"""Launchers of the LM stack (``python -m repro_torch.launch.serve``)."""
