"""Launchers of the LM stack (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``)."""
