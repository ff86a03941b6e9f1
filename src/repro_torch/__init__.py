"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package re-implements
its serving main path (batched single-source frontier fixpoints on the bool,
min-plus, max-plus and plus-times carriers, dense and CSR) in PyTorch, with every TPU kernel on
that path replaced by a CUDA C++ kernel written for ``sm_90a``
(``repro_torch.kernels``).  It never imports ``jax`` or ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper runs its plain PyTorch version instead.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
