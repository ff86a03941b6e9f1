"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package re-implements
two of its paths in PyTorch, with every TPU kernel on them replaced by a
CUDA C++ kernel written for ``sm_90a`` (``repro_torch.kernels``):

* the Datalog serving main path (batched single-source frontier fixpoints
  on the bool, min-plus, max-plus and plus-times carriers, dense and CSR,
  with appends) and the dense all-pairs closures: K1-K8;
* the LM serving path (``configs``, ``models``, ``train``, ``launch``):
  prefill and greedy decode for the ``attn``, ``local`` and ``rg`` block
  types (RecurrentGemma-2B, Gemma2-9B), with K9 (flash attention) in every
  attention block and K10 (the RG-LRU scan) in every recurrent block of a
  prefill.

It never imports ``jax`` or ``repro``.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on the CPU every kernel wrapper runs its
plain PyTorch version instead.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
