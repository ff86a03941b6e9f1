"""K10 — the RG-LRU gated linear recurrence, a CUDA kernel for Hopper.

Replaces the Pallas kernel ``repro.kernels.rglru_scan.rglru_scan``:
``h_t = a_t ⊙ h_{t-1} + b_t`` over the sequence from ``h_0 = 0``, the scan
of every RG-LRU block of a RecurrentGemma prefill (``models.recurrent.
rglru_seq``).  ``csrc/rglru_scan.cu``: one thread per (batch, channel),
coalesced across channels, the time loop unrolled with its loads issued
ahead; the same two roundings a step as the plain version, so the two are
equal bit for bit.

On CPU tensors the wrapper runs the plain version (:data:`plain`); on CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

#: the plain PyTorch version of this kernel
plain = ref.rglru_scan_ref

_VP, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {"repro_rglru_scan": [_VP, _VP, _VP, _I, _I, _I, _VP]}


def rglru_scan(a: torch.Tensor, b: torch.Tensor, *, bw: int | None = None,
               bs: int | None = None) -> torch.Tensor:
    """a, b: (B, S, W) -> h: (B, S, W) f32 with ``h_t = a_t h_{t-1} + b_t``.

    Inputs are taken as f32, as the JAX kernel casts them.  ``bw`` and
    ``bs`` are the JAX kernel's block sizes, accepted so that one kwargs
    dict drives both packages; the Hopper kernel has no sequence tiles and
    masks a ragged S and W, where the JAX kernel asserts that its blocks
    divide them.
    """
    del bw, bs
    if not build.on_card("rglru_scan", a, b):
        return plain(a, b)
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    build.require("rglru_scan a", a, torch.float32, 3)
    if b.shape != a.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must have one (B, S, W) shape")
    batch, seq, width = a.shape
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    lib = build.load("rglru_scan", _PROTOTYPES)
    with torch.cuda.device(a.device):
        rc = lib.repro_rglru_scan(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                  batch, seq, width, build.stream_handle(a))
    build.check(lib, rc, "rglru_scan")
    build.LAUNCHES["rglru_scan"] += 1
    return h
