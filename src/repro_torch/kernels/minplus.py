"""K2 — the tropical (min,+) frontier product, a CUDA kernel for Hopper.

Replaces the Pallas kernel ``repro.kernels.minplus.minplus_matmul``
(serving entry ``minplus_frontier_matmul``).  The kernel
(``csrc/minplus.cu``) is a shared-memory tiled broadcast-add and min on the
CUDA cores, with +inf as the ⊕-zero and ragged shapes masked.

On CPU tensors the wrapper runs the plain version (:data:`plain`); on CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

#: the plain PyTorch version of this kernel
plain = ref.minplus_ref

_VP, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {"repro_minplus_matmul": [_VP, _VP, _VP, _I, _I, _I, _VP]}


def minplus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) ⊗_min,+ (k, n) -> (m, n); f32 with +inf for 'no fact'."""
    if not build.on_card("minplus_matmul", a, b):
        return plain(a, b)
    build.require("minplus_matmul a", a, torch.float32, 2)
    build.require("minplus_matmul b", b, torch.float32, 2)
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"minplus_matmul: {tuple(a.shape)} x {tuple(b.shape)}")
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    lib = build.load("minplus", _PROTOTYPES)
    with torch.cuda.device(a.device):
        rc = lib.repro_minplus_matmul(a.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), m, k, n,
                                      build.stream_handle(a))
    build.check(lib, rc, "minplus_matmul")
    build.LAUNCHES["minplus_matmul"] += 1
    return out


def minplus_frontier_matmul(frontier: torch.Tensor, w: torch.Tensor
                            ) -> torch.Tensor:
    """Micro-batched frontier step: (B, n) ⊗_min,+ (n, n) -> (B, n).
    No padding: the kernel masks ragged B and n itself."""
    return minplus_matmul(frontier, w)
