"""K1 — the boolean (∨,∧) frontier product, a CUDA kernel for Hopper.

Replaces the Pallas kernel ``repro.kernels.boolmm.bool_matmul`` (serving
entry ``bool_frontier_matmul``).  The kernel (``csrc/boolmm.cu``) works on
0/1 bytes with an OR of ANDs, four packed columns per 32-bit word, and masks
ragged shapes instead of padding them; the result is exact.

On CPU tensors the wrapper runs the plain version (:data:`plain`); on CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

#: the plain PyTorch version of this kernel
plain = ref.boolmm_ref

_VP, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {"repro_bool_matmul": [_VP, _VP, _VP, _I, _I, _I, _VP]}


def bool_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) bool ⊗_bool (k, n) bool -> (m, n) bool."""
    if not build.on_card("bool_matmul", a, b):
        return plain(a, b)
    build.require("bool_matmul a", a, torch.bool, 2)
    build.require("bool_matmul b", b, torch.bool, 2)
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"bool_matmul: {tuple(a.shape)} x {tuple(b.shape)}")
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.bool, device=a.device)
    lib = build.load("boolmm", _PROTOTYPES)
    with torch.cuda.device(a.device):
        rc = lib.repro_bool_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                   m, k, n, build.stream_handle(a))
    build.check(lib, rc, "bool_matmul")
    build.LAUNCHES["bool_matmul"] += 1
    return out


def bool_frontier_matmul(frontier: torch.Tensor, adj: torch.Tensor
                         ) -> torch.Tensor:
    """Micro-batched frontier step: (B, n) bool ⊗ (n, n) bool -> (B, n).
    No padding: the kernel masks ragged B and n itself."""
    return bool_matmul(frontier, adj)
