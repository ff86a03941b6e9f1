"""K1 — the boolean (∨,∧) frontier product, a CUDA kernel for Hopper.

Replaces the Pallas kernel ``repro.kernels.boolmm.bool_matmul`` (serving
entry ``bool_frontier_matmul``).  The kernel (``csrc/boolmm.cu``) runs the
product on the int8 tensor cores (``wgmma``, u8 × u8 → s32, ``> 0``) over
128 x 128 output tiles, with K split over the grid by :func:`plan` (the
splits OR their ones into a zeroed output); ragged shapes are masked, not
padded, and the result is exact.

On CPU tensors the wrapper runs the plain version (:data:`plain`); on CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref

#: the plain PyTorch version of this kernel
plain = ref.boolmm_ref

#: the kernel's output tile and stage depth in bytes of k (``csrc/boolmm.cu``);
#: two blocks an SM (113 KB of shared memory each)
BM, BN, BK, BLOCKS_PER_SM = 128, 128, 128, 2

_VP, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {"repro_bool_matmul": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                                     _VP]}


@functools.lru_cache(maxsize=256)
def plan(m: int, k: int, n: int, aligned: bool = True,
         sms: int = build.SMS) -> build.Plan:
    """The launch plan of an (m, k) ⊗ (k, n) product on a card with ``sms``
    SMs; ``aligned``: the operands and output start on 16-byte boundaries.
    No scratch: the splits OR their ones into the output, zeroed first."""
    return build.tiled_plan(m, k, n, (BM, BN, BK), BLOCKS_PER_SM, sms, False,
                            aligned and k % 16 == 0 and n % 16 == 0)


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
    p = plan(m, k, n, build.aligned(a, b, out), build.sm_count(a.device))
    lib = build.load("boolmm", _PROTOTYPES)
    with torch.cuda.device(a.device):
        rc = lib.repro_bool_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                   m, k, n, p.k_chunk, p.splits, int(p.vec),
                                   build.stream_handle(a))
    build.check(lib, rc, "bool_matmul")
    build.LAUNCHES["bool_matmul"] += 1
    return out


def bool_frontier_matmul(frontier: torch.Tensor, adj: torch.Tensor
                         ) -> torch.Tensor:
    """Micro-batched frontier step: (B, n) bool ⊗ (n, n) bool -> (B, n).
    No padding: the kernel masks ragged B and n itself."""
    return bool_matmul(frontier, adj)
