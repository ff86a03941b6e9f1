"""K2 — the tropical frontier products, a CUDA kernel for Hopper with a
min-plus and a max-plus instantiation.

Replaces the Pallas kernel ``repro.kernels.minplus.minplus_matmul``
(serving entry ``minplus_frontier_matmul``; the JAX package serves max-plus
through it by negation, ``ops.maxplus_frontier``).  The kernel
(``csrc/minplus.cu``) is a tiled broadcast-add and ⊕ on the CUDA cores,
templated on the ⊕ (min with +inf, max with -inf as the ⊕-zero): 128 x 128
output tiles, a ``cp.async`` ring of 32-deep stages, dead (row, k) pairs
skipped (each row walks its live k when a stage holds few), and K split
over the grid by :func:`plan` (the splits' partials ⊕-combined by a second
kernel), with ragged shapes masked.

On CPU tensors the wrappers run the plain versions (:data:`plain`,
:data:`plain_max`); on CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref

#: the plain PyTorch versions of this kernel's two instantiations
plain = ref.minplus_ref
plain_max = ref.maxplus_ref

#: the kernel's output tile and stage depth (``csrc/minplus.cu``); one
#: block an SM (16 warps, 96 KB of stages)
BM, BN, BK, BLOCKS_PER_SM = 128, 128, 32, 1

_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP]
_PROTOTYPES = {"repro_minplus_matmul": _ARGS, "repro_maxplus_matmul": _ARGS}


@functools.lru_cache(maxsize=256)
def plan(m: int, k: int, n: int, aligned: bool = True,
         sms: int = build.SMS) -> build.Plan:
    """The launch plan of an (m, k) ⊗ (k, n) product on a card with ``sms``
    SMs; ``aligned``: the operands and output start on 16-byte boundaries.
    With more than one split the partials go to a scratch."""
    return build.tiled_plan(m, k, n, (BM, BN, BK), BLOCKS_PER_SM, sms, True,
                            aligned and k % 4 == 0 and n % 4 == 0)


def _launch(fn: str, counter: str, a: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    build.require(f"{counter} a", a, torch.float32, 2)
    build.require(f"{counter} b", b, torch.float32, 2)
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"{counter}: {tuple(a.shape)} x {tuple(b.shape)}")
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    p = plan(m, k, n, build.aligned(a, b, out), build.sm_count(a.device))
    scratch = torch.empty(p.scratch, dtype=torch.float32, device=a.device) \
        if p.scratch else None
    lib = build.load("minplus", _PROTOTYPES)
    with torch.cuda.device(a.device):
        rc = getattr(lib, fn)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, m, k, n,
            p.k_chunk, p.splits, int(p.vec), build.stream_handle(a))
    build.check(lib, rc, counter)
    build.LAUNCHES[counter] += 1
    return out


def minplus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) ⊗_min,+ (k, n) -> (m, n); f32 with +inf for 'no fact'."""
    if not build.on_card("minplus_matmul", a, b):
        return plain(a, b)
    return _launch("repro_minplus_matmul", "minplus_matmul", a, b)


def maxplus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) ⊗_max,+ (k, n) -> (m, n); f32 with -inf for 'no fact'."""
    if not build.on_card("maxplus_matmul", a, b):
        return plain_max(a, b)
    return _launch("repro_maxplus_matmul", "maxplus_matmul", a, b)


def minplus_frontier_matmul(frontier: torch.Tensor, w: torch.Tensor
                            ) -> torch.Tensor:
    """Micro-batched frontier step: (B, n) ⊗_min,+ (n, n) -> (B, n).
    No padding: the kernel masks ragged B and n itself."""
    return minplus_matmul(frontier, w)


def maxplus_frontier_matmul(frontier: torch.Tensor, w: torch.Tensor
                            ) -> torch.Tensor:
    """Micro-batched frontier step: (B, n) ⊗_max,+ (n, n) -> (B, n)."""
    return maxplus_matmul(frontier, w)
