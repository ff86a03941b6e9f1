"""Semi-naive dense frontier fixpoints over torch tensors.

Port of the dense half of ``repro.core.seminaive``.  Each iteration is one
⊕.⊗ product, with semi-naive evaluation realized as delta-row masking (the
idempotent carriers).  ``lax.while_loop`` becomes a host loop: the
convergence test ``any(mask)`` syncs the host once per iteration, and the
loop reproduces the JAX loop's ``iterations`` and ``generated`` exactly.

The default ⊗ is ``kernels.ops.frontier_matmul``: the CUDA kernel on a CUDA
tensor, the plain version on a CPU tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .semiring import BOOL, MIN_PLUS, Semiring

#: generated-fact accumulator dtype (int64, as in the x64 JAX run)
GEN_DTYPE = torch.int64


@dataclasses.dataclass
class DenseResult:
    table: torch.Tensor  # fixpoint matrix / vector
    iterations: int  # loop trips
    generated: int  # facts produced before dedup (Tables 7/8)


def _ne(sr: Semiring, a, b):
    if sr.dtype == torch.bool:
        return a != b
    # inf-aware compare for tropical semirings
    return ~((a == b) | (torch.isinf(a) & torch.isinf(b)
                         & (torch.sign(a) == torch.sign(b))))


def _zero_like(sr: Semiring, D: torch.Tensor) -> torch.Tensor:
    return torch.tensor(sr.zero, dtype=D.dtype, device=D.device)


def fixpoint_dense(
    sr: Semiring,
    arc: torch.Tensor,
    init: torch.Tensor,
    form: str = "linear",
    matmul: Callable | None = None,
    max_iters: int | None = None,
) -> DenseResult:
    """Dense fixpoint over an idempotent semiring.

    form:
      'linear'  D <- D ⊕ (Δmask·D) ⊗ arc          (tc r2 / dpath r2')
      'vector'  d <- d ⊕ arcᵀ-propagate(d)        (a (B, n) init runs B
                                                   frontiers as one batched
                                                   fixpoint with per-row
                                                   convergence masking)
    The additive accumulate form waits for ROADMAP A.1, the nonlinear and
    sandwich forms for the tuple/graph engines (ROADMAP A.6).
    """
    if not sr.idempotent:
        raise NotImplementedError(
            f"the {sr.name} (accumulate-form) fixpoint is not ported yet "
            "(ROADMAP A.1)")
    if form not in ("linear", "vector"):
        raise NotImplementedError(
            f"fixpoint_dense form={form!r} is not ported yet (ROADMAP A.6)")
    if matmul is None:
        from ..kernels import ops
        matmul = ops.frontier_matmul(sr.name)
    # domain size is the LAST dim: a batched (B, n) vector init must iterate
    # to the domain's depth, not the batch's
    n = init.shape[-1]
    if max_iters is None:
        max_iters = 4 * n + 8
    zero = _zero_like(sr, init)

    def step(D, mask):
        rmask = mask if D.ndim == 1 else mask[:, None]
        dm = torch.where(rmask, D, zero)
        if D.ndim == 1:  # vector form over a single frontier
            upd = matmul(dm[None, :], arc)[0]
        else:
            upd = matmul(dm, arc)
        return sr.add(D, upd), upd

    D = init
    mask = torch.ones(init.shape[:-1] if init.ndim > 1 else init.shape,
                      dtype=torch.bool, device=init.device)
    it = 0
    gen = torch.zeros((), dtype=GEN_DTYPE, device=init.device)
    while it < max_iters and bool(mask.any()):
        Dn, upd = step(D, mask)
        changed = _ne(sr, Dn, D)
        gen = gen + (upd != zero).sum(dtype=GEN_DTYPE)
        mask = changed.any(dim=-1) if D.ndim > 1 else changed
        D = Dn
        it += 1
    return DenseResult(D, it, int(gen))


def fixpoint_dense_cached(
    sr: Semiring,
    arc: torch.Tensor,
    init: torch.Tensor,
    form: str = "linear",
    matmul: Callable | None = None,
    max_iters: int | None = None,
) -> DenseResult:
    """:func:`fixpoint_dense` with the JAX cached twin's signature.  There is
    no jit to cache; ``max_iters`` resolves here (``4n + 8`` over the domain
    size) exactly as the JAX twin resolves it."""
    if max_iters is None:
        max_iters = 4 * init.shape[-1] + 8
    return fixpoint_dense(sr, arc, init, form=form, matmul=matmul,
                          max_iters=max_iters)


def _as_index(srcs, device) -> torch.Tensor:
    return torch.as_tensor(srcs, dtype=torch.int64).to(device)


def reachable_batch_dense(adj: torch.Tensor, srcs, matmul=None,
                          max_iters: int | None = None) -> DenseResult:
    """``?- tc(s, Y)`` for a batch of sources: one (B, n) masked fixpoint."""
    init = adj[_as_index(srcs, adj.device)]
    return fixpoint_dense_cached(BOOL, adj, init, form="vector", matmul=matmul,
                                 max_iters=max_iters)


def distances_batch_dense(w: torch.Tensor, srcs, matmul=None,
                          max_iters: int | None = None) -> DenseResult:
    """``?- spath(s, Z, D)`` for a batch of sources (min-plus carrier)."""
    init = w[_as_index(srcs, w.device)]
    return fixpoint_dense_cached(MIN_PLUS, w, init, form="vector",
                                 matmul=matmul, max_iters=max_iters)


def quantize_rows(n: int, minimum: int = 8) -> int:
    """Shape bucket for data-dependent row counts: next power of two."""
    if n <= minimum:
        return minimum
    return 1 << (n - 1).bit_length()


def quantize_ladder(floor: int, stride: int, top: int) -> tuple[int, ...]:
    """Geometric capacity ladder for degree-class slices: power-of-two caps
    ``floor, floor<<stride, ...`` until the last rung covers ``top``.
    ``stride == 0`` degenerates to one rung at ``quantize_rows(top)``."""
    base = quantize_rows(max(int(floor), 1), minimum=1)
    if stride <= 0:
        return (quantize_rows(max(int(top), 1), minimum=base),)
    caps = [base]
    while caps[-1] < top:
        caps.append(caps[-1] << stride)
    return tuple(caps)
