"""Micro-batching: coalesce B single-source queries into one frontier
fixpoint (port of ``repro.service.batch`` without mesh and probe).

B concurrent queries ``?- tc(s_i, Y)`` on the same decomposable predicate
share one evaluation: their frontier rows stack into a (B, n) matrix and the
semi-naive fixpoint runs once, each iteration one ⊕.⊗ contraction (dense)
or one segment step (CSR) with per-row convergence masking.  The additive
carrier (``sum<>``) runs the accumulate form instead, under the acyclicity
iteration bound: a cyclic EDB raises ``FixpointDivergenceError`` rather than
serving a truncated count.

Batch sizes quantize to the service's pad levels (1, 8, 32, 128, ...) with
⊕-zero frontier rows, exactly as in the JAX package, so ``iterations`` and
``generated`` agree with it.  The padding has no compile cache to feed here;
it keeps the two packages' results identical.

Tuple queries group by (predicate, adornment) shape instead
(:func:`coalesce_by_shape`): a same-shape group shares one qid-tagged
tuple fixpoint (``session._QueryTemplate.run_batch``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import sparse as _sparse
from ..core.semiring import Semiring
from ..core.seminaive import (DenseResult, additive_max_iters,
                              check_additive_converged, fixpoint_dense_cached)


def coalesce_by_shape(items: list, shape_of) -> dict:
    """Group (index, query) pairs by ``shape_of(query)``, preserving order:
    queries sharing a (pred, adornment) shape may share one qid-tagged
    fixpoint (their demands share a seed schema); mixed shapes must not."""
    groups: dict = {}
    for i, q in items:
        groups.setdefault(shape_of(q), []).append((i, q))
    return groups


def pad_batch_size(b: int, pads: tuple[int, ...]) -> int:
    """Smallest pad level >= b; beyond the largest level, its next multiple."""
    for p in pads:
        if b <= p:
            return p
    top = pads[-1]
    return ((b + top - 1) // top) * top


def _padded_index(srcs: list[int], bp: int) -> np.ndarray:
    # duplicate-gather to the padded size; the caller ⊕-zeroes the pad rows
    return np.concatenate([np.asarray(srcs, np.int64),
                           np.full(bp - len(srcs), srcs[0], np.int64)])


def _pad_init(init: torch.Tensor, bp: int, zero) -> torch.Tensor:
    """A caller-built (b, n) seed (append-resume) padded with ⊕-zero rows."""
    if init.shape[0] >= bp:
        return init
    fill = torch.full((bp - init.shape[0], init.shape[1]), zero,
                      dtype=init.dtype, device=init.device)
    return torch.cat([init, fill])


def run_frontier_batch(sr: Semiring, matrix: torch.Tensor, srcs: list[int],
                       pads: tuple[int, ...],
                       init: torch.Tensor | None = None) -> DenseResult:
    """One batched dense fixpoint answering ``len(srcs)`` single-source
    queries; the table's first ``len(srcs)`` rows are their closure rows
    (pad rows follow).  ``init`` overrides the (B, n) seed: an
    append-resume passes the cached rows ⊕ the post-append seed rows."""
    b = len(srcs)
    bp = pad_batch_size(b, pads)
    if init is None:
        idx = torch.from_numpy(_padded_index(srcs, bp)).to(matrix.device)
        init = matrix[idx]  # a gather: a fresh tensor, padded in place
        init[b:] = sr.zero
    else:
        init = _pad_init(init, bp, sr.zero)
    if not sr.idempotent:
        # additive ⊕ has no masked vector form: the accumulate fixpoint sums
        # init·Aᵏ over path lengths, bounded by the acyclicity budget
        max_iters = additive_max_iters(matrix.shape[-1])
        res = fixpoint_dense_cached(sr, matrix, init, form="accumulate",
                                    max_iters=max_iters)
        return check_additive_converged(res, max_iters, "additive dense batch")
    return fixpoint_dense_cached(sr, matrix, init, form="vector")


def run_frontier_batch_csr(csr: "_sparse.CSRMatrix", srcs: list[int],
                           pads: tuple[int, ...],
                           init: torch.Tensor | None = None) -> DenseResult:
    """CSR twin of :func:`run_frontier_batch`: the same (B, n) batched
    frontier fixpoint, each iteration an O(B·|E|) segment step.  Seeds come
    from one segment step over one-hot rows (``rows_from_sources``), so they
    go through the CSR kernel too; ``init`` overrides them (append-resume)."""
    b = len(srcs)
    bp = pad_batch_size(b, pads)
    if init is None:
        init = _sparse.rows_from_sources(csr, _padded_index(srcs, bp))
        init[b:] = csr.semiring.zero  # a step's fresh output, padded in place
    else:
        init = _pad_init(init, bp, csr.semiring.zero)
    if not csr.semiring.idempotent:
        # fixpoint_csr runs the accumulate form for the additive carrier;
        # the budget is checked here, as on the dense twin
        max_iters = additive_max_iters(csr.n_alloc)
        res = _sparse.fixpoint_csr_cached(csr, init, max_iters=max_iters)
        return check_additive_converged(res, max_iters, "additive CSR batch")
    return _sparse.fixpoint_csr_cached(csr, init)


# -- answer formatting (carrier row -> Engine.ask-shaped numpy) --------------


def format_bool_row(src: int, row, n: int) -> np.ndarray:
    """(n_alloc,) bool closure row -> (k, 2) int64 tc rows for source src."""
    dst = np.nonzero(np.asarray(row[:n]))[0]
    return np.stack([np.full(len(dst), src, np.int64), dst.astype(np.int64)],
                    axis=1) if len(dst) else np.zeros((0, 2), np.int64)


def format_minplus_row(src: int, row, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(n_alloc,) float32 distance row -> ((k, 2) rows, (k,) int64 values)."""
    d = np.asarray(row[:n])
    dst = np.nonzero(np.isfinite(d))[0]
    if not len(dst):
        return np.zeros((0, 2), np.int64), np.zeros((0,), np.int64)
    rows = np.stack([np.full(len(dst), src, np.int64), dst.astype(np.int64)],
                    axis=1)
    return rows, d[dst].astype(np.int64)


def format_maxplus_row(src: int, row, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(n_alloc,) float32 longest-path row -> ((k, 2) rows, (k,) int64).

    Same finite mask as the min-plus formatter — the max-plus ⊕-zero is
    -inf, equally non-finite — kept as its own entry point so the carrier
    table stays one-kind-one-formatter."""
    return format_minplus_row(src, row, n)


def format_plustimes_row(src: int, row, n: int
                         ) -> tuple[np.ndarray, np.ndarray]:
    """(n_alloc,) float32 count/sum row -> ((k, 2) rows, (k,) int64 values).

    The additive ⊕-zero is 0.0, so non-zero entries are the destinations
    with at least one path.  Values round to int64 — the packed domain is
    integral, and f32 keeps integer totals exact to 2^24."""
    d = np.asarray(row[:n])
    dst = np.nonzero(d != 0.0)[0]
    if not len(dst):
        return np.zeros((0, 2), np.int64), np.zeros((0,), np.int64)
    rows = np.stack([np.full(len(dst), src, np.int64), dst.astype(np.int64)],
                    axis=1)
    return rows, np.rint(d[dst]).astype(np.int64)
