"""Micro-batching: coalesce B single-source queries into one frontier
fixpoint (port of ``repro.service.batch`` for the idempotent carriers).

B concurrent queries ``?- tc(s_i, Y)`` on the same decomposable predicate
share one evaluation: their frontier rows stack into a (B, n) matrix and the
semi-naive fixpoint runs once, each iteration one ⊕.⊗ contraction (dense)
or one segment step (CSR) with per-row convergence masking.

Batch sizes quantize to the service's pad levels (1, 8, 32, 128, ...) with
⊕-zero frontier rows, exactly as in the JAX package, so ``iterations`` and
``generated`` agree with it.  The padding has no compile cache to feed here;
it keeps the two packages' results identical.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import sparse as _sparse
from ..core.semiring import Semiring
from ..core.seminaive import DenseResult, fixpoint_dense_cached


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


def run_frontier_batch(sr: Semiring, matrix: torch.Tensor, srcs: list[int],
                       pads: tuple[int, ...]) -> DenseResult:
    """One batched dense fixpoint answering ``len(srcs)`` single-source
    queries; the table's first ``len(srcs)`` rows are their closure rows
    (pad rows follow)."""
    b = len(srcs)
    bp = pad_batch_size(b, pads)
    idx = torch.from_numpy(_padded_index(srcs, bp)).to(matrix.device)
    init = matrix[idx]  # a gather: a fresh tensor, padded in place
    init[b:] = sr.zero
    return fixpoint_dense_cached(sr, matrix, init, form="vector")


def run_frontier_batch_csr(csr: "_sparse.CSRMatrix", srcs: list[int],
                           pads: tuple[int, ...]) -> DenseResult:
    """CSR twin of :func:`run_frontier_batch`: the same (B, n) batched
    frontier fixpoint, each iteration an O(B·|E|) segment step.  Seeds come
    from one segment step over one-hot rows (``rows_from_sources``), so they
    go through the CSR kernel too."""
    b = len(srcs)
    init = _sparse.rows_from_sources(
        csr, _padded_index(srcs, pad_batch_size(b, pads)))
    init[b:] = csr.semiring.zero  # a step's fresh output, padded in place
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
