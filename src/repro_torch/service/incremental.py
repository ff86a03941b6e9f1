"""Monotone EDB appends and fixpoint resumption: port of
``repro.service.incremental`` (the dense and CSR carrier path).

Datalog under appends is monotone: new base facts only add derived facts,
so a cached closure row is a lower bound of the post-append one, and the
fixpoint can re-enter from it.  For a cached row ``prev`` of source ``s``
over the appended arcs ``A'``:

    d0 = prev ⊕ A'[s]          (prev alone can miss new arcs leaving s)
    d  <- d ⊕ d ⊗ A'           until fixpoint

which converges in as many iterations as the delta needs to propagate.  The
additive carrier cannot re-enter (already-counted paths would count twice)
and replays the increment instead (:func:`replay_init`).

The tuple-engine snapshots and the admission epoch fence of the JAX module
come with the tuple engine and the admission front-end.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.semiring import Semiring


def validate_append(rows: np.ndarray, arity: int, bits: int) -> np.ndarray:
    """Normalize appended rows to the (n, arity) int64 layout and reject
    rows outside the packed bit domain."""
    rows = np.asarray(rows, np.int64)
    if rows.ndim == 1:
        rows = rows[None, :] if rows.size else rows.reshape(0, arity)
    if rows.ndim != 2 or rows.shape[1] != arity:
        raise ValueError(
            f"append rows have shape {rows.shape}; relation arity is {arity}")
    limit = (1 << bits) - 1
    if rows.size and (rows.min() < 0 or rows.max() > limit):
        raise ValueError(f"appended rows exceed the {bits}-bit packed domain")
    return rows


def resume_init(sr: Semiring, prev_rows: torch.Tensor,
                seed_rows: torch.Tensor) -> torch.Tensor:
    """The resume seed ``d0 = prev ⊕ seed`` for idempotent carriers: the
    cached (B, n) closure rows and the post-append seed rows of the same
    sources.  The additive carrier raises: use :func:`replay_init`."""
    if not sr.idempotent:
        raise ValueError(
            f"resume_init is unsound for the non-idempotent {sr.name} "
            "carrier (re-entering from prev ⊕ seed double-counts); build "
            "the resume seed with replay_init and add prev to the closure")
    return sr.add(prev_rows, seed_rows)


def replay_init(sr: Semiring, prev_rows: torch.Tensor, srcs,
                delta_rows: np.ndarray, n_alloc: int) -> torch.Tensor:
    """Additive (count/sum) append-resume seed, by first-new-arc
    decomposition: with Δ the appended arcs,

        init0[q, b] = Σ_{(a, b, w) ∈ Δ} (1[a = src_q] + prev[q, a]) · w

    and the accumulate fixpoint from ``init0`` counts exactly the paths
    that use an appended arc; ``prev`` plus that closure is the new total.
    The scatter over arc heads is an ``index_add_``: exact while the counts
    stay integers below 2^24 (the carrier's contract).  ``delta_rows``
    must hold only arcs that were not resident (the caller filters)."""
    b_rows = prev_rows.shape[0]
    dev = prev_rows.device
    base = prev_rows.clone()
    base[torch.arange(b_rows, device=dev),
         torch.as_tensor(np.asarray(srcs, np.int64), device=dev)] += sr.one
    delta_rows = np.asarray(delta_rows, np.int64)
    a = torch.from_numpy(delta_rows[:, 0]).to(dev)
    d = torch.from_numpy(delta_rows[:, 1]).to(dev)
    w = torch.from_numpy(delta_rows[:, 2]).to(dev, prev_rows.dtype)
    contrib = sr.mul(base[:, a], w[None, :])  # (B, m): prefix ⊗ first arc
    init0 = torch.zeros((b_rows, n_alloc), dtype=prev_rows.dtype, device=dev)
    return init0.index_add_(1, d, contrib)


def pad_rows(rows: torch.Tensor, n_alloc: int, zero) -> torch.Tensor:
    """Right-pad (B, n_old) carrier rows to (B, n_alloc) after domain growth."""
    grow = n_alloc - rows.shape[-1]
    if grow <= 0:
        return rows
    fill = torch.full((rows.shape[0], grow), zero, dtype=rows.dtype,
                      device=rows.device)
    return torch.cat([rows, fill], dim=1)


def entry_bytes(entry) -> int:
    """Resident bytes of a cache entry (``CacheEntry.nbytes``): the raw
    carrier row a resume re-enters from plus the formatted answer."""
    return int(entry.nbytes)


def partition_resumable(entries: list, min_hits: int,
                        max_bytes: int = 0) -> tuple[list, list]:
    """Split cached (key, entry) pairs into (resume, drop): with
    ``min_hits`` only entries that served at least that many queries since
    their last (re)compute stay warm; with ``max_bytes`` they resume
    hottest-first until their bytes exceed the budget.  Both 0: resume
    everything."""
    if min_hits <= 0 and max_bytes <= 0:
        return list(entries), []
    hot = [(k, e) for k, e in entries if e.hits >= min_hits]
    cold = [(k, e) for k, e in entries if e.hits < min_hits]
    if max_bytes > 0 and hot:
        hot.sort(key=lambda ke: ke[1].hits, reverse=True)
        budget, kept = 0, []
        for k, e in hot:
            budget += entry_bytes(e)
            (kept if budget <= max_bytes else cold).append((k, e))
        hot = kept
    return hot, cold
