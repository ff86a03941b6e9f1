"""Semi-naive fixpoints over torch tensors: port of ``repro.core.seminaive``.

**Dense half.**  Each iteration is one
⊕.⊗ product (two for the nonlinear and sandwich forms), with semi-naive
evaluation realized as delta-row masking (idempotent ⊕) or delta
accumulation (additive ⊕).  ``lax.while_loop`` becomes a host loop: the
convergence test (``any(mask)``, or ``any(delta != 0)`` for the accumulate
form) syncs the host once per iteration, and the loop reproduces the JAX
loop's ``iterations`` and ``generated`` exactly.

The default ⊗ is ``kernels.ops.semiring_matmul``: the CUDA kernel (K1 for
bool, K2 for min-plus and max-plus) on a CUDA tensor, the plain version on a
CPU tensor.  The all-pairs front-ends (transitive closure, shortest paths,
same generation, connected components) and the single-source ones run on
it; the fused relaxation step K8 is reached through ``kernels.ops.relax``,
as in the JAX package.

**Tuple half** (Algorithm 1's building blocks, driven by
``engine.GroupExecutor``): EDB join indexes, binding tables and the joins
that expand them, over the exact-size packed tables of ``relation.py``.

**Trace accounting.**  The JAX package counts fixpoint (re-)traces, which
happen at the first call of each jitted fixpoint with a new static key or
new argument shapes; the serving layer's tests assert that warm batches
compile nothing.  There is no jit here, so :func:`note_trace` keeps the
keys and argument shapes JAX's caches would hold and bumps the same
counter at the same calls: group runners (``engine.GroupExecutor``, keyed
by their structural key and ``quantize_rows``-bucketed shapes),
:func:`fixpoint_dense_cached` and ``sparse.fixpoint_csr_cached``.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, Hashable

import numpy as np
import torch

from ..device import resolve_device
from .relation import (EMPTY, Schema, expand_matches, match_ranges,
                       sorted_member)
from .semiring import BOOL, MIN_PLUS, PLUS_TIMES, Semiring

# ---------------------------------------------------------------------------
# Trace accounting
# ---------------------------------------------------------------------------

_TRACE_COUNT = 0
_TRACE_LOCK = threading.Lock()
#: per cache: static key -> the argument signatures it has been called with,
#: oldest static key first (JAX's group-runner cache evicts FIFO at 256)
_TRACED: dict[str, "OrderedDict[Hashable, set]"] = {}
_TRACE_LIMITS = {"group": 256}


def bump_trace_count() -> None:
    global _TRACE_COUNT
    with _TRACE_LOCK:
        _TRACE_COUNT += 1


def trace_count() -> int:
    return _TRACE_COUNT


def note_trace(cache: str, static_key: Hashable, signature: Hashable) -> bool:
    """Record a call of a fixpoint that JAX runs under a jit: bump the
    trace count (and return True) when JAX would trace it, i.e. at the
    first call with this static key and argument signature since the key
    entered ``cache``."""
    with _TRACE_LOCK:
        seen = _TRACED.setdefault(cache, OrderedDict())
        sigs = seen.get(static_key)
        if sigs is None:
            limit = _TRACE_LIMITS.get(cache)
            if limit is not None and len(seen) >= limit:
                seen.pop(next(iter(seen)))
            sigs = seen[static_key] = set()
        if signature in sigs:
            return False
        sigs.add(signature)
    bump_trace_count()
    return True


def forget_trace(cache: str, static_key: Hashable,
                 signature: Hashable) -> None:
    """Undo :func:`note_trace` for a call whose trace raised (JAX caches
    nothing for it, so the next call traces again)."""
    with _TRACE_LOCK:
        _TRACED.get(cache, {}).get(static_key, set()).discard(signature)


def clear_traces(cache: str) -> None:
    """Forget a cache's keys (JAX: the cached jitted functions dropped)."""
    with _TRACE_LOCK:
        _TRACED.pop(cache, None)


def _shape_sig(t: torch.Tensor | None):
    return None if t is None else (tuple(t.shape), str(t.dtype))

#: generated-fact accumulator dtype (int64, as in the x64 JAX run)
GEN_DTYPE = torch.int64
#: the largest count :data:`GEN_DTYPE` holds (the JAX package's ``GEN_MAX``)
GEN_MAX = torch.iinfo(GEN_DTYPE).max


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
    """Dense fixpoint over a semiring.

    form:
      'linear'      D <- D ⊕ (Δmask·D) ⊗ arc          (tc r2 / dpath r2')
      'nonlinear'   D <- D ⊕ D ⊗ D                    (dpath r5; log-depth;
                                                       semi-naive as
                                                       Δ⊗D ⊕ D⊗Δ)
      'vector'      d <- d ⊕ arcᵀ-propagate(d)        (CC label propagation;
                                                       a (B, n) init runs B
                                                       frontiers as one
                                                       batched fixpoint with
                                                       per-row convergence
                                                       masking)
      'sandwich'    S <- S ⊕ arcᵀ ⊗ (S ⊗ arc)         (same-generation)
      'accumulate'  C = Σ Δ;  Δ <- Δ ⊗ arc             (path counting, +,×)
    """
    if form not in ("linear", "nonlinear", "vector", "sandwich", "accumulate"):
        raise ValueError(form)
    if matmul is None:
        from ..kernels import ops
        matmul = ops.semiring_matmul(sr.name)
    # domain size is the LAST dim: a batched (B, n) vector init must iterate
    # to the domain's depth, not the batch's
    n = init.shape[-1]
    if max_iters is None:
        max_iters = 4 * n + 8
    zero = _zero_like(sr, init)

    if form == "accumulate":
        if sr.idempotent:
            raise ValueError("accumulate form is for additive semirings")
        total = delta = init
        it = 0
        gen = torch.zeros((), dtype=GEN_DTYPE, device=init.device)
        while it < max_iters and bool((delta != zero).any()):
            new = matmul(delta[None, :], arc)[0] if delta.ndim == 1 \
                else matmul(delta, arc)
            gen = gen + (new != zero).sum(dtype=GEN_DTYPE)
            total, delta = total + new, new
            it += 1
        return DenseResult(total, it, int(gen))

    # the sandwich form's arcᵀ, made contiguous once (the kernels take
    # contiguous operands; XLA hoists the JAX package's per-step transpose)
    arc_t = arc.T.contiguous() if form == "sandwich" else None

    def step(D, mask):
        rmask = mask if D.ndim == 1 else mask[:, None]
        Dm = torch.where(rmask, D, zero)
        if D.ndim == 1:  # vector form over a single frontier
            upd = matmul(Dm[None, :], arc)[0]
        elif form in ("linear", "vector"):
            upd = matmul(Dm, arc)
        elif form == "nonlinear":
            upd = sr.add(matmul(Dm, D), matmul(D, Dm))
        else:  # sandwich
            upd = matmul(arc_t, matmul(Dm, arc))
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
    size) exactly as the JAX twin resolves it, and the call is counted as
    the JAX twin's trace cache would count it (:func:`note_trace`)."""
    if max_iters is None:
        max_iters = 4 * init.shape[-1] + 8
    note_trace("dense", (sr.name, form, matmul, max_iters),
               (_shape_sig(arc), _shape_sig(init)))
    return fixpoint_dense(sr, arc, init, form=form, matmul=matmul,
                          max_iters=max_iters)


# additive-⊕ termination -------------------------------------------------------
# Idempotent carriers converge unconditionally; the additive (+,×) carrier
# only terminates when the program is acyclic (paper §2.1's count/sum
# termination discussion).  Additive fixpoints run under a tight iteration
# bound and the caller checks it afterwards, as in the JAX package.


class FixpointDivergenceError(RuntimeError):
    """An additive (non-idempotent ⊕) fixpoint hit its iteration bound —
    the underlying graph is cyclic, so count/sum-in-recursion diverges."""


def additive_max_iters(n: int) -> int:
    """Iteration bound for accumulate-form fixpoints: an acyclic n-vertex
    graph's longest path has < n arcs, so the delta drains within n steps;
    hitting n + 2 means a cycle keeps feeding it."""
    return int(n) + 2


def check_additive_converged(res: DenseResult, max_iters: int,
                             what: str = "additive fixpoint") -> DenseResult:
    if int(res.iterations) >= max_iters:
        raise FixpointDivergenceError(
            f"{what} hit its iteration bound ({max_iters}): the graph is "
            "cyclic, so the (+,×) carrier has no finite fixpoint — additive "
            "aggregates in recursion require an acyclic EDB")
    return res


# convenience graph front-ends ------------------------------------------------


def transitive_closure_dense(adj: torch.Tensor, matmul=None) -> DenseResult:
    """tc(X,Y) over the boolean semiring; adj is (n,n) bool."""
    return fixpoint_dense(BOOL, adj, adj, form="linear", matmul=matmul)


def shortest_paths_dense(w: torch.Tensor, matmul=None) -> DenseResult:
    """All-pairs spath (Examples 2/3). w: (n,n) float32 with +inf for no arc."""
    return fixpoint_dense(MIN_PLUS, w, w, form="linear", matmul=matmul)


def same_generation_dense(adj: torch.Tensor, matmul=None) -> DenseResult:
    """sg(X,Y) (Example 11): exit = AᵀA \\ id, recurse S <- Aᵀ S A.

    Only the exit rule carries X != Y (the paper's r1); the recursive rule may
    re-derive diagonal entries (possible when the graph has self-loops).  The
    exit rule's AᵀA is a plain f32 product, as in the JAX package; it is
    exact on the card too (0/1 inputs, integer sums below 2^24)."""
    a = adj.to(torch.float32)
    exit_ = (a.T @ a) > 0
    exit_ &= ~torch.eye(adj.shape[0], dtype=torch.bool, device=adj.device)
    return fixpoint_dense(BOOL, adj, exit_, form="sandwich", matmul=matmul)


def connected_components_dense(adj: torch.Tensor) -> DenseResult:
    """connComp (Example 7 r7.3/r7.4): min-label propagation, undirected
    view; one (n,) label row through the min-plus ⊗ (K2 with B = 1)."""
    n = adj.shape[0]
    sym = adj | adj.T
    prop = torch.where(sym, 0.0, float("inf")).to(torch.float32)
    labels = torch.arange(n, dtype=torch.float32, device=adj.device)
    return fixpoint_dense(MIN_PLUS, prop, labels, form="vector")


# magic-restricted single-source fast paths ----------------------------------
# A query binding the pivot argument of a decomposable program reduces the
# matrix fixpoint to a *vector* fixpoint seeded with the query frontier row.


def reachable_from_dense(adj: torch.Tensor, src: int,
                         matmul=None) -> DenseResult:
    """``?- tc(src, Y)``: one-frontier reachability."""
    return fixpoint_dense(BOOL, adj, adj[src], form="vector", matmul=matmul)


def single_source_distances_dense(w: torch.Tensor, src: int,
                                  matmul=None) -> DenseResult:
    """``?- spath(src, Z, D)``: single-source min-plus distances."""
    return fixpoint_dense(MIN_PLUS, w, w[src], form="vector", matmul=matmul)


# batched front-ends (the serving layer's hot path) ----------------------------


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


def counts_batch_dense(w: torch.Tensor, srcs, matmul=None,
                       max_iters: int | None = None) -> DenseResult:
    """``?- cpath(s, Z, C)`` for a batch of sources: plus-times path counts
    via the accumulate form (total = Σ_k w[s]·wᵏ), guarded by the additive
    iteration bound — raises :class:`FixpointDivergenceError` on cycles."""
    init = w[_as_index(srcs, w.device)]
    if max_iters is None:
        max_iters = additive_max_iters(w.shape[-1])
    res = fixpoint_dense_cached(PLUS_TIMES, w, init, form="accumulate",
                                matmul=matmul, max_iters=max_iters)
    return check_additive_converged(res, max_iters, "plus-times batch")


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


# ---------------------------------------------------------------------------
# Tuple PSN — Algorithm 1's building blocks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EdbIndex:
    """A base relation indexed for equi-joins on a column subset: the join
    columns packed and sorted (the build side), every column gathered into
    the same order.  ``bucket`` is the row capacity JAX pads the index to
    (:func:`quantize_rows`); it enters only the trace signature."""

    keys: torch.Tensor  # (count,) int64, ascending
    count: int
    cols: tuple[torch.Tensor, ...]  # (count,) int32 each, sorted by keys
    bucket: int


def build_edb_index(rows: np.ndarray, key_cols: tuple[int, ...],
                    schema_bits: int, minimum: int = 8,
                    device=None) -> EdbIndex:
    """Index ``rows`` on ``key_cols`` (packed at ``schema_bits`` a column)
    on ``device`` (``None``: the card).  ``minimum`` is the relation's
    shape-bucket floor (``PlanOptions.bucket_floors``), as in JAX."""
    dev = resolve_device(device)
    rows = np.asarray(rows, np.int64)
    minimum = max(minimum, 8)
    if rows.ndim == 1:  # single-column relation
        rows = rows[:, None]
    if len(rows) == 0:
        width = rows.shape[1] if rows.size or rows.ndim > 1 else 1
        return EdbIndex(
            keys=torch.zeros((0,), dtype=torch.int64, device=dev), count=0,
            cols=tuple(torch.zeros((0,), dtype=torch.int32, device=dev)
                       for _ in range(width)),
            bucket=quantize_rows(1, minimum=minimum))
    t = torch.from_numpy(rows).to(dev)
    keys = Schema(tuple([schema_bits] * len(key_cols))).pack(
        [t[:, c] for c in key_cols])
    skeys, order = torch.sort(keys, stable=True)
    cols = t[order].to(torch.int32)
    return EdbIndex(keys=skeys, count=len(rows),
                    cols=tuple(cols[:, i].contiguous()
                               for i in range(rows.shape[1])),
                    bucket=quantize_rows(len(rows), minimum=minimum))


def pack_warm_rows(rows: np.ndarray, vals: np.ndarray | None, schema: Schema,
                   agg_init: int | None = None, device=None):
    """Pack previously materialized rows for *warm-starting* a later
    fixpoint: monotone tables make any earlier model a lower bound of the
    post-append model, so an appended engine re-enters the fixpoint from
    ``prev ∪ exit(T_new)`` and converges in the delta's propagation depth.
    Returns JAX's arrays: int64 keys ``EMPTY``-padded to a
    :func:`quantize_rows` bucket (and int32 values padded with
    ``agg_init``), on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    n = len(rows)
    cap = quantize_rows(max(n, 1))
    keys = np.full((cap,), EMPTY, np.int64)
    if n:
        rows = np.asarray(rows, np.int64)
        for c, hi in enumerate(schema.max_values()):
            col = rows[:, c]
            if col.min() < 0 or col.max() > hi:
                raise ValueError(
                    f"warm rows exceed the packed domain in column {c} "
                    f"(max {hi}); packing would silently truncate")
        packed = np.zeros((n,), np.int64)
        for c, shift in enumerate(schema.shifts):
            packed |= rows[:, c] << shift
        keys[:n] = packed
    if vals is None:
        return torch.from_numpy(keys).to(dev), None
    v = np.full((cap,), agg_init, np.int32)
    if n:
        v[:n] = np.asarray(vals, np.int32)
    return torch.from_numpy(keys).to(dev), torch.from_numpy(v).to(dev)


@dataclasses.dataclass
class Bindings:
    """Variable bindings flowing through a rule body (columnar).  ``valid``
    marks the live rows; the joins below drop the others, so their outputs
    hold live rows only."""

    cols: dict[str, torch.Tensor]  # var name -> (k,) int32
    valid: torch.Tensor  # (k,) bool
    overflow: bool = False


def _live(b: Bindings) -> Bindings:
    if bool(b.valid.all()):
        return b
    return Bindings({v: c[b.valid] for v, c in b.cols.items()},
                    b.valid[b.valid], b.overflow)


def _probe_cols(b: Bindings, probe_vars) -> list[torch.Tensor]:
    """Probe columns: binding columns by name, int constants as columns."""
    return [b.cols[v] if isinstance(v, str)
            else torch.full(b.valid.shape, v, dtype=torch.int32,
                            device=b.valid.device) for v in probe_vars]


def edb_probe(b: Bindings, probe_vars, schema_bits: int) -> torch.Tensor:
    """The packed probe keys of a join or anti-join against an EDB index."""
    return Schema(tuple([schema_bits] * len(probe_vars))).pack(
        _probe_cols(b, probe_vars))


def edb_antijoin(b: Bindings, index: EdbIndex, probe_vars,
                 schema_bits: int) -> Bindings:
    """Negated EDB literal: the bindings whose probe key the index lacks."""
    hit = sorted_member(edb_probe(b, probe_vars, schema_bits), index.keys)
    return Bindings(b.cols, b.valid & ~hit, b.overflow)


def expand_bindings(b: Bindings, lo: torch.Tensor, matches: torch.Tensor,
                    total: int, fetch, keep=None) -> Bindings:
    """The bindings a join makes of the live bindings ``b``: row ``i`` once
    for each of its ``matches[i]`` build positions from ``lo[i]``
    (``total`` in all; probe order, then build order), with the columns
    ``fetch(build_idx)`` introduces.  ``keep``, when given, names the
    columns to keep."""
    pi, bi = expand_matches(lo, matches, total)
    cols = {v: c[pi] for v, c in b.cols.items() if keep is None or v in keep}
    cols.update((v, c) for v, c in fetch(bi).items()
                if keep is None or v in keep)
    return Bindings(cols, torch.ones(pi.shape, dtype=torch.bool,
                                     device=pi.device), b.overflow)


def _join_capped(b: Bindings, lo, matches, fetch, out_cap) -> Bindings:
    """The first ``out_cap`` joined bindings (JAX's truncation), with
    ``overflow`` set when there were more."""
    cum = torch.cumsum(matches, 0)
    total = int(cum[-1]) if cum.numel() else 0
    if total > out_cap:  # the row counts of the first out_cap matches
        cum = cum.clamp(max=out_cap)
        matches = torch.diff(cum, prepend=cum.new_zeros(1))
    out = expand_bindings(b, lo, matches, min(total, out_cap), fetch)
    out.overflow = b.overflow or total > out_cap
    return out


def edb_intro(index: EdbIndex, build_idx: torch.Tensor, intro) -> dict:
    """The columns a join introduces from an EDB index, at ``build_idx``."""
    return {var: index.cols[c][build_idx] for var, c in dict(intro).items()}


def idb_intro(keys: torch.Tensor, values, idx: torch.Tensor,
              pred_schema: Schema, intro) -> dict:
    """The columns a join introduces from an IDB table (key column ``c`` or
    the aggregate ``"value"``), at table positions ``idx``."""
    intro = dict(intro)
    if not intro:
        return {}
    k = keys[idx]
    out = {}
    for var, c in intro.items():
        if c == "value":
            out[var] = values[idx]
        else:
            b, shift = pred_schema.bits[c], pred_schema.shifts[c]
            out[var] = ((k >> shift) & ((1 << b) - 1)).to(torch.int32)
    return out


def join_edb(b: Bindings, index: EdbIndex, probe_vars, build_key_cols, intro,
             schema_bits, out_cap) -> Bindings:
    """Join the bindings against an EDB index, introducing new columns.
    ``probe_vars`` entries are binding-column names or int constants (the
    planner's constant probes).  More than ``out_cap`` matches set
    ``overflow`` and keep the first ``out_cap``, as in JAX."""
    b = _live(b)
    lo, matches = match_ranges(index.keys,
                               edb_probe(b, probe_vars, schema_bits))
    return _join_capped(b, lo, matches,
                        lambda bi: edb_intro(index, bi, intro), out_cap)


def idb_prefix_ranges(b: Bindings, table_keys: torch.Tensor, probe_vars,
                      pred_schema: Schema, n_key_cols: int):
    """Per live binding: the range of an IDB table's keys whose first
    ``n_key_cols`` columns equal the probe (a range over the high bits of
    the sorted packed keys)."""
    rem_shift = sum(pred_schema.bits[n_key_cols:])
    prefix = Schema(tuple(pred_schema.bits[:n_key_cols])).pack(
        [b.cols[v] for v in probe_vars])
    return match_ranges(table_keys, prefix << rem_shift,
                        (prefix + 1) << rem_shift)


def join_idb_prefix(b: Bindings, table_keys, table_count, probe_vars,
                    pred_schema: Schema, n_key_cols: int, values, intro_vars,
                    out_cap) -> Bindings:
    """Join the bindings against an IDB table on a *prefix* of its columns:
    the table is sorted by its packed tuple, hence by any column prefix, so
    a range query finds every match without re-indexing the table."""
    b = _live(b)
    keys = table_keys[:int(table_count)]
    lo, matches = idb_prefix_ranges(b, keys, probe_vars, pred_schema,
                                    n_key_cols)
    return _join_capped(
        b, lo, matches,
        lambda ti: idb_intro(keys, values, ti, pred_schema, intro_vars),
        out_cap)
