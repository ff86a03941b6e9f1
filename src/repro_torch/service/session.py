"""``DatalogService`` — load a program + EDB once, answer query streams fast.

Port of ``repro.service.session`` for the serving main path: batched
single-source queries on a decomposable recursive predicate over all four
carriers — bool (``tc(s, X)``), min-plus (``dpath(s, X, min<D>)``),
max-plus (``lpath(s, X, max<D>)``) and plus-times (``cpath(s, X,
sum<C>)``; an acyclic EDB, else ``FixpointDivergenceError``).  B queries on
one predicate coalesce into ONE (B, n) frontier fixpoint (``batch.py``) over
the relation's carrier, a dense matrix or a sliced-ELL CSR picked by the
density heuristic, and every answer lands in an LRU result cache.
Monotone EDB appends resume cached closures from the new-fact delta
(``incremental.py``) instead of recomputing them, and ``tune=`` lays CSR
relations out by the autotuner (``kernels.autotune``): min-plus relations
with a tile-skip plan then step through K7.

    svc = DatalogService(TC, db={"arc": edges})          # on the card
    svc.ask("tc", (1, None))
    svc.ask_batch([("tc", (s, None)) for s in sources])  # one fixpoint
    svc.append("arc", [[7, 8]])                          # resume, don't recompute

The service runs on ``cuda`` unless the caller passes ``device="cpu"``; on
the card every fixpoint iteration is a hand-written CUDA kernel
(``repro_torch.kernels``) except the dense plus-times product, a full-f32
``torch.matmul`` as in the JAX package; on the CPU the kernels' plain
versions run.

What the JAX service does beyond this path raises ``NotImplementedError``
naming its ROADMAP item: the tuple engine with the modules built on it —
non-frontier queries, ``mesh``, ``probe``, ``tracer`` and ``durable_dir``
(A.6).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import sparse as _sparse
from ..core.ir import Const, Literal
from ..core.magic import (FrontierLowering, detect_frontier_lowering,
                          frontier_query_source)
from ..core.parser import parse_program
from ..core.query import (PlanError, RowSet, as_query_literal, normalize_db,
                          query_row_mask, unique_rows)
from ..core.semiring import BOOL, MIN_PLUS, carrier_for, edge_arity
from ..device import resolve_device
from ..kernels import autotune as _at
from . import batch as _batch
from . import incremental as _inc
from .cache import CacheEntry, LRUCache


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


@dataclasses.dataclass
class ServiceStats:
    """Evaluation-side counters (result-cache counters live on the
    :class:`~repro_torch.service.cache.LRUCache`)."""

    dense_fixpoints: int = 0  # batched closure fixpoints launched (any repr)
    csr_fixpoints: int = 0  # ... of which ran the CSR-packed sparse engine
    batched_queries: int = 0  # queries answered by those fixpoints
    fixpoint_iterations: int = 0  # loop trips summed over those fixpoints
    appends: int = 0
    resumed_rows: int = 0  # cached closures refreshed by append-resume
    dropped_cold: int = 0  # cold entries evicted instead of resumed


def _freeze(res):
    """Mark a cached answer's arrays read-only: cache hits hand out the SAME
    arrays, so a caller mutating an answer must fail loudly."""
    for a in res if isinstance(res, tuple) else (res,):
        a.flags.writeable = False
    return res


class _DenseRelation:
    """Carrier state for one decomposable predicate: dense matrix OR CSR,
    packed on the service's device and maintained under appends.
    ``svc.sparse`` forces a representation; ``None`` lets the density
    heuristic pick (below ``sparse_threshold`` the CSR segment engine
    replaces the ``n_align``-rounded O(n²) matrix behind the same batching
    interface).  The choice is re-made at every rebuild (domain growth, a
    tail fold), which may flip the carrier."""

    def __init__(self, svc: "DatalogService", low: FrontierLowering):
        self.low = low
        self.sr = carrier_for(low.kind)
        self.n = 0
        self.n_alloc = 0
        self.matrix = None
        self.csr = None
        self.flips = 0  # representation changes across rebuilds
        self.last_flip: str | None = None
        self.tuning: dict | None = None  # autotuner report (tune= on)
        self.last_delta = np.zeros((0, edge_arity(low.kind)), np.int64)
        self._rebuild(svc)

    @property
    def is_csr(self) -> bool:
        return self.csr is not None

    def _rebuild(self, svc: "DatalogService"):
        prev = None if (self.matrix is None and self.csr is None) else \
            ("csr" if self.is_csr else "dense")
        edges = svc.db.get(self.low.edb, np.zeros((0, edge_arity(self.low.kind)),
                                                  np.int64))
        if not self.sr.idempotent:
            # additive ⊕ is set-semantics over arcs: exact duplicate facts
            # collapse before they can double-count, and the arc set filters
            # appends down to genuinely new arcs
            if len(edges):
                edges = unique_rows(edges, svc.bits)
            self._arcs = RowSet(edges, svc.bits)
        n = int(edges[:, :2].max()) + 1 if len(edges) else 0
        align = svc.n_align
        self.n = n
        self.n_alloc = max(((n + align - 1) // align) * align, align)
        use_csr = svc.sparse
        if use_csr is None:
            # density over the LIVE domain, not the align-padded allocation
            use_csr = _sparse.prefer_csr(len(edges), n, svc.sparse_threshold)
        self.matrix = self.csr = None
        if use_csr:
            cfg = svc._tuned_config(self, edges)
            if cfg is None:
                self.csr = _sparse.build_csr(edges, self.n_alloc,
                                             self.low.kind, device=svc.device)
            else:
                self.csr = _at.build_tuned(edges, self.n_alloc, self.low.kind,
                                           cfg, device=svc.device)
        elif self.sr is BOOL:
            adj = np.zeros((self.n_alloc, self.n_alloc), bool)
            if len(edges):
                adj[edges[:, 0], edges[:, 1]] = True
            self.matrix = torch.from_numpy(adj).to(svc.device)
        else:
            # ⊕-zero fill (+inf for min-plus, -inf for max-plus, 0 for
            # plus-times) and the ⊕ scatter folds parallel arcs (min/max; the
            # additive arcs are distinct, so += sums each exactly once)
            w = np.full((self.n_alloc, self.n_alloc), self.sr.zero, np.float32)
            if len(edges):
                scatter = (np.minimum if self.sr is MIN_PLUS
                           else np.maximum if self.sr.idempotent else np.add)
                scatter.at(w, (edges[:, 0], edges[:, 1]),
                           edges[:, 2].astype(np.float32))
            self.matrix = torch.from_numpy(w).to(svc.device)
        now = "csr" if use_csr else "dense"
        if prev is not None and prev != now:
            self.flips += 1
            self.last_flip = f"{prev}->{now}"

    def seed_rows(self, srcs) -> torch.Tensor:
        """The (B, n_alloc) frontier rows ``A[srcs]`` in the carrier (on the
        card, a CSR's go through its step kernel)."""
        if self.is_csr:
            return _sparse.rows_from_sources(self.csr, srcs)
        idx = torch.from_numpy(np.asarray(srcs, np.int64)).to(self.matrix.device)
        return self.matrix[idx]

    def run_batch(self, svc: "DatalogService", srcs: list[int], init=None):
        """One batched frontier fixpoint over this relation's carrier
        (``init`` overrides the seed: append-resume)."""
        if self.is_csr:
            return _batch.run_frontier_batch_csr(self.csr, srcs,
                                                 svc.batch_pads, init=init)
        return _batch.run_frontier_batch(self.sr, self.matrix, srcs,
                                         svc.batch_pads, init=init)

    def append(self, svc: "DatalogService", rows: np.ndarray) -> bool:
        """Fold appended arcs in; True when the domain outgrew the
        allocation (a rebuild: cached rows need re-padding).  For the
        additive carrier the rows are first cut to the genuinely new arcs,
        kept on :attr:`last_delta` for the increment replay."""
        if not self.sr.idempotent:
            rows = self._arcs.new(rows)
        self.last_delta = rows
        new_n = max(self.n, int(rows[:, :2].max()) + 1 if len(rows) else 0)
        if new_n > self.n_alloc:
            self._rebuild(svc)  # svc.db already holds the appended relation
            return True
        self.n = new_n
        if not len(rows):
            return False
        if not self.sr.idempotent:
            self._arcs.add(rows)
        if self.is_csr:
            if _sparse.tail_will_rebuild(self.csr, len(rows),
                                         svc.csr_rebuild_frac):
                # the tail outgrew the spine: a full rebuild, which re-runs
                # the density heuristic (a densified graph flips back to the
                # dense matrix) and the tuned config
                self._rebuild(svc)
            else:  # the additive rows are filtered already
                self.csr = _sparse.csr_append_new(self.csr, rows,
                                                  svc.csr_rebuild_frac)
            return False
        # the dense matrix is updated in place on its device
        dev = self.matrix.device
        r = torch.from_numpy(rows[:, 0]).to(dev)
        c = torch.from_numpy(rows[:, 1]).to(dev)
        if self.sr is BOOL:
            self.matrix[r, c] = True
        elif self.sr.idempotent:
            vals = torch.from_numpy(rows[:, 2].astype(np.float32)).to(dev)
            self.matrix.view(-1).scatter_reduce_(
                0, r * self.n_alloc + c, vals,
                "amin" if self.sr is MIN_PLUS else "amax")
        else:  # the rows are distinct new arcs: each adds once
            vals = torch.from_numpy(rows[:, 2].astype(np.float32)).to(dev)
            self.matrix.index_put_((r, c), vals, accumulate=True)
        return False

    def report(self) -> dict:
        rep = {"n": self.n, "n_alloc": self.n_alloc, "semiring": self.sr.name,
               "repr": "csr" if self.is_csr else "dense"}
        if self.flips:
            rep.update(flips=self.flips, last_flip=self.last_flip)
        if self.is_csr:
            rep.update(nnz=int(self.csr.nnz) + int(self.csr.tail_nnz),
                       density=self.csr.density(), e_alloc=self.csr.e_alloc,
                       padding=self.csr.padding_waste())
        return rep


class DatalogService:
    """A resident Datalog query server over one program + EDB.

    ``device``        where carriers live and fixpoints run: ``None`` is the
                      card (raises on a host without one), ``"cpu"`` runs the
                      kernels' plain versions.
    ``bits``          packed-domain width; EDB values and query constants
                      must fit it.
    ``result_cache``  LRU capacity for whole-answer caching (0 disables).
    ``matmul``        ``None`` or ``'pallas'``: both mean this device's
                      implementation (the CUDA kernels on the card, their
                      plain versions on the CPU).
    ``batch_pads``    batch-size quantization levels (⊕-zero pad rows), as
                      in the JAX service, so iteration counts agree with it.
    ``n_align``       dense domain-size alignment (appends that stay under
                      the allocation keep the carrier's shape).
    ``resume_min_hits``  eviction-aware append resume: cached entries that
                      served fewer queries than this since their last
                      (re)compute are dropped on append instead of resumed
                      (0 = resume everything).
    ``resume_max_bytes``  per append, entries resume hottest-first until
                      their resident bytes exceed this budget; the rest
                      drop (0 = no budget).
    ``sparse``        True forces the CSR carrier, False the dense matrix,
                      None (default) picks per relation by density
                      (< ``sparse_threshold`` -> CSR).
    ``sparse_threshold``  the heuristic's |E|/n² cut (None = library
                      default, ``core.sparse.DEFAULT_SPARSE_THRESHOLD``).
    ``csr_rebuild_frac``  appended arcs fold from the CSR's COO tail into
                      the spine when the tail outgrows this fraction of it.
    ``tune``          CSR layout tuning (``kernels.autotune``): ``True``
                      runs the measured search at every CSR (re)build
                      (cached per graph-shape signature), a pinned
                      :class:`~repro_torch.kernels.autotune.KernelConfig`
                      applies as it is, ``None``/``False`` keeps the
                      library layout.  A config with ``use_kernel`` gives
                      min-plus relations a tile-skip plan, served by K7.

    ``caps``, ``default_cap``, ``join_cap``, ``max_iters``,
    ``bucket_floors`` and ``snapshot_lru`` are the JAX service's tuple-engine
    and tuple-template settings, and ``snapshot_every``, ``keep_snapshots``
    and ``durable_fsync`` its durability settings: none of them acts on the
    frontier path (the JAX frontier batches take their own iteration
    bound), so they are stored as the JAX service stores them.  ``mesh``,
    ``probe``, ``tracer``, ``durable_dir`` and a ``metrics`` registry exist
    for signature parity with the JAX service and raise until ported.
    """

    def __init__(self, program, db: dict[str, np.ndarray], *, bits: int = 18,
                 caps: dict[str, int] | None = None, default_cap: int = 1 << 16,
                 join_cap: int | None = None, max_iters: int = 1 << 16,
                 constants: dict[str, int] | None = None,
                 result_cache: int = 1024, matmul=None, mesh=None,
                 batch_pads: tuple[int, ...] = (1, 8, 32, 128),
                 n_align: int = 128, resume_min_hits: int = 0,
                 resume_max_bytes: int = 0, sparse: bool | None = None,
                 sparse_threshold: float | None = None,
                 csr_rebuild_frac: float = 0.25, snapshot_lru: int = 1,
                 bucket_floors: dict[str, int] | None = None,
                 tune=None, metrics=None, tracer=None, probe: bool = False,
                 durable_dir=None, snapshot_every: int = 0,
                 keep_snapshots: int = 3, durable_fsync: bool = True,
                 device=None):
        if matmul not in (None, "pallas"):
            raise ValueError(f"matmul must be None or 'pallas', got {matmul!r}")
        for name, value, item in (("mesh", mesh is not None, "A.6"),
                                  ("probe", probe, "A.6"),
                                  ("tracer", bool(tracer), "A.6"),
                                  ("metrics", metrics not in (None, False),
                                   "A.6"),
                                  ("durable_dir", durable_dir is not None,
                                   "A.6")):
            if value:
                raise _not_ported(f"DatalogService({name}=...)", item)
        self.device = resolve_device(device)
        if isinstance(program, str):
            program = parse_program(program, constants=constants)
        self.program = program
        self.bits = bits
        self.caps = dict(caps or {})
        self.default_cap = default_cap
        self.join_cap = join_cap
        self.max_iters = max_iters
        self.snapshot_lru = snapshot_lru
        self.bucket_floors = dict(bucket_floors or {})
        self.snapshot_every = snapshot_every
        self.keep_snapshots = keep_snapshots
        self.durable_fsync = durable_fsync
        self.batch_pads = tuple(batch_pads)
        self.n_align = n_align
        self.resume_min_hits = resume_min_hits
        self.resume_max_bytes = resume_max_bytes
        self.sparse = sparse
        self.sparse_threshold = (sparse_threshold
                                 if sparse_threshold is not None
                                 else _sparse.DEFAULT_SPARSE_THRESHOLD)
        self.csr_rebuild_frac = csr_rebuild_frac
        self.tune = tune
        self.db = normalize_db(db, bits)
        self.epoch = 0
        self.stats = ServiceStats()
        self.cache = LRUCache(result_cache)
        self._dense: dict[str, _DenseRelation] = {}
        self._lowerings: dict[str, FrontierLowering | None] = {}

    # -- queries -------------------------------------------------------------

    def ask(self, pred, args: tuple | None = None):
        """Answer one query (``Engine.ask`` forms): a batch of one."""
        return self.ask_batch([pred if args is None else (pred, args)])[0]

    def ask_batch(self, queries: list) -> list:
        """Answer a micro-batch of queries; returns answers in order.

        Single-source queries on the same decomposable predicate coalesce
        into one batched frontier fixpoint; EDB queries are selections;
        cache hits return the cached answer.  Every computed answer lands in
        the result cache individually, so later singleton queries hit."""
        qlits = [self._as_literal(s) for s in queries]
        out: list = [None] * len(qlits)
        groups: dict[str, list[tuple[int, int]]] = {}
        for i, q in enumerate(qlits):
            ent = self.cache.get(self._cache_key(q))
            if ent is not None:
                if ent.epoch != self.epoch:
                    raise RuntimeError("a stale cache entry survived an "
                                       "append")
                out[i] = self._entry_result(ent)
            elif q.pred in self.db:  # EDB query: a pure selection
                rows = self.db[q.pred]
                out[i] = rows[query_row_mask(q, rows)]
            else:
                groups.setdefault(q.pred, []).append((i, self._frontier(q)))
        for pred, items in groups.items():
            answers = self._run_group(pred, [src for _, src in items])
            for i, src in items:
                out[i] = answers[src]
        return out

    def append(self, rel: str, rows) -> "DatalogService":
        """Monotone EDB append: add facts, keep serving.  Cached closures of
        the predicates over ``rel`` resume from their pre-append rows
        (``incremental.py``) and stay warm; under ``resume_min_hits`` /
        ``resume_max_bytes`` the cold tail is dropped instead."""
        if rel not in self.db:
            raise ValueError(
                f"{rel!r} is not an EDB relation of this service "
                f"(known: {sorted(self.db)}); appends are EDB-only")
        rows = _inc.validate_append(rows, self.db[rel].shape[1], self.bits)
        # EDB relations stay sets under appends
        self.db[rel] = unique_rows(np.concatenate([self.db[rel], rows]),
                                   self.bits)
        self.epoch += 1
        self.stats.appends += 1
        for _, e in self.cache.items():
            if e.kind == "dense" and self._lowering(e.pred).edb != rel:
                e.epoch = self.epoch  # untouched base relation: still valid
        for pred, ds in self._dense.items():
            if ds.low.edb == rel:
                self._refresh_dense(pred, ds, rows)
        return self

    # -- introspection -------------------------------------------------------

    def explain(self) -> dict:
        """Introspection report, in the JAX service's schema: ``epoch``,
        ``service`` counters, ``cache`` counters, ``templates`` (always
        empty: no tuple engine yet), per-predicate carrier reports under
        ``relations`` (``{n, n_alloc, semiring, repr}`` plus ``flips``/
        ``last_flip`` after a representation flip and ``nnz``/``density``/
        ``e_alloc``/``padding`` for CSR) and ``kernels``, which holds a
        ``tuning`` entry per tuned predicate when ``tune=`` is on (the
        roofline attribution of the JAX service comes with A.6)."""
        rep = {
            "epoch": self.epoch,
            "service": dataclasses.asdict(self.stats),
            "cache": {"entries": len(self.cache), "hits": self.cache.hits,
                      "misses": self.cache.misses,
                      "evictions": self.cache.evictions},
            "templates": [],
            "relations": {p: ds.report() for p, ds in self._dense.items()},
            "kernels": {},
        }
        tuning = {p: ds.tuning for p, ds in self._dense.items() if ds.tuning}
        if tuning:
            rep["kernels"]["tuning"] = tuning
        return rep

    # -- internals -----------------------------------------------------------

    def _as_literal(self, spec) -> Literal:
        q = as_query_literal(spec)
        limit = (1 << self.bits) - 1
        for a in q.args:
            if isinstance(a, Const) and not (0 <= a.value <= limit):
                raise ValueError(
                    f"query constant {a.value} exceeds the {self.bits}-bit "
                    "packed domain")
        if q.pred in self.db:
            arity = self.db[q.pred].shape[1]
        elif q.pred in self.program.idb_predicates():
            arity = self.program.rules_for(q.pred)[0].head.arity
        else:
            raise PlanError(f"unknown predicate {q.pred!r}")
        if len(q.args) != arity:
            raise PlanError(
                f"query {q!r} has arity {len(q.args)} but {q.pred} has "
                f"arity {arity}")
        return q

    def _cache_key(self, q: Literal):
        # free positions key on their variable-repetition pattern, not just
        # "free": tc(X, Y) and tc(X, X) are different queries
        seen: dict[str, int] = {}
        return (q.pred,) + tuple(
            int(a.value) if isinstance(a, Const)
            else f"~{seen.setdefault(a.name, i)}"
            for i, a in enumerate(q.args))

    def _lowering(self, pred: str) -> FrontierLowering | None:
        if pred not in self._lowerings:
            self._lowerings[pred] = detect_frontier_lowering(self.program, pred)
        return self._lowerings[pred]

    def _frontier(self, q: Literal) -> int:
        """The bound source of a frontier-lowered query; anything else needs
        the tuple engine that is not ported yet."""
        low = self._lowering(q.pred)
        src = frontier_query_source(q) if low is not None else None
        if src is None:
            raise _not_ported(f"query {q!r} (the tuple engine)", "A.6")
        return src

    def _dense_state(self, pred: str) -> _DenseRelation:
        if pred not in self._dense:
            self._dense[pred] = _DenseRelation(self, self._lowering(pred))
        return self._dense[pred]

    def _tuned_config(self, ds: _DenseRelation, edges):
        """The kernel config of a CSR (re)build under ``tune=``: a pinned
        :class:`~repro_torch.kernels.autotune.KernelConfig` as it is,
        ``True`` the measured search on this service's device (cached per
        graph-shape signature); None when tuning is off."""
        if not self.tune:
            ds.tuning = None
            return None
        if isinstance(self.tune, _at.KernelConfig):
            ds.tuning = {"config": self.tune.as_dict(), "pinned": True}
            return self.tune
        res = _at.autotune(edges, ds.n_alloc, ds.low.kind, device=self.device)
        ds.tuning = {**res.as_dict(), "pinned": False}
        return res.config

    def _entry_result(self, ent: CacheEntry):
        if ent.result is None:  # append-resumed entry: format on first serve
            ent.result = _freeze(self._format(self._dense_state(ent.pred),
                                              ent.src, ent.raw))
        return ent.result

    def _refresh_dense(self, pred: str, ds: _DenseRelation,
                       new_rows: np.ndarray):
        """Fold an append into ``pred``'s carrier, then resume its cached
        closures as ONE batched fixpoint (idempotent carriers: from prev ⊕
        the new seed rows; the additive one: the increment replay, added to
        prev) and refresh the entries; cold ones drop under the resume
        policy."""
        grown = ds.append(self, new_rows)
        entries, cold = _inc.partition_resumable(
            [(k, e) for k, e in self.cache.items()
             if e.kind == "dense" and e.pred == pred], self.resume_min_hits,
            self.resume_max_bytes)
        if cold:
            cold_keys = {k for k, _ in cold}
            self.stats.dropped_cold += self.cache.drop_where(
                lambda k, e: k in cold_keys)
        if not entries:
            return
        srcs = [e.src for _, e in entries]
        prev = torch.from_numpy(np.stack([e.raw for _, e in entries])).to(
            self.device)
        if grown:
            prev = _inc.pad_rows(prev, ds.n_alloc, ds.sr.zero)
        res = None
        if ds.sr.idempotent:
            res = ds.run_batch(self, srcs, init=_inc.resume_init(
                ds.sr, prev, ds.seed_rows(srcs)))
            table = res.table[:len(srcs)]
        elif not len(ds.last_delta):
            # additive, nothing genuinely new (exact-duplicate appends): set
            # semantics keeps every total; revalidate only
            table = prev
        else:
            res = ds.run_batch(self, srcs, init=_inc.replay_init(
                ds.sr, prev, srcs, ds.last_delta, ds.n_alloc))
            table = prev + res.table[:len(srcs)]
        if res is not None:
            self.stats.dense_fixpoints += 1
            self.stats.csr_fixpoints += 1 if ds.is_csr else 0
            self.stats.fixpoint_iterations += res.iterations
        self.stats.resumed_rows += len(entries)
        table = table.cpu().numpy()
        for j, (key, e) in enumerate(entries):
            # result=None: the answer is formatted at the entry's next hit
            self.cache.replace(key, CacheEntry(
                "dense", pred, None, self.epoch, src=e.src, raw=table[j]))

    def _format(self, ds: _DenseRelation, src: int, row: np.ndarray):
        if ds.low.kind == "bool":
            return _batch.format_bool_row(src, row, ds.n)
        if ds.low.kind == "plustimes":
            return _batch.format_plustimes_row(src, row, ds.n)
        if ds.low.kind == "maxplus":
            return _batch.format_maxplus_row(src, row, ds.n)
        return _batch.format_minplus_row(src, row, ds.n)

    def _run_group(self, pred: str, srcs: list[int]) -> dict:
        """ONE batched fixpoint for the distinct in-domain sources of a
        group, then one host transfer of their rows; sources beyond the
        allocated domain reach nothing.  Returns ``{src: answer}``."""
        ds = self._dense_state(pred)
        uniq = list(dict.fromkeys(srcs))
        in_range = [s for s in uniq if s < ds.n_alloc]
        answers = {}
        if in_range:
            res = ds.run_batch(self, in_range)
            table = res.table[:len(in_range)].cpu().numpy()
            self.stats.dense_fixpoints += 1
            self.stats.csr_fixpoints += 1 if ds.is_csr else 0
            self.stats.batched_queries += len(in_range)
            self.stats.fixpoint_iterations += res.iterations
            for j, s in enumerate(in_range):
                ans = _freeze(self._format(ds, s, table[j]))
                key = (pred, s) + tuple(
                    f"~{i}" for i in range(1, edge_arity(ds.low.kind)))
                self.cache.put(key, CacheEntry("dense", pred, ans, self.epoch,
                                               src=s, raw=table[j]))
                answers[s] = ans
        for s in uniq:
            if s not in answers:
                answers[s] = self._format(ds, s,
                                          np.full((0,), ds.sr.zero,
                                                  np.float32))
        return answers
