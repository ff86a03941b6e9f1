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

Every other query goes through the tuple engine (``core.engine``), as in
the JAX service: a memoized template per (predicate, adornment) shape holds
the magic rewrite with its seed constants moved into a seed EDB relation
(or, where the magic program cannot plan, the demanded strata, evaluated
once per epoch and filtered per query); B same-shape queries run as ONE
qid-tagged fixpoint, whose state is snapshotted so that a monotone append
resumes the batch warm instead of recomputing it.

The service runs on ``cuda`` unless the caller passes ``device="cpu"``; on
the card every frontier iteration is a hand-written CUDA kernel
(``repro_torch.kernels``) except the dense plus-times product, a full-f32
``torch.matmul`` as in the JAX package, and the tuple engine's sorts,
searches and gathers are torch operations on the card; on the CPU the
kernels' plain versions run.

``mesh``, ``probe``, ``tracer``, ``durable_dir`` and a ``metrics``
registry raise ``NotImplementedError`` naming their ROADMAP item (A.6).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from ..core import sparse as _sparse
from ..core.engine import (CapacityError, Engine, as_query_literal,
                           query_row_mask, split_qid_answers)
from ..core.ir import Const, Literal, Program, Rule, fresh_var
from ..core.magic import (BOUND, FrontierLowering, MagicError, agg_positions,
                          attribute_qids, detect_frontier_lowering,
                          frontier_query_source, qid_batchable,
                          query_adornment)
from ..core.magic import rewrite as magic_rewrite
from ..core.parser import parse_program
from ..core.planner import PlanError, demanded_strata
from ..core.query import RowSet, unique_rows
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
    :class:`~repro_torch.service.cache.LRUCache`): the JAX service's, in its
    order, plus ``fixpoint_iterations``."""

    plans_built: int = 0  # templates constructed (magic rewrite + plan)
    plan_hits: int = 0  # queries served by a memoized template
    tuple_runs: int = 0  # PSN evaluations (template engine runs)
    dense_fixpoints: int = 0  # batched closure fixpoints launched (any repr)
    csr_fixpoints: int = 0  # ... of which ran the CSR-packed sparse engine
    batched_queries: int = 0  # queries answered by those fixpoints
    fixpoint_iterations: int = 0  # loop trips summed over those fixpoints
    tuple_fixpoints: int = 0  # qid-batched tuple fixpoints launched
    tuple_batched_queries: int = 0  # queries answered by those fixpoints
    appends: int = 0
    resumed_rows: int = 0  # cached closures refreshed by append-resume
    resumed_tuple_rows: int = 0  # tuple answers refreshed by snapshot resume
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


class _QueryTemplate:
    """Memoized evaluation template for one (predicate, adornment) shape.

    ``mode='magic'``: the magic-rewritten program with the seed fact swapped
    for a seed-EDB rule; per query only the seed rows change, so the plan is
    reused (and, in JAX's terms, the compiled fixpoints: the trace count
    does not move).

    ``mode='demand'``: fallback when the magic program cannot plan
    (cartesian magic prefixes, PreM violations through magic cycles, as in
    ``Engine._query_engine``).  The demanded-strata model is constant-free,
    so it evaluates once per epoch and every query of the shape
    post-filters it.
    """

    def __init__(self, svc: "DatalogService", q: Literal, adn: str):
        self.pred = q.pred
        self.adn = adn
        self.bound_positions = [i for i, c in enumerate(adn) if c == BOUND]
        self.seed_rel = f"__qseed_{q.pred}__{adn}"
        self._model_fresh = False
        self._mr = None
        self._qid_engine: Engine | None = None
        #: the last K batches' fixpoint snapshots (K = ``snapshot_lru``),
        #: keyed by the batch's query cache keys, oldest first
        self._snaps: "OrderedDict[tuple, _inc.TupleSnapshot]" = OrderedDict()
        self._eng_kw = eng_kw = dict(bits=svc.bits, default_cap=svc.default_cap,
                                     join_cap=svc.join_cap,
                                     max_iters=svc.max_iters,
                                     bucket_floors=svc.bucket_floors,
                                     device=svc.device)
        try:
            mr = magic_rewrite(svc.program, q)
            caps = dict(svc.caps)
            for name, orig in mr.aliases.items():
                if orig in svc.caps:
                    caps.setdefault(name, svc.caps[orig])
            self._caps = caps
            db = dict(svc.db)
            if mr.seed_rule is not None:
                db[self.seed_rel] = np.zeros((1, len(self.bound_positions)),
                                             np.int64)
            self.mode = "magic"
            self._mr = mr
            self.result_pred = mr.query_pred
            self.engine = Engine(self._parameterize(mr), db=db, caps=caps,
                                 **eng_kw)
        except (MagicError, PlanError):
            self.mode = "demand"
            self.result_pred = q.pred
            self.engine = Engine(demanded_strata(svc.program, q.pred),
                                 db=dict(svc.db), caps=dict(svc.caps), **eng_kw)
        #: EDB relations this template's (rewritten) program reads: appends
        #: to anything else leave its answers untouched
        self.reads = set(self.engine.source_program.edb_predicates())
        #: can B queries of this shape run as one qid-tagged fixpoint?
        self.batchable = self.mode == "magic" and qid_batchable(self._mr)
        #: is resuming the batched fixpoint warm sound under monotone
        #: appends (no negation, no additive aggregates)?
        self.resumable = (self.batchable
                          and _inc.resumable_program(self._mr.program))

    def _parameterize(self, mr) -> Program:
        rules, dropped = [], False
        for r in mr.program.rules:
            if not dropped and r is mr.seed_rule:
                dropped = True
                continue
            rules.append(r)
        if mr.seed_rule is not None:
            vs = tuple(fresh_var("_s") for _ in mr.seed_rule.head.args)
            rules.append(Rule(Literal(mr.seed_rule.head.pred, vs),
                              (Literal(self.seed_rel, vs),)))
        return Program(rules)

    def run(self, svc: "DatalogService", q: Literal):
        eng = self.engine
        if self.mode == "demand" or not self.bound_positions:
            # constant-free evaluation: the model answers every query of the
            # shape -- evaluate once per epoch, post-filter per query
            if not self._model_fresh:
                eng.invalidate().run()
                self._model_fresh = True
            return self._filter(q)
        consts = [[int(q.args[i].value) for i in self.bound_positions]]
        eng.db[self.seed_rel] = np.asarray(consts, np.int64)
        eng.invalidate(self.seed_rel).run()
        return self._filter(q)

    def _filter(self, q: Literal):
        """Restrict the evaluated model to the query goal: bound-position
        constants included (the demanded set may exceed the queried set),
        and repeated-variable equalities (``tc(X, X)``)."""
        eng = self.engine
        rows, vals = eng.materialized[self.result_pred]
        info = eng._pred_info[self.result_pred]
        mask = query_row_mask(q, rows, vals, info)
        if info.is_agg:
            return rows[mask], vals[mask]
        return rows[mask]

    # -- qid-batched evaluation ---------------------------------------------

    def _ensure_qid_engine(self, svc: "DatalogService") -> Engine:
        """Build (once) the batched twin: the same magic rewrite with a
        query-id column threaded through (``magic.attribute_qids``) and the
        seed EDB widened to (qid, consts..) rows."""
        if self._qid_engine is None:
            prog = attribute_qids(self._mr, seed_rel=self.seed_rel)
            db = dict(svc.db)
            db[self.seed_rel] = np.zeros(
                (1, 1 + len(self.bound_positions)), np.int64)
            self._qid_engine = Engine(prog.program, db=db, caps=self._caps,
                                      **self._eng_kw)
        return self._qid_engine

    def run_batch(self, svc: "DatalogService", qlits: list[Literal]) -> list:
        """Evaluate B same-shape queries as ONE tuple-path fixpoint and
        return per-query answers in order (storing the fixpoint's snapshot
        when the shape is resumable).  Raises (PlanError/CapacityError/
        ValueError) when the batch cannot run batched: callers fall back to
        sequential :meth:`run`."""
        eng = self._ensure_qid_engine(svc)
        seeds = np.asarray(
            [[qid] + [int(q.args[i].value) for i in self.bound_positions]
             for qid, q in enumerate(qlits)], np.int64)
        eng.db[self.seed_rel] = seeds
        eng.invalidate(self.seed_rel)
        eng.run()
        out = self._split(eng, qlits)
        if self.resumable and svc.snapshot_lru > 0:
            self._store_snap(svc, tuple(svc._cache_key(q) for q in qlits),
                             _inc.TupleSnapshot(seeds=seeds, qlits=list(qlits),
                                                state=dict(eng.materialized)))
        return out

    def _store_snap(self, svc: "DatalogService", key: tuple,
                    snap: _inc.TupleSnapshot) -> None:
        self._snaps[key] = snap
        self._snaps.move_to_end(key)
        while len(self._snaps) > svc.snapshot_lru:
            self._snaps.popitem(last=False)

    def _split(self, eng: Engine, qlits: list[Literal], qids=None) -> list:
        """Per-seed attribution (``engine.split_qid_answers``)."""
        rows, vals = eng.materialized[self.result_pred]
        info = eng._pred_info[self.result_pred]
        return split_qid_answers(self.result_pred, rows, vals, info, qlits,
                                 qids=qids)

    def resume_batch(self, svc: "DatalogService", snap_key: tuple,
                     keep: list[int] | None = None) -> list | None:
        """Re-run one snapshotted batch warm-started from its fixpoint state
        (same seeds, post-append EDB); returns [(qlit, answer)] for the cache
        refresh, or None when there is nothing to resume.  ``keep``
        restricts the resume to those snapshot positions (the hot entries):
        cold seeds and their warm rows are filtered out of the re-entered
        fixpoint and of the new snapshot."""
        snap = self._snaps.get(snap_key)
        if snap is None or not self.resumable:
            return None
        idx = list(range(len(snap.qlits))) if keep is None else sorted(keep)
        seeds = snap.seeds[idx]
        qids = [int(q) for q in seeds[:, 0]]  # original tags, non-contiguous
        qlits = [snap.qlits[i] for i in idx]
        state = snap.state
        if len(idx) < len(snap.qlits):
            state = {}
            for p, (rows, vals) in snap.state.items():
                m = np.isin(rows[:, 0], qids)
                state[p] = (rows[m], vals[m] if vals is not None else None)
        eng = self._qid_engine
        eng.db[self.seed_rel] = seeds
        eng.invalidate(self.seed_rel)
        eng.run(warm=state)
        out = self._split(eng, qlits, qids=qids)
        self._snaps[snap_key] = _inc.TupleSnapshot(
            seeds=seeds, qlits=qlits, state=dict(eng.materialized))
        return list(zip(qlits, out))

    def on_append(self, svc: "DatalogService", rel: str):
        for eng in (self.engine, self._qid_engine):
            if eng is None or rel not in eng.db:
                continue
            eng.db[rel] = svc.db[rel]
            eng.invalidate(rel)
        self._model_fresh = False
        if not self.resumable:
            self._snaps.clear()


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
    ``bucket_floors``  the tuple engine's settings (``core.engine.Engine``)
                      for every query that does not lower to a frontier.
    ``snapshot_lru``  batched tuple templates keep their last K batches'
                      fixpoint snapshots append-resumable (0 disables).

    ``snapshot_every``, ``keep_snapshots`` and ``durable_fsync`` are the
    JAX service's durability settings, stored as it stores them; ``mesh``,
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
        # the base engine owns db normalization + domain validation; sharing
        # its dict means appends reach it without copying
        self._base = Engine(program, db=db, bits=bits, caps=self.caps,
                            default_cap=default_cap, join_cap=join_cap,
                            max_iters=max_iters,
                            bucket_floors=self.bucket_floors,
                            device=self.device)
        self.db = self._base.db
        self.epoch = 0
        self.stats = ServiceStats()
        self.cache = LRUCache(result_cache)
        self._templates: dict[tuple[str, str], _QueryTemplate] = {}
        self._dense: dict[str, _DenseRelation] = {}
        self._lowerings: dict[str, FrontierLowering | None] = {}

    # -- queries -------------------------------------------------------------

    def ask(self, pred, args: tuple | None = None):
        """Answer one query (``Engine.ask`` forms): a batch of one."""
        return self.ask_batch([pred if args is None else (pred, args)])[0]

    def ask_batch(self, queries: list) -> list:
        """Answer a micro-batch of queries; returns answers in order.

        Single-source queries on the same decomposable predicate coalesce
        into one batched frontier fixpoint; same-(pred, adornment)-shape
        tuple queries coalesce into one qid-tagged tuple fixpoint (per-seed
        attribution splits it back per query); everything else runs through
        the memoized tuple templates one by one.  EDB queries are
        selections and cache hits return the cached answer.  Every computed
        answer lands in the result cache individually, so later singleton
        queries hit."""
        qlits = [self._as_literal(s) for s in queries]
        out: list = [None] * len(qlits)
        groups: dict[str, list[tuple[int, int]]] = {}
        singles: list[tuple[int, Literal]] = []
        for i, q in enumerate(qlits):
            ent = self.cache.get(self._cache_key(q))
            if ent is not None:
                if ent.epoch != self.epoch:
                    raise RuntimeError("a stale cache entry survived an "
                                       "append")
                out[i] = self._entry_result(ent)
            elif q.pred in self.db:  # EDB query: a pure selection
                out[i] = self._ask_edb(q)
            else:
                src = self._dense_source(q)
                if src is not None:
                    groups.setdefault(q.pred, []).append((i, src))
                else:
                    singles.append((i, q))
        for pred, items in groups.items():
            answers = self._run_group(pred, [src for _, src in items])
            for i, src in items:
                out[i] = answers[src]
        # same-shape tuple queries share one qid-tagged fixpoint; mixed
        # shapes never coalesce (no shared seed schema)
        shapes = _batch.coalesce_by_shape(
            singles, lambda q: (q.pred, self._adorn(q)))
        for (pred, adn), items in shapes.items():
            results = self._run_tuple_group(pred, adn, items)
            for key, res in results.items():
                self.cache.put(key, CacheEntry("tuple", pred, res,
                                               self.epoch))
            for i, q in items:
                out[i] = results[self._cache_key(q)]
        return out

    def append(self, rel: str, rows) -> "DatalogService":
        """Monotone EDB append: add facts, keep serving.  Cached closures of
        the predicates over ``rel`` resume from their pre-append rows, and
        batched tuple templates from their fixpoint snapshots
        (``incremental.py``), so hot entries stay warm; everything else (and
        under ``resume_min_hits`` / ``resume_max_bytes`` the cold tail) is
        invalidated."""
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
        self._base.invalidate(rel)
        for tpl in self._templates.values():
            tpl.on_append(self, rel)
        refreshed = self._resume_tuple_snapshots(rel)
        self.cache.drop_where(
            lambda k, e: e.kind == "tuple" and k not in refreshed)
        for _, e in self.cache.items():
            if e.kind == "dense" and self._lowering(e.pred).edb != rel:
                e.epoch = self.epoch  # untouched base relation: still valid
        for pred, ds in self._dense.items():
            if ds.low.edb == rel:
                self._refresh_dense(pred, ds, rows)
        return self

    def _resume_tuple_snapshots(self, rel: str) -> dict:
        """Resume batched tuple templates from their fixpoint snapshots and
        refresh the per-qid cache entries; returns {cache_key: entry} of the
        refreshed answers (everything else invalidates).  Under the resume
        policy, snapshots none of whose entries are hot are dropped, and
        only still-cached hot answers refresh."""
        refreshed: dict = {}
        for tpl in self._templates.values():
            for skey in list(tpl._snaps):  # the last K batches
                snap = tpl._snaps[skey]
                keys = [self._cache_key(q) for q in snap.qlits]
                cached = [(k, self.cache.peek(k)) for k in keys]
                if rel not in tpl.reads:
                    # the template never reads the appended relation: its
                    # answers are untouched -- revalidate
                    for k, e in cached:
                        if e is not None:
                            e.epoch = self.epoch
                            refreshed[k] = e
                    continue
                hot, cold = _inc.partition_resumable(
                    [((i, k), e) for i, (k, e) in enumerate(cached)
                     if e is not None], self.resume_min_hits,
                    self.resume_max_bytes)
                self.stats.dropped_cold += len(cold)
                if not hot:
                    del tpl._snaps[skey]
                    continue
                try:
                    # cold positions leave the resumed fixpoint (and the next
                    # snapshot) entirely
                    pairs = tpl.resume_batch(
                        self, skey, keep=[i for (i, _), _ in hot])
                except (PlanError, CapacityError, ValueError):
                    tpl._snaps.pop(skey, None)
                    continue
                for q, res in pairs:
                    key = self._cache_key(q)
                    ent = CacheEntry("tuple", tpl.pred, _freeze(res),
                                     self.epoch)
                    self.cache.replace(key, ent)
                    refreshed[key] = ent
                    self.stats.resumed_tuple_rows += 1
        return refreshed

    # -- introspection -------------------------------------------------------

    def explain(self) -> dict:
        """Introspection report, in the JAX service's schema: ``epoch``,
        ``service`` counters, ``cache`` counters, ``templates`` (the
        memoized ``pred/adornment`` shapes, ``+qid`` where batchable and
        ``+snapN`` with N resumable snapshots), per-predicate carrier reports under
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
            "templates": sorted(
                f"{p}/{a}" + ("+qid" if t.batchable else "")
                + (f"+snap{len(t._snaps)}" if t._snaps else "")
                for (p, a), t in self._templates.items()),
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

    def _ask_edb(self, q: Literal) -> np.ndarray:
        # Engine.ask owns the EDB-selection semantics (constant and repeated-
        # variable filters); the base engine shares this service's db dict
        return self._base.ask(q)

    def _dense_source(self, q: Literal) -> int | None:
        """The bound source of a frontier-lowered query, else None (the
        tuple path; repeated-variable tails go there too)."""
        if self._lowering(q.pred) is None:
            return None
        return frontier_query_source(q)

    def _adorn(self, q: Literal) -> str:
        return query_adornment(
            q, agg_positions(self.program).get(q.pred, -1))

    def _template(self, pred: str, adn: str,
                  q: Literal) -> tuple[_QueryTemplate, bool]:
        """Memoized template for a shape; returns (template, freshly_built)."""
        key = (pred, adn)
        tpl = self._templates.get(key)
        if tpl is None:
            tpl = _QueryTemplate(self, q, adn)
            self._templates[key] = tpl
            self.stats.plans_built += 1
            return tpl, True
        return tpl, False

    def _run_tuple_group(self, pred: str, adn: str, items) -> dict:
        """One (pred, adornment) shape group: the distinct queries as one
        qid-tagged fixpoint where the shape allows it, else each through
        its template.  Returns {cache_key: frozen answer}."""
        uniq: list[tuple[object, Literal]] = []
        seen: set = set()
        for _, q in items:
            key = self._cache_key(q)
            if key not in seen:
                seen.add(key)
                uniq.append((key, q))
        answers = None
        if len(uniq) > 1 and BOUND in adn:
            answers = self._run_tuple_batch(pred, adn, uniq)
        if answers is None:  # singleton / unbatchable: sequential path
            return {key: _freeze(self._ask_tuple(q)) for key, q in uniq}
        return {key: _freeze(res) for (key, _), res in zip(uniq, answers)}

    def _run_tuple_batch(self, pred: str, adn: str, uniq: list):
        """B same-shape tuple queries as ONE qid-tagged fixpoint; None to
        fall back to sequential runs (shape not batchable, or the union of
        demands overflowed a table)."""
        tpl, fresh = self._template(pred, adn, uniq[0][1])
        if not tpl.batchable:
            return None
        try:
            answers = tpl.run_batch(self, [q for _, q in uniq])
        except (PlanError, CapacityError, ValueError):
            return None
        self.stats.plan_hits += len(uniq) - (1 if fresh else 0)
        self.stats.tuple_runs += 1
        self.stats.tuple_fixpoints += 1
        self.stats.tuple_batched_queries += len(uniq)
        return answers

    def _ask_tuple(self, q: Literal):
        tpl, fresh = self._template(q.pred, self._adorn(q), q)
        if not fresh:
            self.stats.plan_hits += 1
        self.stats.tuple_runs += 1
        return tpl.run(self, q)

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
