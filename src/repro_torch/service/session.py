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

Observability threads through the whole path as in the JAX service
(``repro_torch.obs``): ``tracer=True`` records Chrome-exportable spans,
``svc.metrics`` is the unified counter/histogram registry, ``probe=True``
routes the frontier fixpoints through their probed twins, and
``explain()["kernels"]`` attributes every batched fixpoint to its kernel
against the H100 roofline.  :meth:`DatalogService.ask_batch` is
:meth:`~DatalogService.launch_batch` then
:meth:`~DatalogService.finalize_batch`: a launch runs the fixpoints and
copies their tables to the host, the finalize formats them, so the
admission front-end (``admission.py``) can format batch *k* on one thread
while batch *k+1*'s fixpoint runs on another.

``durable_dir=`` makes the service crash-safe (``durable.py``): every
append is written ahead to a log before anything changes, :meth:`snapshot`
hands a copy of the serving state to a background writer, and a service
built on the same directory recovers warm from the newest complete snapshot
plus the log's suffix, in the JAX package's file formats.

``mesh=`` (a ``core.distributed.WorkerMesh``, ``launch.mesh.
make_worker_mesh``) shards every idempotent frontier batch Fig.-4 style
(``batch.py``): each shard closes its rows against the broadcast carrier,
and the only collective in the loop is the scalar convergence ``psum``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from ..core import sparse as _sparse
from ..core.engine import (CapacityError, Engine, as_query_literal,
                           fixpoint_trace_count, query_row_mask,
                           split_qid_answers)
from ..core.ir import Const, Literal, Program, Rule, Var, fresh_var  # noqa: F401
from ..core.magic import (BOUND, FrontierLowering, MagicError, agg_positions,
                          attribute_qids, detect_frontier_lowering,
                          frontier_query_source, qid_batchable,
                          query_adornment)
from ..core.magic import rewrite as magic_rewrite
from ..core.parser import parse_program
from ..core.planner import PlanError, demanded_strata
from ..core.query import RowSet, unique_rows
from ..core.semiring import BOOL, MIN_PLUS, carrier_for, edge_arity
from ..device import canonical_device, resolve_device
from ..kernels import autotune as _at
from ..obs.metrics import NULL_METRICS, MetricsRegistry
from ..obs.roofline_attr import (KernelAttribution, csr_launch_cost,
                                 dense_launch_cost)
from ..obs.trace import NULL_TRACER, Tracer
from . import batch as _batch
from . import incremental as _inc
from .cache import CacheEntry, LRUCache


#: batch-size histogram buckets (queries per launched batch)
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


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


class _DenseLaunch:
    """One launched batched fixpoint and its rows on the host.

    The fixpoint's host loop reads its counters back every iteration, so
    its kernels have all run when the launch returns; the rows are then
    copied to the host on the same stream.  On the card two events around
    the fixpoint time it: its device wall time, the gaps in which the card
    waits for the host loop included."""

    def __init__(self, ds: "_DenseRelation", svc: "DatalogService",
                 srcs: list[int]):
        self.b = len(srcs)
        self.events = None
        if svc.device.type != "cuda":
            t0 = time.perf_counter()
            res = ds.run_batch(svc, srcs)
            self._seconds = time.perf_counter() - t0
        else:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            res = ds.run_batch(svc, srcs)
            stop.record()
            self.events = (start, stop)
        self.table = res.table[:self.b].cpu().numpy()
        self.iterations = res.iterations

    def seconds(self) -> float:
        """The fixpoint's device wall time (CUDA events), or its wall time
        on the CPU."""
        if self.events is None:
            return self._seconds
        start, stop = self.events
        return start.elapsed_time(stop) / 1e3


@dataclasses.dataclass
class _PendingBatch:
    """In-flight state between :meth:`DatalogService.launch_batch` and
    :meth:`DatalogService.finalize_batch` — the double-buffering unit of the
    admission front-end: the launched fixpoints plus everything the host
    finalize needs without touching shared engine state again."""

    epoch: int  # service epoch at launch; finalize asserts it is unchanged
    qlits: list
    out: list  # answer slots; EDB selections fill at launch
    hits: list = dataclasses.field(default_factory=list)  # (slot, CacheEntry)
    #: [(pred, _DenseRelation, items, uniq_srcs, in_range, _DenseLaunch|None)]
    dense: list = dataclasses.field(default_factory=list)
    #: [(pred, items, uniq, (template, launched)|None, results|None)]
    tuples: list = dataclasses.field(default_factory=list)


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
        (``init`` overrides the seed: append-resume).  In probe mode the
        probed twin runs instead (bit-identical result) and its
        observations land on ``svc.last_probes``."""
        if self.is_csr:
            res = _batch.run_frontier_batch_csr(self.csr, srcs,
                                                svc.batch_pads,
                                                mesh=svc.mesh, init=init,
                                                probe=svc.probe)
        else:
            res = _batch.run_frontier_batch(self.sr, self.matrix, srcs,
                                            svc.batch_pads, mesh=svc.mesh,
                                            init=init, probe=svc.probe)
        if svc.probe:
            res, pr = res
            if pr is not None:
                svc._record_probe(pr)
        return res

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

    def launch_batch(self, svc: "DatalogService", qlits: list[Literal]) -> dict:
        """Evaluate B same-shape queries as ONE qid-tagged tuple fixpoint and
        *capture* the materialized model, since the admission front-end may
        launch the next flush on this template while this one's split still
        runs.  Raises (PlanError/CapacityError/ValueError) when the batch
        cannot run batched: callers fall back to sequential :meth:`run`."""
        eng = self._ensure_qid_engine(svc)
        seeds = np.asarray(
            [[qid] + [int(q.args[i].value) for i in self.bound_positions]
             for qid, q in enumerate(qlits)], np.int64)
        eng.db[self.seed_rel] = seeds
        eng.invalidate(self.seed_rel)
        eng.run()
        return dict(seeds=seeds, qlits=list(qlits),
                    model=eng.materialized[self.result_pred],
                    info=eng._pred_info[self.result_pred],
                    state=dict(eng.materialized))

    def finalize_launched(self, svc: "DatalogService", launched: dict) -> list:
        """Per-query answers of a :meth:`launch_batch`, in order: per-qid
        attribution over the captured model, and the snapshot stored when
        the shape is resumable; host work over the launch's own arrays
        (safe to overlap with the next flush's fixpoint)."""
        rows, vals = launched["model"]
        qlits = launched["qlits"]
        out = split_qid_answers(self.result_pred, rows, vals,
                                launched["info"], qlits)
        if self.resumable and svc.snapshot_lru > 0:
            self._store_snap(svc, tuple(svc._cache_key(q) for q in qlits),
                             _inc.TupleSnapshot(seeds=launched["seeds"],
                                                qlits=qlits,
                                                state=launched["state"]))
        return out

    def _store_snap(self, svc: "DatalogService", key: tuple,
                    snap: _inc.TupleSnapshot) -> None:
        with svc.lock:  # finalize may run off the service lock (admission)
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

    ``metrics``       unified metrics registry (``obs.metrics``): ``None``/
                      ``True`` creates one (per-batch observes only),
                      ``False`` disables it (``NULL_METRICS``), or pass a
                      shared ``MetricsRegistry``.
    ``tracer``        span tracer (``obs.trace``): ``None``/``False`` is the
                      no-op ``NULL_TRACER``, ``True`` creates a recording
                      ``Tracer``, or pass one.
    ``probe``         route dense/CSR frontier fixpoints through the probed
                      twins (``obs.fixpoint_probe``): results stay
                      bit-identical, per-iteration frontier/Δ observations
                      accumulate on ``last_probes`` and ``explain()``.

    ``durable_dir``   crash-safe persistence root (``service/durable.py``):
                      every append is logged before it mutates anything,
                      :meth:`snapshot` publishes the serving state in the
                      background, and construction recovers from the newest
                      complete snapshot plus the log's suffix (older
                      generations, then a cold rebuild, on corruption).
                      ``explain()["durability"]`` reports what happened.
    ``snapshot_every``  auto-snapshot after every N logged appends
                      (0 = explicit :meth:`snapshot` calls only).
    ``keep_snapshots``  snapshot generations retained for the fallback.
    ``durable_fsync``  fsync the log per append (True); False trades the
                      tail's durability for append latency.

    ``mesh``          a worker mesh (``launch.mesh.make_worker_mesh``):
                      micro-batches shard their frontier rows Fig.-4 style
                      (``core.distributed``); its first shard must lie on
                      the service's device, where the closed rows are
                      assembled.
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
        self.device = resolve_device(device)
        if mesh is not None and \
                mesh.devices[0] != canonical_device(self.device):
            raise ValueError(f"the mesh's first shard lies on "
                             f"{mesh.devices[0]}, the service on "
                             f"{self.device}: the closed rows are assembled "
                             "on the first shard's device")
        self.mesh = mesh
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
        #: guards all shared serving state (cache, stats, templates, carrier
        #: relations, epoch); the admission front-end launches flushes,
        #: finalizes them and probes the cache from different threads
        self.lock = threading.RLock()
        # -- observability (obs/): tracer, metrics, probes, roofline ---------
        self.probe = bool(probe)
        self.last_probes: list = []  # recent FixpointProbe records (capped)
        if tracer is None or tracer is False:
            self.tracer = NULL_TRACER
        elif tracer is True:
            self.tracer = Tracer()
        else:
            self.tracer = tracer
        if metrics is False:
            self.metrics = NULL_METRICS
        elif metrics is None or metrics is True:
            self.metrics = MetricsRegistry()
        else:
            self.metrics = metrics
        self.kernels = KernelAttribution()
        self._h_device = self.metrics.histogram(
            "datalog_device_seconds",
            "launch to device-sync wall time per batched fixpoint")
        self._h_finalize = self.metrics.histogram(
            "datalog_finalize_seconds",
            "host-side split/format/cache-fill time per finalized batch")
        self._h_batch = self.metrics.histogram(
            "datalog_batch_size", "queries per launched batch",
            buckets=_BATCH_BUCKETS)
        self.metrics.register_collector(self._absorb_stats)
        # -- durability (durable.py): WAL + snapshots + recovery -------------
        self._durable = None
        if durable_dir is not None:
            from .durable import DurabilityManager
            self._durable = DurabilityManager(
                durable_dir, snapshot_every=snapshot_every,
                keep_snapshots=keep_snapshots, fsync=durable_fsync,
                tracer=self.tracer)
            self.metrics.register_collector(self._durable.absorb_metrics)
            with self.lock:
                self._durable.recover(self)

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
        queries hit.

        Two phases: :meth:`launch_batch` runs the fixpoints,
        :meth:`finalize_batch` splits, formats and fills the cache; the
        admission front-end runs them on different threads."""
        with self.lock:
            return self.finalize_batch(self.launch_batch(queries))

    def launch_batch(self, queries: list) -> _PendingBatch:
        """Phase 1 of :meth:`ask_batch`: classify the queries (cache hit,
        EDB selection, frontier group, tuple shape) and run every fixpoint;
        on the card each frontier group's table is then on its way to the
        host.  Returns the in-flight state for :meth:`finalize_batch`."""
        with self.lock, self.tracer.span("launch_batch", cat="service",
                                         batch=len(queries)):
            self._h_batch.observe(len(queries))
            qlits = [self._as_literal(s) for s in queries]
            pending = _PendingBatch(epoch=self.epoch, qlits=qlits,
                                    out=[None] * len(qlits))
            dense: dict[str, list[tuple[int, int, Literal]]] = {}
            singles: list[tuple[int, Literal]] = []
            for i, q in enumerate(qlits):
                ent = self.cache.get(self._cache_key(q))
                if ent is not None:
                    if ent.epoch != self.epoch:
                        raise RuntimeError("a stale cache entry survived an "
                                           "append")
                    pending.hits.append((i, ent))
                elif q.pred in self.db:  # EDB query: a pure selection
                    pending.out[i] = self._ask_edb(q)
                else:
                    src = self._dense_source(q)
                    if src is not None:
                        dense.setdefault(q.pred, []).append((i, src, q))
                    else:
                        singles.append((i, q))
            for pred, items in dense.items():
                pending.dense.append(self._launch_dense_batch(pred, items))
            # same-shape tuple queries share one qid-tagged fixpoint; mixed
            # shapes never coalesce (no shared seed schema)
            shapes = _batch.coalesce_by_shape(
                singles, lambda q: (q.pred, self._adorn(q)))
            for (pred, adn), items in shapes.items():
                pending.tuples.append(
                    self._launch_tuple_group(pred, adn, items))
            return pending

    def finalize_batch(self, pending: _PendingBatch) -> list:
        """Phase 2 of :meth:`ask_batch`: wait for each launched table's copy
        to the host, split and format per query (host work, outside the
        service lock), then fill the result cache and the answer slots
        under the lock.  The epoch assert is the fencing invariant: an
        append must never land between a batch's launch and its cache fill
        (``incremental.EpochFence`` enforces it for the async front-end)."""
        with self.tracer.span("finalize_batch", cat="service",
                              batch=len(pending.qlits)):
            t_fin = time.monotonic()
            dense_done = []
            for pred, ds, items, uniq, in_range, launch in pending.dense:
                with self.tracer.span("device_sync", cat="device", pred=pred):
                    table = launch.table if launch is not None else None
                if launch is not None:
                    self._attribute_launch(ds, launch)
                formatted = {s: (self._format(ds, s, table[j]), table[j])
                             for j, s in enumerate(in_range)}
                dense_done.append((pred, ds, items, uniq, formatted))
            tuple_done = []
            for pred, items, uniq, launched, results in pending.tuples:
                if results is None:  # batched: split the captured model now
                    tpl, run = launched
                    with self.tracer.span("tuple_split", cat="service",
                                          pred=pred):
                        answers = tpl.finalize_launched(self, run)
                    results = {key: _freeze(res)
                               for (key, _), res in zip(uniq, answers)}
                tuple_done.append((pred, items, results))
            with self.lock, self.tracer.span("cache_fill", cat="service"):
                assert pending.epoch == self.epoch, \
                    "append overtook an in-flight batch (epoch fence violated)"
                out = pending.out
                for i, ent in pending.hits:
                    out[i] = self._entry_result(ent)
                for pred, ds, items, uniq, formatted in dense_done:
                    final: dict[int, object] = {}
                    for s, (fmt, raw) in formatted.items():
                        self._cache_dense(pred, s, fmt, raw)
                        final[s] = fmt
                    for s in uniq:
                        if s not in final:  # beyond the domain: unreachable
                            final[s] = self._empty_dense(ds, s)
                    for i, src, _ in items:
                        out[i] = final[src]
                for pred, items, results in tuple_done:
                    for key, res in results.items():
                        self.cache.put(key, CacheEntry("tuple", pred, res,
                                                       self.epoch))
                    for i, q in items:
                        out[i] = results[self._cache_key(q)]
                self._h_finalize.observe(time.monotonic() - t_fin)
                return out

    def append(self, rel: str, rows) -> "DatalogService":
        """Monotone EDB append: add facts, keep serving.  Cached closures of
        the predicates over ``rel`` resume from their pre-append rows, and
        batched tuple templates from their fixpoint snapshots
        (``incremental.py``), so hot entries stay warm; everything else (and
        under ``resume_min_hits`` / ``resume_max_bytes`` the cold tail) is
        invalidated."""
        with self.lock, self.tracer.span("append", cat="service", rel=rel):
            if rel not in self.db:
                raise ValueError(
                    f"{rel!r} is not an EDB relation of this service "
                    f"(known: {sorted(self.db)}); appends are EDB-only")
            rows = _inc.validate_append(rows, self.db[rel].shape[1],
                                        self.bits)
            if self._durable is not None:
                # write-ahead: the record is durable BEFORE any state
                # changes, so a crash anywhere below replays it
                self._durable.log_append(rel, rows, self.epoch + 1)
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
                    e.epoch = self.epoch  # untouched base relation: valid
            for pred, ds in self._dense.items():
                if ds.low.edb == rel:
                    self._refresh_dense(pred, ds, rows)
            if self._durable is not None:
                self._durable.maybe_snapshot(self)
            return self

    def snapshot(self, wait: bool = False) -> int | None:
        """Hand a consistent snapshot of the serving state to the background
        writer (requires ``durable_dir=``); returns the generation's step.
        The copy to the host happens under :attr:`lock`; ``wait=True`` also
        blocks until the generation is published, as before a planned
        shutdown, so the next start recovers warm with no log suffix."""
        if self._durable is None:
            raise RuntimeError("snapshot() requires DatalogService("
                               "durable_dir=...)")
        with self.lock:
            step = self._durable.snapshot(self)
        if wait:
            self._durable.wait()
        return step

    def close(self) -> None:
        """Flush and release durable resources (a no-op without
        ``durable_dir=``); the service stays usable for in-memory serving."""
        if self._durable is not None:
            self._durable.close()

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
        ``e_alloc``/``padding`` for CSR), ``kernels`` (the roofline
        attribution per kernel, ``KernelAttribution.report``, plus a
        ``tuning`` entry per tuned predicate when ``tune=`` is on), in
        probe mode ``probes`` (recent ``FixpointProbe`` dicts) and, with
        ``durable_dir=``, ``durability`` (the log, the snapshots and the
        recovery report).  The async front-end adds ``admission``."""
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
            "kernels": self.kernels.report(),
        }
        tuning = {p: ds.tuning for p, ds in self._dense.items() if ds.tuning}
        if tuning:
            rep["kernels"]["tuning"] = tuning
        if self.probe:
            rep["probes"] = [p.as_dict() for p in self.last_probes]
        if self._durable is not None:
            rep["durability"] = self._durable.report()
        return rep

    def _record_probe(self, pr) -> None:
        self.last_probes.append(pr)
        del self.last_probes[:-64]  # bounded: recent batches only

    def _attribute_launch(self, ds: _DenseRelation,
                          launch: _DenseLaunch) -> None:
        """Roofline attribution at the device sync: the fixpoint's device
        wall time (host-loop gaps included) and the analytic flop/byte
        model of the padded batch that ran (``obs.roofline_attr``)."""
        secs = launch.seconds()
        self._h_device.observe(secs)
        iters = launch.iterations
        bp = _batch.pad_batch_size(max(launch.b, 1), self.batch_pads)
        if ds.is_csr:
            cost = csr_launch_cost(bp, ds.n_alloc, ds.csr.e_alloc,
                                   ds.csr.edge_val.element_size(), iters)
            kernel = f"csr_spmv:{ds.low.kind}"
        else:
            cost = dense_launch_cost(bp, ds.n_alloc,
                                     ds.matrix.element_size(), iters)
            kernel = f"frontier_matmul:{ds.low.kind}"
        self.kernels.record(kernel, seconds=secs, iterations=iters, **cost)

    def _absorb_stats(self, m) -> None:
        """Export-time absorption (``MetricsRegistry.register_collector``):
        the hot paths keep their cheap dataclass ``+=``s; every exporter
        sees them through the JAX service's ``datalog_*`` schema."""
        with self.lock:
            st = dataclasses.asdict(self.stats)
            cache_hits, cache_misses = self.cache.hits, self.cache.misses
            cache_evicts, cache_len = self.cache.evictions, len(self.cache)
            epoch = self.epoch
        fx = m.counter("datalog_fixpoints_total",
                       "batched frontier/tuple fixpoints launched, by repr")
        fx.set(st["dense_fixpoints"] - st["csr_fixpoints"], {"repr": "dense"})
        fx.set(st["csr_fixpoints"], {"repr": "csr"})
        fx.set(st["tuple_fixpoints"], {"repr": "tuple"})
        bq = m.counter("datalog_batched_queries_total",
                       "queries answered by batched fixpoints, by engine")
        bq.set(st["batched_queries"], {"engine": "frontier"})
        bq.set(st["tuple_batched_queries"], {"engine": "tuple"})
        for name, field, help_ in (
            ("datalog_plans_built_total", "plans_built",
             "query templates constructed (magic rewrite + plan)"),
            ("datalog_plan_hits_total", "plan_hits",
             "queries served by a memoized template"),
            ("datalog_tuple_runs_total", "tuple_runs",
             "PSN template evaluations"),
            ("datalog_appends_total", "appends", "monotone EDB appends"),
            ("datalog_resumed_rows_total", "resumed_rows",
             "cached dense closures refreshed by append-resume"),
            ("datalog_resumed_tuple_rows_total", "resumed_tuple_rows",
             "tuple answers refreshed by snapshot resume"),
            ("datalog_dropped_cold_total", "dropped_cold",
             "cold cache entries dropped instead of resumed"),
        ):
            m.counter(name, help_).set(st[field])
        m.counter("datalog_cache_hits_total",
                  "result-cache hits").set(cache_hits)
        m.counter("datalog_cache_misses_total",
                  "result-cache misses").set(cache_misses)
        m.counter("datalog_cache_evictions_total",
                  "result-cache evictions").set(cache_evicts)
        m.gauge("datalog_cache_entries",
                "resident result-cache entries").set(cache_len)
        m.gauge("datalog_epoch", "service append epoch").set(epoch)
        m.counter("datalog_fixpoint_traces_total",
                  "fixpoint jit compilations, process-wide").set(
            fixpoint_trace_count())

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

    def _launch_tuple_group(self, pred: str, adn: str, items):
        """One (pred, adornment) shape group: launch the qid-tagged batched
        fixpoint where the shape allows it, else run each distinct query
        through its template (their answers are host arrays already)."""
        uniq: list[tuple[object, Literal]] = []
        seen: set = set()  # a cache key pins its shape: per-group dedup
        for _, q in items:
            key = self._cache_key(q)
            if key not in seen:
                seen.add(key)
                uniq.append((key, q))
        launched = None
        results = None
        if len(uniq) > 1 and BOUND in adn:
            launched = self._launch_tuple_batch(pred, adn, uniq)
        if launched is None:  # singleton / unbatchable: sequential path
            results = {key: _freeze(self._ask_tuple(q)) for key, q in uniq}
        return (pred, items, uniq, launched, results)

    def _launch_tuple_batch(self, pred: str, adn: str, uniq: list):
        """B same-shape tuple queries as ONE qid-tagged fixpoint; returns
        (template, launched state) for the finalize split, or None to fall
        back to sequential runs (shape not batchable, or the union of
        demands overflowed a table)."""
        tpl, fresh = self._template(pred, adn, uniq[0][1])
        if not tpl.batchable:
            return None
        try:
            run = tpl.launch_batch(self, [q for _, q in uniq])
        except (PlanError, CapacityError, ValueError):
            return None
        self.stats.plan_hits += len(uniq) - (1 if fresh else 0)
        self.stats.tuple_runs += 1
        self.stats.tuple_fixpoints += 1
        self.stats.tuple_batched_queries += len(uniq)
        return (tpl, run)

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

    def _launch_dense_batch(self, pred: str, items):
        """Launch ONE batched fixpoint for the distinct in-domain sources of
        a frontier group (sources beyond the allocated domain reach
        nothing); formatting waits for :meth:`finalize_batch`."""
        ds = self._dense_state(pred)
        uniq = list(dict.fromkeys(src for _, src, _ in items))
        in_range = [s for s in uniq if s < ds.n_alloc]
        launch = None
        if in_range:
            with self.tracer.span("fixpoint", cat="device", pred=pred,
                                  repr="csr" if ds.is_csr else "dense",
                                  b=len(in_range)):
                launch = _DenseLaunch(ds, self, in_range)
            self.stats.dense_fixpoints += 1
            self.stats.csr_fixpoints += 1 if ds.is_csr else 0
            self.stats.batched_queries += len(in_range)
            self.stats.fixpoint_iterations += launch.iterations
        return (pred, ds, items, uniq, in_range, launch)

    def _cache_dense(self, pred: str, src: int, formatted, raw):
        # the canonical single-source pattern key: distinct free tail vars
        key = (pred, src) + tuple(
            f"~{i}" for i in range(1, edge_arity(self._lowering(pred).kind)))
        self.cache.put(key, CacheEntry("dense", pred, _freeze(formatted),
                                       self.epoch, src=src, raw=raw))

    def _empty_dense(self, ds: _DenseRelation, src: int):
        return self._format(ds, src, np.full((0,), ds.sr.zero, np.float32))
