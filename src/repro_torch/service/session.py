"""``DatalogService`` — load a program + EDB once, answer query streams fast.

Port of ``repro.service.session`` for the serving main path: batched
single-source queries on a decomposable recursive predicate over the bool
(``tc(s, X)``) and min-plus (``dpath(s, X, min<D>)``) carriers.  B queries on
one predicate coalesce into ONE (B, n) frontier fixpoint (``batch.py``) over
the relation's carrier, a dense matrix or a sliced-ELL CSR picked by the
density heuristic, and every answer lands in an LRU result cache.

    svc = DatalogService(TC, db={"arc": edges})          # on the card
    svc.ask("tc", (1, None))
    svc.ask_batch([("tc", (s, None)) for s in sources])  # one fixpoint

The service runs on ``cuda`` unless the caller passes ``device="cpu"``; on
the card every fixpoint iteration is a hand-written CUDA kernel
(``repro_torch.kernels``), on the CPU the kernels' plain versions run.

What the JAX service does beyond this path raises ``NotImplementedError``
naming its ROADMAP item: the ``max<>``/``sum<>`` carriers (A.1), appends
(A.2), ``tune`` (A.3), and the tuple engine with the modules built on it —
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
from ..core.query import PlanError, as_query_literal, normalize_db, query_row_mask
from ..core.semiring import BOOL, carrier_for, edge_arity
from ..device import resolve_device
from . import batch as _batch
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


def _freeze(res):
    """Mark a cached answer's arrays read-only: cache hits hand out the SAME
    arrays, so a caller mutating an answer must fail loudly."""
    for a in res if isinstance(res, tuple) else (res,):
        a.flags.writeable = False
    return res


class _DenseRelation:
    """Carrier state for one decomposable predicate: dense matrix OR CSR,
    packed once per service on the service's device.  ``svc.sparse`` forces
    a representation; ``None`` lets the density heuristic pick (below
    ``sparse_threshold`` the CSR segment engine replaces the
    ``n_align``-rounded O(n²) matrix behind the same batching interface)."""

    def __init__(self, svc: "DatalogService", low: FrontierLowering):
        self.low = low
        self.sr = carrier_for(low.kind)
        edges = svc.db.get(low.edb, np.zeros((0, edge_arity(low.kind)),
                                             np.int64))
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
            self.csr = _sparse.build_csr(edges, self.n_alloc, low.kind,
                                         device=svc.device)
        elif self.sr is BOOL:
            adj = np.zeros((self.n_alloc, self.n_alloc), bool)
            if len(edges):
                adj[edges[:, 0], edges[:, 1]] = True
            self.matrix = torch.from_numpy(adj).to(svc.device)
        else:
            # ⊕-zero (+inf) fill; the ⊕ scatter folds parallel arcs
            w = np.full((self.n_alloc, self.n_alloc), self.sr.zero, np.float32)
            if len(edges):
                np.minimum.at(w, (edges[:, 0], edges[:, 1]),
                              edges[:, 2].astype(np.float32))
            self.matrix = torch.from_numpy(w).to(svc.device)

    @property
    def is_csr(self) -> bool:
        return self.csr is not None

    def run_batch(self, svc: "DatalogService", srcs: list[int]):
        """One batched frontier fixpoint over this relation's carrier."""
        if self.is_csr:
            return _batch.run_frontier_batch_csr(self.csr, srcs,
                                                 svc.batch_pads)
        return _batch.run_frontier_batch(self.sr, self.matrix, srcs,
                                         svc.batch_pads)

    def report(self) -> dict:
        rep = {"n": self.n, "n_alloc": self.n_alloc, "semiring": self.sr.name,
               "repr": "csr" if self.is_csr else "dense"}
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
    ``n_align``       dense domain-size alignment.
    ``sparse``        True forces the CSR carrier, False the dense matrix,
                      None (default) picks per relation by density
                      (< ``sparse_threshold`` -> CSR).
    ``sparse_threshold``  the heuristic's |E|/n² cut (None = library
                      default, ``core.sparse.DEFAULT_SPARSE_THRESHOLD``).

    ``mesh``, ``probe``, ``tune``, ``tracer`` and ``durable_dir`` exist for
    signature parity with the JAX service and raise until ported.
    """

    def __init__(self, program, db: dict[str, np.ndarray], *, bits: int = 18,
                 constants: dict[str, int] | None = None,
                 result_cache: int = 1024, matmul=None, mesh=None,
                 batch_pads: tuple[int, ...] = (1, 8, 32, 128),
                 n_align: int = 128, sparse: bool | None = None,
                 sparse_threshold: float | None = None, tune=None,
                 tracer=None, probe: bool = False, durable_dir=None,
                 device=None):
        if matmul not in (None, "pallas"):
            raise ValueError(f"matmul must be None or 'pallas', got {matmul!r}")
        for name, value, item in (("mesh", mesh is not None, "A.6"),
                                  ("probe", probe, "A.6"),
                                  ("tracer", bool(tracer), "A.6"),
                                  ("durable_dir", durable_dir is not None,
                                   "A.6"),
                                  ("tune", bool(tune), "A.3")):
            if value:
                raise _not_ported(f"DatalogService({name}=...)", item)
        self.device = resolve_device(device)
        if isinstance(program, str):
            program = parse_program(program, constants=constants)
        self.program = program
        self.bits = bits
        self.batch_pads = tuple(batch_pads)
        self.n_align = n_align
        self.sparse = sparse
        self.sparse_threshold = (sparse_threshold
                                 if sparse_threshold is not None
                                 else _sparse.DEFAULT_SPARSE_THRESHOLD)
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
                out[i] = ent.result
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

    def append(self, rel: str, rows):
        raise _not_ported("DatalogService.append", "A.2")

    # -- introspection -------------------------------------------------------

    def explain(self) -> dict:
        """Introspection report, in the JAX service's schema: ``epoch``,
        ``service`` counters, ``cache`` counters, ``templates`` (always
        empty: no tuple engine yet) and per-predicate carrier reports under
        ``relations`` (``{n, n_alloc, semiring, repr}`` plus ``nnz``/
        ``density``/``e_alloc``/``padding`` for CSR)."""
        return {
            "epoch": self.epoch,
            "service": dataclasses.asdict(self.stats),
            "cache": {"entries": len(self.cache), "hits": self.cache.hits,
                      "misses": self.cache.misses,
                      "evictions": self.cache.evictions},
            "templates": [],
            "relations": {p: ds.report() for p, ds in self._dense.items()},
        }

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
        a carrier or the tuple engine that is not ported yet."""
        low = self._lowering(q.pred)
        src = frontier_query_source(q) if low is not None else None
        if src is None:
            raise _not_ported(f"query {q!r} (the tuple engine)", "A.6")
        if low.kind not in ("bool", "minplus"):
            raise _not_ported(f"the {low.kind} carrier of {q.pred!r}", "A.1")
        return src

    def _dense_state(self, pred: str) -> _DenseRelation:
        if pred not in self._dense:
            self._dense[pred] = _DenseRelation(self, self._lowering(pred))
        return self._dense[pred]

    def _format(self, ds: _DenseRelation, src: int, row: np.ndarray):
        if ds.low.kind == "bool":
            return _batch.format_bool_row(src, row, ds.n)
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
