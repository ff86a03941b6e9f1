"""The Datalog runtime on torch: stratum-ordered evaluation of planned
programs, ported from ``repro.core.engine``.

``Engine`` is the entry point; it runs on ``cuda`` unless the caller passes
``device="cpu"``:

    eng = Engine(program_text, db={"arc": edges}, caps={"tc": 1 << 20})
    eng.run()
    tc = eng.query("tc")          # numpy rows (full perfect model)
    dist = eng.query_agg("spath") # (rows, values)
    rows = eng.ask("tc", (1, None))          # magic-sets restricted
    answers = eng.ask_batch([("tc", (s, None)) for s in srcs])  # one fixpoint

Evaluation follows the iterated-fixpoint (perfect-model) schedule of §2:
SCCs of the PCG evaluate leaves first; a recursive SCC runs the PSN fixpoint
of Algorithm 1 (delta/all tables, subtract, distinct), with aggregates in
recursion merged eagerly under PreM; results materialize and become base
relations of higher strata.

JAX's ``lax.while_loop`` becomes a host loop here: each iteration syncs
once for the delta counts, and each join once for its total, which is
checked against ``join_cap`` before the join expands.  Tables hold exactly
their tuples (``relation.py``), and a join larger than
:data:`JOIN_CHUNK` bindings expands in chunks, each projected and
compacted before the next: the answers, ``iterations``, ``generated`` and
the capacity checks stay those of one expansion.  A :class:`CapacityError`
is raised for exactly the caps at which JAX raises it, at the first
overflow instead of after the loop.

Every value is int32 as in JAX (columns, arithmetic, aggregate values,
which wrap as int32 sums do); ``generated`` counts, over every rule and
iteration, the bindings still valid after negation and comparisons.
``fixpoint_trace_count()`` counts what JAX's does (``seminaive.
note_trace``): a group runner "traces" at the first run of its structural
key with given ``quantize_rows``-bucketed argument shapes.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Union

import numpy as np
import torch

from ..device import resolve_device
from .ir import Const, Literal, Program, Term, Var, fresh_var  # noqa: F401
from .magic import (MagicError, detect_frontier_lowering,
                    frontier_query_source)
from .parser import parse_program, parse_query  # noqa: F401
from .planner import (CompiledRule, EdbJoinStep, GroupPlan, PlanError,
                      PlanOptions, ProgramPlan, SourceDelta, SourceEdb,
                      batch_adornment, plan_program)
from .query import (QuerySpec, as_query_literal, normalize_db,
                    query_row_mask, repeated_var_groups)
from .relation import (_MERGE_INIT, EMPTY, AggTable,  # noqa: F401
                       FactTable, Schema, _agg_reduce,
                       match_ranges, merge_sorted,
                       sorted_member, sorted_unique)
from .semiring import BOOL, MIN_PLUS
from . import seminaive as _sn
from . import sparse as _sparse
from .seminaive import (Bindings, EdbIndex, build_edb_index, edb_antijoin,
                        edb_intro, edb_probe, expand_bindings, idb_intro,
                        idb_prefix_ranges, join_edb,  # noqa: F401
                        join_idb_prefix, pack_warm_rows, quantize_rows,
                        reachable_from_dense, single_source_distances_dense)

__all__ = ["CapacityError", "Engine", "GroupExecutor", "GroupStats",
           "QuerySpec", "as_query_literal", "clear_runner_cache",
           "fixpoint_trace_count", "query_row_mask", "repeated_var_groups",
           "split_qid_answers", "JOIN_CHUNK"]

#: bindings one join expands at a time; a larger expansion runs in chunks
#: of probe rows, each projected and compacted before the next
JOIN_CHUNK = 1 << 26

_AGG_KIND = {"min": "min", "max": "max", "count": "count", "mcount": "count",
             "sum": "sum", "msum": "sum"}


class CapacityError(RuntimeError):
    pass


class _Overflow(Exception):
    """A table or join of ``pred``'s rules outgrew its capacity."""

    def __init__(self, pred: str):
        super().__init__(pred)
        self.pred = pred


@dataclasses.dataclass
class GroupStats:
    iterations: int
    generated: int  # facts produced before dedup (paper Tables 7/8)


def split_qid_answers(pred: str, rows, vals, info, qlits, qids=None) -> list:
    """Per-seed attribution: split a qid-tagged model into per-query answers.

    ``rows``/``vals`` carry the query id in key column 0; for each goal the
    qid selects its slice, then the goal's own constants / repeated
    variables filter exactly like the single-query path (the demanded set
    may exceed the queried set).  ``qids`` overrides the per-goal qid tags
    (default: position order)."""
    out = []
    for k, q in enumerate(qlits):
        qid = k if qids is None else qids[k]
        shifted = Literal(pred, (Const(qid),) + q.args)
        mask = query_row_mask(shifted, rows, vals, info)
        r = rows[mask][:, 1:]  # drop the qid column
        out.append((r, vals[mask]) if info.is_agg else r)
    return out


def fixpoint_trace_count() -> int:
    """Number of times JAX would have (re-)traced a fixpoint process-wide:
    group runners, cached dense fixpoints and CSR fixpoints alike."""
    return _sn.trace_count()


def clear_runner_cache() -> None:
    """Forget the group runners' trace keys (JAX: drop the cached runners,
    so the next run of each structure traces again)."""
    _sn.clear_traces("group")


def _needed_vars(cr: CompiledRule) -> list[set]:
    """``needed[j]``: the variables that join steps ``j..`` and the
    projection read (so a binding column outside ``needed[j + 1]`` is
    dropped after join ``j``)."""
    proj = set()
    for a in cr.ariths:
        proj |= {t.name for t in (a.lhs, a.rhs, a.target)
                 if isinstance(t, Var)}
    for c in cr.comps:
        proj |= {t.name for t in (c.lhs, c.rhs) if isinstance(t, Var)}
    proj |= {k for k in cr.head_keys if isinstance(k, str)}
    if isinstance(cr.head_value, str):
        proj.add(cr.head_value)
    needed = [proj]
    for step in reversed(cr.joins):
        needed.append(needed[-1] | {v for v in step.probe_vars
                                    if isinstance(v, str)})
    return needed[::-1]


def _sync_count(t: torch.Tensor) -> int:
    with torch.profiler.record_function("tuple.sync"):
        return int(t)


class GroupExecutor:
    """One GroupPlan as a function of its data (EDB indexes, source rows and
    seed facts enter :meth:`run` as arguments), keyed for trace accounting
    by its plan *structure* (:meth:`structural_key`).

    :meth:`run`'s stages are labelled for ``torch.profiler``:
    ``tuple.join`` (ranges and expansion), ``tuple.project`` (arithmetic,
    comparisons, head keys), ``tuple.compact`` (sort and dedup or
    ⊕-reduce), ``tuple.merge`` (delta = new − all; all ∪= delta) and
    ``tuple.sync`` (the host waiting on a count)."""

    def __init__(self, gp: GroupPlan, caps: dict[str, int], bits: int,
                 jcap: int, max_iters: int, device=None):
        self.gp = gp
        self.caps = caps  # fully resolved per predicate (aliases applied)
        self.bits = bits
        self.jcap = jcap
        self.max_iters = max_iters
        self.device = resolve_device(device)

    def structural_key(self) -> tuple:
        gp = self.gp
        return (
            tuple(sorted((p, repr(i)) for p, i in gp.preds.items())),
            tuple(repr(cr) for cr in gp.exit_rules),
            tuple(repr(cr) for cr in gp.rec_rules),
            gp.recursive,
            tuple(sorted(self.caps.items())),
            self.bits, self.jcap, self.max_iters,
        )

    # -- plumbing -----------------------------------------------------------

    def _schema(self, info) -> Schema:
        return Schema(tuple([self.bits] * info.key_arity))

    def _empty_table(self, info):
        if info.is_agg:
            return AggTable.empty(self.caps[info.name], _AGG_KIND[info.agg],
                                  device=self.device)
        return FactTable.empty(self.caps[info.name], device=self.device)

    # -- group evaluation ---------------------------------------------------

    def run(self, facts, edb, hook: Callable | None = None):
        """facts: {pred: (packed_keys, values|None)}; edb: {'idx': {...},
        'src': {...}}.  Returns ({pred: {'all', 'delta'}}, iterations,
        generated); raises ``_Overflow`` at the first overflow.  ``hook(it)``,
        when given, returns a context manager entered around PSN iteration
        ``it`` (profiling)."""
        gp = self.gp
        state = {p: {"all": self._empty_table(info),
                     "delta": self._empty_table(info)}
                 for p, info in gp.preds.items()}
        # facts (rules with empty bodies; magic seed facts; warm rows)
        for pred in sorted(facts):
            keys, vals = facts[pred]
            state[pred]["all"], _ = self._merge_contribs(
                state[pred]["all"], [(keys, vals, False)], gp.preds[pred])
        # exit rules
        gen = torch.zeros((), dtype=torch.int64, device=self.device)
        contribs = {p: [] for p in gp.preds}
        for cr in gp.exit_rules:
            out, n = self._run_pipeline(cr, state, edb)
            contribs[cr.head_pred] += out
            gen = gen + n
        for pred, info in gp.preds.items():
            allt, _ = self._merge_contribs(state[pred]["all"],
                                           contribs[pred], info)
            state[pred]["all"] = allt
            state[pred]["delta"] = allt  # first delta = everything so far
        iters = 0
        if gp.recursive and gp.rec_rules:
            state, iters, gen = self._psn_loop(state, edb, gen, hook)
        return state, iters, _sync_count(gen)

    def _psn_loop(self, state, edb, gen, hook):
        """Algorithm 1: do { delta = T(delta) − all; all ∪= delta } while
        delta, at most ``max_iters`` times (silently, as in JAX)."""
        preds = sorted(self.gp.preds)
        it = 0
        while it < self.max_iters and any(state[p]["delta"].count
                                          for p in preds):
            with hook(it) if hook is not None else contextlib.nullcontext():
                contribs = {p: [] for p in preds}
                for cr in self.gp.rec_rules:
                    out, n = self._run_pipeline(cr, state, edb)
                    contribs[cr.head_pred] += out
                    gen = gen + n
                new_st = {}
                for p in preds:
                    allt, delta = self._merge_contribs(
                        state[p]["all"], contribs[p], self.gp.preds[p])
                    new_st[p] = {"all": allt, "delta": delta}
                state = new_st
            it += 1
        return state, it, gen

    def _merge_contribs(self, allt, contribs, info):
        """Merge every rule contribution of a predicate into its table at
        once (additive aggregates need the final post-iteration value per
        key in the delta, not a stack of snapshots).  ``contribs`` holds
        (keys, values|None, compact) triples; a compact one is sorted and
        distinct (⊕-reduced) already."""
        if not contribs:
            return allt, self._empty_table(info)
        with torch.profiler.record_function("tuple.compact"):
            # compact contributions hold no EMPTY key; facts (and warm
            # rows, EMPTY-padded) are not compact
            raw = not all(c for _, _, c in contribs)
            if len(contribs) == 1 and not raw:
                keys, vals, _ = contribs[0]
            elif info.is_agg:
                keys, vals = _agg_reduce(
                    torch.cat([k for k, _, _ in contribs]),
                    torch.cat([v for _, v, _ in contribs]).to(
                        allt.values.dtype), allt.kind, drop_empty=raw)
            else:
                keys = torch.cat([k for k, _, _ in contribs])
                keys, vals = (sorted_unique(keys) if raw else
                              torch.unique(keys, sorted=True)), None
        with torch.profiler.record_function("tuple.merge"):
            if info.is_agg:
                merged, delta = allt.merge_reduced(keys, vals)
            else:
                dkeys = keys[~sorted_member(keys, allt.keys)]
                mkeys, _ = merge_sorted(allt.keys, dkeys)
                merged = FactTable(mkeys, allt.capacity,
                                   mkeys.numel() > allt.capacity
                                   or allt.overflow)
                delta = FactTable(dkeys, allt.capacity)
        if merged.overflow:
            raise _Overflow(info.name)
        return merged, delta

    # -- pipeline execution -------------------------------------------------

    def _run_pipeline(self, cr: CompiledRule, state, edb):
        """Execute one compiled rule; return its compacted head chunks as
        (keys, values|None, True) triples and the bindings produced (a
        device count)."""
        gp = self.gp
        if isinstance(cr.source, SourceDelta):
            info = gp.preds[cr.source.pred]
            t = state[cr.source.pred]["delta"]
            unpacked = self._schema(info).unpack(t.keys)
            cols = {v: c for v, c in zip(cr.source.key_vars, unpacked) if v}
            if cr.source.value_var:
                cols[cr.source.value_var] = \
                    t.incs if cr.use_increment else t.values
            n = t.count
        else:
            rows = edb["src"][(cr.source.rel, cr.source.select)]
            cols = {v: rows[:, i].to(torch.int32) for v, i in cr.source.intro}
            n = rows.shape[0]
        needed = _needed_vars(cr)
        b = Bindings({v: c for v, c in cols.items() if v in needed[0]},
                     torch.ones(n, dtype=torch.bool, device=self.device))
        out: list = []
        produced = [torch.zeros((), dtype=torch.int64, device=self.device)]
        totals = [0] * len(cr.joins)
        self._walk(cr, b, 0, totals, needed, {}, state, edb, out, produced)
        return out, produced[0]

    def _walk(self, cr, b, j, totals, needed, shuffled, state, edb, out,
              produced):
        """Run joins ``j..`` over the live bindings ``b``: a join whose
        expansion exceeds :data:`JOIN_CHUNK` runs over slices of its probe
        rows.  ``totals[j]`` sums join j's matches over every slice: JAX
        compares that whole total with ``join_cap``.  A joined binding keeps only
        the columns a later step reads (``needed[j + 1]``)."""
        while j < len(cr.joins) and isinstance(cr.joins[j], EdbJoinStep) \
                and cr.joins[j].negated:
            step = cr.joins[j]
            with torch.profiler.record_function("tuple.join"):
                b = edb_antijoin(b, edb["idx"][(step.rel, step.build_cols)],
                                 step.probe_vars, self.bits)
                keep = b.valid
                b = Bindings({v: c[keep] for v, c in b.cols.items()
                              if v in needed[j + 1]}, keep[keep])
            j += 1
        if j == len(cr.joins):
            self._project(cr, b, out, produced)
            return
        with torch.profiler.record_function("tuple.join"):
            lo, matches, fetch = self._ranges(cr.joins[j], b, state, edb,
                                              shuffled, j)
            cum = torch.cumsum(matches, 0)
        total = _sync_count(cum[-1]) if cum.numel() else 0
        totals[j] += total
        if totals[j] > self.jcap:
            raise _Overflow(cr.head_pred)
        keep = needed[j + 1]
        start, base = 0, 0
        while base < total:
            # the probe rows [start, end) whose matches fit one chunk (a
            # single row with more matches forms a chunk of its own)
            end = len(cum)
            if total - base > JOIN_CHUNK:
                end = max(_sync_count(torch.searchsorted(
                    cum, base + JOIN_CHUNK, right=True)), start + 1)
            top = _sync_count(cum[end - 1]) if end < len(cum) else total
            with torch.profiler.record_function("tuple.join"):
                part = Bindings({v: c[start:end] for v, c in b.cols.items()},
                                b.valid[start:end])
                nb = expand_bindings(part, lo[start:end], matches[start:end],
                                     top - base, fetch, keep)
                del part
            self._walk(cr, nb, j + 1, totals, needed, shuffled, state, edb,
                       out, produced)
            del nb
            start, base = end, top

    def _ranges(self, step, b: Bindings, state, edb, shuffled, j):
        """Per live binding, the first match and the match count of join
        step ``step``, and the function that gathers the columns it
        introduces at matched build positions."""
        if isinstance(step, EdbJoinStep):
            idx: EdbIndex = edb["idx"][(step.rel, step.build_cols)]
            lo, matches = match_ranges(
                idx.keys, edb_probe(b, step.probe_vars, self.bits))
            return lo, matches, lambda bi: edb_intro(idx, bi, step.intro)
        info = self.gp.preds[step.pred]
        t = state[step.pred]["all"]
        schema = self._schema(info)
        values = getattr(t, "values", None)
        intro = dict(step.intro)
        if not step.is_prefix:
            # the shuffle: re-pack the table with the probe columns leading
            # and re-sort (the in-engine repartition the RWA model charges)
            if j not in shuffled:
                perm = list(step.probe_cols) + [
                    c for c in range(info.key_arity)
                    if c not in step.probe_cols]
                unpacked = schema.unpack(t.keys)
                pschema = Schema(tuple(schema.bits[c] for c in perm))
                keys, order = torch.sort(pschema.pack(
                    [unpacked[c] for c in perm]))
                shuffled[j] = (keys, values[order] if values is not None
                               else None, pschema, perm)
            keys, values, schema, perm = shuffled[j]
            intro = {v: ("value" if c == "value" else perm.index(c))
                     for v, c in intro.items()}
        else:
            keys = t.keys
        lo, matches = idb_prefix_ranges(b, keys, step.probe_vars, schema,
                                        len(step.probe_cols))
        return lo, matches, \
            lambda ti: idb_intro(keys, values, ti, schema, intro)

    def _project(self, cr: CompiledRule, b: Bindings, out, produced):
        """Interpreted goals, then the head projection of the live bindings,
        compacted (sorted and deduplicated, or ⊕-reduced)."""
        with torch.profiler.record_function("tuple.project"):
            cols = dict(b.cols)
            shape, dev = b.valid.shape, b.valid.device

            def term_col(t):
                if isinstance(t, Var):
                    return cols[t.name]
                return torch.full(shape, t.value, dtype=torch.int32,
                                  device=dev)

            valid = b.valid
            for a in cr.ariths:
                l, r = term_col(a.lhs), term_col(a.rhs)
                res = (l + r if a.op == "+" else
                       l * r if a.op == "*" else l - r)
                if a.target.name in cols:  # bound: an equality constraint
                    valid = valid & (cols[a.target.name] == res)
                else:
                    cols[a.target.name] = res
            for c in cr.comps:
                # '=' with one side unbound binds it (L = L1 aliases)
                if c.op == "=":
                    if isinstance(c.lhs, Var) and c.lhs.name not in cols:
                        cols[c.lhs.name] = term_col(c.rhs)
                        continue
                    if isinstance(c.rhs, Var) and c.rhs.name not in cols:
                        cols[c.rhs.name] = term_col(c.lhs)
                        continue
                l, r = term_col(c.lhs), term_col(c.rhs)
                op = {"<": torch.lt, "<=": torch.le, ">": torch.gt,
                      ">=": torch.ge, "=": torch.eq, "!=": torch.ne}[c.op]
                valid = valid & op(l, r)
            info = self.gp.preds[cr.head_pred]
            schema = self._schema(info)
            key_cols = [cols[hk] if isinstance(hk, str)
                        else torch.full(shape, hk, dtype=torch.int32,
                                        device=dev) for hk in cr.head_keys]
            keys = schema.pack(key_cols) if key_cols else \
                torch.zeros(shape, dtype=torch.int64, device=dev)
            vals = None
            if info.is_agg:
                vals = cols[cr.head_value].to(torch.int32) \
                    if isinstance(cr.head_value, str) else \
                    torch.full(shape, cr.head_value, dtype=torch.int32,
                               device=dev)
            if valid is not b.valid:  # a comparison or equality filtered
                keys = keys[valid]
                vals = vals[valid] if vals is not None else None
            produced[0] = produced[0] + keys.numel()
        with torch.profiler.record_function("tuple.compact"):
            # packed live bindings: no EMPTY key to drop
            if info.is_agg:
                keys, vals = _agg_reduce(keys, vals, _AGG_KIND[info.agg],
                                         drop_empty=False)
            else:
                keys = torch.unique(keys, sorted=True)
        out.append((keys, vals, True))


class Engine:
    """Evaluate a Datalog program over an EDB on ``device`` (``None``: the
    card).  JAX's keywords, plus ``device``."""

    def __init__(
        self,
        program: Union[str, Program],
        db: dict[str, np.ndarray],
        bits: int = 18,
        caps: dict[str, int] | None = None,
        default_cap: int = 1 << 16,
        join_cap: int | None = None,
        max_iters: int = 1 << 16,
        constants: dict[str, int] | None = None,
        query: QuerySpec | None = None,
        batch: list | tuple | None = None,
        magic: bool = True,
        sparse: bool | None = None,
        sparse_threshold: float | None = None,
        bucket_floors: dict[str, int] | None = None,
        tune=None,
        device=None,
    ):
        self.device = resolve_device(device)
        if isinstance(program, str):
            program = parse_program(program, constants=constants)
        self.source_program = program
        if query is None and batch is None and program.queries:
            if len(program.queries) > 1:
                # multi-goal program: same-shape goals evaluate as ONE
                # qid-batched fixpoint (run() + batch_results())
                shapes = {(q.pred, batch_adornment(program, q))
                          for q in program.queries}
                if len(shapes) > 1 or not magic:
                    raise ValueError(
                        f"program has {len(program.queries)} '?-' goals of "
                        f"{len(shapes)} shapes (magic={magic}); one engine "
                        "plans one magic-batched shape — use ask_batch() "
                        "for mixed goals or demand-only evaluation")
                batch = tuple(program.queries)
            else:
                query = program.queries[0]
        if query is not None and batch is not None:
            raise ValueError("pass query= or batch=, not both")
        qlit = as_query_literal(query, constants) if query is not None else None
        blits = (tuple(as_query_literal(b, constants) for b in batch)
                 if batch is not None else None)
        self.magic = magic
        self.plan: ProgramPlan = plan_program(
            program, PlanOptions(
                query=qlit, batch=blits, magic=magic, sparse=sparse,
                sparse_threshold=sparse_threshold,
                bucket_floors=tuple(sorted((bucket_floors or {}).items())),
                tune=tune))
        # groups/facts reference the post-pass (possibly magic-rewritten) rules
        self.program = self.plan.rewritten
        self.bits = bits
        self.caps = dict(caps or {})
        self.default_cap = default_cap
        self.join_cap = join_cap
        self.max_iters = max_iters
        # EDB relations are SETS of facts (an exact duplicate row would
        # double-count its binding in additive aggregates); values must fit
        # the packed domain
        self.db: dict[str, np.ndarray] = normalize_db(db, bits)
        self.materialized: dict[str, tuple[np.ndarray, np.ndarray | None]] = {}
        self.stats: dict[str, GroupStats] = {}
        self._index_cache: dict[tuple[str, tuple[int, ...]], EdbIndex] = {}
        self._pred_info = {p: info for gp in self.plan.groups
                           for p, info in gp.preds.items()}
        self._warm: dict[str, tuple[np.ndarray, np.ndarray | None]] = {}
        self._batch_out: list | None = None
        #: ``hook(it)`` -> a context manager entered around every PSN
        #: iteration ``it`` of every group (profiling); None: no hook
        self.iteration_hook: Callable | None = None

    # -- public API ----------------------------------------------------------

    def run(self, warm: dict[str, tuple] | None = None) -> "Engine":
        """Evaluate all strata.  ``warm`` maps predicate -> previously
        materialized (rows, values): monotone tables re-enter the fixpoint
        from that lower bound (``seminaive.pack_warm_rows``).  Only sound
        for programs monotone under appends (no negation, no additive
        aggregates); anything else raises."""
        if warm and not self.program.monotone_under_appends():
            raise PlanError(
                "run(warm=) on a program with negation or count/sum "
                "aggregates is unsound (warm rows would re-merge into "
                "additive totals / keep non-monotone facts); re-run cold")
        self._warm = dict(warm or {})
        try:
            for gp in self.plan.groups:
                self._eval_group(gp)
        finally:
            self._warm = {}
        if self.plan.options.batch is not None:
            self._finalize_batch()
        elif self.plan.query_pred is not None:
            self._finalize_query()
        return self

    def query(self, pred: str) -> np.ndarray:
        rows, _ = self._result(pred)
        return rows

    def query_agg(self, pred: str) -> tuple[np.ndarray, np.ndarray]:
        rows, vals = self._result(pred)
        assert vals is not None, f"{pred} is not an aggregate predicate"
        return rows, vals

    def ask(self, pred: QuerySpec, args: tuple | None = None, verify: bool = False,
            caps: dict[str, int] | None = None, default_cap: int | None = None,
            join_cap: int | None = None):
        """Demand-driven query: magic-rewrite, evaluate only demanded strata.

        ``ask("tc", (1, None))`` returns exactly the rows of the full-model
        ``query("tc")`` with first column 1, computed bottom-up on the
        magic-restricted program.  Aggregate predicates return ``(rows,
        values)``.  ``verify=True`` cross-checks the result against the
        full-model path.  ``caps``/``default_cap``/``join_cap`` override
        this engine's capacities for the restricted run."""
        q = as_query_literal(pred if args is None else (pred, args))
        if q.pred in self.db:  # EDB query: a pure selection
            rows = self.db[q.pred]
            return rows[query_row_mask(q, rows, None)]
        sub = self._query_engine(q, caps=caps, default_cap=default_cap,
                                 join_cap=join_cap).run()
        for k, v in sub.stats.items():
            # adorned/magic stats merge in (latest ask wins); never clobber
            # stats of predicates this engine materialized itself
            if k not in self.materialized:
                self.stats[k] = v
        info = sub._pred_info[sub.plan.query_pred]
        out = sub.query_agg(q.pred) if info.is_agg else sub.query(q.pred)
        if verify:
            self._verify_ask(q, out, info.is_agg)
        return out

    def ask_dense(self, pred: str, args: tuple, matmul=None,
                  sparse: bool | None = None, spmv=None,
                  probe: bool = False):
        """Single-source fast path: lower a magic-restricted *decomposable*
        program onto a frontier semiring fixpoint seeded with the query
        frontier row, on the dense ``form="vector"`` fixpoint (K1/K2 on the
        card) or the CSR one (K3/K4; K7 under ``tune=``).  ``sparse`` forces
        a carrier (default: ``PlanOptions.sparse``, then the density
        heuristic); ``matmul``/``spmv`` override the ⊗ / the segment step.
        Requires the canonical TC / shortest-path shape with the pivot
        bound; raises ``PlanError`` otherwise.  ``probe=True`` runs the
        probed fixpoint twin (``repro_torch.obs.fixpoint_probe``) instead,
        with a bit-identical answer, and returns ``(answer,
        FixpointProbe)``."""
        low = detect_frontier_lowering(self.source_program, pred)
        q = as_query_literal((pred, args))
        src = frontier_query_source(q)
        if low is None or src is None:
            raise PlanError(
                f"query {q!r} does not admit the dense frontier lowering "
                "(need a decomposable TC/spath shape with the pivot bound)")
        edges = self.db[low.edb]
        if len(edges) == 0:  # no arcs -> nothing reachable
            rows = np.zeros((0, 2), np.int64)
            out = rows if low.kind == "bool" else (rows,
                                                   np.zeros((0,), np.int64))
            return (out, None) if probe else out
        n = max(int(edges[:, :2].max()) + 1, src + 1)
        opts = self.plan.options
        use_csr = opts.sparse if sparse is None else sparse
        if use_csr is None:
            use_csr = _sparse.prefer_csr(
                len(edges), n,
                opts.sparse_threshold if opts.sparse_threshold is not None
                else _sparse.DEFAULT_SPARSE_THRESHOLD)
        dev = self.device
        pr = None
        if probe:  # local import keeps core import-independent of obs
            from ..obs import fixpoint_probe as _probe
        if use_csr:
            if opts.tune:
                from ..kernels import autotune as _at
                cfg = (opts.tune if isinstance(opts.tune, _at.KernelConfig)
                       else _at.autotune(edges, n, low.kind,
                                         device=dev).config)
                csr = _at.build_tuned(edges, n, low.kind, cfg, device=dev)
                if csr.plan_cfg is not None and spmv is None:
                    from ..kernels import ops as _kops
                    spmv = _kops.csr_frontier_step(low.kind)
            else:
                csr = _sparse.build_csr(edges, n, low.kind, device=dev)
            init = _sparse.rows_from_sources(csr, [src])
            if probe:
                res, pr = _probe.fixpoint_csr_probed(csr, init, spmv=spmv)
            else:
                res = _sparse.fixpoint_csr_cached(csr, init, spmv=spmv)
            row = res.table[0].cpu().numpy()
        elif low.kind == "bool":
            adj = np.zeros((n, n), bool)
            adj[edges[:, 0], edges[:, 1]] = True
            adj = torch.from_numpy(adj).to(dev)
            if probe:
                res, pr = _probe.fixpoint_dense_probed(BOOL, adj, adj[src],
                                                       matmul=matmul)
            else:
                res = reachable_from_dense(adj, src, matmul=matmul)
            row = res.table.cpu().numpy()
        else:  # every weighted lowering runs min-plus here, as in JAX
            w = np.full((n, n), np.inf, np.float32)
            np.minimum.at(w, (edges[:, 0], edges[:, 1]),
                          edges[:, 2].astype(np.float32))
            w = torch.from_numpy(w).to(dev)
            if probe:
                res, pr = _probe.fixpoint_dense_probed(MIN_PLUS, w, w[src],
                                                       matmul=matmul)
            else:
                res = single_source_distances_dense(w, src, matmul=matmul)
            row = res.table.cpu().numpy()
        if low.kind == "bool":
            dst = np.nonzero(row[:n])[0]
            out = np.stack([np.full(len(dst), src, np.int64),
                            dst.astype(np.int64)], axis=1)
        else:
            dst = np.nonzero(np.isfinite(row[:n]))[0]
            rows = np.stack([np.full(len(dst), src, np.int64),
                             dst.astype(np.int64)], axis=1)
            out = (rows, row[dst].astype(np.int64))
        self.stats[f"{pred}__{'csr' if use_csr else 'dense'}"] = GroupStats(
            iterations=int(res.iterations), generated=int(res.generated))
        return (out, pr) if probe else out

    def ask_batch(self, queries: list | None = None, verify: bool = False,
                  caps: dict[str, int] | None = None,
                  default_cap: int | None = None,
                  join_cap: int | None = None) -> list:
        """Answer B queries, coalescing same-(pred, adornment)-shape groups
        into ONE tuple-path fixpoint via the qid-tagged magic rewrite.

        ``queries`` defaults to the program's own ``?-`` goals.  Answers come
        back in query order; each equals the corresponding ``ask()``.  Shapes
        that do not admit per-seed attribution (all-free adornments, packed-
        width overflow, non-magic plans) or overflow a table under the
        union of demands fall back to sequential ``ask()``."""
        specs = list(queries) if queries is not None else \
            list(self.source_program.queries)
        qlits = [as_query_literal(s) for s in specs]
        out: list = [None] * len(qlits)
        kw = dict(caps=caps, default_cap=default_cap, join_cap=join_cap)
        groups: dict[tuple[str, str], list[int]] = {}
        for i, q in enumerate(qlits):
            if q.pred in self.db:  # EDB query: a pure selection
                rows = self.db[q.pred]
                out[i] = rows[query_row_mask(q, rows, None)]
                continue
            adn = batch_adornment(self.source_program, q)
            groups.setdefault((q.pred, adn), []).append(i)
        verify_full = None  # ONE full-model engine checks the whole batch
        for (pred, adn), idxs in groups.items():
            res = None
            if len(idxs) > 1 and "b" in adn and self.magic:
                res = self._try_batch([qlits[i] for i in idxs], **kw)
            if res is None:
                res = [self.ask(qlits[i], verify=verify, **kw) for i in idxs]
            elif verify:
                info_agg = self._batch_is_agg(pred)
                if verify_full is None:
                    verify_full = self._full_engine().run()
                for i, r in zip(idxs, res):
                    self._verify_ask(qlits[i], r, info_agg, full=verify_full)
            for i, r in zip(idxs, res):
                out[i] = r
        return out

    def _batch_is_agg(self, pred: str) -> bool:
        return any(r.agg is not None
                   for r in self.source_program.rules_for(pred))

    def _full_engine(self) -> "Engine":
        return Engine(self.source_program, db=self.db, bits=self.bits,
                      caps=self.caps, default_cap=self.default_cap,
                      join_cap=self.join_cap, max_iters=self.max_iters,
                      device=self.device)

    def _try_batch(self, batch: list[Literal], caps=None, default_cap=None,
                   join_cap=None) -> list | None:
        """One qid-tagged fixpoint for a same-shape batch, or None when the
        shape must evaluate sequentially (not batchable / won't pack / table
        overflow under the union of demands)."""
        try:
            sub = Engine(self.source_program, db=self.db, bits=self.bits,
                         caps=self.caps if caps is None else caps,
                         default_cap=default_cap or self.default_cap,
                         join_cap=join_cap or self.join_cap,
                         max_iters=self.max_iters, batch=batch,
                         device=self.device, **self._opt_kwargs())
            sub.run()
        except (PlanError, MagicError, ValueError, CapacityError):
            # ValueError covers packed-width overflow (the qid column pushes
            # the schema past 62 bits) and out-of-domain seed constants
            return None
        for k, v in sub.stats.items():
            if k not in self.materialized:
                self.stats[k] = v
        return sub.batch_results()

    def batch_results(self) -> list:
        """Per-query answers of a batch-planned engine, in batch order."""
        if self._batch_out is None:
            raise RuntimeError("engine has no batch plan or run() not called")
        return self._batch_out

    def _finalize_batch(self):
        """Split the qid-tagged query predicate into per-query answers."""
        qp = self.plan.query_pred
        info = self._pred_info[qp]
        rows, vals = self.materialized.get(
            qp, (np.zeros((0, info.key_arity), np.int64), None))
        self._batch_out = split_qid_answers(
            qp, rows, vals, info, self.plan.options.batch)

    def _opt_kwargs(self) -> dict:
        """Representation/bucketing options to thread into sub-engines."""
        opts = self.plan.options
        return dict(sparse=opts.sparse, sparse_threshold=opts.sparse_threshold,
                    bucket_floors=dict(opts.bucket_floors), tune=opts.tune)

    def _query_engine(self, q: Literal, caps=None, default_cap=None,
                      join_cap=None) -> "Engine":
        kwargs = dict(db=self.db, bits=self.bits,
                      caps=self.caps if caps is None else caps,
                      default_cap=default_cap or self.default_cap,
                      join_cap=join_cap or self.join_cap,
                      max_iters=self.max_iters, device=self.device,
                      **self._opt_kwargs())
        try:
            return Engine(self.source_program, query=q, magic=self.magic,
                          **kwargs)
        except PlanError:
            # magic bodies the join planner cannot order (e.g. cartesian
            # magic prefixes) fall back to demanded-strata + residual filter
            return Engine(self.source_program, query=q, magic=False, **kwargs)

    def _verify_ask(self, q: Literal, got, is_agg: bool,
                    full: "Engine | None" = None):
        if full is None:
            full = self if q.pred in self.materialized \
                else self._full_engine().run()
        info = full._pred_info[q.pred]
        if is_agg:
            rows, vals = full.query_agg(q.pred)
            mask = query_row_mask(q, rows, vals, info)
            want = {(*map(int, r), int(v)) for r, v in zip(rows[mask], vals[mask])}
            have = {(*map(int, r), int(v)) for r, v in zip(got[0], got[1])}
        else:
            rows = full.query(q.pred)
            mask = query_row_mask(q, rows, None, info)
            want = {tuple(map(int, r)) for r in rows[mask]}
            have = {tuple(map(int, r)) for r in got}
        if want != have:
            raise AssertionError(
                f"ask({q!r}) disagrees with the full-model path: "
                f"missing={sorted(want - have)[:5]} extra={sorted(have - want)[:5]}")

    def _finalize_query(self):
        """Restrict the query predicate's result by the query constants and
        alias it (materialization + stats) under the original name.  Every
        constant of the goal filters here, bound positions included: the
        demanded set can exceed the queried set."""
        qp = self.plan.query_pred
        orig = self.plan.aliases.get(qp, qp)
        if qp not in self.materialized:
            return
        rows, vals = self.materialized[qp]
        info = self._pred_info[qp]
        q = self.plan.options.query
        if q is not None:
            mask = query_row_mask(q, rows, vals, info)
        else:
            mask = np.ones(len(rows), bool)
            for pos, c in self.plan.residual_filters:
                if info.is_agg and pos == info.agg_pos:
                    mask &= np.asarray(vals) == c
                else:
                    mask &= np.asarray(rows[:, info.key_rank(pos)]) == c
        if not mask.all():
            rows = rows[mask]
            vals = vals[mask] if vals is not None else None
        self.materialized[qp] = (rows, vals)
        self.materialized[orig] = self.materialized[qp]
        self.stats[orig] = self.stats[qp]

    def _result(self, pred: str):
        if pred not in self.materialized:
            raise KeyError(f"{pred} not evaluated; call run() (known: {list(self.materialized)})")
        return self.materialized[pred]

    def invalidate(self, rel: str | None = None) -> "Engine":
        """Reset evaluated state so ``run()`` re-evaluates from current
        data: drops materialized results/stats and cached indexes over them;
        with ``rel``, also the indexes of that relation (its rows changed).
        Base-EDB indexes otherwise persist across runs."""
        self.materialized.clear()
        self.stats.clear()
        self._index_cache = {
            k: v for k, v in self._index_cache.items()
            if k[0] in self.db and (rel is None or k[0] != rel)}
        return self

    # -- plumbing --------------------------------------------------------------

    def _rows_of(self, rel: str) -> np.ndarray:
        if rel in self.db:
            return self.db[rel]
        if rel in self.materialized:
            rows, vals = self.materialized[rel]
            if vals is not None:
                # re-insert the aggregate value at its literal position
                pos = self._pred_info[rel].agg_pos
                return np.concatenate(
                    [rows[:, :pos], vals[:, None].astype(np.int64), rows[:, pos:]],
                    axis=1)
            return rows
        raise PlanError(f"unknown relation {rel!r} (neither EDB nor evaluated IDB)")

    def _bucket_floor(self, rel: str) -> int:
        """Per-relation quantize_rows floor (``PlanOptions.bucket_floors``)."""
        for name, floor in self.plan.options.bucket_floors:
            if name == rel:
                return floor
        return 8

    def _index(self, rel: str, cols: tuple[int, ...]) -> EdbIndex:
        key = (rel, cols)
        if key not in self._index_cache:
            self._index_cache[key] = build_edb_index(
                self._rows_of(rel), cols, self.bits,
                minimum=self._bucket_floor(rel), device=self.device)
        return self._index_cache[key]

    def _schema(self, info) -> Schema:
        return Schema(tuple([self.bits] * info.key_arity))

    def _cap(self, pred: str) -> int:
        if pred in self.caps:
            return self.caps[pred]
        # adorned (tc__bf) and magic (m__tc__bf) predicates inherit the
        # original predicate's capacity so caps= keeps working under ask()
        orig = self.plan.aliases.get(pred)
        if orig is not None and orig in self.caps:
            return self.caps[orig]
        return self.default_cap

    # -- group evaluation -----------------------------------------------------

    def _gather_edb(self, gp: GroupPlan):
        """Every EDB input the group's pipelines read: join indexes and
        (pre-selected) source rows, on the engine's device, with the
        bucketed shapes JAX's runner would see (the trace signature)."""
        idx: dict[tuple, EdbIndex] = {}
        src: dict[tuple, torch.Tensor] = {}
        src_sig = {}
        for cr in gp.exit_rules + gp.rec_rules:
            if isinstance(cr.source, SourceEdb):
                key = (cr.source.rel, cr.source.select)
                if key not in src:
                    src[key], src_sig[key] = self._source_rows(cr.source)
            for step in cr.joins:
                if isinstance(step, EdbJoinStep):
                    idx[(step.rel, step.build_cols)] = \
                        self._index(step.rel, step.build_cols)
        sig = (tuple(sorted(((k, i.bucket, len(i.cols))
                             for k, i in idx.items()), key=repr)),
               tuple(sorted(src_sig.items(), key=repr)))
        return {"idx": idx, "src": src}, sig

    def _source_rows(self, source: SourceEdb):
        rows = self._rows_of(source.rel)
        sel = rows
        for col, const in source.select:  # pushed-down selections
            sel = sel[np.asarray(sel[:, col]) == const]
        n = len(sel)
        cap = quantize_rows(max(n, 1),
                            minimum=max(self._bucket_floor(source.rel), 8))
        # JAX pads the scan to the bucket (int64 padding) or passes the
        # rows as they are
        dtype = "int64" if cap > n else str(sel.dtype)
        t = torch.from_numpy(np.ascontiguousarray(sel, np.int64)).to(
            self.device)
        return t, (cap, rows.shape[1], dtype)

    def _gather_facts(self, gp: GroupPlan):
        """Pack the group's fact rows (magic seed facts included) per
        predicate, and any warm-start rows (``run(warm=)``) as extra facts:
        the fixpoint re-enters from that lower bound.  Also returns the
        facts' part of the trace signature (JAX's argument lengths)."""
        limit = (1 << self.bits) - 1
        out, sig = {}, []
        for pred, info in gp.preds.items():
            keys = vals = None
            facts = [r for r in self.program.rules_for(pred) if r.is_fact()]
            if facts:
                rows = np.array([[a.value for a in r.head.args] for r in facts], np.int64)
                key_cols = [i for i in range(rows.shape[1])
                            if not (info.is_agg and i == info.agg_pos)]
                kv = rows[:, key_cols]
                if kv.size and (kv.min() < 0 or kv.max() > limit):
                    raise ValueError(
                        f"fact/query constant for {pred!r} exceeds the "
                        f"{self.bits}-bit packed domain (packing would "
                        f"silently truncate)")
                keys, vals = self._pack_rows(rows, info)
            if pred in self._warm:
                wrows, wvals = self._warm[pred]
                init = None
                if info.is_agg:
                    init = _MERGE_INIT["min" if info.agg == "min" else
                                       "max" if info.agg == "max" else "sum"]
                wk, wv = pack_warm_rows(wrows, wvals, self._schema(info), init,
                                        device=self.device)
                if keys is not None:
                    wk = torch.cat([keys, wk])
                    wv = torch.cat([vals, wv]) if wv is not None else None
                keys, vals = wk, wv
            if keys is not None:
                out[pred] = (keys, vals)
                sig.append((pred, int(keys.numel()), vals is not None))
        return out, tuple(sorted(sig))

    def _eval_group(self, gp: GroupPlan):
        edb, edb_sig = self._gather_edb(gp)
        facts, facts_sig = self._gather_facts(gp)
        ex = GroupExecutor(
            gp, caps={p: self._cap(p) for p in gp.preds}, bits=self.bits,
            jcap=self.join_cap or self.default_cap, max_iters=self.max_iters,
            device=self.device)
        key, sig = ex.structural_key(), (facts_sig, edb_sig)
        traced = _sn.note_trace("group", key, sig)
        try:
            state, iters, gen = ex.run(facts, edb, hook=self.iteration_hook)
        except _Overflow as e:
            raise CapacityError(
                f"relation {e.pred!r} overflowed capacity {self._cap(e.pred)}; "
                f"pass caps={{'{e.pred}': <larger>}}") from None
        except Exception:
            if traced:  # a JAX trace that raises caches nothing
                _sn.forget_trace("group", key, sig)
            raise
        # materialize, register for later strata
        for pred, info in gp.preds.items():
            t = state[pred]["all"]
            schema = self._schema(info)
            if info.is_agg:
                self.materialized[pred] = t.to_numpy(schema)
            else:
                self.materialized[pred] = (t.to_numpy(schema), None)
            self.stats[pred] = GroupStats(iterations=int(iters),
                                          generated=int(gen))

    def _pack_rows(self, rows: np.ndarray, info):
        schema = self._schema(info)
        t = torch.from_numpy(rows).to(self.device)
        if info.is_agg:
            keys = schema.pack([t[:, i] for i in range(info.key_arity)])
            return keys, t[:, info.key_arity].to(torch.int32)
        return schema.pack([t[:, i] for i in range(rows.shape[1])]), None
