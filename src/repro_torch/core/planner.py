"""Program planner: IR rules -> physical plans, as a pipeline of named passes.

Compilation runs ``normalize -> rewrite(magic | demand) -> stratify ->
compile_group`` (the pass list is recorded on the resulting plan), mirroring
the BigDatalog compiler (§6.2/6.3/7.3):

* **normalize** — rule dedup + arity consistency checks;
* **rewrite** — when :class:`PlanOptions` carries a query goal, the
  magic-sets rewrite of ``magic.py`` (or, with ``magic=False``, the weaker
  demand restriction to the query's reachable strata);
* **stratify** — PCG condensation + stratum order;
* **compile_group** — per SCC: exit/recursive rules into ``CompiledRule``
  pipelines (source + join sequence + interpreted goals + head projection),
  semi-naive delta-choice expansion for non-linear rules (δ-rewriting),
  **generalized pivoting** (Seib & Lausen: pivot set => decomposable,
  shuffle-free recursion, paper Figure 4) and **discriminating-set
  selection** with the RWA cost model c(N) ∈ {0,1,3} (§7.3).

Query constants are pushed *into* the physical operators (``SourceEdb``
selections and ``EdbJoinStep`` constant probes) instead of post-filtering.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Union

from .ir import AggSpec, Arith, Comparison, Const, Literal, Program, Rule, Term, Var, fresh_var
from .magic import MagicError, MagicRewrite
from .magic import rewrite as magic_rewrite
from .prem import check_prem_structural
from .stratify import PCG, StratificationError, build_pcg

# ---------------------------------------------------------------------------
# Plan IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PredInfo:
    name: str
    key_arity: int  # number of group-by/key columns
    agg: str | None  # aggregate kind, None => plain set
    agg_pos: int = -1  # literal argument position of the aggregate value

    @property
    def is_agg(self) -> bool:
        return self.agg is not None

    def key_rank(self, pos: int) -> int:
        """Map a literal argument position to its key-column index."""
        assert pos != self.agg_pos
        return pos - (1 if self.is_agg and pos > self.agg_pos else 0)


@dataclasses.dataclass(frozen=True)
class SourceDelta:
    pred: str
    key_vars: tuple[str, ...]  # '' entries ignored (unused columns)
    value_var: str | None


@dataclasses.dataclass(frozen=True)
class SourceEdb:
    rel: str
    intro: tuple[tuple[str, int], ...]  # (var, column)
    select: tuple[tuple[int, int], ...] = ()  # (column, constant) pre-filters


@dataclasses.dataclass(frozen=True)
class EdbJoinStep:
    rel: str
    probe_vars: tuple[Union[str, int], ...]  # var name, or int constant probe
    build_cols: tuple[int, ...]
    intro: tuple[tuple[str, int], ...]
    negated: bool = False  # anti-join (stratified negation)


@dataclasses.dataclass(frozen=True)
class IdbJoinStep:
    pred: str
    probe_vars: tuple[str, ...]
    probe_cols: tuple[int, ...]  # columns of the predicate bound by probe_vars
    intro: tuple[tuple[str, Union[int, str]], ...]  # col index or 'value'

    @property
    def is_prefix(self) -> bool:
        """Prefix joins reuse the table's own sort order (decomposable read);
        non-prefix joins force a per-iteration re-sort — the tuple engine's
        analog of a shuffle/repartition."""
        return self.probe_cols == tuple(range(len(self.probe_cols)))


JoinStep = Union[EdbJoinStep, IdbJoinStep]


@dataclasses.dataclass(frozen=True)
class CompiledRule:
    head_pred: str
    source: Union[SourceDelta, SourceEdb]
    joins: tuple[JoinStep, ...]
    ariths: tuple[Arith, ...]
    comps: tuple[Comparison, ...]
    head_keys: tuple[Union[str, int], ...]  # var name or int constant
    head_value: Union[str, int, None]  # agg value var/const; None for sets
    # additive-source -> additive-head rules consume the delta INCREMENT;
    # threshold/value consumers read the delta's new total (§semi-naive)
    use_increment: bool = False
    rule_repr: str = ""


@dataclasses.dataclass
class GroupPlan:
    """Evaluation plan for one SCC of the PCG."""

    preds: dict[str, PredInfo]
    recursive: bool
    exit_rules: list[CompiledRule]
    rec_rules: list[CompiledRule]
    pivot: dict[str, tuple[int, ...] | None]  # GPS per predicate (decomposable?)
    discriminating: dict[str, tuple[int, ...]]  # chosen partition columns
    rwa_cost: int
    prem: dict[str, object]


@dataclasses.dataclass
class PlanOptions:
    """Configuration for the pass pipeline.

    ``query``   — a query goal (constants = bound); enables demand-driven
                  rewriting and result restriction.
    ``batch``   — B same-shape query goals (same predicate, same adornment);
                  plans the magic rewrite with a query-id column threaded
                  through every adorned/magic predicate so ONE fixpoint
                  evaluates the union of the B demands and finalization
                  splits the answers per query.  Mutually exclusive with
                  ``query``.
    ``magic``   — apply the magic-sets rewrite for the query (otherwise only
                  the demanded strata are evaluated and constants filter the
                  result).
    ``push_constants`` — compile constants in EDB body literals into source
                  selections / constant join probes instead of post-filters.
    ``sparse``  — dense-lowered frontier fixpoints (``Engine.ask_dense``,
                  the serving layer's batched closures) pick the CSR-packed
                  O(|E|)-per-iteration engine (``core.sparse``): ``True`` /
                  ``False`` force a representation, ``None`` (default) lets
                  the density heuristic decide per relation.
    ``sparse_threshold`` — the heuristic's density cut: CSR when
                  |E|/n² < threshold (``None`` = library default).
    ``bucket_floors`` — per-relation ``quantize_rows`` floors,
                  ``((rel, floor), ...)``: relations whose cardinality
                  hovers around a bucket boundary pin a floor so warm
                  queries never straddle two compiled shapes (see
                  ``benchmarks/bench_buckets.py`` for how to pick them).
    ``tune``    — kernel tuning for CSR-lowered fixpoints
                  (``kernels.autotune``): ``True`` = roofline-steered
                  measured search at CSR build time (cached per graph-shape
                  signature), a pinned ``KernelConfig`` applies without
                  measuring, ``None`` (default) = library layout.
    """

    query: Literal | None = None
    batch: tuple[Literal, ...] | None = None
    magic: bool = True
    push_constants: bool = True
    sparse: bool | None = None
    sparse_threshold: float | None = None
    bucket_floors: tuple[tuple[str, int], ...] = ()
    tune: object = None  # bool | kernels.autotune.KernelConfig (hashable)


@dataclasses.dataclass
class ProgramPlan:
    program: Program  # the source program handed to plan_program
    pcg: PCG
    groups: list[GroupPlan]  # stratum/topological order
    rewritten: Program | None = None  # program the groups compile (post-passes)
    options: PlanOptions = dataclasses.field(default_factory=PlanOptions)
    passes: tuple[str, ...] = ()
    query_pred: str | None = None  # (adorned) predicate answering the query
    aliases: dict[str, str] = dataclasses.field(default_factory=dict)
    residual_filters: tuple[tuple[int, int], ...] = ()  # (arg pos, const)


class PlanError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Rule compilation
# ---------------------------------------------------------------------------


def _term_key(t: Term) -> Union[str, int]:
    return t.name if isinstance(t, Var) else int(t.value)


def _normalize_literal(lit: Literal, comps: list[Comparison], push_consts: bool) -> Literal:
    """Replace repeated vars (always) and constants (unless pushed down into
    the physical operators) with fresh vars + equality goals."""
    seen: set[str] = set()
    args: list[Term] = []
    for a in lit.args:
        if isinstance(a, Const):
            if push_consts:
                args.append(a)
                continue
            v = fresh_var("_c")
            comps.append(Comparison("=", v, a))
            args.append(v)
        elif a.name in seen:
            v = fresh_var("_r")
            comps.append(Comparison("=", v, a))
            args.append(v)
        else:
            seen.add(a.name)
            args.append(a)
    return Literal(lit.pred, tuple(args), lit.negated)


def compile_rule(
    rule: Rule,
    group: frozenset[str],
    pred_info: dict[str, PredInfo],
    delta_choice: int | None,
    options: PlanOptions | None = None,
) -> CompiledRule:
    """Compile one rule with a chosen delta occurrence (None => exit rule)."""
    options = options or PlanOptions()
    extra_comps: list[Comparison] = []
    # constants are pushed down only for literals handled as EDB scans/probes;
    # in-group (delta) literals join on packed key columns and keep the
    # normalize-to-equality form.
    pos_lits = [
        _normalize_literal(
            l, extra_comps, options.push_constants and l.pred not in group)
        for l in rule.body_literals() if not l.negated
    ]
    neg_lits = [l for l in rule.body_literals() if l.negated]  # kept verbatim
    rec_idx = [i for i, l in enumerate(pos_lits) if l.pred in group]

    # --- pick the source literal
    if delta_choice is not None:
        src_i = rec_idx[delta_choice]
    else:
        if rec_idx:
            raise PlanError(f"exit-rule compilation got recursive rule: {rule!r}")
        src_i = 0
    src_lit = pos_lits[src_i]
    remaining = [l for i, l in enumerate(pos_lits) if i != src_i]

    bound: set[str] = set()
    if src_lit.pred in group:
        info = pred_info[src_lit.pred]
        kv = [a.name for i, a in enumerate(src_lit.args) if i != info.agg_pos or not info.is_agg]
        vv = src_lit.args[info.agg_pos].name if info.is_agg else None
        source: Union[SourceDelta, SourceEdb] = SourceDelta(src_lit.pred, tuple(kv), vv)
        bound.update(kv)
        if vv:
            bound.add(vv)
    else:
        intro = tuple((a.name, i) for i, a in enumerate(src_lit.args)
                      if isinstance(a, Var))
        select = tuple((i, int(a.value)) for i, a in enumerate(src_lit.args)
                       if isinstance(a, Const))
        source = SourceEdb(src_lit.pred, intro, select)
        bound.update(a.name for a in src_lit.args if isinstance(a, Var))

    # --- order remaining positive literals greedily by shared bound vars
    # (a constant argument also anchors a join: it probes a fixed column)
    joins: list[JoinStep] = []
    work = list(remaining)
    guard = 0
    while work:
        guard += 1
        if guard > 50:
            raise PlanError(f"cannot order joins for {rule!r}")
        picked = None
        for l in work:
            anchored = any(
                isinstance(a, Const) or (isinstance(a, Var) and a.name in bound)
                for a in l.args
            )
            if anchored:
                picked = l
                break
        if picked is None:
            # cartesian product fallback: join on nothing is not supported;
            # require at least the paper's example shapes.
            raise PlanError(f"cartesian product in {rule!r} not supported")
        work.remove(picked)
        joins.append(_make_join(picked, bound, group, pred_info, extra_comps))
        bound.update(a.name for a in picked.args if isinstance(a, Var))

    # --- negated literals become anti-joins (EDB / lower-stratum only).
    # Unbound/anonymous arguments project the negated relation onto the bound
    # columns (the ¬myrupt(_,_,_,_,T) "no child" test of Example 9).
    for l in neg_lits:
        if l.pred in group:
            raise PlanError(f"negation inside recursive group: {rule!r}")
        bound_args = [
            (int(a.value) if isinstance(a, Const) else a.name, i)
            for i, a in enumerate(l.args)
            if isinstance(a, Const) or a.name in bound
        ]
        if not bound_args:
            raise PlanError(f"no bound vars in negated literal {l!r}")
        joins.append(
            EdbJoinStep(rel=l.pred,
                        probe_vars=tuple(v for v, _ in bound_args),
                        build_cols=tuple(i for _, i in bound_args),
                        intro=(), negated=True)
        )

    # --- interpreted goals, ordered by def-before-use
    ariths = [g for g in rule.body if isinstance(g, Arith)]
    ordered: list[Arith] = []
    avail = set(bound)
    pending = list(ariths)
    while pending:
        prog = False
        for a in list(pending):
            deps = {t.name for t in (a.lhs, a.rhs) if isinstance(t, Var)}
            if deps <= avail:
                ordered.append(a)
                avail.add(a.target.name)
                pending.remove(a)
                prog = True
        if not prog:
            raise PlanError(f"cyclic arithmetic in {rule!r}")
    comps = tuple(extra_comps + [g for g in rule.body if isinstance(g, Comparison)])

    # --- head projection
    info = pred_info[rule.head.pred]
    keys, value = [], None
    for i, a in enumerate(rule.head.args):
        if rule.agg is not None and i == rule.agg.position:
            value = _term_key(a)
            if rule.agg.kind in ("count", "mcount"):
                value = 1  # each distinct derivation contributes one
            continue
        keys.append(_term_key(a))
    if rule.agg is None and info.is_agg:
        # plain rule feeding an aggregate predicate (e.g. len(T, 0) exit rules)
        value = _term_key(rule.head.args[info.agg_pos])
        keys = [
            _term_key(a) for i, a in enumerate(rule.head.args) if i != info.agg_pos
        ]
    additive = ("sum", "count", "msum", "mcount")
    use_inc = (
        isinstance(source, SourceDelta)
        and pred_info[source.pred].agg in additive
        and info.agg in additive
    )
    return CompiledRule(
        head_pred=rule.head.pred,
        source=source,
        joins=tuple(joins),
        ariths=tuple(ordered),
        comps=comps,
        head_keys=tuple(keys),
        head_value=value,
        use_increment=use_inc,
        rule_repr=repr(rule),
    )


def _make_join(lit: Literal, bound: set[str], group: frozenset[str], pred_info,
               extra_comps: list[Comparison]) -> JoinStep:
    shared = [(a.name, i) for i, a in enumerate(lit.args)
              if isinstance(a, Var) and a.name in bound]
    consts = [(int(a.value), i) for i, a in enumerate(lit.args)
              if isinstance(a, Const)]
    new = list((a.name, i) for i, a in enumerate(lit.args)
               if isinstance(a, Var) and a.name not in bound)
    if lit.pred in group:
        info = pred_info[lit.pred]
        is_val = lambda i: info.is_agg and i == info.agg_pos
        shared_key = [(v, i) for v, i in shared if not is_val(i)]
        if not shared_key:
            raise PlanError(f"IDB join without key columns in {lit!r}")
        # a shared var on the *value* column joins via post-filter equality
        for v, i in shared:
            if is_val(i):
                fv = fresh_var("_vv")
                new.append((fv.name, i))
                extra_comps.append(Comparison("=", fv, Var(v)))
        intro = []
        for v, i in new:
            intro.append((v, "value" if is_val(i) else info.key_rank(i)))
        return IdbJoinStep(
            lit.pred,
            tuple(v for v, _ in shared_key),
            tuple(info.key_rank(i) for _, i in shared_key),
            tuple(intro),
        )
    probes = shared + consts  # constants probe their column directly
    return EdbJoinStep(
        rel=lit.pred,
        probe_vars=tuple(v for v, _ in probes),
        build_cols=tuple(i for _, i in probes),
        intro=new,
    )


# ---------------------------------------------------------------------------
# Generalized pivoting (decomposability) + RWA discriminating sets
# ---------------------------------------------------------------------------


def generalized_pivot(program: Program, pred: str, group: frozenset[str]) -> tuple[int, ...] | None:
    """Simplified Seib/Lausen GPS: argument positions of ``pred`` preserved
    verbatim by every recursive rule between head and every recursive body
    literal.  Non-empty => partitioning on those positions is decomposable
    (paper Fig. 4: tc pivots on position 0)."""
    key_positions = None
    for rule in program.rules_for(pred):
        rec = [l for l in rule.positive_literals() if l.pred in group]
        if not rec:
            continue
        preserved = set()
        for i, a in enumerate(rule.head.args):
            if isinstance(a, Var) and all(
                i < len(l.args) and l.args[i] == a for l in rec
            ):
                preserved.add(i)
        key_positions = preserved if key_positions is None else key_positions & preserved
    if not key_positions:
        return None
    return tuple(sorted(key_positions))


def rwa_cost(program: Program, pred: str, group: frozenset[str], disc: tuple[int, ...]) -> int:
    """RWA-analog cost (§7.3) of partitioning ``pred`` on columns ``disc``.

    c(N)=0: reads/writes stay in the i-th partition (pivot-aligned);
    c(N)=1: writes need repartitioning (a shuffle per iteration);
    c(N)=3: probes must visit every partition (broadcast / replicated reads).
    """
    cost = 0
    for rule in program.rules_for(pred):
        rec = [l for l in rule.positive_literals() if l.pred in group]
        if not rec:
            continue
        # W-node: does the head key at `disc` come verbatim from the delta lit?
        for l in rec:
            aligned = all(
                i < len(l.args) and i < len(rule.head.args) and l.args[i] == rule.head.args[i]
                for i in disc
            )
            if not aligned:
                cost += 1  # write repartition (shuffle)
        # R-nodes: other recursive literals probed on non-disc columns
        for l in rec[1:]:
            cost += 3
    return cost


def choose_discriminating_set(program: Program, pred: str, group: frozenset[str], arity: int) -> tuple[tuple[int, ...], int]:
    """Brute-force the best discriminating set (the paper's tractable search)."""
    best, best_cost = (0,), None
    for r in (1, 2):
        for cand in itertools.combinations(range(arity), r):
            c = rwa_cost(program, pred, group, cand)
            if best_cost is None or c < best_cost:
                best, best_cost = cand, c
    return best, best_cost or 0


# ---------------------------------------------------------------------------
# Whole-program planning: the pass pipeline
# ---------------------------------------------------------------------------


def pass_normalize(program: Program, options: PlanOptions) -> Program:
    """Dedupe rules (preserving order) and check per-predicate arity/aggregate
    consistency — the sanity layer every later pass may assume."""
    seen: set[str] = set()
    rules: list[Rule] = []
    for r in program.rules:
        key = repr(r)
        if key not in seen:
            seen.add(key)
            rules.append(r)
    arity: dict[str, int] = {}
    for r in rules:
        for lit in [r.head] + r.body_literals():
            if arity.setdefault(lit.pred, lit.arity) != lit.arity:
                raise PlanError(
                    f"inconsistent arity for {lit.pred}: "
                    f"{arity[lit.pred]} vs {lit.arity} in {r!r}")
    return Program(rules, queries=list(program.queries))


def pass_rewrite(program: Program, options: PlanOptions) -> tuple[Program, MagicRewrite | None, str]:
    """Demand-driven rewriting.  With a query and ``magic=True``, apply the
    magic-sets rewrite; with ``magic=False``, restrict to the demanded strata
    (rules transitively reachable from the query predicate).  With a
    ``batch``, the magic rewrite additionally threads a query-id column
    (``magic.attribute_qids``) and materializes one tagged seed per query."""
    if options.batch is not None:
        return _rewrite_batch(program, options)
    if options.query is None:
        return program, None, "rewrite(none)"
    q = options.query
    q_rules = program.rules_for(q.pred)
    if q_rules and q_rules[0].head.arity != len(q.args):
        raise PlanError(
            f"query {q!r} has arity {len(q.args)} but {q.pred} has "
            f"arity {q_rules[0].head.arity}")
    if options.magic:
        try:
            mr = magic_rewrite(program, options.query)
        except MagicError as e:
            raise PlanError(str(e)) from e
        return mr.program, mr, "rewrite(magic)"
    return demanded_strata(program, options.query.pred), None, "rewrite(demand)"


def batch_adornment(program: Program, q: Literal) -> str:
    """The (pred, adornment) shape key of a query goal — batches coalesce on
    identical shapes only (shared by ``Engine.ask_batch`` and the service's
    tuple-batch router so the two agree on what may share a fixpoint)."""
    from .magic import agg_positions, query_adornment
    return query_adornment(q, agg_positions(program).get(q.pred, -1))


def _rewrite_batch(program: Program, options: PlanOptions):
    from .magic import attribute_qids, qid_batchable
    batch = options.batch
    if not batch:
        raise PlanError("empty query batch")
    if not options.magic:
        raise PlanError(
            "batch planning requires the magic rewrite (per-seed attribution "
            "tags the magic seeds); with magic=False evaluate sequentially")
    q0 = batch[0]
    adn = batch_adornment(program, q0)
    for q in batch[1:]:
        if q.pred != q0.pred or batch_adornment(program, q) != adn:
            raise PlanError(
                f"mixed-shape batch: {q!r} does not share the "
                f"({q0.pred}, {adn}) shape of {q0!r}")
    try:
        mr = magic_rewrite(program, q0)
    except MagicError as e:
        raise PlanError(str(e)) from e
    if not qid_batchable(mr):
        raise PlanError(
            f"({q0.pred}, {adn}) does not admit per-seed attribution "
            "(all-free adornment in the rewrite); evaluate sequentially")
    bound = [i for i, c in enumerate(adn) if c == "b"]
    seeds = [(qid,) + tuple(int(q.args[i].value) for i in bound)
             for qid, q in enumerate(batch)]
    try:
        mr = attribute_qids(mr, seed_rows=seeds)
    except MagicError as e:
        raise PlanError(str(e)) from e
    return mr.program, mr, "rewrite(magic+qid)"


def demanded_strata(program: Program, pred: str) -> Program:
    if pred not in program.idb_predicates():
        raise PlanError(f"query predicate {pred!r} is not an IDB predicate")
    needed, frontier = set(), [pred]
    while frontier:
        p = frontier.pop()
        if p in needed:
            continue
        needed.add(p)
        for r in program.rules_for(p):
            frontier.extend(l.pred for l in r.body_literals())
    return Program([r for r in program.rules if r.head.pred in needed],
                   queries=list(program.queries))


def pass_stratify(program: Program, options: PlanOptions) -> PCG:
    return build_pcg(program)


def compile_group(
    program: Program,
    scc_idb: list[str],
    pred_info: dict[str, PredInfo],
    pcg: PCG,
    options: PlanOptions,
) -> GroupPlan:
    """Compile one SCC of the PCG into exit/recursive rule pipelines."""
    group = frozenset(scc_idb)
    recursive = any(pcg.is_recursive(p) for p in scc_idb)

    exit_rules, rec_rules = [], []
    prem_reports = {}
    for pred in scc_idb:
        if recursive:
            rep = check_prem_structural(program, pred, group)
            prem_reports[pred] = rep
            if not rep.holds:
                raise PlanError(
                    f"aggregate on {pred} is not PreM: {rep.reasons}"
                )
        for rule in program.rules_for(pred):
            if rule.is_fact():
                continue  # materialized directly by the engine (magic seeds)
            rec_idx = [
                i for i, l in enumerate(
                    [x for x in rule.body_literals() if not x.negated])
                if l.pred in group
            ]
            if not rec_idx:
                exit_rules.append(compile_rule(rule, group, pred_info, None, options))
            else:
                for choice in range(len(rec_idx)):  # δ-rewriting variants
                    rec_rules.append(compile_rule(rule, group, pred_info, choice, options))

    pivot, disc, cost = {}, {}, 0
    for pred in scc_idb:
        if recursive:
            gps = generalized_pivot(program, pred, group)
            pivot[pred] = gps
            if gps:
                disc[pred] = gps
                cost += 0
            else:
                d, c = choose_discriminating_set(
                    program, pred, group, pred_info[pred].key_arity
                )
                disc[pred], cost = d, cost + c
        else:
            pivot[pred] = None
            disc[pred] = (0,)

    return GroupPlan(
        preds={p: pred_info[p] for p in scc_idb},
        recursive=recursive,
        exit_rules=exit_rules,
        rec_rules=rec_rules,
        pivot=pivot,
        discriminating=disc,
        rwa_cost=cost,
        prem=prem_reports,
    )


def _pred_infos(program: Program) -> dict[str, PredInfo]:
    pred_info: dict[str, PredInfo] = {}
    for pred in program.idb_predicates():
        rules = program.rules_for(pred)
        agg_specs = {(r.agg.kind, r.agg.position) for r in rules if r.agg is not None}
        if len(agg_specs) > 1:
            raise PlanError(f"mixed aggregates on {pred}: {agg_specs}")
        agg, agg_pos = agg_specs.pop() if agg_specs else (None, -1)
        arity = rules[0].head.arity
        key_arity = arity - 1 if agg else arity
        pred_info[pred] = PredInfo(pred, key_arity, agg, agg_pos)
    return pred_info


def plan_program(program: Program, options: PlanOptions | None = None) -> ProgramPlan:
    """Run the pass pipeline: normalize -> rewrite -> stratify -> compile_group."""
    options = options or PlanOptions()
    passes: list[str] = []

    prog = pass_normalize(program, options)
    passes.append("normalize")

    prog, mr, rewrite_name = pass_rewrite(prog, options)
    passes.append(rewrite_name)

    pcg = pass_stratify(prog, options)
    passes.append("stratify")

    pred_info = _pred_infos(prog)
    idb = prog.idb_predicates()
    groups: list[GroupPlan] = []
    for scc in pcg.sccs:  # already leaves-first (reverse topological)
        scc_idb = sorted(p for p in scc if p in idb)
        if scc_idb:
            groups.append(compile_group(prog, scc_idb, pred_info, pcg, options))
    passes.append("compile_group")

    if mr is not None:
        query_pred, aliases, residual = mr.query_pred, mr.aliases, mr.residual_filters
    elif options.query is not None:
        q = options.query
        query_pred = q.pred
        aliases = {q.pred: q.pred}
        residual = tuple((i, int(a.value)) for i, a in enumerate(q.args)
                         if isinstance(a, Const))
    else:
        query_pred, aliases, residual = None, {}, ()

    return ProgramPlan(
        program=program,
        pcg=pcg,
        groups=groups,
        rewritten=prog,
        options=options,
        passes=tuple(passes),
        query_pred=query_pred,
        aliases=aliases,
        residual_filters=residual,
    )
