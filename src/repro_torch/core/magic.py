"""Adorned programs + the (supplementary) Magic-Sets rewrite.

The paper's abstract names two implementation techniques behind scalable
Datalog — "Semi-naive Fixpoint and Magic Sets".  This module supplies the
second as a *source-to-source pass*: given a query goal such as
``?- tc(1, X).`` it

1. **adorns** the program — propagates a ``b``/``f`` (bound/free) pattern per
   predicate argument from the query through every rule with a left-to-right
   sideways-information-passing strategy (SIPS), cloning each IDB predicate
   once per distinct binding pattern (``tc`` becomes ``tc__bf``);
2. emits **magic predicates** (``m__tc__bf``) that compute exactly the set of
   bound-argument tuples *demanded* during top-down evaluation, seeded with
   the query constants; and
3. guards every adorned rule with its magic literal, so the ordinary
   bottom-up semi-naive fixpoint only derives facts a top-down evaluation
   would have asked for.

The output is a plain :class:`~repro.core.ir.Program`; the existing
stratifier / planner / PSN machinery runs unchanged on the rewritten rules.
Aggregate heads survive the rewrite verbatim (the magic literal only filters
group-by columns, which commutes with the PreM transfer), with the aggregate
value position pinned to ``f`` in every adornment.

Also here: :func:`detect_frontier_lowering`, the pattern-match that lets a
magic-restricted *decomposable* program (single-source TC / shortest paths)
lower onto the dense ``form="vector"`` semiring fixpoint instead of the tuple
engine — the frontier row of the query seeds the vector.
"""
from __future__ import annotations

import dataclasses

from .ir import (QID_VAR, Arith, Comparison, Const, Goal, Literal, Program,
                 Rule, Var)

BOUND, FREE = "b", "f"


class MagicError(ValueError):
    pass


def adorned_name(pred: str, adornment: str) -> str:
    return f"{pred}__{adornment}"


def magic_name(pred: str, adornment: str) -> str:
    return f"m__{pred}__{adornment}"


def query_adornment(query: Literal, agg_pos: int = -1) -> str:
    """``b`` where the query supplies a constant, ``f`` elsewhere; the
    aggregate value position is always ``f`` (demand is on group-by keys)."""
    return "".join(
        BOUND if isinstance(a, Const) and i != agg_pos else FREE
        for i, a in enumerate(query.args)
    )


@dataclasses.dataclass
class MagicRewrite:
    """Result of :func:`rewrite` — a plain program plus bookkeeping."""

    program: Program
    query: Literal
    query_pred: str  # adorned name of the queried predicate
    adornment: str
    aliases: dict[str, str]  # adorned/magic name -> original predicate
    #: (position, constant) pairs the adornment could not bind (aggregate
    #: value positions); callers post-filter results on these.
    residual_filters: tuple[tuple[int, int], ...] = ()
    #: the top magic seed fact carrying the query constants (None when the
    #: query binds nothing).  The serving layer swaps this single rule for a
    #: seed-EDB rule so one rewrite/plan serves every query of the adornment.
    seed_rule: "Rule | None" = None
    #: True once :func:`attribute_qids` threaded a query-id column: every
    #: adorned/magic predicate carries a leading qid argument and the query
    #: predicate's answers split per-query on that column.
    qid: bool = False


def agg_positions(program: Program) -> dict[str, int]:
    """Aggregate value position per predicate (absent = plain set)."""
    out: dict[str, int] = {}
    for r in program.rules:
        if r.agg is not None:
            out[r.head.pred] = r.agg.position
    return out


_agg_positions = agg_positions  # internal alias (pre-PR-4 name)


def _literal_adornment(lit: Literal, bound: set[str], agg_pos: int) -> str:
    adn = []
    for i, a in enumerate(lit.args):
        if i == agg_pos:
            adn.append(FREE)
        elif isinstance(a, Const) or (isinstance(a, Var) and a.name in bound):
            adn.append(BOUND)
        else:
            adn.append(FREE)
    return "".join(adn)


def _goal_binds(g: Goal, bound: set[str]) -> None:
    """Update ``bound`` in place with variables this goal makes available."""
    if isinstance(g, Literal):
        if not g.negated:
            bound.update(a.name for a in g.args if isinstance(a, Var))
    elif isinstance(g, Arith):
        deps = {t.name for t in (g.lhs, g.rhs) if isinstance(t, Var)}
        if deps <= bound:
            bound.add(g.target.name)
    elif isinstance(g, Comparison) and g.op == "=":
        lv = g.lhs.name if isinstance(g.lhs, Var) else None
        rv = g.rhs.name if isinstance(g.rhs, Var) else None
        if lv and (rv in bound or isinstance(g.rhs, Const)):
            bound.add(lv)
        if rv and (lv in bound or isinstance(g.lhs, Const)):
            bound.add(rv)


def _safe_for_magic_body(g: Goal, avail: set[str]) -> bool:
    """Can this prefix goal be carried into a magic-rule body?  Positive
    literals always; interpreted goals only when their inputs are available
    (otherwise the compiled magic rule would reference unbound columns)."""
    if isinstance(g, Literal):
        return not g.negated
    if isinstance(g, Arith):
        return {t.name for t in (g.lhs, g.rhs) if isinstance(t, Var)} <= avail
    if isinstance(g, Comparison):
        vs = {t.name for t in (g.lhs, g.rhs) if isinstance(t, Var)}
        missing = vs - avail
        if g.op == "=" and len(missing) == 1:
            # binding equality: the missing side gets its value from the
            # other side, which must itself be available (var) or a constant
            other = g.rhs if (isinstance(g.lhs, Var) and g.lhs.name in missing) \
                else g.lhs
            return isinstance(other, Const) or (
                isinstance(other, Var) and other.name in avail)
        return not missing
    return False


def rewrite(program: Program, query: Literal) -> MagicRewrite:
    """Supplementary magic-sets rewrite of ``program`` for ``query``.

    Left-to-right SIPS: a body literal sees bindings from the (magic-guarded)
    head plus every goal to its left.  Negated IDB literals are kept
    *unrestricted* (all-free adornment) — soundness of stratified negation
    requires the complete negated relation on the probed columns.
    """
    idb = program.idb_predicates()
    if query.pred not in idb:
        raise MagicError(f"query predicate {query.pred!r} is not an IDB predicate")
    agg_pos = _agg_positions(program)

    q_agg = agg_pos.get(query.pred, -1)
    q_adn = query_adornment(query, q_agg)
    residual = tuple(
        (i, int(a.value)) for i, a in enumerate(query.args)
        if isinstance(a, Const) and q_adn[i] == FREE
    )

    out_rules: list[Rule] = []
    seen_magic: set[str] = set()
    aliases: dict[str, str] = {}
    worklist: list[tuple[str, str]] = [(query.pred, q_adn)]
    done: set[tuple[str, str]] = set()

    def enqueue(pred: str, adn: str):
        if (pred, adn) not in done and (pred, adn) not in worklist:
            worklist.append((pred, adn))

    def add_magic(rule: Rule):
        key = repr(rule)
        if key in seen_magic:
            return
        # drop the trivial m(X..) <- m(X..) self-propagation
        if len(rule.body) == 1 and rule.body[0] == rule.head:
            return
        seen_magic.add(key)
        out_rules.append(rule)

    # seed: the query's constants populate the top magic predicate
    seed_rule: Rule | None = None
    if BOUND in q_adn:
        seed_args = tuple(a for i, a in enumerate(query.args) if q_adn[i] == BOUND)
        seed_rule = Rule(Literal(magic_name(query.pred, q_adn), seed_args), ())
        out_rules.append(seed_rule)
        aliases[magic_name(query.pred, q_adn)] = query.pred

    while worklist:
        pred, adn = worklist.pop(0)
        if (pred, adn) in done:
            continue
        done.add((pred, adn))
        aliases[adorned_name(pred, adn)] = pred

        for rule in program.rules_for(pred):
            if rule.is_fact():
                head = Literal(adorned_name(pred, adn), rule.head.args)
                if BOUND in adn:
                    # guard the fact with its magic instance, else fact rows
                    # outside the demanded set would leak into the answer
                    guard = Literal(
                        magic_name(pred, adn),
                        tuple(a for i, a in enumerate(rule.head.args)
                              if adn[i] == BOUND))
                    out_rules.append(Rule(head, (guard,), rule.agg))
                else:
                    out_rules.append(Rule(head, (), rule.agg))
                continue
            bound: set[str] = {
                a.name for i, a in enumerate(rule.head.args)
                if adn[i] == BOUND and isinstance(a, Var)
            }
            head_magic: Literal | None = None
            if BOUND in adn:
                head_magic = Literal(
                    magic_name(pred, adn),
                    tuple(a for i, a in enumerate(rule.head.args) if adn[i] == BOUND),
                )

            new_body: list[Goal] = []
            prefix: list[Goal] = []  # transformed goals usable in magic bodies
            prefix_avail: set[str] = set(bound)
            for g in rule.body:
                if isinstance(g, Literal) and not g.negated and g.pred in idb:
                    occ_adn = _literal_adornment(g, bound, agg_pos.get(g.pred, -1))
                    enqueue(g.pred, occ_adn)
                    if BOUND in occ_adn:
                        m_args = tuple(
                            a for i, a in enumerate(g.args) if occ_adn[i] == BOUND)
                        m_vars = {a.name for a in m_args if isinstance(a, Var)}
                        if not m_vars <= prefix_avail:
                            # SIPS marked these bound but no magic-body goal
                            # can supply them; bail out so the planner falls
                            # back to the demanded-strata plan
                            raise MagicError(
                                f"SIPS cannot supply bindings "
                                f"{sorted(m_vars - prefix_avail)} for the "
                                f"magic of {g!r} in {rule!r}")
                        aliases[magic_name(g.pred, occ_adn)] = g.pred
                        m_head = Literal(magic_name(g.pred, occ_adn), m_args)
                        m_body: list[Goal] = list(prefix)
                        if head_magic is not None:
                            m_body.insert(0, head_magic)
                        if m_body:
                            add_magic(Rule(m_head, tuple(m_body)))
                        elif all(isinstance(a, Const) for a in m_args):
                            add_magic(Rule(m_head, ()))  # constant demand
                    renamed = Literal(adorned_name(g.pred, occ_adn), g.args)
                    new_body.append(renamed)
                elif isinstance(g, Literal) and g.negated and g.pred in idb:
                    ff = FREE * len(g.args)
                    enqueue(g.pred, ff)
                    new_body.append(Literal(adorned_name(g.pred, ff), g.args, negated=True))
                else:
                    new_body.append(g)
                last = new_body[-1]
                if _safe_for_magic_body(last, prefix_avail):
                    prefix.append(last)
                    _goal_binds(last, prefix_avail)
                _goal_binds(g, bound)

            full_body: list[Goal] = list(new_body)
            if head_magic is not None:
                full_body.insert(0, head_magic)
            out_rules.append(Rule(
                Literal(adorned_name(pred, adn), rule.head.args),
                tuple(full_body), rule.agg))

    return MagicRewrite(
        program=Program(out_rules),
        query=query,
        query_pred=adorned_name(query.pred, q_adn),
        adornment=q_adn,
        aliases=aliases,
        residual_filters=residual,
        seed_rule=seed_rule,
    )


# ---------------------------------------------------------------------------
# Per-seed attribution: thread a query-id column through a magic rewrite so
# ONE bottom-up fixpoint evaluates the union of B demands and the answers
# split back per query.  (ROADMAP "Batched tuple-path queries".)
# ---------------------------------------------------------------------------


def _adn_of(name: str) -> str:
    return name.rsplit("__", 1)[1]


def qid_batchable(mr: MagicRewrite) -> bool:
    """Does this rewrite admit the query-id column?

    Requires every adorned/magic predicate to participate in demand flow —
    i.e. carry at least one bound slot.  Then every adorned rule (facts
    included) is guarded by a magic literal and every magic rule derives from
    one, so the qid variable is bound in every rule body and tagged
    derivations stay confined to the demand that caused them.  All-free
    adornments (negated IDB literals, unbound queries) have no demand source
    to take a qid from — those shapes fall back to sequential evaluation.
    """
    if mr.seed_rule is None or BOUND not in mr.adornment:
        return False
    return all(BOUND in _adn_of(name) for name in mr.aliases)


def attribute_qids(
    mr: MagicRewrite,
    seed_rel: str | None = None,
    seed_rows: "list[tuple[int, ...]] | None" = None,
) -> MagicRewrite:
    """Thread a query-id column through a magic rewrite.

    Every adorned/magic predicate gains a leading qid argument; within each
    rule one shared qid variable joins the head and every adorned/magic body
    literal, so the model restricted to ``qid = k`` is isomorphic to the
    single-query magic program seeded with query k's constants.  B demands
    evaluate in ONE semi-naive fixpoint (shared plan, shared EDB indexes,
    shared iteration schedule) and finalization splits answers on the qid.

    The original seed fact is dropped and replaced by:

    * ``seed_rel`` — a seed-EDB rule ``m__p__adn(Q, S..) <- seed_rel(Q, S..)``
      so a resident service swaps seed *rows* per batch without replanning
      (row counts quantize to power-of-two buckets inside the engine, so warm
      batch sizes reuse compiled fixpoints); and/or
    * ``seed_rows`` — inline ``(qid, consts..)`` facts for one-shot
      ``Engine.ask_batch`` evaluation.

    Raises :class:`MagicError` when the rewrite is not :func:`qid_batchable`.
    """
    if not qid_batchable(mr):
        raise MagicError(
            f"rewrite of {mr.query!r} is not qid-batchable (an all-free "
            "adornment has no demand source for the query-id column)")
    tagged = set(mr.aliases)
    qv = Var(QID_VAR)
    for r in mr.program.rules:
        names = {v.name for g in (r.head, *r.body)
                 for v in (g.vars() if hasattr(g, "vars") else [])}
        if QID_VAR in names:
            raise MagicError(f"program already uses reserved var {QID_VAR!r}")

    def tag(g: Goal) -> Goal:
        if isinstance(g, Literal) and g.pred in tagged:
            return g.with_prefix(qv)
        return g

    rules: list[Rule] = []
    for r in mr.program.rules:
        if r is mr.seed_rule:
            continue  # replaced by the seed-EDB rule / inline seed facts
        agg = r.agg
        if agg is not None and r.head.pred in tagged:
            agg = agg.shifted(1)
        rules.append(Rule(tag(r.head), tuple(tag(g) for g in r.body), agg))

    seed_pred = mr.seed_rule.head.pred
    if seed_rel is not None:
        svars = tuple(Var(f"__s{i}") for i in range(len(mr.seed_rule.head.args)))
        rules.append(Rule(Literal(seed_pred, (qv,) + svars),
                          (Literal(seed_rel, (qv,) + svars),)))
    for row in seed_rows or ():
        rules.append(Rule(
            Literal(seed_pred, tuple(Const(int(v)) for v in row)), ()))

    return dataclasses.replace(
        mr, program=Program(rules), qid=True, seed_rule=None)


# ---------------------------------------------------------------------------
# Frontier lowering: magic-restricted decomposable programs -> dense vector
# fixpoints (tc_decomposable / form="vector" seeded with the query frontier).
# ---------------------------------------------------------------------------


def frontier_query_source(q: Literal) -> int | None:
    """The bound pivot of a canonical single-source query, or None.

    A query admits the dense frontier plan only when the pivot (first)
    argument is a constant and the tail is all *distinct* free variables —
    a repeated tail variable (``dpath(0, X, X)``) adds an equality the
    lowering cannot enforce.  Shared by ``Engine.ask_dense`` and the serving
    layer's batch router so both agree on eligibility.
    """
    tail = q.args[1:]
    if not (len(q.args) >= 2 and isinstance(q.args[0], Const)
            and all(isinstance(a, Var) for a in tail)
            and len({a.name for a in tail}) == len(tail)):
        return None
    return int(q.args[0].value)


@dataclasses.dataclass(frozen=True)
class FrontierLowering:
    """A program admitting the dense single-source plan.

    ``kind`` selects the semiring carrier: ``'bool'`` (reachability / TC),
    ``'minplus'`` (shortest distances), ``'maxplus'`` (longest paths over
    DAGs), or ``'plustimes'`` (path counting / weighted sums — the additive
    carrier, which needs the accumulate-form fixpoint with a termination
    bound instead of the idempotent convergence test).
    """

    pred: str
    edb: str
    kind: str  # 'bool' | 'minplus' | 'maxplus' | 'plustimes'


#: head aggregate -> (lowering kind, the ⊗-combine Arith op of the rec rule).
#: min/max ride tropical carriers (⊗ = +); sum/msum ride the additive
#: plus-times carrier (⊗ = ×), the paper's count/sum-in-recursion shape.
_AGG_LOWERING = {
    "min": ("minplus", "+"),
    "max": ("maxplus", "+"),
    "sum": ("plustimes", "*"),
    "msum": ("plustimes", "*"),
}


def detect_frontier_lowering(program: Program, pred: str) -> FrontierLowering | None:
    """Match the canonical decomposable shapes::

        p(X,Y) <- e(X,Y).                       p(X,Y,min<D>) <- e(X,Y,D).
        p(X,Y) <- p(X,Z), e(Z,Y).               p(X,Z,min<D>) <- p(X,Y,D1),
                                                    e(Y,Z,D2), D = D1 + D2.

    With the query binding the pivot (first) argument, both lower to a
    ``form="vector"`` fixpoint seeded with the source's frontier row.
    """
    rules = program.rules_for(pred)
    if len(rules) != 2:
        return None
    idb = program.idb_predicates()
    exit_r = next((r for r in rules
                   if not any(l.pred == pred for l in r.positive_literals())), None)
    rec_r = next((r for r in rules
                  if any(l.pred == pred for l in r.positive_literals())), None)
    if exit_r is None or rec_r is None:
        return None

    def only_vars(lit):
        return all(isinstance(a, Var) for a in lit.args)

    # ---- exit rule: p(args) <- e(args) with identical argument vectors
    if len(exit_r.body) != 1 or not isinstance(exit_r.body[0], Literal):
        return None
    e_lit = exit_r.body[0]
    if e_lit.negated or e_lit.pred in idb or e_lit.args != exit_r.head.args:
        return None
    if not only_vars(e_lit) or len(set(a.name for a in e_lit.args)) != len(e_lit.args):
        return None

    agg = exit_r.head.arity == 3
    if agg:
        if not (exit_r.agg and exit_r.agg.kind in _AGG_LOWERING
                and exit_r.agg.position == 2
                and rec_r.agg and rec_r.agg.kind == exit_r.agg.kind
                and rec_r.agg.position == 2):
            return None
        kind, combine_op = _AGG_LOWERING[exit_r.agg.kind]
    elif exit_r.head.arity != 2 or exit_r.agg or rec_r.agg:
        return None

    # ---- recursive rule: p(A,M[,D1]) then e(M,B[,D2]) in either order
    lits = [g for g in rec_r.body if isinstance(g, Literal)]
    if len(lits) != 2 or any(l.negated for l in lits):
        return None
    rec_l = next((l for l in lits if l.pred == pred), None)
    edb_l = next((l for l in lits if l.pred == e_lit.pred), None)
    if rec_l is None or edb_l is None or not (only_vars(rec_l) and only_vars(edb_l)):
        return None
    h = rec_r.head.args
    if not (rec_l.args[0] == h[0]            # pivot preserved (GPS on arg 0)
            and rec_l.args[1] == edb_l.args[0]  # chain var
            and edb_l.args[1] == h[1]):
        return None
    if agg:
        ariths = [g for g in rec_r.body if isinstance(g, Arith)]
        if len(ariths) != 1 or len(rec_r.body) != 3:
            return None
        a = ariths[0]
        if a.op != combine_op or a.target != h[2]:
            return None
        if {a.lhs, a.rhs} != {rec_l.args[2], edb_l.args[2]}:
            return None
        return FrontierLowering(pred, e_lit.pred, kind)
    if len(rec_r.body) != 2:
        return None
    return FrontierLowering(pred, e_lit.pred, "bool")
