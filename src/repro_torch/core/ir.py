"""Datalog IR: terms, literals, rules, programs.

Mirrors the paper's language surface: positive/negated literals, comparison
and arithmetic goals, and head aggregates ``min< >``, ``max< >``, ``count< >``,
``sum< , >``, ``mcount< >``, ``msum< >`` (§2).  Constants are ints or interned
symbols (the engine operates on ints; ``SymbolTable`` handles interning).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Union

# ---------------------------------------------------------------------------
# Terms
# ---------------------------------------------------------------------------

_fresh = itertools.count()


@dataclasses.dataclass(frozen=True)
class Var:
    name: str

    def __repr__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class Const:
    value: int

    def __repr__(self):
        return str(self.value)


Term = Union[Var, Const]


def fresh_var(prefix: str = "_V") -> Var:
    return Var(f"{prefix}{next(_fresh)}")


#: Reserved variable name threading the *query-id column* of a batched
#: demand rewrite (``magic.attribute_qids``) through adorned/magic rules.
#: Fixed (not ``fresh_var``) on purpose: compiled-rule reprs are the engine's
#: runner-cache keys, so two services building the same batched template must
#: produce byte-identical plans to share one compiled fixpoint.
QID_VAR = "__qid"


# ---------------------------------------------------------------------------
# Body goals
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Literal:
    pred: str
    args: tuple[Term, ...]
    negated: bool = False

    @property
    def arity(self) -> int:
        return len(self.args)

    def vars(self) -> list[Var]:
        return [a for a in self.args if isinstance(a, Var)]

    def with_prefix(self, term: Term) -> "Literal":
        """This literal with one extra leading argument (qid threading)."""
        return Literal(self.pred, (term,) + self.args, self.negated)

    def __repr__(self):
        neg = "~" if self.negated else ""
        return f"{neg}{self.pred}({', '.join(map(repr, self.args))})"


@dataclasses.dataclass(frozen=True)
class Comparison:
    """X op Y with op in <, <=, >, >=, =, !=."""

    op: str
    lhs: Term
    rhs: Term

    def vars(self) -> list[Var]:
        return [t for t in (self.lhs, self.rhs) if isinstance(t, Var)]

    def __repr__(self):
        return f"{self.lhs} {self.op} {self.rhs}"


@dataclasses.dataclass(frozen=True)
class Arith:
    """target = lhs op rhs (op in +, -, *) — the interpreted goals of §2."""

    target: Var
    op: str
    lhs: Term
    rhs: Term

    def vars(self) -> list[Var]:
        return [t for t in (self.target, self.lhs, self.rhs) if isinstance(t, Var)]

    def __repr__(self):
        return f"{self.target} = {self.lhs} {self.op} {self.rhs}"


Goal = Union[Literal, Comparison, Arith]


# ---------------------------------------------------------------------------
# Rules / programs
# ---------------------------------------------------------------------------

AGG_KINDS = ("min", "max", "count", "sum", "mcount", "msum")

#: aggregates that are monotone w.r.t. set containment out of the box
MONOTONIC_AGGS = ("mcount", "msum")


@dataclasses.dataclass(frozen=True)
class AggSpec:
    kind: str  # one of AGG_KINDS
    position: int  # head argument position carrying the aggregate value

    def __post_init__(self):
        assert self.kind in AGG_KINDS, self.kind

    def shifted(self, by: int = 1) -> "AggSpec":
        """The same aggregate after ``by`` columns were prepended to the head
        (the value position moves right under qid threading)."""
        return AggSpec(self.kind, self.position + by)


@dataclasses.dataclass(frozen=True)
class Rule:
    head: Literal
    body: tuple[Goal, ...]
    agg: AggSpec | None = None

    def body_literals(self) -> list[Literal]:
        return [g for g in self.body if isinstance(g, Literal)]

    def positive_literals(self) -> list[Literal]:
        return [g for g in self.body_literals() if not g.negated]

    def is_fact(self) -> bool:
        return not self.body

    def head_vars(self) -> list[Var]:
        return self.head.vars()

    def __repr__(self):
        if self.agg is not None:
            args = list(map(repr, self.head.args))
            args[self.agg.position] = f"{self.agg.kind}<{self.head.args[self.agg.position]!r}>"
            head = f"{self.head.pred}({', '.join(args)})"
        else:
            head = repr(self.head)
        if not self.body:
            return f"{head}."
        return f"{head} <- {', '.join(map(repr, self.body))}."


@dataclasses.dataclass
class Program:
    rules: list[Rule]
    #: query goals (``?- tc(1, X).``) — demand patterns for the magic-sets
    #: rewrite (``magic.py``); an empty list means "materialize everything".
    queries: list[Literal] = dataclasses.field(default_factory=list)

    def predicates(self) -> set[str]:
        preds = set()
        for r in self.rules:
            preds.add(r.head.pred)
            for lit in r.body_literals():
                preds.add(lit.pred)
        return preds

    def idb_predicates(self) -> set[str]:
        return {r.head.pred for r in self.rules}

    def edb_predicates(self) -> set[str]:
        return self.predicates() - self.idb_predicates()

    def rules_for(self, pred: str) -> list[Rule]:
        return [r for r in self.rules if r.head.pred == pred]

    def monotone_under_appends(self) -> bool:
        """Is a previously-materialized model a sound warm-start after EDB
        appends?  Negation makes derived facts non-monotone in the appended
        relation, and additive aggregates (count/sum) would double-bill warm
        totals on re-derivation; plain sets and idempotent lattice merges
        (min/max) re-converge to the exact post-append least fixpoint."""
        for r in self.rules:
            if any(l.negated for l in r.body_literals()):
                return False
            if r.agg is not None and r.agg.kind not in ("min", "max"):
                return False
        return True

    def __repr__(self):
        lines = [repr(r) for r in self.rules]
        lines += [f"?- {q!r}." for q in self.queries]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Symbol interning (strings <-> ints for the packed engine)
# ---------------------------------------------------------------------------


class SymbolTable:
    def __init__(self):
        self._by_name: dict[str, int] = {}
        self._by_id: list[str] = []

    def intern(self, name: str) -> int:
        if name not in self._by_name:
            self._by_name[name] = len(self._by_id)
            self._by_id.append(name)
        return self._by_name[name]

    def name(self, idx: int) -> str:
        return self._by_id[idx]

    def __len__(self):
        return len(self._by_id)


def rename_apart(rule: Rule, suffix: str) -> Rule:
    """Uniformly rename a rule's variables (used by the planner)."""

    def ren(t: Term) -> Term:
        return Var(t.name + suffix) if isinstance(t, Var) else t

    def ren_goal(g: Goal) -> Goal:
        if isinstance(g, Literal):
            return Literal(g.pred, tuple(ren(a) for a in g.args), g.negated)
        if isinstance(g, Comparison):
            return Comparison(g.op, ren(g.lhs), ren(g.rhs))
        return Arith(ren(g.target), g.op, ren(g.lhs), ren(g.rhs))

    return Rule(ren_goal(rule.head), tuple(ren_goal(g) for g in rule.body), rule.agg)
