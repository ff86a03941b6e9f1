"""Predicate Connection Graph (PCG), SCCs, and stratification.

Follows the LDL++/BigDatalog compiler pipeline the paper describes: build the
dependency graph between predicates, condense it into strongly connected
components (the recursive cliques), and assign strata.  Negation through a
cycle is rejected (not even the paper's semantics covers it); aggregates
through a cycle are *flagged* — they are legal exactly when PreM (or plain
monotonicity for mcount/msum) certifies them, which is ``prem.py``'s job.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from .ir import MONOTONIC_AGGS, Program, Rule


@dataclasses.dataclass(frozen=True)
class Edge:
    src: str  # body predicate
    dst: str  # head predicate
    negated: bool
    through_agg: bool  # head rule carries an aggregate


@dataclasses.dataclass
class PCG:
    """Predicate connection graph + SCC condensation."""

    edges: list[Edge]
    sccs: list[frozenset[str]]  # topological order (leaves first)
    scc_of: dict[str, int]
    strata: dict[str, int]

    def is_recursive(self, pred: str) -> bool:
        scc = self.sccs[self.scc_of[pred]]
        if len(scc) > 1:
            return True
        return any(e.src == pred and e.dst == pred for e in self.edges)

    def mutual_group(self, pred: str) -> frozenset[str]:
        return self.sccs[self.scc_of[pred]]


class StratificationError(ValueError):
    pass


def build_pcg(program: Program) -> PCG:
    edges: list[Edge] = []
    preds = sorted(program.predicates())
    for rule in program.rules:
        for lit in rule.body_literals():
            edges.append(
                Edge(src=lit.pred, dst=rule.head.pred, negated=lit.negated,
                     through_agg=rule.agg is not None)
            )

    adj: dict[str, list[str]] = defaultdict(list)
    for e in edges:
        adj[e.src].append(e.dst)

    # Tarjan emits consumers-first; reverse so dependencies evaluate first.
    sccs = _tarjan(preds, adj)[::-1]
    scc_of = {p: i for i, scc in enumerate(sccs) for p in scc}

    # reject negation within an SCC (unstratified negation)
    for e in edges:
        if e.negated and scc_of[e.src] == scc_of[e.dst]:
            raise StratificationError(
                f"negation through recursion: ~{e.src} feeds {e.dst} in the same SCC"
            )

    # strata: longest path in the condensation counting negation/aggregate
    # edges as stratum bumps (perfect-model iterated fixpoint order, §2).
    strata = {p: 0 for p in preds}
    changed = True
    iters = 0
    while changed:
        changed = False
        iters += 1
        if iters > len(preds) + len(edges) + 2:
            raise StratificationError("stratum assignment did not converge")
        for e in edges:
            same_scc = scc_of[e.src] == scc_of[e.dst]
            bump = 1 if (e.negated or (e.through_agg and not same_scc)) else 0
            want = strata[e.src] + bump
            if strata[e.dst] < want:
                strata[e.dst] = want
                changed = True

    return PCG(edges=edges, sccs=sccs, scc_of=scc_of, strata=strata)


def recursive_aggregate_rules(program: Program, pcg: PCG) -> list[Rule]:
    """Rules with an aggregate head inside a recursive SCC (need PreM/monotonicity)."""
    out = []
    for rule in program.rules:
        if rule.agg is None:
            continue
        h = rule.head.pred
        if any(
            not lit.negated and pcg.scc_of.get(lit.pred) == pcg.scc_of[h]
            for lit in rule.body_literals()
        ):
            out.append(rule)
    return out


def aggregate_is_monotonic(rule: Rule) -> bool:
    return rule.agg is not None and rule.agg.kind in MONOTONIC_AGGS


def _tarjan(nodes: list[str], adj: dict[str, list[str]]) -> list[frozenset[str]]:
    """Iterative Tarjan SCC; output in reverse topological order (leaves first)."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[frozenset[str]] = []
    counter = [0]

    for root in nodes:
        if root in index:
            continue
        work = [(root, iter(adj.get(root, ())))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(adj.get(w, ()))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
            if low[v] == index[v]:
                comp = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.add(w)
                    if w == v:
                        break
                sccs.append(frozenset(comp))
    return sccs
