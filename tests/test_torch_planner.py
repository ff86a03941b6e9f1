"""Port parity of the planner: ``repro_torch.core.planner``, ``stratify`` and
``prem`` (copies of the JAX package's, which import no JAX) give the same
plans as ``repro.core``: equal ``repr``s of every group (predicates,
compiled rule pipelines, pivots, RWA costs), the same passes, query
predicate, aliases and residual filters, under full, magic, demand and
qid-batched planning; the same PCG; the same PreM reports; and the same
refusals.  ``PlanError`` is one class, re-exported by ``core.query``."""
import re

import numpy as np
import pytest

from repro.core import parser as jparser, planner as jplanner
from repro.core import prem as jprem, stratify as jstrat
from repro_torch.core import parser as tparser, planner as tplanner
from repro_torch.core import prem as tprem, query as tquery
from repro_torch.core import stratify as tstrat

PROGRAMS = {
    "tc": """
        tc(X,Y) <- arc(X,Y).
        tc(X,Y) <- tc(X,Z), arc(Z,Y).""",
    "tc_nl": """
        tc(X,Y) <- arc(X,Y).
        tc(X,Y) <- tc(X,Z), tc(Z,Y).""",
    "sg": """
        sg(X,Y) <- arc(P,X), arc(P,Y), X != Y.
        sg(X,Y) <- arc(A,X), sg(A,B), arc(B,Y).""",
    "spath": """
        dpath(X,Z,min<D>) <- darc(X,Z,D).
        dpath(X,Z,min<D>) <- dpath(X,Y,Dxy), darc(Y,Z,Dyz), D = Dxy + Dyz.
        spath(X,Z,D) <- dpath(X,Z,D).""",
    "attend": """
        attend(X) <- organizer(X).
        attend(X) <- cntfriends(X,N), N >= 2.
        cntfriends(Y, count<X>) <- attend(X), friend(Y,X).""",
    "kcores": """
        degree(X, count<Y>) <- arc(X,Y).
        validArc(X,Y) <- arc(X,Y), degree(X,D1), D1 >= 3, degree(Y,D2), D2 >= 3.
        connComp(A,A) <- validArc(A,B).
        connComp(C,min<B>) <- connComp(A,B), validArc(A,C).
        kCores(A,B) <- connComp(A,B).""",
    "mutual": """
        even(X,Y) <- e(X,Y).
        even(X,Y) <- odd(X,Z), e(Z,Y).
        odd(X,Y) <- even(X,Z), e(Z,Y).""",
    "negation": """
        reach(X,Y) <- arc(X,Y).
        reach(X,Y) <- reach(X,Z), arc(Z,Y).
        leaf(T) <- node(T), ~src(T).""",
    "cpath": """
        cpath(X,Z,sum<C>) <- d(X,Z,C).
        cpath(X,Z,sum<C>) <- cpath(X,Y,C1), d(Y,Z,C2), C = C1 * C2.""",
    "consts": """
        p(Y) <- X = 1, q(X, Y).
        q(A,B) <- arc(A,B).
        q(A,B) <- q(A,C), arc(C,B).
        r(Y) <- arc(1, Y).""",
}

#: (program, options) cases: full model, a goal with magic, the demand
#: fallback, and a qid batch
CASES = [(name, None) for name in PROGRAMS] + [
    ("tc", ("query", "tc(1, X)", True)),
    ("tc", ("query", "tc(X, 5)", True)),
    ("tc", ("query", "tc(1, X)", False)),
    ("tc", ("batch", ["tc(1, X)", "tc(2, X)"], True)),
    ("sg", ("query", "sg(2, Y)", True)),
    ("sg", ("batch", ["sg(2, Y)", "sg(4, Y)"], True)),
    ("spath", ("query", "dpath(0, X, D)", True)),
    ("spath", ("batch", ["dpath(0, X, D)", "dpath(3, X, D)"], True)),
    ("attend", ("query", "attend(5)", True)),
    ("mutual", ("query", "odd(0, Y)", True)),
    ("consts", ("query", "p(2)", True)),
    ("kcores", ("query", "connComp(2, B)", False)),
]


def _canon(text: str) -> str:
    """Number fresh variables (``_c12``, ``_vv3``, ...) by first appearance:
    each package draws them from its own process-wide counter."""
    names: dict[str, str] = {}
    return re.sub(r"\b(_[A-Za-z]+)(\d+)\b",
                  lambda m: names.setdefault(m.group(0),
                                             f"{m.group(1)}#{len(names)}"),
                  text)


def _plan(mod_parser, mod_planner, name, opts):
    prog = mod_parser.parse_program(PROGRAMS[name])
    if opts is None:
        return mod_planner.plan_program(prog)
    kind, goal, magic = opts
    if kind == "query":
        o = mod_planner.PlanOptions(query=mod_parser.parse_query(goal),
                                    magic=magic)
    else:
        o = mod_planner.PlanOptions(
            batch=tuple(mod_parser.parse_query(g) for g in goal), magic=magic)
    return mod_planner.plan_program(prog, o)


@pytest.mark.parametrize("name,opts", CASES,
                         ids=[f"{n}-{o[0] if o else 'full'}-{i}"
                              for i, (n, o) in enumerate(CASES)])
def test_plan_program_matches_jax(name, opts):
    jp = _plan(jparser, jplanner, name, opts)
    tp = _plan(tparser, tplanner, name, opts)
    assert _canon(repr((tp.groups, tp.rewritten))) == \
        _canon(repr((jp.groups, jp.rewritten)))
    assert tp.passes == jp.passes
    assert tp.query_pred == jp.query_pred
    assert tp.aliases == jp.aliases
    assert tp.residual_filters == jp.residual_filters


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_build_pcg_matches_jax(name):
    jg = jstrat.build_pcg(jparser.parse_program(PROGRAMS[name]))
    tg = tstrat.build_pcg(tparser.parse_program(PROGRAMS[name]))
    assert tg.sccs == jg.sccs
    for p in jparser.parse_program(PROGRAMS[name]).idb_predicates():
        assert tg.is_recursive(p) == jg.is_recursive(p)
        assert tg.mutual_group(p) == jg.mutual_group(p)


@pytest.mark.parametrize("text,pred,group", [
    (PROGRAMS["spath"], "dpath", ["dpath"]),
    ("""lpath(X,Z,max<D>) <- darc(X,Z,D).
        lpath(X,Z,max<D>) <- lpath(X,Y,D1), darc(Y,Z,D2), D = D1 + D2, D < 100.""",
     "lpath", ["lpath"]),
    ("""dpath(X,Z,min<D>) <- darc(X,Z,D).
        dpath(X,Z,min<D>) <- dpath(X,Y,D1), darc(Y,Z,D2), D = D1 + D2, D < 100.""",
     "dpath", ["dpath"]),
    ("""attend(X) <- organizer(X).
        attend(X) <- cnt(X,N), N >= 3.
        cnt(Y, mcount<X>) <- attend(X), friend(Y,X).""",
     "cnt", ["attend", "cnt"]),
])
def test_check_prem_structural_matches_jax(text, pred, group):
    jr = jprem.check_prem_structural(jparser.parse_program(text), pred,
                                     frozenset(group))
    tr = tprem.check_prem_structural(tparser.parse_program(text), pred,
                                     frozenset(group))
    assert (tr.holds, tr.reasons) == (jr.holds, jr.reasons)


def test_check_prem_numeric_matches_jax():
    arcs = [(0, 1, 3), (1, 2, 4), (0, 2, 9), (2, 0, 2)]

    def T(tuples):  # one ICO application of Example 1
        out = set(map(tuple, tuples)) | set(arcs)
        for (x, y, d1) in list(out):
            for (y2, z, d2) in arcs:
                if y == y2:
                    out.add((x, z, d1 + d2))
        return np.asarray(sorted(out))

    def gamma(agg):
        def g(tuples):
            best = {}
            for x, z, d in map(tuple, tuples):
                best[(x, z)] = agg(best[(x, z)], d) if (x, z) in best else d
            return np.asarray(sorted((x, z, d) for (x, z), d in best.items()))
        return g

    interps = [np.asarray([(0, 1, 3), (0, 1, 5)]),
               np.asarray([(1, 2, 1), (2, 0, 7), (0, 0, 4)])]
    eq = lambda a, b: a.shape == b.shape and (a == b).all()  # noqa: E731
    for agg in (min, lambda a, b: a + b):
        jr = jprem.check_prem_numeric(T, gamma(agg), interps, equal=eq)
        tr = tprem.check_prem_numeric(T, gamma(agg), interps, equal=eq)
        assert (tr.holds, tr.reasons) == (jr.holds, jr.reasons)


@pytest.mark.parametrize("text,err", [
    ("""lpath(X,Z,max<D>) <- darc(X,Z,D).
        lpath(X,Z,max<D>) <- lpath(X,Y,D1), darc(Y,Z,D2), D = D1 + D2, D < 100.""",
     "plan"),
    ("""p(X) <- q(X).
        q(X) <- r(X), ~p(X).""", "strat"),
])
def test_refusals_match_jax(text, err):
    for parser, planner, strat in ((jparser, jplanner, jstrat),
                                   (tparser, tplanner, tstrat)):
        exc = planner.PlanError if err == "plan" else strat.StratificationError
        with pytest.raises(exc):
            planner.plan_program(parser.parse_program(text))


def test_plan_error_is_one_class():
    assert tquery.PlanError is tplanner.PlanError
    from repro_torch.core.engine import PlanError
    assert PlanError is tplanner.PlanError
