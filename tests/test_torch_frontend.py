"""Port parity of the pure-Python front-end and the graph generators: the
same program text and seeds give the same programs, lowerings, rewrites and
arrays in ``repro`` (the JAX reference) and ``repro_torch`` (the port)."""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.core import ir as jir
from repro.core import magic as jmagic
from repro.core import parser as jparser
from repro.data import graphs as jgraphs
from repro_torch.core import ir as tir
from repro_torch.core import magic as tmagic
from repro_torch.core import parser as tparser
from repro_torch.data import graphs as tgraphs

TC = """
tc(X,Y) <- arc(X,Y).
tc(X,Y) <- tc(X,Z), arc(Z,Y).
"""
SPATH = """
dpath(X,Z,min<D>) <- darc(X,Z,D).
dpath(X,Z,min<D>) <- dpath(X,Y,Dxy), darc(Y,Z,Dyz), D = Dxy + Dyz.
"""
SG = """
sg(X,Y) <- arc(P,X), arc(P,Y), X != Y.
sg(X,Y) <- arc(A,X), sg(A,B), arc(B,Y).
"""
CPATH = """
cpath(X,Z,sum<C>) <- d(X,Z,C).
cpath(X,Z,sum<C>) <- cpath(X,Y,C1), d(Y,Z,C2), C = C1 * C2.
"""
LPATH = """
lpath(X,Z,max<D>) <- d(X,Z,D).
lpath(X,Z,max<D>) <- lpath(X,Y,D1), d(Y,Z,D2), D = D1 + D2.
"""

PROGRAMS = {
    "tc": TC, "spath": SPATH, "sg": SG, "cpath": CPATH, "lpath": LPATH,
    # shapes the frontier lowering must reject
    "tc_nonlinear": "tc(X,Y) <- arc(X,Y).\ntc(X,Y) <- tc(X,Z), tc(Z,Y).",
    "tc_right": "tc(X,Y) <- arc(X,Y).\ntc(X,Y) <- arc(X,Z), tc(Z,Y).",
    "tc_three": TC + "tc(X,Y) <- back(Y,X).",
    "spath_times": SPATH.replace("Dxy + Dyz", "Dxy * Dyz"),
    "spath_mixed": SPATH.replace("min<D>) <- dpath", "max<D>) <- dpath"),
    "neg": "r(X,Y) <- arc(X,Y), ~blocked(Y).\nr(X,Y) <- r(X,Z), arc(Z,Y).",
    "anon": "reach(Y) <- arc(0,Y).\nreach(Y) <- reach(X), arc(X,Y), "
            "arc(_,X).",
    "goal": TC + "?- tc(1, X).",
}

MALFORMED = [
    "tc(X,Y) <- arc(X,Y)",
    "tc(X,Y) <- .",
    "tc(X Y) <- arc(X,Y).",
    "tc(X,Y) <- arc(X,Y)).",
    "p(X,min<D>,min<E>) <- q(X,D,E).",
    "tc(X,Y) :- arc(X,Y).",
    "r(X,Y) <- arc(X,Y), !blocked(Y).",
]

QUERIES = ["tc(1, X)", "tc(X, 1)", "tc(1, 2)", "tc(X, X)", "tc(3, Y)",
           "dpath(0, X, D)", "dpath(0, X, X)", "dpath(X, 0, D)",
           "sg(2, X)", "cpath(0, Z, C)", "lpath(5, Z, D)"]


@pytest.fixture(autouse=True)
def _same_fresh_vars(monkeypatch):
    # anonymous variables draw from a process-wide counter in each package;
    # start both at zero so the parsed programs print alike
    monkeypatch.setattr(jir, "_fresh", itertools.count())
    monkeypatch.setattr(tir, "_fresh", itertools.count())


def _outcome(fn, *args):
    """Result, or the raised error's type name and message."""
    try:
        return fn(*args)
    except Exception as e:  # compared across packages, never swallowed
        return ("raised", type(e).__name__, str(e))


def _fields(low):
    return None if low is None else dataclasses.astuple(low)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_parsed_programs_print_alike(name):
    jp = jparser.parse_program(PROGRAMS[name])
    tp = tparser.parse_program(PROGRAMS[name])
    assert str(tp) == str(jp)
    assert sorted(tp.idb_predicates()) == sorted(jp.idb_predicates())


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_frontier_lowering_agrees(name):
    jp = jparser.parse_program(PROGRAMS[name])
    tp = tparser.parse_program(PROGRAMS[name])
    for pred in sorted(jp.idb_predicates()):
        assert _fields(tmagic.detect_frontier_lowering(tp, pred)) == \
            _fields(jmagic.detect_frontier_lowering(jp, pred)), pred


def test_lowering_kinds_of_the_readme_programs():
    kinds = {}
    for name, pred in (("tc", "tc"), ("spath", "dpath"), ("sg", "sg"),
                       ("cpath", "cpath"), ("lpath", "lpath")):
        low = tmagic.detect_frontier_lowering(
            tparser.parse_program(PROGRAMS[name]), pred)
        kinds[name] = None if low is None else low.kind
    assert kinds == {"tc": "bool", "spath": "minplus", "sg": None,
                     "cpath": "plustimes", "lpath": "maxplus"}


@pytest.mark.parametrize("text", QUERIES)
def test_frontier_query_source_agrees(text):
    jq, tq = jparser.parse_query(text), tparser.parse_query(text)
    assert str(tq) == str(jq)
    assert tmagic.frontier_query_source(tq) == jmagic.frontier_query_source(jq)


@pytest.mark.parametrize("name,query", [
    ("tc", "tc(1, X)"), ("tc", "tc(X, 4)"), ("spath", "dpath(0, X, D)"),
    ("sg", "sg(2, X)"), ("cpath", "cpath(0, Z, C)"),
    ("tc_nonlinear", "tc(1, X)"), ("neg", "r(1, X)")])
def test_magic_rewrite_agrees(name, query):
    def rewrite(parser, magic):
        mr = magic.rewrite(parser.parse_program(PROGRAMS[name]),
                           parser.parse_query(query))
        return str(mr.program), mr.query_pred, str(mr.seed_rule)

    assert _outcome(rewrite, tparser, tmagic) == \
        _outcome(rewrite, jparser, jmagic)


@pytest.mark.parametrize("text", MALFORMED)
def test_malformed_programs_fail_alike(text):
    got = _outcome(lambda t: str(tparser.parse_program(t)), text)
    want = _outcome(lambda t: str(jparser.parse_program(t)), text)
    assert got == want


@pytest.mark.parametrize("gen,args", [
    ("gnp_graph", (300, 0.02, 3)),
    ("gnp_graph", (64, 0.2, 0)),
    ("powerlaw_graph", (400, 3000, 0.8, 1)),
    ("powerlaw_graph", (4096, 20000, 1.5, 7)),
    ("dag_graph", (200, 0.05, 2, 9)),
    ("tree_graph", (4, 5)),
    ("grid_graph", (6,)),
])
def test_graph_generators_give_equal_arrays(gen, args):
    got = getattr(tgraphs, gen)(*args)
    want = getattr(jgraphs, gen)(*args)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_table6_scaled_and_oracles_agree():
    got, want = tgraphs.table6_scaled(), jgraphs.table6_scaled()
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    e = want["G500"]
    assert tgraphs.tc_size_oracle(e) == jgraphs.tc_size_oracle(e)
    w_t = tgraphs.graph_to_weighted(e, seed=4)
    assert np.array_equal(w_t, jgraphs.graph_to_weighted(e, seed=4))
