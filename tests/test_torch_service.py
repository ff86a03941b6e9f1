"""Port parity of the serving layer: ``repro_torch.service.DatalogService``
answers ``ask``/``ask_batch`` exactly as ``repro.service.DatalogService``
does on the bool (TC), min-plus (SPATH), max-plus (LPATH) and plus-times
(CPATH) carriers, dense and CSR, with cache hits and out-of-domain sources;
a cyclic ``sum<>`` EDB raises ``FixpointDivergenceError`` in both; what the
port does not serve yet raises ``NotImplementedError``; the package imports
neither ``jax`` nor ``repro``; and it runs on the CPU only when asked to."""
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import ir as jir
from repro.core.seminaive import FixpointDivergenceError as JDivergence
from repro.core.planner import PlanError as JPlanError
from repro.data import graphs as jgraphs
from repro.service import batch as jbatch
from repro.service import DatalogService as JService
from repro_torch.core import ir as tir
from repro_torch.core.query import PlanError as TPlanError
from repro_torch.core.seminaive import FixpointDivergenceError as TDivergence
from repro_torch.kernels import ops as tops
from repro_torch.service import batch as tbatch
from repro_torch.service import DatalogService as TService

SRC = Path(__file__).resolve().parents[1] / "src"

TC = """
tc(X,Y) <- arc(X,Y).
tc(X,Y) <- tc(X,Z), arc(Z,Y).
"""
SPATH = """
dpath(X,Z,min<D>) <- darc(X,Z,D).
dpath(X,Z,min<D>) <- dpath(X,Y,Dxy), darc(Y,Z,Dyz), D = Dxy + Dyz.
"""
CPATH = """
cpath(X,Z,sum<C>) <- d(X,Z,C).
cpath(X,Z,sum<C>) <- cpath(X,Y,C1), d(Y,Z,C2), C = C1 * C2.
"""
LPATH = """
lpath(X,Z,max<D>) <- d(X,Z,D).
lpath(X,Z,max<D>) <- lpath(X,Y,D1), d(Y,Z,D2), D = D1 + D2.
"""

#: (program, pred, EDB name, largest weight (0: unweighted), DAG only)
WORKLOADS = {"tc": (TC, "tc", "arc", 0, False),
             "spath": (SPATH, "dpath", "darc", 9, False),
             "lpath": (LPATH, "lpath", "d", 9, True),
             "cpath": (CPATH, "cpath", "d", 2, True)}

#: a diamond where longest and shortest routes differ:
#: 0->3 direct (1), 0->1->3 (2+2=4), 0->1->2->3 (2+1+5=8)
DIAMOND = np.array([[0, 3, 1], [0, 1, 2], [1, 3, 2],
                    [1, 2, 1], [2, 3, 5]], np.int64)


def _db(edb, max_w, n, p, seed, dag=False):
    """A Gn-p relation with duplicate rows (EDB relations are sets: both
    packages must collapse them); ``dag`` keeps the arcs with src < dst."""
    e = jgraphs.gnp_graph(n, p, seed=seed)
    if dag:
        e = e[e[:, 0] < e[:, 1]]
    if max_w:
        rng = np.random.default_rng(seed)
        e = np.concatenate([e, rng.integers(1, max_w + 1, (len(e), 1))],
                           axis=1)
    return {edb: np.concatenate([e, e[:7]])}


def _pair(program, db, **kw):
    """Both services from one kwargs dict (ROADMAP rule (c)); the port also
    gets ``device="cpu"``."""
    kw = dict(default_cap=2048, **kw)
    jsvc = JService(program, db=db, **kw)
    tsvc = TService(program, db=db, device="cpu", **kw)
    return jsvc, tsvc


def _assert_same_answer(got, want, what):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert np.array_equal(g, w), what


def _q(pred, weighted, s):
    return (pred, (s, None, None) if weighted else (s, None))


# (graph, sparse option, the carrier the service must pick)
CARRIERS = [((90, 0.05, 1), None, "dense"), ((90, 0.05, 1), True, "csr"),
            ((250, 0.006, 2), None, "csr"), ((250, 0.006, 2), False, "dense")]


@pytest.mark.parametrize("graph,sparse,repr_", CARRIERS)
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_ask_batch_matches_jax(workload, graph, sparse, repr_):
    program, pred, edb, max_w, dag = WORKLOADS[workload]
    weighted = bool(max_w)
    n, p, seed = graph
    db = _db(edb, max_w, n, p, seed, dag)
    jsvc, tsvc = _pair(program, db, sparse=sparse)
    for k in db:
        assert np.array_equal(tsvc.db[k], np.asarray(jsvc.db[k])), k
    # duplicates, a vertex allocated but past the live domain, and one
    # beyond the allocation (inside the 18-bit domain): both reach nothing
    sources = [0, 3, 3, n - 1, 7, n + 2, 5000, 11]
    qs = [_q(pred, weighted, s) for s in sources]
    want, got = jsvc.ask_batch(qs), tsvc.ask_batch(qs)
    for s, g, w in zip(sources, got, want):
        _assert_same_answer(g, w, s)
    assert len(got[-3][0] if weighted else got[-3]) == 0
    # the same batch again: every in-domain answer is a cache hit, the same
    # object (5000 is never cached: it runs no fixpoint)
    hits = tsvc.cache.hits
    again = tsvc.ask_batch(qs)
    for s, a, b in zip(sources, again, got):
        assert (a is b) == (s != 5000), s
        _assert_same_answer(a, b, s)
    assert tsvc.cache.hits - hits == len(sources) - 1
    # singletons: a hit, and a fresh source through its own fixpoint
    for s in (3, 13):
        _assert_same_answer(tsvc.ask(*_q(pred, weighted, s)),
                            jsvc.ask(*_q(pred, weighted, s)), s)
    for field in ("dense_fixpoints", "csr_fixpoints", "batched_queries"):
        assert getattr(tsvc.stats, field) == getattr(jsvc.stats, field), field
    t_rel = tsvc.explain()["relations"][pred]
    j_rel = jsvc.explain()["relations"][pred]
    assert t_rel["repr"] == repr_
    assert t_rel == j_rel


def test_mixed_query_forms_and_edb_selections_match_jax():
    db = _db("arc", 0, 60, 0.06, 4)
    jsvc, tsvc = _pair(TC, db)
    qs = ["tc(1, X)", ("arc", (2, None)), ("arc", (None, 9)), "tc(4, Y)",
          ("tc", (1, None)), "arc(X, X)"]
    for q, g, w in zip(qs, tsvc.ask_batch(qs), jsvc.ask_batch(qs)):
        _assert_same_answer(g, w, q)
    # one fixpoint for the two distinct tc sources, none for the selections
    assert tsvc.stats.dense_fixpoints == 1 and tsvc.stats.batched_queries == 2


@pytest.mark.parametrize("query", [("tc", (99, 99999999)), ("nope", (1, None)),
                                   ("tc", (1, None, None)),
                                   ("arc", (1,))])
def test_query_errors_match_jax(query, monkeypatch):
    # free arguments draw names from a process-wide counter in each
    # package; start both at zero so the messages print alike
    monkeypatch.setattr(jir, "_fresh", itertools.count())
    monkeypatch.setattr(tir, "_fresh", itertools.count())
    db = _db("arc", 0, 40, 0.1, 5)
    jsvc, tsvc = _pair(TC, db)
    with pytest.raises((ValueError, JPlanError)) as jerr:
        jsvc.ask(*query)
    with pytest.raises((ValueError, TPlanError)) as terr:
        tsvc.ask(*query)
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value)


def test_out_of_domain_edb_raises_like_jax():
    db = {"arc": np.array([[0, 1], [1, 1 << 18]])}
    with pytest.raises(ValueError, match="18-bit domain"):
        JService(TC, db=db)
    with pytest.raises(ValueError, match="18-bit domain"):
        TService(TC, db=db, device="cpu")


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_diamond_serves_longest_not_shortest(sparse):
    """The max<> program rides the max-plus carrier, not min-plus: on the
    diamond the longest route to 3 is 8, the shortest 1."""
    jsvc, tsvc = _pair(LPATH, {"d": DIAMOND}, sparse=sparse)
    got = tsvc.ask("lpath", (0, None, None))
    _assert_same_answer(got, jsvc.ask("lpath", (0, None, None)), "diamond")
    rows = {(int(a), int(b), int(v)) for (a, b), v in zip(*got)}
    assert rows == {(0, 1, 2), (0, 2, 3), (0, 3, 8)}
    rel = tsvc.explain()["relations"]["lpath"]
    assert (rel["semiring"], rel["repr"]) == \
        ("max_plus", "csr" if sparse else "dense")


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_duplicate_cpath_rows_count_once(sparse):
    """EDB relations are sets: a duplicated arc is one arc, so the diamond
    still has 3 unit-weight routes 0 -> 3, not 4 or 5."""
    ones = DIAMOND.copy()
    ones[:, 2] = 1
    dup = np.concatenate([ones, ones[:2], ones[:1]])
    jsvc, tsvc = _pair(CPATH, {"d": dup}, sparse=sparse)
    got = tsvc.ask("cpath", (0, None, None))
    _assert_same_answer(got, jsvc.ask("cpath", (0, None, None)), "dup")
    assert {(int(a), int(b), int(v)) for (a, b), v in zip(*got)} == \
        {(0, 1, 1), (0, 2, 1), (0, 3, 3)}
    assert tsvc.explain()["relations"]["cpath"]["semiring"] == "plus_times"


#: a 3-cycle 0 -> 1 -> 2 -> 0 with a spur 2 -> 3
CYCLE = np.array([[0, 1, 1], [1, 2, 2], [2, 0, 1], [2, 3, 4]], np.int64)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_cyclic_cpath_raises_divergence_and_caches_nothing(sparse):
    jsvc, tsvc = _pair(CPATH, {"d": CYCLE}, sparse=sparse)
    with pytest.raises(JDivergence) as jerr:
        jsvc.ask("cpath", (0, None, None))
    with pytest.raises(TDivergence) as terr:
        tsvc.ask_batch([("cpath", (0, None, None)), ("cpath", (1, None, None))])
    assert str(terr.value) == str(jerr.value)
    assert "(130)" in str(terr.value)  # n_alloc + 2
    assert len(tsvc.cache) == 0 and tsvc.stats.dense_fixpoints == 0
    with pytest.raises(TDivergence):  # still nothing cached to serve
        tsvc.ask("cpath", (0, None, None))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_cyclic_lpath_runs_to_the_bound_like_jax(sparse):
    """max<> on a cycle has no finite fixpoint either; both packages run
    the vector form to its 4n + 8 bound and serve the values reached."""
    jsvc, tsvc = _pair(LPATH, {"d": CYCLE}, sparse=sparse)
    qs = [("lpath", (s, None, None)) for s in (0, 3)]
    for g, w in zip(tsvc.ask_batch(qs), jsvc.ask_batch(qs)):
        _assert_same_answer(g, w, "cyclic lpath")
    assert tsvc.stats.fixpoint_iterations == 4 * 128 + 8
    # the batch under the answers: the same table and iteration count
    jds, tds = jsvc._dense_state("lpath"), tsvc._dense_state("lpath")
    if sparse:
        want = jbatch.run_frontier_batch_csr(jds.csr, [0, 1], (1, 8))
        got = tbatch.run_frontier_batch_csr(tds.csr, [0, 1], (1, 8))
    else:
        want = jbatch.run_frontier_batch(jds.sr, jds.matrix, [0, 1], (1, 8))
        got = tbatch.run_frontier_batch(tds.sr, tds.matrix, [0, 1], (1, 8))
    assert np.array_equal(got.table.numpy(), np.asarray(want.table))
    assert got.iterations == int(want.iterations) == 4 * 128 + 8


@pytest.mark.parametrize("query", ["tc(X, 5)", "tc(1, 2)", "tc(X, Y)"])
def test_tuple_path_queries_match_jax(query):
    """The queries that lower to no frontier (second argument bound, both
    bound, all free) go through the tuple engine: the same answer (rows and
    dtype) and the same counters as the JAX service, cold and from the
    cache."""
    jsvc, tsvc = _pair(TC, _db("arc", 0, 30, 0.1, 6))
    for _ in range(2):
        want, got = jsvc.ask_batch([query])[0], tsvc.ask_batch([query])[0]
        assert got.dtype == want.dtype and np.array_equal(got, want)
    jrep, trep = jsvc.explain(), tsvc.explain()
    trep["service"].pop("fixpoint_iterations")
    assert trep["service"] == jrep["service"]
    assert trep["cache"] == jrep["cache"]
    assert trep["templates"] == jrep["templates"]


@pytest.mark.parametrize("kw,item", [({"mesh": object()}, "A.6"),
                                     ({"probe": True}, "A.6"),
                                     ({"tracer": True}, "A.6"),
                                     ({"durable_dir": "x"}, "A.6")])
def test_unported_options_raise_not_implemented(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        TService(TC, db={"arc": np.array([[0, 1]])}, device="cpu", **kw)


def test_append_and_bad_matmul_raise():
    """Appends to a relation that is not in the EDB, and rows of the wrong
    arity or outside the packed domain, raise as in the JAX service; so
    does an unknown ``matmul``."""
    kw = dict(default_cap=2048, matmul="pallas")
    tsvc = TService(TC, db={"arc": np.array([[0, 1]])}, device="cpu", **kw)
    jsvc = JService(TC, db={"arc": np.array([[0, 1]])}, **kw)
    for rel, rows in (("tc", [[1, 2]]), ("arc", [[1, 2, 3]]),
                      ("arc", [[1, 1 << 18]])):
        with pytest.raises(ValueError):
            jsvc.append(rel, np.array(rows))
        with pytest.raises(ValueError):
            tsvc.append(rel, np.array(rows))
    with pytest.raises(ValueError, match="matmul"):
        TService(TC, db={"arc": np.array([[0, 1]])}, device="cpu",
                 matmul="xla")


def test_cpu_serving_counts_no_kernel_launch():
    tops.reset_launch_counts()
    for sparse in (True, False):
        TService(TC, db={"arc": np.array([[0, 1], [1, 2]])}, device="cpu",
                 sparse=sparse).ask("tc", (0, None))
    assert set(tops.launch_counts().values()) == {0}


def test_default_device_is_the_card(monkeypatch):
    """With no ``device=``, the service runs on CUDA; a host without a GPU
    raises instead of quietly running on the CPU."""
    if torch.cuda.is_available():  # make the GPU-less case on any host
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no usable GPU"):
        TService(TC, db={"arc": np.array([[0, 1]])})
    from repro_torch.core import sparse as tsp
    with pytest.raises(RuntimeError, match="no usable GPU"):
        tsp.build_csr(np.array([[0, 1]]), 8)


def test_package_imports_neither_jax_nor_repro():
    """Every module of ``repro_torch`` imports in a fresh interpreter with
    no ``jax`` and no module of the JAX package loaded."""
    code = (
        "import pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert len(mods) > 15, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 15
