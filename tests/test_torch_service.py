"""Port parity of the serving layer: ``repro_torch.service.DatalogService``
answers ``ask``/``ask_batch`` exactly as ``repro.service.DatalogService``
does on the bool (TC) and min-plus (SPATH) carriers, dense and CSR, with
cache hits and out-of-domain sources; what the port does not serve yet
raises ``NotImplementedError``; the package imports neither ``jax`` nor
``repro``; and it runs on the CPU only when asked to."""
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import ir as jir
from repro.core.planner import PlanError as JPlanError
from repro.data import graphs as jgraphs
from repro.service import DatalogService as JService
from repro_torch.core import ir as tir
from repro_torch.core.query import PlanError as TPlanError
from repro_torch.kernels import ops as tops
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

#: (program, pred, EDB name, weighted)
WORKLOADS = {"tc": (TC, "tc", "arc", False),
             "spath": (SPATH, "dpath", "darc", True)}


def _db(edb, weighted, n, p, seed):
    """A Gn-p relation with duplicate rows (EDB relations are sets: both
    packages must collapse them)."""
    e = jgraphs.gnp_graph(n, p, seed=seed)
    if weighted:
        rng = np.random.default_rng(seed)
        e = np.concatenate([e, rng.integers(1, 10, (len(e), 1))], axis=1)
    return {edb: np.concatenate([e, e[:7]])}


def _pair(program, db, **kw):
    jsvc = JService(program, db=db, default_cap=2048, **kw)
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
    program, pred, edb, weighted = WORKLOADS[workload]
    n, p, seed = graph
    db = _db(edb, weighted, n, p, seed)
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
    db = _db("arc", False, 60, 0.06, 4)
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
    db = _db("arc", False, 40, 0.1, 5)
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


@pytest.mark.parametrize("program,pred,edb", [(CPATH, "cpath", "d"),
                                              (LPATH, "lpath", "d")])
def test_max_and_sum_carriers_raise_not_implemented(program, pred, edb):
    db = {edb: np.array([[0, 1, 2], [1, 2, 3]])}
    tsvc = TService(program, db=db, device="cpu")
    with pytest.raises(NotImplementedError, match="A.1"):
        tsvc.ask_batch([(pred, (0, None, None))])
    with pytest.raises(NotImplementedError, match="A.1"):
        tsvc.ask(pred, (1, None, None))
    # the unported carrier ran nothing, and nothing was cached
    assert tsvc.stats.dense_fixpoints == 0 and len(tsvc.cache) == 0


@pytest.mark.parametrize("query", ["tc(X, 5)", "tc(1, 2)", "tc(X, Y)"])
def test_tuple_path_queries_raise_not_implemented(query):
    tsvc = TService(TC, db=_db("arc", False, 30, 0.1, 6), device="cpu")
    with pytest.raises(NotImplementedError, match="A.6"):
        tsvc.ask_batch([query])


@pytest.mark.parametrize("kw,item", [({"mesh": object()}, "A.6"),
                                     ({"probe": True}, "A.6"),
                                     ({"tracer": True}, "A.6"),
                                     ({"durable_dir": "x"}, "A.6"),
                                     ({"tune": True}, "A.3")])
def test_unported_options_raise_not_implemented(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        TService(TC, db={"arc": np.array([[0, 1]])}, device="cpu", **kw)


def test_append_and_bad_matmul_raise():
    tsvc = TService(TC, db={"arc": np.array([[0, 1]])}, device="cpu",
                    matmul="pallas")
    with pytest.raises(NotImplementedError, match="A.2"):
        tsvc.append("arc", np.array([[1, 2]]))
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
