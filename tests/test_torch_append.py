"""Port parity of EDB appends: ``DatalogService.append`` grows every
carrier (bool, min-plus, max-plus, plus-times; dense and CSR) and resumes
the cached closures as the JAX service does — the same answers, the same
``stats`` counters — through domain growth, a CSR tail fold, a CSR→dense
flip-back, the ``resume_min_hits``/``resume_max_bytes`` eviction policies
and a duplicate counting append (a no-op); and the helpers of
``service/incremental.py`` against the JAX module's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.semiring import BY_NAME as JSR
from repro.data import graphs as jgraphs
from repro.service import DatalogService as JService
from repro.service import incremental as jinc
from repro_torch.core import query as tquery
from repro_torch.core import sparse as tsparse
from repro_torch.core.semiring import BY_NAME as TSR
from repro_torch.service import DatalogService as TService
from repro_torch.service import incremental as tinc

TC = """
tc(X,Y) <- arc(X,Y).
tc(X,Y) <- tc(X,Z), arc(Z,Y).
"""
SPATH = """
dpath(X,Z,min<D>) <- darc(X,Z,D).
dpath(X,Z,min<D>) <- dpath(X,Y,Dxy), darc(Y,Z,Dyz), D = Dxy + Dyz.
"""
LPATH = """
lpath(X,Z,max<D>) <- d(X,Z,D).
lpath(X,Z,max<D>) <- lpath(X,Y,D1), d(Y,Z,D2), D = D1 + D2.
"""
CPATH = """
cpath(X,Z,sum<C>) <- d(X,Z,C).
cpath(X,Z,sum<C>) <- cpath(X,Y,C1), d(Y,Z,C2), C = C1 * C2.
"""

#: (program, pred, EDB name, largest weight (0: unweighted), DAG only)
WORKLOADS = {"tc": (TC, "tc", "arc", 0, False),
             "spath": (SPATH, "dpath", "darc", 9, False),
             "lpath": (LPATH, "lpath", "d", 9, True),
             "cpath": (CPATH, "cpath", "d", 2, True)}

#: the stats fields both services keep
STATS = ("dense_fixpoints", "csr_fixpoints", "batched_queries", "appends",
         "resumed_rows", "dropped_cold")


def _arcs(n, p, seed, max_w, dag, lo=0):
    e = jgraphs.gnp_graph(n, p, seed=seed) + lo
    if dag:
        e = e[e[:, 0] < e[:, 1]]
    if max_w:
        rng = np.random.default_rng(seed)
        e = np.concatenate([e, rng.integers(1, max_w + 1, (len(e), 1))],
                           axis=1)
    return e


def _pair(program, db, **kw):
    kw = dict(default_cap=2048, **kw)  # one dict builds both (rule (c))
    return (JService(program, db=db, **kw),
            TService(program, db=db, device="cpu", **kw))


def _q(pred, max_w, s):
    return (pred, (s, None, None) if max_w else (s, None))


def _same_answers(got, want, what=""):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        for a, b in zip(g, w):
            b = np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), what


def _same_stats(tsvc, jsvc):
    t, j = dataclasses.asdict(tsvc.stats), dataclasses.asdict(jsvc.stats)
    assert {k: t[k] for k in STATS} == {k: j[k] for k in STATS}


def _relation(svc, pred):
    rep = dict(svc.explain()["relations"][pred])
    rep.pop("padding", None)
    return rep


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_append_resumes_like_jax(workload, sparse):
    """Warm a batch, append a few arcs (the CSR's go to its tail), then an
    arc past the allocated domain (a rebuild: cached rows are re-padded):
    the resumed answers, the counters and the carrier reports equal the
    JAX service's after each append, and a fresh service's answers."""
    program, pred, edb, max_w, dag = WORKLOADS[workload]
    db = {edb: _arcs(120, 0.03, 5, max_w, dag)}
    jsvc, tsvc = _pair(program, db, sparse=sparse)
    srcs = [0, 3, 40, 119]
    qs = [_q(pred, max_w, s) for s in srcs]
    _same_answers(tsvc.ask_batch(qs), jsvc.ask_batch(qs))
    small = np.array([[3, 110], [110, 115], [0, 5]], np.int64)
    grow = np.array([[115, 140]], np.int64)  # past n_alloc = 128
    for rows in (small, grow):
        if max_w:
            rows = np.concatenate([rows, np.full((len(rows), 1), 2)], 1)
        jsvc.append(edb, rows)
        tsvc.append(edb, rows)
        assert tsvc.epoch == jsvc.epoch
        _same_stats(tsvc, jsvc)
        assert _relation(tsvc, pred) == _relation(jsvc, pred)
        want = jsvc.ask_batch(qs)
        _same_answers(tsvc.ask_batch(qs), want, f"{workload} after {rows}")
        _same_stats(tsvc, jsvc)
    assert tsvc.stats.resumed_rows == 2 * len(srcs)
    assert tsvc.explain()["relations"][pred]["n_alloc"] == 256
    fresh = TService(program, db=tsvc.db, device="cpu", sparse=sparse)
    _same_answers(tsvc.ask_batch(qs + [_q(pred, max_w, 140)]),
                  fresh.ask_batch(qs + [_q(pred, max_w, 140)]))


@pytest.mark.parametrize("workload", ["tc", "cpath"])
def test_csr_tail_fold_and_flip_back_like_jax(workload):
    """Small appends stay in the COO tail (no flip); one that outgrows
    ``csr_rebuild_frac`` folds it through a full rebuild, which re-runs the
    density heuristic and flips the carrier to dense, as in JAX."""
    program, pred, edb, max_w, dag = WORKLOADS[workload]
    db = {edb: _arcs(128, 0.008, 13, max_w, dag)}
    jsvc, tsvc = _pair(program, db)
    qs = [_q(pred, max_w, s) for s in (0, 7, 33)]
    _same_answers(tsvc.ask_batch(qs), jsvc.ask_batch(qs))
    tail = _arcs(128, 0.0005, 3, max_w, dag)
    densify = _arcs(128, 0.2, 14, max_w, dag)
    for rows, repr_, flips in ((tail, "csr", 0), (densify, "dense", 1)):
        jsvc.append(edb, rows)
        tsvc.append(edb, rows)
        ds = tsvc._dense_state(pred)
        assert ("csr" if ds.is_csr else "dense") == repr_
        assert ds.flips == flips
        assert _relation(tsvc, pred) == _relation(jsvc, pred)
        _same_answers(tsvc.ask_batch(qs), jsvc.ask_batch(qs))
        _same_stats(tsvc, jsvc)
    assert tsvc.explain()["relations"][pred]["last_flip"] == "csr->dense"


def test_tuned_csr_keeps_its_plan_through_tail_and_fold():
    """A tuned min-plus CSR: tail appends keep the plan, a fold rebuilds it
    with the pinned config, and the answers equal the JAX tuned service's."""
    from repro.kernels.autotune import KernelConfig as JK
    from repro_torch.kernels.autotune import KernelConfig as TK
    db = {"darc": _arcs(100, 0.015, 21, 9, False)}
    jsvc = JService(SPATH, db=db, default_cap=2048, sparse=True,
                    tune=JK(use_kernel=True, chunk=16, bn=64))
    tsvc = TService(SPATH, db=db, device="cpu", sparse=True,
                    tune=TK(use_kernel=True, chunk=16, bn=64))
    qs = [_q("dpath", 9, s) for s in (0, 50, 99)]
    _same_answers(tsvc.ask_batch(qs), jsvc.ask_batch(qs))
    for rows in (_arcs(100, 0.001, 1, 9, False),
                 _arcs(100, 0.01, 2, 9, False)):
        jsvc.append("darc", rows)
        tsvc.append("darc", rows)
        jc, tc = jsvc._dense_state("dpath").csr, tsvc._dense_state("dpath").csr
        assert tc.plan_cfg == jc.plan_cfg == (16, 64)
        assert int(tc.tail_nnz) == int(jc.tail_nnz)
        assert np.array_equal(tc.plan_tile.numpy(), np.asarray(jc.plan_tile))
        _same_answers(tsvc.ask_batch(qs), jsvc.ask_batch(qs))
        _same_stats(tsvc, jsvc)
    assert int(tc.tail_nnz) == 0  # the second append folded the tail
    assert tsvc.explain()["kernels"]["tuning"] == \
        jsvc.explain()["kernels"]["tuning"]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_resume_policies_drop_the_cold_tail_like_jax(sparse):
    """``resume_min_hits``: only entries served since their last compute
    resume; ``resume_max_bytes``: hottest first within the budget."""
    edges = _arcs(100, 0.03, 14, 0, False)
    qs = [_q("tc", 0, s) for s in range(6)]
    for kw in ({"resume_max_bytes": 1},
               {"resume_min_hits": 1, "resume_max_bytes": 1 << 30}):
        jsvc, tsvc = _pair(TC, {"arc": edges}, sparse=sparse, **kw)
        _same_answers(tsvc.ask_batch(qs), jsvc.ask_batch(qs))
        for svc in (jsvc, tsvc):
            svc.ask("tc", (2, None))  # source 2 is hot
            svc.ask("tc", (4, None))
            svc.ask("tc", (4, None))
        for svc in (jsvc, tsvc):
            svc.append("arc", [[0, 99], [99, 1]])
        _same_stats(tsvc, jsvc)
        assert len(tsvc.cache) == len(jsvc.cache)
        _same_answers(tsvc.ask_batch(qs), jsvc.ask_batch(qs), kw)
        _same_stats(tsvc, jsvc)
    assert tsvc.stats.resumed_rows == 2 and tsvc.stats.dropped_cold == 4


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_duplicate_counting_append_is_a_noop(sparse):
    """Set semantics: re-appending resident arcs changes no count and runs
    no fixpoint; a mix of old and new arcs counts only the new ones."""
    edges = _arcs(64, 0.06, 3, 2, True)
    jsvc, tsvc = _pair(CPATH, {"d": edges}, sparse=sparse)
    q = [_q("cpath", 2, 0), _q("cpath", 2, 9)]
    before = tsvc.ask_batch(q)
    _same_answers(before, jsvc.ask_batch(q))
    fp0 = tsvc.stats.dense_fixpoints
    for svc in (jsvc, tsvc):
        svc.append("d", np.concatenate([edges[:4], edges[:2]]))
    assert tsvc.stats.dense_fixpoints == fp0
    _same_answers(tsvc.ask_batch(q), before)
    mixed = np.concatenate([edges[:3], [[0, 60, 1], [0, 60, 1], [9, 61, 2]]])
    for svc in (jsvc, tsvc):
        svc.append("d", mixed)
    _same_answers(tsvc.ask_batch(q), jsvc.ask_batch(q))
    _same_stats(tsvc, jsvc)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_wide_counting_rows_filter_through_tuples_like_jax(sparse):
    """At bits=22 a 3-column row does not pack into 63 bits: the additive
    set filter holds tuples, with the same answers and stats as JAX's."""
    edges = _arcs(64, 0.06, 5, 2, True)
    jsvc, tsvc = _pair(CPATH, {"d": edges}, sparse=sparse, bits=22)
    q = [_q("cpath", 2, 0), _q("cpath", 2, 7)]
    _same_answers(tsvc.ask_batch(q), jsvc.ask_batch(q))
    assert tsvc._dense_state("cpath")._arcs.keys is None
    mixed = np.concatenate([edges[:5], [[1, 62, 2], [1, 62, 2], [7, 63, 1]]])
    for _ in range(2):  # the repeat is a no-op
        for svc in (jsvc, tsvc):
            svc.append("d", mixed)
        _same_answers(tsvc.ask_batch(q), jsvc.ask_batch(q))
    _same_stats(tsvc, jsvc)


@pytest.mark.parametrize("bits", [8, 22], ids=["packed", "tuples"])
def test_row_set_filters_like_a_set_of_tuples(bits):
    """``RowSet.new`` / ``add`` and ``new_rows`` against Python sets, on
    rows that pack into one key and rows that do not."""
    rng = np.random.default_rng(bits)
    top = (1 << bits) - 1
    held, rows, more = (rng.integers(0, 4, (k, 3)) * (top // 3)
                        for k in (30, 40, 20))
    want = sorted(set(map(tuple, rows.tolist()))
                  - set(map(tuple, held.tolist())))
    rs = tquery.RowSet(held, bits)
    assert (rs.keys is None) == (bits == 22)
    new = rs.new(rows)
    assert new.tolist() == [list(r) for r in want]
    assert np.array_equal(tquery.new_rows(rows, held, bits), new)
    rs.add(new)
    assert len(rs.new(rows)) == 0 and len(rs.new(rows[:0])) == 0
    seen = set(map(tuple, np.concatenate([held, rows]).tolist()))
    assert rs.new(more).tolist() == sorted(
        map(list, set(map(tuple, more.tolist())) - seen))


def test_csr_counting_append_reads_no_arcs_back(monkeypatch):
    """The service filters an additive CSR append once, against its own
    arc set: it never copies the CSR's arcs back to the host."""
    edges = _arcs(64, 0.06, 3, 2, True)
    jsvc, tsvc = _pair(CPATH, {"d": edges}, sparse=True)
    q = [_q("cpath", 2, 0)]
    _same_answers(tsvc.ask_batch(q), jsvc.ask_batch(q))

    def refuse(self):
        raise AssertionError("the CSR's arcs were read back")
    monkeypatch.setattr(tsparse.CSRMatrix, "edges_numpy", refuse)
    rows = np.concatenate([edges[:3], [[0, 61, 1]]])
    for svc in (jsvc, tsvc):
        svc.append("d", rows)
    assert tsvc._dense_state("cpath").is_csr
    assert int(tsvc._dense_state("cpath").csr.tail_nnz) == 1
    _same_answers(tsvc.ask_batch(q), jsvc.ask_batch(q))
    _same_stats(tsvc, jsvc)


def test_append_to_another_relation_keeps_entries_valid():
    """An append to a relation a cached predicate does not read leaves its
    entries valid at the new epoch (served from the cache)."""
    db = {"arc": _arcs(50, 0.05, 2, 0, False),
          "darc": _arcs(50, 0.05, 3, 9, False)}
    prog = TC + SPATH
    jsvc, tsvc = _pair(prog, db)
    qs = [("tc", (1, None)), ("dpath", (1, None, None))]
    _same_answers(tsvc.ask_batch(qs), jsvc.ask_batch(qs))
    for svc in (jsvc, tsvc):
        svc.append("darc", [[1, 49, 1]])
    hits = tsvc.cache.hits
    _same_answers(tsvc.ask_batch(qs), jsvc.ask_batch(qs))
    assert tsvc.cache.hits == hits + 2
    _same_stats(tsvc, jsvc)


def test_incremental_helpers_match_jax():
    rng = np.random.default_rng(0)
    for rows, arity in (([1, 2], 2), ([], 2), ([[1, 2, 3]], 3)):
        assert np.array_equal(tinc.validate_append(rows, arity, 8),
                              jinc.validate_append(rows, arity, 8))
    for rows, arity in (([[1, 2, 3]], 2), ([[1, 256]], 2), ([[-1, 2]], 2)):
        for inc in (tinc, jinc):
            with pytest.raises(ValueError):
                inc.validate_append(rows, arity, 8)
    n = 40
    prev = np.where(rng.random((3, n)) < 0.3, rng.integers(1, 5, (3, n)),
                    0).astype(np.float32)
    delta = np.array([[1, 5, 2], [0, 7, 1], [9, 5, 3]], np.int64)
    srcs = [0, 1, 9]
    sr_t, sr_j = TSR["plus_times"], JSR["plus_times"]
    got = tinc.replay_init(sr_t, torch.from_numpy(prev), srcs, delta, 48)
    want = jinc.replay_init(sr_j, jnp.asarray(prev), srcs, delta, 48)
    assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="replay_init"):
        tinc.resume_init(sr_t, got, got)
    dist = np.where(rng.random((2, n)) < 0.4, 3.0, np.inf).astype(np.float32)
    seed = np.where(rng.random((2, n)) < 0.4, 1.0, np.inf).astype(np.float32)
    assert np.array_equal(
        tinc.resume_init(TSR["min_plus"], torch.from_numpy(dist),
                         torch.from_numpy(seed)).numpy(),
        np.asarray(jinc.resume_init(JSR["min_plus"], jnp.asarray(dist),
                                    jnp.asarray(seed))))
    assert np.array_equal(
        tinc.pad_rows(torch.from_numpy(dist), 64, float("inf")).numpy(),
        np.asarray(jinc.pad_rows(jnp.asarray(dist), 64, float("inf"))))
