"""Port parity of ``DatalogService(mesh=...)``: a service whose frontier
batches run the Fig.-4 plan on a four-shard CPU worker mesh answers exactly
as the JAX service on a one-device mesh and as the port's unsharded service,
dense and CSR, before and after an append; its fixpoints' ``iterations``
are JAX's mesh path's (``explain()["kernels"]``); the census shows one
broadcast per fixpoint and one scalar all-reduce per iteration.  The
additive carrier bypasses the mesh, probes report nothing on the mesh path,
and the admission front-end and durable recovery run through the mesh."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.data import graphs as jgraphs
from repro.service import DatalogService as JService
from repro_torch.core import semiring as tsr
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.service import AsyncDatalogService
from repro_torch.service import DatalogService as TService
from repro_torch.service import batch as tbatch

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
N = 60
SOURCES = [0, 3, 5, 7, 11]  # B = 5, padded to 8
LATER = [3, 13, 21]  # after the append: two cached, one new


@functools.lru_cache(maxsize=None)
def _jmesh():
    return jax.make_mesh((1,), ("data",))


def _db(workload: str, seed: int = 1) -> dict:
    _, _, edb, max_w, dag = WORKLOADS[workload]
    e = jgraphs.gnp_graph(N, 0.05, seed=seed)
    if dag:
        e = e[e[:, 0] < e[:, 1]]
    if max_w:
        e = np.concatenate([e, np.random.default_rng(seed).integers(
            1, max_w + 1, (len(e), 1))], axis=1)
    return {edb: e}


def _append_rows(workload: str) -> np.ndarray:
    """New arcs (src < dst, so the DAGs stay acyclic) into the queried
    sources' reach and to a new vertex inside the allocation."""
    rows = np.array([[0, 40], [40, 59], [13, 62]], np.int64)
    if WORKLOADS[workload][3]:
        rows = np.concatenate([rows, np.array([[2], [1], [4]])], axis=1)
    return rows


def _q(workload, s):
    pred, weighted = WORKLOADS[workload][1], WORKLOADS[workload][3]
    return (pred, (s, None, None) if weighted else (s, None))


def _same(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(
        g.dtype == np.asarray(w).dtype and np.array_equal(g, np.asarray(w))
        for g, w in zip(got, want))


def _services(workload, sparse, **kw):
    program = WORKLOADS[workload][0]
    db = _db(workload)
    kw = dict(default_cap=2048, sparse=sparse, **kw)
    return (JService(program, db=db, mesh=_jmesh(), **kw),
            TService(program, db=db, device="cpu",
                     mesh=make_worker_mesh(4, devices=["cpu"] * 4), **kw),
            TService(program, db=db, device="cpu", **kw))


def _drive(workload, svcs):
    """A batch, an append, the resumed batch; every service's answers."""
    out = []
    for svc in svcs:
        a = svc.ask_batch([_q(workload, s) for s in SOURCES])
        svc.append(WORKLOADS[workload][2], _append_rows(workload))
        b = svc.ask_batch([_q(workload, s) for s in LATER])
        out.append(a + b)
    return out


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
@pytest.mark.parametrize("workload", ["tc", "spath", "lpath"])
def test_mesh_service_matches_jax_and_the_unsharded_service(workload,
                                                            sparse):
    jsvc, msvc, usvc = _services(workload, sparse)
    jans, mans, uans = _drive(workload, (jsvc, msvc, usvc))
    for i, (m, j, u) in enumerate(zip(mans, jans, uans)):
        assert _same(m, j) and _same(m, u), i
    jk, mk = jsvc.explain()["kernels"], msvc.explain()["kernels"]
    assert sorted(mk) == sorted(jk)
    for name in jk:
        for key in ("launches", "iterations", "model_flops", "model_bytes"):
            assert mk[name][key] == jk[name][key], (name, key)
    # Fig. 4 per fixpoint (the append's resume included): one broadcast,
    # one scalar psum per iteration
    census = msvc.mesh.census()
    assert census["broadcast"]["count"] == msvc.stats.dense_fixpoints
    assert census["psum"]["count"] == msvc.stats.fixpoint_iterations
    assert census["all_gather"]["count"] == census["all_to_all"]["count"] == 0
    assert msvc.stats.csr_fixpoints == (msvc.stats.dense_fixpoints
                                        if sparse else 0)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_additive_carrier_bypasses_the_mesh(sparse):
    """``sum<>`` runs the accumulate form on the service's device, as in
    JAX: no collective, the unsharded service's answers."""
    jsvc, msvc, usvc = _services("cpath", sparse)
    jans, mans, uans = _drive("cpath", (jsvc, msvc, usvc))
    for m, j, u in zip(mans, jans, uans):
        assert _same(m, j) and _same(m, u)
    assert all(v["count"] == 0 for v in msvc.mesh.census().values())
    assert msvc.stats.fixpoint_iterations == usvc.stats.fixpoint_iterations


def test_mesh_batch_result_and_probe():
    """The batch entry returns JAX's mesh ``DenseResult`` (``generated`` 0,
    the padded rows) and ``(res, None)`` under ``probe=True``; a probed
    mesh service records no probe, as JAX's does not."""
    mesh = make_worker_mesh(4, devices=["cpu"] * 4)
    arc = torch.from_numpy(np.random.default_rng(2).random((24, 24)) < 0.1)
    res, pr = tbatch.run_frontier_batch(tsr.BOOL, arc, [1, 2, 3], (1, 8),
                                        mesh=mesh, probe=True)
    plain = tbatch.run_frontier_batch(tsr.BOOL, arc, [1, 2, 3], (1, 8))
    assert pr is None and res.generated == 0 and res.table.shape == (8, 24)
    assert torch.equal(res.table[:3], plain.table[:3])
    jsvc, msvc, _ = _services("tc", False, probe=True)
    qs = [_q("tc", s) for s in SOURCES]
    assert all(_same(m, j) for m, j in zip(msvc.ask_batch(qs),
                                           jsvc.ask_batch(qs)))
    assert msvc.last_probes == [] and jsvc.last_probes == []


def test_async_front_end_over_a_mesh_service():
    front = AsyncDatalogService(TC, db=_db("tc"), device="cpu",
                                mesh=make_worker_mesh(2, devices=["cpu"] * 2))
    try:
        usvc = TService(TC, db=_db("tc"), device="cpu")
        futs = [front.submit(_q("tc", s)) for s in SOURCES]
        got = [f.result(timeout=60) for f in futs]
        want = usvc.ask_batch([_q("tc", s) for s in SOURCES])
        assert all(_same(g, w) for g, w in zip(got, want))
        assert front.svc.mesh.census()["psum"]["count"] > 0
    finally:
        front.close()


def test_durable_mesh_service_recovers_through_the_mesh(tmp_path):
    """A crash after a snapshot and one logged append: the recovered mesh
    service replays the log through the mesh (a resumed fixpoint, its
    psums in the census) and answers as a twin that never restarted."""
    db = _db("tc")
    twin = TService(TC, db=db, device="cpu")
    kw = dict(device="cpu", durable_dir=tmp_path)
    svc = TService(TC, db=db, mesh=make_worker_mesh(4, devices=["cpu"] * 4),
                   **kw)
    for s in (twin, svc):
        s.ask_batch([_q("tc", x) for x in SOURCES])
    assert svc.snapshot(wait=True) == 1
    for s in (twin, svc):
        s.append("arc", _append_rows("tc"))
    del svc  # crash: the append is only in the log
    mesh = make_worker_mesh(4, devices=["cpu"] * 4)
    svc2 = TService(TC, db=db, mesh=mesh, **kw)
    rep = svc2.explain()["durability"]["recovery"]
    assert rep["mode"] == "warm" and rep["wal_replayed"] == 1
    assert mesh.census()["broadcast"]["count"] >= 1  # the replay's resume
    qs = [_q("tc", x) for x in SOURCES + LATER]
    assert all(_same(g, w) for g, w in zip(svc2.ask_batch(qs),
                                           twin.ask_batch(qs)))
    svc2.close()


def test_mesh_off_the_service_device_raises():
    with pytest.raises(ValueError, match="first shard"):
        TService(TC, db=_db("tc"), device="cpu",
                 mesh=make_worker_mesh(2, devices=["meta", "meta"]))
