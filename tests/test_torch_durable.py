"""Durable serving state on the port (``repro_torch.service.durable``):
WAL framing, snapshot round trips, the recovery degradation ladder under
every fault of ``_faults.py``, and recovery across the two packages.

Each test of ``tests/test_durable.py`` has its port here, on
``device="cpu"``.  The oracles are a port twin that never restarted and a
JAX twin that never restarted: recovery is correct iff the restarted
service's answers are bit-identical to both (dtype and order included) and
its epoch matches.  A durable directory written by either package must
recover in the other.  Generations are counted only after the publisher
has been waited on (``snapshot(wait=True)`` / ``_durable.wait()``), never
after a sleep.
"""
import functools
import threading

import numpy as np
import pytest
from _faults import (bit_flip_shard, garble_wal_tail, kill_mid_save,
                     stale_manifest, step_dirs, truncate_wal)

from repro.service import DatalogService as JService
from repro_torch.checkpoint import store as tstore
from repro_torch.checkpoint.store import (CheckpointCorrupt,
                                          CheckpointWriteError,
                                          complete_steps, load_checkpoint,
                                          load_checkpoint_raw,
                                          save_checkpoint)
from repro_torch.service import AsyncDatalogService
from repro_torch.service import DatalogService as TService
from repro_torch.service.durable import (WalCorrupt, WriteAheadLog,
                                         snapshot_state)

TC = "tc(X,Y) <- e(X,Y).\ntc(X,Y) <- tc(X,Z), e(Z,Y)."
MINPLUS = ("dp(X,Z,min<D>) <- w(X,Z,D).\n"
           "dp(X,Z,min<D>) <- dp(X,Y,D1), w(Y,Z,D2), D = D1 + D2.")
CAPS = dict(default_cap=4096)


def _port(program, db, **kw):
    return TService(program, db, device="cpu", **{**CAPS, **kw})


def _jax(program, db, **kw):
    return JService(program, db, **{**CAPS, **kw})


def _edges(n=50, m=120, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, size=(m, 2)).astype(np.int64)


def _weighted(seed=5, n=30, m=80):
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.integers(0, n, m), rng.integers(0, n, m),
                            rng.integers(1, 9, m)]).astype(np.int64)


def _assert_identical(a, b, ctx=""):
    assert isinstance(a, tuple) == isinstance(b, tuple), ctx
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), ctx


def _assert_all(got, *refs, ctx=""):
    for ref in refs:
        assert len(got) == len(ref), ctx
        for g, r in zip(got, ref):
            _assert_identical(g, r, ctx)


# -- WAL framing -------------------------------------------------------------


def test_wal_roundtrip_and_reopen(tmp_path):
    wal = WriteAheadLog(tmp_path / "wal.log")
    rows1 = np.array([[1, 2], [3, 4]], np.int64)
    rows2 = np.array([[5, 6, 7]], np.int64)
    assert wal.append("e", rows1, 1) == 0
    assert wal.append("w", rows2, 2) == 1
    wal.close()
    wal2 = WriteAheadLog(tmp_path / "wal.log")
    assert wal2.records == 2 and wal2.torn_bytes == 0
    got = list(wal2.replay())
    assert got[0][0] == "e" and np.array_equal(got[0][1], rows1)
    assert got[1][0] == "w" and np.array_equal(got[1][1], rows2)
    assert got[1][2] == 2
    wal2.close()


def test_wal_torn_tail_truncates(tmp_path):
    wal = WriteAheadLog(tmp_path / "wal.log")
    for i in range(4):
        wal.append("e", np.array([[i, i + 1]], np.int64), i + 1)
    wal.close()
    torn = truncate_wal(tmp_path / "wal.log", nbytes=5)
    wal2 = WriteAheadLog(tmp_path / "wal.log")
    assert wal2.records == 3  # the torn 4th record is gone, prefix intact
    assert wal2.torn_bytes > 0
    assert [r[2] for r in wal2.replay()] == [1, 2, 3]
    # appends after the repair extend the repaired log cleanly
    wal2.append("e", np.array([[9, 9]], np.int64), 4)
    assert [r[2] for r in wal2.replay()] == [1, 2, 3, 4]
    wal2.close()
    assert torn > 0


def test_wal_garbled_tail_truncates(tmp_path):
    wal = WriteAheadLog(tmp_path / "wal.log")
    for i in range(3):
        wal.append("e", np.array([[i, i + 1]], np.int64), i + 1)
    wal.close()
    garble_wal_tail(tmp_path / "wal.log")  # same size, bad CRC
    wal2 = WriteAheadLog(tmp_path / "wal.log")
    assert wal2.records == 2 and wal2.torn_bytes > 0
    wal2.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_frames_are_the_jax_frames(tmp_path, writer):
    """The same records written by either package give the same bytes, and
    each package replays the other's log; a bad magic raises."""
    from repro.service.durable import WriteAheadLog as JWal
    records = [("e", np.array([[1, 2], [3, 4]], np.int64), 1),
               ("w", np.array([[5, 6, 7]], np.int64), 2)]
    paths = {}
    for name, cls in (("jax", JWal), ("port", WriteAheadLog)):
        wal = cls(tmp_path / f"{name}.log", fsync=False)
        for rel, rows, epoch in records:
            wal.append(rel, rows, epoch)
        wal.close()
        paths[name] = tmp_path / f"{name}.log"
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    reader = WriteAheadLog if writer == "jax" else JWal
    wal = reader(paths[writer])
    got = list(wal.replay())
    wal.close()
    assert [(r, e) for r, _, e in got] == [(r, e) for r, _, e in records]
    for (_, rows, _), (_, want, _) in zip(got, records):
        assert rows.dtype == np.int64 and np.array_equal(rows, want)
    bad = tmp_path / "bad.log"
    bad.write_bytes(b"NOTAWAL!" + paths[writer].read_bytes()[8:])
    with pytest.raises(WalCorrupt):
        WriteAheadLog(bad)


# -- restart correctness -----------------------------------------------------


def test_warm_restart_bit_identical(tmp_path):
    e = _edges()
    queries = [("tc", (3, None)), ("tc", (None, 7)), ("tc", (5, 9))]
    twin = _port(TC, {"e": e.copy()})
    jtwin = _jax(TC, {"e": e.copy()})
    svc = _port(TC, {"e": e.copy()}, durable_dir=tmp_path)
    for s in (twin, jtwin, svc):
        s.ask_batch(list(queries))
        s.append("e", np.array([[3, 49], [49, 17]], np.int64))
    assert svc.snapshot(wait=True) == 1
    for s in (twin, jtwin, svc):
        s.append("e", np.array([[17, 23]], np.int64))
    twin_res = twin.ask_batch(list(queries))
    jax_res = jtwin.ask_batch(list(queries))
    del svc  # crash: no close(), no final snapshot; the WAL has the suffix

    svc2 = _port(TC, {"e": e.copy()}, durable_dir=tmp_path)
    rep = svc2.explain()["durability"]["recovery"]
    assert rep["mode"] == "warm" and rep["wal_replayed"] == 1
    assert svc2.epoch == twin.epoch == jtwin.epoch
    _assert_all(svc2.ask_batch(list(queries)), twin_res, jax_res,
                ctx="warm restart answer drifted")
    svc2.close()


def test_duplicate_wal_replay_is_noop(tmp_path):
    e = _edges(seed=3)
    dup = np.array([[1, 2], [2, 3]], np.int64)
    twin = _port(TC, {"e": e.copy()})
    jtwin = _jax(TC, {"e": e.copy()})
    svc = _port(TC, {"e": e.copy()}, durable_dir=tmp_path)
    for s in (twin, jtwin, svc):
        s.ask("tc", (1, None))
        s.append("e", dup)
        s.append("e", dup)  # exact duplicate: set semantics absorb it
    refs = (twin.ask("tc", (1, None)), jtwin.ask("tc", (1, None)))
    del svc  # crash with BOTH records in the WAL and no snapshot at all

    svc2 = _port(TC, {"e": e.copy()}, durable_dir=tmp_path)
    rep = svc2.explain()["durability"]["recovery"]
    assert rep["mode"] == "cold" and rep["wal_replayed"] == 2
    _assert_all([svc2.ask("tc", (1, None))], *[[r] for r in refs],
                ctx="duplicate replay")
    assert svc2.epoch == twin.epoch == jtwin.epoch
    svc2.close()


def test_minplus_csr_restart(tmp_path):
    w = _weighted()
    twin = _port(MINPLUS, {"w": w.copy()}, sparse=True)
    jtwin = _jax(MINPLUS, {"w": w.copy()}, sparse=True)
    svc = _port(MINPLUS, {"w": w.copy()}, sparse=True, durable_dir=tmp_path)
    for s in (twin, jtwin, svc):
        s.ask("dp", (2, None, None))
        s.append("w", np.array([[2, 29, 1]], np.int64))
    svc.snapshot(wait=True)
    refs = (twin.ask("dp", (2, None, None)), jtwin.ask("dp", (2, None, None)))
    del svc
    svc2 = _port(MINPLUS, {"w": w.copy()}, sparse=True, durable_dir=tmp_path)
    rep = svc2.explain()
    assert rep["durability"]["recovery"]["mode"] == "warm"
    assert rep["relations"]["dp"]["repr"] == "csr"
    _assert_all([svc2.ask("dp", (2, None, None))], *[[r] for r in refs],
                ctx="min-plus CSR")
    svc2.close()


# -- the degradation ladder under injected faults ----------------------------

TWO_GEN_QUERIES = [("tc", (3, None)), ("tc", (1, None))]
TWO_GEN_APPENDS = [np.array([[3, 44]], np.int64),
                   np.array([[44, 21]], np.int64),
                   np.array([[21, 8]], np.int64)]


def _two_generations(tmp_path, e):
    """A durable port service with two published snapshot generations and
    one WAL record after the newest, and its never-restarted port twin."""
    twin = _port(TC, {"e": e.copy()})
    svc = _port(TC, {"e": e.copy()}, durable_dir=tmp_path)
    for s in (twin, svc):
        s.ask_batch(list(TWO_GEN_QUERIES))
        s.append("e", TWO_GEN_APPENDS[0])
    svc.snapshot(wait=True)  # generation 1
    for s in (twin, svc):
        s.append("e", TWO_GEN_APPENDS[1])
        s.ask_batch(list(TWO_GEN_QUERIES))
    svc.snapshot(wait=True)  # generation 2
    for s in (twin, svc):
        s.append("e", TWO_GEN_APPENDS[2])
    return svc, twin


@functools.lru_cache(maxsize=None)
def _jax_two_generations(seed: int, n_appends: int):
    """JAX's answers and epoch after the first ``n_appends`` appends of the
    two-generation stream (queries interleaved as in
    :func:`_two_generations`), from a JAX service that never restarted."""
    e = _edges(seed=seed)
    jsvc = _jax(TC, {"e": e.copy()})
    jsvc.ask_batch(list(TWO_GEN_QUERIES))
    for k, rows in enumerate(TWO_GEN_APPENDS[:n_appends]):
        jsvc.append("e", rows)
        if k == 1:
            jsvc.ask_batch(list(TWO_GEN_QUERIES))
    return jsvc.ask_batch(list(TWO_GEN_QUERIES)), jsvc.epoch


@pytest.mark.parametrize("fault", ["kill_mid_save", "bit_flip", "stale",
                                   "torn_wal", "all_corrupt"])
def test_fault_recovery_bit_identical(tmp_path, fault):
    e = _edges(seed=11)
    svc, twin = _two_generations(tmp_path, e)
    twin_res = twin.ask_batch(list(TWO_GEN_QUERIES))
    del svc  # crash

    snap = tmp_path / "snapshots"
    want_mode = {"kill_mid_save": "warm", "bit_flip": "degraded",
                 "stale": "degraded", "torn_wal": "warm",
                 "all_corrupt": "cold"}[fault]
    if fault == "kill_mid_save":
        kill_mid_save(snap)  # the .tmp turd must stay invisible
    elif fault == "bit_flip":
        bit_flip_shard(snap)  # the newest generation silently corrupt
    elif fault == "stale":
        stale_manifest(snap)  # the newest manifest names a gone shard
    elif fault == "torn_wal":
        truncate_wal(tmp_path / "wal.log", nbytes=6)
    elif fault == "all_corrupt":
        for step in complete_steps(snap):
            bit_flip_shard(snap, step=step)

    svc2 = _port(TC, {"e": e.copy()}, durable_dir=tmp_path)
    rep = svc2.explain()["durability"]["recovery"]
    assert rep["mode"] == want_mode, rep
    if fault == "torn_wal":
        # the torn record IS the last append: the twins lose it too
        assert rep["torn_bytes"] > 0
        twin2 = _port(TC, {"e": e.copy()})
        for rows in TWO_GEN_APPENDS[:2]:
            twin2.append("e", rows)
        twin_res = twin2.ask_batch(list(TWO_GEN_QUERIES))
        jax_res, jax_epoch = _jax_two_generations(11, 2)
        assert svc2.epoch == twin2.epoch == jax_epoch
    else:
        jax_res, jax_epoch = _jax_two_generations(11, 3)
        assert svc2.epoch == twin.epoch == jax_epoch
    _assert_all(svc2.ask_batch(list(TWO_GEN_QUERIES)), twin_res, jax_res,
                ctx=f"fault={fault}")
    if fault in ("bit_flip", "stale"):
        assert rep["fallbacks"] >= 1
    svc2.close()


@pytest.mark.parametrize("order", ["prune_first", "publish_first"])
def test_snapshot_pruning_keeps_k_generations(tmp_path, monkeypatch, order):
    """``keep_snapshots=2`` keeps two generations whichever comes first,
    the writer's publish of the new step or the prune after handing it
    over; each order is forced (the writer held back until ``snapshot()``
    returns, or ``save`` returning only once it has published)."""
    gate = threading.Event()
    if order == "prune_first":
        real = tstore.save_checkpoint

        def held(*a, **k):
            gate.wait(timeout=60)
            return real(*a, **k)

        monkeypatch.setattr(tstore, "save_checkpoint", held)
    else:
        real_save = tstore.AsyncCheckpointer.save

        def published(self, *a, **k):
            real_save(self, *a, **k)
            self._q.join()

        monkeypatch.setattr(tstore.AsyncCheckpointer, "save", published)
    e = _edges(seed=7)
    svc = _port(TC, {"e": e.copy()}, durable_dir=tmp_path, keep_snapshots=2)
    svc.ask("tc", (1, None))
    for i in range(5):
        svc.append("e", np.array([[i, i + 40]], np.int64))
        assert svc.snapshot() == i + 1
        gate.set()
        svc._durable.wait()
        gate.clear()
    snap = tmp_path / "snapshots"
    assert complete_steps(snap) == [5, 4]
    assert len(step_dirs(snap)) == 2
    svc.close()


def test_auto_snapshot_cadence(tmp_path, monkeypatch):
    """5 appends at every 2 hand two snapshots to the writer; the second is
    numbered past the first although the first is still being written (the
    writer is held back until both are handed over)."""
    gate = threading.Event()
    real = tstore.save_checkpoint

    def held(*a, **k):
        gate.wait(timeout=60)
        return real(*a, **k)

    monkeypatch.setattr(tstore, "save_checkpoint", held)
    e = _edges(seed=9)
    svc = _port(TC, {"e": e.copy()}, durable_dir=tmp_path, snapshot_every=2)
    svc.ask("tc", (1, None))
    for i in range(5):
        svc.append("e", np.array([[i, i + 40]], np.int64))
    assert svc.explain()["durability"]["snapshots"]["written"] == 2
    assert complete_steps(tmp_path / "snapshots") == []
    gate.set()
    svc._durable.wait()
    assert complete_steps(tmp_path / "snapshots") == [2, 1]
    svc.close()


def test_async_front_end_durable(tmp_path):
    e = _edges(seed=13)
    twin = _port(TC, {"e": e.copy()})
    jtwin = _jax(TC, {"e": e.copy()})
    front = AsyncDatalogService(
        _port(TC, {"e": e.copy()}, durable_dir=tmp_path))
    for s in (twin, jtwin, front):
        s.ask("tc(3, X)") if s is front else s.ask("tc", (3, None))
        s.append("e", np.array([[3, 42]], np.int64))
    assert front.snapshot(wait=True) == 1
    refs = (twin.ask("tc", (3, None)), jtwin.ask("tc", (3, None)))
    front.close()
    front.svc.close()
    svc2 = _port(TC, {"e": e.copy()}, durable_dir=tmp_path)
    assert svc2.explain()["durability"]["recovery"]["mode"] == "warm"
    _assert_all([svc2.ask("tc", (3, None))], *[[r] for r in refs],
                ctx="async durable")
    svc2.close()


def test_snapshot_without_durable_dir_raises():
    svc = _port(TC, {"e": _edges()})
    with pytest.raises(RuntimeError, match="durable_dir"):
        svc.snapshot()
    svc.close()  # a no-op without durable_dir


# -- observability -----------------------------------------------------------


def test_recovery_metrics_and_explain(tmp_path):
    e = _edges(seed=17)
    svc = _port(TC, {"e": e.copy()}, durable_dir=tmp_path)
    svc.ask("tc", (1, None))
    svc.append("e", np.array([[1, 44]], np.int64))
    svc.snapshot(wait=True)
    del svc
    svc2 = _port(TC, {"e": e.copy()}, durable_dir=tmp_path, tracer=True)
    rep = svc2.explain()["durability"]
    assert rep["recovery"]["mode"] == "warm"
    assert rep["wal"]["records"] >= 1
    assert rep["snapshots"]["steps"] == [1]
    text = svc2.metrics.to_prometheus()
    for name in ("datalog_recovery_total", "datalog_wal_records_total",
                 "datalog_snapshots_total",
                 "datalog_recovery_wal_replayed_total",
                 "datalog_recovery_fallbacks_total",
                 "datalog_recovery_seconds", "datalog_wal_bytes",
                 "datalog_snapshot_errors_total"):
        assert name in text, name
    assert 'mode="warm"' in text
    # spans: recover at construction, wal_append + snapshot afterwards
    svc2.append("e", np.array([[44, 2]], np.int64))
    svc2.snapshot(wait=True)
    evs = svc2.tracer.events()
    assert {"recover", "wal_append", "snapshot"} <= {s["name"] for s in evs}
    assert {s["cat"] for s in evs if s["name"] in
            ("recover", "wal_append", "snapshot")} == {"durable"}
    svc2.close()


# -- checkpoint store satellites ---------------------------------------------


def test_load_checkpoint_falls_back_past_corruption(tmp_path):
    tree1 = {"a": np.arange(6, dtype=np.float32)}
    tree2 = {"a": np.arange(6, dtype=np.float32) * 2}
    save_checkpoint(tmp_path, 1, tree1, n_shards=1)
    save_checkpoint(tmp_path, 2, tree2, n_shards=1)
    bit_flip_shard(tmp_path, step=2)
    restored, step = load_checkpoint(
        tmp_path, {"a": np.zeros(6, np.float32)})
    assert step == 1 and np.array_equal(np.asarray(restored["a"]), tree1["a"])
    # a missing shard (stale manifest) falls back identically
    save_checkpoint(tmp_path, 3, tree2, n_shards=1)
    stale_manifest(tmp_path, step=3)
    _, step = load_checkpoint(tmp_path, {"a": np.zeros(6, np.float32)})
    assert step == 1
    # every generation corrupt -> CheckpointCorrupt (not FileNotFoundError)
    bit_flip_shard(tmp_path, step=1)
    with pytest.raises(CheckpointCorrupt):
        load_checkpoint(tmp_path, {"a": np.zeros(6, np.float32)})


def test_async_checkpointer_error_raises_once_then_recovers(tmp_path):
    ckpt = tstore.AsyncCheckpointer(tmp_path / "not" / "a" / "dir" / "f.txt")
    # force a failure: the ckpt_dir path collides with a file
    (tmp_path / "not").mkdir()
    (tmp_path / "not" / "a").write_text("in the way")
    ckpt.save(1, {"x": np.zeros(3)})
    with pytest.raises(CheckpointWriteError):
        ckpt.wait()
    # the latch cleared: the writer keeps working once the path is usable
    (tmp_path / "not" / "a").unlink()
    ckpt.save(2, {"x": np.zeros(3)})
    ckpt.wait()  # does NOT re-raise the old error
    ckpt.close()


# -- a snapshot is a copy ----------------------------------------------------


def test_queued_snapshot_does_not_tear(tmp_path, monkeypatch):
    """The writer is held back, an append (which updates the dense carrier
    and the cache in place on the CPU) follows at once: the published
    generation still holds the state before the append, and a service
    recovered from it alone answers as the twin did before the append."""
    gate = threading.Event()
    real = tstore.save_checkpoint

    def held(*a, **k):
        gate.wait(timeout=60)
        return real(*a, **k)

    monkeypatch.setattr(tstore, "save_checkpoint", held)
    e = _edges(seed=21)
    queries = [("tc", (s, None)) for s in (0, 3, 5)]
    twin = _port(TC, {"e": e.copy()}, sparse=False)
    svc = _port(TC, {"e": e.copy()}, sparse=False, durable_dir=tmp_path)
    for s in (twin, svc):
        s.ask_batch(list(queries))
    want = snapshot_state(twin, svc._durable.wal.records)  # never appended
    matrix = svc._dense_state("tc").matrix
    assert svc.snapshot() == 1  # queued; the writer waits on the gate
    svc.append("e", np.array([[0, 49], [49, 48], [3, 47]], np.int64))
    assert svc._dense_state("tc").matrix is matrix  # updated in place
    gate.set()
    svc._durable.wait()
    flat, step = load_checkpoint_raw(tmp_path / "snapshots")
    assert step == 1 and sorted(flat) == sorted(want)
    for k in want:
        assert flat[k].dtype == want[k].dtype, k
        assert np.array_equal(flat[k], want[k]), k
    # recover from the generation alone (the WAL's suffix left out): cached
    # and new sources answer as the twin, which never saw the append
    (tmp_path / "wal.log").unlink()
    svc2 = _port(TC, {"e": e.copy()}, sparse=False, durable_dir=tmp_path)
    assert svc2.explain()["durability"]["recovery"]["mode"] == "warm"
    assert svc2.epoch == 0
    more = queries + [("tc", (s, None)) for s in range(50)]
    _assert_all(svc2.ask_batch(more), twin.ask_batch(more),
                ctx="torn snapshot")
    svc2.close()
    svc.close()


# -- recovery across the two packages ----------------------------------------


def _bool_dense_case():
    e = _edges(seed=31)
    queries = [("tc", (s, None)) for s in (0, 4, 9)] + [("tc", (2, 7))]
    return (TC, {"e": e}, dict(sparse=False), queries,
            [("e", np.array([[0, 49], [49, 30]], np.int64)),
             ("e", np.array([[30, 12]], np.int64))])


def _minplus_csr_case():
    w = _weighted(seed=33)
    queries = [("dp", (s, None, None)) for s in (1, 2, 6)]
    return (MINPLUS, {"w": w}, dict(sparse=True), queries,
            [("w", np.array([[1, 29, 2], [29, 3, 1]], np.int64)),
             ("w", np.array([[3, 17, 1]], np.int64))])


SG = """
sg(X,Y) <- arc(P,X), arc(P,Y), X != Y.
sg(X,Y) <- arc(A,X), sg(A,B), arc(B,Y).
"""


def _tuple_template_case():
    # sg(s, X) does not lower to a frontier: B of them run as one
    # qid-tagged tuple fixpoint, whose TupleSnapshot the snapshot persists
    rng = np.random.default_rng(35)
    arcs = np.argwhere(rng.random((20, 20)) < 0.08).astype(np.int64)
    queries = [("sg", (s, None)) for s in (0, 2, 4)]
    return (SG, {"arc": arcs}, dict(default_cap=1 << 14), queries,
            [("arc", np.array([[0, 19], [19, 2]], np.int64)),
             ("arc", np.array([[4, 17]], np.int64))])


CROSS_CASES = {"bool_dense": _bool_dense_case,
               "minplus_csr": _minplus_csr_case,
               "tuple_template": _tuple_template_case}


@pytest.mark.parametrize("case", sorted(CROSS_CASES))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_recovery(tmp_path, case, writer):
    """A durable directory written by one package (queries, an append, a
    snapshot, a second append left in the WAL, a crash) is recovered warm
    by the other, which answers as the writer did, at its epoch."""
    program, db, kw, queries, appends = CROSS_CASES[case]()
    build_w, build_r = (_jax, _port) if writer == "jax" else (_port, _jax)
    wsvc = build_w(program, {k: v.copy() for k, v in db.items()},
                   durable_dir=tmp_path, **kw)
    wsvc.ask_batch(list(queries))
    wsvc.append(*appends[0])
    assert wsvc.snapshot(wait=True) == 1
    wsvc.append(*appends[1])
    want = wsvc.ask_batch(list(queries))
    epoch = wsvc.epoch
    if case == "tuple_template":
        assert any("+snap" in t for t in wsvc.explain()["templates"])
    del wsvc  # crash: the second append lives only in the WAL

    rsvc = build_r(program, {k: v.copy() for k, v in db.items()},
                   durable_dir=tmp_path, **kw)
    rep = rsvc.explain()
    assert rep["durability"]["recovery"]["mode"] == "warm"
    assert rep["durability"]["recovery"]["wal_replayed"] == 1
    assert rsvc.epoch == epoch
    if case == "tuple_template":
        assert any("+snap" in t for t in rep["templates"])
    else:
        pred = queries[0][0]
        assert rep["relations"][pred]["repr"] == (
            "csr" if kw.get("sparse") else "dense")
    _assert_all(rsvc.ask_batch(list(queries)), want, ctx=f"{case}/{writer}")
    rsvc.close()
