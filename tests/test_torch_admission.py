"""Parity of the port's admission front-end (``repro_torch.service.
admission``) with ``repro.service.admission``: the cases of
``tests/test_admission.py`` and the admission cases of ``tests/test_obs.py``
on the port, each answer held to JAX's ``Engine.ask`` on the same inputs,
and the counters, ``explain()["admission"]`` and the ``datalog_*`` metrics
of a staged flush equal to the JAX front-end's.  Every front-end closes in
``finally`` and every ``result()`` has a timeout; nothing here depends on
timing beyond what the JAX tests assume (a burst submitted while the
dispatcher is stopped flushes as one window).
"""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.engine import Engine as JEngine
from repro.service import AsyncDatalogService as JAsync
from repro.service import DatalogService as JService
from repro_torch.obs import Tracer
from repro_torch.service import (AsyncDatalogService, DatalogService,
                                 QueueFullError)
from repro_torch.service.incremental import EpochFence

TC = """
tc(X,Y) <- arc(X,Y).
tc(X,Y) <- tc(X,Z), arc(Z,Y).
"""
SG = """
sg(X,Y) <- arc(P,X), arc(P,Y), X != Y.
sg(X,Y) <- arc(A,X), sg(A,B), arc(B,Y).
"""
EDGES = np.array([[0, 1], [1, 2], [2, 3], [3, 1], [4, 0], [5, 6], [2, 5],
                  [6, 7], [7, 8], [0, 4], [3, 7]])
T = 60  # seconds any future may take


def front(program=TC, edges=EDGES, **kw):
    return AsyncDatalogService(
        DatalogService(program, db={"arc": edges}, default_cap=2048,
                       device="cpu"), **kw)


def jax_answers(program, edges, queries):
    eng = JEngine(program, db={"arc": edges}, default_cap=2048)
    return [eng.ask(*q) for q in queries]


def rows_set(rows):
    return {tuple(map(int, r)) for r in rows}


def test_concurrent_submitters_match_jax_ask():
    """8 threads x 4 queries race the dispatcher: every answer holds
    exactly JAX's ``Engine.ask`` rows in its order, whichever flush it
    landed in."""
    sources = list(range(8))
    want = dict(zip(sources, jax_answers(
        TC, EDGES, [("tc", (s, None)) for s in sources])))
    fr = front(max_wait_ms=1.0, max_batch=8)
    results: dict = {}
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # more thread switches: lost updates show
    try:
        def worker(s):
            results[s] = [fr.ask(("tc", (s, None)), timeout=T)
                          for _ in range(4)]

        threads = [threading.Thread(target=worker, args=(s,))
                   for s in sources]
        for t in threads:
            t.start()
        for t in threads:
            t.join(T)
        assert not any(t.is_alive() for t in threads)
        rep = fr.explain()["admission"]["counters"]
    finally:
        sys.setswitchinterval(switch)
        fr.close()
    for s in sources:
        for got in results[s]:
            assert np.array_equal(got, want[s]), s
    assert rep["submitted"] == 32 and rep["shed"] == 0
    assert rep["completed"] + rep["short_circuits"] == 32


def _staged(async_cls, svc):
    """One staged window of interleaved tc and sg queries: submitted while
    the dispatcher is stopped, so the flush holds all eight."""
    fr = async_cls(svc, max_wait_ms=50.0, max_batch=16, start=False)
    queries = []
    for s in (0, 2, 3, 1):
        queries.append(("tc", (s, None)))
        queries.append(("sg", (s, None)))
    try:
        futs = [fr.submit(q) for q in queries]
        fr.start()
        answers = [f.result(timeout=T) for f in futs]
        fr.drain(T)
        rep = fr.explain()
    finally:
        fr.close()
    return queries, answers, rep, fr


def test_mixed_shapes_staged_flush_matches_jax():
    """A flush holding tc (frontier) and sg (tuple) queries runs each shape
    group as its own fixpoint; the answers, the service counters, the
    admission report and the admission metrics equal the JAX front-end's
    for the same staged window."""
    program = TC + SG
    jsvc = JService(program, db={"arc": EDGES}, default_cap=2048)
    tsvc = DatalogService(program, db={"arc": EDGES}, default_cap=2048,
                          device="cpu")
    queries, want, jrep, jfr = _staged(JAsync, jsvc)
    _, got, rep, fr = _staged(AsyncDatalogService, tsvc)
    for q, g, w in zip(queries, got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), q
    assert fr.stats.flushes == 1 and fr.stats.max_flush == 8
    assert tsvc.stats.dense_fixpoints == 1 and tsvc.stats.tuple_fixpoints >= 1
    rep["service"].pop("fixpoint_iterations")
    assert rep["service"] == jrep["service"]
    assert rep["admission"] == jrep["admission"]
    jm, tm = jsvc.metrics.to_json(), tsvc.metrics.to_json()
    for name in ("datalog_admission_total", "datalog_queue_depth",
                 "datalog_admission_max_flush"):
        assert tm[name] == jm[name], name
    assert tm["datalog_queue_wait_seconds"]["series"]["_"]["count"] == \
        jm["datalog_queue_wait_seconds"]["series"]["_"]["count"] == 8
    assert 'datalog_admission_total{event="submitted"} 8' in \
        tsvc.metrics.to_prometheus()


def test_cache_hit_short_circuits_at_submit():
    fr = front(max_wait_ms=1.0, max_batch=8)
    try:
        first = fr.ask(("tc", (2, None)), timeout=T)
        flushes = fr.stats.flushes
        fut = fr.submit(("tc", (2, None)))
        assert fut.done(), "a cache hit resolves before submit returns"
        assert fut.result() is first
        assert fr.stats.short_circuits == 1
        fr.drain(T)
        assert fr.stats.flushes == flushes
    finally:
        fr.close()
    (want,) = jax_answers(TC, EDGES, [("tc", (2, None))])
    assert np.array_equal(first, want)


def test_queue_full_sheds_with_typed_error():
    fr = front(queue_depth=3, start=False)
    try:
        futs = [fr.submit(("tc", (s, None))) for s in (0, 1, 2)]
        with pytest.raises(QueueFullError) as exc:
            fr.submit(("tc", (3, None)))
        assert exc.value.depth == 3
        assert fr.stats.shed == 1 and fr.stats.submitted == 3
        # malformed queries fail the caller synchronously
        with pytest.raises(Exception):
            fr.submit("no_such_pred(1, X)")
        fr.start()
        fr.drain(T)
        assert fr.stats.completed == 3
        for f, w in zip(futs, jax_answers(
                TC, EDGES, [("tc", (s, None)) for s in (0, 1, 2)])):
            assert np.array_equal(f.result(timeout=T), w)
    finally:
        fr.close()


def test_append_racing_inflight_flush_is_epoch_fenced():
    """A burst, then an append from the test thread: the fence drains the
    in-flight flushes before the epoch moves; every pre-append answer is
    one epoch's whole answer, post-append ones see the new arc, and the
    refreshed cache serves post-append answers."""
    appended = np.vstack([EDGES, [[8, 0]]])
    pre_q = [("tc", (s, None)) for s in range(6)]
    post_q = [("tc", (s, None)) for s in range(9)]
    want_pre = jax_answers(TC, EDGES, pre_q)
    want_post = jax_answers(TC, appended, post_q)
    fr = front(max_wait_ms=1.0, max_batch=4)
    try:
        pre_futs = [fr.submit(q) for q in pre_q]
        fr.append("arc", [[8, 0]])  # races the in-flight flushes
        assert fr.epoch == 1
        post_futs = [fr.submit(q) for q in post_q[6:]]
        pre = [f.result(timeout=T) for f in pre_futs]
        post = [f.result(timeout=T) for f in post_futs]
        for s, got in enumerate(pre):
            assert rows_set(got) in (rows_set(want_pre[s]),
                                     rows_set(want_post[s])), s
        for s, got in zip(range(6, 9), post):
            assert np.array_equal(got, want_post[s]), s
        for s in range(6):  # refreshed under the fence
            got = fr.ask(pre_q[s], timeout=T)
            assert rows_set(got) == rows_set(want_post[s]), s
    finally:
        fr.close()


def test_append_under_sustained_load_stays_consistent():
    new_edges = [[8, 1], [7, 0], [6, 3]]
    final = np.vstack([EDGES] + [[r] for r in new_edges])
    want = jax_answers(TC, final, [("tc", (s, None)) for s in range(9)])
    fr = front(max_wait_ms=1.0, max_batch=8)
    stop = threading.Event()
    errors: list = []
    try:
        def submitter(seed):
            rng = np.random.default_rng(seed)
            while not stop.is_set():
                try:
                    fr.ask(("tc", (int(rng.integers(0, 9)), None)), timeout=T)
                except Exception as e:  # pragma: no cover - diagnostic
                    errors.append(e)
                    return

        threads = [threading.Thread(target=submitter, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for row in new_edges:
            time.sleep(0.01)
            fr.append("arc", [row])
        stop.set()
        for t in threads:
            t.join(T)
        assert not errors, errors[:1]
        assert not any(t.is_alive() for t in threads)
        assert fr.epoch == len(new_edges)
        for s in range(9):
            assert rows_set(fr.ask(("tc", (s, None)), timeout=T)) == \
                rows_set(want[s]), s
    finally:
        stop.set()
        fr.close()


def test_unfenced_append_trips_the_epoch_assert_like_jax():
    """An append that lands between a batch's launch and its finalize (what
    the fence prevents) trips the same assertion in both services."""
    msgs = []
    for svc in (JService(TC, db={"arc": EDGES}),
                DatalogService(TC, db={"arc": EDGES}, device="cpu")):
        pending = svc.launch_batch([("tc", (0, None))])
        svc.append("arc", [[8, 0]])
        with pytest.raises(AssertionError) as exc:
            svc.finalize_batch(pending)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "epoch fence" in msgs[1]


def test_epoch_fence_writer_drains_readers_and_has_priority():
    fence = EpochFence()
    fence.acquire_read()
    order: list = []

    def writer():
        with fence.writing():
            order.append("write")

    w = threading.Thread(target=writer)
    w.start()
    time.sleep(0.05)
    assert order == []  # the in-flight reader holds the writer off
    late = threading.Thread(target=lambda: (fence.acquire_read(),
                                            order.append("read"),
                                            fence.release_read()))
    late.start()
    time.sleep(0.05)
    assert order == []  # writer priority: a new reader waits too
    fence.release_read()
    w.join(T)
    late.join(T)
    assert order == ["write", "read"]


def test_flush_errors_reach_the_futures():
    """A failure inside a flush (launch or finalize) is set on every future
    of that flush and counted; the front-end keeps serving."""
    fr = front(max_wait_ms=1.0, max_batch=8, start=False)
    svc = fr.svc
    try:
        for phase in ("launch_batch", "finalize_batch"):
            real = getattr(svc, phase)

            def boom(*a, **k):
                raise RuntimeError(f"{phase} failed")

            setattr(svc, phase, boom)
            futs = [fr.submit(("tc", (s, None))) for s in (0, 1)]
            if not fr._started:
                fr.start()
            for f in futs:
                with pytest.raises(RuntimeError, match=phase):
                    f.result(timeout=T)
            fr.drain(T)
            setattr(svc, phase, real)
        assert fr.stats.failed_flushes == 2
        got = fr.ask(("tc", (3, None)), timeout=T)
        (want,) = jax_answers(TC, EDGES, [("tc", (3, None))])
        assert np.array_equal(got, want)
    finally:
        fr.close()


def test_racing_submitters_leave_well_formed_traces():
    svc = DatalogService(TC, db={"arc": np.asarray(
        [[i, (i + 1) % 48] for i in range(48)])}, default_cap=4096,
        tracer=True, device="cpu")
    assert isinstance(svc.tracer, Tracer)
    fr = AsyncDatalogService(svc, max_wait_ms=1.0, max_batch=4)
    queries = [f"tc({s}, X)" for s in range(8)]
    futs: list = [None] * len(queries)
    gate = threading.Barrier(2)
    try:
        def submit(lo, hi):
            gate.wait()
            for i in range(lo, hi):
                futs[i] = fr.submit(queries[i])

        workers = [threading.Thread(target=submit, args=(0, 4)),
                   threading.Thread(target=submit, args=(4, 8))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(T)
        assert not any(w.is_alive() for w in workers)
        for f in futs:
            assert f.result(timeout=T) is not None
    finally:
        fr.close()
    evs = svc.tracer.events()
    xs = [e for e in evs if e["ph"] == "X"]
    for i, a in enumerate(xs):  # one lane's spans nest or are disjoint
        for b in xs[i + 1:]:
            if a["tid"] == b["tid"] and Tracer.overlaps(a, b):
                a0, a1 = a["ts"], a["ts"] + a["dur"]
                b0, b1 = b["ts"], b["ts"] + b["dur"]
                assert (a0 <= b0 and b1 <= a1) or (b0 <= a0 and a1 <= b1)
    submits = [e for e in evs if e["name"] == "submit"]
    assert len(submits) == 8 and len({e["tid"] for e in submits}) == 2
    coalesce = [e for e in xs if e["name"] == "coalesce"]
    assert sum(e["args"]["batch"] for e in coalesce) == 8
    assert {"launch_batch", "finalize_batch"} <= {e["name"] for e in xs}
    json.dumps(svc.tracer.to_chrome())


def test_snapshot_and_default_device(monkeypatch):
    """A snapshot of a front-end whose service has no ``durable_dir`` raises
    JAX's ``RuntimeError``, and with no ``device`` the front-end builds its
    service on the card, raising without one."""
    fr = front(start=False)
    try:
        with pytest.raises(RuntimeError, match="durable_dir"):
            fr.snapshot()
    finally:
        fr.close()
    if torch.cuda.is_available():  # make the GPU-less case on any host
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no usable GPU"):
        AsyncDatalogService(TC, db={"arc": EDGES}, start=False)
