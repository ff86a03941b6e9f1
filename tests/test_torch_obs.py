"""Parity of the port's observability (``repro_torch.obs`` and the
service's ``tracer=``/``probe=``/``metrics=``) with ``repro.obs``: the cases
of ``tests/test_obs.py``, each fed the same numpy inputs through both
packages and held to JAX's answers.

* ``Tracer``: the same calls record the same events (names, categories,
  phases, args, lanes), and nest the same way;
* ``MetricsRegistry``: the same calls give the same Prometheus text and
  JSON, exact under a thread hammer;
* ``KernelAttribution.report()``: equal for the same records under the same
  ``HW`` numbers;
* the probed twins: bit-identical to the unprobed fixpoints, dense and CSR,
  bool, min-plus and max-plus, with ``FixpointProbe`` dicts and trace-count
  deltas equal to JAX's and the Δ oracle (``seed + ΣΔ == final`` for bool);
* the service: answers, spans, ``explain()``'s ``kernels``/``probes`` and
  the ``datalog_*`` schema equal to JAX's (device times excepted: they are
  measured, not computed).
"""
import dataclasses
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _reference import ref_distances, ref_reachable
from test_torch_parity_cases import pair, same

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.core import engine as jengine
from repro.core import semiring as jsr
from repro.core import sparse as jsp
from repro.roofline.report import HW as JHW
from repro.service import DatalogService as JService
from repro.service.cache import CacheEntry as JEntry
from repro.service.cache import LRUCache as JLRU
from repro_torch.core import engine as tengine
from repro_torch.core import semiring as tsr
from repro_torch.core import seminaive as tsn
from repro_torch.core import sparse as tsp
from repro_torch.roofline.report import H100
from repro_torch.service import DatalogService as TService
from repro_torch.service.cache import CacheEntry as TEntry
from repro_torch.service.cache import LRUCache as TLRU

TC = "tc(X,Y) <- arc(X,Y).\ntc(X,Y) <- tc(X,Z), arc(Z,Y)."
SP = ("sp(X,Y,min<D>) <- w(X,Y,D).\n"
      "sp(X,Y,min<D>) <- sp(X,Z,D1), w(Z,Y,D2), D = D1 + D2.")
CPATH = ("cpath(X,Z,sum<C>) <- d(X,Z,C).\n"
         "cpath(X,Z,sum<C>) <- cpath(X,Y,C1), d(Y,Z,C2), C = C1 * C2.")
PKGS = {"jax": jobs, "torch": tobs}
#: the timing histograms: their counts are computed, their sums measured
TIMED = ("datalog_device_seconds", "datalog_finalize_seconds")


def ring(n: int) -> np.ndarray:
    return np.asarray([[i, (i + 1) % n] for i in range(n)], np.int64)


def gnp(n: int, p: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    np.fill_diagonal(a, False)
    r, c = np.nonzero(a)
    return np.stack([r, c], axis=1).astype(np.int64)


def weighted(edges, seed, hi=9):
    rng = np.random.default_rng(seed)
    return np.concatenate([edges, rng.integers(1, hi, (len(edges), 1))], 1)


def services(text, db, **kw):
    """The JAX service and the port's (on the CPU) over the same inputs."""
    return JService(text, db=db, **kw), TService(text, db=db, device="cpu",
                                                 **kw)


def well_formed(spans) -> bool:
    """Any two spans on one tid are disjoint or properly nested."""
    for i, a in enumerate(spans):
        for b in spans[i + 1:]:
            if a["tid"] != b["tid"] or not tobs.Tracer.overlaps(a, b):
                continue
            a0, a1 = a["ts"], a["ts"] + a["dur"]
            b0, b1 = b["ts"], b["ts"] + b["dur"]
            if not ((a0 <= b0 and b1 <= a1) or (b0 <= a0 and a1 <= b1)):
                return False
    return True


def inside(inner, outer) -> bool:
    return (inner["ts"] >= outer["ts"] and
            inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def shape_of(events) -> list:
    """What two traces of the same calls share: every event but its times
    and thread ids."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
            for e in events]


# -- tracer -------------------------------------------------------------------


def _trace_scenario(obs):
    tr = obs.Tracer()
    with tr.span("outer", cat="service", k=1):
        time.sleep(0.001)
        with tr.span("inner", cat="device"):
            time.sleep(0.001)
    tr.instant("mark", cat="service", n=3)
    sp = tr.span("s", cat="c")
    sp.annotate(batch=4)
    sp.end()
    sp.end()  # idempotent: no duplicate event
    with sp:  # a with-block after end() records nothing either
        pass
    return tr


def test_tracer_events_match_jax(tmp_path):
    jtr, ttr = _trace_scenario(jobs), _trace_scenario(tobs)
    assert shape_of(ttr.events()) == shape_of(jtr.events())
    xs = ttr.spans()
    assert [e["name"] for e in xs] == ["inner", "outer", "s"]
    for e in xs:
        for field in ("name", "cat", "ph", "ts", "dur", "pid", "tid"):
            assert field in e
    inner, outer, _ = xs
    assert inside(inner, outer) and well_formed(xs)
    assert ttr.spans("s")[0]["args"] == {"batch": 4}
    assert ttr.spans("nope") == jtr.spans("nope") == []
    path = tmp_path / "trace.json"
    ttr.export_chrome(str(path))
    doc = json.loads(path.read_text())
    assert shape_of(doc["traceEvents"]) == shape_of(
        jtr.to_chrome()["traceEvents"])
    assert doc["displayTimeUnit"] == jtr.to_chrome()["displayTimeUnit"]
    ttr.clear()
    assert ttr.events() == []


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_tracer_concurrent_threads_exact_and_well_formed(pkg):
    tr = PKGS[pkg].Tracer()
    threads, per = 6, 40
    gate = threading.Barrier(threads)  # all alive at once -> distinct tids

    def work():
        gate.wait()
        for i in range(per):
            with tr.span("step", i=i):
                with tr.span("sub"):
                    pass

    ts = [threading.Thread(target=work) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts)
    xs = tr.spans()
    assert len(xs) == threads * per * 2
    assert len({e["tid"] for e in xs}) == threads
    assert well_formed(xs)


def test_null_tracer_matches_jax(tmp_path):
    for obs in (jobs, tobs):
        null = obs.NULL_TRACER
        assert null.enabled is False
        s1, s2 = null.span("a", x=1), null.span("b")
        assert s1 is s2  # shared no-op span
        with s1:
            s1.annotate(y=2)
        null.instant("i")
        assert null.events() == [] and null.spans() == []
        path = tmp_path / f"{obs.__name__}.json"
        null.export_chrome(str(path))
        assert json.loads(path.read_text()) == {"traceEvents": [],
                                                "displayTimeUnit": "ms"}


# -- metrics ------------------------------------------------------------------


def _metrics_scenario(obs):
    m = obs.MetricsRegistry()
    c = m.counter("datalog_things_total", "things")
    c.inc()
    c.inc(2, labels={"kind": "a"})
    g = m.gauge("datalog_depth")
    g.set(5)
    g.dec()
    h = m.histogram("datalog_s_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    b = m.histogram("datalog_batch_size", buckets=(1, 2, 4))
    for v in (1, 3, 9, 2):
        b.observe(v, labels={"shape": "tc"})
    ext = {"done": 7}
    m.register_collector(
        lambda reg: reg.counter("datalog_done_total").set(ext["done"]))
    return m, c, g, h


def test_metrics_exports_match_jax(tmp_path):
    (jm, jc, jg, jh), (tm, tc_, tg, th) = (_metrics_scenario(jobs),
                                          _metrics_scenario(tobs))
    assert tm.to_prometheus() == jm.to_prometheus()
    assert tm.to_json() == jm.to_json()
    assert (tc_.value(), tc_.value({"kind": "a"}), tg.value(), th.count()) \
        == (jc.value(), jc.value({"kind": "a"}), jg.value(), jh.count()) \
        == (1, 2, 4, 3)
    assert th.percentiles((50, 99)) == jh.percentiles((50, 99))
    text = tm.to_prometheus()
    for needle in ('datalog_s_seconds_bucket{le="0.1"} 1',
                   'datalog_s_seconds_bucket{le="+Inf"} 3',
                   "datalog_s_seconds_sum 5.55", "datalog_done_total 7"):
        assert needle in text
    for m in (jm, tm):  # same name, same object; kind conflicts raise
        assert m.counter("datalog_things_total") is m.counter(
            "datalog_things_total")
        with pytest.raises(TypeError):
            m.gauge("datalog_things_total")
        with pytest.raises(TypeError):
            m.histogram("datalog_depth")
    for m, name in ((jm, "j"), (tm, "t")):
        m.export(str(tmp_path / f"{name}.prom"))
        m.export(str(tmp_path / f"{name}.json"))
    assert (tmp_path / "t.prom").read_text() == \
        (tmp_path / "j.prom").read_text()
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())


def test_metrics_registry_concurrency_exact_totals():
    m = tobs.MetricsRegistry()
    c = m.counter("datalog_hammer_total")
    h = m.histogram("datalog_hammer_seconds")
    threads, per = 8, 2000

    def work(tid):
        for i in range(per):
            c.inc()
            c.inc(labels={"t": str(tid % 2)})
            h.observe(1e-3 * (i % 7))

    ts = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts)
    assert c.value() == threads * per
    assert c.value({"t": "0"}) + c.value({"t": "1"}) == threads * per
    assert h.count() == threads * per


def test_null_metrics_match_jax(tmp_path):
    for obs in (jobs, tobs):
        n = obs.NULL_METRICS
        assert n.enabled is False
        n.counter("x").inc()
        n.gauge("y").set(3)
        n.histogram("z").observe(1.0)
        assert n.counter("x").value() == 0.0
        assert np.isnan(n.histogram("z").percentiles((50,))["p50"])
        n.register_collector(lambda reg: 1 / 0)  # never runs
        n.collect()
        assert n.to_prometheus() == "" and n.to_json() == {}
    assert tobs.DEFAULT_BUCKETS == jobs.DEFAULT_BUCKETS


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_lru_cache_hit_counts_exact_under_threads(pkg):
    lru, entry = (JLRU, JEntry) if pkg == "jax" else (TLRU, TEntry)
    cache = lru(64)
    cache.put(("tc", 0, None),
              entry("dense", "tc", np.zeros((1, 2), np.int64), epoch=0))
    threads, per = 8, 2000

    def work(tid):
        for i in range(per):
            assert cache.get(("tc", 0, None)) is not None
            cache.get(("miss", tid, i))
            if i % 100 == 0:
                cache.put(("k", tid, i), entry("tuple", "tc", None, epoch=0))

    ts = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts)
    assert cache.hits == cache.misses == threads * per
    assert cache.peek(("tc", 0, None)).hits == threads * per


# -- roofline attribution -----------------------------------------------------


def test_kernel_attribution_report_matches_jax():
    hw = dataclasses.asdict(H100)
    reports = []
    for obs, HW in ((jobs, JHW), (tobs, type(H100))):
        ka = obs.KernelAttribution(HW(**hw))
        cost = obs.dense_launch_cost(B=8, n=1024, itemsize=4, iters=10)
        assert cost["flops"] == 2 * 8 * 1024 * 1024 * 10
        ka.record("frontier_matmul:bool", seconds=0.01, iterations=10, **cost)
        ka.record("frontier_matmul:bool", seconds=0.01, iterations=10, **cost)
        ccost = obs.csr_launch_cost(B=8, n_alloc=1024, e_alloc=4096,
                                    itemsize=4, iters=5)
        ka.record("csr_spmv:bool", seconds=0.002, iterations=5, **ccost)
        ka.record("csr_spmv:minplus", seconds=0.0, iterations=0, flops=0.0,
                  bytes=0.0)
        reports.append(ka.report())
        ka.clear()
        assert ka.report() == {}
    assert reports[1] == reports[0]
    mm = reports[1]["frontier_matmul:bool"]
    assert mm["launches"] == 2 and mm["iterations"] == 20
    assert tobs.KernelAttribution().hw == H100  # the port scores the H100


# -- probed twins -------------------------------------------------------------


def _dense_inputs(kind, n=40, b=3, seed=4):
    """A random arc matrix and a (b, n) frontier in the carrier, and the
    semirings of both packages."""
    rng = np.random.default_rng(seed)
    live = rng.random((n, n)) < 0.08
    if kind == "bool":
        arc = live
        init = np.zeros((b, n), bool)
        init[np.arange(b), rng.integers(0, n, b)] = True
    else:
        zero = np.inf if kind == "minplus" else -np.inf
        if kind == "maxplus":  # a DAG: max-plus has a fixpoint there
            live &= np.triu(np.ones((n, n), bool), 1)
        arc = np.where(live, rng.integers(1, 9, (n, n)), zero).astype(
            np.float32)
        init = arc[rng.integers(0, n, b)]
    name = {"bool": "BOOL", "minplus": "MIN_PLUS", "maxplus": "MAX_PLUS"}[kind]
    return arc, init, getattr(jsr, name), getattr(tsr, name)


def _probe_pair(jres, jpr, tres, tpr):
    assert np.array_equal(tres.table.numpy(), np.asarray(jres.table))
    assert tres.iterations == int(jres.iterations)
    assert tres.generated == int(jres.generated)
    assert tpr.as_dict() == jpr.as_dict()


@pytest.mark.parametrize("kind", ["bool", "minplus", "maxplus"])
def test_probed_dense_twin_matches_jax_and_unprobed(kind):
    arc, init, jsr_, tsr_ = _dense_inputs(kind)
    jres, jpr = jobs.fixpoint_dense_probed(jsr_, jnp.asarray(arc),
                                           jnp.asarray(init))
    ta, ti = torch.from_numpy(arc), torch.from_numpy(init)
    tres, tpr = tobs.fixpoint_dense_probed(tsr_, ta, ti)
    _probe_pair(jres, jpr, tres, tpr)
    plain = tsn.fixpoint_dense(tsr_, ta, ti, form="vector")
    assert torch.equal(plain.table, tres.table)  # bit-identical
    assert (plain.iterations, plain.generated) == (tres.iterations,
                                                   tres.generated)
    assert tpr.iterations == len(tpr.delta_facts) == len(tpr.frontier_rows)
    if kind == "bool":
        assert tpr.seed_facts + tpr.total_delta == tpr.final_facts


@pytest.mark.parametrize("kind", ["bool", "minplus", "maxplus"])
def test_probed_csr_twin_matches_jax_and_unprobed(kind):
    arc, init, _, _ = _dense_inputs(kind, seed=9)
    live = arc if kind == "bool" else np.isfinite(arc)
    r, c = np.nonzero(live)
    edges = np.stack([r, c], 1).astype(np.int64)
    if kind != "bool":
        edges = np.concatenate([edges, arc[r, c].astype(np.int64)[:, None]],
                               1)
    n = arc.shape[0]
    jcsr, tcsr = (jsp.build_csr(edges, n, kind),
                  tsp.build_csr(edges, n, kind, device="cpu"))
    jres, jpr = jobs.fixpoint_csr_probed(jcsr, jnp.asarray(init))
    ti = torch.from_numpy(init)
    tres, tpr = tobs.fixpoint_csr_probed(tcsr, ti)
    _probe_pair(jres, jpr, tres, tpr)
    plain = tsp.fixpoint_csr(tcsr, ti)
    assert torch.equal(plain.table, tres.table)
    assert (plain.iterations, plain.generated) == (tres.iterations,
                                                   tres.generated)
    assert tpr.repr == "csr"
    if kind == "bool":
        assert tpr.seed_facts + tpr.total_delta == tpr.final_facts


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_probed_ask_dense_bit_identical_and_delta_oracle(sparse):
    edges = gnp(48, 0.08, seed=3)
    j, t = pair(TC, {"arc": edges}, default_cap=4096)
    for src in (0, 5, 17):
        plain = t.ask_dense("tc", (src, None), sparse=sparse)
        got, pr = t.ask_dense("tc", (src, None), sparse=sparse, probe=True)
        jgot, jpr = j.ask_dense("tc", (src, None), sparse=sparse, probe=True)
        same(got, plain)
        same(got, jgot)
        assert pr.as_dict() == jpr.as_dict()
        want = ref_reachable(edges, src)
        assert pr.final_facts == len(want)
        assert pr.seed_facts + pr.total_delta == len(want)
        assert pr.repr == ("csr" if sparse else "dense")


def test_probed_minplus_ask_dense_matches_oracle_and_jax():
    w = weighted(gnp(24, 0.12, seed=11), 7)
    j, t = pair(SP, {"w": w}, default_cap=4096)
    plain = t.ask_dense("sp", (0, None))
    got, pr = t.ask_dense("sp", (0, None), probe=True)
    jgot, jpr = j.ask_dense("sp", (0, None), probe=True)
    same(got, plain)
    same(got, jgot)
    assert pr.as_dict() == jpr.as_dict()
    rows, vals = got
    want = ref_distances(w, 0)
    assert {int(r[1]): int(v) for r, v in zip(rows, vals)} == want
    assert pr.final_facts == len(want)


def test_probed_twins_reject_what_jax_rejects():
    edges = np.array([[0, 1, 1], [1, 2, 1], [0, 2, 1]], np.int64)
    w = np.zeros((8, 8), np.float32)
    w[edges[:, 0], edges[:, 1]] = 1.0
    arc = torch.from_numpy(w)
    with pytest.raises(NotImplementedError, match="accumulate"):
        tobs.fixpoint_dense_probed(tsr.PLUS_TIMES, arc, arc[:1])
    with pytest.raises(NotImplementedError, match="form='vector'"):
        tobs.fixpoint_dense_probed(tsr.BOOL, arc > 0, arc[:1] > 0,
                                   form="linear")
    with pytest.raises(NotImplementedError, match="accumulate"):
        tobs.fixpoint_csr_probed(
            tsp.build_csr(edges, 8, "plustimes", device="cpu"),
            torch.zeros((1, 8)))
    # a probe-mode counting service answers as JAX's and probes nothing
    jsvc, tsvc = services(CPATH, {"d": edges}, probe=True)
    same(tsvc.ask("cpath", (0, None, None)), jsvc.ask("cpath", (0, None, None)))
    assert not tsvc.last_probes and not jsvc.last_probes


def test_probe_counters_saturate_like_jax():
    assert tsn.GEN_MAX == torch.iinfo(tsn.GEN_DTYPE).max
    edges = gnp(32, 0.1, seed=2)
    adj = np.zeros((32, 32), bool)
    adj[edges[:, 0], edges[:, 1]] = True
    init = np.zeros((3, 32), bool)
    init[[0, 1, 2], [0, 5, 9]] = True
    jres, jpr = jobs.fixpoint_dense_probed(jsr.BOOL, jnp.asarray(adj),
                                           jnp.asarray(init))
    tres, tpr = tobs.fixpoint_dense_probed(tsr.BOOL, torch.from_numpy(adj),
                                           torch.from_numpy(init))
    _probe_pair(jres, jpr, tres, tpr)
    assert 0 <= tpr.total_delta < int(tsn.GEN_MAX)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_probed_trace_count_deltas_match_jax(sparse):
    """The probed steps count as JAX's own jit entries: once per batch
    shape, nothing when warm, and never in the unprobed fixpoints' caches
    (allocations no other test uses keep the shapes fresh)."""
    arcs = ring(33)
    kw = dict(n_align=41 + int(sparse), sparse=sparse, result_cache=0)
    jsvc, tsvc = services(TC, {"arc": arcs}, probe=True, **kw)
    jplain, tplain = services(TC, {"arc": arcs}, **kw)
    deltas = []
    for svcs, batch in (((jsvc, tsvc), [1]), ((jsvc, tsvc), [2]),
                        ((jsvc, tsvc), [1, 2, 3]), ((jplain, tplain), [4]),
                        ((jplain, tplain), [5]), ((jsvc, tsvc), [6])):
        qs = [("tc", (s, None)) for s in batch]
        j0, t0 = jengine.fixpoint_trace_count(), tengine.fixpoint_trace_count()
        want = svcs[0].ask_batch(qs)
        got = svcs[1].ask_batch(qs)
        for g, w in zip(got, want):
            same(g, w)
        deltas.append(tengine.fixpoint_trace_count() - t0)
        assert deltas[-1] == jengine.fixpoint_trace_count() - j0, batch
    assert deltas == [1, 0, 1, 1, 0, 0]
    assert ([p.as_dict() for p in tsvc.last_probes]
            == [p.as_dict() for p in jsvc.last_probes])


# -- the service: probes, spans, metrics, attribution -------------------------


def test_service_probe_mode_answers_and_explain_match_jax():
    edges = gnp(40, 0.08, seed=5)
    queries = [f"tc({s}, X)" for s in (0, 3, 9, 12)]
    base = TService(TC, db={"arc": edges}, default_cap=4096, device="cpu")
    jsvc, tsvc = services(TC, {"arc": edges}, default_cap=4096, probe=True)
    want = jsvc.ask_batch(queries)
    for a, b, c in zip(base.ask_batch(queries), tsvc.ask_batch(queries),
                       want):
        same(b, a)
        same(b, c)
    rep, jrep = tsvc.explain(), jsvc.explain()
    assert rep["probes"] == jrep["probes"] and rep["probes"]
    assert rep["probes"][-1]["iterations"] >= 1
    for p in tsvc.last_probes:
        assert p.seed_facts + p.total_delta == p.final_facts
    assert "probes" not in base.explain()


def _trace_calls(svc):
    svc.ask_batch(["tc(0, X)", "tc(5, X)"])
    svc.ask_batch(["tc(0, X)", "tc(7, X)", "tc(1, 2)"])
    svc.append("arc", np.asarray([[0, 16]], np.int64))
    return svc.tracer.spans()


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_service_trace_spans_match_jax(sparse, tmp_path):
    jsvc, tsvc = services(TC, {"arc": ring(32)}, default_cap=4096,
                          tracer=True, sparse=sparse)
    want, xs = _trace_calls(jsvc), _trace_calls(tsvc)
    assert shape_of(xs) == shape_of(want)
    assert {"launch_batch", "fixpoint", "finalize_batch", "device_sync",
            "cache_fill", "append"} <= {e["name"] for e in xs}
    assert well_formed(xs)
    lb, fp = tsvc.tracer.spans("launch_batch")[0], \
        tsvc.tracer.spans("fixpoint")[0]
    fb, cf = tsvc.tracer.spans("finalize_batch")[0], \
        tsvc.tracer.spans("cache_fill")[0]
    assert inside(fp, lb) and inside(cf, fb)
    assert fp["cat"] == "device" and lb["cat"] == "service"
    path = tmp_path / "svc_trace.json"
    tsvc.tracer.export_chrome(str(path))
    assert len(json.loads(path.read_text())["traceEvents"]) == \
        len(tsvc.tracer.events())


def _metric_calls(svc):
    svc.ask_batch(["tc(0, X)", "tc(3, X)"])
    svc.ask_batch(["tc(0, X)"])  # cache hit
    svc.ask_batch(["tc(X, 4)", "tc(2, X)"])  # a tuple query beside a frontier
    svc.append("arc", np.asarray([[1, 20]], np.int64))


def _untimed(doc: dict) -> dict:
    """A ``to_json()`` without what is measured: the timing histograms'
    sums and the process-wide trace count."""
    doc = json.loads(json.dumps(doc))
    for name in TIMED:
        for series in doc[name]["series"].values():
            series.pop("sum")
    doc.pop("datalog_fixpoint_traces_total")
    return doc


@pytest.mark.parametrize("metrics", [None, "registry"])
def test_service_metrics_unified_schema_matches_jax(metrics):
    kw = dict(default_cap=4096)
    if metrics == "registry":
        jsvc = JService(TC, db={"arc": ring(32)},
                        metrics=jobs.MetricsRegistry(), **kw)
        tsvc = TService(TC, db={"arc": ring(32)}, device="cpu",
                        metrics=tobs.MetricsRegistry(), **kw)
    else:
        jsvc, tsvc = services(TC, {"arc": ring(32)}, **kw)
    _metric_calls(jsvc)
    _metric_calls(tsvc)
    assert _untimed(tsvc.metrics.to_json()) == _untimed(jsvc.metrics.to_json())
    text = tsvc.metrics.to_prometheus()
    for needle in ("datalog_fixpoints_total", "datalog_cache_hits_total",
                   "datalog_batched_queries_total", "datalog_appends_total",
                   "datalog_epoch", "datalog_batch_size",
                   "datalog_fixpoint_traces_total"):
        assert needle in text
    m = tsvc.metrics
    assert m.gauge("datalog_epoch").value() == 1
    assert m.histogram("datalog_batch_size").count() == 3


def test_disabled_metrics_record_nothing_like_jax():
    jsvc, tsvc = services(TC, {"arc": ring(16)}, metrics=False)
    for svc in (jsvc, tsvc):
        svc.ask_batch(["tc(0, X)"])
        assert svc.metrics.to_prometheus() == ""
    assert tsvc.metrics is tobs.NULL_METRICS


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_service_kernel_attribution_matches_jax(sparse):
    edges = gnp(64, 0.06, seed=2)
    jsvc, tsvc = services(TC, {"arc": edges}, default_cap=4096,
                          sparse=sparse)
    for svc in (jsvc, tsvc):
        svc.ask_batch(["tc(0, X)", "tc(1, X)", "tc(2, X)"])
        svc.ask_batch([f"tc({s}, X)" for s in range(3, 12)])
    got, want = tsvc.explain()["kernels"], jsvc.explain()["kernels"]
    assert sorted(got) == sorted(want) == \
        [f"{'csr_spmv' if sparse else 'frontier_matmul'}:bool"]
    for name, k in got.items():
        for key in ("launches", "iterations", "model_flops", "model_bytes"):
            assert k[key] == want[name][key], key
        assert set(k) == set(want[name])
        assert k["launches"] == 2 and k["seconds"] > 0
        assert k["dominant"] in ("compute", "memory")
        assert 0 <= k["frac_peak_flops"] and 0 <= k["frac_peak_bw"]


def test_trace_count_thread_hammer_exact():
    threads, per = 16, 2000
    t0 = tsn.trace_count()
    gate = threading.Barrier(threads)

    def work():
        gate.wait()
        for _ in range(per):
            tsn.bump_trace_count()

    ts = [threading.Thread(target=work) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts)
    assert tsn.trace_count() - t0 == threads * per
