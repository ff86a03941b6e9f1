"""Port parity of the tuple engine's evaluation mechanics, against
``repro.core.engine.Engine`` on the same seeded inputs: ``CapacityError``
at the same table and join capacities, joins expanded in chunks (the
answers, counters and capacity checks of one expansion), ``run(warm=)``,
domain and width errors, the trace counter's deltas, and the default
device."""
import numpy as np
import pytest
import torch

from test_torch_parity_cases import (
    ATTEND, CASES_NEGATION_DB, CPATH_EX5, FRIEND, NEGATION, SG, SPATH_LIN,
    SPATH_NL, TC, TC_NL, boundary, edges_of, port_fits, run_both, same_engine,
    weighted)
from repro.core import engine as jengine
from repro.core.engine import CapacityError as JCapacityError
from repro.core.engine import Engine as JEngine
from repro.core.planner import PlanError as JPlanError
from repro_torch.core import engine as tengine
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.planner import PlanError as TPlanError


# -- capacities ------------------------------------------------------------


@pytest.mark.parametrize("text,db,knob", [
    (TC, {"arc": np.array([[i, i + 1] for i in range(40)])}, "default_cap"),
    (TC, {"arc": edges_of(5, 14, 40)}, "join_cap"),
    (SPATH_LIN, {"darc": weighted(edges_of(6, 10, 30))}, "join_cap"),
    (ATTEND, {"friend": FRIEND, "organizer": np.array([[0], [2]])},
     "default_cap"),
], ids=["tc-chain-table", "tc-join", "spath-join", "attend-table"])
def test_capacity_error_at_jax_caps(text, db, knob):
    """The least capacity that fits is the same in both: one below it both
    raise ``CapacityError``, at it both run and agree."""
    kw = {"default_cap": 4096} if knob == "join_cap" else {}
    b = boundary(lambda c: port_fits(text, db, **kw, **{knob: c}))
    assert 1 < b < 4096
    run_both(text, db, **kw, **{knob: b - 1})
    t, _ = run_both(text, db, **kw, **{knob: b})
    assert t is not None
    with pytest.raises(JCapacityError):
        JEngine(text, db=db, **kw, **{knob: b - 1}).run()


def test_chunked_joins_match_one_expansion(monkeypatch):
    """Joins expanded in chunks of a few bindings (as G10K's 5 × 10^8-
    binding iteration is on the card) give the tables, iterations and
    generated of one expansion (which the tests above hold to JAX; TC here
    to JAX directly), and the join capacity still bounds the whole join,
    not a chunk: the least join capacity that fits is JAX's."""
    edges = edges_of(7, 14, 45)
    w = np.random.default_rng(7).integers(1, 8, len(edges))[:, None]
    programs = ((TC, {"arc": edges}), (TC_NL, {"arc": edges}),
                (SG, {"arc": edges}),
                (SPATH_NL, {"darc": np.concatenate([edges, w], 1)}),
                (ATTEND, {"friend": FRIEND,
                          "organizer": np.array([[0], [2]])}),
                (NEGATION, CASES_NEGATION_DB))
    whole = [TEngine(text, db=db, default_cap=1 << 14, device="cpu").run()
             for text, db in programs]
    monkeypatch.setattr(tengine, "JOIN_CHUNK", 5)
    for (text, db), one in zip(programs, whole):
        same_engine(TEngine(text, db=db, default_cap=1 << 14,
                            device="cpu").run(), one)
    b = boundary(lambda c: port_fits(TC, {"arc": edges}, default_cap=4096,
                                       join_cap=c))
    assert b > 5
    run_both(TC, {"arc": edges}, default_cap=4096, join_cap=b - 1)
    run_both(TC, {"arc": edges}, default_cap=4096, join_cap=b)


# -- run(warm=) ---------------------------------------------------------------


def test_warm_run_matches_jax():
    """An appended engine re-entered from the earlier model: the same table
    and the same (fewer) iterations as JAX's warm run."""
    edges = edges_of(8, 16, 40)
    base, extra = edges[:-6], edges[-6:]
    j0 = JEngine(TC, db={"arc": base}, default_cap=4096).run()
    t0 = TEngine(TC, db={"arc": base}, default_cap=4096, device="cpu").run()
    same_engine(t0, j0)
    j1 = JEngine(TC, db={"arc": edges}, default_cap=4096).run(
        warm={"tc": j0.materialized["tc"]})
    t1 = TEngine(TC, db={"arc": edges}, default_cap=4096, device="cpu").run(
        warm={"tc": t0.materialized["tc"]})
    same_engine(t1, j1)
    d = weighted(edges, 2)
    for eng_j, eng_t in ((JEngine(SPATH_LIN, db={"darc": d[:-6]}),
                          TEngine(SPATH_LIN, db={"darc": d[:-6]},
                                  device="cpu")),):
        eng_j.run(), eng_t.run()
        same_engine(eng_t, eng_j)
        w1j = JEngine(SPATH_LIN, db={"darc": d}).run(
            warm={"dpath": eng_j.materialized["dpath"]})
        w1t = TEngine(SPATH_LIN, db={"darc": d}, device="cpu").run(
            warm={"dpath": eng_t.materialized["dpath"]})
        same_engine(w1t, w1j)


def test_warm_run_refused_on_non_monotone_programs():
    with pytest.raises(JPlanError):
        JEngine(CPATH_EX5, db={"edge": np.array([[0, 1]])}).run(
            warm={"cpath": (np.zeros((0, 2)), np.zeros(0))})
    with pytest.raises(TPlanError):
        TEngine(CPATH_EX5, db={"edge": np.array([[0, 1]])}, device="cpu").run(
            warm={"cpath": (np.zeros((0, 2)), np.zeros(0))})


def test_domain_and_width_errors_match_jax():
    for eng in (JEngine, TEngine):
        kw = {} if eng is JEngine else {"device": "cpu"}
        with pytest.raises(ValueError, match="exceeds"):
            eng(TC, db={"arc": np.array([[0, 1 << 18]])}, **kw)
        with pytest.raises(ValueError, match="too wide"):
            eng("p(A,B,C,D) <- q(A,B,C,D).",
                db={"q": np.array([[1, 2, 3, 4]])}, bits=16, **kw).run()


# -- trace accounting ---------------------------------------------------------


def test_trace_count_deltas_match_jax():
    """A sequence of engine runs and asks moves the port's trace counter by
    JAX's deltas: cold, warm with another seed constant, an EDB across a
    ``quantize_rows`` bucket, full-model runs and qid batches; and after
    the runners are dropped, the next run traces again."""
    jengine.clear_runner_cache()
    tengine.clear_runner_cache()
    small, large = edges_of(20, 30, 14), edges_of(21, 30, 40)
    jeng = JEngine(TC, db={"arc": small}, default_cap=1000)
    teng = TEngine(TC, db={"arc": small}, default_cap=1000, device="cpu")
    jbig = JEngine(TC, db={"arc": large}, default_cap=1000)
    tbig = TEngine(TC, db={"arc": large}, default_cap=1000, device="cpu")
    steps = [
        lambda e, b: e.ask("tc", (1, None)),  # cold
        lambda e, b: e.ask("tc", (2, None)),  # warm: another constant
        lambda e, b: b.ask("tc", (1, None)),  # across a bucket
        lambda e, b: b.ask("tc", (3, None)),  # warm again
        lambda e, b: e.run(),  # full model, cold
        lambda e, b: e.invalidate().run(),  # and warm
        lambda e, b: e.ask_batch([("tc", (1, None)), ("tc", (2, None))]),
        lambda e, b: e.ask_batch([("tc", (4, None)), ("tc", (5, None))]),
    ]
    for i, step in enumerate(steps):
        j0, t0 = jengine.fixpoint_trace_count(), tengine.fixpoint_trace_count()
        step(jeng, jbig)
        step(teng, tbig)
        dj = jengine.fixpoint_trace_count() - j0
        dt = tengine.fixpoint_trace_count() - t0
        assert dt == dj, (i, dt, dj)
    jengine.clear_runner_cache()
    tengine.clear_runner_cache()
    j0, t0 = jengine.fixpoint_trace_count(), tengine.fixpoint_trace_count()
    jeng.ask("tc", (2, None))
    teng.ask("tc", (2, None))
    assert tengine.fixpoint_trace_count() - t0 == \
        jengine.fixpoint_trace_count() - j0 > 0


@pytest.mark.parametrize("sparse", [False, True])
def test_frontier_trace_count_deltas_match_jax(sparse):
    """The services' cached dense and CSR fixpoints count as JAX's jit
    caches do: a new padded batch shape traces, a warm one does not (an
    allocation no other test uses keeps the shapes fresh)."""
    from repro.service import DatalogService as JService
    from repro_torch.service import DatalogService as TService
    arcs = edges_of(30, 37, 90)
    kw = dict(n_align=37 + int(sparse), sparse=sparse, result_cache=0)
    jsvc = JService(TC, db={"arc": arcs}, **kw)
    tsvc = TService(TC, db={"arc": arcs}, device="cpu", **kw)
    deltas = []
    for batch in ([1], [2], [1, 2, 3], [4, 5], list(range(10))):
        qs = [("tc", (s, None)) for s in batch]
        j0, t0 = jengine.fixpoint_trace_count(), tengine.fixpoint_trace_count()
        jsvc.ask_batch(qs)
        tsvc.ask_batch(qs)
        deltas.append(tengine.fixpoint_trace_count() - t0)
        assert deltas[-1] == jengine.fixpoint_trace_count() - j0, batch
    assert deltas == [1, 0, 1, 0, 1]  # pads 1, 1, 8, 8, 32


# -- device -------------------------------------------------------------------


def test_engine_default_device_is_the_card(monkeypatch):
    """With no ``device=`` the engine runs on CUDA; without a GPU it raises
    instead of quietly running on the CPU."""
    if torch.cuda.is_available():  # make the GPU-less case on any host
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no usable GPU"):
        TEngine(TC, db={"arc": np.array([[0, 1]])})


def test_tables_live_on_the_engine_device():
    eng = TEngine(TC, db={"arc": np.array([[0, 1], [1, 2]])}, device="cpu")
    idx = eng._index("arc", (0,))
    assert idx.keys.device.type == "cpu" and idx.count == 2
    assert eng.run().query("tc").tolist() == [[0, 1], [0, 2], [1, 2]]


def test_iteration_hook_wraps_each_psn_iteration():
    """``Engine.iteration_hook(it)`` is entered around every PSN iteration,
    in order, and leaves the results as they were."""
    import contextlib
    seen = []

    @contextlib.contextmanager
    def hook(it):
        seen.append(it)
        yield

    arcs = edges_of(9, 12, 30)
    eng = TEngine(TC, db={"arc": arcs}, default_cap=4096, device="cpu")
    eng.iteration_hook = hook
    eng.run()
    plain = TEngine(TC, db={"arc": arcs}, default_cap=4096,
                    device="cpu").run()
    same_engine(eng, plain)
    assert seen == list(range(eng.stats["tc"].iterations))
