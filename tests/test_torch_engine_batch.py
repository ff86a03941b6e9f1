"""Port parity of the tuple engine's batched and frontier query paths,
against ``repro.core.engine.Engine`` on the same inputs: ``?-`` goals in
the program text (one goal, and same-shape goals as one qid batch),
``ask_batch`` (one qid-tagged fixpoint, ``verify=True``, and the fall back
to sequential ``ask`` when the union of demands overflows), ``ask_dense``
on both carriers, the query-domain errors, and the pruning magic sets give
on a graph of disjoint paths.  Answers must be the same arrays (order,
dtype); the engines' ``stats`` equal."""
import numpy as np
import pytest

from test_torch_parity_cases import (
    DARC, SG_ARCS, SG_Q, SPATH, TC, TC_ARCS, ask_both, pair, same,
    same_stats)
from repro.core.engine import Engine as JEngine
from repro.core.planner import PlanError as JPlanError
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.planner import PlanError as TPlanError


def test_query_goals_in_program_text_match_jax():
    arcs = np.array([[1, 2], [2, 3], [0, 1], [5, 6]])
    j = JEngine(TC + "?- tc(0, X).", db={"arc": arcs}, default_cap=4096).run()
    t = TEngine(TC + "?- tc(0, X).", db={"arc": arcs}, default_cap=4096,
                device="cpu").run()
    same(t.query("tc"), j.query("tc"))
    assert t.plan.query_pred == j.plan.query_pred == "tc__bf"
    text = TC + "?- tc(1,X).\n?- tc(2,X)."
    j = JEngine(text, db={"arc": arcs}, default_cap=256).run()
    t = TEngine(text, db={"arc": arcs}, default_cap=256, device="cpu").run()
    for got, want in zip(t.batch_results(), j.batch_results()):
        same(got, want)
    same_stats(t, j)
    for eng, kw in ((JEngine, {}), (TEngine, {"device": "cpu"})):
        with pytest.raises(ValueError):
            eng(TC + "?- tc(1,X).\n?- tc(X,2).",
                db={"arc": np.array([[1, 2]])}, **kw)


def test_ask_batch_matches_jax():
    """Same-shape goals as ONE qid-tagged fixpoint (its stats are the
    batch's), mixed shapes and EDB goals alongside; ``verify=True``."""
    j, t = pair(TC, {"arc": TC_ARCS}, default_cap=4096)
    qs = [("tc", (s, None)) for s in (1, 4, 5, 9)] + \
        [("tc", (None, 3)), ("arc", (2, None)), ("tc", (0, 3))]
    for got, want in zip(t.ask_batch(qs, verify=True),
                         j.ask_batch(qs, verify=True)):
        same(got, want)
    same_stats(t, j)
    j, t = pair(SPATH, {"darc": DARC}, default_cap=4096)
    qs = [("dpath", (s, None, None)) for s in range(4)]
    for got, want in zip(t.ask_batch(qs), j.ask_batch(qs)):
        same(got, want)
    same_stats(t, j)


def test_ask_batch_capacity_fallback_matches_jax():
    """A cap each single ``ask`` fits but the union of the batch's demands
    overflows: both engines fall back to sequential asks, with the same
    answers and stats; at a cap that fits the union, one fixpoint."""
    arcs = np.array([[i, i + 1] for i in range(30)])
    qs = [("tc", (s, None)) for s in (0, 10, 20)]
    for cap in (40, 64, 128):
        j, t = pair(TC, {"arc": arcs}, default_cap=4096)
        got = t.ask_batch(qs, default_cap=cap)
        want = j.ask_batch(qs, default_cap=cap)
        for g, w in zip(got, want):
            same(g, w)
        same_stats(t, j)


def test_ask_dense_matches_jax():
    """The frontier lowering on both carriers: the same rows, values and
    dtypes as JAX's ``ask_dense``, its stats, and the tuple path's answer;
    an empty EDB; the refusals."""
    for sparse in (False, True):
        j, t = pair(TC, {"arc": TC_ARCS}, default_cap=4096)
        same(t.ask_dense("tc", (1, None), sparse=sparse),
             j.ask_dense("tc", (1, None), sparse=sparse))
        j, t = pair(SPATH, {"darc": DARC}, default_cap=4096)
        same(t.ask_dense("dpath", (0, None, None), sparse=sparse),
             j.ask_dense("dpath", (0, None, None), sparse=sparse))
        same_stats(t, j)
    j, t = pair(TC, {"arc": np.zeros((0, 2), np.int64)}, default_cap=64)
    same(t.ask_dense("tc", (1, None)), j.ask_dense("tc", (1, None)))
    ask_both(j, t, "tc", (1, None), verify=True)
    for eng in pair(SG_Q, {"arc": SG_ARCS}, default_cap=1024):
        err = JPlanError if isinstance(eng, JEngine) else TPlanError
        with pytest.raises(err):
            eng.ask_dense("sg", (0, None))
    for eng in pair(TC, {"arc": SG_ARCS}, default_cap=1024):
        err = JPlanError if isinstance(eng, JEngine) else TPlanError
        with pytest.raises(err):
            eng.ask_dense("tc", (None, 2))
    with pytest.raises(NotImplementedError, match="A.6c"):
        TEngine(TC, db={"arc": TC_ARCS}, device="cpu").ask_dense(
            "tc", (1, None), probe=True)


def test_query_domain_errors_match_jax():
    for eng in pair(TC, {"arc": np.array([[0, 1]])}, default_cap=64):
        with pytest.raises(ValueError):
            eng.ask("tc", (1 << 40, None))  # would truncate when packed
        err = JPlanError if isinstance(eng, JEngine) else TPlanError
        with pytest.raises(err):
            eng.ask("tc", (1,))  # wrong arity


def test_ask_prunes_work_matches_jax():
    """Magic sets prune generated facts on a graph of disjoint paths: the
    full model's and the restricted run's counters equal JAX's."""
    edges, v = [], 0
    for _ in range(300):
        for _ in range(5):
            edges.append((v, v + 1))
            v += 1
        v += 1
    j, t = pair(TC, {"arc": np.asarray(edges)}, default_cap=1 << 13,
                join_cap=1 << 13)
    j.run(), t.run()
    ask_both(j, t, "tc", (0, None))
    assert t.stats["tc__bf"].generated < t.stats["tc"].generated
