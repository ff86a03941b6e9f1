"""Port parity of the service's tuple path: ``repro_torch.service.
DatalogService`` (on the CPU) answers every query that lowers to no
frontier as ``repro.service.DatalogService`` does, through memoized
templates over the tuple engine: same-shape queries as one qid-tagged
fixpoint, the fall back to one query at a time, the demanded-strata
templates, result caching, and the snapshots' serialized form
(``test_torch_service_resume.py`` holds the appends).  Answers
must be the same arrays (order, dtype); the service counters
(``explain()["service"]``, the port's extra ``fixpoint_iterations``
aside), the cache counters and the template list equal."""
import numpy as np

from test_torch_parity_cases import (ATTEND, FRIEND, K4, KCORES, SG_Q, TC,
                                     batch_both, same, service_pair)
from repro.core import ir as jir
from repro.service import incremental as jinc
from repro_torch.core import ir as tir
from repro_torch.service import incremental as tinc

#: TC whose exit rule carries a comparison: no frontier lowering, so
#: ``tc(s, X)`` takes the tuple path
GUARDED_TC = """
tc(X,Y) <- arc(X,Y), Y != 999.
tc(X,Y) <- tc(X,Z), arc(Z,Y).
"""
NEGATION = """
reach(X,Y) <- arc(X,Y).
reach(X,Y) <- reach(X,Z), arc(Z,Y).
indirect(X,Y) <- reach(X,Y), node(Y), ~arc(X,Y), X != Y.
"""


def _gnp(n, p, seed):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    return np.argwhere(a).astype(np.int64)


def test_sg_and_bound_second_argument_batches_match_jax():
    """``sg(s, X)`` batches as one qid-tagged fixpoint, ``tc(X, s)`` goes
    through its template; a repeat is served from the cache."""
    arcs = _gnp(24, 0.08, 1)
    j, t = service_pair(SG_Q + TC, {"arc": arcs}, default_cap=1 << 14)
    qs = [f"sg({s}, X)" for s in (0, 3, 5, 7)] + \
        [f"tc(X, {s})" for s in (2, 4)] + ["tc(X, Y)", "arc(1, X)"]
    batch_both(j, t, qs)
    assert t.stats.tuple_fixpoints == 1 and t.stats.tuple_batched_queries == 4
    h = t.cache.hits
    batch_both(j, t, qs)
    assert t.cache.hits == h + len(qs) - 1  # the EDB selection is not cached


def test_count_cascade_negation_and_demand_templates_match_jax():
    j, t = service_pair(ATTEND, {"friend": FRIEND, "organizer": np.array([[0], [2]])},
                default_cap=4096)
    batch_both(j, t, ["attend(1)", "attend(5)", "attend(9)", "attend(X)",
                      "cntfriends(X, N)"])
    j, t = service_pair(NEGATION, {"arc": _gnp(10, 0.15, 2),
                           "node": np.arange(10)[:, None]}, default_cap=4096)
    batch_both(j, t, ["indirect(0, X)", "indirect(3, X)", "indirect(X, 4)"])
    j, t = service_pair(KCORES, {"arc": K4}, default_cap=4096)  # demand mode
    batch_both(j, t, ["connComp(2, B)", "connComp(4, B)", "kCores(X, Y)"])


def test_batch_capacity_fallback_matches_jax():
    """A cap the union of a batch's demands overflows: both services run
    the queries one by one (the same counters), with the same answers."""
    arcs = np.array([[i, i + 1] for i in range(30)])
    for cap, batched in ((40, False), (64, True)):
        j, t = service_pair(GUARDED_TC, {"arc": arcs}, default_cap=cap)
        batch_both(j, t, [f"tc({s}, X)" for s in (0, 10, 20)])
        assert t.stats.tuple_fixpoints == int(batched)


def test_tuple_snapshot_state_round_trip_matches_jax():
    """``snapshot_to_state`` writes JAX's arrays and meta, and
    ``snapshot_from_state`` reads either package's back."""
    seeds = np.array([[0, 3], [1, 5]], np.int64)
    state = {"sg__bf": (np.array([[0, 3, 4]], np.int32), None),
             "m__sg__bf": (np.array([[0, 3], [1, 5]], np.int32), None),
             "d__bff": (np.array([[1, 2, 3]], np.int32),
                        np.array([7], np.int32))}
    snaps = [mod.TupleSnapshot(seeds=seeds, qlits=[
        ir.Literal("sg", (ir.Const(3), ir.Var("X"))),
        ir.Literal("sg", (ir.Const(5), ir.Var("Y")))], state=state)
        for mod, ir in ((jinc, jir), (tinc, tir))]
    out = []
    for mod, snap in zip((jinc, tinc), snaps):
        arrays = {}
        meta = mod.snapshot_to_state(snap, arrays.__setitem__)
        out.append((meta, arrays))
    assert out[0][0] == out[1][0]
    assert out[0][1].keys() == out[1][1].keys()
    for k in out[0][1]:
        same(out[1][1][k], out[0][1][k])
    back = tinc.snapshot_from_state(out[0][0], out[0][1].__getitem__)
    assert [tinc.literal_to_json(q) for q in back.qlits] == \
        [jinc.literal_to_json(q) for q in snaps[0].qlits]
    for p, (rows, vals) in state.items():
        same(back.state[p][0], rows)
    assert tinc.resumable_program(tir.Program([])) is True
