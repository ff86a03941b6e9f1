"""Port parity of the service's tuple path under appends, against
``repro.service.DatalogService``: batched templates resume from their
fixpoint snapshots (``snapshot_lru`` of them), their cached answers
refresh, the resume policy (``resume_min_hits``) drops cold entries, and
the differential generator's tuple-path cases answer alike before and
after a monotone append.  Answers must be the same arrays (order, dtype);
the service counters (the port's extra ``fixpoint_iterations`` aside), the
cache counters and the template list equal."""
import numpy as np
import pytest

from test_torch_parity_cases import (DIFF_SHAPES, SG_Q, TC, batch_both,
                                     diff_case, same, same_report,
                                     service_pair)
from repro.core import ir as jir
from repro_torch.core import ir as tir
from repro_torch.core.engine import Engine as TEngine


def _gnp(n, p, seed):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    return np.argwhere(a).astype(np.int64)


@pytest.mark.parametrize("snapshot_lru", [1, 2])
def test_append_resumes_tuple_snapshots_like_jax(snapshot_lru):
    """Two batched ``sg`` batches, an append to the arcs: the snapshotted
    batches resume warm (``resumed_tuple_rows``), their cached answers
    refresh and equal JAX's and a cold engine's on the union; the rest of
    the cache drops as in JAX."""
    arcs = _gnp(20, 0.08, 3)
    base, extra = arcs[:-4], arcs[-4:]
    j, t = service_pair(SG_Q, {"arc": base}, default_cap=1 << 14,
                snapshot_lru=snapshot_lru)
    b1 = [f"sg({s}, X)" for s in (0, 2, 4)]
    b2 = [f"sg({s}, X)" for s in (1, 3)]
    batch_both(j, t, b1)
    batch_both(j, t, b2)
    j.append("arc", extra)
    t.append("arc", extra)
    same_report(t, j)
    assert t.stats.resumed_tuple_rows == (5 if snapshot_lru == 2 else 2)
    hits = t.cache.hits
    got = batch_both(j, t, b1 + b2)
    assert t.cache.hits - hits == t.stats.resumed_tuple_rows
    cold = TEngine(SG_Q, db={"arc": arcs}, default_cap=1 << 14,
                   device="cpu")
    for q, g in zip(b1 + b2, got):
        same(g, cold.ask(q))


def test_append_resume_policy_matches_jax():
    """``resume_min_hits``: cold entries drop (``dropped_cold``) instead of
    resuming; the hot ones resume."""
    arcs = _gnp(20, 0.1, 4)
    j, t = service_pair(TC, {"arc": arcs[:-3]}, default_cap=1 << 14, sparse=True,
                resume_min_hits=1)
    qs = [f"tc(X, {s})" for s in (1, 2, 3)]
    batch_both(j, t, qs)
    batch_both(j, t, qs[:1])  # one entry served a hit: hot
    j.append("arc", arcs[-3:])
    t.append("arc", arcs[-3:])
    same_report(t, j)
    batch_both(j, t, qs)


@pytest.mark.parametrize("case", [0, 5, 9])
def test_differential_service_paths_match_jax(case):
    """The differential generator's cases (nonlinear TC, same generation,
    mutual recursion: the tuple path's shapes) through both services: a batch,
    the same batch from the cache, then (on a prefix of the EDB) a batch,
    a monotone append of the tail and the batch again."""
    shape, text, db, jq = diff_case(case, jir.Literal, jir.Const, jir.Var)
    *_, tq = diff_case(case, tir.Literal, tir.Const, tir.Var)
    j, t = service_pair(text, db, default_cap=4096)
    for _ in range(2):
        for g, w in zip(t.ask_batch(tq), j.ask_batch(jq)):
            same(g, w)
        same_report(t, j)
    rel = DIFF_SHAPES[shape][2][0]
    k = 1 + case % 3
    base = dict(db)
    base[rel] = db[rel][:-k]
    j, t = service_pair(text, base, default_cap=4096)
    j.ask_batch(jq), t.ask_batch(tq)
    j.append(rel, db[rel][-k:])
    t.append(rel, db[rel][-k:])
    for g, w in zip(t.ask_batch(tq), j.ask_batch(jq)):
        same(g, w)
    same_report(t, j)
