"""Port parity of the tuple engine on the differential generator of
``tests/test_differential.py`` (copied into
``test_torch_parity_cases.py``): random programs of fixed shapes (TC,
nonlinear TC, same generation, mutual recursion, ``min<>``, ``max<>`` and
``sum<>`` paths) over random EDBs, with
random constants and repeated variables in the goals, through the JAX
engine and the port's: the full model, magic ``ask``, the demanded-strata
``ask`` and the engine ``ask_batch`` give the same arrays and counters."""
import pytest

from test_torch_parity_cases import (DIFF_SHAPES, diff_case, pair, same,
                                     same_stats)
from repro.core import ir as jir
from repro_torch.core import ir as tir


@pytest.mark.parametrize("case", range(10))
def test_differential_engine_paths_match_jax(case):
    """The differential generator's cases through the full model, magic
    ``ask``, the demanded-strata ``ask`` and (every 3rd case) the engine
    ``ask_batch``: every answer the JAX engine's."""
    shape, text, db, jq = diff_case(case, jir.Literal, jir.Const, jir.Var)
    *_, tq = diff_case(case, tir.Literal, tir.Const, tir.Var)
    j, t = pair(text, db, default_cap=4096)
    j.run(), t.run()
    for pred in DIFF_SHAPES[shape][1]:
        same(t.materialized[pred], j.materialized[pred])
    same_stats(t, j)
    jd, td = pair(text, db, default_cap=4096, magic=False)
    jm, tm = pair(text, db, default_cap=4096)
    for a, b in zip(jq, tq):
        same(tm.ask(b), jm.ask(a))
        same(td.ask(b), jd.ask(a))
    same_stats(tm, jm)
    same_stats(td, jd)
    if case % 3 == 0:
        for got, want in zip(tm.ask_batch(tq), jm.ask_batch(jq)):
            same(got, want)
