"""Port parity of the tuple engine: ``repro_torch.core.engine.Engine`` (on
the CPU) against ``repro.core.engine.Engine`` on the same seeded inputs,
over the programs of ``tests/test_engine_datalog.py`` and
``tests/test_engines_agree.py`` (copied into
``test_torch_parity_cases.py``; those
files stay as they are): every materialized table equal (rows in the same
order and dtype, values too), and every group's ``iterations`` and
``generated``.  ``test_torch_engine_run.py`` holds the capacities, chunked
joins, warm runs, trace counts and the device; ``test_torch_engine_ask.py``
the query paths."""
import numpy as np
import pytest

from test_torch_parity_cases import (
    ATTEND, CASES_NEGATION_DB, CC, CPATH_EX5, FRIEND, HOPS, K4, KCORES, MUTUAL,
    NEGATION, SG, SPATH_LIN, SPATH_NL, TC, TC_NL, edges_of, run_both)
from repro.data.graphs import gnp_graph


# -- the programs of test_engine_datalog.py ----------------------------------

CASES = {
    "tc_example10": (TC, {"arc": np.array([[0, 1], [1, 2], [2, 3], [3, 1],
                                           [4, 0]])}, 4096),
    "spath_linear": (SPATH_LIN, {"darc": np.array([[0, 1, 4], [0, 2, 1],
                                                   [2, 1, 1], [1, 3, 2],
                                                   [3, 0, 7], [2, 3, 9]])},
                     4096),
    "spath_nonlinear": (SPATH_NL, {"darc": np.array([[0, 1, 4], [0, 2, 1],
                                                     [2, 1, 1], [1, 3, 2],
                                                     [3, 0, 7], [2, 3, 9]])},
                        4096),
    "spath_cycles": (SPATH_LIN, {"darc": np.array([[0, 1, 1], [1, 0, 1],
                                                   [1, 2, 5]])}, 1024),
    "sg_example11": (SG, {"arc": np.array([[0, 2], [0, 3], [1, 4], [1, 5],
                                           [2, 6], [3, 7], [4, 8]])}, 8192),
    "attend_example4": (ATTEND, {"friend": FRIEND,
                                 "organizer": np.array([[0], [2]])}, 4096),
    "cpath_example5": (CPATH_EX5, {"edge": np.array([[0, 1], [0, 2], [1, 3],
                                                     [2, 3], [3, 4]])}, 4096),
    "cpath_mixed_lengths": (CPATH_EX5, {"edge": np.array([[0, 1], [1, 2],
                                                          [0, 2], [2, 3]])},
                            4096),
    "kcores_example7": (KCORES, {"arc": K4}, 4096),
    "diameter_example6": (HOPS, {"arc": np.array([[0, 1], [1, 0], [1, 2],
                                                  [2, 1], [2, 3], [3, 2]])},
                          4096),
    "mutual_driver": (MUTUAL, {"e": np.array([[0, 1], [1, 2], [2, 3]])}, 2048),
    "negation": (NEGATION, CASES_NEGATION_DB, 1024),
    "tc_random": (TC, {"arc": edges_of(1, 10, 25)}, 2048),
    "tc_nonlinear_shuffle": (TC_NL, {"arc": edges_of(2, 12, 30)}, 4096),
    "tc_dup_rows": (TC, {"arc": np.concatenate(
        [edges_of(3, 9, 20), edges_of(3, 9, 20)[:5]])}, 2048),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_programs_match_jax(name):
    text, db, cap = CASES[name]
    t, _ = run_both(text, db, default_cap=cap)
    assert t is not None


# -- the programs of test_engines_agree.py, on seeded random graphs -----------


@pytest.mark.parametrize("seed", range(3))
def test_engines_agree_programs_match_jax(seed):
    edges = edges_of(10 + seed, 12, 30)
    w = np.random.default_rng(42 + seed).integers(1, 8, len(edges))
    run_both(TC, {"arc": edges}, default_cap=4096)
    run_both(SPATH_LIN, {"darc": np.concatenate([edges, w[:, None]], axis=1)},
             default_cap=8192)
    run_both(SG, {"arc": edges}, default_cap=1 << 15)
    run_both(CC, {"arc": np.concatenate([edges, edges[:, ::-1]])},
             default_cap=8192)


def test_generated_facts_accounting_matches_jax():
    for p in (0.02, 0.08):
        t, j = run_both(TC, {"arc": gnp_graph(60, p, seed=1)},
                        default_cap=1 << 14)
        assert t.stats["tc"].generated >= len(t.query("tc"))
