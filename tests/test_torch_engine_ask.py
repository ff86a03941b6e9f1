"""Port parity of the tuple engine's ``ask``, against
``repro.core.engine.Engine`` on the same inputs: magic sets, the
``magic=False`` demanded-strata fallback and ``verify=True``, over TC (both
arguments bound or free, repeated variables, out-of-domain constants), same
generation, ``min<>`` paths and their projection, mutual recursion, a
``count<>`` cascade, k-cores (whose magic rewrite breaks PreM, so ``ask``
falls back) and facts guarded by magic.  ``test_torch_engine_batch.py``
holds ``ask_batch``, ``?-`` goals and ``ask_dense``;
``test_torch_engine_diff.py`` the differential generator's cases.  Answers
must be the same arrays (order, dtype); the engines' ``stats``
(iterations, generated per predicate) equal."""
import numpy as np
import pytest

from test_torch_parity_cases import (
    ATTEND, DARC, FRIEND, K4, KCORES, MUTUAL, SG_ARCS, SG_Q, SPATH, TC,
    TC_ARCS, ask_both, pair, same)


@pytest.mark.parametrize("magic", [True, False])
def test_ask_tc_matches_jax(magic):
    """Bound first argument (the magic rewrite), bound second (an all-free
    sub-evaluation), both bound, repeated variables, out-of-domain
    constants; with ``magic=False`` the demanded-strata fallback."""
    j, t = pair(TC, {"arc": TC_ARCS}, default_cap=4096, magic=magic)
    for args in ((1, None), (None, 5), (0, 2), (0, 6), (9, None)):
        ask_both(j, t, "tc", args, verify=True)
    ask_both(j, t, "tc(X, X)")
    ask_both(j, t, "arc", (2, None))  # an EDB query: a selection


def test_ask_sg_spath_mutual_match_jax():
    j, t = pair(SG_Q, {"arc": SG_ARCS}, default_cap=8192)
    ask_both(j, t, "sg", (2, None))
    ask_both(j, t, "sg", (None, 7))
    j, t = pair(SPATH, {"darc": DARC}, default_cap=4096)
    ask_both(j, t, "dpath", (0, None, None))
    ask_both(j, t, "spath", (0, None, None))
    ask_both(j, t, "dpath", (None, 3, None))
    j, t = pair(MUTUAL, {"e": np.array([[0, 1], [1, 2], [2, 3], [7, 8]])},
                default_cap=2048)
    ask_both(j, t, "odd", (0, None))
    ask_both(j, t, "even", (7, None))


def test_ask_count_cascade_and_kcores_fallback_match_jax():
    """A count<> cascade through recursion, and the k-cores program whose
    magic rewrite breaks PreM (so ``ask`` falls back to demanded strata)."""
    j, t = pair(ATTEND, {"friend": FRIEND, "organizer": np.array([[0], [2]])},
                default_cap=4096)
    for who in (1, 5, 9):
        ask_both(j, t, "attend", (who,))
    j, t = pair(KCORES, {"arc": K4}, default_cap=4096)
    ask_both(j, t, "connComp", (2, None))
    ask_both(j, t, "kCores", (4, None))


def test_ask_guards_and_magic_prefix_match_jax():
    prog = """
    tc(5,6).
    tc(X,Y) <- arc(X,Y).
    tc(X,Y) <- tc(X,Z), arc(Z,Y).
    """
    j, t = pair(prog, {"arc": np.array([[0, 1], [1, 2]])}, default_cap=1024)
    ask_both(j, t, "tc", (1, None))
    ask_both(j, t, "tc", (5, None))
    prog = """
    p(Y) <- X = 1, q(X, Y).
    q(A,B) <- arc(A,B).
    q(A,B) <- q(A,C), arc(C,B).
    """
    j, t = pair(prog, {"arc": np.array([[1, 2], [2, 3], [7, 8]])},
                default_cap=1024)
    ask_both(j, t, "p", (2,))
    ask_both(j, t, "p", (8,))
