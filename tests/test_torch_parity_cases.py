"""Shared inputs and checks of the tuple-engine parity tests
(``test_torch_engine*.py``, ``test_torch_service_*.py``): the programs of
``tests/test_engine_datalog.py`` / ``test_engines_agree.py`` /
``test_magic.py`` and the generator of ``test_differential.py`` (copied;
those files stay as they are), and exact comparisons of the port's
answers, tables and counters with JAX's.  It holds no test of its own."""
import numpy as np
import pytest

from repro.core.engine import CapacityError as JCapacityError
from repro.core.engine import Engine as JEngine
from repro.service import DatalogService as JService
from repro_torch.core.engine import CapacityError as TCapacityError
from repro_torch.core.engine import Engine as TEngine
from repro_torch.service import DatalogService as TService

TC = """
tc(X,Y) <- arc(X,Y).
tc(X,Y) <- tc(X,Z), arc(Z,Y).
"""
TC_NL = """
tc(X,Y) <- arc(X,Y).
tc(X,Y) <- tc(X,Z), tc(Z,Y).
"""
SG = """
sg(X,Y) <- arc(P,X), arc(P,Y), X != Y.
sg(X,Y) <- arc(A,X), sg(A,B), arc(B,Y).
"""
SPATH_LIN = """
dpath(X,Z,min<D>) <- darc(X,Z,D).
dpath(X,Z,min<D>) <- dpath(X,Y,Dxy), darc(Y,Z,Dyz), D = Dxy + Dyz.
"""
SPATH_NL = """
dpath(X,Z,min<D>) <- darc(X,Z,D).
dpath(X,Z,min<D>) <- dpath(X,Y,D1), dpath(Y,Z,D2), D = D1 + D2.
"""
ATTEND = """
attend(X) <- organizer(X).
attend(X) <- cntfriends(X,N), N >= 2.
cntfriends(Y, count<X>) <- attend(X), friend(Y,X).
"""
CPATH_EX5 = """
cpath(X,Y,sum<C>) <- edge(X,Y), C = 1.
cpath(X,Z,sum<C>) <- cpath(X,Y,Cxy), edge(Y,Z), C = Cxy + 0.
"""
KCORES = """
degree(X, count<Y>) <- arc(X,Y).
validArc(X,Y) <- arc(X,Y), degree(X,D1), D1 >= 3, degree(Y,D2), D2 >= 3.
connComp(A,A) <- validArc(A,B).
connComp(C,min<B>) <- connComp(A,B), validArc(A,C).
kCores(A,B) <- connComp(A,B).
"""
HOPS = """
hops(X,Y,min<H>) <- arc(X,Y), H = 1.
hops(X,Z,min<H>) <- hops(X,Y,H1), arc(Y,Z), H = H1 + 1.
"""
MUTUAL = """
even(X,Y) <- e(X,Y).
even(X,Y) <- odd(X,Z), e(Z,Y).
odd(X,Y) <- even(X,Z), e(Z,Y).
"""
CC = """
cc(A,A) <- arc(A,B).
cc(C,min<B>) <- cc(A,B), arc(A,C).
"""
NEGATION = """
reach(X,Y) <- arc(X,Y).
reach(X,Y) <- reach(X,Z), arc(Z,Y).
indirect(X,Y) <- reach(X,Y), node(Y), ~arc(X,Y), X != Y.
lone(X) <- node(X), ~arc(X, 3).
"""

#: the EDB of the negation program
CASES_NEGATION_DB = {"arc": np.array([[0, 1], [1, 2], [2, 3], [3, 0]]),
                     "node": np.arange(6)[:, None]}
FRIEND = np.array([[1, 0], [2, 0], [1, 2], [2, 1], [3, 1], [3, 2], [4, 3],
                   [4, 1], [5, 4], [5, 3]])
K4 = np.array([[a, b] for a in range(4) for b in range(4) if a != b]
              + [[0, 4], [4, 0]])
TC_ARCS = np.array([[0, 1], [1, 2], [2, 3], [3, 1], [4, 0], [5, 6], [2, 5]])
SG_ARCS = np.array([[0, 2], [0, 3], [1, 4], [1, 5], [2, 6], [3, 7], [4, 8]])
DARC = np.array([[0, 1, 4], [0, 2, 1], [2, 1, 1], [1, 3, 2], [3, 0, 7],
                 [2, 3, 9], [5, 6, 2]])


def same(got, want):
    """Exactly the JAX answer: arrays of the same dtype, shape and values
    (a pair for aggregate predicates)."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape and np.array_equal(got, want), (got, want)


def same_engine(t, j):
    """Every materialized table and every group's counters equal."""
    assert t.materialized.keys() == j.materialized.keys()
    for pred, (jr, jv) in j.materialized.items():
        tr, tv = t.materialized[pred]
        same(tr, jr)
        assert (tv is None) == (jv is None)
        if jv is not None:
            same(tv, jv)
    same_stats(t, j)


def same_stats(t, j):
    """Every group's counters (iterations, generated) equal."""
    assert {k: (v.iterations, v.generated) for k, v in t.stats.items()} == \
        {k: (v.iterations, v.generated) for k, v in j.stats.items()}


def pair(text, db, **kw):
    """The JAX engine and the port's (on the CPU) over the same inputs."""
    return (JEngine(text, db=db, **kw),
            TEngine(text, db=db, device="cpu", **kw))


def ask_both(j, t, *args, **kw):
    """Both engines answer the same ``ask`` alike, with equal counters."""
    want = j.ask(*args, **kw)
    got = t.ask(*args, **kw)
    same(got, want)
    same_stats(t, j)
    return got


def service_pair(program, db, **kw):
    """The JAX service and the port's (on the CPU) over the same inputs."""
    return (JService(program, db=db, **kw),
            TService(program, db=db, device="cpu", **kw))


def same_report(t, j):
    """The service counters (the port's extra ``fixpoint_iterations``
    aside), the cache counters, the template list and the epoch equal."""
    trep, jrep = t.explain(), j.explain()
    trep["service"].pop("fixpoint_iterations")
    assert trep["service"] == jrep["service"]
    assert trep["cache"] == jrep["cache"]
    assert trep["templates"] == jrep["templates"]
    assert t.epoch == j.epoch


def batch_both(j, t, queries):
    """Each service answers the batch (its own IR for Literal goals)."""
    want = j.ask_batch(queries)
    got = t.ask_batch(queries)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        same(g, w)
    same_report(t, j)
    return got


def run_both(text, db, **kw):
    """Both engines run (or both raise CapacityError); returns them."""
    try:
        j = JEngine(text, db=db, **kw).run()
    except JCapacityError:
        with pytest.raises(TCapacityError):
            TEngine(text, db=db, device="cpu", **kw).run()
        return None, None
    t = TEngine(text, db=db, device="cpu", **kw).run()
    same_engine(t, j)
    return t, j


def edges_of(seed, n, m):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, n, (m, 2)), axis=0)


def weighted(edges, w=1):
    return np.concatenate([edges, np.full((len(edges), 1), w, np.int64)], 1)




def boundary(fits, hi=4096):
    """The least value in [1, hi] for which ``fits`` holds (bisection)."""
    lo = 1
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if fits(mid) else (mid + 1, hi)
    return lo


def port_fits(text, db, **kw):
    """Does the port's engine run ``text`` without a CapacityError?"""
    try:
        TEngine(text, db=db, device="cpu", **kw).run()
        return True
    except TCapacityError:
        return False


SG_Q = """
sg(X,Y) <- arc(P,X), arc(P,Y), X != Y.
sg(X,Y) <- arc(A,X), sg(A,B), arc(B,Y).
"""
SPATH = """
dpath(X,Z,min<D>) <- darc(X,Z,D).
dpath(X,Z,min<D>) <- dpath(X,Y,Dxy), darc(Y,Z,Dyz), D = Dxy + Dyz.
spath(X,Z,D) <- dpath(X,Z,D).
"""

# the differential generator of tests/test_differential.py (copied): random
# programs of fixed shapes over random EDBs, with random constants and
# repeated variables in the goals
DIFF_SHAPES = {
    "tc": ("tc(X,Y) <- e(X,Y).\n"
           "tc(X,Y) <- tc(X,Z), e(Z,Y).", ["tc"], ("e",)),
    "tc_nl": ("tc(X,Y) <- e(X,Y).\n"
              "tc(X,Y) <- tc(X,Z), tc(Z,Y).", ["tc"], ("e",)),
    "sg": ("sg(X,Y) <- e(P,X), e(P,Y), X != Y.\n"
           "sg(X,Y) <- e(A,X), sg(A,B), e(B,Y).", ["sg"], ("e",)),
    "mutual": ("p(X,Y) <- e(X,Y).\n"
               "p(X,Y) <- q(X,Z), e(Z,Y).\n"
               "q(X,Y) <- f(X,Y).\n"
               "q(X,Y) <- p(X,Z), f(Z,Y).", ["p", "q"], ("e", "f")),
    "dpath": ("dpath(X,Z,min<D>) <- w(X,Z,D).\n"
              "dpath(X,Z,min<D>) <- dpath(X,Y,D1), w(Y,Z,D2), D = D1 + D2.",
              ["dpath"], ("w",)),
    "cpath": ("cpath(X,Z,sum<C>) <- d(X,Z,C).\n"
              "cpath(X,Z,sum<C>) <- cpath(X,Y,C1), d(Y,Z,C2), C = C1 * C2.",
              ["cpath"], ("d",)),
    "lpath": ("lpath(X,Z,max<D>) <- d(X,Z,D).\n"
              "lpath(X,Z,max<D>) <- lpath(X,Y,D1), d(Y,Z,D2), D = D1 + D2.",
              ["lpath"], ("d",)),
}
DIFF_N = 7  # vertex domain [0, N)
DIFF_ARITY = {"tc": 2, "sg": 2, "p": 2, "q": 2, "dpath": 3, "cpath": 3,
              "lpath": 3}
DIFF_AGG_POS = {"dpath": 2, "cpath": 2, "lpath": 2}


def diff_case(case: int, lit_cls, const_cls, var_cls):
    """Deterministic random (shape, program, db, queries) for one case
    index, with goals built from the given package's IR classes (the same
    draws for either package)."""
    import random
    rng = random.Random(case)
    shape = rng.choice(sorted(DIFF_SHAPES))
    text, preds, rels = DIFF_SHAPES[shape]
    db = {}
    for rel in rels:
        if rel == "d":  # acyclic weighted arcs (src < dst), duplicates kept
            rows = []
            for _ in range(12):
                a, b = sorted(rng.sample(range(DIFF_N), 2))
                rows.append([a, b, rng.randint(1, 3)])
        elif rel == "w":
            rows = [[rng.randrange(DIFF_N), rng.randrange(DIFF_N),
                     rng.randint(1, 6)] for _ in range(12)]
        else:
            rows = [[rng.randrange(DIFF_N), rng.randrange(DIFF_N)]
                    for _ in range(12)]
        db[rel] = np.asarray(rows, np.int64)
    queries = []
    for _ in range(rng.randint(4, 7)):
        pred = rng.choice(preds)
        args = []
        for i in range(DIFF_ARITY[pred]):
            p_const = 0.2 if i == DIFF_AGG_POS.get(pred) else 0.45
            if rng.random() < p_const:
                args.append(const_cls(rng.randrange(DIFF_N + 1)))
            else:
                args.append(var_cls(rng.choice(["X", "Y", "Z"])))
        queries.append(lit_cls(pred, tuple(args)))
    return shape, text, db, queries
