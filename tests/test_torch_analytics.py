"""Parity of the port's §4 analytics (``repro_torch.analytics``) and of the
k-core / effective-diameter halves of ``examples/graph_analytics_torch.py``
with the JAX package: the cases of ``tests/test_analytics.py`` (Tables 2
and 5, Example 9, naive Bayes on the paper's Table 1) and a seeded random
table, each fed to both packages and held to JAX's arrays exactly."""
import collections
import importlib.util
from pathlib import Path

import numpy as np
import pytest
from test_analytics import TABLE1

import repro.analytics as J
import repro_torch.analytics as T
from repro.core.engine import Engine as JEngine

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "graph_analytics_torch.py"


def random_table(rows=40, cards=(3, 4, 2, 3), seed=5):
    """A seeded categorical table; the last column is the label."""
    rng = np.random.default_rng(seed)
    return [[f"c{j}v{int(rng.integers(0, k))}" for j, k in enumerate(cards)]
            for _ in range(rows)]


@pytest.fixture(scope="module", params=["table1", "random"])
def both(request):
    """Verticalized tables and rollup prefix tables of both packages."""
    table = TABLE1 if request.param == "table1" else random_table()
    vj, vt = J.verticalize(table), T.verticalize(table)
    mj, _ = J.build_rollup_prefix_table(vj)
    mt, _ = T.build_rollup_prefix_table(vt, device="cpu")
    return table, vj, vt, mj, mt


def test_verticalize_matches_jax_and_table2(both):
    table, vj, vt, _, _ = both
    assert vt.rows.dtype == vj.rows.dtype
    assert np.array_equal(vt.rows, vj.rows)
    assert (vt.n_tuples, vt.n_cols) == (vj.n_tuples, vj.n_cols)
    assert [vt.symbols.name(i) for i in range(len(vt.symbols))] == \
        [vj.symbols.name(i) for i in range(len(vj.symbols))]
    first = vt.rows[vt.rows[:, 0] == 1]
    assert list(first[:, 1]) == list(range(1, len(table[0]) + 1))
    assert vt.symbols.name(int(first[0, 2]) - 1) == table[0][0]


def test_rollup_prefix_table_matches_jax_and_table5(both):
    table, vj, vt, mj, mt = both
    assert mt.dtype == mj.dtype and np.array_equal(mt, mj)
    cr = T.compact_rollup(mt, vt)
    assert cr == J.compact_rollup(mj, vj)
    assert len(set(mt[:, 0])) == len(mt)  # globally unique node ids
    if table is TABLE1:  # Table 5
        root = cr["root"]
        assert root["overcast"][0] == 4
        assert root["overcast"][1]["hot"][0] == 2
        assert root["overcast"][1]["hot"][1]["high"][0] == 1
        assert root["rain"][0] == 5 and root["sunny"][0] == 1
    # every root-to-node count is the number of rows with that prefix
    for row in table:
        node, depth = cr["root"], 0
        for cell in row:
            depth += 1
            count, node = node[cell]
            assert count == sum(r[:depth] == row[:depth] for r in table)


def _brute_longest(myrupt, k):
    items: dict = {}
    for r in myrupt:
        items[(r[1], r[2])] = items.get((r[1], r[2]), 0) + r[3]
    freq = {key for key, v in items.items() if v >= k}
    byparent: dict = {}
    for r in myrupt:
        byparent.setdefault(int(r[4]), []).append(r)

    def walk(node, col, acc):
        out = [acc]
        for r in byparent.get(node, []):
            if r[1] == col:
                out += walk(int(r[0]), col + 1,
                            acc + (1 if (r[1], r[2]) in freq else 0))
        return out

    return max(walk(1, 1, 0))


@pytest.mark.parametrize("k", [2, 4])
def test_longest_maximal_pattern_matches_jax(both, k):
    _, _, _, mj, mt = both
    got = T.longest_maximal_pattern(mt, k=k, device="cpu")
    assert got == J.longest_maximal_pattern(mj, k=k) == _brute_longest(mt, k)


def test_naive_bayes_matches_jax(both):
    table, vj, vt, _, _ = both
    mj, mt = J.naive_bayes_train(vj), T.naive_bayes_train(vt, device="cpu")
    assert mt == mj
    labels = collections.Counter(r[-1] for r in table)
    assert {vt.symbols.name(c - 1): n for c, n in mt["classes"].items()} == \
        dict(labels)
    for row in table:
        ex = {c + 1: vt.symbols.intern(v) + 1 for c, v in enumerate(row[:-1])}
        assert T.naive_bayes_predict(mt, ex) == J.naive_bayes_predict(mj, ex)
    if table is TABLE1:
        sym = vt.symbols
        ex = {1: sym.intern("overcast") + 1, 2: sym.intern("hot") + 1,
              3: sym.intern("normal") + 1, 4: sym.intern("weak") + 1}
        assert sym.name(T.naive_bayes_predict(mt, ex) - 1) == "yes"


def test_graph_analytics_example_matches_jax():
    """The example's k-core and effective-diameter halves against the same
    programs on the JAX engine; its dense half checks itself."""
    spec = importlib.util.spec_from_file_location("ga_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu"])
    arc = np.array([[a, b] for a in range(5) for b in range(5) if a != b]
                   + [[0, 5], [5, 0], [5, 6], [6, 5]])
    eng = JEngine("""
    degree(X, count<Y>) <- arc(X,Y).
    validArc(X,Y) <- arc(X,Y), degree(X,D1), D1 >= 4, degree(Y,D2), D2 >= 4.
    connComp(A,A) <- validArc(A,B).
    connComp(C,min<B>) <- connComp(A,B), validArc(A,C).
    kCores(A,B) <- connComp(A,B).
    """, db={"arc": arc}, default_cap=4096).run()
    assert out["k_core"] == sorted({int(r[0]) for r in eng.query("kCores")})
    path_arcs = np.array([[i, i + 1] for i in range(9)] +
                         [[i + 1, i] for i in range(9)])
    eng = JEngine("""
    hops(X,Y,min<H>) <- arc(X,Y), H = 1.
    hops(X,Z,min<H>) <- hops(X,Y,H1), arc(Y,Z), H = H1 + 1.
    """, db={"arc": path_arcs}, default_cap=1 << 14).run()
    _, vals = eng.query_agg("hops")
    assert out["hops"] == dict(collections.Counter(int(v) for v in vals))
    assert out["diameter"] == 7 and out["relax_matches"]
