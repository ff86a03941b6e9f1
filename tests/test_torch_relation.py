"""Port parity of the packed-table substrate: ``repro_torch.core.relation``
against ``repro.core.relation`` on the same numpy inputs (the cases of
``tests/test_relation.py``): pack/unpack, union/difference, the overflow
flag and the keys a table keeps past it, ``AggTable`` aggregation (int32
wrap included), ``merge`` deltas and increments, ``lookup``,
``expand_join`` and ``hash32``; and the tuple half of ``seminaive``
(``build_edb_index``, ``join_edb``, ``join_idb_prefix``,
``pack_warm_rows``).  The port's tables hold exactly their keys;
JAX's are ``EMPTY``-padded to capacity, so its keys are compared up to its
count."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import relation as jrel
from repro.core import seminaive as jsn
from repro_torch.core import relation as trel
from repro_torch.core import seminaive as tsn


def _rows(seed, n, hi=200, width=2):
    return np.random.default_rng(seed).integers(0, hi, (n, width))


def _keys_equal(tt, jt):
    """A port table's keys equal a JAX table's valid keys, and the counts."""
    n = int(jt.count)
    assert tt.count == n
    assert np.array_equal(tt.keys.numpy(), np.asarray(jt.keys)[:n])


@pytest.mark.parametrize("seed,n", [(0, 0), (1, 1), (2, 60), (3, 128)])
def test_pack_unpack_roundtrip(seed, n):
    schema_j, schema_t = jrel.Schema((10, 10)), trel.Schema((10, 10))
    rows = _rows(seed, n) if n else np.zeros((0, 2), np.int64)
    jt = jrel.FactTable.from_numpy(rows, schema_j, 128)
    tt = trel.FactTable.from_numpy(rows, schema_t, 128, device="cpu")
    _keys_equal(tt, jt)
    want, got = jt.to_numpy(schema_j), tt.to_numpy(schema_t)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    cols = [torch.from_numpy(rows[:, i]) for i in range(2)]
    assert np.array_equal(schema_t.pack(cols).numpy(),
                          np.asarray(schema_j.pack([jnp.asarray(rows[:, i])
                                                    for i in range(2)])))


def test_schema_too_wide_raises():
    for mod in (jrel, trel):
        with pytest.raises(ValueError, match="too wide"):
            mod.Schema((21, 21, 21))


@pytest.mark.parametrize("seed", range(6))
def test_union_difference_match_jax(seed):
    schema_j, schema_t = jrel.Schema((10, 10)), trel.Schema((10, 10))
    a, b = _rows(seed, 40, hi=12), _rows(seed + 100, 50, hi=12)
    ja = jrel.FactTable.from_numpy(a, schema_j, 256)
    jb = jrel.FactTable.from_numpy(b, schema_j, 256)
    ta = trel.FactTable.from_numpy(a, schema_t, 256, device="cpu")
    tb = trel.FactTable.from_numpy(b, schema_t, 256, device="cpu")
    _keys_equal(ta.union(tb), ja.union(jb))
    _keys_equal(ta.difference(tb), ja.difference(jb))
    probe = trel.FactTable.from_numpy(b, schema_t, 256, device="cpu").keys
    assert np.array_equal(ta.member(probe).numpy(),
                          np.asarray(ja.member(jnp.asarray(probe.numpy()))))


@pytest.mark.parametrize("cap", [32, 49, 50, 64])
def test_overflow_flagged_not_silent(cap):
    """Both flag an overflow at the same capacities and keep the same
    (smallest) keys; a union into a smaller capacity overflows too."""
    schema_j, schema_t = jrel.Schema((10, 10)), trel.Schema((10, 10))
    rows = np.array([[i, i] for i in range(50)])
    jt = jrel.FactTable.from_numpy(rows, schema_j, cap)
    tt = trel.FactTable.from_numpy(rows, schema_t, cap, device="cpu")
    assert tt.overflow == bool(jt.overflow) == (cap < 50)
    _keys_equal(tt, jt)
    ju = jt.union(jrel.FactTable.from_numpy(rows + 1, schema_j, cap))
    tu = tt.union(trel.FactTable.from_numpy(rows + 1, schema_t, cap,
                                            device="cpu"))
    assert tu.overflow == bool(ju.overflow)
    _keys_equal(tu, ju)


@pytest.mark.parametrize("kind", ["min", "max", "sum", "count"])
@pytest.mark.parametrize("seed", range(3))
def test_aggtable_from_numpy_matches_jax(kind, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 31, (80, 1))
    vals = rng.integers(-50, 51, 80)
    jt = jrel.AggTable.from_numpy(keys, vals, jrel.Schema((10,)), 256, kind)
    tt = trel.AggTable.from_numpy(keys, vals, trel.Schema((10,)), 256, kind,
                                  device="cpu")
    jr, jv = jt.to_numpy(jrel.Schema((10,)))
    tr, tv = tt.to_numpy(trel.Schema((10,)))
    assert np.array_equal(tr, jr) and tv.dtype == jv.dtype
    assert np.array_equal(tv, jv)


def test_aggtable_sum_wraps_as_int32():
    """Sums wrap as int32 sums do in JAX (the value column is int32)."""
    keys = np.array([[1], [1], [2]])
    vals = np.array([2 ** 31 - 10, 100, 7], np.int32)
    jt = jrel.AggTable.from_numpy(keys, vals, jrel.Schema((10,)), 8, "sum")
    tt = trel.AggTable.from_numpy(keys, vals, trel.Schema((10,)), 8, "sum",
                                  device="cpu")
    assert np.array_equal(tt.to_numpy(trel.Schema((10,)))[1],
                          jt.to_numpy(jrel.Schema((10,)))[1])
    assert int(tt.values[0]) < 0


@pytest.mark.parametrize("kind", ["min", "max", "sum", "count"])
@pytest.mark.parametrize("seed", range(3))
def test_aggtable_merge_deltas_and_increments(kind, seed):
    """``merge`` returns the same table and delta as JAX: the changed keys,
    their totals, and for sum/count the increments (new - old) in
    ``incs``."""
    rng = np.random.default_rng(seed)
    base_k = rng.choice(40, 15, replace=False)[:, None]
    base_v = rng.integers(-20, 21, 15)
    jt = jrel.AggTable.from_numpy(base_k, base_v, jrel.Schema((10,)), 64, kind)
    tt = trel.AggTable.from_numpy(base_k, base_v, trel.Schema((10,)), 64, kind,
                                  device="cpu")
    new_k = rng.integers(0, 40, 30)
    new_v = rng.integers(-20, 21, 30).astype(np.int32)
    if seed == 0:  # one pair equal to the old value: no change, no delta
        new_k[0], new_v[0] = base_k[0, 0], base_v[0]
    jk = jrel.Schema((10,)).pack([jnp.asarray(new_k)])
    tk = trel.Schema((10,)).pack([torch.from_numpy(new_k)])
    j2, jd = jt.merge(jk, jnp.asarray(new_v))
    t2, td = tt.merge(tk, torch.from_numpy(new_v))
    for t, j in ((t2, j2), (td, jd)):
        n = int(j.count)
        assert t.count == n and t.kind == j.kind
        assert np.array_equal(t.keys.numpy(), np.asarray(j.keys)[:n])
        assert np.array_equal(t.values.numpy(), np.asarray(j.values)[:n])
        assert np.array_equal(t.incs.numpy(), np.asarray(j.incs)[:n])
    hit_t, val_t = t2.lookup(tk)
    hit_j, val_j = j2.lookup(jk)
    assert np.array_equal(hit_t.numpy(), np.asarray(hit_j))
    assert np.array_equal(val_t.numpy(), np.asarray(val_j))


def test_aggtable_delta_is_changed_keys():
    schema = trel.Schema((10,))
    t = trel.AggTable.from_numpy(np.array([[1], [2]]), np.array([5, 7]),
                                 schema, 64, "min", device="cpu")
    _, delta = t.merge(schema.pack([torch.tensor([1, 2, 3])]),
                       torch.tensor([9, 3, 4], dtype=torch.int32))
    rows, vals = delta.to_numpy(schema)
    assert {int(r[0]): int(v) for r, v in zip(rows, vals)} == {2: 3, 3: 4}


def test_aggtable_merge_overflow_matches_jax():
    schema_j, schema_t = jrel.Schema((10,)), trel.Schema((10,))
    keys = np.arange(10)[:, None]
    jt = jrel.AggTable.from_numpy(keys, np.arange(10), schema_j, 12, "sum")
    tt = trel.AggTable.from_numpy(keys, np.arange(10), schema_t, 12, "sum",
                                  device="cpu")
    extra = np.arange(5, 15)
    j2, _ = jt.merge(schema_j.pack([jnp.asarray(extra)]),
                     jnp.ones(10, jnp.int32))
    t2, _ = tt.merge(schema_t.pack([torch.from_numpy(extra)]),
                     torch.ones(10, dtype=torch.int32))
    assert t2.overflow and bool(j2.overflow)
    assert np.array_equal(t2.keys.numpy(), np.asarray(j2.keys))
    assert np.array_equal(t2.values.numpy(), np.asarray(j2.values))


@pytest.mark.parametrize("out_cap", [1024, 40, 7])
@pytest.mark.parametrize("seed", range(3))
def test_expand_join_matches_jax(out_cap, seed):
    """The same (probe, build) pairs in the same order (probe order, then
    build order), the invalid probes skipped, and ``overflow`` where the
    total exceeds the output capacity (the first pairs kept)."""
    rng = np.random.default_rng(seed)
    probe = rng.integers(0, 10, 40).astype(np.int64)
    valid = rng.random(40) < 0.8
    build = np.sort(rng.integers(0, 10, 30).astype(np.int64))
    jpi, jbi, jv, jo = jrel.expand_join(jnp.asarray(probe), jnp.asarray(valid),
                                        jnp.asarray(build), jnp.asarray(25),
                                        out_cap)
    tpi, tbi, tv, to = trel.expand_join(torch.from_numpy(probe),
                                        torch.from_numpy(valid),
                                        torch.from_numpy(build), 25, out_cap)
    jv = np.asarray(jv)
    assert to == bool(jo) and bool(tv.all())
    assert np.array_equal(tpi.numpy(), np.asarray(jpi)[jv])
    assert np.array_equal(tbi.numpy(), np.asarray(jbi)[jv])


def test_expand_join_vs_nested_loop():
    rng = np.random.default_rng(0)
    probe = rng.integers(0, 10, 40).astype(np.int64)
    build = np.sort(rng.integers(0, 10, 30).astype(np.int64))
    pi, bi, valid, ovf = trel.expand_join(
        torch.from_numpy(probe), torch.ones(40, dtype=torch.bool),
        torch.from_numpy(build), 30, 1024)
    got = {(int(p), int(b)) for p, b in zip(pi, bi)}
    want = {(i, j) for i, p in enumerate(probe) for j, b in enumerate(build)
            if p == b}
    assert got == want and not ovf


@pytest.mark.parametrize("n", [1, 7, 64])
def test_hash32_matches_jax(n):
    x = np.concatenate([np.arange(1000), [2 ** 40 + 3, 2 ** 62 - 1]])
    want = np.asarray(jrel.hash32(jnp.asarray(x, jnp.int64), n))
    got = trel.hash32(torch.from_numpy(x), n).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    counts = np.bincount(got[:1000], minlength=n)
    assert counts.min() > 1000 // n // 2  # roughly balanced


# -- the tuple half of seminaive: indexes, joins, warm rows -------------------


@pytest.mark.parametrize("n,floor", [(0, 8), (5, 8), (37, 8), (37, 64)])
def test_build_edb_index_matches_jax(n, floor):
    """The same sorted keys and gathered columns (up to JAX's count) and
    the JAX bucket as ``bucket``."""
    rows = _rows(n, n, hi=50, width=3) if n else np.zeros((0, 3), np.int64)
    j = jsn.build_edb_index(rows, (2, 0), 10, minimum=floor)
    t = tsn.build_edb_index(rows, (2, 0), 10, minimum=floor, device="cpu")
    c = int(j.count)
    assert t.count == c and t.bucket == j.keys.shape[0]
    assert np.array_equal(t.keys.numpy(), np.asarray(j.keys)[:c])
    assert len(t.cols) == len(j.cols)
    for tc, jc in zip(t.cols, j.cols):
        assert tc.dtype == torch.int32
        assert np.array_equal(tc.numpy(), np.asarray(jc)[:c])


def _bindings(mod, cols, valid):
    if mod is jsn:
        return jsn.Bindings({k: jnp.asarray(v) for k, v in cols.items()},
                            jnp.asarray(valid), jnp.zeros((), bool))
    return tsn.Bindings({k: torch.from_numpy(v) for k, v in cols.items()},
                        torch.from_numpy(valid))


@pytest.mark.parametrize("out_cap", [4096, 30])
def test_join_edb_and_idb_prefix_match_jax(out_cap):
    """The joins' live bindings, in JAX's order, with a constant probe, and
    the overflow flag past ``out_cap``."""
    rng = np.random.default_rng(3)
    arcs = np.unique(rng.integers(0, 12, (40, 2)), axis=0)
    cols = {"X": rng.integers(0, 12, 25).astype(np.int32),
            "Z": rng.integers(0, 12, 25).astype(np.int32)}
    valid = rng.random(25) < 0.8
    outs = []
    for mod in (jsn, tsn):
        kw = {} if mod is jsn else {"device": "cpu"}
        idx = mod.build_edb_index(arcs, (0,), 10, **kw)
        b = _bindings(mod, cols, valid)
        e = mod.join_edb(b, idx, ("Z",), (0,), {"Y": 1}, 10, out_cap)
        c = mod.join_edb(b, idx, (3,), (0,), {"Y": 1}, 10, out_cap)
        schema = (jrel if mod is jsn else trel).Schema((10, 10))
        keys = schema.pack([arcs[:, 0], arcs[:, 1]]) if mod is jsn else \
            schema.pack([torch.from_numpy(arcs[:, 0]),
                         torch.from_numpy(arcs[:, 1])])
        vals = (jnp if mod is jsn else torch).arange(len(arcs))
        p = mod.join_idb_prefix(b, keys, len(arcs), ("Z",), schema, 1, vals,
                                {"Y": 1, "V": "value"}, out_cap)
        outs.append((e, c, p))
    for jb, tb in zip(*outs):
        live = np.asarray(jb.valid)
        assert tb.overflow == bool(jb.overflow)
        assert sorted(tb.cols) == sorted(jb.cols)
        for k in jb.cols:
            assert np.array_equal(tb.cols[k].numpy(),
                                  np.asarray(jb.cols[k])[live])


@pytest.mark.parametrize("n,agg", [(0, None), (5, None), (9, "min")])
def test_pack_warm_rows_matches_jax(n, agg):
    rows = _rows(n + 10, n, hi=100) if n else np.zeros((0, 2), np.int64)
    vals = np.arange(n, dtype=np.int32) if agg else None
    init = int(jrel._MERGE_INIT["min"]) if agg else None
    jk, jv = jsn.pack_warm_rows(rows, vals, jrel.Schema((10, 10)), init)
    tk, tv = tsn.pack_warm_rows(rows, vals, trel.Schema((10, 10)), init,
                                device="cpu")
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert (tv is None) == (jv is None)
    if jv is not None:
        assert np.array_equal(tv.numpy(), np.asarray(jv))
    for mod, schema in ((jsn, jrel.Schema((6, 6))),
                        (tsn, trel.Schema((6, 6)))):
        kw = {} if mod is jsn else {"device": "cpu"}
        with pytest.raises(ValueError, match="packed domain"):
            mod.pack_warm_rows(np.array([[70, 1]]), None, schema, **kw)
