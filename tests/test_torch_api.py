"""Port parity of the JAX package's public API (ROADMAP rule (c)): one kwargs
dict of every ``repro.service.DatalogService`` keyword builds both services,
which then answer alike; the dense frontier names ``ops.bool_frontier`` …
``ops.plustimes_frontier``, the raw-triple CSR entries ``ops.csr_bool`` …
``ops.csr_minplus_tiled`` and ``core.sparse.csr_frontier_step`` /
``reachable_batch_csr`` / ``distances_batch_csr`` equal their JAX
counterparts (the Pallas kernels in interpret mode) on the same numpy
inputs, and so do the names of ROADMAP C.7: ``kernels.spmv``'s
``padded_width`` and five Pallas entry names, ``core.semiring``'s
``AGGREGATE_SEMIRING`` and ``core.seminaive``'s ``GEN_MAX``.  The CSR the
raw entries build for the card (``spmv.raw_csr``, ``spmv.raw_tiled_csr``)
is checked here through the kernels' plain versions.
Every comparison is exact: plus-times values are small integers, so every
sum is an integer below 2^24 in any order."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import seminaive as jsn
from repro.core import semiring as jsr
from repro.core import sparse as jsp
from repro.core.semiring import CarrierError as JCarrierError
from repro.data import graphs as jgraphs
from repro.kernels import ops as jops
from repro.kernels import spmv as jspmv
from repro.obs.metrics import MetricsRegistry
from repro.service import DatalogService as JService
from repro_torch.core import seminaive as tsn
from repro_torch.core import semiring as tsr
from repro_torch.core import sparse as tsp
from repro_torch.core.semiring import CarrierError as TCarrierError
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref, spmv
from repro_torch.service import DatalogService as TService

PROGRAM = """
tc(X,Y) <- arc(X,Y).
tc(X,Y) <- tc(X,Z), arc(Z,Y).
dpath(X,Z,min<D>) <- darc(X,Z,D).
dpath(X,Z,min<D>) <- dpath(X,Y,Dxy), darc(Y,Z,Dyz), D = Dxy + Dyz.
"""

KINDS = ["bool", "minplus", "maxplus", "plustimes"]
#: the largest arc weight per carrier: plus-times keeps sums small
MAX_W = {"minplus": 9, "maxplus": 9, "plustimes": 2}


def _jax_kwargs() -> dict:
    """Every keyword of the JAX ``DatalogService`` at its default."""
    sig = inspect.signature(JService.__init__)
    return {name: p.default for name, p in sig.parameters.items()
            if p.kind is inspect.Parameter.KEYWORD_ONLY}


def _same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    got = got.numpy()
    return got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("sparse", [None, True])
def test_one_kwargs_dict_builds_both_services(sparse):
    """C.4: the JAX signature's keywords, at JAX's defaults, build the port's
    service too (a keyword JAX adds later fails here), which stores the
    ones that do not act on the frontier path as JAX does and answers a
    ``tc`` and a ``dpath`` batch as JAX does."""
    kw = _jax_kwargs()
    assert {"caps", "default_cap", "join_cap", "max_iters", "snapshot_lru",
            "bucket_floors", "metrics", "snapshot_every", "keep_snapshots",
            "durable_fsync"} <= set(kw)
    kw["sparse"] = sparse
    e = jgraphs.gnp_graph(60, 0.05, seed=3)
    w = np.random.default_rng(3).integers(1, 10, (len(e), 1))
    db = {"arc": e, "darc": np.concatenate([e, w], axis=1)}
    jsvc = JService(PROGRAM, db=db, **kw)
    tsvc = TService(PROGRAM, db=db, device="cpu", **kw)
    for name in ("caps", "default_cap", "join_cap", "max_iters",
                 "snapshot_lru", "bucket_floors"):
        assert getattr(tsvc, name) == getattr(jsvc, name), name
    queries = [("tc", (s, None)) for s in (0, 5, 17)] + [
        ("dpath", (s, None, None)) for s in (0, 5, 17)]
    for got, want in zip(tsvc.ask_batch(queries), jsvc.ask_batch(queries)):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("metrics", [True, "registry"])
def test_metrics_registry_raises_naming_a6(metrics):
    """C.4: ``metrics=None``/``False`` are accepted; a registry (or True,
    which makes one in JAX) is unported and raises, naming ROADMAP A.6."""
    value = MetricsRegistry() if metrics == "registry" else metrics
    with pytest.raises(NotImplementedError, match="A.6"):
        TService(PROGRAM, db={"arc": np.array([[0, 1]])}, device="cpu",
                 metrics=value)
    for ok in (None, False):
        TService(PROGRAM, db={"arc": np.array([[0, 1]]),
                              "darc": np.array([[0, 1, 2]])},
                 device="cpu", metrics=ok).ask("tc", (0, None))


def _dist(rng, shape, p, zero=np.inf):
    return np.where(rng.random(shape) < p, rng.integers(1, 9, shape),
                    zero).astype(np.float32)


@pytest.mark.parametrize("name", ["bool_frontier", "minplus_frontier",
                                  "maxplus_frontier", "plustimes_frontier"])
@pytest.mark.parametrize("b,n", [(1, 50), (3, 128), (8, 130)])
def test_dense_frontier_names_match_jax(name, b, n):
    """C.5: ``ops.<carrier>_frontier(a, b)`` == JAX's on the same inputs, as
    ``tests/test_kernels.py`` calls them."""
    rng = np.random.default_rng(b * n)
    if name == "bool_frontier":
        f, w = rng.random((b, n)) < 0.2, rng.random((n, n)) < 0.1
    elif name == "plustimes_frontier":
        f = np.where(rng.random((b, n)) < 0.3, rng.integers(1, 4, (b, n)),
                     0).astype(np.float32)
        w = (rng.random((n, n)) < 0.1).astype(np.float32)
    elif name == "minplus_frontier":
        f, w = _dist(rng, (b, n), 0.3), _dist(rng, (n, n), 0.1)
    else:
        f, w = _dist(rng, (b, n), 0.3, -np.inf), _dist(rng, (n, n), 0.1,
                                                        -np.inf)
    want = getattr(jops, name)(jnp.asarray(f), jnp.asarray(w))
    got = getattr(tops, name)(torch.from_numpy(f), torch.from_numpy(w))
    assert _same(got, want)
    # JAX's block sizes are accepted (and ignored); interpret is Pallas-only
    assert _same(getattr(tops, name)(torch.from_numpy(f), torch.from_numpy(w),
                                     bm=64, bn=64, bk=64), want)
    with pytest.raises(TypeError):
        getattr(tops, name)(torch.from_numpy(f), torch.from_numpy(w),
                            interpret=True)


def _csr(kind, n, p, seed):
    """A JAX CSR (sentinel-padded spine) with a COO tail of a few arcs, its
    edges a Gn-p graph plus a hub (vertex 1 gets n // 3 in-arcs)."""
    rng = np.random.default_rng(seed)
    e = jgraphs.gnp_graph(n, p, seed=seed)
    hub = np.stack([rng.permutation(n)[:n // 3], np.ones(n // 3, np.int64)],
                   1)
    e = np.unique(np.concatenate([e, hub]), axis=0)
    extra = np.stack([rng.integers(0, n, 6), rng.integers(0, n, 6)], 1)
    if kind != "bool":
        e = np.concatenate([e, rng.integers(1, MAX_W[kind] + 1,
                                            (len(e), 1))], 1)
        extra = np.concatenate([extra, rng.integers(1, MAX_W[kind] + 1,
                                                    (len(extra), 1))], 1)
    csr = jsp.csr_append(jsp.build_csr(e, n, kind), extra)
    assert int(csr.tail_nnz) > 0
    return csr


def _frontier(kind, b, n, seed, p=0.2):
    rng = np.random.default_rng(seed)
    if kind == "bool":
        return rng.random((b, n)) < p
    hit = rng.random((b, n)) < p
    if kind == "plustimes":
        return np.where(hit, rng.integers(1, 4, (b, n)), 0).astype(np.float32)
    zero = np.inf if kind == "minplus" else -np.inf
    return np.where(hit, rng.integers(1, 10, (b, n)), zero).astype(np.float32)


def _arcs(csr, part):
    """The spine's or the tail's (src, dst, val) arrays, as numpy."""
    names = (("src_idx", "col_idx", "edge_val") if part == "spine"
             else ("tail_src", "tail_dst", "tail_val"))
    return tuple(np.asarray(getattr(csr, a)) for a in names)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("part", ["spine", "tail"])
@pytest.mark.parametrize("b,n", [(1, 64), (5, 100)])
def test_raw_csr_entries_match_jax(kind, part, b, n):
    """C.5: ``ops.csr_<kind>(frontier, src, dst, val)`` == JAX's on a CSR's
    spine arrays (sentinel pads included) and on its tail arrays.  On the
    CPU the entry is the plain version; the CSR it builds for the card
    (``spmv.raw_csr``: the triple as a COO tail whose segment map is made
    with torch index operations) is stepped here by the plain step and must
    agree too, its map equal to ``core.sparse._ell_index``'s layout."""
    csr = _csr(kind, n, 0.05, seed=n + b)
    src, dst, val = _arcs(csr, part)
    f = _frontier(kind, b, n, seed=b)
    want = getattr(jops, f"csr_{kind}")(jnp.asarray(f), *map(jnp.asarray,
                                                             (src, dst, val)))
    args = [torch.from_numpy(np.array(x)) for x in (src, dst,
                                                                val)]
    ft = torch.from_numpy(f)
    assert _same(getattr(tops, f"csr_{kind}")(ft, *args), want)
    raw = spmv.raw_csr(kind, n, *args)
    step = {"bool": spmv.plain_bool, "minplus": spmv.plain_minplus,
            "maxplus": spmv.plain_maxplus,
            "plustimes": spmv.plain_plustimes}[kind]
    assert _same(step(ft, raw), want)
    live = val if kind == "bool" else val != ref.CSR_ZERO[kind]
    m = int(live.sum())
    assert int(raw.tail_nnz) == m
    assert np.array_equal(raw.tail_ell.numpy(),
                          tsp._ell_index(dst[live].astype(np.int32), m, n, m))


@pytest.mark.parametrize("plan", [(32, 128), (16, 64), (64, 128)])
def test_raw_csr_minplus_tiled_matches_jax(plan):
    """C.5: ``ops.csr_minplus_tiled`` == JAX's over the same plan arrays
    (and == the untiled entry); the CSR it builds for K7
    (``spmv.raw_tiled_csr``) gives the same step through K7's plain
    version."""
    n = 128
    e = jgraphs.gnp_graph(n, 0.04, seed=3)
    e = np.concatenate([e, np.random.default_rng(3).integers(
        1, 9, (len(e), 1))], 1)
    csr = jsp.build_csr(e, n, "minplus", kernel_plan=plan)
    chunk, bn = csr.plan_cfg
    arrays = [np.asarray(a) for a in (csr.src_idx, csr.col_idx, csr.edge_val,
                                      csr.plan_tile, csr.plan_chunk,
                                      csr.plan_first)]
    f = _frontier("minplus", 4, n, seed=5, p=0.3)
    want = jops.csr_minplus_tiled(jnp.asarray(f), *map(jnp.asarray, arrays),
                                  chunk=chunk, bn=bn)
    args = [torch.from_numpy(np.array(a)) for a in arrays]
    ft = torch.from_numpy(f)
    assert _same(tops.csr_minplus_tiled(ft, *args, chunk=chunk, bn=bn), want)
    assert _same(tops.csr_minplus(ft, *args[:3]), want)
    raw = spmv.raw_tiled_csr(n, *args, chunk, bn)
    assert raw.plan_cfg == (chunk, bn) and int(raw.tail_nnz) == 0
    assert _same(spmv.plain_minplus_tiled(ft, raw), want)


def test_raw_entries_refuse_mixed_devices():
    """A CPU tensor runs the plain version and counts no launch; operands on
    anything but the CPU or one CUDA device are refused, never computed."""
    csr = _csr("bool", 40, 0.1, seed=1)
    src, dst, val = (torch.from_numpy(np.array(a))
                     for a in _arcs(csr, "spine"))
    f = torch.from_numpy(_frontier("bool", 2, 40, seed=2))
    before = tops.launch_counts()
    tops.csr_bool(f, src, dst, val)
    assert tops.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        tops.csr_bool(f.to("meta"), src, dst, val)
    with pytest.raises(ValueError, match="CUDA"):
        tops.csr_minplus_tiled(f.float().to("meta"), src, dst, val.float(),
                               src, src, src, chunk=8, bn=64)


@pytest.mark.parametrize("kind", KINDS)
def test_sparse_csr_frontier_step_matches_jax(kind):
    """C.5: ``core.sparse.csr_frontier_step(kind)`` is the plain step, equal
    to JAX's on spine and tail; an unknown kind raises the typed carrier
    error in both."""
    n = 96
    j_csr = _csr(kind, n, 0.05, seed=7)
    t_csr = tsp.csr_from_state(*jsp.csr_to_state(j_csr), device="cpu")
    f = _frontier(kind, 3, n, seed=8)
    want = jsp.csr_frontier_step(kind)(jnp.asarray(f), j_csr)
    assert tsp.csr_frontier_step(kind) is {
        "bool": tsp.csr_frontier_or, "minplus": tsp.csr_frontier_min,
        "maxplus": tsp.csr_frontier_max, "plustimes": tsp.csr_frontier_sum}[
            kind]
    assert _same(tsp.csr_frontier_step(kind)(torch.from_numpy(f), t_csr),
                 want)
    with pytest.raises(JCarrierError):
        jsp.csr_frontier_step("semiring-x")
    with pytest.raises(TCarrierError):
        tsp.csr_frontier_step("semiring-x")


@pytest.mark.parametrize("name,kind", [("reachable_batch_csr", "bool"),
                                       ("distances_batch_csr", "minplus")])
def test_batch_csr_front_ends_match_jax(name, kind):
    """C.5: ``core.sparse.reachable_batch_csr`` / ``distances_batch_csr``
    (``(csr, srcs, spmv=None, max_iters=None)``) give JAX's table and
    iteration count, with the default step and with an explicit one."""
    n = 100
    j_csr = _csr(kind, n, 0.03, seed=11)
    t_csr = tsp.csr_from_state(*jsp.csr_to_state(j_csr), device="cpu")
    srcs = [0, 7, 63, 99]
    want = getattr(jsp, name)(j_csr, srcs)
    for spmv_fn in (None, tsp.csr_frontier_step(kind)):
        got = getattr(tsp, name)(t_csr, srcs, spmv=spmv_fn)
        assert _same(got.table, want.table)
        assert got.iterations == int(want.iterations)
    capped = getattr(tsp, name)(t_csr, srcs, max_iters=2)
    assert capped.iterations == int(getattr(jsp, name)(j_csr, srcs,
                                                       max_iters=2).iterations)


C7_NAMES = ["padded_width", "csr_bool_spmv", "csr_plustimes_spmv",
            "csr_minplus_spmv", "csr_maxplus_spmv", "csr_minplus_spmv_tiled",
            "AGGREGATE_SEMIRING", "GEN_MAX"]


@pytest.mark.parametrize("name", C7_NAMES)
def test_c7_names_match_jax(name):
    """C.7: each JAX public name the ported modules lacked exists in the
    port with JAX's meaning.  ``padded_width`` at several (n, bn); each
    ``spmv.csr_*_spmv`` on CPU tensors, with JAX's keywords, against the
    JAX entry in interpret mode on a CSR's spine and tail arrays (the tiled
    one over its plan); ``AGGREGATE_SEMIRING``'s keys and semirings;
    ``GEN_MAX`` the int64 maximum."""
    if name == "padded_width":
        for n in (0, 1, 127, 128, 129, 300, 1000):
            for bn in (1, 64, 128, 256, 1024):
                assert spmv.padded_width(n, bn) == jspmv.padded_width(n, bn)
        assert spmv.padded_width(300) == jspmv.padded_width(300)
        return
    if name == "AGGREGATE_SEMIRING":
        assert list(tsr.AGGREGATE_SEMIRING) == list(jsr.AGGREGATE_SEMIRING)
        for key, sr in jsr.AGGREGATE_SEMIRING.items():
            got = tsr.AGGREGATE_SEMIRING[key]
            assert got.name == sr.name and got is tsr.BY_NAME[sr.name]
        return
    if name == "GEN_MAX":
        assert tsn.GEN_MAX == int(jsn.GEN_MAX) == 2 ** 63 - 1
        assert tsn.GEN_MAX == torch.iinfo(tsn.GEN_DTYPE).max
        return
    n, b = 100, 4
    if name == "csr_minplus_spmv_tiled":
        e = jgraphs.gnp_graph(n, 0.05, seed=4)
        e = np.concatenate([e, np.random.default_rng(4).integers(
            1, 9, (len(e), 1))], 1)
        j_csr = jsp.build_csr(e, n, "minplus", kernel_plan=(32, 128))
        chunk, bn = j_csr.plan_cfg
        arrays = [np.asarray(a) for a in (
            j_csr.src_idx, j_csr.col_idx, j_csr.edge_val, j_csr.plan_tile,
            j_csr.plan_chunk, j_csr.plan_first)]
        f = _frontier("minplus", b, n, seed=6, p=0.3)
        want = jspmv.csr_minplus_spmv_tiled(
            jnp.asarray(f), *map(jnp.asarray, arrays), chunk=chunk, bn=bn,
            interpret=True)
        got = spmv.csr_minplus_spmv_tiled(
            torch.from_numpy(f), *(torch.from_numpy(np.array(a))
                                   for a in arrays),
            chunk=chunk, bn=bn, interpret=True)
        assert _same(got, want)
        return
    kind = name[len("csr_"):-len("_spmv")]
    j_csr = _csr(kind, n, 0.05, seed=12)
    f = _frontier(kind, b, n, seed=13)
    for part in ("spine", "tail"):
        src, dst, val = _arcs(j_csr, part)
        want = getattr(jspmv, name)(jnp.asarray(f), *map(
            jnp.asarray, (src, dst, val)), interpret=True)
        args = [torch.from_numpy(np.array(x)) for x in (src, dst, val)]
        ft = torch.from_numpy(f)
        assert _same(getattr(spmv, name)(ft, *args), want)
        kw = ({"chunk": 64} if kind in ("bool", "plustimes")
              else {"chunk": 16, "bn": 64})
        assert _same(getattr(spmv, name)(ft, *args, interpret=False, **kw),
                     want)
