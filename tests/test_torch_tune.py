"""Port parity of the tuned CSR path: the tile-skip plan
(``core.sparse._tile_plan``, ``build_csr(kernel_plan=)``) array for array,
the plain K7 (``csr_minplus_tiled_step``) against the JAX Pallas
``csr_minplus_spmv_tiled`` in interpret mode, a planned CSR with a COO tail
through ``ops.csr_frontier_step("minplus")`` (table, iterations, generated),
``csr_append`` (tail arrays, tail map, fold rebuild, additive filter), the
autotuner's signature, histogram and analytic ranking given the same
hardware numbers, its CPU search and cache, and ``DatalogService(tune=)``
against the JAX service.  Every comparison is exact."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse as jsp
from repro.data import graphs as jgraphs
from repro.kernels import autotune as jat
from repro.kernels import ops as jops
from repro.kernels.spmv import csr_minplus_spmv_tiled
from repro.roofline.report import HW as JHW
from repro.service import DatalogService as JService
from repro_torch.core import sparse as tsp
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spmv
from repro_torch.roofline.report import H100
from repro_torch.service import DatalogService as TService

SPATH = """
dpath(X,Z,min<D>) <- darc(X,Z,D).
dpath(X,Z,min<D>) <- dpath(X,Y,Dxy), darc(Y,Z,Dyz), D = Dxy + Dyz.
"""
TC = """
tc(X,Y) <- arc(X,Y).
tc(X,Y) <- tc(X,Z), arc(Z,Y).
"""
LPATH = """
lpath(X,Z,max<D>) <- d(X,Z,D).
lpath(X,Z,max<D>) <- lpath(X,Y,D1), d(Y,Z,D2), D = D1 + D2.
"""
CPATH = """
cpath(X,Z,sum<C>) <- d(X,Z,C).
cpath(X,Z,sum<C>) <- cpath(X,Y,C1), d(Y,Z,C2), C = C1 * C2.
"""


def _weighted(rng, e, hi=9):
    return np.concatenate([e, rng.integers(1, hi + 1, (len(e), 1))], axis=1)


def _arcs(n_live, m, seed, dst_hi=None):
    """m random weighted arcs over ``n_live`` sources; destinations below
    ``dst_hi`` only (so the upper column tiles stay empty)."""
    rng = np.random.default_rng(seed)
    if not m:
        return np.zeros((0, 3), np.int64)
    e = np.stack([rng.integers(0, n_live, m),
                  rng.integers(0, dst_hi or n_live, m)], axis=1)
    return _weighted(rng, e)


def _dist(rng, b, n, p=0.3):
    return np.where(rng.random((b, n)) < p, rng.integers(1, 10, (b, n)),
                    np.inf).astype(np.float32)


def _same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    got = got.numpy()
    return got.dtype == want.dtype and np.array_equal(got, want)


# (n_alloc, live vertices, arcs, destinations below, (chunk, bn))
PLANS = {
    "empty-tiles": (512, 500, 900, 100, (32, 128)),
    "ragged-n_alloc": (300, 300, 1200, None, (16, 64)),
    "chunk-over-cap": (128, 100, 20, None, (1024, 128)),
    "no-arcs": (256, 0, 0, None, (32, 128)),
    "wide-tile": (640, 600, 2000, None, (64, 256)),
    "odd-block-sizes": (200, 190, 700, None, (40, 100)),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_tile_plan_and_planned_build_match_jax(case):
    n_alloc, n, m, dst_hi, plan = PLANS[case]
    edges = _arcs(n, m, seed=len(case), dst_hi=dst_hi)
    j = jsp.build_csr(edges, n_alloc, "minplus", kernel_plan=plan)
    t = tsp.build_csr(edges, n_alloc, "minplus", kernel_plan=plan,
                      device="cpu")
    assert t.plan_cfg == j.plan_cfg
    for name in ("plan_tile", "plan_chunk", "plan_first", "row_ptr",
                 "col_idx", "edge_val", "src_idx", "ell_rank"):
        assert _same(getattr(t, name), getattr(j, name)), name
    # _tile_plan itself, on the packed destinations
    chunk, bn = j.plan_cfg
    dst = np.asarray(j.col_idx)
    for a, b in zip(tsp._tile_plan(dst, m, j.capacity, n_alloc, chunk, bn),
                    jsp._tile_plan(dst, m, j.capacity, n_alloc, chunk, bn)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the plan survives a state round trip, work units included
    back = tsp.csr_from_state(*jsp.csr_to_state(j), device="cpu")
    assert back.plan_cfg == j.plan_cfg
    assert torch.equal(back.plan_unit, t.plan_unit)


def test_plan_units_cover_the_live_items_tile_by_tile():
    """K7's work units: offsets at every tile start and every PLAN_UNIT
    items within a tile, ending at the live item count (pads excluded)."""
    edges = _arcs(128, 12000, seed=4, dst_hi=40)  # one hot tile
    csr = tsp.build_csr(edges, 256, "minplus", kernel_plan=(8, 64),
                        device="cpu")
    tiles = csr.plan_tile.numpy()
    chunks = csr.plan_chunk.numpy()
    units = csr.plan_unit.numpy()
    live = units[-1]
    keys = tiles[:live].astype(np.int64) * (1 << 32) + chunks[:live]
    assert len(np.unique(keys)) == live and live < len(tiles)
    assert (tiles[live:] == tiles[live - 1]).all()  # pads repeat the last
    assert (chunks[live:] == chunks[live - 1]).all()
    lo, hi = units[:-1], units[1:]
    assert (hi > lo).all() and (hi - lo <= tsp.PLAN_UNIT).all()
    assert (tiles[lo] == tiles[hi - 1]).all()  # a unit stays in its tile
    assert max(hi - lo) == tsp.PLAN_UNIT  # the hot tile was split


@pytest.mark.parametrize("chunk,bn", [(32, 128), (16, 64), (64, 128)])
@pytest.mark.parametrize("b,n", [(1, 128), (4, 130), (8, 200)])
def test_plain_k7_matches_pallas_tiled(chunk, bn, b, n):
    """The plain K7 == the JAX tile-skip kernel (interpret mode) over the
    spine, ragged domains included; with an empty tail it is the same
    function as the untiled K4 too."""
    edges = _arcs(n, int(0.05 * n * n), seed=n + chunk)
    j = jsp.build_csr(edges, n, "minplus", kernel_plan=(chunk, bn))
    t = tsp.build_csr(edges, n, "minplus", kernel_plan=(chunk, bn),
                      device="cpu")
    f = _dist(np.random.default_rng(b * n), b, n)
    c, w = j.plan_cfg
    want = csr_minplus_spmv_tiled(
        jnp.asarray(f), j.src_idx, j.col_idx, j.edge_val, j.plan_tile,
        j.plan_chunk, j.plan_first, chunk=c, bn=w, interpret=True)
    got = spmv.csr_minplus_tiled_step(torch.from_numpy(f), t)
    assert _same(got, want)
    assert torch.equal(got, spmv.plain_minplus(torch.from_numpy(f), t))
    one = spmv.csr_minplus_tiled_step(torch.from_numpy(f[0]), t)
    assert _same(one, np.asarray(want)[0])


def test_planned_csr_with_tail_drives_the_fixpoint_like_jax():
    """A planned CSR plus a COO tail, through each package's
    ``csr_frontier_step("minplus")`` (JAX: tiled spine + untiled tail; the
    port: K7's plain version, tail folded in): the same table, iteration
    count and generated-fact count."""
    n = 96
    edges = _arcs(n, 460, seed=11)
    new = np.array([[0, 95, 2], [95, 1, 3], [40, 7, 1]], np.int64)
    j = jsp.csr_append(jsp.build_csr(edges, n, "minplus",
                                     kernel_plan=(32, 128)), new)
    t = tsp.csr_append(tsp.build_csr(edges, n, "minplus",
                                     kernel_plan=(32, 128), device="cpu"),
                       new)
    assert int(t.tail_nnz) == 3 and t.plan_cfg == j.plan_cfg
    srcs = np.array([0, 9, 40, 95])
    jstep = jops.csr_frontier_step("minplus")
    want = jsp.fixpoint_csr_cached(
        j, jsp.rows_from_sources(j, srcs), spmv=jstep)
    tstep = tops.csr_frontier_step("minplus")
    got = tsp.fixpoint_csr_cached(t, tsp.rows_from_sources(t, srcs, tstep),
                                  spmv=tstep)
    assert _same(got.table, want.table)
    assert got.iterations == int(want.iterations)
    assert got.generated == int(want.generated)


KINDS = {"bool": None, "minplus": 9, "maxplus": 9, "plustimes": 2}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_csr_append_tail_and_fold_match_jax(kind):
    """Tail arrays, the tail's segment map, the fold rebuild (carrying
    ``ell_cfg`` and ``plan_cfg``) and the additive set filter."""
    rng = np.random.default_rng(len(kind))
    n = 100
    e = jgraphs.gnp_graph(n, 0.04, seed=3)
    if kind in ("maxplus", "plustimes"):
        e = e[e[:, 0] < e[:, 1]]

    def w(a):
        return a if kind == "bool" else _weighted(rng, a, KINDS[kind])

    edges = w(e)
    plan = (16, 64) if kind == "minplus" else None
    j = jsp.build_csr(edges, 128, kind, ell_cfg=(2, 1), kernel_plan=plan)
    t = tsp.build_csr(edges, 128, kind, ell_cfg=(2, 1), kernel_plan=plan,
                      device="cpu")
    small = w(np.array([[0, 99], [5, 60], [5, 60]], np.int64))
    # re-append resident arcs too: the additive carrier must drop them
    small = np.concatenate([small, edges[:3]])
    for _ in range(2):
        j, t = jsp.csr_append(j, small), tsp.csr_append(t, small)
        assert int(t.tail_nnz) == int(j.tail_nnz) > 0
        for name in ("tail_src", "tail_dst", "tail_val", "tail_ell",
                     "tail_nnz", "nnz"):
            assert _same(getattr(t, name), getattr(j, name)), name
        assert np.array_equal(t.edges_numpy(), j.edges_numpy())
    big = w(jgraphs.gnp_graph(n, 0.03, seed=4))
    if kind in ("maxplus", "plustimes"):
        big = big[big[:, 0] < big[:, 1]]
    j, t = jsp.csr_append(j, big), tsp.csr_append(t, big)
    assert int(t.tail_nnz) == int(j.tail_nnz) == 0  # folded into the spine
    assert t.ell_cfg == j.ell_cfg == (2, 1) and t.plan_cfg == j.plan_cfg
    for name in ("row_ptr", "col_idx", "edge_val", "src_idx", "ell_rank",
                 "nnz", "tail_ell") + (("plan_tile", "plan_chunk",
                                        "plan_first") if plan else ()):
        assert _same(getattr(t, name), getattr(j, name)), name
    with pytest.raises(ValueError, match="n_alloc"):
        tsp.csr_append(t, w(np.array([[0, 128]], np.int64)))


@pytest.mark.parametrize("gen", ["gnp", "powerlaw", "empty"])
def test_signature_and_predicted_alloc_match_jax(gen):
    if gen == "gnp":
        edges = jgraphs.gnp_graph(200, 0.02, seed=1)
    elif gen == "powerlaw":
        edges = jgraphs.powerlaw_graph(256, 1500, alpha=1.2, seed=2)
    else:
        edges = np.zeros((0, 2), np.int64)
    for kind in ("bool", "minplus"):
        e = edges if kind == "bool" else _weighted(
            np.random.default_rng(0), edges)
        assert tat.graph_signature(e, 256, kind) == \
            jat.graph_signature(e, 256, kind)
    indeg = tat._indegree(edges, 256)
    assert np.array_equal(indeg, jat._indegree(edges, 256))
    for cfg in tat.DEFAULT_SLICE_CANDIDATES:
        assert tat._predicted_e_alloc(indeg, cfg) == \
            jat._predicted_e_alloc(indeg, cfg)


def _h100_for_jax():
    return JHW(**dataclasses.asdict(H100))


def test_autotune_search_on_cpu_matches_jax_and_caches():
    """With the same hardware numbers both packages rank and shortlist the
    same candidates with the same predictions; on the CPU no tile-skip
    candidate enters; a second call is a cache hit."""
    edges = _weighted(np.random.default_rng(2),
                      jgraphs.powerlaw_graph(200, 1200, alpha=1.3, seed=5))
    tat.clear_cache()
    jat.clear_cache()
    got = tat.autotune(edges, 256, "minplus", device="cpu")
    want = jat.autotune(edges, 256, "minplus", hw=_h100_for_jax())
    assert got.signature == want.signature and not got.cached
    assert [(c["config"], c["predicted_s"], c["measured_s"] is None)
            for c in got.candidates] == \
        [(tat.KernelConfig(**c["config"].as_dict()), c["predicted_s"],
          c["measured_s"] is None) for c in want.candidates]
    assert not any(c["config"].use_kernel for c in got.candidates)
    assert got.config in [c["config"] for c in got.candidates
                          if c["measured_s"] is not None]
    assert got.best_seconds <= got.baseline_seconds and got.gain >= 1.0
    again = tat.autotune(edges, 256, "minplus", device="cpu")
    assert again.cached and again.config == got.config
    # kernel candidates on request: the best layout with each block size
    tat.clear_cache()
    ker = tat.autotune(edges, 256, "minplus", include_kernels=True,
                       device="cpu", use_cache=False)
    assert [(c["config"].chunk, c["config"].bn) for c in ker.candidates
            if c["config"].use_kernel] == list(tat.DEFAULT_BLOCK_CANDIDATES)
    assert tat._CACHE == {}
    # a card too small for the single-width tables: it is never built, and
    # the gain is measured against the default layout
    small = dataclasses.replace(H100, hbm_bytes=16 * 4 * 1200)
    cut = tat.autotune(edges, 256, "minplus", device="cpu", hw=small,
                       use_cache=False)
    sw = [c for c in cut.candidates if c["config"] == tat.SINGLE_WIDTH]
    assert sw and sw[0]["measured_s"] is None
    default = [c for c in cut.candidates if c["config"] == tat.KernelConfig()]
    assert default[0]["measured_s"] == cut.baseline_seconds


def test_build_tuned_applies_layout_and_plan():
    edges = _weighted(np.random.default_rng(3),
                      jgraphs.gnp_graph(150, 0.03, seed=6))
    for cfg in (tat.SINGLE_WIDTH, tat.KernelConfig(slice_floor=4,
                                                   slice_stride=2),
                tat.KernelConfig(use_kernel=True, chunk=64, bn=256)):
        jc = jat.build_tuned(edges, 256, "minplus",
                             jat.KernelConfig(**cfg.as_dict()))
        tc = tat.build_tuned(edges, 256, "minplus", cfg, device="cpu")
        assert tc.ell_cfg == jc.ell_cfg and tc.plan_cfg == jc.plan_cfg
        assert len(tc.ell_slices) == len(jc.ell_slices)
        for a, b in zip(tc.ell_slices, jc.ell_slices):
            assert _same(a, b)


WORKLOADS = {"tc": (TC, "tc", "arc", 0, False),
             "spath": (SPATH, "dpath", "darc", 9, False),
             "lpath": (LPATH, "lpath", "d", 9, True),
             "cpath": (CPATH, "cpath", "d", 2, True)}


def _db(edb, max_w, n, p, seed, dag):
    e = jgraphs.gnp_graph(n, p, seed=seed)
    if dag:
        e = e[e[:, 0] < e[:, 1]]
    if max_w:
        e = _weighted(np.random.default_rng(seed), e, max_w)
    return {edb: e}


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_pinned_tune_service_matches_jax(workload):
    """``tune=KernelConfig(use_kernel=True)`` on every CSR relation: the
    answers equal the JAX tuned service's, and ``explain()`` reports the
    same tuning entry and the same plan."""
    program, pred, edb, max_w, dag = WORKLOADS[workload]
    db = _db(edb, max_w, 150, 0.02, 7, dag)
    kw = dict(sparse=True, csr_rebuild_frac=0.25)
    jsvc = JService(program, db=db, default_cap=2048,
                    tune=jat.KernelConfig(use_kernel=True), **kw)
    tsvc = TService(program, db=db, device="cpu",
                    tune=tat.KernelConfig(use_kernel=True), **kw)
    q = [(pred, (s, None) if not max_w else (s, None, None))
         for s in (0, 3, 17, 149, 300)]
    for got, want in zip(tsvc.ask_batch(q), jsvc.ask_batch(q)):
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.dtype == np.asarray(w).dtype and np.array_equal(g, w)
    assert tsvc.explain()["kernels"]["tuning"] == \
        jsvc.explain()["kernels"]["tuning"]
    # every carrier gets the plan (as in JAX); only min-plus steps read it
    assert tsvc._dense_state(pred).csr.plan_cfg == \
        jsvc._dense_state(pred).csr.plan_cfg == (32, 128)


def test_measured_tune_service_answers_like_jax():
    """``tune=True`` runs the measured search at build: whatever layout it
    picks, the answers equal the JAX service's."""
    program, pred, edb, max_w, dag = WORKLOADS["spath"]
    db = _db(edb, max_w, 180, 0.02, 8, dag)
    tat.clear_cache()
    jsvc = JService(program, db=db, default_cap=2048, sparse=True)
    tsvc = TService(program, db=db, device="cpu", sparse=True, tune=True)
    q = [(pred, (s, None, None)) for s in (0, 1, 2, 90)]
    for got, want in zip(tsvc.ask_batch(q), jsvc.ask_batch(q)):
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    tuning = tsvc.explain()["kernels"]["tuning"][pred]
    assert tuning["pinned"] is False
    assert tuning["config"] in [c["config"] for c in tuning["candidates"]]


def test_k7_wrapper_routes_and_refuses():
    """CPU tensors run the plain version and count no launch; a CSR with no
    plan, or operands on neither the CPU nor CUDA, are refused; min-plus
    dispatch picks K7 only for a planned CSR."""
    edges = _arcs(60, 300, seed=9)
    planned = tsp.build_csr(edges, 64, "minplus", kernel_plan=(32, 128),
                            device="cpu")
    plain = tsp.build_csr(edges, 64, "minplus", device="cpu")
    f = torch.from_numpy(_dist(np.random.default_rng(1), 3, 64))
    before = tops.launch_counts()
    step = tops.csr_frontier_step("minplus")
    assert torch.equal(step(f, planned), spmv.plain_minplus_tiled(f, planned))
    assert torch.equal(step(f, plain), spmv.plain_minplus(f, plain))
    assert tops.launch_counts() == before
    with pytest.raises(ValueError, match="plan"):
        spmv.csr_minplus_tiled_step(f, plain)
    with pytest.raises(ValueError, match="CUDA"):
        spmv.csr_minplus_tiled_step(f.to("meta"), planned)
    assert "csr_minplus_tiled_step" in build.LAUNCHES
