"""Port parity of the tuned CSR path: the tile-skip plan
(``core.sparse._tile_plan``, ``build_csr(kernel_plan=)``) array for array,
K7's view of it (``core.sparse._tile_order``: the planned arcs by
destination and the work units) after build, tail, fold, state, a partial
plan and raw triples, the plain K7 (``csr_minplus_tiled_step``) and K7's
walk in PyTorch (``spmv.tiled_step_in_kernel_order``) against the JAX
Pallas ``csr_minplus_spmv_tiled`` in interpret mode, a planned CSR with a
COO tail through ``ops.csr_frontier_step("minplus")`` (table, iterations,
generated),
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
    # the plan survives a state round trip, K7's view of it included
    back = tsp.csr_from_state(*jsp.csr_to_state(j), device="cpu")
    assert back.plan_cfg == j.plan_cfg
    for name in TILE_FIELDS:
        assert torch.equal(getattr(back, name), getattr(t, name)), name
    _check_tile_order(t)


#: K7's view of a planned CSR (``core.sparse._tile_order``)
TILE_FIELDS = ("tile_src", "tile_dst", "tile_val", "tile_units")
#: K3-K6's view of every other CSR (``core.sparse._ell_order``)
ELL_FIELDS = ("ell_src", "ell_val", "ell_items", "ell_row_piece")
#: the carriers and their largest weight
KINDS = {"bool": None, "minplus": 9, "maxplus": 9, "plustimes": 2}


def _planned_positions(csr, items=None) -> np.ndarray:
    """The live spine positions the plan's (tile, chunk) items visit (or
    those of ``items``, an (L, 2) array), in (destination, position) order:
    what K7's view must hold, computed with numpy from the spine."""
    chunk, bn = csr.plan_cfg
    dst = csr.col_idx.numpy().astype(np.int64)
    val = csr.edge_val.numpy()
    if items is None:
        items = np.stack([csr.plan_tile.numpy(), csr.plan_chunk.numpy()], 1)
    planned = {(int(t), int(c)) for t, c in items}
    pos = [p for p in range(len(dst)) if np.isfinite(val[p])
           and (dst[p] // bn, p // chunk) in planned]
    return np.array(sorted(pos, key=lambda p: (dst[p], p)), np.int64)


def _check_tile_order(csr, items=None, unit=tsp.TILE_UNIT):
    """K7's view against the spine and plan it was built from: each
    planned arc once, in destination order (ties in spine order), with
    its source and value; units that cover the arcs in order, tile by
    tile, every tile below n_alloc with one, none over ``unit`` arcs, and
    the first/whole flags as the units lie; no ELL order beside it."""
    assert all(getattr(csr, k) is None for k in ELL_FIELDS)
    pos = _planned_positions(csr, items)
    assert csr.tile_src.dtype == csr.tile_dst.dtype == torch.int32
    assert csr.tile_val.dtype == torch.float32
    assert np.array_equal(csr.tile_dst.numpy(), csr.col_idx.numpy()[pos])
    assert np.array_equal(csr.tile_src.numpy(), csr.src_idx.numpy()[pos])
    assert np.array_equal(csr.tile_val.numpy(), csr.edge_val.numpy()[pos])
    bn = csr.plan_cfg[1]
    units = csr.tile_units.numpy().astype(np.int64)
    assert csr.tile_units.dtype == torch.int32 and units.shape[1] == 4
    tile, lo, hi, flags = units.T
    assert lo[0] == 0 and hi[-1] == len(pos) and (lo[1:] == hi[:-1]).all()
    assert (hi >= lo).all() and (hi - lo <= unit).all()
    assert np.array_equal(np.unique(tile), np.arange(-(-csr.n_alloc // bn)))
    assert (np.diff(tile) >= 0).all()
    dst_tile = csr.tile_dst.numpy() // bn
    for u in range(len(units)):  # a unit's arcs lie in its tile
        assert (dst_tile[lo[u]:hi[u]] == tile[u]).all()
    first = np.r_[True, tile[1:] != tile[:-1]]
    last = np.r_[tile[1:] != tile[:-1], True]
    assert np.array_equal(flags & tsp.UNIT_FIRST != 0, first)
    assert np.array_equal(flags & tsp.UNIT_WHOLE != 0, first & last)
    return units


def test_plan_units_cover_the_live_items_tile_by_tile():
    """K7's work units over a plan with one hot tile: they cover the
    planned arcs tile by tile in destination order, each at most
    ``TILE_UNIT`` arcs (or the unit size given), and the hot tile is
    split into near-equal units."""
    edges = _arcs(128, 12000, seed=4, dst_hi=40)  # one hot tile
    csr = tsp.build_csr(edges, 256, "minplus", kernel_plan=(8, 64),
                        device="cpu")
    assert 12000 > tsp.TILE_UNIT
    for unit in (tsp.TILE_UNIT, 1000):
        view = csr if unit == tsp.TILE_UNIT else \
            tsp._with_tile_order(csr, unit)
        units = _check_tile_order(view, unit=unit)
        tile, lo, hi, _ = units.T
        hot = tile == 0
        assert hot.sum() == -(-12000 // unit)  # the hot tile was split
        assert (hi - lo)[hot].max() - (hi - lo)[hot].min() <= 1
    assert csr.tile_dst.numel() == int(csr.nnz)  # a full plan: every arc


@pytest.mark.parametrize("case", sorted(PLANS))
def test_tile_order_after_tail_fold_and_state(case):
    """K7's view holds after an append into the COO tail (the spine does
    not move, nor does the view), through a fold (rebuilt for the new
    spine), and from a JAX state."""
    n_alloc, n, m, dst_hi, plan = PLANS[case]
    edges = _arcs(n, m, seed=len(case) + 1, dst_hi=dst_hi)
    t = tsp.build_csr(edges, n_alloc, "minplus", kernel_plan=plan,
                      device="cpu")
    _check_tile_order(t)
    new = _arcs(max(n, 2), 9, seed=99)  # more than the fold's floor of 8
    tail = tsp.csr_append(t, new, rebuild_frac=10.0)
    assert int(tail.tail_nnz) == 9 and tail.tile_src is t.tile_src
    fold = tsp.csr_append(t, new, rebuild_frac=0.0)
    assert int(fold.tail_nnz) == 0 and fold.plan_cfg == t.plan_cfg
    _check_tile_order(fold)
    j = jsp.csr_append(jsp.build_csr(edges, n_alloc, "minplus",
                                     kernel_plan=plan), new,
                       rebuild_frac=0.0)
    carried = tsp.csr_from_state(*jsp.csr_to_state(j), device="cpu")
    _check_tile_order(carried)
    for name in TILE_FIELDS:
        assert torch.equal(getattr(carried, name), getattr(fold, name)), name


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("planned", [False, True])
def test_each_csr_carries_the_view_its_step_reads(kind, planned):
    """A planned min-plus CSR (stepped by K7 alone) carries K7's view and
    no ELL order; every other CSR, a planned one of another carrier (K3,
    K5 and K6 ignore the plan) included, carries the ELL order and no K7
    view, after a build, a fold and from a JAX state."""
    rng = np.random.default_rng(len(kind) + planned)
    e = jgraphs.gnp_graph(100, 0.04, seed=7)
    edges = e if kind == "bool" else _weighted(rng, e, KINDS[kind])
    plan = (16, 64) if planned else None
    k7 = planned and kind == "minplus"
    new = jgraphs.gnp_graph(100, 0.01, seed=8)
    t = tsp.build_csr(edges, 128, kind, kernel_plan=plan, device="cpu")
    fold = tsp.csr_append(t, new if kind == "bool" else _weighted(
        rng, new, KINDS[kind]), rebuild_frac=0.0)
    j = jsp.build_csr(edges, 128, kind, kernel_plan=plan)
    carried = tsp.csr_from_state(*jsp.csr_to_state(j), device="cpu")
    for csr in (t, fold, carried):
        assert csr.plan_cfg == plan
        assert all((getattr(csr, k) is not None) == k7 for k in TILE_FIELDS)
        assert all((getattr(csr, k) is None) == (k7 or (
            k == "ell_val" and kind == "bool")) for k in ELL_FIELDS)


def _partial_plan(j, rng):
    """A JAX plan with about half its non-first items dropped (each tile
    keeps its first item, so the Pallas kernel still initializes every
    output tile)."""
    keep = np.asarray(j.plan_first) == 1
    keep |= rng.random(len(keep)) < 0.5
    return tuple(np.asarray(a)[keep] for a in (j.plan_tile, j.plan_chunk,
                                               j.plan_first))


def test_partial_plan_keeps_only_its_own_arcs():
    """A plan that misses some (tile, chunk) items (the raw-triple entry
    takes any plan): K7's view holds exactly the arcs of the items it
    keeps, and its walk equals the plain tiled step and the Pallas kernel
    (interpret mode) over that plan."""
    rng = np.random.default_rng(21)
    n = 200
    edges = _arcs(n, 2500, seed=21)
    j = jsp.build_csr(edges, n, "minplus", kernel_plan=(16, 64))
    tiles, chunks, first = _partial_plan(j, rng)
    assert len(tiles) < len(np.asarray(j.plan_tile))
    src, dst, val = (torch.from_numpy(np.array(a)) for a in (
        j.src_idx, j.col_idx, j.edge_val))
    plan = tuple(torch.from_numpy(a) for a in (tiles, chunks, first))
    csr = spmv.raw_tiled_csr(n, src, dst, val, *plan, 16, 64)
    _check_tile_order(csr, np.stack([tiles, chunks], 1))
    assert csr.tile_dst.numel() < int(j.nnz)
    f = _dist(rng, 5, n)
    got = spmv.tiled_step_in_kernel_order(torch.from_numpy(f), csr)
    assert torch.equal(got, spmv.ref.csr_raw_minplus_tiled_ref(
        torch.from_numpy(f), src, dst, val, plan[0], plan[1], 16, 64))
    want = csr_minplus_spmv_tiled(
        jnp.asarray(f), j.src_idx, j.col_idx, j.edge_val,
        jnp.asarray(tiles), jnp.asarray(chunks), jnp.asarray(first),
        chunk=16, bn=64, interpret=True)
    assert _same(got, want)


def test_raw_tiled_csr_has_no_untiled_view():
    """``spmv.raw_tiled_csr`` (the raw-triple tiled entry on the card):
    its slice map is a placeholder K7 never reads, so it carries no ELL
    order and K4's check refuses it, while K7's view of the plan is whole
    and its walk equals the triple's plain tiled step."""
    n = 150
    edges = _arcs(n, 1200, seed=23)
    j = jsp.build_csr(edges, n, "minplus", kernel_plan=(32, 128))
    arcs = tuple(torch.from_numpy(np.array(a)) for a in (
        j.src_idx, j.col_idx, j.edge_val))
    plan = tuple(torch.from_numpy(np.array(a)) for a in (
        j.plan_tile, j.plan_chunk, j.plan_first))
    csr = spmv.raw_tiled_csr(n, *arcs, *plan, 32, 128)
    assert all(getattr(csr, k) is None for k in ELL_FIELDS)
    f = torch.from_numpy(_dist(np.random.default_rng(2), 3, n))
    with pytest.raises(ValueError, match="no ELL-ordered sources"):
        spmv._ell_checked("csr_minplus_step", torch.float32, f, csr)
    _check_tile_order(csr)
    got = spmv.tiled_step_in_kernel_order(f, csr)
    assert torch.equal(got, spmv.ref.csr_raw_minplus_tiled_ref(
        f, *arcs, plan[0], plan[1], 32, 128))
    assert torch.equal(got, spmv.ref.csr_raw_ref("minplus", f, *arcs))


#: K7's plans in chip_smoke.py's ragged parity
K7_PLANS = [(32, 128), (64, 128), (32, 256), (16, 64)]


@pytest.mark.parametrize("plan", K7_PLANS)
@pytest.mark.parametrize("append", ["tail", "fold"])
def test_k7_walk_equals_plain_and_pallas(plan, append):
    """K7's walk over the plan's arcs in destination order and its units
    (``spmv.tiled_step_in_kernel_order``) equals the plain tiled step and
    the JAX step over the Pallas ``csr_minplus_spmv_tiled`` (interpret
    mode; JAX folds the COO tail in an untiled pass) exactly, after arcs
    went into the COO tail and after a fold, with ``TILE_UNIT`` and with
    units of 256 arcs (the hot tile split into several); at B = 1, 3 and
    8 and a fully +inf frontier."""
    rng = np.random.default_rng(plan[0] + plan[1])
    n = 300
    edges = np.concatenate([_arcs(n, 1500, seed=plan[1]),
                            _arcs(n, 2600, seed=plan[0], dst_hi=30)])
    new = _arcs(n, 40, seed=plan[0] + 1)
    j = jsp.csr_append(jsp.build_csr(edges, n, "minplus", kernel_plan=plan),
                       new, rebuild_frac=0.0 if append == "fold" else 1.0)
    t = tsp.csr_from_state(*jsp.csr_to_state(j), device="cpu")
    assert (int(t.tail_nnz) > 0) == (append == "tail")
    _check_tile_order(t)
    small = tsp._with_tile_order(t, 256)
    units = _check_tile_order(small, unit=256)
    assert (units[:, 0] == 0).sum() > 1  # the hot tile is split
    for b in (1, 3, 8):
        f = _dist(rng, b, n)
        if b == 8:
            f[:] = np.inf
        got = spmv.tiled_step_in_kernel_order(torch.from_numpy(f), t)
        assert torch.equal(got, spmv.plain_minplus_tiled(torch.from_numpy(f),
                                                         t))
        assert torch.equal(got, spmv.tiled_step_in_kernel_order(
            torch.from_numpy(f), small))
        want = jops.csr_frontier_step("minplus")(jnp.asarray(f), j)
        assert _same(got, want)
    one = spmv.tiled_step_in_kernel_order(torch.from_numpy(f[0]), t)
    assert torch.equal(one, got[0])


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


def test_layout_bytes_charge_the_view_and_guard_kernel_candidates():
    """The autotuner's memory guard charges each candidate the slice map
    and the view its step reads (``tat.layout_bytes``): the ELL order
    (twice, as it is concatenated) or, for a planned min-plus CSR, K7's
    arcs and their build's temporaries.  On a card whose quarter holds the
    default layout but not K7's view, no tile-skip candidate is built."""
    edges = _weighted(np.random.default_rng(2),
                      jgraphs.powerlaw_graph(200, 1200, alpha=1.3, seed=5))
    indeg = tat._indegree(edges, 256)
    m = len(edges)
    for cfg in (tat.KernelConfig(), tat.SINGLE_WIDTH):
        slots = tat._predicted_e_alloc(indeg, cfg.ell_cfg)
        assert tat.layout_bytes("bool", cfg, indeg, m) == 12 * slots
        for kind in ("minplus", "maxplus", "plustimes"):
            assert tat.layout_bytes(kind, cfg, indeg, m) == 20 * slots
        ker = dataclasses.replace(cfg, use_kernel=True, chunk=32, bn=128)
        assert tat.layout_bytes("minplus", ker, indeg, m) == \
            4 * slots + 36 * m
        assert tat.layout_bytes("bool", ker, indeg, m) == 12 * slots
    default = tat.layout_bytes("minplus", tat.KernelConfig(), indeg, m)
    ker = tat.KernelConfig(use_kernel=True, chunk=32, bn=128)
    assert tat.layout_bytes("minplus", ker, indeg, m) > default
    small = dataclasses.replace(H100, hbm_bytes=4 * default)
    got = tat.autotune(edges, 256, "minplus", include_kernels=True,
                       device="cpu", hw=small, use_cache=False)
    assert not any(c["config"].use_kernel for c in got.candidates)
    assert any(c["config"] == tat.KernelConfig() and c["measured_s"]
               is not None for c in got.candidates)


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
