"""Port parity of the dense all-pairs path: the plain K8 (``relax_step``,
the fused min-plus step, merge and per-row changed flags) against the JAX
Pallas kernel in interpret mode and against ``ref.relax_ref`` at ragged
sizes, K8's arc-list route rendered in PyTorch (its column lists, their
fold, the route choice at ``relax.ARC_DENSITY``), the K8-driven
shortest-path loop, the nonlinear and sandwich forms of
``fixpoint_dense``, the six all-pairs and single-source front-ends
(table, iterations and generated facts), the ``ops`` entry names, and the
example ``examples/graph_analytics_torch.py`` against the JAX functions.
Inputs are made with numpy from a seed and fed to both packages; every
comparison is exact (bool is exact, and min of sums of small integers in
f32 is exact whatever the order)."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import seminaive as jsn
from repro.core import semiring as jsr
from repro.data import graphs as jgraphs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import seminaive as tsn
from repro_torch.core import semiring as tsr
from repro_torch.data import graphs as tgraphs
from repro_torch.kernels import build, relax
from repro_torch.kernels import ops as tops

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "graph_analytics_torch.py"


def _dist(rng, shape, p):
    return np.where(rng.random(shape) < p, rng.integers(1, 10, shape),
                    np.inf).astype(np.float32)


def _mask(rng, n, kind):
    if kind == "all":
        return np.ones(n, bool)
    if kind == "none":
        return np.zeros(n, bool)
    m = rng.random(n) < 0.5
    m[64:128] = False  # a whole 64-row tile with no Δ row (where n allows)
    return m


def _same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    got = got.numpy()
    return got.dtype == want.dtype and np.array_equal(got, want)


def _relax_port(d, a, m, **kw):
    return relax.relax_step(torch.from_numpy(d), torch.from_numpy(a),
                            torch.from_numpy(m), **kw)


@pytest.mark.parametrize("mask", ["random", "all", "none"])
@pytest.mark.parametrize("n", [128, 256])
def test_k8_plain_matches_pallas_relax(n, mask):
    """The plain K8 == the JAX Pallas ``relax_step`` (interpret mode) at
    the JAX kernel's divisible shapes, with (64, 64, 32) blocks."""
    rng = np.random.default_rng(n + len(mask))
    d, a, m = _dist(rng, (n, n), 0.2), _dist(rng, (n, n), 0.05), \
        _mask(rng, n, mask)
    want_d, want_c = jops.relax(jnp.asarray(d), jnp.asarray(a),
                                jnp.asarray(m), bm=64, bn=64, bk=32)
    got_d, got_c = _relax_port(d, a, m, bm=64, bn=64, bk=32)
    assert _same(got_d, want_d) and _same(got_c, want_c)
    if mask == "none":
        assert _same(got_d, d) and not got_c.any()


@pytest.mark.parametrize("mask", ["random", "all", "none"])
@pytest.mark.parametrize("n", [1, 50, 130, 200])
def test_k8_plain_matches_jax_ref_at_ragged_n(n, mask):
    """Ragged n (the JAX kernel asserts divisibility; its oracle does not),
    with whole +inf rows in d."""
    rng = np.random.default_rng(1000 + n + len(mask))
    d, a, m = _dist(rng, (n, n), 0.3), _dist(rng, (n, n), 0.05), \
        _mask(rng, n, mask)
    d[::7] = np.inf
    want_d, want_c = jref.relax_ref(jnp.asarray(d), jnp.asarray(a),
                                    jnp.asarray(m))
    got_d, got_c = _relax_port(d, a, m)
    assert _same(got_d, want_d) and _same(got_c, want_c)


def test_k8_plain_is_row_separable():
    """Each output row depends only on its own row of d and mask: row
    blocks of the plain step (how the full-width run holds K8 to it)
    reassemble the whole step exactly."""
    rng = np.random.default_rng(9)
    n = 130
    d, a, m = _dist(rng, (n, n), 0.3), _dist(rng, (n, n), 0.05), \
        _mask(rng, n, "random")
    whole_d, whole_c = _relax_port(d, a, m)
    td, ta, tm = map(torch.from_numpy, (d, a, m))
    parts = [relax.plain(td[r:r + 32], ta, tm[r:r + 32])
             for r in range(0, n, 32)]
    assert torch.equal(torch.cat([p[0] for p in parts]), whole_d)
    assert torch.equal(torch.cat([p[1] for p in parts]), whole_c)


@pytest.mark.parametrize("n,p", [(128, 0.03), (200, 0.02)])
def test_k8_loop_matches_shortest_paths_dense(n, p):
    """Iterating K8 from d = w with every row in Δ is the linear min-plus
    fixpoint: the same table as both packages' ``shortest_paths_dense``,
    in as many trips as their ``iterations``."""
    rng = np.random.default_rng(n)
    w = _dist(rng, (n, n), p)
    tw = torch.from_numpy(w)
    d, mask, trips = tw, torch.ones(n, dtype=torch.bool), 0
    while bool(mask.any()):
        d, mask = tops.relax(d, tw, mask, bm=64, bn=64, bk=32)
        trips += 1
    want = jsn.shortest_paths_dense(jnp.asarray(w))
    got = tsn.shortest_paths_dense(tw)
    assert _same(d, want.table) and _same(got.table, want.table)
    assert trips == got.iterations == int(want.iterations)
    assert got.generated == int(want.generated)


def _jax_relax(d, a, m):
    """JAX's K8: the Pallas kernel (interpret mode) where n divides its
    (64, 64, 32) blocks, its oracle ``ref.relax_ref`` otherwise."""
    args = map(jnp.asarray, (d, a, m))
    if len(d) % 64 == 0:
        return jops.relax(*args, bm=64, bn=64, bk=32)
    return jref.relax_ref(*args)


@pytest.mark.parametrize("mask", ["random", "all", "none"])
@pytest.mark.parametrize("n", [1, 50, 128, 130, 256])
def test_k8_arc_route_matches_plain_and_jax(n, mask):
    """K8's arc-list route in PyTorch (``relax.arcs_in_kernel_order``: A's
    column lists as the pre-pass builds them, each Δ row's column folded
    over its list, merged with d) equals the plain K8 and JAX's, at ragged
    n, with whole +inf rows of d and an all-+inf column of A; then with an
    all-+inf A."""
    rng = np.random.default_rng(2000 + n + len(mask))
    d, a, m = _dist(rng, (n, n), 0.3), _dist(rng, (n, n), 0.05), \
        _mask(rng, n, mask)
    d[::7] = np.inf
    a[:, n // 3] = np.inf
    for arcs in (a, np.full_like(a, np.inf)):
        got = relax.arcs_in_kernel_order(*map(torch.from_numpy,
                                              (d, arcs, m)))
        plain = _relax_port(d, arcs, m)
        assert torch.equal(got[0], plain[0])
        assert torch.equal(got[1], plain[1])
        want = _jax_relax(d, arcs, m)
        assert _same(got[0], want[0]) and _same(got[1], want[1])


def test_k8_column_lists_are_the_arcs_by_column():
    """The pre-pass's layout: columns in groups of 32, group g's block
    ``lists[gptr[g]:gptr[g + 1]]`` an (L, 32) array whose lane j % 32 holds
    column j's entries ``(k, the f32 bits of a[k, j])`` for every a[k, j]
    other than +inf, in ascending k, then ``(0, +inf)`` pads up to L, the
    group's longest column; lanes past n hold pads only."""
    rng = np.random.default_rng(31)
    n = 150
    a = _dist(rng, (n, n), 0.04)
    a[:, 7] = np.inf
    a[3, :] = np.inf
    gptr, lists = relax.column_lists(torch.from_numpy(a))
    assert gptr.dtype == lists.dtype == torch.int32
    gp, ls = gptr.numpy(), lists.numpy()
    pad = np.array([0, np.float32(np.inf).view(np.int32)])
    counts = np.isfinite(a).sum(0)
    assert len(gp) == -(-n // 32) + 1 and gp[0] == 0
    for g in range(len(gp) - 1):
        cols = range(32 * g, min(n, 32 * g + 32))
        length = max(counts[j] for j in cols)
        block = ls[gp[g]:gp[g + 1]].reshape(-1, 32, 2)
        assert block.shape[0] == length
        for lane in range(32):
            j = 32 * g + lane
            c = counts[j] if j < n else 0
            if c:
                k = np.nonzero(np.isfinite(a[:, j]))[0]
                assert np.array_equal(block[:c, lane, 0], k)
                assert np.array_equal(block[:c, lane, 1].view(np.float32),
                                      a[k, j])
            assert (block[c:, lane] == pad).all()


@pytest.mark.parametrize("side", ["below", "above"])
def test_k8_route_choice_at_the_threshold(side):
    """``relax_step`` takes the arc-list route where ``relax.arcs_pay``:
    with an A of exactly ``ARC_DENSITY·n²`` live entries its pre-pass
    hands on the column lists (the arc-list route), with one more entry
    None (the tiled route); either way the step equals the plain K8 and
    JAX's.  An n past ``ARC_MAX_N`` never takes the arc-list route."""
    n = 200
    rng = np.random.default_rng(41)
    live = int(relax.ARC_DENSITY * n * n) + (side == "above")
    a = np.full(n * n, np.inf, np.float32)
    a[rng.permutation(n * n)[:live]] = rng.integers(1, 10, live)
    a = a.reshape(n, n)
    d, m = _dist(rng, (n, n), 0.3), _mask(rng, n, "random")
    assert relax.arcs_pay(n, live) == (side == "below")
    assert not relax.arcs_pay(relax.ARC_MAX_N + 1, 0)
    ta = torch.from_numpy(a)
    td, tm = torch.from_numpy(d), torch.from_numpy(m)
    pre = relax._prepass(ta, tm, pick=True)
    assert (pre is None) == (side == "above")
    if pre is not None:
        assert pre[3].tolist() == np.nonzero(m)[0].tolist() == \
            pre[3][:pre[4]].tolist()
    got = relax.arcs_in_kernel_order(td, ta, tm) if pre is not None \
        else relax.relax_tiled(td, ta, tm)
    want = _jax_relax(d, a, m)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    plain = relax.relax_step(td, ta, tm)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


# -- the dense forms and front-ends against JAX ------------------------------


def _cut(edges, n):
    """A table-6 graph cut to its first ``n`` vertices (n <= 300)."""
    return edges[(edges < n).all(axis=1)]


def _graph(name):
    """(edges, n): ``table6_scaled()`` graphs cut to n <= 300, and a random
    graph with self-loops."""
    if name == "loops":
        rng = np.random.default_rng(21)
        n = 90
        e = np.stack([rng.integers(0, n, 200), rng.integers(0, n, 200)], 1)
        loops = np.stack([np.arange(0, n, 9)] * 2, 1)
        return np.unique(np.concatenate([e, loops]), axis=0), n
    graphs = tgraphs.table6_scaled()
    assert all(np.array_equal(graphs[k], v)
               for k, v in jgraphs.table6_scaled().items())
    n = {"Tree6": 200, "Grid20": 300, "G500": 250}[name]
    return _cut(graphs[name], n), n


def _both(edges, n):
    adj = tgraphs.graph_to_adj(edges, n)
    w = tgraphs.graph_to_weighted(edges, n, seed=n)
    return adj, w


def _check(got, want):
    assert _same(got.table, want.table)
    assert got.iterations == int(want.iterations)
    assert got.generated == int(want.generated)


GRAPHS = ["Tree6", "Grid20", "G500", "loops"]


@pytest.mark.parametrize("form", ["nonlinear", "sandwich"])
@pytest.mark.parametrize("name", GRAPHS)
def test_fixpoint_dense_new_forms_match_jax(name, form):
    """The nonlinear (Δ⊗D ⊕ D⊗Δ) and sandwich (arcᵀ ⊗ (Δ ⊗ arc)) forms,
    bool and min-plus, from init = arc: table, iterations, generated."""
    edges, n = _graph(name)
    adj, w = _both(edges, n)
    for jsr_, tsr_, arc in ((jsr.BOOL, tsr.BOOL, adj),
                            (jsr.MIN_PLUS, tsr.MIN_PLUS, w)):
        want = jsn.fixpoint_dense(jsr_, jnp.asarray(arc), jnp.asarray(arc),
                                  form=form)
        got = tsn.fixpoint_dense(tsr_, torch.from_numpy(arc),
                                 torch.from_numpy(arc), form=form)
        _check(got, want)


FRONT_ENDS = ["transitive_closure_dense", "shortest_paths_dense",
              "same_generation_dense", "connected_components_dense",
              "reachable_from_dense", "single_source_distances_dense"]


@pytest.mark.parametrize("fn", FRONT_ENDS)
@pytest.mark.parametrize("name", GRAPHS)
def test_front_ends_match_jax(name, fn):
    edges, n = _graph(name)
    adj, w = _both(edges, n)
    arc = w if fn in ("shortest_paths_dense",
                      "single_source_distances_dense") else adj
    args = (3,) if fn in ("reachable_from_dense",
                          "single_source_distances_dense") else ()
    want = getattr(jsn, fn)(jnp.asarray(arc), *args)
    got = getattr(tsn, fn)(torch.from_numpy(arc), *args)
    _check(got, want)


def test_same_generation_with_plain_matmul_equals_default():
    """``matmul=`` reaches the sandwich form's two products: the plain
    boolean product gives the default's table, iterations and generated."""
    edges, n = _graph("loops")
    adj = torch.from_numpy(tgraphs.graph_to_adj(edges, n))
    want = tsn.same_generation_dense(adj)
    calls = []

    def plain(a, b):
        calls.append(a.shape)
        return tsr.BOOL.matmul(a, b)

    got = tsn.same_generation_dense(adj, matmul=plain)
    assert torch.equal(got.table, want.table)
    assert (got.iterations, got.generated) == (want.iterations,
                                               want.generated)
    assert len(calls) == 2 * got.iterations
    with pytest.raises(ValueError):
        tsn.fixpoint_dense(tsr.BOOL, adj, adj, form="quadratic")


# -- the ops entry names -----------------------------------------------------


def test_ops_entries_accept_jax_block_kwargs():
    """``ops.relax``, ``ops.minplus`` and ``ops.boolmm`` take the JAX
    kernels' ``bm``/``bn``/``bk`` (results unchanged) and refuse any other
    keyword; ``relax_step`` takes them too."""
    rng = np.random.default_rng(4)
    n = 96
    d, a, m = _dist(rng, (n, n), 0.2), _dist(rng, (n, n), 0.05), \
        _mask(rng, n, "random")
    td, ta, tm = map(torch.from_numpy, (d, a, m))
    base = relax.relax_step(td, ta, tm)
    for kw in ({}, {"bm": 32}, {"bm": 64, "bn": 64, "bk": 32}):
        for got in (tops.relax(td, ta, tm, **kw),
                    relax.relax_step(td, ta, tm, **kw)):
            assert torch.equal(got[0], base[0])
            assert torch.equal(got[1], base[1])
        assert torch.equal(tops.minplus(td, ta, **kw),
                           tsr.MIN_PLUS.matmul(td, ta))
        adj = torch.from_numpy(rng.random((n, n)) < 0.05)
        assert torch.equal(tops.boolmm(adj, adj, **kw),
                           tsr.BOOL.matmul(adj, adj))
    for fn, args in ((tops.minplus, (td, ta)), (tops.boolmm, (tm, tm)),
                     (tops.relax, (td, ta, tm))):
        with pytest.raises(TypeError):
            fn(*args, interpret=True)


@pytest.mark.parametrize("name", ["bool", "min_plus", "max_plus",
                                  "plus_times"])
def test_semiring_matmul_routes_like_jax(name):
    """``ops.semiring_matmul`` names the same carriers as JAX's and, on CPU
    tensors, equals the semiring's plain product without a launch."""
    rng = np.random.default_rng(2)
    if name == "bool":
        a = rng.random((64, 64)) < 0.1
    elif name == "plus_times":
        a = rng.integers(0, 3, (64, 64)).astype(np.float32)
    else:
        a = _dist(rng, (64, 64), 0.2)
        if name == "max_plus":
            a = np.where(np.isinf(a), -np.inf, a).astype(np.float32)
    ta = torch.from_numpy(a)
    before = tops.launch_counts()
    assert torch.equal(tops.semiring_matmul(name)(ta, ta),
                       tsr.BY_NAME[name].matmul(ta, ta))
    assert _same(tops.semiring_matmul(name)(ta, ta),
                 jops.semiring_matmul(name)(jnp.asarray(a), jnp.asarray(a)))
    assert tops.launch_counts() == before
    with pytest.raises(KeyError):
        tops.semiring_matmul("tropical")


def test_relax_step_routes_by_device():
    """A CPU tensor runs the plain version and counts no launch; a tensor
    on neither the CPU nor a CUDA device is refused, never computed, by
    ``relax_step`` and by each of its routes; K8 is a registered source
    with a launch counter for each route."""
    d = torch.full((8, 8), float("inf"))
    m = torch.ones(8, dtype=torch.bool)
    before = tops.launch_counts()
    got = relax.relax_step(d, d, m)
    assert torch.equal(got[0], d) and got[1].dtype == torch.bool
    assert tops.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        relax.relax_step(d.to("meta"), d.to("meta"), m.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        relax.relax_step(d, d.to("meta"), m)
    assert "relax" in build.SOURCES and "relax_step" in build.LAUNCHES
    assert "relax_step_tiled" in build.LAUNCHES
    for route in (relax.relax_arcs, relax.relax_tiled):
        assert torch.equal(route(d, d, m)[0], d)
        with pytest.raises(ValueError, match="CUDA"):
            route(d.to("meta"), d.to("meta"), m.to("meta"))
    assert tops.launch_counts() == before
    assert (build.CSRC / "relax.cu").is_file()


# -- the example -------------------------------------------------------------


@pytest.fixture(scope="module")
def example_run():
    """``graph_analytics_torch.py --device cpu`` in a fresh interpreter,
    with the modules it loaded."""
    code = (
        "import json, runpy, sys\n"
        f"sys.argv = [{str(EXAMPLE)!r}, '--device', 'cpu']\n"
        f"runpy.run_path({str(EXAMPLE)!r}, run_name='__main__')\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    return lines[:-1], json.loads(lines[-1])


def test_example_prints_the_jax_answers(example_run):
    lines, _ = example_run
    text = "\n".join(lines)
    edges = jgraphs.gnp_graph(300, 0.01, seed=1)
    adj = jnp.asarray(jgraphs.graph_to_adj(edges))
    tc = jsn.transitive_closure_dense(adj)
    labels = np.asarray(jsn.connected_components_dense(adj).table)
    comps = len(set(labels[np.isfinite(labels)].tolist()))
    assert re.search(rf"dense TC on G300: {int(np.asarray(tc.table).sum())} "
                     rf"pairs in {int(tc.iterations)} semiring-matmul", text)
    assert f"dense CC: {comps} components" in text
    n = 256
    g = jgraphs.grid_graph(15)
    w = np.full((n, n), np.inf, np.float32)
    g = g[(g < n).all(axis=1)]
    w[g[:, 0], g[:, 1]] = np.random.default_rng(0).integers(1, 5, len(g))
    d, mask, iters = jnp.asarray(w), jnp.ones(n, bool), 0
    while bool(mask.any()):
        d, mask = jops.relax(d, jnp.asarray(w), mask, bm=64, bn=64, bk=32)
        iters += 1
    assert f"relax kernel fixpoint: {iters} iterations, matches dense " \
        "engine: True" in text


def test_example_imports_neither_jax_nor_repro(example_run):
    _, modules = example_run
    assert "repro_torch" in modules
    assert not [m for m in modules if m == "jax" or m.startswith("jax.")
                or m == "repro" or m.startswith("repro.")]
