"""The launch plans of the K1 (``boolmm.plan``) and K2 (``minplus.plan``)
wrappers, and a PyTorch rendering of each plan held to the JAX Pallas
kernels.

A plan cuts K into splits over the grid; K1's splits OR their ones into a
zeroed output, K2's write ⊕-partials to a scratch that a second pass
⊕-combines.  The rendering computes each split's partial product with the
plain version on that split's k range, then the combine, and must equal
``repro.kernels.boolmm.bool_frontier_matmul`` and
``repro.kernels.minplus.minplus_frontier_matmul`` (interpret mode; max-plus
by the JAX package's negation route, ``ops.maxplus_frontier``) exactly:
bool is exact, and min / max of sums of small integers in f32 are exact
whatever the order.  Inputs are made with numpy from a seed, with dead
(⊕-zero) rows and a dead tile in every frontier and a dead row block in
every matrix."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import boolmm as jboolmm
from repro.kernels import minplus as jminplus
from repro.kernels import ops as jops
from repro_torch.kernels import boolmm, build, minplus

BATCHES = (1, 8, 100, 128, 129)
WIDTHS = (1, 17, 257, 1003)
#: (m, k, n): the ragged shapes, the serving shape, its ask shapes, M = n
SHAPES = [(b, n, n) for b in BATCHES for n in WIDTHS] + [
    (128, 10_112, 10_112), (1, 10_112, 10_112), (8, 10_112, 10_112),
    (10_112, 10_112, 10_112), (10_000, 10_000, 10_000), (3, 0, 5)]
KERNELS = {"K1": boolmm, "K2": minplus}


def _ranges(p, k):
    return [(s * p.k_chunk, min(k, (s + 1) * p.k_chunk))
            for s in range(p.splits)]


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_every_k_lies_in_exactly_one_split(kernel, m, k, n):
    mod = KERNELS[kernel]
    p = mod.plan(m, k, n)
    assert p.k_chunk % mod.BK == 0 and p.k_chunk > 0
    assert p.grid == (-(-n // mod.BN), -(-m // mod.BM), p.splits)
    covered = np.zeros(k, np.int64)
    for lo, hi in _ranges(p, k):
        assert lo < hi or k == 0  # no split is empty
        covered[lo:hi] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_scratch_holds_the_partials(m, k, n):
    """K2's scratch is one (m, n) partial a split, and none for one split;
    K1 needs none: its splits OR straight into the zeroed output."""
    p = minplus.plan(m, k, n)
    assert p.scratch == ((p.splits, m, n) if p.splits > 1 else ())
    assert boolmm.plan(m, k, n).scratch == ()


@pytest.mark.parametrize("kernel,n,vec", [
    ("K1", 1003, False), ("K1", 1000, False), ("K1", 1024, True),
    ("K1", 17, False), ("K2", 1003, False), ("K2", 1002, False),
    ("K2", 1000, True), ("K2", 17, False)])
def test_unaligned_width_takes_the_predicated_route(kernel, n, vec):
    """16-byte loads need rows of 16 bytes: n % 16 for K1's bytes, n % 4
    for K2's floats; an operand off a 16-byte boundary is unaligned too."""
    mod = KERNELS[kernel]
    assert mod.plan(128, n, n).vec is vec
    assert mod.plan(128, n, n, aligned=False).vec is False


def test_the_grid_fills_the_card():
    """At the serving shape K is split so that the blocks fill 132 SMs; at
    M = n the tiles alone fill them, and nothing is split."""
    for mod in (boolmm, minplus):
        serving = mod.plan(128, 10_112, 10_112)
        slots = build.SMS * mod.BLOCKS_PER_SM
        assert serving.splits > 1
        assert 79 * serving.splits >= slots * 0.85
        assert mod.plan(1, 10_112, 10_112).splits == serving.splits
        assert mod.plan(10_112, 10_112, 10_112).splits == 1


@pytest.mark.parametrize("tiles,stages,slots,want", [
    (79, 79, 264, 3), (79, 316, 132, 5), (6241, 316, 132, 1),
    (1, 1, 132, 1), (1, 8, 132, 8)])
def test_split_k(tiles, stages, slots, want):
    splits, per = build.split_k(tiles, stages, slots)
    assert splits == want and -(-stages // per) == splits


def _frontier(rng, b, n):
    """Live entries at density 0.3, with row 0 dead and the first 128 k
    dead in every row (a dead tile)."""
    keep = rng.random((b, n)) < 0.3
    keep[0] = False
    keep[:, :128] = False
    return keep


def _render_k1(f, a, p):
    out = torch.zeros((f.shape[0], a.shape[1]), dtype=torch.bool)
    for lo, hi in _ranges(p, f.shape[1]):
        out |= boolmm.plain(f[:, lo:hi], a[lo:hi])
    return out


def _render_k2(f, w, p, plain, combine):
    parts = [plain(f[:, lo:hi], w[lo:hi]) for lo, hi in _ranges(p, f.shape[1])]
    if not p.scratch:
        return parts[0]
    scratch = torch.stack(parts)
    assert tuple(scratch.shape) == p.scratch
    return combine(scratch, dim=0)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("n", WIDTHS)
def test_plan_rendering_matches_pallas(b, n):
    rng = np.random.default_rng(b * 10_000 + n)
    fb = _frontier(rng, b, n)
    adj = rng.random((n, n)) < 0.05
    adj[n // 2:] = False  # a dead row block
    p1 = boolmm.plan(b, n, n)
    want = jboolmm.bool_frontier_matmul(jnp.asarray(fb), jnp.asarray(adj),
                                        interpret=True)
    got = _render_k1(torch.from_numpy(fb), torch.from_numpy(adj), p1)
    assert np.array_equal(got.numpy(), np.asarray(want))

    p2 = minplus.plan(b, n, n)
    fw = np.where(_frontier(rng, b, n), rng.integers(1, 10, (b, n)),
                  np.inf).astype(np.float32)
    w = np.where(rng.random((n, n)) < 0.05, rng.integers(1, 10, (n, n)),
                 np.inf).astype(np.float32)
    w[n // 2:] = np.inf
    want = jminplus.minplus_frontier_matmul(jnp.asarray(fw), jnp.asarray(w),
                                            interpret=True)
    got = _render_k2(torch.from_numpy(fw), torch.from_numpy(w), p2,
                     minplus.plain, torch.amin)
    assert np.array_equal(got.numpy(), np.asarray(want))

    fm, wm = -fw, -w  # max-plus: -inf is the ⊕-zero
    want = jops.maxplus_frontier(jnp.asarray(fm), jnp.asarray(wm),
                                 interpret=True)
    got = _render_k2(torch.from_numpy(fm), torch.from_numpy(wm), p2,
                     minplus.plain_max, torch.amax)
    assert np.array_equal(got.numpy(), np.asarray(want))
