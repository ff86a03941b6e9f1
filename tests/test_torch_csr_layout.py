"""The CSR layout that K3, K5 and K6 read, checked on the CPU.

K3 (``csr_bool_step``), K5 (``csr_plustimes_step``) and K6
(``csr_maxplus_step``) run on the card only (``csrc/spmv.cu``).  What they
read is built in PyTorch and is checked here: the derived ELL-ordered
sources and values and the warp work list (``core.sparse._ell_order``)
after every way a CSR comes to be, K3's bit pack and unpack
(``spmv.pack_bits``/``unpack_bits``), and K5's and K6's walk of the items
in the kernel's order (``spmv.ell_step_in_kernel_order``) against the plain
step and the JAX Pallas kernel (interpret mode): exactly for max-plus and
on integer sums, within a stated tolerance otherwise.  Last,
``chip_smoke.capture_frontiers``, the spy that records the frontiers a warm
batch's fixpoint passes to its step.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse as jsp
from repro.data import graphs as jgraphs
from repro.kernels import ops as jops
from repro.service import batch as jbatch
from repro_torch.core import sparse as tsp
from repro_torch.core.seminaive import additive_max_iters
from repro_torch.kernels import spmv
from repro_torch.service import DatalogService
from repro_torch.service import batch as tbatch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

#: the graphs of test_torch_sparse.py's layout test: (n, p, seed, powerlaw)
GRAPHS = [(100, 0.05, 0, False), (100, 0.05, 1, False),
          (300, 0.02, 2, True), (300, 0.02, 3, True), (40, 0.0, 4, False)]
LAYOUT_KINDS = ["bool", "plustimes", "maxplus"]


def _edges(kind, n, p, seed, powerlaw):
    """As test_torch_sparse.py makes them; the weighted carriers keep
    src < dst and weights 1..2."""
    rng = np.random.default_rng(seed)
    if powerlaw:
        e = jgraphs.powerlaw_graph(n, int(p * n * n), alpha=1.2, seed=seed)
    else:
        e = jgraphs.gnp_graph(n, p, seed=seed)
    if kind == "bool":
        return e
    e = e[e[:, 0] < e[:, 1]]
    return np.concatenate([e, rng.integers(1, 3, (len(e), 1))], axis=1)


def _check_ell_order(csr):
    """The derived fields against the spine they were built from: slot k
    of the slices laid end to end has ``ell_src = src_idx[p]`` (-1 where
    ``edge_val[p]`` is the ⊕-zero, 0 or -inf: a sentinel) and ``ell_val =
    edge_val[p]`` (equal to it at every live slot); the work list's pieces
    tile each row from its first slot to its last live one (the whole row
    where rows share an item), in order, so every live slot lies in
    exactly one piece."""
    if csr.kind not in LAYOUT_KINDS:
        assert all(getattr(csr, k) is None for k in (
            "ell_src", "ell_val", "ell_items", "ell_row_piece"))
        return
    pos = torch.cat([t.reshape(-1) for t in csr.ell_slices]).long()
    val = csr.edge_val[pos]
    live = val if csr.kind == "bool" else val != spmv.ref.CSR_ZERO[csr.kind]
    want = torch.where(live, csr.src_idx[pos], -1)
    assert csr.ell_src.dtype == torch.int32
    assert torch.equal(csr.ell_src, want)
    if csr.kind == "bool":
        assert csr.ell_val is None
    else:
        assert csr.ell_val.dtype == torch.float32
        assert torch.equal(csr.ell_val, val)
        assert torch.equal(csr.ell_val[live], csr.edge_val[pos[live]])
        if csr.kind == "maxplus":  # the sentinels: -1 sources, -inf values
            assert bool((csr.ell_val[~live] == float("-inf")).all())
            assert bool((csr.ell_src[~live] == -1).all())
    items = csr.ell_items.numpy().astype(np.int64)
    rp = csr.ell_row_piece.numpy()
    assert csr.ell_items.dtype == csr.ell_row_piece.dtype == torch.int32
    spans = {}  # piece -> (first slot, slots)
    for lo, k0, _, w in items:
        npc, length = w & 63, w >> 6
        for t in range(npc):
            spans[k0 + t] = (lo + t * length, length)
    assert sorted(spans) == list(range(int(rp[-1])))
    covered = np.zeros(csr.ell_src.numel(), np.int64)
    for a, la in spans.values():
        covered[a:a + la] += 1
    assert (covered[live.numpy()] == 1).all()
    slot = row = 0
    for tbl, lv in zip(csr.ell_slices,
                       torch.split(live, [t.numel() for t in csr.ell_slices])):
        R, C = tbl.shape
        lv = lv.view(R, C).numpy()
        for r in range(R):
            pieces = [spans[k] for k in range(rp[row + r], rp[row + r + 1])]
            start = slot + r * C
            end = start + (C if C <= 16 else
                           int(np.nonzero(lv[r])[0].max()) + 1
                           if lv[r].any() else 0)
            assert pieces[0][0] == start
            assert all(a + la == b for (a, la), (b, _) in
                       zip(pieces, pieces[1:]))
            assert pieces[-1][0] + pieces[-1][1] == end
            assert max(la for _, la in pieces) <= tsp.ELL_SEG
        slot, row = slot + R * C, row + R
    assert slot == csr.ell_src.numel() and row + 1 == len(rp)


def _same_state(t_csr, j_csr):
    t_arrays, t_meta = tsp.csr_to_state(t_csr)
    j_arrays, j_meta = jsp.csr_to_state(j_csr)
    assert t_meta == j_meta and sorted(t_arrays) == sorted(j_arrays)
    for k, want in j_arrays.items():
        got = t_arrays[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert np.array_equal(got, want), k


@pytest.mark.parametrize("kind", ["bool", "minplus", "maxplus", "plustimes"])
def test_csr_from_state_keeps_the_jax_state(kind):
    """ROADMAP C.6: a JAX state carried into the port and back out is the
    JAX state field for field, shapes included: ``nnz`` and ``tail_nnz``
    are 0-d (``csr_from_state`` used to hand them back as (1,) arrays)."""
    edges = _edges("bool" if kind == "bool" else "plustimes", 100, 0.05, 6,
                   False)
    j_csr = jsp.build_csr(edges, 128, kind)
    carried = tsp.csr_from_state(*jsp.csr_to_state(j_csr), device="cpu")
    assert carried.nnz.shape == carried.tail_nnz.shape == ()
    _same_state(carried, j_csr)


@pytest.mark.parametrize("n,p,seed,powerlaw", GRAPHS)
@pytest.mark.parametrize("kind", LAYOUT_KINDS + ["minplus"])
def test_ell_order_after_build_append_fold_and_state(kind, n, p, seed,
                                                     powerlaw):
    """``build_csr``, ``csr_append`` into the COO tail and through a fold,
    and ``csr_from_state`` of a JAX state: the derived fields hold, and the
    state stays the JAX package's field for field."""
    if kind == "minplus":
        edges = _edges("plustimes", n, p, seed, powerlaw)
    else:
        edges = _edges(kind, n, p, seed, powerlaw)
    n_alloc = n + 28
    t_csr = tsp.build_csr(edges, n_alloc, kind, device="cpu")
    j_csr = jsp.build_csr(edges, n_alloc, kind)
    _check_ell_order(t_csr)
    _same_state(t_csr, j_csr)
    rng = np.random.default_rng(seed + 50)
    extra = np.sort(rng.integers(0, n, (4, 2)), axis=1)
    extra = extra[extra[:, 0] < extra[:, 1]]
    if kind != "bool":
        extra = np.concatenate([extra, np.ones((len(extra), 1), np.int64)], 1)
    tail = tsp.csr_append(t_csr, extra, rebuild_frac=1.0)  # into the tail
    assert tail.ell_src is t_csr.ell_src  # the spine did not move
    _check_ell_order(tail)
    _same_state(tail, jsp.csr_append(j_csr, extra, rebuild_frac=1.0))
    fold = tsp.csr_append(t_csr, extra, rebuild_frac=0.0)  # a fold
    _check_ell_order(fold)
    _same_state(fold, jsp.csr_append(j_csr, extra, rebuild_frac=0.0))
    carried = tsp.csr_from_state(*jsp.csr_to_state(j_csr), device="cpu")
    _check_ell_order(carried)
    _same_state(carried, j_csr)


@pytest.mark.parametrize("kind", LAYOUT_KINDS)
def test_ell_order_of_raw_triples(kind):
    """``spmv.raw_csr`` (the JAX API's raw-triple entries on the card):
    the sentinel spine's derived fields and a step equal to the triple's
    plain version."""
    edges = _edges(kind, 200, 0.03, 9, True)
    src = torch.from_numpy(edges[:, 0])
    dst = torch.from_numpy(edges[:, 1])
    val = torch.ones(len(edges), dtype=torch.bool) if kind == "bool" else \
        torch.from_numpy(edges[:, 2].astype(np.float32))
    csr = spmv.raw_csr(kind, 200, src, dst, val)
    _check_ell_order(csr)
    assert csr.ell_src.tolist() == [-1]
    rng = np.random.default_rng(3)
    f = torch.from_numpy(rng.random((5, 200)) < 0.2)
    if kind == "bool":
        got = spmv.plain_bool(f, csr)
    else:
        f = f.float() * 2 if kind == "plustimes" else \
            torch.where(f, 2.0, float("-inf"))
        got = spmv.ell_step_in_kernel_order(f, csr)
    assert torch.equal(got, spmv.ref.csr_raw_ref(kind, f, src, dst, val))


@pytest.mark.parametrize("B", [1, 31, 32, 33, 130])
def test_pack_bits_round_trip(B):
    """K3's frontier words: bit ``b % 32`` of word ``b // 32``, and back."""
    rng = np.random.default_rng(B)
    f = torch.from_numpy(rng.random((B, 77)) < 0.3)
    f[:, 5] = True  # bit 31 of a full word: the sign bit of an int32
    words = spmv.pack_bits(f)
    assert words.shape == (77, -(-B // 32)) and words.dtype == torch.int32
    u = words.numpy().view(np.uint32)
    for b in range(B):
        assert np.array_equal((u[:, b // 32] >> (b % 32)) & 1,
                              f[b].numpy().astype(np.uint32))
    assert torch.equal(spmv.unpack_bits(words, B), f)


def _plustimes_case(n, p, seed, powerlaw, b, kind="plustimes", fold=False):
    """A JAX CSR of ``kind`` with up to six arcs appended into its COO tail
    (or up to 40 through a fold), and the port's CSR from its state."""
    edges = _edges(kind, n, p, seed, powerlaw)
    j_csr = jsp.build_csr(edges, n + 28, kind)
    rng = np.random.default_rng(seed + 7)
    extra = np.sort(rng.integers(0, n, (40 if fold else 6, 2)), axis=1)
    extra = extra[extra[:, 0] < extra[:, 1]]
    j_csr = jsp.csr_append(j_csr, np.concatenate(
        [extra, rng.integers(1, 3, (len(extra), 1))], 1),
        rebuild_frac=0.0 if fold else 1.0)
    t_csr = tsp.csr_from_state(*jsp.csr_to_state(j_csr), device="cpu")
    return j_csr, t_csr, rng


@pytest.mark.parametrize("n,p,seed,powerlaw", GRAPHS)
@pytest.mark.parametrize("b", [1, 5])
def test_k5_order_equals_plain_and_pallas_on_integers(n, p, seed, powerlaw,
                                                      b):
    """K5's order of summation gives the plain step's and the JAX Pallas
    kernel's sums exactly on small-integer counts (every partial sum an
    integer below 2^24), spine and COO tail."""
    j_csr, t_csr, rng = _plustimes_case(n, p, seed, powerlaw, b)
    f = np.where(rng.random((b, n + 28)) < 0.3,
                 rng.integers(1, 4, (b, n + 28)), 0).astype(np.float32)
    got = spmv.ell_step_in_kernel_order(torch.from_numpy(f), t_csr)
    assert torch.equal(got, spmv.plain_plustimes(torch.from_numpy(f), t_csr))
    want = jops.csr_frontier_step("plustimes")(jnp.asarray(f), j_csr)
    assert np.array_equal(got.numpy(), np.asarray(want))
    one = spmv.ell_step_in_kernel_order(torch.from_numpy(f[0]), t_csr)
    assert torch.equal(one, got[0])


@pytest.mark.parametrize("n,p,seed,powerlaw", GRAPHS[:4])
def test_k5_order_on_non_integers_within_tolerance(n, p, seed, powerlaw):
    """On non-integer frontiers K5's order rounds differently from the
    plain step's and the Pallas kernel's.  Every term is nonnegative, so a
    sum of k terms in any order is within (k - 1)·2^-24 of the exact sum,
    relatively; k stays below 700 here, so rtol = 2^-24 · 700 < 5e-5."""
    j_csr, t_csr, rng = _plustimes_case(n, p, seed, powerlaw, 4)
    f = (rng.random((4, n + 28)) * (rng.random((4, n + 28)) < 0.5)).astype(
        np.float32)
    got = spmv.ell_step_in_kernel_order(torch.from_numpy(f), t_csr).numpy()
    plain = spmv.plain_plustimes(torch.from_numpy(f), t_csr).numpy()
    pallas = np.asarray(jops.csr_frontier_step("plustimes")(jnp.asarray(f),
                                                            j_csr))
    np.testing.assert_allclose(got, plain, rtol=5e-5, atol=0)
    np.testing.assert_allclose(got, pallas, rtol=5e-5, atol=0)


@pytest.mark.parametrize("n,p,seed,powerlaw", GRAPHS)
@pytest.mark.parametrize("append", ["tail", "fold"])
def test_k6_walk_equals_plain_and_pallas(n, p, seed, powerlaw, append):
    """K6's walk of the max-plus CSR's items in its own order
    (``spmv.ell_step_in_kernel_order``: each piece's max from -inf, the
    pieces, then the COO tail) equals the plain step and the JAX step over
    the Pallas ``csr_maxplus_spmv`` (interpret mode) exactly, after arcs
    went into the COO tail and after a fold, at B = 1, 3 and 8 and a
    fully dead frontier."""
    j_csr, t_csr, rng = _plustimes_case(n, p, seed, powerlaw, 1, "maxplus",
                                        fold=append == "fold")
    assert (int(t_csr.tail_nnz) > 0) == (append == "tail")
    _check_ell_order(t_csr)
    for b in (1, 3, 8):
        f = np.where(rng.random((b, n + 28)) < 0.3,
                     rng.integers(0, 5, (b, n + 28)), -np.inf).astype(
                         np.float32)
        if b == 8:
            f[:] = -np.inf
        got = spmv.ell_step_in_kernel_order(torch.from_numpy(f), t_csr)
        assert torch.equal(got, spmv.plain_maxplus(torch.from_numpy(f),
                                                   t_csr))
        want = jops.csr_frontier_step("maxplus")(jnp.asarray(f), j_csr)
        assert np.array_equal(got.numpy(), np.asarray(want))
    one = spmv.ell_step_in_kernel_order(torch.from_numpy(f[0]), t_csr)
    assert torch.equal(one, got[0])


def _service(program, pred, edges):
    svc = DatalogService(program, db={"d" if pred == "cpath" else "arc":
                                      edges}, sparse=True, device="cpu")
    return svc


@pytest.mark.parametrize("pred", ["tc", "cpath"])
def test_capture_frontiers_records_what_the_fixpoint_passes(pred):
    """On a small CPU CSR TC and CPATH service, the smoke's spy records as
    many frontiers as the warm batch's iterations, each equal to what
    ``fixpoint_csr`` passes its step when the batch's seed is replayed, and
    the batch's table, iterations and generated facts are JAX's."""
    kind = "bool" if pred == "tc" else "plustimes"
    n = 200
    edges = _edges(kind, n, 0.02, 31, True)
    if pred == "cpath":
        edges[:, 2] = 1
    program = chip_smoke.TC.replace("arc", "arc") if pred == "tc" else \
        chip_smoke.CPATH
    svc = _service(program, pred, edges)
    srcs = [0, 5, 17, 150]
    svc.ask_batch([(pred, (s, None) if pred == "tc" else (s, None, None))
                   for s in srcs])  # warm: the carrier is packed
    frontiers, res = chip_smoke.capture_frontiers(svc, pred, srcs)
    assert len(frontiers) == res.iterations > 1
    csr = svc._dense_state(pred).csr
    bp = tbatch.pad_batch_size(len(srcs), svc.batch_pads)
    init = tsp.rows_from_sources(csr, tbatch._padded_index(srcs, bp))
    init[len(srcs):] = csr.semiring.zero
    passed = []

    def record(f, c):
        passed.append(f.clone())
        return spmv.plain_bool(f, c) if kind == "bool" else \
            spmv.plain_plustimes(f, c)

    max_iters = None if kind == "bool" else additive_max_iters(csr.n_alloc)
    replay = tsp.fixpoint_csr(csr, init, spmv=record, max_iters=max_iters)
    assert replay.iterations == res.iterations == len(passed)
    assert all(torch.equal(a, b) for a, b in zip(frontiers, passed))
    assert torch.equal(replay.table, res.table)
    j_csr = jsp.build_csr(edges, csr.n_alloc, kind)
    want = jbatch.run_frontier_batch_csr(j_csr, srcs, svc.batch_pads)
    assert (res.iterations, res.generated) == (int(want.iterations),
                                               int(want.generated))
    assert np.array_equal(res.table.numpy(), np.asarray(want.table))
