"""Port parity of the CSR carrier: the packed layout array for array, state
carried across packages both ways, the plain K3 (bool) and K4 (min-plus)
steps against the JAX Pallas kernels (interpret mode, spine and COO tail),
and the CSR fixpoints' table, iteration count and generated-fact count.
Every comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse as jsp
from repro.data import graphs as jgraphs
from repro.kernels import ops as jops
from repro.service import batch as jbatch
from repro_torch.core import sparse as tsp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spmv
from repro_torch.service import batch as tbatch


def _edges(kind, n, p, seed, powerlaw=False):
    rng = np.random.default_rng(seed)
    if powerlaw:
        e = jgraphs.powerlaw_graph(n, int(p * n * n), alpha=1.2, seed=seed)
    else:
        e = jgraphs.gnp_graph(n, p, seed=seed)
    if kind == "minplus":
        e = np.concatenate([e, rng.integers(1, 10, (len(e), 1))], axis=1)
    return e


def _with_tail(csr, kind, n, seed):
    """A JAX CSR whose COO tail holds a few appended arcs."""
    rng = np.random.default_rng(seed)
    extra = np.stack([rng.integers(0, n, 5), rng.integers(0, n, 5)], 1)
    if kind == "minplus":
        extra = np.concatenate([extra, rng.integers(1, 10, (5, 1))], 1)
    out = jsp.csr_append(csr, extra)
    assert int(out.tail_nnz) == 5
    return out


def _frontier(kind, b, n, seed, p=0.2):
    rng = np.random.default_rng(seed)
    if kind == "bool":
        return rng.random((b, n)) < p
    return np.where(rng.random((b, n)) < p, rng.integers(1, 10, (b, n)),
                    np.inf).astype(np.float32)


def _same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    got = got.numpy()
    return got.dtype == want.dtype and np.array_equal(got, want)


def _port(csr):
    return tsp.csr_from_state(*jsp.csr_to_state(csr), device="cpu")


GRAPHS = [("bool", 100, 0.05, 0, False), ("minplus", 100, 0.05, 1, False),
          ("bool", 300, 0.02, 2, True), ("minplus", 300, 0.02, 3, True),
          ("bool", 40, 0.0, 4, False)]


@pytest.mark.parametrize("kind,n,p,seed,powerlaw", GRAPHS)
@pytest.mark.parametrize("ell_cfg", [(1, 1), (1, 0), (2, 2)])
def test_build_csr_state_equals_jax_field_for_field(kind, n, p, seed,
                                                    powerlaw, ell_cfg):
    edges = _edges(kind, n, p, seed, powerlaw)
    n_alloc = n + 28
    j_arrays, j_meta = jsp.csr_to_state(
        jsp.build_csr(edges, n_alloc, kind, ell_cfg=ell_cfg))
    t_csr = tsp.build_csr(edges, n_alloc, kind, ell_cfg=ell_cfg,
                          device="cpu")
    t_arrays, t_meta = tsp.csr_to_state(t_csr)
    assert t_meta == j_meta
    assert sorted(t_arrays) == sorted(j_arrays)
    for k, want in j_arrays.items():
        got = t_arrays[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert np.array_equal(got, want), k
    j_csr = jsp.build_csr(edges, n_alloc, kind, ell_cfg=ell_cfg)
    assert (t_csr.capacity, t_csr.deg_cap, t_csr.e_alloc, t_csr.density(),
            t_csr.padding_waste()) == (j_csr.capacity, j_csr.deg_cap,
                                       j_csr.e_alloc, j_csr.density(),
                                       j_csr.padding_waste())


@pytest.mark.parametrize("kind", ["bool", "minplus"])
def test_state_carries_across_both_ways(kind):
    edges = _edges(kind, 96, 0.05, 7)
    j_csr = _with_tail(jsp.build_csr(edges, 128, kind), kind, 96, 8)
    t_csr = _port(j_csr)
    assert int(t_csr.tail_nnz) == 5 and t_csr.device.type == "cpu"
    back = jsp.csr_from_state(*tsp.csr_to_state(t_csr))
    f = _frontier(kind, 4, 128, 9)
    step = jsp.csr_frontier_step(kind)
    assert np.array_equal(np.asarray(step(jnp.asarray(f), back)),
                          np.asarray(step(jnp.asarray(f), j_csr)))


@pytest.mark.parametrize("kind", ["bool", "minplus"])
@pytest.mark.parametrize("b,n", [(1, 64), (3, 100), (8, 130)])
def test_plain_csr_steps_match_pallas(kind, b, n):
    """K3/K4's plain versions == the JAX Pallas steps (one-hot scatter /
    masked broadcast-min), over spine AND tail."""
    edges = _edges(kind, n, 0.04, n + b)
    j_csr = _with_tail(jsp.build_csr(edges, n, kind), kind, n, b)
    f = _frontier(kind, b, n, n * b)
    want = jops.csr_frontier_step(kind)(jnp.asarray(f), j_csr)
    step = spmv.csr_bool_step if kind == "bool" else spmv.csr_minplus_step
    got = step(torch.from_numpy(f), _port(j_csr))
    assert _same(got, want)
    one = step(torch.from_numpy(f[0]), _port(j_csr))  # (n,) frontier
    assert _same(one, np.asarray(want)[0])


@pytest.mark.parametrize("kind", ["bool", "minplus"])
def test_rows_from_sources_matches_jax(kind):
    edges = _edges(kind, 120, 0.03, 12)
    j_csr = jsp.build_csr(edges, 128, kind)
    srcs = [0, 3, 3, 119, 127]
    want = jsp.rows_from_sources(j_csr, srcs)
    assert _same(tsp.rows_from_sources(_port(j_csr), srcs), want)


@pytest.mark.parametrize("kind,powerlaw", [("bool", True),
                                           ("minplus", False)])
def test_fixpoint_csr_with_pad_rows_matches_jax(kind, powerlaw):
    """The batch layer's CSR fixpoint (seeds through the step, ⊕-zero pad
    rows): equal table, iterations and generated facts."""
    n = 120
    edges = _edges(kind, n, 0.025, 21, powerlaw)
    j_csr = _with_tail(jsp.build_csr(edges, 128, kind), kind, n, 22)
    t_csr = _port(j_csr)
    srcs, pads = [0, 17, 110], (1, 8, 32)
    want = jbatch.run_frontier_batch_csr(j_csr, srcs, pads)
    got = tbatch.run_frontier_batch_csr(t_csr, srcs, pads)
    assert got.table.shape[0] == 8
    assert _same(got.table, want.table)
    assert (got.iterations, got.generated) == \
        (int(want.iterations), int(want.generated))
    init = tsp.rows_from_sources(t_csr, srcs)
    capped = tsp.fixpoint_csr(t_csr, init, max_iters=2)
    j_capped = jsp.fixpoint_csr(j_csr, jsp.rows_from_sources(j_csr, srcs),
                                max_iters=2)
    assert _same(capped.table, j_capped.table) and capped.iterations == 2


def test_dense_and_csr_carriers_agree_in_the_port():
    n = 150
    edges = _edges("minplus", n, 0.02, 31)
    w = np.full((n, n), np.inf, np.float32)
    np.minimum.at(w, (edges[:, 0], edges[:, 1]), edges[:, 2].astype(np.float32))
    csr = tsp.build_csr(edges, n, "minplus", device="cpu")
    srcs = [1, 2, 99]
    from repro_torch.core.seminaive import distances_batch_dense
    dense = distances_batch_dense(torch.from_numpy(w), srcs)
    sparse = tsp.fixpoint_csr_cached(csr, tsp.rows_from_sources(csr, srcs))
    assert torch.equal(dense.table, sparse.table)


def test_prefer_csr_and_unported_carriers():
    for nnz, n in ((10, 100), (200, 100), (0, 0), (156, 100)):
        assert tsp.prefer_csr(nnz, n) == jsp.prefer_csr(nnz, n)
    assert tsp.DEFAULT_SPARSE_THRESHOLD == jsp.DEFAULT_SPARSE_THRESHOLD
    for kind in ("maxplus", "plustimes"):
        with pytest.raises(NotImplementedError, match="A.1"):
            tops.csr_frontier_step(kind)
    edges = np.array([[0, 1, 2]], np.int64)
    with pytest.raises(NotImplementedError, match="A.1"):
        tsp.fixpoint_csr(tsp.build_csr(edges, 8, "plustimes", device="cpu"),
                         torch.zeros(1, 8))
    with pytest.raises(ValueError, match="n_alloc"):
        tsp.build_csr(edges, 1, "minplus", device="cpu")
    with pytest.raises(ValueError, match="n_alloc"):
        tsp.rows_from_sources(tsp.build_csr(edges, 8, "minplus", device="cpu"),
                              [3, 8])
