"""Port parity of the CSR carrier: the packed layout array for array, state
carried across packages both ways, the plain K3 (bool), K4 (min-plus), K5
(plus-times) and K6 (max-plus) steps against the JAX Pallas kernels
(interpret mode, spine and COO tail), and the CSR fixpoints' table,
iteration count and generated-fact count (vector and accumulate forms).
Every comparison is exact: the plus-times inputs are small integers, so
every sum is an integer below 2^24 whatever the order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import seminaive as jsn
from repro.core import sparse as jsp
from repro.data import graphs as jgraphs
from repro.kernels import ops as jops
from repro.service import batch as jbatch
from repro_torch.core import seminaive as tsn
from repro_torch.core import sparse as tsp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spmv
from repro_torch.service import batch as tbatch


KINDS = ["bool", "minplus", "maxplus", "plustimes"]
#: the largest arc weight per carrier: plus-times keeps sums small
MAX_W = {"minplus": 9, "maxplus": 9, "plustimes": 2}


def _weigh(rng, kind, e):
    if kind == "bool":
        return e
    return np.concatenate([e, rng.integers(1, MAX_W[kind] + 1, (len(e), 1))],
                          axis=1)


def _edges(kind, n, p, seed, powerlaw=False):
    """A Gn-p or power-law edge list; max-plus and plus-times keep only the
    arcs with src < dst (a DAG, where both carriers have a fixpoint)."""
    rng = np.random.default_rng(seed)
    if powerlaw:
        e = jgraphs.powerlaw_graph(n, int(p * n * n), alpha=1.2, seed=seed)
    else:
        e = jgraphs.gnp_graph(n, p, seed=seed)
    if kind in ("maxplus", "plustimes"):
        e = e[e[:, 0] < e[:, 1]]
    return _weigh(rng, kind, e)


def _with_tail(csr, kind, n, seed):
    """A JAX CSR whose COO tail holds a few appended arcs (for max-plus and
    plus-times only those with src < dst, minus any the spine holds)."""
    rng = np.random.default_rng(seed)
    extra = np.stack([rng.integers(0, n, 5), rng.integers(0, n, 5)], 1)
    dag = kind in ("maxplus", "plustimes")
    if dag:
        extra = np.sort(extra, axis=1)
        extra = extra[extra[:, 0] < extra[:, 1]]
    out = jsp.csr_append(csr, _weigh(rng, kind, extra))
    assert int(out.tail_nnz) > 0 if dag else int(out.tail_nnz) == 5
    return out


def _frontier(kind, b, n, seed, p=0.2):
    rng = np.random.default_rng(seed)
    if kind == "bool":
        return rng.random((b, n)) < p
    hit = rng.random((b, n)) < p
    if kind == "plustimes":
        return np.where(hit, rng.integers(1, 4, (b, n)), 0).astype(np.float32)
    zero = np.inf if kind == "minplus" else -np.inf
    return np.where(hit, rng.integers(1, 10, (b, n)), zero).astype(np.float32)


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


@pytest.mark.parametrize("kind", KINDS)
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


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b,n", [(1, 64), (3, 100), (8, 130)])
def test_plain_csr_steps_match_pallas(kind, b, n):
    """K3-K6's plain versions == the JAX Pallas steps (one-hot scatter /
    masked broadcast-min or -max), over spine AND tail."""
    edges = _edges(kind, n, 0.04 if kind in ("bool", "minplus") else 0.08,
                   n + b)
    j_csr = _with_tail(jsp.build_csr(edges, n, kind), kind, n, b)
    f = _frontier(kind, b, n, n * b)
    want = jops.csr_frontier_step(kind)(jnp.asarray(f), j_csr)
    step = {"bool": spmv.csr_bool_step, "minplus": spmv.csr_minplus_step,
            "maxplus": spmv.csr_maxplus_step,
            "plustimes": spmv.csr_plustimes_step}[kind]
    # min-plus dispatches on the CSR's plan: K4 without one, K7 with one
    assert tops.csr_frontier_step(kind) is (
        tops._csr_minplus_step if kind == "minplus" else step)
    got = step(torch.from_numpy(f), _port(j_csr))
    assert _same(got, want)
    one = step(torch.from_numpy(f[0]), _port(j_csr))  # (n,) frontier
    assert _same(one, np.asarray(want)[0])


@pytest.mark.parametrize("kind", KINDS)
def test_rows_from_sources_matches_jax(kind):
    edges = _edges(kind, 120, 0.03, 12)
    j_csr = jsp.build_csr(edges, 128, kind)
    srcs = [0, 3, 3, 119, 127]
    want = jsp.rows_from_sources(j_csr, srcs)
    assert _same(tsp.rows_from_sources(_port(j_csr), srcs), want)


@pytest.mark.parametrize("kind,powerlaw", [("bool", True),
                                           ("minplus", False),
                                           ("maxplus", True),
                                           ("plustimes", True),
                                           ("plustimes", False)])
def test_fixpoint_csr_with_pad_rows_matches_jax(kind, powerlaw):
    """The batch layer's CSR fixpoint (seeds through the step, ⊕-zero pad
    rows; the accumulate form for plus-times): equal table, iterations and
    generated facts, also when the iteration bound cuts it short."""
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


def test_counts_batch_csr_and_divergence_match_jax():
    """``counts_batch_csr`` on a DAG equals JAX's (the accumulate form's
    ``n_alloc + 2`` bound); on a cycle both raise
    ``FixpointDivergenceError`` with the same message."""
    n = 110
    edges = _edges("plustimes", n, 0.05, 41)
    j_csr = jsp.build_csr(edges, 128, "plustimes")
    t_csr = _port(j_csr)
    srcs = [0, 4, 60]
    want = jsp.counts_batch_csr(j_csr, srcs)
    got = tsp.counts_batch_csr(t_csr, srcs)
    assert _same(got.table, want.table) and got.iterations > 2
    assert (got.iterations, got.generated) == \
        (int(want.iterations), int(want.generated))
    cyc = np.concatenate([edges, [[9, 0, 1]], [[0, 9, 1]]])
    j_cyc = jsp.build_csr(cyc, 128, "plustimes")
    with pytest.raises(jsn.FixpointDivergenceError, match=r"\(130\)") as jerr:
        jsp.counts_batch_csr(j_cyc, srcs)
    with pytest.raises(tsn.FixpointDivergenceError) as terr:
        tsp.counts_batch_csr(_port(j_cyc), srcs)
    assert str(terr.value) == str(jerr.value)


def test_additive_csr_packing_dedupes_like_jax():
    """Plus-times arcs are a set: duplicate rows pack once, in both
    packages, so a parallel duplicate cannot count twice."""
    edges = _edges("plustimes", 60, 0.08, 43)
    dup = np.concatenate([edges, edges[:9], edges[:2]])
    j_arrays, _ = jsp.csr_to_state(jsp.build_csr(dup, 64, "plustimes"))
    t_arrays, _ = tsp.csr_to_state(tsp.build_csr(dup, 64, "plustimes",
                                                 device="cpu"))
    ref_arrays, _ = tsp.csr_to_state(tsp.build_csr(edges, 64, "plustimes",
                                                   device="cpu"))
    for k, want in j_arrays.items():
        assert np.array_equal(t_arrays[k], want), k
        assert np.array_equal(ref_arrays[k], want), k


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
    """The density cut equals JAX's; a carrier kind neither package has is
    refused (every kind of the routing table is ported)."""
    for nnz, n in ((10, 100), (200, 100), (0, 0), (156, 100)):
        assert tsp.prefer_csr(nnz, n) == jsp.prefer_csr(nnz, n)
    assert tsp.DEFAULT_SPARSE_THRESHOLD == jsp.DEFAULT_SPARSE_THRESHOLD
    with pytest.raises(KeyError):
        tops.csr_frontier_step("minmax")
    edges = np.array([[0, 1, 2]], np.int64)
    with pytest.raises(ValueError, match="minmax"):
        tsp.build_csr(edges, 8, "minmax", device="cpu")
    with pytest.raises(ValueError, match="n_alloc"):
        tsp.build_csr(edges, 1, "minplus", device="cpu")
    with pytest.raises(ValueError, match="n_alloc"):
        tsp.rows_from_sources(tsp.build_csr(edges, 8, "minplus", device="cpu"),
                              [3, 8])
