"""Port parity of the dense carrier: semirings, the plain versions of the
K1 (bool) and K2 (min-plus and max-plus) frontier kernels against the JAX
Pallas kernels (interpret mode, as ``tests/test_kernels.py`` runs them), the
dense plus-times product, and the dense fixpoints' table, iteration count
and generated-fact count (vector and accumulate forms).  Inputs are made
with numpy from a seed and fed to both packages; every comparison is exact
(bool is exact, min/max of sums of small integers in f32 are exact whatever
the order, and so are sums of integers below 2^24)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import seminaive as jsn
from repro.core import semiring as jsr
from repro.kernels import ops as jops
from repro.service import batch as jbatch
from repro_torch.core import seminaive as tsn
from repro_torch.core import semiring as tsr
from repro_torch.kernels import boolmm, build, minplus
from repro_torch.kernels import ops as tops
from repro_torch.service import batch as tbatch

RAGGED = [(1, 50), (3, 200), (8, 128), (17, 130), (3, 1000)]


def _bool(rng, shape, p):
    return rng.random(shape) < p


def _dist(rng, shape, p):
    return np.where(rng.random(shape) < p, rng.integers(1, 10, shape),
                    np.inf).astype(np.float32)


def _neg_inf(x):
    """A min-plus array re-zeroed for max-plus (+inf -> -inf)."""
    return np.where(np.isinf(x), -np.inf, x).astype(np.float32)


def _count(rng, shape, p, dag=False):
    """Small integer weights (0 = no arc); ``dag`` keeps the strict upper
    triangle, so accumulate fixpoints drain."""
    w = np.where(rng.random(shape) < p, rng.integers(1, 3, shape), 0)
    return (np.triu(w, k=1) if dag else w).astype(np.float32)


def _same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    got = got.numpy()
    return got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("b,n", RAGGED)
def test_k1_plain_matches_pallas_bool_frontier(b, n):
    rng = np.random.default_rng(b * 1000 + n)
    f, adj = _bool(rng, (b, n), 0.2), _bool(rng, (n, n), 0.05)
    want = jops.bool_frontier(jnp.asarray(f), jnp.asarray(adj))
    got = boolmm.bool_frontier_matmul(torch.from_numpy(f),
                                      torch.from_numpy(adj))
    assert _same(got, want)


@pytest.mark.parametrize("b,n", RAGGED)
def test_k2_plain_matches_pallas_minplus_frontier(b, n):
    rng = np.random.default_rng(b * 1000 + n + 1)
    f, w = _dist(rng, (b, n), 0.3), _dist(rng, (n, n), 0.05)
    want = jops.minplus_frontier(jnp.asarray(f), jnp.asarray(w))
    got = minplus.minplus_frontier_matmul(torch.from_numpy(f),
                                          torch.from_numpy(w))
    assert _same(got, want)


@pytest.mark.parametrize("b,n", RAGGED)
def test_k2_max_plain_matches_pallas_maxplus_frontier(b, n):
    """The max-plus instantiation's plain version == the JAX route (the
    min-plus Pallas kernel through negation)."""
    rng = np.random.default_rng(b * 1000 + n + 2)
    f, w = _neg_inf(_dist(rng, (b, n), 0.3)), _neg_inf(_dist(rng, (n, n), 0.05))
    want = jops.maxplus_frontier(jnp.asarray(f), jnp.asarray(w))
    got = minplus.maxplus_frontier_matmul(torch.from_numpy(f),
                                          torch.from_numpy(w))
    assert _same(got, want)
    assert _same(minplus.plain_max(torch.from_numpy(f), torch.from_numpy(w)),
                 jsr.MAX_PLUS.matmul(jnp.asarray(f), jnp.asarray(w)))


@pytest.mark.parametrize("name", ["bool", "min_plus", "max_plus",
                                  "plus_times"])
def test_semiring_matmul_matches_jax(name):
    """The plain ⊕.⊗ product, K-chunked for the tropical carriers (k = 130
    leaves a ragged last chunk)."""
    rng = np.random.default_rng(5)
    if name == "bool":
        a, b = _bool(rng, (7, 130), 0.1), _bool(rng, (130, 40), 0.1)
    elif name == "plus_times":  # small integers: the sum is exact
        a = rng.integers(0, 3, (7, 130)).astype(np.float32)
        b = rng.integers(0, 3, (130, 40)).astype(np.float32)
    else:
        a, b = _dist(rng, (7, 130), 0.3), _dist(rng, (130, 40), 0.3)
        if name == "max_plus":
            a, b = np.where(np.isinf(a), -np.inf, a), \
                np.where(np.isinf(b), -np.inf, b)
    want = jsr.BY_NAME[name].matmul(jnp.asarray(a), jnp.asarray(b))
    got = tsr.BY_NAME[name].matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert _same(got, want)
    assert tsr.BY_NAME[name].zero == jsr.BY_NAME[name].zero
    assert tsr.BY_NAME[name].idempotent == jsr.BY_NAME[name].idempotent


def test_carrier_routing_matches_jax():
    for kind in ("bool", "minplus", "maxplus", "plustimes"):
        assert tsr.carrier_for(kind).name == jsr.carrier_for(kind).name
        assert tsr.edge_arity(kind) == jsr.edge_arity(kind)
    with pytest.raises(tsr.CarrierError):
        tsr.carrier_for("minmax")


def test_inf_aware_compare_matches_jax():
    a = np.array([1, np.inf, -np.inf, np.inf, 2, 3], np.float32)
    b = np.array([1, np.inf, -np.inf, -np.inf, 3, np.inf], np.float32)
    want = jsn._ne(jsr.MIN_PLUS, jnp.asarray(a), jnp.asarray(b))
    assert _same(tsn._ne(tsr.MIN_PLUS, torch.from_numpy(a),
                         torch.from_numpy(b)), want)


def _seeds(matrix, srcs, b_pad, zero):
    idx = np.asarray(srcs + [srcs[0]] * (b_pad - len(srcs)))
    init = np.array(matrix[idx])
    init[len(srcs):] = zero  # pad rows, as the batch layer zeroes them
    return init


@pytest.mark.parametrize("kind,n,p", [("bool", 90, 0.03),
                                      ("bool", 150, 0.01),
                                      ("minplus", 90, 0.04),
                                      ("minplus", 130, 0.02),
                                      ("maxplus", 90, 0.08),
                                      ("maxplus", 130, 0.03)])
def test_fixpoint_dense_vector_form_matches_jax(kind, n, p):
    """Batched (B, n) vector fixpoint with ⊕-zero pad rows: equal table,
    iterations and generated facts (max-plus over a DAG: upper triangle)."""
    rng = np.random.default_rng(n)
    if kind == "bool":
        arc, jsr_, tsr_ = _bool(rng, (n, n), p), jsr.BOOL, tsr.BOOL
    elif kind == "minplus":
        arc, jsr_, tsr_ = _dist(rng, (n, n), p), jsr.MIN_PLUS, tsr.MIN_PLUS
    else:
        arc = _neg_inf(np.where(np.triu(np.ones((n, n), bool), k=1),
                                _dist(rng, (n, n), p), np.inf))
        jsr_, tsr_ = jsr.MAX_PLUS, tsr.MAX_PLUS
    init = _seeds(arc, [0, 7, 40], 8, jsr_.zero)
    want = jsn.fixpoint_dense(jsr_, jnp.asarray(arc), jnp.asarray(init),
                              form="vector")
    got = tsn.fixpoint_dense(tsr_, torch.from_numpy(arc),
                             torch.from_numpy(init), form="vector")
    assert _same(got.table, want.table)
    assert got.iterations == int(want.iterations)
    assert got.generated == int(want.generated)


@pytest.mark.parametrize("kind", ["bool", "minplus"])
def test_fixpoint_dense_linear_and_single_row_match_jax(kind):
    rng = np.random.default_rng(11)
    n = 60
    if kind == "bool":
        arc, jsr_, tsr_ = _bool(rng, (n, n), 0.04), jsr.BOOL, tsr.BOOL
    else:
        arc, jsr_, tsr_ = _dist(rng, (n, n), 0.05), jsr.MIN_PLUS, tsr.MIN_PLUS
    for form, init in (("linear", arc), ("vector", arc[3])):
        want = jsn.fixpoint_dense(jsr_, jnp.asarray(arc), jnp.asarray(init),
                                  form=form)
        got = tsn.fixpoint_dense(tsr_, torch.from_numpy(arc),
                                 torch.from_numpy(np.array(init)), form=form)
        assert _same(got.table, want.table), form
        assert (got.iterations, got.generated) == \
            (int(want.iterations), int(want.generated)), form


@pytest.mark.parametrize("n,p,max_iters", [(90, 0.05, None), (130, 0.03, None),
                                           (90, 0.05, 3)])
def test_fixpoint_dense_accumulate_form_matches_jax(n, p, max_iters):
    """The additive carrier's accumulate form (total = Σ Δ, Δ <- Δ ⊗ arc)
    with ⊕-zero pad rows: equal table, iterations and generated facts,
    also when the iteration bound cuts it short."""
    rng = np.random.default_rng(n + 7)
    arc = _count(rng, (n, n), p, dag=True)
    init = _seeds(arc, [0, 2, 33], 8, 0.0)
    want = jsn.fixpoint_dense(jsr.PLUS_TIMES, jnp.asarray(arc),
                              jnp.asarray(init), form="accumulate",
                              max_iters=max_iters)
    got = tsn.fixpoint_dense(tsr.PLUS_TIMES, torch.from_numpy(arc),
                             torch.from_numpy(init), form="accumulate",
                             max_iters=max_iters)
    assert _same(got.table, want.table)
    assert got.iterations == int(want.iterations)
    assert got.generated == int(want.generated)
    one = tsn.fixpoint_dense(tsr.PLUS_TIMES, torch.from_numpy(arc),
                             torch.from_numpy(init[0]), form="accumulate",
                             max_iters=max_iters)  # (n,) frontier
    assert _same(one.table, np.asarray(want.table)[0])
    with pytest.raises(ValueError, match="additive"):
        tsn.fixpoint_dense(tsr.MIN_PLUS, torch.from_numpy(arc),
                           torch.from_numpy(init), form="accumulate")


def test_counts_batch_dense_and_divergence_match_jax():
    """``counts_batch_dense`` on a DAG equals JAX's; on a cycle both hit the
    n + 2 bound and raise ``FixpointDivergenceError``."""
    rng = np.random.default_rng(17)
    n = 70
    dag = _count(rng, (n, n), 0.06, dag=True)
    srcs = [0, 1, 40]
    want = jsn.counts_batch_dense(jnp.asarray(dag), srcs)
    got = tsn.counts_batch_dense(torch.from_numpy(dag), srcs)
    assert _same(got.table, want.table)
    assert (got.iterations, got.generated) == \
        (int(want.iterations), int(want.generated))
    assert tsn.additive_max_iters(n) == jsn.additive_max_iters(n) == n + 2
    cyc = dag.copy()
    cyc[5, 0] = 1.0  # 0 -> ... -> 5 -> 0
    cyc[0, 5] = 1.0
    with pytest.raises(jsn.FixpointDivergenceError, match=r"\(72\)") as jerr:
        jsn.counts_batch_dense(jnp.asarray(cyc), srcs)
    with pytest.raises(tsn.FixpointDivergenceError) as terr:
        tsn.counts_batch_dense(torch.from_numpy(cyc), srcs)
    assert str(terr.value) == str(jerr.value)


def test_batch_helpers_and_iteration_bound_match_jax():
    rng = np.random.default_rng(3)
    n = 70
    adj, w = _bool(rng, (n, n), 0.03), _dist(rng, (n, n), 0.03)
    srcs = [0, 5, 69]
    for jfn, tfn, arc in ((jsn.reachable_batch_dense,
                           tsn.reachable_batch_dense, adj),
                          (jsn.distances_batch_dense,
                           tsn.distances_batch_dense, w)):
        for max_iters in (None, 2):
            want = jfn(jnp.asarray(arc), srcs, max_iters=max_iters)
            got = tfn(torch.from_numpy(arc), srcs, max_iters=max_iters)
            assert _same(got.table, want.table)
            assert (got.iterations, got.generated) == \
                (int(want.iterations), int(want.generated))
    assert tsn.GEN_DTYPE == torch.int64 and jsn.GEN_DTYPE == jnp.int64


@pytest.mark.parametrize("srcs,pads", [([4], (1, 8)), ([0, 3, 9], (1, 8)),
                                       (list(range(9)), (1, 8, 32))])
def test_run_frontier_batch_pads_like_jax(srcs, pads):
    rng = np.random.default_rng(len(srcs))
    n = 80
    upper = np.triu(np.ones((n, n), bool), k=1)
    for jsr_, tsr_, arc in ((jsr.BOOL, tsr.BOOL, _bool(rng, (n, n), 0.03)),
                            (jsr.MIN_PLUS, tsr.MIN_PLUS,
                             _dist(rng, (n, n), 0.03)),
                            (jsr.MAX_PLUS, tsr.MAX_PLUS,
                             _neg_inf(np.where(upper, _dist(rng, (n, n), 0.06),
                                               np.inf))),
                            (jsr.PLUS_TIMES, tsr.PLUS_TIMES,
                             _count(rng, (n, n), 0.06, dag=True))):
        want = jbatch.run_frontier_batch(jsr_, jnp.asarray(arc), srcs, pads)
        got = tbatch.run_frontier_batch(tsr_, torch.from_numpy(arc), srcs,
                                        pads)
        assert tbatch.pad_batch_size(len(srcs), pads) == \
            jbatch.pad_batch_size(len(srcs), pads) == got.table.shape[0]
        assert _same(got.table, want.table)
        assert (got.iterations, got.generated) == \
            (int(want.iterations), int(want.generated))


@pytest.mark.parametrize("x", [0, 1, 7, 8, 9, 100, 1024, 1025])
def test_quantize_matches_jax(x):
    assert tsn.quantize_rows(x) == jsn.quantize_rows(x)
    assert tsn.quantize_rows(x, minimum=1) == jsn.quantize_rows(x, minimum=1)
    for floor, stride in ((1, 1), (1, 0), (2, 2), (4, 1)):
        assert tsn.quantize_ladder(floor, stride, x) == \
            jsn.quantize_ladder(floor, stride, x)


def test_wrappers_route_by_device():
    """A CPU tensor runs the plain version and counts no launch; a tensor on
    neither the CPU nor a CUDA device is refused, never computed."""
    rng = np.random.default_rng(0)
    f = torch.from_numpy(_bool(rng, (2, 16), 0.3))
    a = torch.from_numpy(_bool(rng, (16, 16), 0.3))
    before = tops.launch_counts()
    assert torch.equal(tops.frontier_matmul("bool")(f, a), boolmm.plain(f, a))
    assert tops.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        boolmm.bool_matmul(f.to("meta"), a.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        minplus.minplus_matmul(f.float(), a.float().to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        minplus.maxplus_matmul(f.float(), a.float().to("meta"))
    assert set(before) == {"bool_matmul", "minplus_matmul", "maxplus_matmul",
                           "csr_bool_step", "csr_minplus_step",
                           "csr_maxplus_step", "csr_plustimes_step",
                           "csr_minplus_tiled_step", "relax_step",
                           "relax_step_tiled", "flash_attention",
                           "flash_attention_f32", "rglru_scan"}
    assert build.SOURCES == ("boolmm", "minplus", "spmv", "relax",
                             "flash_attention", "rglru_scan")


@pytest.mark.parametrize("name", ["bool", "min_plus", "max_plus",
                                  "plus_times"])
def test_frontier_matmul_routes_every_carrier(name):
    """Each carrier's dense ⊗ is the port's wrapper for it, and on CPU
    tensors equals the semiring's plain product; unknown names raise."""
    rng = np.random.default_rng(1)
    if name == "bool":
        f, w = _bool(rng, (3, 40), 0.2), _bool(rng, (40, 40), 0.1)
    elif name == "plus_times":
        f, w = _count(rng, (3, 40), 0.2), _count(rng, (40, 40), 0.1)
    else:
        f, w = _dist(rng, (3, 40), 0.3), _dist(rng, (40, 40), 0.1)
        if name == "max_plus":
            f, w = _neg_inf(f), _neg_inf(w)
    f, w = torch.from_numpy(f), torch.from_numpy(w)
    before = tops.launch_counts()
    got = tops.frontier_matmul(name)(f, w)
    assert torch.equal(got, tsr.BY_NAME[name].matmul(f, w))
    assert tops.launch_counts() == before
    with pytest.raises(KeyError):
        tops.frontier_matmul("tropical")


def test_dense_plus_times_refuses_tf32_on_the_card(monkeypatch):
    """On a CUDA operand the dense plus-times product raises while PyTorch
    lets f32 products use TF32, and never changes the setting itself.  The
    card is stood in for by routing every operand to it (the product then
    runs on the CPU tensors)."""
    f = torch.ones((2, 4))
    w = torch.ones((4, 4))
    monkeypatch.setattr(build, "on_card", lambda what, *ts: True)
    assert torch.equal(tops.plustimes_frontier_matmul(f, w), f @ w)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        tops.plustimes_frontier_matmul(f, w)
    assert torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            tops.plustimes_frontier_matmul(f, w)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prec)
