"""Port parity of the LM kernels' plain versions: K9 (``flash_attention``,
forward GQA attention with causal, window and softcap masks) against the
JAX Pallas kernel in interpret mode and against the JAX
``ref.flash_attention_ref`` at ragged sizes; K10 (``rglru_scan``, the
RG-LRU recurrence) against the JAX ``ref.rglru_scan_ref`` (the Pallas
kernel itself does not run under this jax: ROADMAP C.1), and the Hopper
kernel's walk rendered in PyTorch (``rglru_scan.scan_in_kernel_order``)
against the plain version, exactly.  Inputs are made
with numpy from a seed and fed to both packages; each comparison states
its tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, flash_attention, rglru_scan
from repro_torch.kernels import ops as tops

RNG_SEED = 15


def _qkv(rng, b, hq, hkv, s, d):
    """q (b, hq, s, d), k and v (b, hkv, s, d): standard normal f32."""
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]


def _both(arrs, dtype):
    """The same values as a JAX array and a tensor of ``dtype``."""
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got: torch.Tensor, want, dtype: str, atol: float) -> float:
    """Max abs error of the port's output against JAX's, held to ``atol``
    plus, for bf16, one bf16 rounding step of the output (2^-7 of the
    value): both compute in f32 and round once at the end, and f32 sums
    taken in another order can land on either side of a rounding edge."""
    g = got.to(torch.float32).numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    tol = atol + (2.0 ** -7 * np.abs(w) if dtype == "bf16" else 0.0)
    diff = np.abs(g - w)
    assert got.shape == tuple(w.shape)
    assert np.all(diff <= tol), float(diff.max())
    return float(diff.max())


# f32: the two packages' f32 einsums and softmax sum in other orders; the
# JAX package holds its own kernel to its reference at 2e-6 on these inputs
F32_ATOL = 2e-6


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=True, window=64),
    dict(causal=True, softcap=30.0), dict(causal=False),
])
def test_flash_plain_matches_pallas_variants(kw, dtype):
    """The variants of ``tests/test_kernels.py::test_flash_attention_variants``
    at its shapes: the plain K9 against the Pallas kernel (interpret)."""
    rng = np.random.default_rng(RNG_SEED)
    arrs = _qkv(rng, 2, 4, 2, 256, 64)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    want = jops.flash(jq, jk, jv, interpret=True, **kw)
    got = tops.flash(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype
    _close(got, want, dtype, F32_ATOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kw", [
    dict(causal=True, window=48), dict(causal=True, softcap=50.0,
                                       scale=0.1)])
def test_flash_plain_matches_pallas_mqa_head256(kw, dtype):
    """RecurrentGemma's attention shape cut to size: MQA with rep = 10 and
    head_dim 256 (the kv head read by index in the Pallas kernel, repeated
    in the plain version)."""
    rng = np.random.default_rng(RNG_SEED + 1)
    arrs = _qkv(rng, 1, 10, 1, 128, 256)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    want = jops.flash(jq, jk, jv, interpret=True, bq=64, bk=64, **kw)
    got = tops.flash(tq, tk, tv, bq=64, bk=64, **kw)
    _close(got, want, dtype, F32_ATOL)


@pytest.mark.parametrize("s", [1, 63, 130])
@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=True, window=16, softcap=50.0),
    dict(causal=False, window=40), dict(causal=False, softcap=20.0),
    dict(causal=False, window=-3)])
def test_flash_plain_matches_reference_ragged(s, kw):
    """Ragged sq = sk (the Pallas kernel asserts that its blocks divide
    them; the plain K9 and the Hopper kernel take any length), rep 2,
    head_dim 16, against the JAX ``ref.flash_attention_ref``; a negative
    non-causal window admits only keys past q + 3 (the last rows none)."""
    rng = np.random.default_rng(RNG_SEED + s)
    arrs = _qkv(rng, 2, 4, 2, s, 16)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, "f32")
    want = jref.flash_attention_ref(jq, jk, jv, **kw)
    _close(flash_attention.flash_attention(tq, tk, tv, **kw), want, "f32",
           F32_ATOL)


def test_flash_all_masked_row_is_uniform():
    """A row whose keys are all masked (a window that ends before the
    first key) softmaxes to the uniform row, in both packages: the mask
    is -1e30, not -inf."""
    rng = np.random.default_rng(RNG_SEED + 2)
    arrs = _qkv(rng, 1, 2, 1, 8, 16)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, "f32")
    kw = dict(causal=True, window=0)
    got = tops.flash(tq, tk, tv, **kw)
    _close(got, jref.flash_attention_ref(jq, jk, jv, **kw), "f32", F32_ATOL)
    torch.testing.assert_close(
        got, tv.mean(2, keepdim=True).expand_as(got), rtol=0, atol=1e-6)


@pytest.mark.parametrize("b,s,w", [(1, 1, 1), (2, 256, 128), (3, 255, 130),
                                   (1, 512, 256)])
def test_rglru_plain_matches_reference(b, s, w):
    """The plain K10 (the sequential recurrence, two roundings a step, as
    the Pallas body) against the JAX oracle (an associative scan): within
    1e-5 + 1e-5·|h|, the rounding of the other order."""
    rng = np.random.default_rng(RNG_SEED + s)
    a = rng.uniform(0.5, 0.99, (b, s, w)).astype(np.float32)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    want = np.asarray(jax.jit(jref.rglru_scan_ref)(jnp.asarray(a),
                                                   jnp.asarray(x)))
    got = tops.rglru(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_rglru_plain_is_the_sequential_recurrence():
    """Bit for bit the loop ``h = a_t * h + b_t`` with one rounding for the
    product and one for the sum: what the Hopper kernel is held to."""
    rng = np.random.default_rng(RNG_SEED + 3)
    a = rng.uniform(0.5, 0.99, (2, 40, 7)).astype(np.float32)
    x = rng.standard_normal((2, 40, 7)).astype(np.float32)
    h = np.zeros((2, 7), np.float32)
    want = np.empty_like(a)
    for t in range(a.shape[1]):
        h = (a[:, t] * h).astype(np.float32) + x[:, t]
        want[:, t] = h
    got = rglru_scan.rglru_scan(torch.from_numpy(a), torch.from_numpy(x))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,s,w,cw,t", [
    (1, 1, 1, 32, 64), (3, 63, 4, 32, 64), (1, 64, 16, 16, 32),
    (2, 65, 33, 32, 64), (3, 257, 130, 32, 64), (1, 300, 36, 16, 128),
    (2, 129, 64, 32, 128), (1, 97, 300, 16, 32)])
def test_rglru_kernel_order_equals_plain(b, s, w, cw, t):
    """K10's walk in PyTorch (``rglru_scan.scan_in_kernel_order``: channel
    blocks of ``cw``, ring stages of ``t``, a ragged last block and a
    partial last stage masked) equals the plain version bit for bit: the
    Hopper kernel's exact check, here with no tolerance."""
    rng = np.random.default_rng(RNG_SEED + 5 + s + w)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (b, s, w)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((b, s, w)).astype(np.float32))
    got = rglru_scan.scan_in_kernel_order(a, x, cw=cw, t=t)
    assert torch.equal(got, rglru_scan.plain(a, x))


def test_rglru_default_plan_is_a_built_plan():
    """The wrapper's default plan is one the kernel is built for, and a
    ``plan=`` on CPU tensors runs the plain version."""
    assert (rglru_scan.CW, rglru_scan.T) in rglru_scan.PLANS
    a = torch.rand((2, 9, 5), generator=torch.Generator().manual_seed(0))
    got = rglru_scan.rglru_scan(a, a, plan=(16, 32, 3))
    assert torch.equal(got, rglru_scan.plain(a, a))


def test_wrappers_accept_jax_block_sizes_and_count_no_cpu_launch():
    """``bq``/``bk`` and ``bw``/``bs`` (the JAX kernels' block sizes) are
    accepted and ignored; a CPU call launches nothing; a tensor on neither
    the CPU nor a CUDA device is refused, never computed."""
    rng = np.random.default_rng(RNG_SEED + 4)
    arrs = _qkv(rng, 1, 2, 2, 32, 16)
    _, (tq, tk, tv) = _both(arrs, "f32")
    a = torch.rand((1, 32, 8))
    tops.reset_launch_counts()
    torch.testing.assert_close(tops.flash(tq, tk, tv, bq=16, bk=16),
                               flash_attention.plain(tq, tk, tv),
                               rtol=0, atol=0)
    assert torch.equal(tops.rglru(a, a, bw=8, bs=16), rglru_scan.plain(a, a))
    counts = tops.launch_counts()
    assert counts["flash_attention"] == 0 and counts["rglru_scan"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash(tq, tk.to("meta"), tv)
    with pytest.raises(ValueError, match="CUDA"):
        tops.rglru(a.to("meta"), a.to("meta"))
    assert {"flash_attention", "rglru_scan"} <= set(build.LAUNCHES)
    assert {"flash_attention", "rglru_scan"} <= set(build.SOURCES)
