"""The backward kernels' plain versions and the differentiable wrappers:
``ref.flash_attention_bwd_ref`` (the plain K9-bwd) against ``torch.autograd``
of ``ref.flash_attention_ref`` and against ``jax.grad`` of the JAX model's
``attention_reference``; ``ref.rglru_scan_bwd_ref`` (the plain K10-bwd)
against ``torch.autograd`` of the plain scan and ``jax.grad`` through the
JAX ``ref.rglru_scan_ref`` (its associative scan, which runs under this jax:
ROADMAP C.1 is the Pallas body); ``torch.autograd.gradcheck`` of
``kernels.ops.flash`` and ``ops.rglru`` on the CPU route in f64; the
forward's log-sum-exp; and what the wrappers save.  Inputs are made with
numpy from a seed and fed to both packages; each comparison states its
tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import layers as jl
from repro_torch.kernels import build, flash_attention, ops, ref, rglru_scan

RNG_SEED = 28

#: f32 gradients against autograd and jax.grad of the same f32 function:
#: the same products summed in other orders, within 1e-5 of each tensor's
#: largest value (at least 1)
F32_TOL = 1e-5

#: (causal, window, softcap, scale): windows 0 and -3 leave rows with no
#: valid key (causal: every row; not causal: the last rows), which softmax
#: to the uniform row and send gradient to every key
CASES = [(True, None, None, None), (True, 5, None, None),
         (True, 0, None, None), (False, -3, None, None),
         (True, None, 20.0, 0.1), (True, 4, 20.0, None),
         (False, None, None, 0.3)]


def _close(got, want, tol=F32_TOL):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    err = float(np.abs(g - w).max()) if g.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(w).max())), err
    return err


def _attn_inputs(rng, rep, s=19, d=8, b=2, hkv=2):
    q = rng.standard_normal((b, hkv * rep, s, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal(q.shape).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("causal,window,cap,scale", CASES)
def test_flash_bwd_ref_matches_autograd_and_jax(causal, window, cap, scale,
                                                rep):
    """The plain K9-bwd from (o, lse, dO) against autograd of the plain
    forward, and against ``jax.grad`` of the JAX model's
    ``attention_reference`` (its (b, s, h, d) layout, additive mask)."""
    rng = np.random.default_rng(RNG_SEED + rep)
    q, k, v, do = _attn_inputs(rng, rep)
    kw = dict(causal=causal, window=window, softcap=cap, scale=scale)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = ref.flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    want = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    got = ref.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                      o.detach(), lse.detach(),
                                      torch.from_numpy(do),
                                      **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)

    spec = jl.AttnSpec(n_heads=q.shape[1], n_kv_heads=k.shape[1],
                       head_dim=q.shape[3], causal=causal, window=window,
                       softcap=cap, scale=scale)
    pos = jnp.arange(q.shape[2])

    def loss(q, k, v):
        out = jl.attention_reference(spec, q, k, v, pos, pos)
        return jnp.sum(out * jnp.asarray(do.transpose(0, 2, 1, 3)))

    jg = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)))
    for g, w in zip(got, jg):
        _close(g, np.asarray(w).transpose(0, 2, 1, 3))


def test_flash_forward_lse_is_the_masked_logsumexp():
    """``return_lse``: the output is the plain forward's, bit for bit, and
    the lse each row's log-sum-exp of its masked logits; a row with no
    valid key has -1e30 (and a uniform output row)."""
    rng = np.random.default_rng(RNG_SEED + 3)
    q, k, v, _ = _attn_inputs(rng, 2)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for kw in (dict(causal=True, window=4, softcap=30.0),
               dict(causal=True, window=0)):
        o, lse = flash_attention.flash_attention(tq, tk, tv, return_lse=True,
                                                 **kw)
        assert torch.equal(o, flash_attention.flash_attention(tq, tk, tv,
                                                              **kw))
        assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
        scale = 1.0 / np.sqrt(q.shape[3])
        s = torch.einsum("bhqd,bhkd->bhqk", tq * scale,
                         tk.repeat_interleave(2, 1))
        if kw.get("softcap"):
            s = kw["softcap"] * torch.tanh(s / kw["softcap"])
        qp, kp = torch.arange(19)[:, None], torch.arange(19)[None, :]
        ok = (qp >= kp) & ((qp - kp) < kw["window"])
        want = torch.logsumexp(torch.where(ok, s, ref.NEG_INF), -1)
        torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)
    assert bool((lse == ref.NEG_INF).all())
    torch.testing.assert_close(o, tv.repeat_interleave(2, 1).mean(2,
                               keepdim=True).expand_as(o), rtol=0, atol=1e-6)


@pytest.mark.parametrize("b,s,w", [(1, 1, 3), (2, 7, 5), (3, 40, 16)])
def test_rglru_bwd_ref_matches_autograd_and_jax(b, s, w):
    """The plain K10-bwd against autograd of the plain scan and ``jax.grad``
    through the JAX ``ref.rglru_scan_ref`` (an associative scan: the same
    function, rounded in another order), with a in the gates' range."""
    rng = np.random.default_rng(RNG_SEED + s)
    a = rng.uniform(0.5, 0.999, (b, s, w)).astype(np.float32)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    dh = rng.standard_normal((b, s, w)).astype(np.float32)
    ta, tx = (torch.from_numpy(t).requires_grad_() for t in (a, x))
    h = ref.rglru_scan_ref(ta, tx)
    want = torch.autograd.grad(h, (ta, tx), torch.from_numpy(dh))
    got = ref.rglru_scan_bwd_ref(ta.detach(), h.detach(), torch.from_numpy(dh))
    jg = jax.grad(lambda a, x: jnp.sum(jref.rglru_scan_ref(a, x) * dh),
                  argnums=(0, 1))(jnp.asarray(a), jnp.asarray(x))
    for g, w_, j in zip(got, want, jg):
        assert g.dtype == torch.float32 and g.shape == (b, s, w)
        _close(g, w_)
        _close(g, np.asarray(j))


def test_rglru_bwd_ref_is_the_reverse_walk():
    """``g_t = dh_t + a_{t+1} g_{t+1}``, ``db = g``, ``da_t = g_t h_{t-1}``
    from h_{-1} = 0, each step one rounded product and one rounded sum,
    exactly (the walk K10-bwd takes)."""
    rng = np.random.default_rng(RNG_SEED + 9)
    a, h, dh = (torch.from_numpy(rng.standard_normal((2, 9, 4)).astype(
        np.float32)) for _ in range(3))
    da, db = rglru_scan.rglru_scan_bwd(a, h, dh)
    g = torch.zeros(2, 4)
    for t in range(8, -1, -1):
        g = dh[:, t] + (a[:, t + 1] * g if t < 8 else 0 * g)
        assert torch.equal(db[:, t], g)
        assert torch.equal(da[:, t], g * (h[:, t - 1] if t else 0 * g))


@pytest.mark.parametrize("causal,window,cap,rep", [
    (True, None, None, 1), (True, 3, 5.0, 2), (False, 4, None, 2)])
def test_gradcheck_flash_on_the_cpu_route(causal, window, cap, rep):
    """``ops.flash`` (the ``autograd.Function`` of K9 and K9-bwd) through
    ``torch.autograd.gradcheck`` in f64 on CPU tensors (the plain versions
    run in f64 there).  Windows here leave no row without a valid key: in
    f64, ``s - 1e30`` keeps s, so such a row would not be uniform."""
    rng = np.random.default_rng(RNG_SEED + 11)
    q, k, v, _ = (torch.from_numpy(a).double().requires_grad_()
                  for a in _attn_inputs(rng, rep, s=6, d=4, b=1, hkv=1))

    def fn(q, k, v):
        return ops.flash(q, k, v, causal=causal, window=window, softcap=cap)

    assert fn(q, k, v).grad_fn.name().endswith("_FlashBackward")
    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-6)


def test_gradcheck_rglru_on_the_cpu_route():
    """``ops.rglru`` (K10 and K10-bwd) through ``gradcheck`` in f64."""
    rng = np.random.default_rng(RNG_SEED + 12)
    a = torch.from_numpy(rng.uniform(0.3, 0.9, (2, 7, 3))).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((2, 7, 3))).requires_grad_()
    assert ops.rglru(a, b).grad_fn.name().endswith("_RglruBackward")
    assert torch.autograd.gradcheck(ops.rglru, (a, b), eps=1e-6, atol=1e-6)


def test_wrappers_record_only_where_a_gradient_is_needed():
    """Without a gradient to record (inference mode, no_grad, or no input
    requiring one) ``ops.flash`` and ``ops.rglru`` return their forward
    kernels' outputs with nothing saved, equal to the recorded path's."""
    rng = np.random.default_rng(RNG_SEED + 13)
    q, k, v, _ = map(torch.from_numpy, _attn_inputs(rng, 2))
    a = torch.rand((2, 9, 4))
    plain_o = ops.flash(q, k, v, window=5)
    assert plain_o.grad_fn is None and not plain_o.requires_grad
    with torch.inference_mode():
        assert ops.flash(q, k, v, window=5).grad_fn is None
        assert ops.rglru(a, a).grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert ops.flash(qg, k, v, window=5).grad_fn is None
    rec = ops.flash(qg, k, v, window=5)
    assert rec.grad_fn is not None and torch.equal(rec.detach(), plain_o)
    ag = a.clone().requires_grad_()
    assert torch.equal(ops.rglru(ag, a).detach(), ops.rglru(a, a))
    ops.reset_launch_counts()
    rec.sum().backward()
    assert qg.grad.shape == q.shape
    assert set(ops.launch_counts().values()) == {0}  # CPU: plain versions


def test_bwd_wrappers_take_the_forwards_keywords():
    """``flash_attention_bwd`` and ``rglru_scan_bwd`` on CPU tensors are
    their plain versions; K9-bwd's window is clamped as the forward's (a
    window past sq is no window)."""
    rng = np.random.default_rng(RNG_SEED + 14)
    q, k, v, do = map(torch.from_numpy, _attn_inputs(rng, 2))
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    got = flash_attention.flash_attention_bwd(q, k, v, o, lse, do,
                                              window=10 ** 6)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    a, h, dh = (torch.rand((1, 5, 3)) for _ in range(3))
    for g, w in zip(rglru_scan.rglru_scan_bwd(a, h, dh),
                    rglru_scan.plain_bwd(a, h, dh)):
        assert torch.equal(g, w)
    assert flash_attention.plain_bwd is ref.flash_attention_bwd_ref
    assert rglru_scan.plain_bwd is ref.rglru_scan_bwd_ref
    # one counter a route (bf16: tensor cores; f32: CUDA cores), and one
    # library a kernel source
    assert set(flash_attention.BWD_ROUTES) == set(flash_attention.ROUTES)
    assert {*flash_attention.BWD_ROUTES.values(), "rglru_scan_bwd"} <= set(
        build.LAUNCHES)
    assert {"flash_attention_bwd", "rglru_scan_bwd"} <= set(build.SOURCES)


@pytest.mark.parametrize("causal,window,cap,scale", CASES[:5])
def test_flash_bwd_ref_operand_rounding(causal, window, cap, scale):
    """``operand_dtype``: rounding P and dS to f32 on f32 inputs changes
    nothing, bit for bit; to bf16 it moves dV by at most one bf16 rounding
    of each P (2^-9 of it, here allowed 2^-8) times |dO|: |ΔdV| <= 2^-8 ·
    Pᵀ|dO|, summed over each kv head's query heads."""
    rng = np.random.default_rng(RNG_SEED + 7)
    q, k, v, do = (torch.from_numpy(a) for a in _attn_inputs(rng, 2))
    kw = dict(causal=causal, window=window, softcap=cap, scale=scale)
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    plain = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    same = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw,
                                       operand_dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(plain, same))
    one = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw,
                                      operand_dtype=torch.bfloat16)
    assert not all(torch.equal(a, b) for a, b in zip(plain, one))
    mag = ref.flash_attention_bwd_ref(q, k, v, o, lse, do.abs(), **kw)[2]
    assert bool(((one[2] - plain[2]).abs() <= 2.0 ** -8 * mag + 1e-6).all())
