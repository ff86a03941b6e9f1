"""Port parity of the optimizer and the gradient compression: AdamW
(``adamw_init``, ``adamw_update``, ``global_norm``, ``cosine_lr``) against
the JAX package's on the same numpy parameters and gradients; int8
quantization's scale and floor against JAX's, its rounding unbiased over
many draws; ``hierarchical_psum`` waiting for ROADMAP A.9; and
``opt_state_from_jax``.  Each comparison states its tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compress as jcompress
from repro.train import optim as joptim
from repro_torch.train import compress, optim

RNG_SEED = 281

#: f32 elementwise arithmetic in the same order as JAX's; XLA may fuse or
#: pick other rounding for pow/cos/sqrt, so within a few f32 ulps
F32_TOL = dict(rtol=2e-6, atol=1e-7)


def _tree(rng):
    """A params-like dict: a matrix, a vector and a scalar-like leaf."""
    return {"a.w": rng.standard_normal((6, 5)).astype(np.float32),
            "b.scale": rng.standard_normal(7).astype(np.float32) * 0.1,
            "c.lam": rng.uniform(0.2, 0.9, (1,)).astype(np.float32)}


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_jax(steps, clip):
    """``steps`` AdamW updates from the same params and gradients (a new
    gradient each step; clipped by the global norm at ``clip``): params, m,
    v, step and the grad norm equal JAX's within :data:`F32_TOL`.  The
    port updates in place and returns the same dicts."""
    rng = np.random.default_rng(RNG_SEED + steps)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=clip)
    jp = {k: jnp.asarray(v) for k, v in _tree(rng).items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    js = joptim.adamw_init(jp)
    ts = optim.adamw_init(tp)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    assert set(ts["m"]) == set(tp) and ts["m"]["a.w"].dtype == torch.float32
    for _ in range(steps):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 3
             for k, v in tp.items()}
        jp, js, jn = joptim.adamw_update(joptim.AdamWConfig(**cfg), jp,
                                         {k: jnp.asarray(v)
                                          for k, v in g.items()}, js)
        out, ts2, tn = optim.adamw_update(
            optim.AdamWConfig(**cfg), tp,
            {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        assert out is tp and ts2 is ts
        np.testing.assert_allclose(float(tn), float(jn), **F32_TOL)
    assert int(ts["step"]) == int(js["step"]) == steps
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   **F32_TOL)
        np.testing.assert_allclose(ts["m"][k].numpy(), np.asarray(js["m"][k]),
                                   **F32_TOL)
        np.testing.assert_allclose(ts["v"][k].numpy(), np.asarray(js["v"][k]),
                                   **F32_TOL)


def test_cosine_lr_matches_jax():
    """Warmup, the cosine and its floor, at every step from 0 to past the
    end, as a tensor on the step's device (f32)."""
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=50, min_lr_frac=0.1)
    steps = np.arange(0, 60, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: joptim.cosine_lr(
        joptim.AdamWConfig(**cfg), s))(jnp.asarray(steps)))
    got = optim.cosine_lr(optim.AdamWConfig(**cfg), torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    assert float(got[55]) == pytest.approx(3e-4, rel=1e-6)


def test_global_norm_matches_jax():
    rng = np.random.default_rng(RNG_SEED + 7)
    tree = _tree(rng)
    want = float(joptim.global_norm({k: jnp.asarray(v)
                                     for k, v in tree.items()}))
    got = optim.global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, **F32_TOL)


def test_quantize_int8_matches_jax_scale_and_floor():
    """Scale (max |x| / 127) equal to JAX's; every code the floor of x /
    scale or one above it, as JAX's (the draws differ: other generators);
    dequantized within one quantum; codes within [-127, 127]."""
    rng = np.random.default_rng(RNG_SEED + 8)
    x = rng.standard_normal(4096).astype(np.float32)
    jq, js = jcompress.quantize_int8(jnp.asarray(x), jax.random.PRNGKey(2))
    tq, ts = compress.quantize_int8(torch.from_numpy(x),
                                    torch.Generator().manual_seed(2))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert float(ts) == float(js)
    lo = np.floor(x / np.float32(ts))
    for q in (tq.numpy().astype(np.float32), np.asarray(jq, np.float32)):
        assert np.all((q == lo) | (q == lo + 1) | (np.abs(q) == 127))
        assert np.abs(q).max() <= 127
    y = compress.dequantize_int8(tq, ts)
    assert float((y - torch.from_numpy(x)).abs().max()) <= float(ts) + 1e-6


def test_quantize_int8_is_unbiased():
    """E[dequant(quant(x))] = x: the mean error over 64 draws is within 5%
    of a quantum (JAX's test takes 16 draws at the same bound)."""
    x = torch.from_numpy(np.random.default_rng(RNG_SEED + 9)
                         .standard_normal(4096).astype(np.float32))
    gen = torch.Generator().manual_seed(100)
    errs, scale = [], None
    for _ in range(64):
        q, scale = compress.quantize_int8(x, gen)
        errs.append((compress.dequantize_int8(q, scale) - x).numpy())
    assert abs(float(np.mean(errs))) < float(scale) * 0.05


def test_int8_grad_transform_is_seeded_per_call():
    """The transform draws from a generator seeded anew at each call (JAX's
    splits one key at each call): two calls agree bit for bit, another seed
    differs, every leaf keeps its shape and dtype and lies within one
    quantum of its gradient."""
    rng = np.random.default_rng(RNG_SEED + 10)
    grads = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    t0 = compress.make_int8_grad_transform(0)
    a, b = t0(grads), t0(grads)
    c = compress.make_int8_grad_transform(1)(grads)
    assert list(a) == list(grads)
    assert all(torch.equal(a[k], b[k]) for k in grads)
    assert any(not torch.equal(a[k], c[k]) for k in grads)
    for k, g in grads.items():
        assert a[k].shape == g.shape and a[k].dtype == g.dtype
        quantum = float(g.abs().max()) / 127
        assert float((a[k] - g).abs().max()) <= quantum * (1 + 1e-5)


def test_hierarchical_psum_waits_for_a9():
    with pytest.raises(NotImplementedError, match="A.9"):
        compress.hierarchical_psum(torch.ones(3), intra_axes=("data",),
                                   pod_axis="pod")


def test_opt_state_from_jax_maps_the_layout():
    """A JAX ``adamw_update`` state carried across by
    ``opt_state_from_jax``: m and v land under the port's parameter names,
    as ``params_from_jax`` puts the parameters, and step is int32."""
    from repro.configs import get_config as jget_config
    from repro.models.model import Model as JModel
    from repro_torch.configs import get_config
    from repro_torch.models.convert import opt_state_from_jax, params_from_jax
    from repro_torch.models.model import Model
    cfg = jget_config("recurrentgemma-2b", smoke=True)
    params = jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0))
    leaves, treedef = jax.tree.flatten(params)
    grads = jax.tree.unflatten(treedef, [jnp.full(x.shape, 0.5 + i, x.dtype)
                                         for i, x in enumerate(leaves)])
    _, state, _ = jax.jit(lambda p, g, s: joptim.adamw_update(
        joptim.AdamWConfig(), p, g, s))(params, grads,
                                        joptim.adamw_init(params))
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    tm = Model(get_config("recurrentgemma-2b", smoke=True), device="cpu")
    got = opt_state_from_jax(np_(state), tm)
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 1
    for k in ("m", "v"):
        want = params_from_jax(np_(state[k]), tm)
        assert list(got[k]) == [n for n, _ in tm.named_parameters()]
        for name, t in got[k].items():
            assert t.dtype == torch.float32 and torch.equal(t, want[name])
