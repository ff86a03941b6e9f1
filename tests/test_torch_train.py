"""Port parity of LM training: ``layers.cross_entropy`` and
``attention_chunked`` against JAX's; ``Model.loss`` and every parameter's
gradient against ``jax.grad(model.loss)`` (weights carried across by
``params_from_jax``) on the RecurrentGemma-2B smoke config and a tiny dense
``attn`` config from ``examples/train_lm.make_config``; ``remat`` on
against off, bit for bit; and gradients only inside the train step
(``tests/test_torch_train_step.py`` holds the train steps against JAX's).
Inputs are made with numpy from a seed and fed to both packages; each
comparison states its tolerance."""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jl
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.train import (AdamWConfig, init_optimizer, make_prefill_step,
                               make_train_step)

ROOT = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)
RNG_SEED = 2828

#: f32 layer checks: the same f32 arithmetic summed in other orders
F32_TOL = dict(rtol=1e-5, atol=1e-5)

#: bf16 models: both packages run bf16 matmuls with f32 accumulation but
#: round activations after sums taken in other orders (XLA's and PyTorch's
#: CPU GEMMs), and the backward compounds those bf16 ulps.  The loss within
#: LOSS_RTOL; each gradient tensor's max |Δ| within GRAD_MAX_FRAC of its
#: largest |JAX gradient| and its mean |Δ| within GRAD_MEAN_FRAC (measured
#: at most 5.9% and 1.3% on these configs)
LOSS_RTOL = 5e-4
GRAD_MAX_FRAC, GRAD_MEAN_FRAC = 0.1, 0.025


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _dense_config() -> ArchConfig:
    """``examples/train_lm.py``'s ``make_config`` (a dense ``attn`` LM) at a
    tiny size, as the port's ``ArchConfig``."""
    spec = importlib.util.spec_from_file_location(
        "train_lm_example", ROOT / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jcfg = mod.make_config(128, 2, 256)
    return jcfg, ArchConfig(**{f: getattr(jcfg, f)
                               for f in jcfg.__dataclass_fields__})


@functools.lru_cache(maxsize=None)
def _configs(arch):
    if arch == "dense":
        return _dense_config()
    return jget_config(arch, smoke=True), get_config(arch, smoke=True)


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    jcfg, _ = _configs(arch)
    jm = JModel(jcfg, tp=1, use_chunked_attn=False, remat=False)
    return jm, jax.jit(jm.init)(KEY)


def _port_model(arch, remat=True):
    jm, params = _jax_model(arch)
    tm = Model(_configs(arch)[1], tp=1, remat=remat, device="cpu")
    tm.load_state_dict(params_from_jax(_np(params), tm))
    return tm


def _batch(vocab, b, s, seed, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        out["mask"] = rng.random((b, s)) < 0.7
    return out


def _grads(tm, batch):
    """The port's loss and every parameter's gradient (the train step's
    scope: ``trainable``)."""
    from repro_torch.train.steps import trainable
    with trainable(tm):
        loss = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
        loss.backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    for p in tm.parameters():
        p.grad = None
    return loss.detach(), grads


# -- layers -------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    """Mean NLL in f32 from bf16 logits, masked mean over the kept
    positions (an all-false mask divides by 1), against JAX's."""
    rng = np.random.default_rng(RNG_SEED)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    masks = ([rng.random((3, 7)) < 0.5, np.zeros((3, 7), bool)]
             if masked else [None])
    for mask in masks:
        want = jl.cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                                jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask))
        got = tl.cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                               torch.from_numpy(labels),
                               None if mask is None
                               else torch.from_numpy(mask))
        assert got.dtype == torch.float32 and got.ndim == 0
        np.testing.assert_allclose(float(got), float(want), **F32_TOL)


@pytest.mark.parametrize("sk,chunk", [(16, 4), (10, 4)])
@pytest.mark.parametrize("kw", [dict(), dict(window=3),
                                dict(softcap=5.0, window=0)])
def test_attention_chunked_matches_jax(sk, chunk, kw):
    """``attention_chunked`` (chunks of 4 over 16 keys; 10 keys fall back
    to one chunk, as JAX's) and its gradient against JAX's, in f32, GQA rep
    2; a window of 0 leaves every row without a valid key."""
    spec = dict(n_heads=4, n_kv_heads=2, head_dim=8, **kw)
    rng = np.random.default_rng(RNG_SEED + sk)
    q, k, v = (rng.standard_normal((2, sk, h, 8)).astype(np.float32)
               for h in (4, 2, 2))
    dout = rng.standard_normal(q.shape).astype(np.float32)
    pos = np.arange(sk)

    def jloss(q, k, v):
        out = jl.attention_chunked(jl.AttnSpec(**spec), q, k, v,
                                   jnp.asarray(pos), jnp.asarray(pos),
                                   chunk=chunk)
        return jnp.sum(out * dout), out

    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = tl.attention_chunked(tl.AttnSpec(**spec), tq, tk, tv,
                               torch.from_numpy(pos), torch.from_numpy(pos),
                               chunk=chunk)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)
    tg = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(dout))
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)
    # the same function as the plain attention (and K9's plain version)
    ref = tl.attention_reference(tl.AttnSpec(**spec), tq, tk, tv,
                                 torch.from_numpy(pos), torch.from_numpy(pos))
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                               **F32_TOL)


# -- the model's loss and gradients ---------------------------------------------


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "dense"])
def test_loss_and_every_gradient_match_jax(arch):
    """``Model.loss`` (K9 and K10 forward, K9-bwd and K10-bwd backward:
    their plain versions here; masked for the dense config) and the
    gradient of every parameter against ``jax.grad`` of JAX's
    ``Model.loss``, the gradients mapped by ``params_from_jax``."""
    jm, params = _jax_model(arch)
    tm = _port_model(arch)
    batch = _batch(jm.cfg.vocab, 2, 24, RNG_SEED + 1, mask=arch == "dense")
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _grads(tm, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    want = params_from_jax(_np(jgrads), tm)
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name]
        scale = float(w.abs().max())
        diff = (g - w).abs()
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert float(diff.max()) <= GRAD_MAX_FRAC * scale, (name, scale)
        assert float(diff.mean()) <= GRAD_MEAN_FRAC * scale, (name, scale)


def test_remat_on_and_off_are_bit_identical():
    """``remat=True`` recomputes each pattern group in the backward
    (``torch.utils.checkpoint``): the same operations in the same order,
    so the loss and every gradient equal ``remat=False``'s bit for bit on
    the CPU."""
    arch = "recurrentgemma-2b"
    jm, _ = _jax_model(arch)
    batch = _batch(jm.cfg.vocab, 2, 20, RNG_SEED + 20)
    l1, g1 = _grads(_port_model(arch, remat=True), batch)
    l0, g0 = _grads(_port_model(arch, remat=False), batch)
    assert torch.equal(l1, l0)
    for name in g0:
        assert torch.equal(g1[name], g0[name]), name


def test_gradients_only_inside_the_train_step():
    """Parameters are built without gradients; a train step turns them on
    for its own scope and frees the gradients after; a forward outside
    records nothing (K9 and K10 save nothing), and the prefill's output is
    unchanged by the step's machinery."""
    arch = "recurrentgemma-2b"
    jm, _ = _jax_model(arch)
    tm = _port_model(arch)
    assert not any(p.requires_grad for p in tm.parameters())
    batch = _batch(jm.cfg.vocab, 2, 12, RNG_SEED + 30)
    tokens = {"tokens": torch.from_numpy(batch["tokens"])}
    logits, _ = tm.forward(tokens)
    assert logits.grad_fn is None
    last = make_prefill_step(tm)(tokens)
    assert torch.equal(last, logits[:, -1, :])
    opt = init_optimizer(tm)
    assert list(opt["m"]) == [n for n, _ in tm.named_parameters()]
    opt, met = make_train_step(tm, AdamWConfig(lr=1e-3, warmup_steps=1))(
        opt, batch)
    assert bool(torch.isfinite(met["loss"])) and int(opt["step"]) == 1
    assert not any(p.requires_grad or p.grad is not None
                   for p in tm.parameters())
    ops.reset_launch_counts()
    assert tm.forward(tokens)[0].grad_fn is None
    assert set(ops.launch_counts().values()) == {0}  # CPU: plain versions
