"""Port parity of the LM serving path: the layers, the RG-LRU block,
``Model.forward`` (RecurrentGemma-2B and Gemma2-9B smoke configs, JAX
weights carried across by ``params_from_jax``), ``decode_step`` against
JAX's and against the port's own forward, the serving steps and the serve
CLI.  Inputs are made with numpy from a seed and fed to both packages;
each comparison states its tolerance."""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jl
from repro.models import recurrent as jrec
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.models import layers as tl
from repro_torch.models import recurrent as trec
from repro_torch.models.convert import cache_from_jax, params_from_jax
from repro_torch.models.model import Model
from repro_torch.train import make_prefill_step, make_serve_step

ROOT = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)
B = 2
LM_ARCHS = ["recurrentgemma-2b", "gemma2-9b"]

#: f32 component checks: the same f32 arithmetic, summed in other orders
#: (and, for the RG-LRU, a sequential scan against JAX's associative one)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    """A JAX params dict (nested) as a dict of CPU tensors."""
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(
        np.array(v)) for k, v in tree.items()}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# -- layers and the RG-LRU block, in f32 --------------------------------------


def test_rglru_seq_and_step_match_jax_f32():
    """``rglru_seq`` (the plain K10 scan) and 12 ``rglru_step``s, in f32,
    against JAX's (associative scan; its step), with the carried state."""
    spec = jrec.RglruSpec(d_model=32, d_rnn=48)
    tspec = trec.RglruSpec(d_model=32, d_rnn=48)
    p = jrec.rglru_init(jax.random.PRNGKey(1), spec)
    tp = _t(_np(p))
    x = np.random.default_rng(1).standard_normal((2, 12, 32)).astype(
        np.float32)
    want = jax.jit(functools.partial(jrec.rglru_seq, spec=spec,
                                     compute=jnp.float32))(p, x=jnp.asarray(x))
    got = trec.rglru_seq(tp, tspec, torch.from_numpy(x),
                         compute=torch.float32)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
    jst = jrec.rglru_state_init(2, spec)
    tst = trec.rglru_state_init(2, tspec)
    jstep = jax.jit(functools.partial(jrec.rglru_step, spec=spec,
                                      compute=jnp.float32))
    for t in range(12):
        jy, jst = jstep(p, x=jnp.asarray(x[:, t:t + 1]), state=jst)
        ty, tst = trec.rglru_step(tp, tspec, torch.from_numpy(x[:, t:t + 1]),
                                  tst, compute=torch.float32)
        np.testing.assert_allclose(_f32(ty), _f32(jy), **F32_TOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(_f32(tst[k]), _f32(jst[k]), **F32_TOL)
    # the step recurrence ends where the sequence does
    np.testing.assert_allclose(_f32(ty), _f32(got)[:, -1:], **F32_TOL)


@pytest.mark.parametrize("kw", [dict(), dict(window=5), dict(softcap=20.0),
                                dict(causal=False, scale=0.3)])
def test_attention_reference_and_decode_match_jax(kw):
    """``attention_reference`` (GQA, rep 2) and ``decode_attention`` over a
    ring cache with unfilled (-1) and wrapped slots, in f32."""
    spec = dict(n_heads=4, n_kv_heads=2, head_dim=16, **kw)
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 10, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    pos = np.arange(10)
    want = jl.attention_reference(jl.AttnSpec(**spec), *map(jnp.asarray, (
        q, k, v, pos, pos)))
    got = tl.attention_reference(tl.AttnSpec(**spec), *map(torch.from_numpy, (
        q, k, v, pos, pos)))
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
    cpos = np.array([8, 9, 2, 3, 4, 5, 6, 7, -1, -1], np.int32)
    qpos = np.array([9, 6], np.int32)
    want = jl.decode_attention(jl.AttnSpec(**spec), *map(jnp.asarray, (
        q[:, :1], k, v, qpos, cpos)))
    got = tl.decode_attention(tl.AttnSpec(**spec), *map(torch.from_numpy, (
        q[:, :1], k, v, qpos, cpos)))
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_layers_match_jax_f32(act):
    """rmsnorm (``1 + scale``), rope, the qkv projection with qk-norm, the
    output projection, the gated MLP (tanh GeLU) and the logit softcap."""
    rng = np.random.default_rng(3)
    spec = dict(n_heads=4, n_kv_heads=2, head_dim=16)
    pa = jl.attn_block_init(jax.random.PRNGKey(3), 32, jl.AttnSpec(**spec),
                            qk_norm=True)
    pa["q_norm"]["scale"] = jnp.asarray(rng.standard_normal(16), jnp.float32)
    pm = jl.mlp_init(jax.random.PRNGKey(4), 32, 64)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7), (2, 7)) + 3
    jq = jl.attn_qkv(pa, jl.AttnSpec(**spec), jnp.asarray(x),
                     jnp.asarray(pos), 500.0, compute=jnp.float32)
    tq = tl.attn_qkv(_t(_np(pa)), tl.AttnSpec(**spec), torch.from_numpy(x),
                     torch.from_numpy(pos), 500.0, compute=torch.float32)
    for g, w in zip(tq, jq):
        np.testing.assert_allclose(_f32(g), _f32(w), **F32_TOL)
    np.testing.assert_allclose(
        _f32(tl.attn_out(_t(_np(pa)), tl.AttnSpec(**spec), tq[0],
                         compute=torch.float32)),
        _f32(jl.attn_out(pa, jl.AttnSpec(**spec), jq[0],
                         compute=jnp.float32)), **F32_TOL)
    np.testing.assert_allclose(
        _f32(tl.mlp(_t(_np(pm)), torch.from_numpy(x), act,
                    compute=torch.float32)),
        _f32(jl.mlp(pm, jnp.asarray(x), act, compute=jnp.float32)),
        **F32_TOL)
    np.testing.assert_allclose(
        _f32(tl.softcap(torch.from_numpy(x * 20), 30.0)),
        _f32(jl.softcap(jnp.asarray(x * 20), 30.0)), **F32_TOL)


# -- the model ----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models(arch):
    """The JAX model and its params, and the port's model on the CPU with
    the same weights (``params_from_jax``); built once per arch (decode
    changes only its cache)."""
    cfg = jget_config(arch, smoke=True)
    jm = JModel(cfg, tp=1, use_chunked_attn=False, remat=False)
    params = jax.jit(jm.init)(KEY)
    tm = Model(get_config(arch, smoke=True), tp=1, use_chunked_attn=False,
               remat=False, device="cpu")
    tm.load_state_dict(params_from_jax(_np(params), tm))
    return jm, params, tm


def _tokens(cfg, s, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, s)).astype(
        np.int32)


#: bf16 logits of a whole model against JAX's: both run bf16 matmuls with
#: f32 accumulation, but round their outputs after sums taken in other
#: orders (XLA's and PyTorch's CPU GEMMs), so single bf16 ulps (2^-8 at
#: 0.5) differ at most positions and compound over 4-5 layers.  Max |Δ|
#: within 6% of the largest |logit| and mean |Δ| within 1% (measured: 3.1%
#: and 0.4% for recurrentgemma-2b-smoke, 1.5% and 0.2% for gemma2-9b-smoke)
LOGIT_MAX_FRAC, LOGIT_MEAN_FRAC = 0.06, 0.01


def _logits_close(got, want):
    g, w = _f32(got), _f32(want)
    scale = float(np.abs(w).max())
    diff = np.abs(g - w)
    assert g.shape == w.shape and np.isfinite(g).all()
    assert diff.max() <= LOGIT_MAX_FRAC * scale, (diff.max(), scale)
    assert diff.mean() <= LOGIT_MEAN_FRAC * scale, (diff.mean(), scale)


@pytest.mark.parametrize("arch", LM_ARCHS + ["qwen3-14b"])
def test_forward_matches_jax_bf16(arch):
    """``Model.forward`` logits in bf16, as JAX runs them: the prefill path
    through the plain K9 (every ``local``/``attn`` block) and K10 (every
    ``rg`` block); ``make_prefill_step`` is its last position.  Qwen3-14B
    adds full causal attention with qk-norm."""
    jm, params, tm = _models(arch)
    toks = _tokens(jm.cfg, 32)
    want, waux = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    got, aux = tm.forward({"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16 and float(aux) == float(waux) == 0.0
    _logits_close(got, want)
    last = make_prefill_step(tm)({"tokens": torch.from_numpy(toks)})
    assert torch.equal(last, got[:, -1, :])


#: the mirror of ``tests/test_models.py::test_decode_matches_forward``:
#: decode against the same package's forward, JAX's bound (bf16
#: recurrences accumulate rounding)
DECODE_VS_FORWARD = 0.15


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("s", [16, 32])
def test_decode_matches_jax_and_forward(arch, s):
    """``s`` ``decode_step``s against JAX's decode (the logits within the
    forward's tolerance; the caches converted by ``cache_from_jax``: slot
    positions exactly, k/v/state within it) and against the port's own
    forward.  At s = 32 the smoke window of 8 makes the local layers'
    ring buffers wrap four times."""
    jm, params, tm = _models(arch)
    toks = _tokens(jm.cfg, s, seed=6)
    fwd, _ = tm.forward({"tokens": torch.from_numpy(toks)})
    step = jax.jit(jm.decode_step)
    jcache = jm.init_cache(B, s)
    tcache = tm.init_cache(B, s)
    assert [c["k"].shape[1] for c in tcache if "k" in c] == [
        tm.cache_len(lt, s) for lt in tm.ltypes if lt != "rg"]
    jall, tall = [], []
    for t in range(s):
        jlg, jcache = step(params, jcache, jnp.asarray(toks[:, t]),
                           jnp.int32(t))
        tlg, tcache = tm.decode_step(tcache, torch.from_numpy(toks[:, t]), t)
        jall.append(_f32(jlg))
        tall.append(_f32(tlg))
        assert np.abs(tall[-1] - _f32(fwd[:, t])).max() < DECODE_VS_FORWARD
    _logits_close(np.stack(tall, 1), np.stack(jall, 1))
    for got, want in zip(tcache, cache_from_jax(_np(jcache), tm)):
        assert got.keys() == want.keys()
        for k in got:
            if k == "pos":
                assert torch.equal(got[k], want[k])
            else:
                _logits_close(got[k], want[k])


def test_serve_step_is_greedy():
    """``make_serve_step``: argmax of ``decode_step``'s logits, int32."""
    _, _, tm = _models("recurrentgemma-2b")
    serve = make_serve_step(tm)
    cache = tm.init_cache(B, 4)
    tok = torch.zeros(B, dtype=torch.int32)
    for t in range(4):
        nxt, logits, cache = serve(cache, tok, t)
        assert nxt.dtype == torch.int32
        assert torch.equal(nxt, logits.argmax(-1).to(torch.int32))
        tok = nxt


def test_generate_returns_every_step():
    """``launch.serve.generate``: the logits of every prompt and generated
    step, finite; the prompt's last within :data:`DECODE_VS_FORWARD` of
    the forward's; each generated token the argmax of its step's logits."""
    from repro_torch.launch.serve import generate
    _, _, tm = _models("recurrentgemma-2b")
    toks = torch.from_numpy(_tokens(tm.cfg, 6, seed=7))
    out = generate(tm, toks, 3)
    assert out["logits"].shape == (B, 9, tm.vocab)
    assert bool(torch.isfinite(out["logits"].float()).all())
    fwd, _ = tm.forward({"tokens": toks})
    assert float((out["logits"][:, 5].float() - fwd[:, -1].float()).abs()
                 .max()) < DECODE_VS_FORWARD
    assert torch.equal(out["tokens"],
                       out["logits"][:, 6:].argmax(-1).to(torch.int32))
    assert out["seconds"] > 0


def test_full_size_parameters_match_jax():
    """RecurrentGemma-2B at its published widths and depth: the port's
    parameter count equals the JAX model's (2,894,435,840 by JAX's
    ``eval_shape``), built on the meta device (no memory)."""
    cfg = jget_config("recurrentgemma-2b")
    shapes = jax.eval_shape(JModel(cfg).init, KEY)
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    tm = Model(get_config("recurrentgemma-2b"), device="meta")
    assert sum(p.numel() for p in tm.parameters()) == want
    assert len(tm.layers) == 26 and tm.ltypes.count("local") == 8
    assert tm.ltypes.count("rg") == 18


def test_init_draws_from_the_generator():
    """``Model.init(generator)``: seeded, finite, norms at zero (as JAX's
    init), and the same seed gives the same weights."""
    cfg = get_config("recurrentgemma-2b", smoke=True)
    a = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(x, y) and torch.isfinite(x).all(), name
        if name.endswith("scale"):
            assert not x.any(), name
    assert float(a.layers[0].rg.lam.min()) >= 0.2


def test_model_defaults_to_cuda():
    """With no ``device`` the model lives on the card; without one it
    raises instead of running on the CPU."""
    cfg = get_config("recurrentgemma-2b", smoke=True)
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Model(cfg)


@pytest.mark.parametrize("arch,item", [
    ("mixtral-8x7b", "mixture-of-experts"), ("xlstm-1.3b", "mLSTM"),
    ("hubert-xlarge", "encoder"), ("qwen2-vl-7b", "vlm")])
def test_waiting_block_types_raise(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        Model(get_config(arch, smoke=True), device="cpu")


def test_serve_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "recurrentgemma-2b", "--device", "cpu", "--gen", "4"],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    assert "recurrentgemma-2b: 4 tokens x 4 seqs" in out.stdout
    assert "first sequence:" in out.stdout
