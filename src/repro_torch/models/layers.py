"""Core transformer layers in PyTorch: explicit dtypes, init/apply pairs.

The JAX package's ``models/layers.py`` with its names and arguments.  A
block's parameters are a :class:`Params` module, which declares each
tensor's shape and how it is drawn once; ``init(generator)`` draws them
(the JAX ``*_init(key, ...)`` functions).  An apply function takes
``params``, the block's module or a dict of tensors by the same names (the
parity tests pass JAX's), since both index by name.  Compute dtype is bf16
with f32 where the JAX package keeps f32 (norms, softmax, rope, logit
caps); master parameters are f32, cast at use.

Attention:
  * ``attention_reference`` — the plain einsum in the model's (b, s, h, d)
    layout (the oracle);
  * ``attention_chunked`` — JAX's online softmax over KV chunks in plain
    PyTorch, each chunk recomputed in the backward;
  * the model's attention is K9 (``kernels.ops.flash``, the same function,
    O(s) memory, with K9-bwd as its backward), through
    ``models.model.Model._attention``;
  * ``decode_attention`` — one query position against a (ring) cache.

``cross_entropy`` is the training loss's mean NLL in f32.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.ref import NEG_INF

DEFAULT_COMPUTE = torch.bfloat16


class Params(nn.Module):
    """A module whose parameters and sub-modules are read by name, as the
    JAX functions read a params dict: ``params["wq"]``, ``"q_norm" in
    params``.  Parameters are registered with ``requires_grad=False``, so
    serving and every forward outside training records nothing; the train
    step (``train.steps.make_train_step``) turns gradients on for its own
    scope only."""

    def __init__(self):
        super().__init__()
        self._draws: dict[str, Callable | None] = {}

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def add(self, name: str, shape, device, draw: Callable | None = None
            ) -> None:
        """Register an f32 parameter ``name`` of ``shape``, which
        :meth:`init` fills with ``draw(generator, *shape)`` (zeros when
        ``draw`` is None)."""
        self.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=torch.float32, device=device),
            requires_grad=False))
        self._draws[name] = draw

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Params":
        """Draw every parameter of this module and its sub-modules from
        ``generator``, in the order they were registered."""
        for module in self.modules():
            for name, draw in getattr(module, "_draws", {}).items():
                p = module[name]
                p.copy_(torch.zeros_like(p) if draw is None
                        else draw(generator, *p.shape))
        return self


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


class RMSNorm(Params):
    """``scale``, zero at init (the norm scales by ``1 + scale``)."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.add("scale", (d,), device)


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"])).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (b, s, h, d); positions: (b, s) (or broadcastable) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (d/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (b, s, d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int  # padded query heads (divisible by TP)
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    window: int | None = None  # sliding/local window (None = full)
    softcap: float | None = None
    scale: float | None = None


def _mask_bias(spec: AttnSpec, q_pos: torch.Tensor, k_pos: torch.Tensor
               ) -> torch.Tensor:
    """(q, k) additive bias from causality + locality."""
    ok = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    if spec.causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if spec.window is not None:
        ok &= (q_pos[:, None] - k_pos[None, :]) < spec.window
    return torch.where(ok, 0.0, NEG_INF)


def attention_reference(spec: AttnSpec, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, q_pos: torch.Tensor,
                        k_pos: torch.Tensor) -> torch.Tensor:
    """q: (b, sq, hq, d); k/v: (b, sk, hkv, d).  GQA by head grouping."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    scale = spec.scale or (1.0 / math.sqrt(d))
    qf = (q.to(torch.float32) * scale).reshape(b, sq, hkv, rep, d)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qf, kf)
    if spec.softcap is not None:
        scores = spec.softcap * torch.tanh(scores / spec.softcap)
    scores = scores + _mask_bias(spec, q_pos, k_pos)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", p, vf)
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attention_chunked(spec: AttnSpec, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, q_pos: torch.Tensor,
                      k_pos: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention over KV chunks (JAX's flash equivalent,
    O(s) memory): q (b, sq, hq, d), k/v (b, sk, hkv, d).  A ragged sk
    falls back to a single chunk, as in JAX; each chunk's step is
    recomputed in the backward (``torch.utils.checkpoint``, as JAX's
    ``jax.checkpoint(step)``), so the (s, chunk) scores are never kept."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = spec.scale or (1.0 / math.sqrt(d))
    if sk % chunk:
        chunk = sk  # fall back to single chunk for ragged sizes
    qf = (q.to(torch.float32) * scale).reshape(b, sq, hkv, rep, d)

    def step(m, l, acc, ks, vs, kp):
        s = torch.einsum("bqhrd,bkhd->bhrqk", qf, ks.to(torch.float32))
        if spec.softcap is not None:
            s = spec.softcap * torch.tanh(s / spec.softcap)
        s = s + _mask_bias(spec, q_pos, kp)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * alpha + p.sum(dim=-1)
        acc_new = acc * alpha[..., None] + torch.einsum(
            "bhrqk,bkhd->bhrqd", p, vs.to(torch.float32))
        return m_new, l_new, acc_new

    m = torch.full((b, hkv, rep, sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, rep, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, rep, sq, d), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, sk, chunk):
        args = (m, l, acc, k[:, c0:c0 + chunk], v[:, c0:c0 + chunk],
                k_pos[c0:c0 + chunk])
        if torch.is_grad_enabled():
            m, l, acc = checkpoint(step, *args, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            m, l, acc = step(*args)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    return out.to(q.dtype)


def decode_attention(spec: AttnSpec, q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, q_pos: torch.Tensor,
                     k_pos: torch.Tensor) -> torch.Tensor:
    """Single-token decode: q (b, 1, hq, d); caches (b, S, hkv, d).

    ``k_pos`` (S,) holds the absolute position stored in each cache slot
    (-1 = unfilled); ring-buffer caches work unchanged because masking is
    by absolute position, not slot index.
    """
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    rep = hq // hkv
    scale = spec.scale or (1.0 / math.sqrt(d))
    qf = (q.to(torch.float32) * scale).reshape(b, hkv, rep, d)
    s = torch.einsum("bhrd,bkhd->bhrk", qf, k_cache.to(torch.float32))
    if spec.softcap is not None:
        s = spec.softcap * torch.tanh(s / spec.softcap)
    ok = (k_pos[None, :] >= 0) & (k_pos[None, :] <= q_pos[:, None])  # (b, S)
    if spec.window is not None:
        ok &= (q_pos[:, None] - k_pos[None, :]) < spec.window
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhrk,bkhd->bhrd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# attention block (projections + norms + rope)
# ---------------------------------------------------------------------------


class Attention(Params):
    """The projections (and qk-norms) of an attention block."""

    def __init__(self, d_model: int, spec: AttnSpec, qk_norm: bool,
                 device=None):
        super().__init__()
        hq, hkv, d = spec.n_heads, spec.n_kv_heads, spec.head_dim
        self.add("wq", (d_model, hq * d), device, dense_init)
        self.add("wk", (d_model, hkv * d), device, dense_init)
        self.add("wv", (d_model, hkv * d), device, dense_init)
        self.add("wo", (hq * d, d_model), device, dense_init)
        if qk_norm:
            self.q_norm = RMSNorm(d, device)
            self.k_norm = RMSNorm(d, device)


def attn_qkv(params, spec: AttnSpec, x: torch.Tensor, positions, theta: float,
             mrope_sections=None, compute=DEFAULT_COMPUTE):
    if mrope_sections is not None:
        raise NotImplementedError(
            "M-RoPE (vlm inputs) waits for the port's vlm slice (ROADMAP A.8)")
    b, s, _ = x.shape
    hq, hkv, d = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = (x @ params["wq"].to(compute)).reshape(b, s, hq, d)
    k = (x @ params["wk"].to(compute)).reshape(b, s, hkv, d)
    v = (x @ params["wv"].to(compute)).reshape(b, s, hkv, d)
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if positions is not None:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def attn_out(params, spec: AttnSpec, o: torch.Tensor,
             compute=DEFAULT_COMPUTE) -> torch.Tensor:
    b, s = o.shape[:2]
    return o.reshape(b, s, spec.n_heads * spec.head_dim) @ params["wo"].to(
        compute)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class MLP(Params):
    """The up, down (and gate) projections of the MLP."""

    def __init__(self, d_model: int, d_ff: int, gated: bool = True,
                 device=None):
        super().__init__()
        self.add("w_up", (d_model, d_ff), device, dense_init)
        self.add("w_down", (d_ff, d_model), device, dense_init)
        if gated:
            self.add("w_gate", (d_model, d_ff), device, dense_init)


_ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}


def mlp(params, x: torch.Tensor, act: str = "silu",
        compute=DEFAULT_COMPUTE) -> torch.Tensor:
    up = x @ params["w_up"].to(compute)
    fn = _ACTS[act]
    if "w_gate" in params:
        h = fn(x @ params["w_gate"].to(compute)) * up
    else:
        h = fn(up)
    return h @ params["w_down"].to(compute)


# ---------------------------------------------------------------------------
# logits
# ---------------------------------------------------------------------------


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean NLL in f32: logits (..., V); labels (...) int; with ``mask``
    the mean over the masked-in positions (at least one), as JAX's."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        m = mask.to(torch.float32)
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()
