"""Model assembly: ArchConfig -> init / forward / loss / decode_step, in
PyTorch.

The JAX package's ``models/model.py`` for the block types ``attn``,
``local`` and ``rg``, with its names and constructor arguments.  The model
is an ``nn.Module`` that holds its parameters (f32 masters, cast to bf16 at
use), so the JAX functions' ``params`` argument is the module itself.  The
JAX package stacks each pattern slot's parameters on a leading group axis
and scans over groups; here the blocks are a ``nn.ModuleList`` in layer
order (group after group, then the tail) and the scan is a loop over it.
``models.convert.params_from_jax`` maps one layout to the other.  Blocks:

  attn   pre-norm GQA attention (+RoPE/qk-norm/softcap) + gated MLP
  local  same, sliding-window mask (gemma2 local / recurrentgemma)
  rg     RG-LRU recurrent block + MLP (RecurrentGemma)

A forward's attention is K9 and its RG-LRU scan K10 (``kernels.ops``); a
training backward runs them back through K9-bwd and K10-bwd, with each
pattern group recomputed under ``remat`` (JAX's ``jax.checkpoint`` of its
group step).  Decode carries a cache, a list of per-layer dicts: windowed
layers keep ring buffers (O(window) state), recurrent layers O(1) state.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..kernels import ops
from . import recurrent as rec
from .layers import (DEFAULT_COMPUTE, MLP, AttnSpec, Attention, Params,
                     RMSNorm, attn_out, attn_qkv, cross_entropy,
                     decode_attention, dense_init, embed_init, mlp, rmsnorm,
                     softcap)

ATTN_TYPES = ("attn", "local")
BLOCK_TYPES = ATTN_TYPES + ("rg",)
#: what the port does not build yet, and the ROADMAP item that brings it
WAITING = {"moe": "mixture-of-experts blocks wait for ROADMAP A.8",
           "mlstm": "mLSTM blocks wait for ROADMAP A.8",
           "slstm": "sLSTM blocks wait for ROADMAP A.8",
           "enc": "bidirectional encoder blocks wait for ROADMAP A.8",
           "frames": "frame inputs (HuBERT) wait for ROADMAP A.8",
           "vlm": "vlm inputs and M-RoPE wait for ROADMAP A.8"}


class Block(Params):
    """One layer: ``ln1``, ``attn`` or ``rg``, ``ln2``, ``mlp`` (and the
    sandwich norms ``ln1_post``/``ln2_post`` when ``cfg.post_norm``)."""

    def __init__(self, model: "Model", ltype: str):
        super().__init__()
        cfg, dev = model.cfg, model.device
        self.ltype = ltype
        self.ln1 = RMSNorm(cfg.d_model, dev)
        if ltype in ATTN_TYPES:
            self.attn = Attention(cfg.d_model, model.specs[ltype],
                                  cfg.qk_norm, dev)
            if cfg.post_norm:
                self.ln1_post = RMSNorm(cfg.d_model, dev)
                self.ln2_post = RMSNorm(cfg.d_model, dev)
        else:
            self.rg = rec.RGLRU(model.rg_spec, dev)
        self.ln2 = RMSNorm(cfg.d_model, dev)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=True, device=dev)


class Model(Params):
    def __init__(self, cfg: ArchConfig, tp: int = 1,
                 use_chunked_attn: bool | None = None, remat: bool = True,
                 *, device=None):
        """``use_chunked_attn`` and ``remat`` are the JAX arguments.  The
        port's attention is K9 at every length (O(s) memory, the function
        of the JAX package's chunked attention), so ``use_chunked_attn``
        does not change the path.  ``remat`` (JAX's default, True) makes a
        forward that autograd records keep only each pattern group's input
        and recompute the group in the backward (``torch.utils.checkpoint``,
        as JAX's ``jax.checkpoint(group_step)``; the tail blocks are kept);
        a serving forward records nothing, so there it changes nothing.
        ``device`` defaults to ``cuda`` (:func:`resolve_device`)."""
        super().__init__()
        for t in (*cfg.pattern, *cfg.tail, cfg.input_kind):
            if t in WAITING:
                raise NotImplementedError(f"{cfg.name}: {WAITING[t]}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tp = tp
        self.q_heads = cfg.padded_heads(tp)
        self.vocab = cfg.padded_vocab(256 if cfg.vocab > 1000 else 16)
        self.remat = remat
        self.use_chunked_attn = use_chunked_attn
        self.specs: dict[str, AttnSpec] = {}
        for t in set(cfg.pattern) | set(cfg.tail):
            if t not in BLOCK_TYPES:
                raise ValueError(t)
            if t in ATTN_TYPES:
                self.specs[t] = AttnSpec(
                    n_heads=self.q_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.head_dim, causal=cfg.causal,
                    window=cfg.window if t == "local" else None,
                    softcap=cfg.attn_softcap, scale=cfg.attn_scale)
        if cfg.rnn_width:
            self.rg_spec = rec.RglruSpec(cfg.d_model, cfg.rnn_width)
        self.add("embed", (self.vocab, cfg.d_model), self.device, embed_init)
        if not cfg.tie_embeddings:
            self.add("lm_head", (cfg.d_model, self.vocab), self.device,
                     dense_init)
        self.final_norm = RMSNorm(cfg.d_model, self.device)
        self.layers = nn.ModuleList(Block(self, lt) for lt in self.ltypes)
        # sqrt(d_model) rounded to bf16 first, as the JAX package does
        self.embed_scale = torch.tensor(math.sqrt(cfg.d_model),
                                        dtype=DEFAULT_COMPUTE,
                                        device=self.device)

    @property
    def ltypes(self) -> list[str]:
        """Block types in layer order: the pattern ``n_groups`` times, then
        the tail (the JAX group scan, unrolled)."""
        return list(self.cfg.pattern) * self.cfg.n_groups + list(self.cfg.tail)

    # ------------------------------------------------------------------ init

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from ``generator`` (which must live on the
        model's device) and return the model."""
        if generator.device.type != self.device.type:
            raise ValueError(f"init: a generator on {generator.device} for a "
                             f"model on {self.device}")
        return super().init(generator)

    # --------------------------------------------------------------- forward

    def _attention(self, spec: AttnSpec, q, k, v):
        """q: (b, s, hq, d); k/v: (b, s, hkv, d) at positions arange(s)
        (all that ``forward`` passes): K9 in the kernel's (b, h, s, d)
        layout."""
        o = ops.flash(q.transpose(1, 2).contiguous(),
                      k.transpose(1, 2).contiguous(),
                      v.transpose(1, 2).contiguous(), causal=spec.causal,
                      window=spec.window, softcap=spec.softcap,
                      scale=spec.scale)
        return o.transpose(1, 2)

    def _apply_block(self, p: Block, x: torch.Tensor, positions):
        """Full-sequence block application."""
        cfg = self.cfg
        if p.ltype in ATTN_TYPES:
            spec = self.specs[p.ltype]
            h = rmsnorm(p["ln1"], x)
            rope_pos = positions if cfg.use_rope else None
            q, k, v = attn_qkv(p["attn"], spec, h, rope_pos, cfg.rope_theta)
            o = attn_out(p["attn"], spec, self._attention(spec, q, k, v))
            if cfg.post_norm:
                o = rmsnorm(p["ln1_post"], o)
            x = x + o
            y = mlp(p["mlp"], rmsnorm(p["ln2"], x), cfg.act)
            if cfg.post_norm:
                y = rmsnorm(p["ln2_post"], y)
            x = x + y
        else:
            h = rmsnorm(p["ln1"], x)
            x = x + rec.rglru_seq(p["rg"], self.rg_spec, h)
            x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x), cfg.act)
        return x

    def _embed_in(self, tokens: torch.Tensor) -> torch.Tensor:
        # gather, then cast: the JAX package casts the table first, which
        # gives the same values
        x = self.embed[tokens.long()].to(DEFAULT_COMPUTE)
        if self.cfg.embed_scale:
            x = x * self.embed_scale
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(self.final_norm, x)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return softcap(x @ head.to(x.dtype), self.cfg.final_softcap)

    def forward(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """``batch["tokens"]`` (b, s) int -> (logits (b, s, V), aux_loss).
        The aux loss is the MoE router's in the JAX package: 0 for the
        block types ported here.  Differentiable where autograd records it
        (the train step); serving wraps it in ``inference_mode``."""
        tokens = batch["tokens"]
        x = self._embed_in(tokens)
        positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
        P = len(self.cfg.pattern)
        n_group = P * self.cfg.n_groups
        remat = self.remat and torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())
        for g0 in range(0, n_group, P):
            blocks = self.layers[g0:g0 + P]
            if remat:
                x = checkpoint(self._apply_group, blocks, x, positions,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = self._apply_group(blocks, x, positions)
        for block in self.layers[n_group:]:
            x = self._apply_block(block, x, positions)
        return self._logits(x), torch.zeros((), dtype=torch.float32,
                                            device=x.device)

    def _apply_group(self, blocks, x: torch.Tensor, positions):
        """One pattern group (JAX's ``group_step``)."""
        for block in blocks:
            x = self._apply_block(block, x, positions)
        return x

    def loss(self, batch: dict) -> torch.Tensor:
        """Mean cross-entropy of ``batch["labels"]`` (masked by
        ``batch["mask"]`` when present) plus 0.01 of the aux loss, as
        JAX's ``Model.loss``."""
        logits, aux = self.forward(batch)
        ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
        return ce + 0.01 * aux

    # ---------------------------------------------------------------- decode

    def cache_len(self, ltype: str, max_len: int) -> int:
        spec = self.specs.get(ltype)
        if spec is not None and spec.window is not None:
            return min(max_len, spec.window)
        return max_len

    def _init_block_cache(self, ltype: str, batch: int, max_len: int) -> dict:
        cfg, dev = self.cfg, self.device
        if ltype in ATTN_TYPES:
            S = self.cache_len(ltype, max_len)
            shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
            return {"k": torch.zeros(shape, dtype=DEFAULT_COMPUTE, device=dev),
                    "v": torch.zeros(shape, dtype=DEFAULT_COMPUTE, device=dev),
                    "pos": torch.full((S,), -1, dtype=torch.int32,
                                      device=dev)}
        return rec.rglru_state_init(batch, self.rg_spec, dev)

    def init_cache(self, batch: int, max_len: int) -> list[dict]:
        """One dict a layer, in layer order."""
        return [self._init_block_cache(lt, batch, max_len)
                for lt in self.ltypes]

    def _decode_block(self, p: Block, c: dict, x: torch.Tensor, pos: int):
        """x: (b, 1, d); pos: absolute position. Returns (x, cache')."""
        cfg = self.cfg
        if p.ltype in ATTN_TYPES:
            spec = self.specs[p.ltype]
            S = c["k"].shape[1]
            h = rmsnorm(p["ln1"], x)
            bpos = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                              device=x.device)
            q, k, v = attn_qkv(p["attn"], spec, h,
                               bpos if cfg.use_rope else None, cfg.rope_theta)
            # the ring slot is written in place (the JAX package returns an
            # updated copy)
            slot = pos % S
            c["k"][:, slot] = k[:, 0]
            c["v"][:, slot] = v[:, 0]
            c["pos"][slot] = pos
            o = decode_attention(spec, q, c["k"], c["v"], bpos[:, 0],
                                 c["pos"])
            o = attn_out(p["attn"], spec, o)
            if cfg.post_norm:
                o = rmsnorm(p["ln1_post"], o)
            x = x + o
            y = mlp(p["mlp"], rmsnorm(p["ln2"], x), cfg.act)
            if cfg.post_norm:
                y = rmsnorm(p["ln2_post"], y)
            return x + y, c
        h = rmsnorm(p["ln1"], x)
        y, st = rec.rglru_step(p["rg"], self.rg_spec, h, c)
        x = x + y
        return x + mlp(p["mlp"], rmsnorm(p["ln2"], x), cfg.act), st

    @torch.no_grad()
    def decode_step(self, cache: list[dict], tokens: torch.Tensor, pos):
        """One greedy-decode step. tokens: (b,) int; pos: int (or a 0-d
        tensor), the absolute position.  Returns (logits (b, V), cache');
        attention layers' ring buffers are updated in place."""
        pos = int(pos)
        x = self._embed_in(tokens)[:, None, :]
        new_cache = []
        for block, c in zip(self.layers, cache):
            x, c = self._decode_block(block, c, x, pos)
            new_cache.append(c)
        return self._logits(x)[:, 0, :], new_cache
