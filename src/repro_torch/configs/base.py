"""Architecture configs + input-shape grid for the assigned 10 architectures.

A copy of the JAX package's ``configs/base.py`` (pure data, no JAX): every
arch is a frozen ``ArchConfig`` with the JAX field names, the exact
published configuration lives in ``configs/<id>.py`` and a reduced
``smoke()`` variant drives the CPU tests.  ``shape_skip_reason`` keeps the
JAX package's applicability rules for the (arch × shape) grid.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128

    # block structure: `pattern` repeats `n_layers // len(pattern+tail...)`
    # times; `tail` appends the remainder. Entries name block types.
    pattern: tuple[str, ...] = ("attn",)
    tail: tuple[str, ...] = ()

    # attention details
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    window: Optional[int] = None  # sliding-window size for 'local'/'swa' blocks
    rope_theta: float = 10000.0
    use_rope: bool = True
    mrope_sections: Optional[tuple[int, int, int]] = None
    causal: bool = True
    post_norm: bool = False  # gemma2 sandwich norms
    attn_scale: Optional[float] = None  # e.g. gemma2 query_pre_attn_scalar
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scaling

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # recurrent
    rnn_width: int = 0  # RG-LRU lru width
    mlstm_heads: int = 4
    mlstm_proj: float = 2.0

    act: str = "silu"
    tie_embeddings: bool = False
    input_kind: str = "tokens"  # tokens | frames | vlm

    # capability flags for the shape grid
    supports_decode: bool = True
    subquadratic: bool = False  # every token's state is O(window)/O(1)

    source: str = ""  # provenance tag from the assignment table

    @property
    def n_groups(self) -> int:
        body = self.n_layers - len(self.tail)
        assert body % len(self.pattern) == 0, (self.name, body, self.pattern)
        return body // len(self.pattern)

    def padded_heads(self, tp: int = 16) -> int:
        """Query heads padded up to a TP-divisible count (DESIGN.md §5)."""
        return ((self.n_heads + tp - 1) // tp) * tp

    def padded_vocab(self, mult: int = 256) -> int:
        return ((self.vocab + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_skip_reason(cfg: ArchConfig, shape: ShapeSpec) -> str | None:
    """None => run the cell; else a human-readable skip reason."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return "encoder-only architecture has no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("pure full-attention architecture: 500k-token KV state is "
                "O(s) per token and quadratic end-to-end; skipped per assignment")
    return None


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, "tuple"] = {}


def register(full_fn, smoke_fn):
    cfg = full_fn()
    _REGISTRY[cfg.name] = (full_fn, smoke_fn)
    return cfg


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    full_fn, smoke_fn = _REGISTRY[name]
    return smoke_fn() if smoke else full_fn()


def all_arch_names() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from . import (deepseek_coder_33b, gemma2_9b, hubert_xlarge,  # noqa: F401
                   mixtral_8x22b, mixtral_8x7b, phi4_mini_3_8b, qwen2_vl_7b,
                   qwen3_14b, recurrentgemma_2b, xlstm_1_3b)
