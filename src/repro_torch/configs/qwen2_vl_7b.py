"""qwen2-vl-7b — VLM backbone with M-RoPE [arXiv:2409.12191; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.  The vision frontend
(dynamic-resolution patch embedding) is a STUB per the assignment:
``input_specs`` supplies precomputed patch/token embeddings plus the 3-stream
(t, h, w) M-RoPE position ids; the backbone (this config) is exact.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab=152064, head_dim=128,
        pattern=("attn",), rope_theta=1000000.0, act="silu",
        mrope_sections=(16, 24, 24), input_kind="vlm",
        source="arXiv:2409.12191; hf",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-7b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        pattern=("attn",), act="silu",
        mrope_sections=(2, 3, 3), input_kind="vlm",
    )


register(full, smoke)
