"""phi4-mini-3.8b — dense, RoPE SwiGLU GQA [arXiv:2412.08905; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=200064, head_dim=128,
        pattern=("attn",), rope_theta=10000.0, act="silu",
        tie_embeddings=True,
        source="arXiv:2412.08905; hf",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        pattern=("attn",), act="silu", tie_embeddings=True,
    )


register(full, smoke)
