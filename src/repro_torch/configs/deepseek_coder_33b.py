"""deepseek-coder-33b — dense llama-arch [arXiv:2401.14196; hf].

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256, RoPE + SwiGLU.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="deepseek-coder-33b", family="dense",
        n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=19200, vocab=32256, head_dim=128,
        pattern=("attn",), rope_theta=100000.0, act="silu",
        source="arXiv:2401.14196; hf",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="deepseek-coder-33b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        pattern=("attn",), rope_theta=100000.0, act="silu",
    )


register(full, smoke)
