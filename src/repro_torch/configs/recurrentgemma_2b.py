"""recurrentgemma-2b — hybrid RG-LRU + local attention, 1:2 [arXiv:2402.19427; hf].

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, head_dim=256,
pattern (recurrent, recurrent, local-attn) × 8 + 2 recurrent tail,
local window 2048, GeGLU, sqrt(d_model) embedding scale.
Sub-quadratic (RG-LRU state + windowed cache) => runs long_500k.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
        d_ff=7680, vocab=256000, head_dim=256,
        pattern=("rg", "rg", "local"), tail=("rg", "rg"),
        window=2048, rnn_width=2560, embed_scale=True,
        rope_theta=10000.0, act="gelu", tie_embeddings=True,
        subquadratic=True,
        source="arXiv:2402.19427; hf",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-2b-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab=256, head_dim=16,
        pattern=("rg", "rg", "local"), tail=("rg", "rg"),
        window=8, rnn_width=64, embed_scale=True,
        act="gelu", tie_embeddings=True, subquadratic=True,
    )


register(full, smoke)
