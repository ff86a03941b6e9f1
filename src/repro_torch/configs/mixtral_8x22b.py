"""mixtral-8x22b — MoE 8 experts top-2 + SWA [arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, sliding window 4096.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=32768, head_dim=128,
        pattern=("moe",), window=4096, n_experts=8, top_k=2,
        rope_theta=1000000.0, act="silu", subquadratic=True,
        source="arXiv:2401.04088; hf",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        pattern=("moe",), window=16, n_experts=4, top_k=2,
        act="silu", subquadratic=True,
    )


register(full, smoke)
