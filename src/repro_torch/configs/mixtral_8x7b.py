"""mixtral-8x7b — MoE 8 experts top-2 + SWA [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, sliding window 4096.
SWA ring cache bounds decode state => runs long_500k.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000, head_dim=128,
        pattern=("moe",), window=4096, n_experts=8, top_k=2,
        rope_theta=1000000.0, act="silu", subquadratic=True,
        source="arXiv:2401.04088; hf",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        pattern=("moe",), window=16, n_experts=4, top_k=2,
        act="silu", subquadratic=True,
    )


register(full, smoke)
