"""qwen3-14b — dense, qk-norm + GQA [hf:Qwen/Qwen3-8B family; hf].

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen3-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=17408, vocab=151936, head_dim=128,
        pattern=("attn",), qk_norm=True, rope_theta=1000000.0, act="silu",
        source="hf:Qwen/Qwen3-8B; hf",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen3-14b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        pattern=("attn",), qk_norm=True, rope_theta=1000000.0, act="silu",
    )


register(full, smoke)
