"""gemma2-9b — dense, local/global alternating + logit softcaps [arXiv:2408.00118; hf].

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000, head_dim=256,
sliding window 4096 on local layers, attn softcap 50, final softcap 30,
GeGLU, sandwich norms, sqrt(d_model) embedding scaling.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="gemma2-9b", family="dense",
        n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
        d_ff=14336, vocab=256000, head_dim=256,
        pattern=("local", "attn"), window=4096,
        attn_softcap=50.0, final_softcap=30.0,
        attn_scale=256 ** -0.5, post_norm=True, embed_scale=True,
        rope_theta=10000.0, act="gelu", tie_embeddings=True,
        source="arXiv:2408.00118; hf",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="gemma2-9b-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        pattern=("local", "attn"), window=8,
        attn_softcap=50.0, final_softcap=30.0,
        attn_scale=16 ** -0.5, post_norm=True, embed_scale=True,
        act="gelu", tie_embeddings=True,
    )


register(full, smoke)
