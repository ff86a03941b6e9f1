"""hubert-xlarge — audio encoder-only [arXiv:2106.07447].

48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504 (cluster codebook;
padded to 512 for TP divisibility).  The CNN waveform frontend is a STUB per
the assignment: ``input_specs`` supplies precomputed frame embeddings
(b, s, d_model); training is masked-frame cluster prediction (CE over the
codebook on masked positions).  Encoder-only => no decode shapes.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge", family="encoder",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab=504, head_dim=80,
        pattern=("enc",), causal=False, use_rope=False,
        act="gelu", input_kind="frames", supports_decode=False,
        source="arXiv:2106.07447",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge-smoke", family="encoder",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=32, head_dim=16,
        pattern=("enc",), causal=False, use_rope=False,
        act="gelu", input_kind="frames", supports_decode=False,
    )


register(full, smoke)
