"""xlstm-1.3b — recurrent sLSTM + mLSTM blocks [arXiv:2405.04517].

48 blocks, d_model=2048, 4 heads, vocab=50304, d_ff=0 (pre-up-projection
blocks carry their own 2x expansion).  Ratio 7:1 mLSTM:sLSTM (xLSTM[7:1]),
realized as 6 groups of (7 mLSTM + 1 sLSTM).  O(1) decode state =>
runs long_500k.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304, head_dim=512,
        pattern=("mlstm",) * 7 + ("slstm",),
        mlstm_heads=4, mlstm_proj=2.0, use_rope=False,
        act="gelu", subquadratic=True,
        source="arXiv:2405.04517",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="xlstm-1.3b-smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=0, vocab=256, head_dim=32,
        pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        mlstm_heads=2, mlstm_proj=2.0, use_rope=False,
        act="gelu", subquadratic=True,
    )


register(full, smoke)
