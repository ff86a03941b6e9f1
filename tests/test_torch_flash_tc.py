"""The numeric contract of K9's tensor-core route, checked on the CPU.

The bf16 route of ``repro_torch.kernels.flash_attention`` runs on the card
only (``csrc/flash_attention.cu``, ``flash_kernel_tc``).  This file emulates
its roundings in f32 PyTorch, step for step — bf16 q·k products (exact in
f32) summed in f32, ``scale`` applied to the f32 scores after the product,
softcap and mask in f32, an online softmax over 64-key tiles in f32, P
split as ``P_hi = bf16(p)``, ``P_lo = bf16(p − P_hi)``, ``acc += P_hi·V +
P_lo·V`` accumulated in f32,
``acc / max(l, 1e-30)`` rounded to bf16 — and holds it to the plain version
within ``chip_smoke.flash_err``'s tolerance (``K9_ATOL`` and one bf16 step)
on a CPU-sized cut of ``chip_smoke.py``'s ragged K9 grid: every window,
softcap, GQA repeat and head dim of the ``K9_*`` grids, sq = sk in 1, 63
and 130.  The emulation lives here, not in the package: the package's own
CPU path is the plain version."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.kernels.ref import NEG_INF  # noqa: E402

#: the tensor-core kernel's key tile (``tc::BK`` in flash_attention.cu)
BK = 64
#: CPU-sized sequence lengths (the card's grid adds 2049)
SEQS = (1, 63, 130)


def emulate_tc(q, k, v, *, causal=True, window=None, softcap=None,
               scale=None):
    """The tensor-core K9's arithmetic on bf16 q (b, hq, s, d) and k/v
    (b, hkv, s, d), in f32 on the CPU."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = scale or (1.0 / np.sqrt(d))
    qf = q.float()
    kf = k.repeat_interleave(rep, dim=1).float()
    vf = v.repeat_interleave(rep, dim=1).float()
    qi = torch.arange(sq)[:, None]
    m = torch.full((b, hq, sq, 1), NEG_INF)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    for k0 in range(0, sk, BK):
        kj = torch.arange(k0, min(k0 + BK, sk))[None, :]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + BK]) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        ok = torch.ones((sq, kj.shape[1]), dtype=torch.bool)
        if causal:
            ok &= qi >= kj
        if window is not None:
            ok &= (qi - kj) < window
        s = torch.where(ok, s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.to(torch.bfloat16)
        p_lo = (p - p_hi.float()).to(torch.bfloat16)
        vt = vf[:, :, k0:k0 + BK]
        acc = (acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p_hi.float(), vt)
               + torch.einsum("bhqk,bhkd->bhqd", p_lo.float(), vt))
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("d", chip_smoke.K9_DIMS)
@pytest.mark.parametrize("rep", chip_smoke.K9_REPS)
@pytest.mark.parametrize("s", SEQS)
def test_tensor_core_roundings_hold_k9_tolerance(s, rep, d):
    """The split-P emulation is within ``flash_err``'s tolerance of the
    plain version at every window, softcap and mask of the grid."""
    rng = np.random.default_rng(s * 100 + rep * 10 + d)
    b, hkv = 2, 1 if rep == 10 else 2
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)).to(torch.bfloat16) for h in (hkv * rep, hkv, hkv))
    for causal in (True, False):
        for window in chip_smoke.K9_WINDOWS:
            for cap in chip_smoke.K9_SOFTCAPS:
                kw = dict(causal=causal, window=window, softcap=cap,
                          scale=None if cap is None else 0.1)
                chip_smoke.flash_err(torch, emulate_tc(q, k, v, **kw),
                                     flash_attention.plain(q, k, v, **kw), v)


def test_split_p_is_what_holds_the_tolerance():
    """Without the split, P·V rounds p to bf16 (2^-8 relative): on rows
    whose output nearly cancels the error exceeds ``K9_ATOL``, while the
    split keeps it far inside.  The rows below attend to 2,048 keys with
    values ±1 in equal number, so the exact output is near 0."""
    rng = np.random.default_rng(0)
    s, d = 2048, 16
    q = torch.from_numpy(rng.standard_normal((1, 1, 4, d)).astype(
        np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((1, 1, s, d)).astype(
        np.float32)).to(torch.bfloat16)
    sign = np.where(np.arange(s) % 2 == 0, 1.0, -1.0).astype(np.float32)
    v = torch.from_numpy(np.repeat(sign[None, None, :, None], d, -1)).to(
        torch.bfloat16)
    kw = dict(causal=False, scale=0.5)
    want = flash_attention.plain(q, k, v, **kw).float()
    split = emulate_tc(q, k, v, **kw).float()
    qf, kf, vf = q.float(), k.float(), v.float()
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * 0.5, -1)
    single = torch.einsum("bhqk,bhkd->bhqd",
                          p.to(torch.bfloat16).float(), vf)
    assert float((split - want).abs().max()) <= chip_smoke.K9_ATOL
    assert float((single - want).abs().max()) > chip_smoke.K9_ATOL
