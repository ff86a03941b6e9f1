"""K10 — the RG-LRU gated linear recurrence, a CUDA kernel for Hopper.

Replaces the Pallas kernel ``repro.kernels.rglru_scan.rglru_scan``:
``h_t = a_t ⊙ h_{t-1} + b_t`` over the sequence from ``h_0 = 0``, the scan
of every RG-LRU block of a RecurrentGemma prefill (``models.recurrent.
rglru_seq``).  ``csrc/rglru_scan.cu``: one CTA a (batch, block of ``CW``
channels); a producer warp keeps a shared-memory ring of stages of ``T``
steps full, and a consumer warp, one thread a channel, walks t in order
through it.  Where the width is a multiple of 4 and a and b lie on 16-byte
boundaries, TMA boxes fill the ring and store h back from shared memory;
otherwise 4-byte ``cp.async`` fills it and the consumer stores h itself
(:func:`route`).  Each channel takes the same two roundings a step as the
plain version, in the same order, so the two are equal bit for bit; a
chunked two-pass scan would give the card more threads but round in
another order, and the ring comes near the card's byte rate without it.
:func:`scan_in_kernel_order` is the kernel's walk in PyTorch.


:func:`rglru_scan_bwd` is its backward, K10-bwd (``csrc/rglru_scan_bwd.cu``,
counter ``rglru_scan_bwd``): a kernel of the port with no TPU counterpart
(the JAX package differentiates an associative scan), the reverse walk
with ``da`` and ``db`` in the same pass, bit for bit its plain version.

On CPU tensors the wrappers run the plain versions (:data:`plain`,
:data:`plain_bwd`); on CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

#: the plain PyTorch version of this kernel, and of its backward
plain = ref.rglru_scan_ref
plain_bwd = ref.rglru_scan_bwd_ref

#: the kernel's default plan (``csrc/rglru_scan.cu``): channels a CTA and
#: steps a ring stage; its stage count, 2 to 4, follows the shape
#: (:func:`stages`)
CW, T = 32, 64
#: the (channels, steps) a stage the kernel is built for; any 2..16 stages
#: that fit a block's shared memory
PLANS = ((16, 32), (16, 64), (16, 128), (32, 32), (32, 64), (32, 128))

_VP, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    "repro_rglru_scan": [_VP, _VP, _VP, _I, _I, _I, _VP],
    "repro_rglru_scan_plan": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
    "repro_rglru_scan_route": [_VP, _VP, _I],
    "repro_rglru_scan_stages": [_I, _I]}
_BWD_PROTOTYPES = {"repro_rglru_scan_bwd": [_VP] * 5 + [_I] * 3 + [_VP]}


def rglru_scan(a: torch.Tensor, b: torch.Tensor, *, bw: int | None = None,
               bs: int | None = None,
               plan: tuple[int, int, int] | None = None) -> torch.Tensor:
    """a, b: (B, S, W) -> h: (B, S, W) f32 with ``h_t = a_t h_{t-1} + b_t``.

    Inputs are taken as f32, as the JAX kernel casts them.  ``bw`` and
    ``bs`` are the JAX kernel's block sizes, accepted so that one kwargs
    dict drives both packages; the Hopper kernel masks a ragged S and W,
    where the JAX kernel asserts that its blocks divide them.  ``plan``
    (``(cw, t, stages)``, ``(cw, t)`` one of :data:`PLANS`) replaces the
    kernel's default plan; it changes no bit of the result.
    """
    del bw, bs
    if not build.on_card("rglru_scan", a, b):
        return plain(a, b)
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    build.require("rglru_scan a", a, torch.float32, 3)
    if b.shape != a.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must have one (B, S, W) shape")
    batch, seq, width = a.shape
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    lib = build.load("rglru_scan", _PROTOTYPES)
    with torch.cuda.device(a.device):
        stream = build.stream_handle(a)
        if plan is None:
            rc = lib.repro_rglru_scan(a.data_ptr(), b.data_ptr(),
                                      h.data_ptr(), batch, seq, width, stream)
        else:
            rc = lib.repro_rglru_scan_plan(a.data_ptr(), b.data_ptr(),
                                           h.data_ptr(), batch, seq, width,
                                           *plan, stream)
    build.check(lib, rc, f"rglru_scan (plan {plan or 'default'})")
    build.LAUNCHES["rglru_scan"] += 1
    return h


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """K10-bwd: from the decays ``a``, :func:`rglru_scan`'s states ``h`` and
    their gradient ``dh`` (all (B, S, W), taken as f32), ``(da, db)`` f32:
    ``g_t = dh_t + a_{t+1} g_{t+1}``, ``db_t = g_t``, ``da_t = g_t
    h_{t-1}``."""
    if not build.on_card("rglru_scan_bwd", a, h, dh):
        return plain_bwd(a, h, dh)
    a, h, dh = (t.to(torch.float32).contiguous() for t in (a, h, dh))
    build.require("rglru_scan_bwd a", a, torch.float32, 3)
    if h.shape != a.shape or dh.shape != a.shape:
        raise ValueError(f"rglru_scan_bwd: a {tuple(a.shape)}, h "
                         f"{tuple(h.shape)} and dh {tuple(dh.shape)} must "
                         f"have one (B, S, W) shape")
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db
    lib = build.load("rglru_scan_bwd", _BWD_PROTOTYPES)
    with torch.cuda.device(a.device):
        rc = lib.repro_rglru_scan_bwd(
            a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
            db.data_ptr(), *a.shape, build.stream_handle(a))
    build.check(lib, rc, "rglru_scan_bwd")
    build.LAUNCHES["rglru_scan_bwd"] += 1
    return da, db


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The route the kernel takes for these (contiguous f32, CUDA)
    operands, as the kernel's library decides it: ``"tma"`` (width a
    multiple of 4, both on 16-byte boundaries: a, b and h move by TMA) or
    ``"cp.async"``."""
    lib = build.load("rglru_scan", _PROTOTYPES)
    return ("tma" if lib.repro_rglru_scan_route(a.data_ptr(), b.data_ptr(),
                                                a.shape[-1]) else "cp.async")


def stages(batch: int, width: int) -> int:
    """The ring stages of the kernel's default plan at ``batch`` x
    ``width`` channels, as its library decides them: as many as bring the
    ring across the card to about 4 MB, 2 to 4.  They change no bit."""
    lib = build.load("rglru_scan", _PROTOTYPES)
    return lib.repro_rglru_scan_stages(batch, width)


def scan_in_kernel_order(a: torch.Tensor, b: torch.Tensor, cw: int = CW,
                         t: int = T) -> torch.Tensor:
    """The kernel's walk in PyTorch: per block of ``cw`` channels (a CTA),
    per ring stage of ``t`` steps, the stage's rows as the producer lands
    them (zeros past S and past the width, as the TMA route fills them; no
    live channel reads them), then the
    consumer's steps over the rows that exist, one rounded product and one
    rounded sum each, storing only the live channels.  Equal to
    :data:`plain` bit for bit at every shape and plan."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    batch, seq, width = a.shape
    out = torch.empty_like(a)
    for w0 in range(0, width, cw):
        live = min(cw, width - w0)
        hv = torch.zeros((batch, cw), dtype=torch.float32, device=a.device)
        for t0 in range(0, seq, t):
            rows = min(t, seq - t0)
            sa = torch.zeros((batch, t, cw), dtype=torch.float32,
                             device=a.device)
            sb = torch.zeros_like(sa)
            sa[:, :rows, :live] = a[:, t0:t0 + rows, w0:w0 + live]
            sb[:, :rows, :live] = b[:, t0:t0 + rows, w0:w0 + live]
            for u in range(rows):
                hv = torch.add(torch.mul(sa[:, u], hv), sb[:, u])
                out[:, t0 + u, w0:w0 + live] = hv[:, :live]
    return out
