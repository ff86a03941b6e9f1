"""K9 — forward attention with an online softmax, a CUDA kernel for Hopper.

Replaces the Pallas kernel ``repro.kernels.flash_attention.flash_attention``:
GQA, causal, sliding-window and logit-softcap attention in the JAX layout
q (b, hq, sq, d), k/v (b, hkv, sk, d), the attention of every ``attn`` and
``local`` block of a prefill (``models.model.Model._attention``).

``csrc/flash_attention.cu`` holds one kernel per input dtype, each with its
own launch counter:

* bf16 (the prefill's path, counter ``flash_attention``): the tensor-core
  kernel, ``wgmma`` with f32 accumulators, a 128-query tile (two
  warpgroups) looping over double-buffered 64-key tiles, P·V as
  ``P_hi·V + P_lo·V`` so that it holds the f32 kernel's tolerance;
* f32 (counter ``flash_attention_f32``): the CUDA-core kernel, f32
  arithmetic, a 64-query tile looping over 32-key tiles.

Both read kv heads by index and skip wholly masked kv tiles, and write each
row's log-sum-exp when asked (``return_lse``: the training forward, never
the prefill).

:func:`flash_attention_bwd` is its backward, K9-bwd
(``csrc/flash_attention_bwd.cu``): a kernel of the port with no TPU
counterpart (the JAX package trains through plain JAX), with a route per
dtype as the forward's: bf16 on the tensor cores (``mma.sync``, P and dS
split in two bf16 halves; counter ``flash_attention_bwd``), f32 on the
CUDA cores (counter ``flash_attention_bwd_f32``); deterministic either way:
dQ in one pass over key tiles, dK and dV in one over query tiles, no float
atomics.

On CPU tensors the wrappers run the plain versions (:data:`plain`,
:data:`plain_bwd`); on CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, ref

#: the plain PyTorch version of this kernel, and of its backward
plain = ref.flash_attention_ref
plain_bwd = ref.flash_attention_bwd_ref

#: the widest head the kernel's register accumulator holds
MAX_HEAD_DIM = 256

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
         _F, _F, _VP]
#: the entry point and launch counter of each input dtype's kernel
ROUTES = {torch.bfloat16: ("repro_flash_attention_bf16", "flash_attention"),
          torch.float32: ("repro_flash_attention_f32", "flash_attention_f32")}
_PROTOTYPES = {fn: _ARGS for fn, _ in ROUTES.values()}
_BWD_PROTOTYPES = {"repro_flash_attention_bwd": [_VP] * 12 + [_I] * 11
                   + [_F, _F, _VP]}
#: K9-bwd's launch counter for each input dtype's route
BWD_ROUTES = {torch.bfloat16: "flash_attention_bwd",
              torch.float32: "flash_attention_bwd_f32"}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, scale: float | None = None,
                    bq: int | None = None, bk: int | None = None,
                    return_lse: bool = False):
    """q: (b, hq, sq, d); k/v: (b, hkv, sk, d) -> (b, hq, sq, d) in
    ``q.dtype`` (f32 or bf16; the sums are f32 either way, and bf16 runs
    the tensor-core kernel, f32 the CUDA-core one).

    ``scale`` defaults to ``1/sqrt(d)``; ``softcap`` is ``cap·tanh(s/cap)``
    on the scaled logits, before the mask.  ``bq`` and ``bk`` are the JAX
    kernel's block sizes, accepted so that one kwargs dict drives both
    packages; the Hopper kernels keep their own tiles and mask a ragged sq
    and sk, where the JAX kernel asserts that its blocks divide them.

    ``return_lse`` returns ``(o, lse)``: each row's log-sum-exp of its
    masked logits, (b, hq, sq) f32, from the running max and sum the
    softmax used (what :func:`flash_attention_bwd` takes).
    """
    del bq, bk
    if not build.on_card("flash_attention", q, k, v):
        return plain(q, k, v, causal=causal, window=window, softcap=softcap,
                     scale=scale, return_lse=return_lse)
    b, hq, sq, d, hkv, sk = _check("flash_attention", q, k, v)
    o = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if o.numel() == 0:
        return (o, lse) if return_lse else o
    fn, counter = ROUTES[q.dtype]
    lib = build.load("flash_attention", _PROTOTYPES)
    with torch.cuda.device(q.device):
        rc = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if return_lse else None, b, hq, hkv, sq, sk, d,
            *_mask_args(sq, sk, d, causal, window, softcap, scale),
            build.stream_handle(q))
    build.check(lib, rc, counter)
    build.LAUNCHES[counter] += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None):
    """K9-bwd: ``(dq, dk, dv)`` of :func:`flash_attention` from its inputs,
    its output ``o`` and ``lse`` (``return_lse``) and the output's gradient
    ``do`` (all of q's dtype, f32 or bf16, but ``lse``: f32); the gradients
    in the inputs' dtype, every sum f32 (bf16 runs the tensor-core kernels,
    f32 the CUDA-core ones).  The keywords are the forward's."""
    if not build.on_card("flash_attention_bwd", q, k, v, o, lse, do):
        return plain_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                         softcap=softcap, scale=scale)
    b, hq, sq, d, hkv, sk = _check("flash_attention_bwd", q, k, v)
    build.require("flash_attention_bwd o", o, q.dtype, 4)
    build.require("flash_attention_bwd do", do, q.dtype, 4)
    build.require("flash_attention_bwd lse", lse, torch.float32, 3)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, hq, sq):
        raise ValueError(
            f"flash_attention_bwd: o {tuple(o.shape)}, do {tuple(do.shape)} "
            f"and lse {tuple(lse.shape)} do not match q {tuple(q.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    parts = ([torch.empty((b, hq, sk, d), dtype=torch.float32,
                          device=q.device) for _ in range(2)]
             if hq > hkv else [None, None])
    lib = build.load("flash_attention_bwd", _BWD_PROTOTYPES)
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention_bwd(
            *(t.data_ptr() for t in (q, k, v, o, do, lse, delta, dq, dk, dv)),
            *(t.data_ptr() if t is not None else None for t in parts),
            int(q.dtype == torch.bfloat16), b, hq, hkv, sq, sk, d,
            *_mask_args(sq, sk, d, causal, window, softcap, scale),
            build.stream_handle(q))
    counter = BWD_ROUTES[q.dtype]
    build.check(lib, rc, counter)
    build.LAUNCHES[counter] += 1
    return dq, dk, dv


def _check(what: str, q, k, v) -> tuple[int, ...]:
    """What both kernels take: contiguous 4-D q, k, v of one dtype (f32 or
    bf16), GQA head counts, a head dim the kernels hold.  Returns (b, hq,
    sq, d, hkv, sk)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require(f"{what} {name}", t, q.dtype, 4)
    if q.dtype not in ROUTES:
        raise ValueError(f"{what}: f32 or bf16 inputs, got {q.dtype}")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if (k.shape != (b, hkv, sk, d) or v.shape != k.shape or hq % hkv
            or not 1 <= d <= MAX_HEAD_DIM or sk < 1):
        raise ValueError(
            f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}; expected (b, hq, sq, d) and (b, hkv, sk, d) "
            f"with hq % hkv == 0, 1 <= d <= {MAX_HEAD_DIM} and sk >= 1")
    return b, hq, sq, d, hkv, sk


def _mask_args(sq: int, sk: int, d: int, causal, window, softcap,
               scale) -> tuple:
    """The kernels' (causal, has_window, window, has_softcap, softcap,
    scale) arguments.  A key is in the window when k > q - window: a window
    at or past sq admits every key and one at or below -sk admits none, so
    clamped to [-sk, sq] the mask is unchanged and the kernels' int
    arithmetic exact."""
    has_window = window is not None
    win = min(max(int(window), -sk), sq) if has_window else 0
    return (int(causal), int(has_window), win, int(softcap is not None),
            float(softcap or 0.0), float(scale or (1.0 / math.sqrt(d))))
