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

Both read kv heads by index and skip wholly masked kv tiles.  On CPU
tensors the wrapper runs the plain version (:data:`plain`); on CUDA tensors
it launches the kernel for the dtype or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, ref

#: the plain PyTorch version of this kernel
plain = ref.flash_attention_ref

#: the widest head the kernel's register accumulator holds
MAX_HEAD_DIM = 256

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
         _VP]
#: the entry point and launch counter of each input dtype's kernel
ROUTES = {torch.bfloat16: ("repro_flash_attention_bf16", "flash_attention"),
          torch.float32: ("repro_flash_attention_f32", "flash_attention_f32")}
_PROTOTYPES = {fn: _ARGS for fn, _ in ROUTES.values()}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, scale: float | None = None,
                    bq: int | None = None, bk: int | None = None
                    ) -> torch.Tensor:
    """q: (b, hq, sq, d); k/v: (b, hkv, sk, d) -> (b, hq, sq, d) in
    ``q.dtype`` (f32 or bf16; the sums are f32 either way, and bf16 runs
    the tensor-core kernel, f32 the CUDA-core one).

    ``scale`` defaults to ``1/sqrt(d)``; ``softcap`` is ``cap·tanh(s/cap)``
    on the scaled logits, before the mask.  ``bq`` and ``bk`` are the JAX
    kernel's block sizes, accepted so that one kwargs dict drives both
    packages; the Hopper kernels keep their own tiles and mask a ragged sq
    and sk, where the JAX kernel asserts that its blocks divide them.
    """
    del bq, bk
    if not build.on_card("flash_attention", q, k, v):
        return plain(q, k, v, causal=causal, window=window, softcap=softcap,
                     scale=scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require(f"flash_attention {name}", t, q.dtype, 4)
    if q.dtype not in ROUTES:
        raise ValueError(f"flash_attention: f32 or bf16 inputs, got {q.dtype}")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if (k.shape != (b, hkv, sk, d) or v.shape != k.shape or hq % hkv
            or not 1 <= d <= MAX_HEAD_DIM or sk < 1):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}; expected (b, hq, sq, d) and (b, hkv, sk, d) "
            f"with hq % hkv == 0, 1 <= d <= {MAX_HEAD_DIM} and sk >= 1")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    scale = scale or (1.0 / math.sqrt(d))
    # a key is in the window when k > q - window: a window at or past sq
    # admits every key and one at or below -sk admits none, so clamped to
    # [-sk, sq] the mask is unchanged and the kernel's int arithmetic exact
    has_window = window is not None
    win = min(max(int(window), -sk), sq) if has_window else 0
    fn, counter = ROUTES[q.dtype]
    lib = build.load("flash_attention", _PROTOTYPES)
    with torch.cuda.device(q.device):
        rc = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq,
            hkv, sq, sk, d, int(causal), int(has_window), win,
            int(softcap is not None), float(softcap or 0.0), float(scale),
            build.stream_handle(q))
    build.check(lib, rc, counter)
    build.LAUNCHES[counter] += 1
    return o
