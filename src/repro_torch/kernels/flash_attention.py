"""K9 — forward attention with an online softmax, a CUDA kernel for Hopper.

Replaces the Pallas kernel ``repro.kernels.flash_attention.flash_attention``:
GQA, causal, sliding-window and logit-softcap attention in the JAX layout
q (b, hq, sq, d), k/v (b, hkv, sk, d), the attention of every ``attn`` and
``local`` block of a prefill (``models.model.Model._attention``).
``csrc/flash_attention.cu``: one block a (b·hq row, 64-query tile) looping
over 32-key tiles with (m, l, acc) in registers, kv heads read by index,
wholly masked kv tiles skipped, f32 arithmetic on f32 or bf16 inputs.

On CPU tensors the wrapper runs the plain version (:data:`plain`); on CUDA
tensors it launches the kernel or raises.
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
_PROTOTYPES = {"repro_flash_attention": [
    _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
    _VP]}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, scale: float | None = None,
                    bq: int | None = None, bk: int | None = None
                    ) -> torch.Tensor:
    """q: (b, hq, sq, d); k/v: (b, hkv, sk, d) -> (b, hq, sq, d) in
    ``q.dtype`` (f32 or bf16; the sums are f32 either way).

    ``scale`` defaults to ``1/sqrt(d)``; ``softcap`` is ``cap·tanh(s/cap)``
    on the scaled logits, before the mask.  ``bq`` and ``bk`` are the JAX
    kernel's block sizes, accepted so that one kwargs dict drives both
    packages; the Hopper kernel keeps its own tiles (64 queries, 32 keys)
    and masks a ragged sq and sk, where the JAX kernel asserts that its
    blocks divide them.
    """
    del bq, bk
    if not build.on_card("flash_attention", q, k, v):
        return plain(q, k, v, causal=causal, window=window, softcap=softcap,
                     scale=scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require(f"flash_attention {name}", t, q.dtype, 4)
    if q.dtype not in (torch.float32, torch.bfloat16):
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
    lib = build.load("flash_attention", _PROTOTYPES)
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq,
            hkv, sq, sk, d, int(q.dtype == torch.bfloat16), int(causal),
            int(has_window), win, int(softcap is not None),
            float(softcap or 0.0), float(scale), build.stream_handle(q))
    build.check(lib, rc, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return o
