"""Dispatch for the kernel-backed carriers, and the launch counters.

Every entry returned here routes by device: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the CUDA kernel (or the
call raises).  The one exception is the dense plus-times product, which is
a plain f32 matrix product on both (the JAX package leaves it to XLA's
``jnp.matmul`` as well), held to full f32 on the card.

``flash`` (K9) and ``rglru`` (K10) are differentiable: where autograd
records them, each runs as a ``torch.autograd.Function`` whose backward is
a kernel too (K9-bwd, K10-bwd), and on CPU tensors both directions run the
plain versions.  Where nothing needs a gradient (serving, under
``inference_mode`` or ``no_grad``) they launch the forward kernel alone and
save nothing.
"""
from __future__ import annotations

import torch

from . import build, ref
from .boolmm import bool_frontier_matmul, bool_matmul
from .flash_attention import flash_attention, flash_attention_bwd
from .minplus import (maxplus_frontier_matmul, minplus_frontier_matmul,
                      minplus_matmul)
from .relax import relax_step
from .rglru_scan import rglru_scan, rglru_scan_bwd
from .spmv import (csr_bool_spmv, csr_bool_step, csr_maxplus_spmv,  # noqa: F401
                   csr_maxplus_step, csr_minplus_spmv, csr_minplus_spmv_tiled,
                   csr_minplus_step, csr_minplus_tiled_step,
                   csr_plustimes_spmv, csr_plustimes_step,
                   csr_raw_minplus_tiled, csr_raw_step)


def plustimes_frontier_matmul(frontier: torch.Tensor, w: torch.Tensor
                              ) -> torch.Tensor:
    """(B, n) ⊗_+,× (n, n) -> (B, n): ``torch.matmul`` in full f32.

    Path counts must stay exact integers, and TF32 rounds the inputs to a
    10-bit mantissa (a count of 3,000 already needs 12 bits), so on the card
    this raises when PyTorch is set to let f32 products use TF32.  It never
    changes the setting itself."""
    if build.on_card("plustimes_frontier_matmul", frontier, w) and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "plustimes_frontier_matmul: f32 products may use TF32 "
            "(torch.backends.cuda.matmul.allow_tf32 or "
            "torch.set_float32_matmul_precision); path counts need full f32 "
            "— set the precision to 'highest'")
    return ref.plustimes_ref(frontier, w)


def minplus(a: torch.Tensor, b: torch.Tensor, *, bm=None, bn=None, bk=None
            ) -> torch.Tensor:
    """The full (m, k) ⊗_min,+ (k, n) product: K2.  ``bm``, ``bn`` and
    ``bk`` are the JAX kernel's block sizes, accepted so that one kwargs
    dict drives both packages; K2 keeps its own tile."""
    return minplus_matmul(a, b)


def boolmm(a: torch.Tensor, b: torch.Tensor, *, bm=None, bn=None, bk=None
           ) -> torch.Tensor:
    """The full (m, k) ⊗_bool (k, n) product: K1 (block sizes as
    :func:`minplus`)."""
    return bool_matmul(a, b)


def relax(d: torch.Tensor, a: torch.Tensor, delta_mask: torch.Tensor, **kw):
    """One fused min-plus relaxation step, ``(d_new, changed)``: K8."""
    return relax_step(d, a, delta_mask, **kw)


def _recorded(*tensors) -> bool:
    """Autograd records a call on these tensors (grad mode on, one of them
    requiring a gradient)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _Flash(torch.autograd.Function):
    """K9 forward with its log-sum-exp saved; K9-bwd backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None


class _Rglru(torch.autograd.Function):
    """K10 forward with ``a`` and the states saved; K10-bwd backward."""

    @staticmethod
    def forward(ctx, a, b):
        h = rglru_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        da, db = rglru_scan_bwd(a, h, dh)
        return da, db


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool = True, window: int | None = None,
          softcap: float | None = None, scale: float | None = None,
          bq=None, bk=None) -> torch.Tensor:
    """GQA attention in the JAX kernel layout (b, h, s, d): K9, and K9-bwd
    in its backward where autograd records the call (``bq``/``bk`` are the
    JAX kernel's block sizes, ignored)."""
    if _recorded(q, k, v):
        return _Flash.apply(q, k, v, causal, window, softcap, scale)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale)


def rglru(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """The RG-LRU recurrence ``h_t = a_t h_{t-1} + b_t``, (B, S, W): K10,
    and K10-bwd in its backward where autograd records the call (``kw``:
    :func:`rglru_scan`'s, forward only)."""
    if _recorded(a, b):
        return _Rglru.apply(a, b)
    return rglru_scan(a, b, **kw)


def bool_frontier(a: torch.Tensor, b: torch.Tensor, *, bm=None, bn=None,
                  bk=None) -> torch.Tensor:
    """The (B, n) ⊗_bool (n, n) frontier product: K1 (block sizes as
    :func:`minplus`)."""
    return bool_frontier_matmul(a, b)


def minplus_frontier(a: torch.Tensor, b: torch.Tensor, *, bm=None, bn=None,
                     bk=None) -> torch.Tensor:
    """The (B, n) ⊗_min,+ (n, n) frontier product: K2."""
    return minplus_frontier_matmul(a, b)


def maxplus_frontier(a: torch.Tensor, b: torch.Tensor, *, bm=None, bn=None,
                     bk=None) -> torch.Tensor:
    """The (B, n) ⊗_max,+ (n, n) frontier product: K2's max-plus
    instantiation."""
    return maxplus_frontier_matmul(a, b)


def plustimes_frontier(a: torch.Tensor, b: torch.Tensor, *, bm=None,
                       bn=None, bk=None) -> torch.Tensor:
    """The (B, n) ⊗_+,× (n, n) frontier product: a full-f32 matrix
    product (:func:`plustimes_frontier_matmul`)."""
    return plustimes_frontier_matmul(a, b)


def csr_bool(frontier, src, dst, val, *, chunk=None) -> torch.Tensor:
    """Segment-OR of ``frontier[:, src] & val`` by ``dst``, over a bare arc
    triple: K3 (``spmv.csr_raw_step``; ``chunk`` is the JAX kernel's and is
    ignored)."""
    return csr_raw_step("bool", frontier, src, dst, val)


def csr_minplus(frontier, src, dst, val, *, chunk=None, bn=None
                ) -> torch.Tensor:
    """Segment-min of ``frontier[:, src] + val`` by ``dst``: K4."""
    return csr_raw_step("minplus", frontier, src, dst, val)


def csr_maxplus(frontier, src, dst, val, *, chunk=None, bn=None
                ) -> torch.Tensor:
    """Segment-max of ``frontier[:, src] + val`` by ``dst``: K6."""
    return csr_raw_step("maxplus", frontier, src, dst, val)


def csr_plustimes(frontier, src, dst, val, *, chunk=None) -> torch.Tensor:
    """Segment-sum of ``frontier[:, src] * val`` by ``dst``: K5."""
    return csr_raw_step("plustimes", frontier, src, dst, val)


def csr_minplus_tiled(frontier, src, dst, val, plan_tile, plan_chunk,
                      plan_first, *, chunk: int, bn: int) -> torch.Tensor:
    """Segment-min over the (tile, chunk) worklist of a tile-skip plan
    built for these arcs with ``(chunk, bn)``: K7."""
    return csr_raw_minplus_tiled(frontier, src, dst, val, plan_tile,
                                 plan_chunk, plan_first, chunk, bn)


def semiring_matmul(name: str):
    """Kernel-backed ⊗ of the dense engine (semiring name): the all-pairs
    forms' full (n, n) products and the vector form's (1, n) row."""
    if name == "bool":
        return boolmm
    if name == "min_plus":
        return minplus
    if name == "max_plus":
        return maxplus_frontier_matmul
    if name == "plus_times":
        return plustimes_frontier_matmul
    raise KeyError(name)


def frontier_matmul(name: str):
    """Kernel-backed ⊗ of the dense fixpoints (semiring name): the batched
    (B, n) frontier product of the serving layer."""
    if name == "bool":
        return bool_frontier_matmul
    if name == "min_plus":
        return minplus_frontier_matmul
    if name == "max_plus":
        return maxplus_frontier_matmul
    if name == "plus_times":
        return plustimes_frontier_matmul
    raise KeyError(name)


def _csr_minplus_step(frontier: torch.Tensor, csr) -> torch.Tensor:
    """The min-plus step: K7 over the tile-skip plan when the CSR carries
    one (``build_csr(kernel_plan=)``, the autotuner's ``use_kernel``), else
    K4.  The other carriers' steps ignore a plan, as in the JAX package."""
    if csr.plan_cfg is not None:
        return csr_minplus_tiled_step(frontier, csr)
    return csr_minplus_step(frontier, csr)


def csr_frontier_step(kind: str):
    """Kernel-backed segment-semiring step for the sparse engine (``kind``
    is the CSR carrier: 'bool' | 'minplus' | 'maxplus' | 'plustimes')."""
    if kind == "bool":
        return csr_bool_step
    if kind == "minplus":
        return _csr_minplus_step
    if kind == "maxplus":
        return csr_maxplus_step
    if kind == "plustimes":
        return csr_plustimes_step
    raise KeyError(kind)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(build.LAUNCHES)


def reset_launch_counts() -> None:
    for k in build.LAUNCHES:
        build.LAUNCHES[k] = 0
