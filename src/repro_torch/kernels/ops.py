"""Dispatch for the kernel-backed carriers, and the launch counters.

Every entry returned here routes by device: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the CUDA kernel (or the
call raises).  The one exception is the dense plus-times product, which is
a plain f32 matrix product on both (the JAX package leaves it to XLA's
``jnp.matmul`` as well), held to full f32 on the card.
"""
from __future__ import annotations

import torch

from . import build, ref
from .boolmm import bool_frontier_matmul, bool_matmul
from .minplus import (maxplus_frontier_matmul, minplus_frontier_matmul,
                      minplus_matmul)
from .relax import relax_step
from .spmv import (csr_bool_step, csr_maxplus_step, csr_minplus_step,
                   csr_minplus_tiled_step, csr_plustimes_step)


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
