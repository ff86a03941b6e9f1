"""Plain PyTorch versions of the CUDA kernels: the CPU path and the oracles
the kernels are held to on the card (exact equality)."""
from __future__ import annotations

import torch

from ..core.semiring import BOOL, MIN_PLUS
from ..core.sparse import (_ell_step_min, csr_frontier_max, csr_frontier_min,
                           csr_frontier_or, csr_frontier_sum)


def boolmm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) bool ⊗_bool (k, n) bool -> (m, n) bool, as an f32 product
    with a ``> 0`` epilogue (exact: 0/1 sums stay below 2^24)."""
    return BOOL.matmul(a, b)


def minplus_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) ⊗_min,+ (k, n) -> (m, n) in f32; +inf means "no fact".  K is
    streamed in chunks so the (m, k, n) broadcast never materializes."""
    return MIN_PLUS.matmul(a.to(torch.float32), b.to(torch.float32))


def maxplus_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) ⊗_max,+ (k, n) -> (m, n) in f32; -inf means "no fact".  The
    JAX package's route: min-plus through negation."""
    return -minplus_ref(-a, -b)


def plustimes_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) ⊗_+,× (k, n) -> (m, n): the f32 matrix product."""
    return a @ b


#: one CSR frontier step per carrier (spine + COO tail)
csr_bool_step_ref = csr_frontier_or
csr_minplus_step_ref = csr_frontier_min
csr_maxplus_step_ref = csr_frontier_max
csr_plustimes_step_ref = csr_frontier_sum


#: worklist items expanded at a time by the tiled reference (bounds the
#: (items · chunk) position arrays it materializes)
TILED_REF_ITEMS = 1 << 18


def csr_minplus_tiled_step_ref(frontier: torch.Tensor, csr) -> torch.Tensor:
    """One min-plus step over a CSR's tile-skip plan, item by item as the
    TPU kernel walks it: each (tile, chunk) item's arcs whose destination
    lies in the tile contribute ``f[:, src] + val`` to a +inf output
    (``scatter_reduce_`` amin; pad items repeat an item, which min absorbs),
    then the COO tail folds in as in :func:`csr_minplus_step_ref`."""
    if csr.plan_cfg is None:
        raise ValueError("csr_minplus_tiled_step_ref: the CSR has no "
                         "tile-skip plan (build_csr(kernel_plan=...))")
    f = frontier[None, :] if frontier.ndim == 1 else frontier
    chunk, bn = csr.plan_cfg
    out = torch.full(f.shape, float("inf"), dtype=torch.float32,
                     device=f.device)
    lane = torch.arange(chunk, device=f.device)
    for i0 in range(0, csr.plan_tile.shape[0], TILED_REF_ITEMS):
        tile = csr.plan_tile[i0:i0 + TILED_REF_ITEMS].long()
        pos = (csr.plan_chunk[i0:i0 + TILED_REF_ITEMS].long()[:, None] * chunk
               + lane).reshape(-1)
        dst = csr.col_idx[pos].long()
        keep = dst // bn == tile.repeat_interleave(chunk)
        pos, dst = pos[keep], dst[keep]
        contrib = f[:, csr.src_idx[pos].long()] + csr.edge_val[pos]
        out.scatter_reduce_(1, dst.expand(f.shape[0], -1), contrib, "amin")
    out = torch.minimum(
        out, _ell_step_min(f, csr.tail_src, csr.tail_val, csr.tail_ell))
    return out[0] if frontier.ndim == 1 else out
