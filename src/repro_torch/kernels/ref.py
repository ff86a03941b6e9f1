"""Plain PyTorch versions of the CUDA kernels: the CPU path and the oracles
the kernels are held to on the card (exact equality; K9 within a stated
tolerance, its f32 sums being taken in another order)."""
from __future__ import annotations

import math

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


def relax_ref(d: torch.Tensor, a: torch.Tensor, delta_mask: torch.Tensor):
    """One fused semi-naive min-plus step: ``U = Δ-masked d ⊗_min,+ a``,
    ``d' = min(d, U)``, ``changed = any(d' < d)`` per row.  Returns
    ``(d', changed)``.  Row by row: each output row depends only on its own
    row of ``d`` and mask, so ``d`` may be a (r, n) block of rows."""
    d = d.to(torch.float32)
    dm = torch.where(delta_mask[:, None], d,
                     torch.tensor(float("inf"), device=d.device))
    merged = torch.minimum(d, minplus_ref(dm, a))
    return merged, (merged < d).any(1)


#: the masked-logit value of the attention kernels (not -inf: a row whose
#: keys are all masked softmaxes to a uniform row, as in the JAX package)
NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """q: (b, hq, sq, d); k/v: (b, hkv, sk, d) -> (b, hq, sq, d) in
    ``q.dtype``.  GQA by repeating each kv head ``hq // hkv`` times; f32
    scores, a logit softcap ``cap·tanh(s/cap)`` before the causal/window
    mask (``-1e30``, positions ``arange(sq)`` and ``arange(sk)``), softmax
    and the f32 value product, as the JAX ``ref.flash_attention_ref``."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = scale or (1.0 / math.sqrt(d))
    kx = k.repeat_interleave(rep, dim=1).to(torch.float32)
    vx = v.repeat_interleave(rep, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32) * scale, kx)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= (qp - kp) < window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx).to(q.dtype)


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W) -> h (B, S, W) f32, ``h_t = a_t·h_{t-1} + b_t`` from
    ``h_0 = 0``: the sequential recurrence in f32, one rounded product and
    one rounded sum a step, as the Pallas body computes it (the JAX
    package's own oracle is an associative scan, equal within rounding)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    out = torch.empty_like(a)
    h = torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        h = torch.add(torch.mul(a[:, t], h), b[:, t])
        out[:, t] = h
    return out


#: one CSR frontier step per carrier (spine + COO tail)
csr_bool_step_ref = csr_frontier_or
csr_minplus_step_ref = csr_frontier_min
csr_maxplus_step_ref = csr_frontier_max
csr_plustimes_step_ref = csr_frontier_sum


#: the ⊕-zero of each CSR carrier (a raw arc with this value is a sentinel)
CSR_ZERO = {"bool": False, "minplus": float("inf"),
            "maxplus": float("-inf"), "plustimes": 0.0}


def csr_raw_ref(kind: str, frontier: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """One frontier step over a bare arc triple, as the JAX ``ops.csr_*``
    entries compute it: ``out[b, v] = ⊕ over arcs e with dst[e] = v of
    frontier[b, src[e]] ⊗ val[e]``, from ⊕-zero (a scatter by ``dst``; the
    sum in ``index_add_``'s order, exact while the partial sums are integers
    below 2^24).  ``frontier`` is (B, n) or (n,)."""
    f = frontier[None, :] if frontier.ndim == 1 else frontier
    src, dst = src.long(), dst.long()
    g = f[:, src]
    if kind == "bool":
        hits = torch.zeros(f.shape, dtype=torch.int32, device=f.device)
        out = hits.index_add_(1, dst, (g & val).to(torch.int32)) > 0
    elif kind == "plustimes":
        out = torch.zeros_like(f).index_add_(1, dst, g * val)
    elif kind in ("minplus", "maxplus"):
        out = torch.full_like(f, CSR_ZERO[kind]).scatter_reduce_(
            1, dst.expand(f.shape[0], -1), g + val,
            "amin" if kind == "minplus" else "amax")
    else:
        raise KeyError(kind)
    return out[0] if frontier.ndim == 1 else out


#: worklist items expanded at a time by the tiled reference (bounds the
#: (items · chunk) position arrays it materializes)
TILED_REF_ITEMS = 1 << 18


def csr_raw_minplus_tiled_ref(frontier: torch.Tensor, src: torch.Tensor,
                              dst: torch.Tensor, val: torch.Tensor,
                              plan_tile: torch.Tensor,
                              plan_chunk: torch.Tensor, chunk: int,
                              bn: int) -> torch.Tensor:
    """The min-plus step over an arc triple's tile-skip plan, item by item
    as the TPU kernel walks it: each (tile, chunk) item's arcs whose
    destination lies in the tile contribute ``f[:, src] + val`` to a +inf
    output (``scatter_reduce_`` amin; pad items repeat an item, which min
    absorbs).  ``frontier`` is (B, n) or (n,)."""
    f = frontier[None, :] if frontier.ndim == 1 else frontier
    out = torch.full(f.shape, float("inf"), dtype=torch.float32,
                     device=f.device)
    lane = torch.arange(chunk, device=f.device)
    for i0 in range(0, plan_tile.shape[0], TILED_REF_ITEMS):
        tile = plan_tile[i0:i0 + TILED_REF_ITEMS].long()
        pos = (plan_chunk[i0:i0 + TILED_REF_ITEMS].long()[:, None] * chunk
               + lane).reshape(-1)
        d = dst[pos].long()
        keep = d // bn == tile.repeat_interleave(chunk)
        pos, d = pos[keep], d[keep]
        contrib = f[:, src[pos].long()] + val[pos]
        out.scatter_reduce_(1, d.expand(f.shape[0], -1), contrib, "amin")
    return out[0] if frontier.ndim == 1 else out


def csr_minplus_tiled_step_ref(frontier: torch.Tensor, csr) -> torch.Tensor:
    """One min-plus step over a CSR's tile-skip plan
    (:func:`csr_raw_minplus_tiled_ref` over the spine), then the COO tail
    folds in as in :func:`csr_minplus_step_ref`."""
    if csr.plan_cfg is None:
        raise ValueError("csr_minplus_tiled_step_ref: the CSR has no "
                         "tile-skip plan (build_csr(kernel_plan=...))")
    f = frontier[None, :] if frontier.ndim == 1 else frontier
    out = csr_raw_minplus_tiled_ref(f, csr.src_idx, csr.col_idx,
                                    csr.edge_val, csr.plan_tile,
                                    csr.plan_chunk, *csr.plan_cfg)
    out = torch.minimum(
        out, _ell_step_min(f, csr.tail_src, csr.tail_val, csr.tail_ell))
    return out[0] if frontier.ndim == 1 else out
