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


def _wide(dtype) -> torch.dtype:
    """The plain versions' working type: f32, or f64 for f64 inputs (the
    CPU gradient checks); the kernels take f32 and bf16."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _logits(q, k, causal, window, softcap, scale):
    """The masked logits of :func:`flash_attention_ref` (kv heads repeated)
    and the softcap's ``tanh`` (None without one).  The mask is an additive
    ``-1e30`` bias, as the JAX model's ``attention_reference`` adds it: the
    forward equals a ``where`` (in f32, ``s - 1e30`` rounds to ``-1e30``),
    and the gradient reaches the logits of a row with no valid key, which
    softmaxes to the uniform row."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    wt = _wide(q.dtype)
    scale = scale or (1.0 / math.sqrt(d))
    kx = k.repeat_interleave(hq // hkv, dim=1).to(wt)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(wt) * scale, kx)
    t = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= (qp - kp) < window
    return s + torch.where(ok, 0.0, NEG_INF).to(wt), t


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None, return_lse: bool = False):
    """q: (b, hq, sq, d); k/v: (b, hkv, sk, d) -> (b, hq, sq, d) in
    ``q.dtype``.  GQA by repeating each kv head ``hq // hkv`` times; f32
    scores, a logit softcap ``cap·tanh(s/cap)`` before the causal/window
    mask (``-1e30``, positions ``arange(sq)`` and ``arange(sk)``), softmax
    and the f32 value product, as the JAX ``ref.flash_attention_ref``.

    ``return_lse`` also returns each row's log-sum-exp of its masked
    logits, (b, hq, sq) f32: what the backward recomputes P from (a row
    with no valid key has ``-1e30``)."""
    x, _ = _logits(q, k, causal, window, softcap, scale)
    rep = q.shape[1] // k.shape[1]
    vx = v.repeat_interleave(rep, dim=1).to(x.dtype)
    p = torch.softmax(x, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vx).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(x, dim=-1)
    return o


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int | None = None,
                            softcap: float | None = None,
                            scale: float | None = None,
                            operand_dtype: torch.dtype | None = None):
    """The gradient of :func:`flash_attention_ref` (the plain K9-bwd):
    ``(dq, dk, dv)`` in the inputs' dtypes from the forward's output ``o``
    and log-sum-exp ``lse`` and the output's gradient ``do``.  P is
    recomputed from q·k and ``lse`` (a row with no valid key is uniform,
    ``1/sk``); ``D = rowsum(dO ⊙ O)``; ``dV = Pᵀ dO``, ``dP = dO Vᵀ``,
    ``dS = P ⊙ (dP − D)``, times ``1 − (s/cap)²`` under a softcap;
    ``dQ = dS K·scale``, ``dK = dSᵀ Q·scale``; dK and dV summed over the
    query heads of each kv head.  Every sum in f32 (f64 for f64 inputs).

    ``operand_dtype`` (a measurement aid; None on every path) rounds P and
    dS to that type once before their products, as a kernel that feeds each
    to the tensor cores as a single bf16 operand would."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = hq // hkv
    x, t = _logits(q, k, causal, window, softcap, scale)
    wt = x.dtype
    scale = scale or (1.0 / math.sqrt(d))
    lse = lse.to(wt)[..., None]
    p = torch.where(lse <= NEG_INF / 2, 1.0 / sk, torch.exp(x - lse))
    dof = do.to(wt)
    big_d = (dof * o.to(wt)).sum(-1, keepdim=True)
    vx = v.repeat_interleave(rep, dim=1).to(wt)
    kx = k.repeat_interleave(rep, dim=1).to(wt)

    def operand(x):
        return x if operand_dtype is None else x.to(operand_dtype).to(wt)

    dv = torch.einsum("bhqk,bhqd->bhkd", operand(p), dof)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vx) - big_d)
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = operand(ds)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kx) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(wt) * scale)

    def heads(x):  # (b, hq, sk, d) -> (b, hkv, sk, d), summed over rep
        return x.reshape(b, hkv, rep, sk, d).sum(2)

    return dq.to(q.dtype), heads(dk).to(k.dtype), heads(dv).to(v.dtype)


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W) -> h (B, S, W) f32, ``h_t = a_t·h_{t-1} + b_t`` from
    ``h_0 = 0``: the sequential recurrence in f32, one rounded product and
    one rounded sum a step, as the Pallas body computes it (the JAX
    package's own oracle is an associative scan, equal within rounding).
    f64 inputs run in f64."""
    wt = _wide(a.dtype)
    a = a.to(wt)
    b = b.to(wt)
    out = torch.empty_like(a)
    h = torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        h = torch.add(torch.mul(a[:, t], h), b[:, t])
        out[:, t] = h
    return out


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    """The gradient of :func:`rglru_scan_ref` (the plain K10-bwd): from the
    decays ``a``, the forward's states ``h`` and their gradient ``dh``,
    all (B, S, W), the reverse walk ``g_t = dh_t + a_{t+1}·g_{t+1}`` (from
    ``g_S = 0``, ``a_S = 0``) in f32, one rounded product and one rounded
    sum a step; returns ``(da, db)`` with ``db_t = g_t`` and ``da_t =
    g_t·h_{t-1}`` (``h_{-1} = 0``).  f64 inputs run in f64."""
    wt = _wide(a.dtype)
    a, h, dh = a.to(wt), h.to(wt), dh.to(wt)
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    zero = torch.zeros_like(a[:, 0])
    g, a_next = zero, zero
    for t in reversed(range(a.shape[1])):
        g = torch.add(dh[:, t], torch.mul(a_next, g))
        db[:, t] = g
        da[:, t] = torch.mul(g, h[:, t - 1] if t else zero)
        a_next = a[:, t]
    return da, db


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
