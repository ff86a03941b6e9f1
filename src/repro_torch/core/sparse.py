"""CSR-packed sparse frontier engine — O(|E|)-per-iteration fixpoints.

Port of ``repro.core.sparse`` for the idempotent carriers.  The packing
(``_pack_edges``, ``_ell_index``, ``_sliced_ell_index``, ``build_csr``) is a
numpy copy of the JAX package's, so the packed layout is identical array for
array; the arrays then land on the caller's device as a :class:`CSRMatrix`
of tensors with the same field names.

Layout (see the JAX module for the full story):

* ``row_ptr``/``col_idx``/``edge_val``/``src_idx`` — the CSR spine, arcs
  sorted by (src, dst), capacity padded to a power of two with ⊕-zero
  sentinel arcs (slot ``cap - 1`` is always a sentinel);
* ``ell_slices``/``ell_rank`` — the sliced-ELL segment map: per degree
  class a ``(rows_s, cap_s)`` table of each vertex's in-edge positions,
  sentinel-padded; ``ell_rank`` maps a vertex to its row in the
  slice-concatenated reduce output (dead vertices share the all-sentinel
  row 0);
* a COO tail (``tail_src``/``tail_dst``/``tail_val``/``tail_ell``) that
  ``build_csr`` leaves empty; appends that fill it wait for a later slice.

``csr_frontier_or``/``csr_frontier_min`` are the plain PyTorch steps (the
CPU path and the oracle the CUDA kernels in ``kernels.spmv`` are held to).
``fixpoint_csr`` defaults to ``kernels.ops.csr_frontier_step``: the CUDA
kernel on a CUDA frontier, the plain step on a CPU one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from .semiring import Semiring, carrier_for
from .seminaive import (GEN_DTYPE, DenseResult, _ne, quantize_ladder,
                        quantize_rows)

#: density |E|/n² below which the serving layer prefers CSR over the dense
#: matrix (the auto heuristic).
DEFAULT_SPARSE_THRESHOLD = 1 / 64

#: default sliced-ELL capacity ladder: floor 1, stride 1 — pure power-of-two
#: degree classes (caps 1, 2, 4, ...).  ``(f, 0)`` is single-width legacy.
DEFAULT_ELL_CFG = (1, 1)


def prefer_csr(nnz: int, n: int, threshold: float = DEFAULT_SPARSE_THRESHOLD) -> bool:
    """The density heuristic: CSR pays off when |E|/n² is small."""
    if n <= 0:
        return False
    return (nnz / float(n * n)) < threshold


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """A base relation packed for sparse frontier fixpoints (tensors)."""

    row_ptr: torch.Tensor  # (n_alloc + 1,) int32 — CSR spine over sources
    col_idx: torch.Tensor  # (cap,) int32 — destinations, source-sorted
    edge_val: torch.Tensor  # (cap,) carrier — True / weight; ⊕-zero sentinels
    src_idx: torch.Tensor  # (cap,) int32 — expanded row ids (packed COO)
    ell_slices: tuple  # per-degree-class (rows_s, cap_s) int32 tables
    ell_rank: torch.Tensor  # (n_alloc,) int32 — vertex -> reduce-output row
    nnz: torch.Tensor  # () int32 — live arcs in the CSR spine
    tail_src: torch.Tensor  # (tail_cap,) int32 — appended arcs (COO tail)
    tail_dst: torch.Tensor  # (tail_cap,) int32
    tail_val: torch.Tensor  # (tail_cap,) carrier
    tail_ell: torch.Tensor  # (n_alloc, tail_deg_cap) int32 — tail segment map
    tail_nnz: torch.Tensor  # () int32
    plan_tile: torch.Tensor | None  # tile-skip worklist: not built by the
    plan_chunk: torch.Tensor | None  # port (ROADMAP A.3); carried across
    plan_first: torch.Tensor | None  # from a JAX state unchanged
    n: int  # live domain size at build time
    n_alloc: int  # padded domain
    kind: str  # 'bool' | 'minplus' | 'maxplus' | 'plustimes'
    ell_cfg: tuple  # (floor, stride) capacity-ladder config
    plan_cfg: tuple | None  # (chunk, bn) of the tile-skip plan, or None

    @property
    def semiring(self) -> Semiring:
        return carrier_for(self.kind)

    @property
    def device(self) -> torch.device:
        return self.col_idx.device

    @property
    def capacity(self) -> int:
        return int(self.col_idx.shape[0])

    @property
    def deg_cap(self) -> int:
        """Widest slice capacity (the single-width ELL width when stride=0)."""
        return max(int(t.shape[1]) for t in self.ell_slices)

    @property
    def e_alloc(self) -> int:
        """Allocated segment-reduce slots (sliced spine + tail)."""
        spine = sum(int(t.shape[0]) * int(t.shape[1]) for t in self.ell_slices)
        return spine + int(self.tail_ell.numel())

    def density(self) -> float:
        if self.n <= 0:
            return 0.0
        return float(int(self.nnz) + int(self.tail_nnz)) / float(self.n * self.n)

    def padding_waste(self) -> dict:
        """Per-slice allocation report: how much of the sliced spine is pad."""
        sent = self.capacity - 1
        slices = []
        for t in self.ell_slices:
            live = int((t != sent).sum())
            slices.append({"rows": int(t.shape[0]), "cap": int(t.shape[1]),
                           "alloc": int(t.numel()), "live": live})
        alloc = sum(s["alloc"] for s in slices)
        nnz = int(self.nnz)
        return {"slices": slices, "e_alloc": alloc, "nnz": nnz,
                "waste": alloc / max(nnz, 1)}


def _pack_edges(edges: np.ndarray, kind: str):
    """Normalize an (m, 2|3) edge array into src/dst/val numpy columns."""
    edges = np.asarray(edges, np.int64)
    if edges.ndim != 2 or edges.shape[1] not in (2, 3):
        raise ValueError(f"edge list must be (m, 2|3), got {edges.shape}")
    if len(edges) and not carrier_for(kind).idempotent:
        edges = np.unique(edges, axis=0)
    src = edges[:, 0].astype(np.int32)
    dst = edges[:, 1].astype(np.int32)
    if kind == "bool":
        val = np.ones(len(edges), bool)
    else:
        if edges.shape[1] != 3:
            raise ValueError(f"{kind} CSR wants (src, dst, weight) rows")
        val = edges[:, 2].astype(np.float32)
    return src, dst, val


def _ell_index(dst: np.ndarray, m: int, n_alloc: int,
               sentinel_pos: int) -> np.ndarray:
    """Single-width segment map (the COO tail's layout): for every vertex,
    the packed positions of its in-edges, right-padded with ``sentinel_pos``
    to the bucketed max in-degree."""
    live = dst[:m]
    indeg = np.bincount(live, minlength=n_alloc) if m else \
        np.zeros(n_alloc, np.int64)
    k = quantize_rows(int(indeg.max()) if m else 1, minimum=1)
    ell = np.full((n_alloc, k), sentinel_pos, np.int32)
    if m:
        order = np.argsort(live, kind="stable")  # positions grouped by dst
        sorted_dst = live[order]
        starts = np.cumsum(indeg) - indeg
        rank = np.arange(m) - starts[sorted_dst]
        ell[sorted_dst, rank] = order
    return ell


def _sliced_ell_index(dst: np.ndarray, m: int, n_alloc: int,
                      sentinel_pos: int, ell_cfg: tuple):
    """The sliced-ELL segment map: ``(slices, rank)`` (see the JAX module:
    exact row counts, empty rungs dropped, shared all-sentinel row 0)."""
    floor, stride = ell_cfg
    live = dst[:m]
    indeg = np.bincount(live, minlength=n_alloc) if m else \
        np.zeros(n_alloc, np.int64)
    max_d = int(indeg.max()) if m else 0
    caps = np.asarray(quantize_ladder(floor, stride, max_d), np.int64)
    live_v = np.nonzero(indeg > 0)[0]
    slice_of = np.searchsorted(caps, indeg[live_v], side="left")
    rank = np.zeros(n_alloc, np.int32)  # dead vertices -> shared row 0
    tables = []
    if m:
        order = np.argsort(live, kind="stable")
        sorted_dst = live[order]
        starts = np.cumsum(indeg) - indeg
        edge_rank = np.arange(m) - starts[sorted_dst]
        edge_slice = np.searchsorted(caps, indeg[sorted_dst], side="left")
    row_of = np.zeros(n_alloc, np.int64)
    off = 0
    for s, cap in enumerate(caps):
        vs = live_v[slice_of == s]
        base = 1 if not tables else 0  # the shared sentinel row
        if not len(vs) and not base:
            continue  # empty rung: no table at all
        rows = len(vs) + base
        tbl = np.full((rows, int(cap)), sentinel_pos, np.int32)
        row_of[vs] = base + np.arange(len(vs))
        rank[vs] = off + base + np.arange(len(vs))
        if m:
            me = edge_slice == s
            tbl[row_of[sorted_dst[me]], edge_rank[me]] = order[me]
        tables.append(tbl)
        off += rows
    return tuple(tables), rank


def _to(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def build_csr(edges: np.ndarray, n_alloc: int, kind: str = "bool",
              tail_min: int = 8, ell_cfg: tuple = DEFAULT_ELL_CFG,
              device=None) -> CSRMatrix:
    """Pack an edge list into a :class:`CSRMatrix` over ``n_alloc`` vertices
    on ``device`` (``None``: the card).  The numpy packing is the JAX
    ``build_csr``'s, without the tile-skip ``kernel_plan``."""
    device = resolve_device(device)
    src, dst, val = _pack_edges(edges, kind)
    m = len(src)
    n = int(max(src.max(), dst.max())) + 1 if m else 0
    if n > n_alloc:
        raise ValueError(f"edges reference vertex {n - 1} >= n_alloc {n_alloc}")
    order = np.lexsort((dst, src))
    src, dst, val = src[order], dst[order], val[order]
    counts = np.bincount(src, minlength=n_alloc) if m else np.zeros(n_alloc, np.int64)
    row_ptr = np.zeros(n_alloc + 1, np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    cap = quantize_rows(m + 1)  # >= 1 sentinel slot for the ELL pads
    sr = carrier_for(kind)
    pad = cap - m
    slices, rank = _sliced_ell_index(dst, m, n_alloc, cap - 1, tuple(ell_cfg))
    src = np.concatenate([src, np.zeros(pad, np.int32)])
    dst = np.concatenate([dst, np.zeros(pad, np.int32)])
    val = np.concatenate([val, np.full(pad, sr.zero, val.dtype)])
    return CSRMatrix(
        row_ptr=_to(row_ptr, device), col_idx=_to(dst, device),
        edge_val=_to(val, device), src_idx=_to(src, device),
        ell_slices=tuple(_to(t, device) for t in slices),
        ell_rank=_to(rank, device),
        nnz=torch.tensor(m, dtype=torch.int32, device=device),
        tail_src=torch.zeros(tail_min, dtype=torch.int32, device=device),
        tail_dst=torch.zeros(tail_min, dtype=torch.int32, device=device),
        tail_val=torch.full((tail_min,), sr.zero, dtype=sr.dtype,
                            device=device),
        tail_ell=torch.full((n_alloc, 1), tail_min - 1, dtype=torch.int32,
                            device=device),
        tail_nnz=torch.tensor(0, dtype=torch.int32, device=device),
        plan_tile=None, plan_chunk=None, plan_first=None,
        n=n, n_alloc=n_alloc, kind=kind, ell_cfg=tuple(ell_cfg),
        plan_cfg=None)


# ---------------------------------------------------------------------------
# Plain segment-semiring steps (the CPU path; CUDA kernels in kernels/spmv)
# ---------------------------------------------------------------------------
# Scatter-free, as in the JAX oracle: gather every arc's source value, reduce
# each slice's in-edge positions at the slice's own capacity, concatenate,
# and gather back to vertex order through ``ell_rank``.


def _ell_step_or(f, src, val, ell):
    contrib = f[:, src.long()] & val  # (B, cap): frontier value at each arc
    return contrib[:, ell.long()].any(dim=2)  # (B, n, deg_cap) ⊕-reduce


def _ell_step_min(f, src, val, ell):
    contrib = f[:, src.long()] + val  # +inf sentinels never win the min
    return contrib[:, ell.long()].amin(dim=2)


def _sliced_step_or(f, src, val, slices, rank):
    contrib = f[:, src.long()] & val
    parts = [contrib[:, t.long()].any(dim=2) for t in slices]
    return torch.cat(parts, dim=1)[:, rank.long()]


def _sliced_step_min(f, src, val, slices, rank):
    contrib = f[:, src.long()] + val
    parts = [contrib[:, t.long()].amin(dim=2) for t in slices]
    return torch.cat(parts, dim=1)[:, rank.long()]


def csr_frontier_or(frontier: torch.Tensor, csr: CSRMatrix) -> torch.Tensor:
    """One plain boolean frontier step over the packed arcs: O(B·|E|).

    ``frontier``: (B, n_alloc) bool (or (n_alloc,) — promoted).  Sentinel
    arcs carry ``val=False`` and never fire; the COO tail contributes a
    second (single-width) segment pass."""
    f = frontier[None, :] if frontier.ndim == 1 else frontier
    out = _sliced_step_or(f, csr.src_idx, csr.edge_val, csr.ell_slices,
                          csr.ell_rank)
    out = out | _ell_step_or(f, csr.tail_src, csr.tail_val, csr.tail_ell)
    return out[0] if frontier.ndim == 1 else out


def csr_frontier_min(frontier: torch.Tensor, csr: CSRMatrix) -> torch.Tensor:
    """One plain min-plus frontier step over the packed arcs (sentinels are
    +inf)."""
    f = frontier[None, :] if frontier.ndim == 1 else frontier
    out = _sliced_step_min(f, csr.src_idx, csr.edge_val, csr.ell_slices,
                           csr.ell_rank)
    out = torch.minimum(
        out, _ell_step_min(f, csr.tail_src, csr.tail_val, csr.tail_ell))
    return out[0] if frontier.ndim == 1 else out


def rows_from_sources(csr: CSRMatrix, srcs, spmv: Callable | None = None
                      ) -> torch.Tensor:
    """The adjacency rows ``A[srcs]`` without materializing A: seed a ⊗-one
    one-hot frontier and take one segment step (through the kernel on CUDA,
    the plain step on the CPU)."""
    if spmv is None:
        from ..kernels import ops
        spmv = ops.csr_frontier_step(csr.kind)
    srcs = np.asarray(srcs, np.int64)
    if len(srcs) and (srcs.min() < 0 or srcs.max() >= csr.n_alloc):
        raise ValueError(f"sources must lie in [0, n_alloc={csr.n_alloc})")
    idx = torch.from_numpy(srcs).to(csr.device)
    b = idx.shape[0]
    sr = csr.semiring
    onehot = torch.full((b, csr.n_alloc), sr.zero, dtype=sr.dtype,
                        device=csr.device)
    onehot[torch.arange(b, device=csr.device), idx] = sr.one
    return spmv(onehot, csr)


# ---------------------------------------------------------------------------
# Semi-naive frontier fixpoints over CSR (twin of fixpoint_dense form=vector)
# ---------------------------------------------------------------------------


def fixpoint_csr(csr: CSRMatrix, init: torch.Tensor,
                 spmv: Callable | None = None,
                 max_iters: int | None = None) -> DenseResult:
    """Sparse frontier fixpoint: ``d <- d ⊕ step(Δ-masked d)`` to closure.

    Twin of ``fixpoint_dense(form="vector")`` over the packed arcs, as a host
    loop reproducing the JAX while_loop's ``iterations`` and ``generated``.
    """
    sr = csr.semiring
    if not sr.idempotent:
        raise NotImplementedError(
            "the accumulate-form CSR fixpoint (plus-times) is not ported yet "
            "(ROADMAP A.1)")
    if spmv is None:
        from ..kernels import ops
        spmv = ops.csr_frontier_step(csr.kind)
    n = init.shape[-1]
    if max_iters is None:
        max_iters = 4 * n + 8
    zero = torch.tensor(sr.zero, dtype=init.dtype, device=init.device)
    D = init
    mask = torch.ones(init.shape[:-1] if init.ndim > 1 else init.shape,
                      dtype=torch.bool, device=init.device)
    it = 0
    gen = torch.zeros((), dtype=GEN_DTYPE, device=init.device)
    while it < max_iters and bool(mask.any()):
        rmask = mask if D.ndim == 1 else mask[:, None]
        dm = torch.where(rmask, D, zero)
        upd = spmv(dm, csr)
        Dn = sr.add(D, upd)
        changed = _ne(sr, Dn, D)
        gen = gen + (upd != zero).sum(dtype=GEN_DTYPE)
        mask = changed.any(dim=-1) if D.ndim > 1 else changed
        D = Dn
        it += 1
    return DenseResult(D, it, int(gen))


def fixpoint_csr_cached(csr: CSRMatrix, init: torch.Tensor,
                        spmv: Callable | None = None,
                        max_iters: int | None = None) -> DenseResult:
    """:func:`fixpoint_csr` with the JAX cached twin's signature (no jit
    here; ``max_iters`` resolves to ``4n + 8`` as there)."""
    if max_iters is None:
        max_iters = 4 * init.shape[-1] + 8
    return fixpoint_csr(csr, init, spmv=spmv, max_iters=max_iters)


# (de)serialization --------------------------------------------------------

_STATE_FIELDS = ("row_ptr", "col_idx", "edge_val", "src_idx", "ell_rank",
                 "nnz", "tail_src", "tail_dst", "tail_val", "tail_ell",
                 "tail_nnz")


def csr_to_state(csr: CSRMatrix) -> tuple[dict, dict]:
    """Flatten a :class:`CSRMatrix` to ``(arrays, meta)``: the same names and
    numpy arrays as ``repro.core.sparse.csr_to_state``."""
    arrays: dict[str, np.ndarray] = {}
    for name in _STATE_FIELDS:
        arrays[name] = getattr(csr, name).cpu().numpy()
    for i, t in enumerate(csr.ell_slices):
        arrays[f"ell_slice_{i}"] = t.cpu().numpy()
    if csr.plan_cfg is not None:
        for name in ("plan_tile", "plan_chunk", "plan_first"):
            arrays[name] = getattr(csr, name).cpu().numpy()
    meta = {"n": csr.n, "n_alloc": csr.n_alloc, "kind": csr.kind,
            "ell_cfg": list(csr.ell_cfg),
            "plan_cfg": list(csr.plan_cfg) if csr.plan_cfg else None,
            "n_slices": len(csr.ell_slices)}
    return arrays, meta


def csr_from_state(arrays: dict, meta: dict, device=None) -> CSRMatrix:
    """Inverse of :func:`csr_to_state`; accepts exactly what the JAX
    package's ``csr_to_state`` returns.  Arrays land on ``device``."""
    device = resolve_device(device)
    # copies: the caller's arrays may be read-only views (a JAX state)
    t = {k: _to(np.array(v), device) for k, v in arrays.items()
         if not k.startswith("ell_slice_")}
    slices = tuple(_to(np.array(arrays[f"ell_slice_{i}"]), device)
                   for i in range(int(meta["n_slices"])))
    plan_cfg = tuple(meta["plan_cfg"]) if meta.get("plan_cfg") else None
    return CSRMatrix(
        row_ptr=t["row_ptr"], col_idx=t["col_idx"], edge_val=t["edge_val"],
        src_idx=t["src_idx"], ell_slices=slices, ell_rank=t["ell_rank"],
        nnz=t["nnz"], tail_src=t["tail_src"], tail_dst=t["tail_dst"],
        tail_val=t["tail_val"], tail_ell=t["tail_ell"],
        tail_nnz=t["tail_nnz"],
        plan_tile=t.get("plan_tile"), plan_chunk=t.get("plan_chunk"),
        plan_first=t.get("plan_first"),
        n=int(meta["n"]), n_alloc=int(meta["n_alloc"]),
        kind=str(meta["kind"]), ell_cfg=tuple(meta["ell_cfg"]),
        plan_cfg=plan_cfg)
