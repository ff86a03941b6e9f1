"""CSR-packed sparse frontier engine — O(|E|)-per-iteration fixpoints.

Port of ``repro.core.sparse``.  The packing (``_pack_edges``,
``_ell_index``, ``_sliced_ell_index``, ``_tile_plan``, ``build_csr``,
``csr_append``) is a numpy copy of the JAX package's, so the packed layout
is identical array for array; the arrays then land on the caller's device
as a :class:`CSRMatrix` of tensors with the same field names.

Layout (see the JAX module for the full story):

* ``row_ptr``/``col_idx``/``edge_val``/``src_idx`` — the CSR spine, arcs
  sorted by (src, dst), capacity padded to a power of two with ⊕-zero
  sentinel arcs (slot ``cap - 1`` is always a sentinel);
* ``ell_slices``/``ell_rank`` — the sliced-ELL segment map: per degree
  class a ``(rows_s, cap_s)`` table of each vertex's in-edge positions,
  sentinel-padded; ``ell_rank`` maps a vertex to its row in the
  slice-concatenated reduce output (dead vertices share the all-sentinel
  row 0);
* an optional tile-skip plan (``plan_tile``/``plan_chunk``/``plan_first``
  + ``plan_cfg``, from ``build_csr(kernel_plan=)``): the worklist of
  (column tile, arc chunk) pairs with a destination hit, the JAX arrays
  exactly, plus what the Hopper kernel K7 reads instead
  (:func:`_tile_order`): the plan's arcs once each, in destination order,
  and its work units over them (``tile_src``/``tile_dst``/``tile_val``,
  ``tile_units``);
* ``ell_src``/``ell_val`` and the work list ``ell_items``/
  ``ell_row_piece`` (:func:`_ell_order`): the slices' slots in order with
  each slot's source and value, which K3-K6 read instead of the
  positions;
* a CSR carries the one derived view its step reads (a planned min-plus
  CSR K7's, every other K3-K6's), built on the card wherever the spine is
  (``build_csr``, the fold, ``csr_from_state``, ``spmv.raw_csr``/
  ``raw_tiled_csr``) and never part of the state;
* a COO tail (``tail_src``/``tail_dst``/``tail_val``/``tail_ell``) that
  ``csr_append`` fills with appended arcs and folds into the spine once it
  outgrows ``rebuild_frac`` of it (the fold carries ``ell_cfg`` and
  ``plan_cfg``).

``csr_frontier_or``/``_min``/``_max``/``_sum`` are the plain PyTorch steps
(the CPU path and the oracle the CUDA kernels in ``kernels.spmv`` are held
to).
``fixpoint_csr`` defaults to ``kernels.ops.csr_frontier_step``: the CUDA
kernel on a CUDA frontier, the plain step on a CPU one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from .query import new_rows, sorted_unique, unique_rows
from .semiring import Semiring, carrier_for
from .seminaive import (GEN_DTYPE, DenseResult, _ne, additive_max_iters,
                        check_additive_converged, note_trace, quantize_ladder,
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
    plan_tile: torch.Tensor | None  # (L,) int32 — tile-skip worklist: the
    plan_chunk: torch.Tensor | None  # items' column tile, arc chunk and
    plan_first: torch.Tensor | None  # first-visit flag (JAX's arrays)
    n: int  # live domain size at build time
    n_alloc: int  # padded domain
    kind: str  # 'bool' | 'minplus' | 'maxplus' | 'plustimes'
    ell_cfg: tuple  # (floor, stride) capacity-ladder config
    plan_cfg: tuple | None  # (chunk, bn) of the tile-skip plan, or None
    # K3-K6's view of the slices (:func:`_ell_order`), every CSR but a
    # planned min-plus one; derived on the card, never part of the state
    ell_src: torch.Tensor | None = None  # (E,) int32 — slot sources, -1 pad
    ell_val: torch.Tensor | None = None  # (E,) f32 — slot values (K4-K6)
    ell_items: torch.Tensor | None = None  # (I, 4) int32 — warp items
    ell_row_piece: torch.Tensor | None = None  # (rows + 1,) int32
    # K7's view of the plan (:func:`_tile_order`), planned min-plus CSRs
    # only
    tile_src: torch.Tensor | None = None  # (A,) int32 — planned arcs by dst
    tile_dst: torch.Tensor | None = None  # (A,) int32
    tile_val: torch.Tensor | None = None  # (A,) f32
    tile_units: torch.Tensor | None = None  # (U, 4) int32 — work units

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
    def tail_capacity(self) -> int:
        return int(self.tail_src.shape[0])

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

    def edges_numpy(self) -> np.ndarray:
        """The live arcs back as an (m, 2|3) int64 edge list (spine + tail)."""
        m, t = int(self.nnz), int(self.tail_nnz)

        def live(spine, tail):
            return np.concatenate([spine[:m].cpu().numpy(),
                                   tail[:t].cpu().numpy()]).astype(np.int64)

        cols = [live(self.src_idx, self.tail_src),
                live(self.col_idx, self.tail_dst)]
        if self.kind != "bool":
            cols.append(live(self.edge_val, self.tail_val))
        return np.stack(cols, axis=1)


def _pack_edges(edges: np.ndarray, kind: str):
    """Normalize an (m, 2|3) edge array into src/dst/val numpy columns."""
    edges = np.asarray(edges, np.int64)
    if edges.ndim != 2 or edges.shape[1] not in (2, 3):
        raise ValueError(f"edge list must be (m, 2|3), got {edges.shape}")
    if len(edges) and not carrier_for(kind).idempotent:
        edges = unique_rows(edges)
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


def padded_width(n: int, bn: int = 1) -> int:
    """The frontier width the JAX tile-skip kernel sees: ``n`` rounded up to
    ``max(128, bn)`` (``bn`` is a power of two).  Plans cover this width;
    the port's frontier stays ``n`` wide and K7 masks the rest."""
    w = max(128, bn)
    return ((max(n, 1) + w - 1) // w) * w


def _pow2_floor(x: int) -> int:
    return 1 << (max(int(x), 1).bit_length() - 1)


def _tile_plan(dst: np.ndarray, m: int, cap: int, n_alloc: int,
               chunk: int, bn: int):
    """The tile-skip worklist, array for array the JAX ``_tile_plan``'s:
    the (column tile, arc chunk) pairs where a live arc's destination lands
    in the tile, sorted by (tile, chunk), each tile's first item flagged;
    a tile with no hit keeps one dummy (tile, 0) item; the list pads to a
    :func:`quantize_rows` bucket by repeating the last item (flag 0).

    Built from the sorted, deduplicated int64 keys ``tile * nchunks +
    chunk`` of the m live arcs, with no dense (tiles x chunks) matrix and
    no loop over items."""
    nt, nchunks = padded_width(n_alloc, bn) // bn, cap // chunk
    pos = np.arange(m, dtype=np.int64)
    key = sorted_unique((dst[:m].astype(np.int64) // bn) * nchunks
                        + pos // chunk)
    hit = np.zeros(nt, bool)
    hit[key // nchunks] = True
    empty = np.nonzero(~hit)[0].astype(np.int64) * nchunks
    key = np.insert(key, np.searchsorted(key, empty), empty)
    tiles = (key // nchunks).astype(np.int32)
    chunks = (key % nchunks).astype(np.int32)
    first = np.ones(len(key), np.int32)
    first[1:] = tiles[1:] != tiles[:-1]
    pad = quantize_rows(len(key), minimum=8) - len(key)
    return (np.concatenate([tiles, np.full(pad, tiles[-1], np.int32)]),
            np.concatenate([chunks, np.full(pad, chunks[-1], np.int32)]),
            np.concatenate([first, np.zeros(pad, np.int32)]))


#: slots per piece of a wide slice row: K3-K6 cut rows of capacity
#: above 16 into pieces of at most this many slots, one warp each, so a
#: hub's row spreads over many SMs
ELL_SEG = 256


def _ell_order(kind: str, src_idx: torch.Tensor, edge_val: torch.Tensor,
               slices: tuple) -> dict:
    """K3's to K6's view of the sliced-ELL map, built with torch indexing
    on the map's device (a port-only derivation, never part of the
    state):

    * ``ell_src`` (E,) int32: the slices' slots laid end to end (slice,
      row, slot), each the source ``src_idx[p]`` of its position p, -1
      where ``edge_val[p]`` is the ⊕-zero (a sentinel);
    * ``ell_val`` (E,) f32, the weighted carriers: ``edge_val[p]`` (the
      ⊕-zero, +inf, 0 or -inf, at a sentinel);
    * ``ell_items`` (I, 4) int32, one warp item each: ``(first slot, first
      piece, first row, pieces | length << 6)``.  A row of capacity <= 16
      (a power of two) is one piece, and ``32 // cap`` of them share an
      item; a wider row is cut into pieces of :data:`ELL_SEG` slots that
      end at its last live slot (one empty piece if it has none), one item
      each;
    * ``ell_row_piece`` (rows + 1,) int32: row r's pieces are
      ``ell_row_piece[r]:ell_row_piece[r + 1]``, rows numbered as
      ``ell_rank`` numbers them."""
    dev = src_idx.device
    zero = carrier_for(kind).zero
    srcs, vals, items, counts = [], [], [], []
    slot = row = piece = 0
    for t in slices:
        R, C = (int(d) for d in t.shape)
        pos = t.reshape(-1).long()
        v = edge_val[pos]
        live = v if kind == "bool" else v != zero
        srcs.append(torch.where(live, src_idx[pos], -1))
        vals.append(v)
        if C <= 16 and C & (C - 1) == 0:  # 32 // C rows share one load
            G = 32 // C
            g = torch.arange(-(-R // G), device=dev)
            k = torch.ones(R, dtype=torch.int64, device=dev)
            first = g * G
            it = (slot + first * C, piece + first, row + first,
                  torch.clamp(R - first, max=G) | (C << 6))
        else:
            last = (live.view(R, C) * torch.arange(1, C + 1, device=dev)
                    ).amax(1)  # last live slot + 1, 0 for none
            k = torch.clamp(-(-last // ELL_SEG), min=1)
            r = torch.repeat_interleave(torch.arange(R, device=dev), k)
            j = torch.arange(int(k.sum()), device=dev) - torch.repeat_interleave(
                torch.cumsum(k, 0) - k, k)
            length = torch.clamp(last[r] - j * ELL_SEG, 0, ELL_SEG)
            it = (slot + r * C + j * ELL_SEG, piece + torch.arange(
                len(r), device=dev), row + r, 1 | (length << 6))
        items.append(torch.stack(it, 1))
        counts.append(k)
        slot, row, piece = slot + R * C, row + R, piece + int(k.sum())
    if slot >= 2 ** 31:
        raise ValueError(f"{slot} ELL slots: K3-K6 index them with int32")
    k = torch.cat(counts)
    return {"ell_src": torch.cat(srcs).int(),
            "ell_val": None if kind == "bool" else torch.cat(vals),
            "ell_items": torch.cat(items).int().contiguous(),
            "ell_row_piece": torch.cat(
                [k.new_zeros(1), torch.cumsum(k, 0)]).int()}


def _with_views(csr: "CSRMatrix") -> "CSRMatrix":
    """``csr`` with the one derived view its step reads, built from its
    spine: the :func:`_tile_order` fields for a min-plus CSR with a plan
    (``kernels.ops`` steps it with K7 only), the :func:`_ell_order` fields
    otherwise."""
    if csr.kind == "minplus" and csr.plan_cfg is not None:
        return _with_tile_order(csr)
    return dataclasses.replace(csr, **_ell_order(
        csr.kind, csr.src_idx, csr.edge_val, csr.ell_slices))


#: planned arcs per K7 work unit: a column tile with more is cut into
#: units of at most this many, one CTA each, so a hub's tile (a power-law
#: graph's first tile of 128 columns holds about 1.8M of its 16M arcs)
#: spreads over many SMs.  Of 1,024, 2,048, 4,096 and 8,192, the last two
#: gave the fastest steps on an H100 at both the tuned CSR SPATH seed
#: frontier and an all-finite one, 8,192 up to 3% faster than 4,096 and
#: never 0.2% slower (scripts/k7_ab.py --units; the times are in PERF.md)
TILE_UNIT = 8192
#: ``tile_units`` flag bits: the tile's first unit (it folds the COO tail)
#: and a unit that covers its whole tile (it stores its block)
UNIT_FIRST, UNIT_WHOLE = 1, 2


def _tile_order(src_idx: torch.Tensor, col_idx: torch.Tensor,
                edge_val: torch.Tensor, plan_tile: torch.Tensor,
                plan_chunk: torch.Tensor, plan_cfg: tuple, n_alloc: int,
                unit: int = TILE_UNIT) -> dict:
    """K7's view of a min-plus spine and its tile-skip plan, built with
    torch on the plan's device (a port-only derivation, never part of the
    state):

    * the planned arcs: the live positions p (``edge_val[p]`` finite)
      whose key ``(col_idx[p] // bn, p // chunk)`` is one of the plan's
      (tile, chunk) items (a ``searchsorted`` over the items' sorted keys;
      pad items repeat one), which is exactly the set of arcs the TPU
      kernel visits, stable-sorted by destination: ``tile_src``,
      ``tile_dst`` (int32) and ``tile_val`` (f32), 12 bytes an arc;
    * ``tile_units`` (U, 4) int32, one CTA each: ``(tile, first arc, end
      arc, flags)``.  Every column tile of ``bn`` below ``n_alloc`` has at
      least one unit (an empty tile still folds the COO tail and stores
      its +inf block); a tile of c arcs is cut into ``ceil(c / unit)``
      units of near-equal size, in order.  Flags: :data:`UNIT_FIRST` on a
      tile's first unit, :data:`UNIT_WHOLE` where one unit covers it."""
    chunk, bn = plan_cfg
    dev = col_idx.device
    nchunks = -(-int(col_idx.shape[0]) // chunk)
    items = torch.unique(plan_tile.long() * nchunks + plan_chunk.long())
    p = torch.nonzero(edge_val != float("inf")).squeeze(1)
    key = (col_idx[p].long() // bn) * nchunks + p // chunk
    if len(items):
        p = p[items[torch.searchsorted(items, key).clamp(
            max=len(items) - 1)] == key]
    else:
        p = p[:0]
    dst, order = torch.sort(col_idx[p], stable=True)
    p = p[order]
    ntiles = -(-n_alloc // bn)
    count = torch.bincount(dst.long() // bn, minlength=ntiles)
    k = torch.clamp(-(-count // unit), min=1)
    tile = torch.repeat_interleave(torch.arange(ntiles, device=dev), k)
    j = torch.arange(int(k.sum()), device=dev) - torch.repeat_interleave(
        torch.cumsum(k, 0) - k, k)
    c, kt = count[tile], k[tile]
    start = (torch.cumsum(count, 0) - count)[tile]
    flags = (j == 0).long() * UNIT_FIRST + (kt == 1).long() * UNIT_WHOLE
    units = torch.stack([tile, start + c * j // kt, start + c * (j + 1) // kt,
                         flags], 1)
    return {"tile_src": src_idx[p].int(), "tile_dst": dst.int(),
            "tile_val": edge_val[p].float(),
            "tile_units": units.int().contiguous()}


def _with_tile_order(csr: "CSRMatrix", unit: int = TILE_UNIT) -> "CSRMatrix":
    """``csr`` with its :func:`_tile_order` fields built from its spine and
    plan."""
    return dataclasses.replace(csr, **_tile_order(
        csr.src_idx, csr.col_idx, csr.edge_val, csr.plan_tile,
        csr.plan_chunk, csr.plan_cfg, csr.n_alloc, unit))


def _to(a: np.ndarray, device) -> torch.Tensor:
    # np.require keeps a 0-d array 0-d (np.ascontiguousarray makes it (1,))
    return torch.from_numpy(np.require(a, requirements="C")).to(device)


def build_csr(edges: np.ndarray, n_alloc: int, kind: str = "bool",
              tail_min: int = 8, ell_cfg: tuple = DEFAULT_ELL_CFG,
              kernel_plan: tuple | None = None, device=None) -> CSRMatrix:
    """Pack an edge list into a :class:`CSRMatrix` over ``n_alloc`` vertices
    on ``device`` (``None``: the card).  The numpy packing is the JAX
    ``build_csr``'s; ``kernel_plan=(chunk, bn)`` also builds the tile-skip
    worklist for those block sizes (chunk clamped to a power of two no
    larger than the capacity, bn to a power of two)."""
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
    plan_cfg, plan = None, (None,) * 3
    if kernel_plan is not None:
        chunk, bn = kernel_plan
        chunk = min(_pow2_floor(chunk), cap)  # cap is a power of two
        bn = _pow2_floor(bn)
        plan = tuple(_to(a, device) for a in _tile_plan(
            dst, m, cap, n_alloc, chunk, bn))
        plan_cfg = (chunk, bn)
    src = np.concatenate([src, np.zeros(pad, np.int32)])
    dst = np.concatenate([dst, np.zeros(pad, np.int32)])
    val = np.concatenate([val, np.full(pad, sr.zero, val.dtype)])
    return _with_views(CSRMatrix(
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
        plan_tile=plan[0], plan_chunk=plan[1], plan_first=plan[2],
        n=n, n_alloc=n_alloc, kind=kind,
        ell_cfg=tuple(ell_cfg), plan_cfg=plan_cfg))


def tail_will_rebuild(csr: CSRMatrix, n_new: int,
                      rebuild_frac: float = 0.25) -> bool:
    """Would appending ``n_new`` arcs fold the COO tail into the spine?  The
    one predicate shared by :func:`csr_append` and the serving layer (which
    re-runs the density heuristic at fold time); the floor of 8 only
    shields tiny spines from thrashing."""
    total_tail = int(csr.tail_nnz) + n_new
    return total_tail > max(rebuild_frac * max(int(csr.nnz), 1), 8)


def csr_append(csr: CSRMatrix, rows: np.ndarray,
               rebuild_frac: float = 0.25) -> CSRMatrix:
    """Monotone append: new arcs land in the COO tail; the spine rebuilds
    (re-sort and repack, carrying ``ell_cfg`` and ``plan_cfg``) only when
    the tail outgrows ``rebuild_frac`` of the packed arcs.  The additive
    carrier keeps set semantics: arcs already resident, or repeated in
    ``rows``, are dropped first.  Arcs must stay inside ``n_alloc``."""
    rows = np.asarray(rows, np.int64)
    if not csr.semiring.idempotent and len(rows):
        rows = new_rows(rows, csr.edges_numpy())
    return csr_append_new(csr, rows, rebuild_frac)


def csr_append_new(csr: CSRMatrix, rows: np.ndarray,
                   rebuild_frac: float = 0.25) -> CSRMatrix:
    """:func:`csr_append` without the additive set filter, for a caller
    that keeps its own arc set (the service): ``rows`` are distinct and not
    resident."""
    rows = np.asarray(rows, np.int64)
    src, dst, val = _pack_edges(rows, csr.kind)
    if len(src) and int(max(src.max(), dst.max())) >= csr.n_alloc:
        raise ValueError("appended arcs outgrow n_alloc; rebuild the CSR")
    t = int(csr.tail_nnz)
    total_tail = t + len(src)
    if tail_will_rebuild(csr, len(src), rebuild_frac):
        merged = np.concatenate([csr.edges_numpy(),
                                 rows.reshape(len(src), -1)])
        return build_csr(merged, csr.n_alloc, csr.kind, ell_cfg=csr.ell_cfg,
                         kernel_plan=csr.plan_cfg, device=csr.device)
    cap = quantize_rows(total_tail + 1)  # >= 1 sentinel slot for the ELL pads
    tsrc = np.zeros(cap, np.int32)
    tdst = np.zeros(cap, np.int32)
    tval = np.full(cap, csr.semiring.zero, val.dtype)
    tsrc[:t] = csr.tail_src[:t].cpu().numpy()
    tdst[:t] = csr.tail_dst[:t].cpu().numpy()
    tval[:t] = csr.tail_val[:t].cpu().numpy()
    tsrc[t:total_tail], tdst[t:total_tail], tval[t:total_tail] = src, dst, val
    tell = _ell_index(tdst, total_tail, csr.n_alloc, cap - 1)
    dev = csr.device
    return dataclasses.replace(
        csr, tail_src=_to(tsrc, dev), tail_dst=_to(tdst, dev),
        tail_val=_to(tval, dev), tail_ell=_to(tell, dev),
        tail_nnz=torch.tensor(total_tail, dtype=torch.int32, device=dev))


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


def _ell_step_max(f, src, val, ell):
    contrib = f[:, src.long()] + val  # -inf sentinels never win the max
    return contrib[:, ell.long()].amax(dim=2)


def _sliced_step_max(f, src, val, slices, rank):
    contrib = f[:, src.long()] + val
    parts = [contrib[:, t.long()].amax(dim=2) for t in slices]
    return torch.cat(parts, dim=1)[:, rank.long()]


def _ell_step_sum(f, src, val, ell):
    contrib = f[:, src.long()] * val  # 0-valued sentinels contribute nothing
    return contrib[:, ell.long()].sum(dim=2)


def _sliced_step_sum(f, src, val, slices, rank):
    contrib = f[:, src.long()] * val
    parts = [contrib[:, t.long()].sum(dim=2) for t in slices]
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


def csr_frontier_max(frontier: torch.Tensor, csr: CSRMatrix) -> torch.Tensor:
    """One plain max-plus frontier step over the packed arcs (sentinels are
    -inf)."""
    f = frontier[None, :] if frontier.ndim == 1 else frontier
    out = _sliced_step_max(f, csr.src_idx, csr.edge_val, csr.ell_slices,
                           csr.ell_rank)
    out = torch.maximum(
        out, _ell_step_max(f, csr.tail_src, csr.tail_val, csr.tail_ell))
    return out[0] if frontier.ndim == 1 else out


def csr_frontier_sum(frontier: torch.Tensor, csr: CSRMatrix) -> torch.Tensor:
    """One plain plus-times frontier step over the packed arcs (sentinels
    are 0): the segment reduce is an exact sum while the partial sums are
    integers below 2^24 — parallel arcs both contribute."""
    f = frontier[None, :] if frontier.ndim == 1 else frontier
    out = _sliced_step_sum(f, csr.src_idx, csr.edge_val, csr.ell_slices,
                           csr.ell_rank)
    out = out + _ell_step_sum(f, csr.tail_src, csr.tail_val, csr.tail_ell)
    return out[0] if frontier.ndim == 1 else out


_FRONTIER_STEPS = {"bool": csr_frontier_or, "minplus": csr_frontier_min,
                   "maxplus": csr_frontier_max, "plustimes": csr_frontier_sum}


def csr_frontier_step(kind: str) -> Callable:
    """The plain step of a carrier (``kind``: 'bool' | 'minplus' |
    'maxplus' | 'plustimes'), as the JAX module's; an unknown kind raises
    :class:`~repro_torch.core.semiring.CarrierError`.  The kernel-backed
    steps are ``kernels.ops.csr_frontier_step``."""
    carrier_for(kind)
    return _FRONTIER_STEPS[kind]


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
    The additive carrier runs the accumulate form instead (the twin of
    ``fixpoint_dense(form="accumulate")``): the delta propagates until it
    drains, bounded by ``max_iters``, which the caller checks afterwards
    (``check_additive_converged``).
    """
    sr = csr.semiring
    if spmv is None:
        from ..kernels import ops
        spmv = ops.csr_frontier_step(csr.kind)
    if max_iters is None:
        max_iters = _default_max_iters(csr, init)
    zero = torch.tensor(sr.zero, dtype=init.dtype, device=init.device)
    it = 0
    gen = torch.zeros((), dtype=GEN_DTYPE, device=init.device)
    if not sr.idempotent:
        total = delta = init
        while it < max_iters and bool((delta != zero).any()):
            new = spmv(delta, csr)
            gen = gen + (new != zero).sum(dtype=GEN_DTYPE)
            total, delta = total + new, new
            it += 1
        return DenseResult(total, it, int(gen))
    D = init
    mask = torch.ones(init.shape[:-1] if init.ndim > 1 else init.shape,
                      dtype=torch.bool, device=init.device)
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


def _default_max_iters(csr: CSRMatrix, init: torch.Tensor) -> int:
    """The JAX default bound: ``n + 2`` for the additive carrier (an acyclic
    graph drains within n steps), ``4n + 8`` for the idempotent ones, over
    the frontier's domain size n."""
    n = init.shape[-1]
    return additive_max_iters(n) if not csr.semiring.idempotent \
        else 4 * n + 8


def fixpoint_csr_cached(csr: CSRMatrix, init: torch.Tensor,
                        spmv: Callable | None = None,
                        max_iters: int | None = None) -> DenseResult:
    """:func:`fixpoint_csr` with the JAX cached twin's signature (no jit
    here; ``max_iters`` resolves per carrier as there).  The call is counted
    as the JAX twin's trace cache would count it: its static key is the
    step and the bound, its signature the carrier's static fields and the
    shapes of its arrays and of ``init`` (``seminaive.note_trace``)."""
    if max_iters is None:
        max_iters = _default_max_iters(csr, init)
    note_trace("csr", (spmv, max_iters), _csr_signature(csr, init))
    return fixpoint_csr(csr, init, spmv=spmv, max_iters=max_iters)


def _csr_signature(csr: CSRMatrix, init: torch.Tensor) -> tuple:
    """What a JAX jit keys a CSR argument on: the static fields and the
    shape of every array of JAX's layout (the derived views excluded)."""
    arrays = (csr.row_ptr, csr.col_idx, csr.edge_val, csr.src_idx,
              *csr.ell_slices, csr.ell_rank, csr.nnz, csr.tail_src,
              csr.tail_dst, csr.tail_val, csr.tail_ell, csr.tail_nnz,
              csr.plan_tile, csr.plan_chunk, csr.plan_first)
    return ((csr.n, csr.n_alloc, csr.kind, csr.ell_cfg, csr.plan_cfg,
             len(csr.ell_slices)),
            tuple(None if a is None else tuple(a.shape) for a in arrays),
            (tuple(init.shape), str(init.dtype)))


def reachable_batch_csr(csr: CSRMatrix, srcs, spmv=None,
                        max_iters: int | None = None) -> DenseResult:
    """``?- tc(s, Y)`` for a batch of sources over packed arcs."""
    return fixpoint_csr_cached(csr, rows_from_sources(csr, srcs, spmv),
                               spmv=spmv, max_iters=max_iters)


def distances_batch_csr(csr: CSRMatrix, srcs, spmv=None,
                        max_iters: int | None = None) -> DenseResult:
    """``?- spath(s, Z, D)`` for a batch of sources (min-plus carrier)."""
    return fixpoint_csr_cached(csr, rows_from_sources(csr, srcs, spmv),
                               spmv=spmv, max_iters=max_iters)


def counts_batch_csr(csr: CSRMatrix, srcs, spmv=None,
                     max_iters: int | None = None) -> DenseResult:
    """``?- cpath(s, Z, C)`` for a batch of sources (plus-times carrier):
    accumulate-form over the packed arcs, host-checked against the additive
    iteration bound (:class:`~repro_torch.core.seminaive.
    FixpointDivergenceError` on cyclic graphs)."""
    if max_iters is None:
        max_iters = additive_max_iters(csr.n_alloc)
    res = fixpoint_csr_cached(csr, rows_from_sources(csr, srcs, spmv),
                              spmv=spmv, max_iters=max_iters)
    return check_additive_converged(res, max_iters, "plus-times CSR batch")


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
    return _with_views(CSRMatrix(
        row_ptr=t["row_ptr"], col_idx=t["col_idx"], edge_val=t["edge_val"],
        src_idx=t["src_idx"], ell_slices=slices, ell_rank=t["ell_rank"],
        nnz=t["nnz"], tail_src=t["tail_src"], tail_dst=t["tail_dst"],
        tail_val=t["tail_val"], tail_ell=t["tail_ell"],
        tail_nnz=t["tail_nnz"],
        plan_tile=t.get("plan_tile"), plan_chunk=t.get("plan_chunk"),
        plan_first=t.get("plan_first"),
        n=int(meta["n"]), n_alloc=int(meta["n_alloc"]),
        kind=str(meta["kind"]), ell_cfg=tuple(meta["ell_cfg"]),
        plan_cfg=plan_cfg))
