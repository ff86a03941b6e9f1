"""K3 / K4 / K5 / K6 — one CSR frontier step on the bool, min-plus,
plus-times and max-plus carriers — and K7, the min-plus step over a
tile-skip plan, as CUDA kernels for Hopper.

Replace the Pallas kernels ``repro.kernels.spmv.csr_bool_spmv``,
``csr_minplus_spmv``, ``csr_plustimes_spmv`` and ``csr_maxplus_spmv`` as the
JAX serving path drives them (``ops._csr_<carrier>_step``: spine + COO
tail).  The kernels (``csrc/spmv.cu``) compute the same function as a pull
by destination: each output ``(b, v)`` ⊕-reduces ``frontier[b, src_idx[p]]
⊗ edge_val[p]`` over v's in-edge positions ``p``, then over its COO-tail
positions.  K4 reads the positions through the CSR's sliced-ELL segment
map, slice by slice; K3, K5 and K6 read the CSR's ELL-ordered sources and
values (``core.sparse._ell_order``), skip arcs whose source holds the
⊕-zero in every batch row, and run every slice in one launch; K3 gathers a
bit-packed frontier (:func:`pack_bits`), K5 and K6 are one kernel template
on (⊕, ⊗).  OR, min and max are order-independent, so K3, K4 and K6 are
bit-identical to the plain step; K5 sums in a fixed order with no atomics
(:func:`ell_step_in_kernel_order`), so it is deterministic, and equals the
plain step exactly while every partial sum is an integer below 2^24
(integral EDBs and path counts).

K7 (``csr_minplus_tiled_step``) replaces ``csr_minplus_spmv_tiled``: it
walks the CSR's tile-skip worklist (``build_csr(kernel_plan=)``) in work
units of one tile each, keeps a (32, bn) accumulator per unit in shared
memory, and folds the COO tail in the same call (``csrc/spmv.cu`` says
more).  Min is order-free, so it is bit-identical to the plain version.

The wrappers take the CSR itself (``csr_bool_step(frontier, csr)``).  On
CPU tensors they run the plain step (:data:`plain_bool`,
:data:`plain_minplus`, :data:`plain_plustimes`, :data:`plain_maxplus`); on
CUDA tensors they launch the kernel or raise.  :func:`csr_raw_step` and
:func:`csr_raw_minplus_tiled` take the JAX entries' bare arc triple
(``ops.csr_bool(frontier, src, dst, val)`` …) and launch the same kernels;
``csr_bool_spmv`` … ``csr_minplus_spmv_tiled`` and ``padded_width`` are the
JAX module's own names for them.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core.seminaive import quantize_rows
from ..core.sparse import (DEFAULT_ELL_CFG, CSRMatrix, _plan_units,
                           _with_ell_order)
from ..core.sparse import padded_width  # noqa: F401 (the JAX module's name)
from . import build, ref

#: the plain PyTorch versions of these kernels
plain_bool = ref.csr_bool_step_ref
plain_minplus = ref.csr_minplus_step_ref
plain_plustimes = ref.csr_plustimes_step_ref
plain_maxplus = ref.csr_maxplus_step_ref
plain_minplus_tiled = ref.csr_minplus_tiled_step_ref

#: positions per K4 warp work item: wider slice rows (power-law hubs)
#: are cut into SEG-position segments, one warp each, then ⊕-reduced
SEG = 1024
#: batch rows per kernel call (lanes own rows lane + 32q, q < 4)
MAX_BATCH = 128

_VP, _I = ctypes.c_void_p, ctypes.c_int
#: K5's and K6's entry points (one kernel template)
_ELL_ARGS = [_VP, _I, _I, _VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _VP,
             _VP, _VP, _VP, _VP, _VP]
_PROTOTYPES = {"repro_csr_bool_step": [
                   _VP, _I, _I, _VP, _VP, _I, _I, _VP, _VP, _I, _VP, _VP,
                   _VP, _VP, _VP, _VP, _VP],
               "repro_csr_minplus_step": [
                   _VP, _I, _I, _VP, _VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _I,
                   _VP, _VP, _VP, _VP, _VP, _VP, _VP],
               "repro_csr_plustimes_step": _ELL_ARGS,
               "repro_csr_maxplus_step": _ELL_ARGS,
               "repro_csr_minplus_tiled_step": [
                   _VP, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                   _VP, _I, _VP, _VP, _VP, _VP, _VP]}
#: the widest column tile K7 takes: its (32, bn + 1) f32 accumulator must fit
#: a block's 227 KB of shared memory
MAX_TILED_BN = 1024


def _checked(what: str, dtype: torch.dtype, frontier, csr,
             index: tuple[str, ...]) -> torch.Tensor:
    """The frontier as (B, n_alloc), after checking it and the CSR arrays a
    kernel reads (``index``: its int32 arrays) for device, dtype and
    layout."""
    if frontier.ndim not in (1, 2):
        raise ValueError(f"{what}: frontier must be (n,) or (B, n)")
    f = frontier[None, :] if frontier.ndim == 1 else frontier
    build.require(f"{what} frontier", f, dtype, 2)
    if f.shape[1] != csr.n_alloc:
        raise ValueError(f"{what}: frontier width {f.shape[1]} != "
                         f"n_alloc {csr.n_alloc}")
    for name in index:
        t = getattr(csr, name)
        build.require(f"{what} csr.{name}", t, torch.int32, t.ndim)
    build.require(f"{what} csr.edge_val", csr.edge_val, dtype, 1)
    build.require(f"{what} csr.tail_val", csr.tail_val, dtype, 1)
    return f


def _launch(fn: str, counter: str, dtype: torch.dtype, frontier, csr):
    f = _checked(counter, dtype, frontier, csr,
                 ("src_idx", "ell_rank", "tail_src", "tail_ell"))
    n = csr.n_alloc
    for t in csr.ell_slices:
        build.require(f"{counter} csr.ell_slices", t, torch.int32, 2)
    slices = csr.ell_slices
    rows = [int(t.shape[0]) for t in slices]
    caps = [int(t.shape[1]) for t in slices]
    part_rows = max([r * -(-c // SEG) for r, c in zip(rows, caps) if c > SEG],
                    default=1)
    k = len(slices)
    ells = (ctypes.c_void_p * k)(*[t.data_ptr() for t in slices])
    rows_c = (ctypes.c_int * k)(*rows)
    caps_c = (ctypes.c_int * k)(*caps)
    B = f.shape[0]
    out = torch.empty_like(f)
    bc = min(B, MAX_BATCH)
    dev = f.device
    fT = torch.empty((n, bc), dtype=dtype, device=dev)
    cat = torch.empty((sum(rows), bc), dtype=dtype, device=dev)
    part = torch.empty((part_rows, bc), dtype=dtype, device=dev)
    lib = build.load("spmv", _PROTOTYPES)
    with torch.cuda.device(dev):
        stream = build.stream_handle(f)
        for b0 in range(0, B, MAX_BATCH):
            b = min(MAX_BATCH, B - b0)
            rc = getattr(lib, fn)(
                f[b0].data_ptr(), b, n, csr.src_idx.data_ptr(),
                csr.edge_val.data_ptr(), k, ells, rows_c, caps_c, SEG,
                csr.ell_rank.data_ptr(), csr.tail_ell.data_ptr(),
                int(csr.tail_ell.shape[1]), csr.tail_src.data_ptr(),
                csr.tail_val.data_ptr(), fT.data_ptr(), cat.data_ptr(),
                part.data_ptr(), out[b0].data_ptr(), stream)
            build.check(lib, rc, counter)
    build.LAUNCHES[counter] += 1
    return out[0] if frontier.ndim == 1 else out


def _operands(frontier, csr) -> tuple:
    """Every tensor a step reads: the frontier and the CSR arrays."""
    return (frontier, csr.src_idx, csr.edge_val, csr.ell_rank, csr.tail_src,
            csr.tail_val, csr.tail_ell, *csr.ell_slices)


def pack_bits(frontier: torch.Tensor) -> torch.Tensor:
    """The (B, n) bool frontier as K3 gathers it: (n, ceil(B / 32)) int32
    words, bit ``b % 32`` of word ``b // 32`` set where ``frontier[b, v]``
    (the plain version of K3's pack; the words' bit patterns are uint32)."""
    B, n = frontier.shape
    W = -(-B // 32)
    bits = torch.zeros((W * 32, n), dtype=torch.int64,
                       device=frontier.device)
    bits[:B] = frontier.to(torch.int64)
    shift = torch.arange(32, device=frontier.device).view(1, 32, 1)
    words = (bits.view(W, 32, n) << shift).sum(1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).int().T


def unpack_bits(words: torch.Tensor, B: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (n, W) words -> (B, n) bool (K3's
    unpack)."""
    shift = torch.arange(32, device=words.device).view(1, 32, 1)
    bits = (words.T.to(torch.int64)[:, None, :] >> shift) & 1
    return bits.reshape(-1, words.shape[0])[:B].bool()


#: (⊗, ⊕) of the carriers K5 and K6 run, each rounded as the kernel does
_ELL_OPS = {"plustimes": (torch.mul, torch.add),
            "maxplus": (torch.add, torch.maximum)}


def ell_step_in_kernel_order(frontier: torch.Tensor, csr) -> torch.Tensor:
    """K5's or K6's step in the kernel's own order, in PyTorch (f32, every
    ⊗ and ⊕ rounded as the kernel rounds it): per piece of
    ``csr.ell_items``, the slots in order from the ⊕-zero; per row, its
    pieces in order; then the COO tail's positions in order.  Equal to the
    kernel bit for bit where every weight is finite; for max-plus, and for
    plus-times while every partial sum is an integer below 2^24, equal to
    the plain step (:data:`plain_maxplus`, :data:`plain_plustimes`)."""
    mul, add = _ELL_OPS[csr.kind]
    zero = ref.CSR_ZERO[csr.kind]
    f = frontier[None, :] if frontier.ndim == 1 else frontier
    B, dev = f.shape[0], f.device
    it = csr.ell_items.long()
    npc, length = it[:, 3] & 63, it[:, 3] >> 6
    n_pieces = int(csr.ell_row_piece[-1])
    first = torch.zeros(n_pieces, dtype=torch.int64, device=dev)
    plen = torch.zeros(n_pieces, dtype=torch.int64, device=dev)
    t = torch.arange(int(npc.sum()), device=dev) - torch.repeat_interleave(
        torch.cumsum(npc, 0) - npc, npc)
    k = torch.repeat_interleave(it[:, 1], npc) + t
    first[k] = torch.repeat_interleave(it[:, 0], npc) + t * \
        torch.repeat_interleave(length, npc)
    plen[k] = torch.repeat_interleave(length, npc)
    src = csr.ell_src.long()
    contrib = mul(f[:, src.clamp(min=0)], csr.ell_val)  # (B, E), rounded
    contrib[:, src < 0] = zero
    piece = torch.full((B, n_pieces), zero, dtype=f.dtype, device=dev)
    for j in range(int(plen.max()) if n_pieces else 0):
        on = plen > j
        piece[:, on] = add(piece[:, on], contrib[:, first[on] + j])
    rp = csr.ell_row_piece.long()
    cnt = rp[1:] - rp[:-1]
    rows = torch.full((B, len(cnt)), zero, dtype=f.dtype, device=dev)
    for j in range(int(cnt.max()) if len(cnt) else 0):
        on = cnt > j
        rows[:, on] = add(rows[:, on], piece[:, rp[:-1][on] + j])
    out = rows[:, csr.ell_rank.long()]
    tail = csr.tail_ell.long()
    tsrc = csr.tail_src.long()
    for j in range(tail.shape[1]):
        p = tail[:, j]
        out = add(out, mul(f[:, tsrc[p]], csr.tail_val[p]))
    return out[0] if frontier.ndim == 1 else out


def _ell_operands(frontier, csr) -> tuple:
    """Every tensor K3/K5/K6 read: :func:`_operands` and the derived ELL
    order (``core.sparse._ell_order``)."""
    derived = (csr.ell_src, csr.ell_val, csr.ell_items, csr.ell_row_piece)
    return (*_operands(frontier, csr), *(t for t in derived if t is not None))


def _ell_checked(what: str, dtype, frontier, csr) -> torch.Tensor:
    """The frontier as (B, n_alloc), after checking the arrays K3/K5/K6
    read."""
    if csr.ell_items is None:
        raise ValueError(f"{what}: the CSR has no ELL-ordered sources "
                         "(core.sparse._ell_order)")
    f = _checked(what, dtype, frontier, csr,
                 ("ell_src", "ell_rank", "ell_row_piece", "tail_src",
                  "tail_ell"))
    build.require(f"{what} csr.ell_items", csr.ell_items, torch.int32, 2)
    if csr.ell_items.shape[1] != 4 or csr.ell_items.data_ptr() % 16:
        raise ValueError(f"{what}: csr.ell_items must be (items, 4) and "
                         "16-byte aligned")
    return f


def csr_bool_step(frontier: torch.Tensor, csr) -> torch.Tensor:
    """(B, n_alloc) bool ⊗ packed arcs -> (B, n_alloc) bool: segment-OR by
    destination over the spine and the COO tail (K3: a bit-packed frontier
    gathered over the ELL-ordered sources)."""
    if not build.on_card("csr_bool_step", *_ell_operands(frontier, csr)):
        return plain_bool(frontier, csr)
    what = "csr_bool_step"
    f = _ell_checked(what, torch.bool, frontier, csr)
    B, n = f.shape
    out = torch.empty_like(f)
    bc = min(B, MAX_BATCH)
    W, dev = -(-bc // 32), f.device
    n_rows = int(csr.ell_row_piece.shape[0]) - 1
    fw = torch.empty((n, W), dtype=torch.int32, device=dev)
    act = torch.empty(-(-n // 32), dtype=torch.int32, device=dev)
    roww = torch.empty((n_rows, W), dtype=torch.int32, device=dev)
    lib = build.load("spmv", _PROTOTYPES)
    with torch.cuda.device(dev):
        stream = build.stream_handle(f)
        for b0 in range(0, B, MAX_BATCH):
            rc = lib.repro_csr_bool_step(
                f[b0].data_ptr(), min(MAX_BATCH, B - b0), n,
                csr.ell_src.data_ptr(), csr.ell_items.data_ptr(),
                int(csr.ell_items.shape[0]), n_rows, csr.ell_rank.data_ptr(),
                csr.tail_ell.data_ptr(), int(csr.tail_ell.shape[1]),
                csr.tail_src.data_ptr(), csr.tail_val.data_ptr(),
                fw.data_ptr(), act.data_ptr(), roww.data_ptr(),
                out[b0].data_ptr(), stream)
            build.check(lib, rc, what)
    build.LAUNCHES[what] += 1
    return out[0] if frontier.ndim == 1 else out


def csr_minplus_step(frontier: torch.Tensor, csr) -> torch.Tensor:
    """(B, n_alloc) f32 ⊗_min,+ packed arcs -> (B, n_alloc) f32:
    segment-min by destination over the spine and the COO tail."""
    if not build.on_card("csr_minplus_step", *_operands(frontier, csr)):
        return plain_minplus(frontier, csr)
    return _launch("repro_csr_minplus_step", "csr_minplus_step",
                   torch.float32, frontier, csr)


def _ell_step(what: str, fn: str, frontier, csr) -> torch.Tensor:
    """Launch K5 or K6 (entry ``fn``, counter ``what``): the template's
    three passes over the CSR's ELL order, once a 128-row batch slice."""
    f = _ell_checked(what, torch.float32, frontier, csr)
    build.require(f"{what} csr.ell_val", csr.ell_val, torch.float32, 1)
    B, n = f.shape
    out = torch.empty_like(f)
    bc, dev = min(B, MAX_BATCH), f.device
    # each item holds one piece or one piece a row: a bound read from the
    # shapes, with no sync for the exact count
    n_pieces = int(csr.ell_items.shape[0]) + int(csr.ell_row_piece.shape[0])
    fT = torch.empty((n, bc), dtype=torch.float32, device=dev)
    act = torch.empty(-(-n // 32), dtype=torch.int32, device=dev)
    part = torch.empty((n_pieces, bc), dtype=torch.float32, device=dev)
    live = torch.empty(n_pieces, dtype=torch.uint8, device=dev)
    lib = build.load("spmv", _PROTOTYPES)
    with torch.cuda.device(dev):
        stream = build.stream_handle(f)
        for b0 in range(0, B, MAX_BATCH):
            rc = getattr(lib, fn)(
                f[b0].data_ptr(), min(MAX_BATCH, B - b0), n,
                csr.ell_src.data_ptr(), csr.ell_val.data_ptr(),
                csr.ell_items.data_ptr(), int(csr.ell_items.shape[0]),
                csr.ell_row_piece.data_ptr(), csr.ell_rank.data_ptr(),
                csr.tail_ell.data_ptr(), int(csr.tail_ell.shape[1]),
                csr.tail_src.data_ptr(), csr.tail_val.data_ptr(),
                fT.data_ptr(), act.data_ptr(), part.data_ptr(),
                live.data_ptr(), out[b0].data_ptr(), stream)
            build.check(lib, rc, what)
    build.LAUNCHES[what] += 1
    return out[0] if frontier.ndim == 1 else out


def csr_plustimes_step(frontier: torch.Tensor, csr) -> torch.Tensor:
    """(B, n_alloc) f32 ⊗_+,× packed arcs -> (B, n_alloc) f32: segment-sum
    by destination over the spine and the COO tail, in a fixed order (K5:
    :func:`ell_step_in_kernel_order`)."""
    if not build.on_card("csr_plustimes_step",
                         *_ell_operands(frontier, csr)):
        return plain_plustimes(frontier, csr)
    return _ell_step("csr_plustimes_step", "repro_csr_plustimes_step",
                     frontier, csr)


def csr_maxplus_step(frontier: torch.Tensor, csr) -> torch.Tensor:
    """(B, n_alloc) f32 ⊗_max,+ packed arcs -> (B, n_alloc) f32:
    segment-max by destination over the spine and the COO tail (-inf
    sentinels; K6, K5's template with max for the sum)."""
    if not build.on_card("csr_maxplus_step", *_ell_operands(frontier, csr)):
        return plain_maxplus(frontier, csr)
    return _ell_step("csr_maxplus_step", "repro_csr_maxplus_step", frontier,
                     csr)


def csr_minplus_tiled_step(frontier: torch.Tensor, csr) -> torch.Tensor:
    """(B, n_alloc) f32 ⊗_min,+ packed arcs -> (B, n_alloc) f32 over the
    CSR's tile-skip plan (``csr.plan_cfg``), the COO tail folded in."""
    plan = (csr.plan_tile, csr.plan_chunk, csr.plan_first, csr.plan_unit)
    if csr.plan_cfg is None or any(t is None for t in plan):
        raise ValueError("csr_minplus_tiled_step: the CSR has no tile-skip "
                         "plan (build_csr(kernel_plan=...))")
    if not build.on_card("csr_minplus_tiled_step",
                         *_operands(frontier, csr), csr.col_idx, *plan):
        return plain_minplus_tiled(frontier, csr)
    what = "csr_minplus_tiled_step"
    f = _checked(what, torch.float32, frontier, csr,
                 ("col_idx", "src_idx", "tail_src", "tail_ell", "plan_tile",
                  "plan_chunk", "plan_first", "plan_unit"))
    n = csr.n_alloc
    chunk, bn = csr.plan_cfg
    if bn > MAX_TILED_BN or csr.capacity % chunk:
        raise ValueError(f"{what}: plan (chunk={chunk}, bn={bn}) does not "
                         f"fit the kernel (bn <= {MAX_TILED_BN}, chunk "
                         f"dividing the capacity {csr.capacity})")
    B = f.shape[0]
    # +inf under the split tiles' atomic min.  Filling the whole output
    # costs one fast pass; a kernel pass that fills only split tiles timed
    # 0.04-0.05 ms slower a step on the power-law graph of chip_smoke.py,
    # where most tiles are split (scripts/k7_ab.py, on an H100).
    out = torch.full_like(f, float("inf"))
    fT = torch.empty((n, B), dtype=torch.float32, device=f.device)
    lib = build.load("spmv", _PROTOTYPES)
    with torch.cuda.device(f.device):
        rc = lib.repro_csr_minplus_tiled_step(
            f.data_ptr(), B, n, csr.col_idx.data_ptr(),
            csr.src_idx.data_ptr(), csr.edge_val.data_ptr(),
            csr.plan_tile.data_ptr(), csr.plan_chunk.data_ptr(),
            csr.plan_first.data_ptr(), csr.plan_unit.data_ptr(),
            int(csr.plan_unit.shape[0]) - 1, chunk, bn,
            csr.tail_ell.data_ptr(), int(csr.tail_ell.shape[1]),
            csr.tail_src.data_ptr(), csr.tail_val.data_ptr(), fT.data_ptr(),
            out.data_ptr(), build.stream_handle(f))
        build.check(lib, rc, what)
    build.LAUNCHES[what] += 1
    return out[0] if frontier.ndim == 1 else out


#: the kernel-backed step of each carrier, for a CSR without a plan
_STEPS = {"bool": csr_bool_step, "minplus": csr_minplus_step,
          "maxplus": csr_maxplus_step, "plustimes": csr_plustimes_step}


def _raw_csr(kind: str, n: int, spine: tuple, tail: tuple) -> CSRMatrix:
    """A :class:`CSRMatrix` over n vertices from arrays on one device:
    ``spine`` and ``tail`` are each ``(src, dst, val, ell)``, or None for
    one ⊕-zero sentinel arc (a spine of one all-sentinel slice row, a tail
    whose map points every vertex at that arc)."""
    f = spine[0] if spine is not None else tail[0]
    dev, zero = f.device, ref.CSR_ZERO[kind]
    dtype = torch.bool if kind == "bool" else torch.float32

    def sentinel(rows):
        return (torch.zeros(1, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev),
                torch.full((1,), zero, dtype=dtype, device=dev),
                torch.zeros((rows, 1), dtype=torch.int32, device=dev))

    s_src, s_dst, s_val, s_ell = spine if spine is not None else sentinel(1)
    t_src, t_dst, t_val, t_ell = tail if tail is not None else sentinel(n)
    i32 = dict(dtype=torch.int32, device=dev)
    return _with_ell_order(CSRMatrix(
        row_ptr=torch.zeros(n + 1, **i32), col_idx=s_dst, edge_val=s_val,
        src_idx=s_src, ell_slices=(s_ell,),
        ell_rank=torch.zeros(n, **i32), nnz=torch.tensor(0, **i32),
        tail_src=t_src, tail_dst=t_dst, tail_val=t_val, tail_ell=t_ell,
        tail_nnz=torch.tensor(int(t_src.shape[0]) - 1, **i32),
        plan_tile=None, plan_chunk=None, plan_first=None, plan_unit=None,
        n=n, n_alloc=n, kind=kind, ell_cfg=DEFAULT_ELL_CFG, plan_cfg=None))


def _raw_tail(kind: str, n: int, src: torch.Tensor, dst: torch.Tensor,
             val: torch.Tensor) -> tuple:
    """An arc triple as a COO tail ``(src, dst, val, ell)`` over n vertices,
    built on the triple's device with torch index operations: the live
    arcs (value not the ⊕-zero) keep their order, one ⊕-zero sentinel arc
    follows them, and ``ell`` is ``core.sparse._ell_index``'s layout (each
    vertex's positions, grouped by destination in order, padded with the
    sentinel to the bucketed max in-degree).  ``ell`` takes n × that
    in-degree int32."""
    zero = ref.CSR_ZERO[kind]
    live = val if kind == "bool" else val != zero
    src, dst, val = src[live].int(), dst[live].int(), val[live]
    m = int(src.shape[0])
    dev = src.device
    indeg = torch.bincount(dst.long(), minlength=n)
    if m:
        lo, hi, top = torch.stack([torch.minimum(src.min(), dst.min()),
                                   torch.maximum(src.max(), dst.max()),
                                   indeg.max()]).tolist()
        if lo < 0 or hi >= n:
            raise ValueError(f"arcs reference vertex {hi if hi >= n else lo}"
                             f" outside [0, {n})")
    k = quantize_rows(top if m else 1, minimum=1)
    order = torch.argsort(dst.long(), stable=True)
    by_dst = dst.long()[order]
    rank = (torch.arange(m, device=dev)
            - (torch.cumsum(indeg, 0) - indeg)[by_dst])
    ell = torch.full((n, k), m, dtype=torch.int32, device=dev)
    ell[by_dst, rank] = order.int()
    tail_val = torch.cat([val, torch.full((1,), zero, dtype=val.dtype,
                                          device=dev)])
    pad = torch.zeros(1, dtype=torch.int32, device=dev)
    return torch.cat([src, pad]), torch.cat([dst, pad]), tail_val, ell


def raw_csr(kind: str, n: int, src: torch.Tensor, dst: torch.Tensor,
            val: torch.Tensor) -> CSRMatrix:
    """An arc triple as a :class:`CSRMatrix` over n vertices that K3-K6
    step: an empty spine, the triple as its COO tail (:func:`_raw_tail`)."""
    return _raw_csr(kind, n, None, _raw_tail(kind, n, src, dst, val))


def raw_tiled_csr(n: int, src: torch.Tensor, dst: torch.Tensor,
                  val: torch.Tensor, plan_tile: torch.Tensor,
                  plan_chunk: torch.Tensor, plan_first: torch.Tensor,
                  chunk: int, bn: int) -> CSRMatrix:
    """An arc triple and its tile-skip plan as a min-plus
    :class:`CSRMatrix` over n vertices that K7 steps: the triple as the
    spine (``col_idx = dst``), no tail, and K7's work units cut from the
    plan on the host (``core.sparse._plan_units``; the plan is a few int32
    a tile)."""
    plan = tuple(t.int() for t in (plan_tile, plan_chunk, plan_first))
    units = _plan_units(*(t.cpu().numpy() for t in plan))
    # K7 reads col_idx, src_idx, edge_val and the plan, never the slice map
    spine = (src.int(), dst.int(), val,
             torch.zeros((1, 1), dtype=torch.int32, device=src.device))
    return dataclasses.replace(
        _raw_csr("minplus", n, spine, None), plan_tile=plan[0],
        plan_chunk=plan[1], plan_first=plan[2],
        plan_unit=torch.from_numpy(np.ascontiguousarray(units)).to(
            src.device), plan_cfg=(int(chunk), int(bn)))


def csr_raw_step(kind: str, frontier: torch.Tensor, src: torch.Tensor,
                 dst: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """One frontier step over a bare arc triple (the JAX ``ops.csr_bool``,
    ``csr_minplus``, ``csr_maxplus`` and ``csr_plustimes``): ``frontier``
    (B, n) ⊗ the arcs ``src -> dst`` with values ``val`` -> (B, n).

    On CPU tensors the plain version (:func:`ref.csr_raw_ref`).  On CUDA
    tensors K3/K4/K6/K5 over :func:`raw_csr`, whose map is built on the
    card.  That map is n × (max in-degree) int32, so these entries suit the
    JAX API's callers and tests; the service packs its CSR once and steps
    it."""
    if kind not in _STEPS:
        raise KeyError(kind)
    if not build.on_card(f"csr_{kind}", frontier, src, dst, val):
        return ref.csr_raw_ref(kind, frontier, src, dst, val)
    return _STEPS[kind](frontier, raw_csr(kind, int(frontier.shape[-1]),
                                          src, dst, val))


def csr_raw_minplus_tiled(frontier: torch.Tensor, src: torch.Tensor,
                          dst: torch.Tensor, val: torch.Tensor,
                          plan_tile: torch.Tensor, plan_chunk: torch.Tensor,
                          plan_first: torch.Tensor, chunk: int,
                          bn: int) -> torch.Tensor:
    """The min-plus step over an arc triple's tile-skip plan (the JAX
    ``ops.csr_minplus_tiled``): the plan's (tile, chunk, first) worklist,
    built for these arcs with ``(chunk, bn)`` as ``core.sparse._tile_plan``
    builds it.  On CPU tensors the plain version
    (:func:`ref.csr_raw_minplus_tiled_ref`); on CUDA tensors K7 over
    :func:`raw_tiled_csr`."""
    operands = (frontier, src, dst, val, plan_tile, plan_chunk, plan_first)
    if not build.on_card("csr_minplus_tiled", *operands):
        return ref.csr_raw_minplus_tiled_ref(frontier, src, dst, val,
                                             plan_tile, plan_chunk, chunk,
                                             bn)
    return csr_minplus_tiled_step(frontier, raw_tiled_csr(
        int(frontier.shape[-1]), src, dst, val, plan_tile, plan_chunk,
        plan_first, chunk, bn))


# The JAX module's Pallas entry names (``repro.kernels.spmv``), with its
# signatures: the block sizes and ``interpret`` are accepted so that one
# call drives both packages, and ignored (the Hopper kernels keep their own
# blocks; ``padded_width`` is ``core.sparse``'s, the same function).


def csr_bool_spmv(frontier, src, dst, val, *, chunk: int = 128,
                  interpret: bool = False) -> torch.Tensor:
    """(B, n) bool ⊗_bool packed arcs -> (B, n) bool (segment-OR by dst):
    :func:`csr_raw_step`, K3 on the card."""
    return csr_raw_step("bool", frontier, src, dst, val)


def csr_plustimes_spmv(frontier, src, dst, val, *, chunk: int = 128,
                       interpret: bool = False) -> torch.Tensor:
    """(B, n) f32 ⊗_+,× packed arcs -> (B, n) f32 (segment-sum by dst):
    :func:`csr_raw_step`, K5 on the card."""
    return csr_raw_step("plustimes", frontier, src, dst, val)


def csr_minplus_spmv(frontier, src, dst, val, *, chunk: int = 32,
                     bn: int = 128, interpret: bool = False) -> torch.Tensor:
    """(B, n) f32 ⊗_min,+ packed arcs -> (B, n) f32 (segment-min by dst):
    :func:`csr_raw_step`, K4 on the card."""
    return csr_raw_step("minplus", frontier, src, dst, val)


def csr_maxplus_spmv(frontier, src, dst, val, *, chunk: int = 32,
                     bn: int = 128, interpret: bool = False) -> torch.Tensor:
    """(B, n) f32 ⊗_max,+ packed arcs -> (B, n) f32 (segment-max by dst):
    :func:`csr_raw_step`, K6 on the card."""
    return csr_raw_step("maxplus", frontier, src, dst, val)


def csr_minplus_spmv_tiled(frontier, src, dst, val, plan_tile, plan_chunk,
                           plan_first, *, chunk: int, bn: int,
                           interpret: bool = False) -> torch.Tensor:
    """The min-plus step over the arcs' tile-skip plan, built with
    ``(chunk, bn)``: :func:`csr_raw_minplus_tiled`, K7 on the card."""
    return csr_raw_minplus_tiled(frontier, src, dst, val, plan_tile,
                                 plan_chunk, plan_first, chunk, bn)
