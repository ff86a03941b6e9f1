"""K8 — the fused semi-naive relaxation step, a CUDA kernel for Hopper.

Replaces the Pallas kernel ``repro.kernels.relax.relax_step``: one
iteration of the PreM-optimised shortest-path program,

    U  = Δ-masked D ⊗_min,+ A        (the recursive rule's join + is_min)
    D' = min(D, U)                    (merge into `all`)
    δ  = any(D' < D, per row)         (the new delta frontier)

in one call (``csrc/relax.cu``), by one of two routes chosen from A's
density:

* the arc-list route (:func:`relax_arcs`) for a sparse A, the all-pairs
  paths' arc matrices: a pre-pass builds A's column lists on the card
  (:func:`column_lists`), and the main pass folds each column's list
  against the Δ rows of D staged in shared memory, so only |Δ|·|E|
  candidates are computed;
* the tiled route (:func:`relax_tiled`) for a dense A: 64 x 128 output
  tiles over 32-deep K stages, the Δ mask applied while the left tile is
  loaded.

Both merge and raise the per-row flags in the epilogue.  On CPU tensors the
wrappers run the plain version (:data:`plain`); on CUDA tensors they launch
the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

#: the plain PyTorch version of this kernel
plain = ref.relax_ref

DEFAULT_BM = 128
DEFAULT_BN = 128
DEFAULT_BK = 32

#: the densest A (live entries over n²) that takes the arc-list route: where
#: the two routes cross at the first step of the G10K loop's shape (n =
#: 10,000, d = a, every row in Δ) with Gn-p arc matrices of swept density.
#: ``chip_smoke.k8_density_sweep`` on an NVIDIA H100 80GB HBM3 at 700 W
#: (PERF.md): the arc-list route 1.37, 4.98, 12.9, 39.8, 77.4 and
#: 114.7 ms at 0.1%, 1%, 3%, 10%, 20% and 30% live, the tiled route 94.9 ms
#: at 0.1% and 108.7-108.8 ms above; linear between 20% and 30%, they cross
#: at 28%.
ARC_DENSITY = 0.28
#: the widest n the arc-list route takes: one row of d (n f32) must fit a
#: block's 227 KB of shared memory
ARC_MAX_N = 232_448 // 4
#: rows a pre-pass block walks (``CSC_ROWS`` in ``csrc/relax.cu``)
CSC_ROWS = 256
#: a list slot past its column's last entry: (k = 0, w = +inf), as int64
_PAD = 0x7F800000 << 32

_VP, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {"repro_relax_step": [_VP, _VP, _VP, _VP, _VP, _I, _VP],
               "repro_relax_csc_scan": [_VP, _I, _VP, _VP, _VP, _VP, _VP,
                                        _VP, _VP, _VP, _VP, _VP, _VP],
               "repro_relax_csc_fill": [_VP, _I, _VP, _VP, _VP, _VP, _VP],
               "repro_relax_arcs": [_VP, _VP, _VP, _VP, _VP, _I, _VP, _VP,
                                    _VP, _I, _I, _VP]}


def arcs_pay(n: int, live: int) -> bool:
    """Does an (n, n) A with ``live`` entries other than +inf take the
    arc-list route: at most :data:`ARC_DENSITY` of it live, and n at most
    :data:`ARC_MAX_N`."""
    return n <= ARC_MAX_N and live <= ARC_DENSITY * n * n


def _checked(d, a, delta_mask) -> int:
    build.require("relax_step d", d, torch.float32, 2)
    build.require("relax_step a", a, torch.float32, 2)
    build.require("relax_step delta_mask", delta_mask, torch.bool, 1)
    n = d.shape[0]
    if d.shape != (n, n) or a.shape != (n, n) or delta_mask.shape != (n,):
        raise ValueError(f"relax_step: d {tuple(d.shape)}, a "
                         f"{tuple(a.shape)}, delta_mask "
                         f"{tuple(delta_mask.shape)}; expected (n, n), "
                         "(n, n), (n,)")
    return n


def _prepass(a: torch.Tensor, delta_mask, pick: bool):
    """The arc-list route's pre-pass: ``(gptr, lists, ccnt, rows,
    n_delta)``, or None where the route cannot take A (n past
    :data:`ARC_MAX_N`, or lists past int32 indexing) or, with ``pick``,
    where :func:`arcs_pay` says no once A's live entries are counted.
    ``gptr``/``lists`` are :func:`column_lists`'s, ``ccnt`` each column's
    live entries (int32); ``rows[:n_delta]`` are the Δ rows in order (none
    when ``delta_mask`` is None).  On a CUDA tensor three kernels (count,
    column scan, group scan), one sync for the totals, then the fill
    kernel; on a CPU tensor the same arrays by torch indexing."""
    n = a.shape[0]
    groups = -(-n // 32)
    if n > ARC_MAX_N:
        return None
    if not build.on_card("relax_step a", a):
        live = a != float("inf")
        if pick and not arcs_pay(n, int(live.sum())):
            return None
        j, k = torch.nonzero(live.T, as_tuple=True)  # by column, then k
        cnt = torch.bincount(j, minlength=groups * 32)
        glen = cnt.view(groups, 32).amax(1)
        gptr = torch.zeros(groups + 1, dtype=torch.int64)
        gptr[1:] = torch.cumsum(32 * glen, 0)
        t = torch.arange(len(j)) - (torch.cumsum(cnt, 0) - cnt)[j]
        lists = torch.full((int(gptr[-1]),), _PAD, dtype=torch.int64)
        lists = lists.view(torch.int32).view(-1, 2)
        lists[gptr[j // 32] + 32 * t + j % 32] = torch.stack(
            [k.int(), a[k, j].view(torch.int32)], 1)
        rows = torch.zeros(0, dtype=torch.int32) if delta_mask is None \
            else torch.nonzero(delta_mask).flatten().int()
        return gptr.int(), lists, cnt[:n].int(), rows, len(rows)
    build.require("relax_step a", a, torch.float32, 2)
    dev, i32 = a.device, dict(dtype=torch.int32, device=a.device)
    chunks, parts = -(-n // CSC_ROWS), -(-n // 1024)
    bits = torch.empty((groups, -(-n // 8) * 8), **i32)
    cnt = torch.empty((chunks, n), **i32)
    off = torch.empty((chunks, n), **i32)
    ccnt = torch.empty(n, **i32)
    glen = torch.empty(groups, **i32)
    part = torch.empty(parts, dtype=torch.int64, device=dev)
    gptr = torch.empty(groups + 1, **i32)
    rows = torch.empty(n, **i32)
    totals = torch.empty(3, dtype=torch.int64, device=dev)
    lib = build.load("relax", _PROTOTYPES)
    with torch.cuda.device(dev):
        stream = build.stream_handle(a)
        build.check(lib, lib.repro_relax_csc_scan(
            a.data_ptr(), n,
            delta_mask.data_ptr() if delta_mask is not None else None,
            bits.data_ptr(), cnt.data_ptr(), off.data_ptr(), ccnt.data_ptr(),
            glen.data_ptr(), part.data_ptr(), gptr.data_ptr(),
            rows.data_ptr(), totals.data_ptr(), stream),
            "relax_step column lists")
        entries, live, n_delta = totals.tolist()  # the one sync
        if (pick and not arcs_pay(n, live)) or entries >= 2 ** 31:
            return None
        lists = torch.full((entries,), _PAD, dtype=torch.int64, device=dev)
        lists = lists.view(torch.int32).view(-1, 2)
        build.check(lib, lib.repro_relax_csc_fill(
            a.data_ptr(), n, bits.data_ptr(), off.data_ptr(),
            gptr.data_ptr(), lists.data_ptr(), stream),
            "relax_step column lists")
    return gptr, lists, ccnt, rows, n_delta


def column_lists(a: torch.Tensor):
    """A's column lists, the arc-list route's pre-pass: ``(gptr, lists)``
    (None past :data:`ARC_MAX_N`).  Columns go in groups of 32: group g's
    block is ``lists[gptr[g]:gptr[g + 1]]``, an (L_g, 32) array of int32
    pairs whose row t holds the t-th live entry (not +inf) of each of its
    columns, ``(k, the f32 bits of a[k, j])``, in ascending k, and ``(0,
    +inf)`` past a column's last (L_g: the group's longest column).  So a
    warp of 32 columns reads its t-th entries in one coalesced load.  On a
    CUDA tensor the pre-pass kernels; on a CPU tensor the same arrays by
    torch indexing."""
    pre = _prepass(a, None, pick=False)
    return None if pre is None else pre[:2]


def arcs_in_kernel_order(d: torch.Tensor, a: torch.Tensor,
                         delta_mask: torch.Tensor) -> tuple:
    """The arc-list route in PyTorch: A's :func:`column_lists`, then each Δ
    row's column j the min over j's slots, pads included, of ``d[m, k] +
    w`` (one f32 add each, as the kernel rounds it), merged with d; rows
    outside Δ keep d.  Returns ``(d', changed)``, equal to :data:`plain`'s
    (no -inf in d: a pad would add it to +inf)."""
    n = d.shape[0]
    gptr, lists = column_lists(a)
    size = (gptr[1:] - gptr[:-1]).long()
    g = torch.repeat_interleave(torch.arange(len(size), device=d.device),
                                size)
    col = 32 * g + (torch.arange(len(g), device=d.device)
                    - gptr[:-1].long()[g]) % 32
    keep = col < n
    col, k = col[keep], lists[keep, 0].long()
    w = lists[keep, 1].view(torch.float32)
    rows = torch.nonzero(delta_mask).flatten()
    u = torch.full((len(rows), n), float("inf"), device=d.device)
    for r0 in range(0, len(rows), 64):  # bounds the (rows, slots) candidates
        cand = d[rows[r0:r0 + 64]][:, k] + w
        u[r0:r0 + 64].scatter_reduce_(1, col.expand(len(cand), -1), cand,
                                      "amin")
    out = d.clone()
    out[rows] = torch.minimum(d[rows], u)
    return out, (out < d).any(1)


def _arcs(d, delta_mask, pre):
    """Launch the arc-list route's main pass over a :func:`_prepass`."""
    gptr, lists, ccnt, rows, n_delta = pre
    n = d.shape[0]
    dnew = torch.empty_like(d)
    # zeroed before the launch: blocks only ever store a 1 into it
    changed = torch.zeros(n, dtype=torch.uint8, device=d.device)
    lib = build.load("relax", _PROTOTYPES)
    with torch.cuda.device(d.device):
        rc = lib.repro_relax_arcs(d.data_ptr(), gptr.data_ptr(),
                                  ccnt.data_ptr(), lists.data_ptr(),
                                  rows.data_ptr(), n_delta,
                                  delta_mask.data_ptr(), dnew.data_ptr(),
                                  changed.data_ptr(), n,
                                  build.sm_count(d.device),
                                  build.stream_handle(d))
    build.check(lib, rc, "relax_step")
    build.LAUNCHES["relax_step"] += 1
    return dnew, changed.view(torch.bool)


def relax_arcs(d: torch.Tensor, a: torch.Tensor, delta_mask: torch.Tensor):
    """K8 by the arc-list route, ``(d_new, changed_rows)``, whatever A's
    density.  Counted as ``relax_step``."""
    if not build.on_card("relax_step", d, a, delta_mask):
        return plain(d, a, delta_mask)
    n = _checked(d, a, delta_mask)
    pre = _prepass(a, delta_mask, pick=False)
    if pre is None:
        raise ValueError(f"relax_step: n = {n} > {ARC_MAX_N} or A's lists "
                         "pass int32 indexing: the arc-list route cannot "
                         "take it")
    return _arcs(d, delta_mask, pre)


def relax_tiled(d: torch.Tensor, a: torch.Tensor, delta_mask: torch.Tensor):
    """K8 by the tiled route, ``(d_new, changed_rows)``.  Counted as
    ``relax_step_tiled``."""
    if not build.on_card("relax_step", d, a, delta_mask):
        return plain(d, a, delta_mask)
    n = _checked(d, a, delta_mask)
    dnew = torch.empty_like(d)
    # zeroed before the launch: blocks only ever store a 1 into it
    changed = torch.zeros(n, dtype=torch.uint8, device=d.device)
    lib = build.load("relax", _PROTOTYPES)
    with torch.cuda.device(d.device):
        rc = lib.repro_relax_step(d.data_ptr(), a.data_ptr(),
                                  delta_mask.data_ptr(), dnew.data_ptr(),
                                  changed.data_ptr(), n,
                                  build.stream_handle(d))
    build.check(lib, rc, "relax_step")
    build.LAUNCHES["relax_step_tiled"] += 1
    return dnew, changed.view(torch.bool)


def relax_step(d: torch.Tensor, a: torch.Tensor, delta_mask: torch.Tensor, *,
               bm: int = DEFAULT_BM, bn: int = DEFAULT_BN,
               bk: int = DEFAULT_BK):
    """One fused semi-naive iteration.  Returns ``(d_new, changed_rows)``.

    d: (n, n) f32 distances (+inf = no fact); a: (n, n) f32 arc matrix;
    delta_mask: (n,) bool, the rows that changed last iteration.  d_new is
    a new tensor (it never aliases ``d``) and changed_rows an (n,) bool.

    On the card the arc-list route runs where :func:`arcs_pay` (its
    pre-pass counts A's live entries first, and the count decides), else
    the tiled route.  ``bm``, ``bn`` and ``bk`` are the JAX kernel's block
    sizes, accepted so that one kwargs dict drives both packages; they do
    not change the result.  Both routes mask a ragged n, where the JAX
    kernel asserts that n divides the blocks.
    """
    del bm, bn, bk
    if not build.on_card("relax_step", d, a, delta_mask):
        return plain(d, a, delta_mask)
    _checked(d, a, delta_mask)
    pre = _prepass(a, delta_mask, pick=True)
    if pre is None:
        return relax_tiled(d, a, delta_mask)
    return _arcs(d, delta_mask, pre)
