"""K3 / K4 — one CSR frontier step on the bool and min-plus carriers, as
CUDA kernels for Hopper.

Replace the Pallas kernels ``repro.kernels.spmv.csr_bool_spmv`` and
``csr_minplus_spmv`` as the JAX serving path drives them
(``ops._csr_bool_step`` / ``ops._csr_minplus_step``: spine + COO tail).  The
kernels (``csrc/spmv.cu``) compute the same function as a pull over the
CSR's own sliced-ELL segment map: each output ``(b, v)`` ⊕-reduces
``frontier[b, src_idx[p]] ⊗ edge_val[p]`` over v's in-edge positions ``p``,
then over its COO-tail positions.  No atomics; OR and min are
order-independent, so the result is bit-identical to the plain step.

The wrappers take the CSR itself (``csr_bool_step(frontier, csr)``), not the
raw arc triple.  On CPU tensors they run the plain step (:data:`plain_bool`,
:data:`plain_minplus`); on CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

#: the plain PyTorch versions of these kernels
plain_bool = ref.csr_bool_step_ref
plain_minplus = ref.csr_minplus_step_ref

#: positions per warp work item: wider slice rows (power-law hubs) are cut
#: into SEG-position segments, one warp each, then ⊕-reduced
SEG = 1024
#: batch rows per kernel call (lanes own rows lane + 32q, q < 4)
MAX_BATCH = 128

_VP, _I = ctypes.c_void_p, ctypes.c_int
_STEP_ARGS = [_VP, _I, _I, _VP, _VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _I, _VP,
              _VP, _VP, _VP, _VP, _VP, _VP]
_PROTOTYPES = {"repro_csr_bool_step": _STEP_ARGS,
               "repro_csr_minplus_step": _STEP_ARGS}


def _launch(fn: str, counter: str, dtype: torch.dtype, frontier, csr):
    if frontier.ndim not in (1, 2):
        raise ValueError(f"{counter}: frontier must be (n,) or (B, n)")
    f = frontier[None, :] if frontier.ndim == 1 else frontier
    n = csr.n_alloc
    build.require(f"{counter} frontier", f, dtype, 2)
    if f.shape[1] != n:
        raise ValueError(f"{counter}: frontier width {f.shape[1]} != "
                         f"n_alloc {n}")
    for name in ("src_idx", "ell_rank", "tail_src", "tail_ell"):
        t = getattr(csr, name)
        build.require(f"{counter} csr.{name}", t, torch.int32, t.ndim)
    build.require(f"{counter} csr.edge_val", csr.edge_val, dtype, 1)
    build.require(f"{counter} csr.tail_val", csr.tail_val, dtype, 1)
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


def csr_bool_step(frontier: torch.Tensor, csr) -> torch.Tensor:
    """(B, n_alloc) bool ⊗ packed arcs -> (B, n_alloc) bool: segment-OR by
    destination over the spine and the COO tail."""
    if not build.on_card("csr_bool_step", *_operands(frontier, csr)):
        return plain_bool(frontier, csr)
    return _launch("repro_csr_bool_step", "csr_bool_step", torch.bool,
                   frontier, csr)


def csr_minplus_step(frontier: torch.Tensor, csr) -> torch.Tensor:
    """(B, n_alloc) f32 ⊗_min,+ packed arcs -> (B, n_alloc) f32:
    segment-min by destination over the spine and the COO tail."""
    if not build.on_card("csr_minplus_step", *_operands(frontier, csr)):
        return plain_minplus(frontier, csr)
    return _launch("repro_csr_minplus_step", "csr_minplus_step",
                   torch.float32, frontier, csr)
