"""K8 — the fused semi-naive relaxation step, a CUDA kernel for Hopper.

Replaces the Pallas kernel ``repro.kernels.relax.relax_step``: one
iteration of the PreM-optimised shortest-path program,

    U  = Δ-masked D ⊗_min,+ A        (the recursive rule's join + is_min)
    D' = min(D, U)                    (merge into `all`)
    δ  = any(D' < D, per row)         (the new delta frontier)

in one pass (``csrc/relax.cu``): the Δ mask is applied while the left tile
is loaded, and the merge and the per-row flags run in the epilogue while the
output tile is still in registers.

On CPU tensors the wrapper runs the plain version (:data:`plain`); on CUDA
tensors it launches the kernel or raises.
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

_VP, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {"repro_relax_step": [_VP, _VP, _VP, _VP, _VP, _I, _VP]}


def relax_step(d: torch.Tensor, a: torch.Tensor, delta_mask: torch.Tensor, *,
               bm: int = DEFAULT_BM, bn: int = DEFAULT_BN,
               bk: int = DEFAULT_BK):
    """One fused semi-naive iteration.  Returns ``(d_new, changed_rows)``.

    d: (n, n) f32 distances (+inf = no fact); a: (n, n) f32 arc matrix;
    delta_mask: (n,) bool, the rows that changed last iteration.  d_new is
    a new tensor (it never aliases ``d``) and changed_rows an (n,) bool.

    ``bm``, ``bn`` and ``bk`` are the JAX kernel's block sizes, accepted so
    that one kwargs dict drives both packages; they do not change the
    result.  The Hopper kernel keeps its own tile (64 x 128 outputs,
    32-deep K stages) and masks a ragged n, where the JAX kernel asserts
    that n divides the blocks.
    """
    del bm, bn, bk
    if not build.on_card("relax_step", d, a, delta_mask):
        return plain(d, a, delta_mask)
    build.require("relax_step d", d, torch.float32, 2)
    build.require("relax_step a", a, torch.float32, 2)
    build.require("relax_step delta_mask", delta_mask, torch.bool, 1)
    n = d.shape[0]
    if d.shape != (n, n) or a.shape != (n, n) or delta_mask.shape != (n,):
        raise ValueError(f"relax_step: d {tuple(d.shape)}, a "
                         f"{tuple(a.shape)}, delta_mask "
                         f"{tuple(delta_mask.shape)}; expected (n, n), "
                         "(n, n), (n,)")
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
    build.LAUNCHES["relax_step"] += 1
    return dnew, changed.view(torch.bool)
