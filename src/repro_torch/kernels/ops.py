"""Dispatch for the kernel-backed carriers, and the launch counters.

Every entry returned here routes by device: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the CUDA kernel (or the
call raises).  Carriers whose kernels are not ported yet (max-plus,
plus-times) raise ``NotImplementedError`` on every device.
"""
from __future__ import annotations

from . import build
from .boolmm import bool_frontier_matmul
from .minplus import minplus_frontier_matmul
from .spmv import csr_bool_step, csr_minplus_step


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


def frontier_matmul(name: str):
    """Kernel-backed ⊗ of the dense fixpoints (semiring name): the batched
    (B, n) frontier product of the serving layer."""
    if name == "bool":
        return bool_frontier_matmul
    if name == "min_plus":
        return minplus_frontier_matmul
    if name in ("max_plus", "plus_times"):
        _not_ported(f"the dense {name} frontier product", "A.1")
    raise KeyError(name)


def csr_frontier_step(kind: str):
    """Kernel-backed segment-semiring step for the sparse engine (``kind``
    is the CSR carrier: 'bool' | 'minplus')."""
    if kind == "bool":
        return csr_bool_step
    if kind == "minplus":
        return csr_minplus_step
    if kind in ("maxplus", "plustimes"):
        _not_ported(f"the {kind} CSR step", "A.1")
    raise KeyError(kind)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(build.LAUNCHES)


def reset_launch_counts() -> None:
    for k in build.LAUNCHES:
        build.LAUNCHES[k] = 0
