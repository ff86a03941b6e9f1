"""Plain PyTorch versions of the four CUDA kernels: the CPU path and the
oracles the kernels are held to on the card (exact equality)."""
from __future__ import annotations

import torch

from ..core.semiring import BOOL, MIN_PLUS
from ..core.sparse import csr_frontier_min, csr_frontier_or


def boolmm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) bool ⊗_bool (k, n) bool -> (m, n) bool, as an f32 product
    with a ``> 0`` epilogue (exact: 0/1 sums stay below 2^24)."""
    return BOOL.matmul(a, b)


def minplus_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) ⊗_min,+ (k, n) -> (m, n) in f32; +inf means "no fact".  K is
    streamed in chunks so the (m, k, n) broadcast never materializes."""
    return MIN_PLUS.matmul(a.to(torch.float32), b.to(torch.float32))


#: one CSR frontier step on the bool / min-plus carriers (spine + COO tail)
csr_bool_step_ref = csr_frontier_or
csr_minplus_step_ref = csr_frontier_min
