"""Analytic roofline costs of serving-path fixpoints, scored against the
H100 model (``repro_torch.roofline.report.H100``).

Port of the cost functions of ``repro.obs.roofline_attr`` (the same
formulas, so both packages rank layouts alike given the same ``HW``); its
``KernelAttribution`` accumulator comes with the service's observability.

Per fixpoint *iteration* (B = padded batch rows, n = padded domain,
e = allocated packed-arc slots incl. ELL padding):

- ``frontier_matmul`` (dense vector form): ``2·B·n²`` flops; bytes = arc
  matrix + frontier read + write.
- ``csr_spmv`` (segment step): ``2·B·e`` flops; bytes = arc arrays
  (src/val/ell) + frontier traffic + gathered contributions.

These are *model* flops (useful work at the semiring level).
"""
from __future__ import annotations

from typing import Dict

from ..roofline.report import H100, HW

__all__ = ["dense_launch_cost", "csr_launch_cost", "predicted_seconds",
           "achieved_fractions"]


def dense_launch_cost(B: int, n: int, itemsize: int, iters: int
                      ) -> Dict[str, float]:
    """Flops/bytes for a dense vector-form fixpoint: ``iters`` (B,n)x(n,n)
    semiring products against a resident arc matrix."""
    flops_per_iter = 2.0 * B * n * n
    bytes_per_iter = itemsize * (n * n + 2.0 * B * n)  # arc + read + write
    return {"flops": flops_per_iter * iters, "bytes": bytes_per_iter * iters}


def csr_launch_cost(B: int, n_alloc: int, e_alloc: int, itemsize: int,
                    iters: int) -> Dict[str, float]:
    """Flops/bytes for a CSR segment-step fixpoint: ``iters`` gather +
    segment-⊕ passes over ``e_alloc`` packed arc slots (ELL + COO tail)."""
    flops_per_iter = 2.0 * B * e_alloc
    bytes_per_iter = (
        e_alloc * (4 + itemsize + 4)        # src_idx + edge_val + ell_idx
        + itemsize * 2.0 * B * n_alloc      # frontier read + write
        + itemsize * B * e_alloc            # gathered contributions
    )
    return {"flops": flops_per_iter * iters, "bytes": bytes_per_iter * iters}


def predicted_seconds(cost: Dict[str, float], hw: HW = H100) -> float:
    """Roofline lower bound for an analytic cost: the slower of its compute
    and memory terms (the autotuner's analytic seed)."""
    return max(cost["flops"] / hw.peak_flops, cost["bytes"] / hw.hbm_bw)


def achieved_fractions(cost: Dict[str, float], seconds: float,
                       hw: HW = H100) -> Dict[str, float]:
    """Achieved-vs-peak fractions for a measured run of an analytic cost —
    the autotuner's score (``cost`` holds *useful* work)."""
    secs = max(seconds, 1e-12)
    return {"frac_peak_flops": cost["flops"] / secs / hw.peak_flops,
            "frac_peak_bw": cost["bytes"] / secs / hw.hbm_bw}
