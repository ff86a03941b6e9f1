"""Analytic roofline costs of serving-path fixpoints, scored against the
H100 model (``repro_torch.roofline.report.H100``).

Port of the cost functions of ``repro.obs.roofline_attr`` (the same
formulas, so both packages rank layouts alike given the same ``HW``) and
its ``KernelAttribution`` accumulator, which the service feeds one record
per batched fixpoint: the analytic cost of the padded batch and the device
wall time of its launch (two CUDA events around the fixpoint; the host
loop syncs every iteration, so the gaps where the card waits for it are
counted too, and the time is not kernel time alone).

Per fixpoint *iteration* (B = padded batch rows, n = padded domain,
e = allocated packed-arc slots incl. ELL padding):

- ``frontier_matmul`` (dense vector form): ``2·B·n²`` flops; bytes = arc
  matrix + frontier read + write.
- ``csr_spmv`` (segment step): ``2·B·e`` flops; bytes = arc arrays
  (src/val/ell) + frontier traffic + gathered contributions.

These are *model* flops (useful work at the semiring level).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict

from ..roofline.report import H100, HW

__all__ = ["KernelAttribution", "dense_launch_cost", "csr_launch_cost",
           "predicted_seconds", "achieved_fractions"]


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


@dataclasses.dataclass
class _KernelTally:
    launches: int = 0
    iterations: int = 0
    seconds: float = 0.0
    flops: float = 0.0
    bytes: float = 0.0


class KernelAttribution:
    """Thread-safe accumulator of per-kernel launch costs + timings."""

    def __init__(self, hw: HW = H100):
        self.hw = hw
        self._lock = threading.Lock()
        self._tallies: Dict[str, _KernelTally] = {}

    def record(self, kernel: str, *, seconds: float, iterations: int,
               flops: float, bytes: float) -> None:
        """One launch: analytic cost + measured device time."""
        with self._lock:
            t = self._tallies.get(kernel)
            if t is None:
                t = self._tallies[kernel] = _KernelTally()
            t.launches += 1
            t.iterations += iterations
            t.seconds += seconds
            t.flops += flops
            t.bytes += bytes

    def report(self) -> Dict[str, Dict[str, Any]]:
        """Per-kernel achieved-vs-peak summary for ``explain()``."""
        with self._lock:
            tallies = {k: dataclasses.replace(t)
                       for k, t in self._tallies.items()}
        out: Dict[str, Dict[str, Any]] = {}
        for name, t in sorted(tallies.items()):
            secs = max(t.seconds, 1e-12)
            ach_flops = t.flops / secs
            ach_bw = t.bytes / secs
            compute_s = t.flops / self.hw.peak_flops
            memory_s = t.bytes / self.hw.hbm_bw
            out[name] = {
                "launches": t.launches,
                "iterations": t.iterations,
                "seconds": t.seconds,
                "model_flops": t.flops,
                "model_bytes": t.bytes,
                "achieved_flops_per_s": ach_flops,
                "achieved_bytes_per_s": ach_bw,
                "frac_peak_flops": ach_flops / self.hw.peak_flops,
                "frac_peak_bw": ach_bw / self.hw.hbm_bw,
                "dominant": "compute" if compute_s >= memory_s else "memory",
            }
        return out

    def clear(self) -> None:
        with self._lock:
            self._tallies.clear()
