"""Roofline-steered autotuner for the CSR kernel stack: port of
``repro.kernels.autotune``.

A relation's fixpoint cost depends on knobs the engine can only guess at
statically: the sliced-ELL capacity ladder (``ell_cfg``; K4 reads the
ladder's slots in ELL order), the tile-skip plan's block sizes
(``chunk``/``bn``; K7 reads the plan's arcs once each in destination
order, in work units of one ``bn``-column tile, so on the card ``bn``
sets its units and ``chunk`` only which arcs a plan covers) and whether
the tile-skip kernel (K7) beats the untiled step (K4) at all on this
graph.  So it is a measured search:

1. **Seed analytically.**  Every candidate layout's allocated segment slots
   (``e_alloc``) follow from the in-degree histogram alone, and the H100
   roofline model (``obs.roofline_attr``) turns that into a predicted
   per-iteration bound; only the best ``top_k`` (plus the single-width
   baseline) are built.
2. **Measure the shortlist** — and, when kernels are in scope, the best
   layout with each tile-skip block size — by running the real batched
   fixpoint on a seed batch (a warm-up run excluded, the card synchronized
   around each timed run).
3. **Score** by the roofline fraction of useful work; the fastest wins.

A layout whose segment tables and the view its kernel reads
(:func:`layout_bytes`) would not fit a quarter of the card's memory
(``hw.hbm_bytes``; the rest holds the other carriers, the frontier and the
scratch) is never built: on a power-law graph the single-width ladder pads
every vertex to the largest in-degree (2^20 rows of 2^18 slots for the
16M-arc smoke graph, a terabyte).  The gain is then measured against the
library's default layout instead of the single-width one.  On graphs where
every candidate fits the search is the JAX package's, candidate for
candidate.

Kernel candidates enter the search only when the search runs on a CUDA
device (``include_kernels=None``): on the CPU every candidate runs the
plain PyTorch steps, whose times say nothing about the kernels.  Results
cache per (graph-shape, kind) signature, so a tail-fold rebuild of a
stable shape class reuses its config.  Pin a config
(``DatalogService(tune=KernelConfig(...))``) to skip measuring.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core import sparse as _sparse
from ..core.seminaive import quantize_ladder, quantize_rows
from ..device import resolve_device
from ..obs.roofline_attr import (achieved_fractions, csr_launch_cost,
                                 predicted_seconds)
from ..roofline.report import H100

__all__ = ["KernelConfig", "TuneResult", "autotune", "build_tuned",
           "graph_signature", "clear_cache", "DEFAULT_SLICE_CANDIDATES"]


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One point in the tuning space (frozen, hashable: a pinned config)."""

    slice_floor: int = 1  # sliced-ELL ladder floor (ell_cfg[0])
    slice_stride: int = 1  # ladder stride; 0 = single-width legacy ELL
    chunk: int = 32  # tile-skip plan: arcs per chunk
    bn: int = 128  # tile-skip plan: columns per tile
    use_kernel: bool = False  # build the plan: min-plus steps run K7

    @property
    def ell_cfg(self) -> tuple:
        return (self.slice_floor, self.slice_stride)

    @property
    def kernel_plan(self) -> tuple | None:
        return (self.chunk, self.bn) if self.use_kernel else None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


#: the legacy layout — the measured baseline every gain is relative to
SINGLE_WIDTH = KernelConfig(slice_floor=1, slice_stride=0)

#: slice ladders worth trying: pure power-of-two classes, coarser strides
#: (fewer slices, more within-slice pad), higher floors (fewer tiny slices)
DEFAULT_SLICE_CANDIDATES = ((1, 1), (2, 1), (8, 1), (4, 2), (1, 0))

#: tile-skip block sizes tried when kernel candidates are in scope
DEFAULT_BLOCK_CANDIDATES = ((32, 128), (64, 128), (32, 256))


@dataclasses.dataclass
class TuneResult:
    config: KernelConfig
    gain: float  # baseline_seconds / best_seconds (>= 1 when tuning won);
    #              the baseline is SINGLE_WIDTH, or the default layout where
    #              single width does not fit the card
    baseline_seconds: float
    best_seconds: float
    frac_peak_flops: float  # achieved fraction of peak for USEFUL work
    frac_peak_bw: float
    signature: tuple
    candidates: list  # [{config, predicted_s, measured_s | None}, ...]
    cached: bool = False

    def as_dict(self) -> dict:
        return {"config": self.config.as_dict(), "gain": self.gain,
                "baseline_seconds": self.baseline_seconds,
                "best_seconds": self.best_seconds,
                "frac_peak_flops": self.frac_peak_flops,
                "frac_peak_bw": self.frac_peak_bw,
                "signature": list(self.signature), "cached": self.cached,
                "candidates": [
                    {"config": c["config"].as_dict(),
                     "predicted_s": c["predicted_s"],
                     "measured_s": c["measured_s"]}
                    for c in self.candidates]}


_CACHE: dict[tuple, TuneResult] = {}


def clear_cache() -> None:
    _CACHE.clear()


def build_tuned(edges: np.ndarray, n_alloc: int, kind: str,
                cfg: KernelConfig, tail_min: int = 8,
                device=None) -> "_sparse.CSRMatrix":
    """``build_csr`` with a config's layout and tile-skip plan applied."""
    return _sparse.build_csr(edges, n_alloc, kind, tail_min=tail_min,
                             ell_cfg=cfg.ell_cfg,
                             kernel_plan=cfg.kernel_plan, device=device)


def _indegree(edges: np.ndarray, n_alloc: int) -> np.ndarray:
    if len(edges) == 0:
        return np.zeros(n_alloc, np.int64)
    return np.bincount(edges[:, 1].astype(np.int64), minlength=n_alloc)


def graph_signature(edges: np.ndarray, n_alloc: int, kind: str) -> tuple:
    """The tuning-cache key: a degree-profile shape class, not the graph —
    the edge-count bucket (the CSR capacity), the max-in-degree bucket and
    a heavy-tail flag (max > 8x mean)."""
    m = len(edges)
    indeg = _indegree(edges, n_alloc)
    max_d = int(indeg.max()) if m else 0
    mean_d = m / max(int((indeg > 0).sum()), 1)
    heavy = max_d > 8 * max(mean_d, 1.0)
    return (kind, n_alloc, quantize_rows(m + 1),
            quantize_rows(max_d, minimum=1), bool(heavy))


def _predicted_e_alloc(indeg: np.ndarray, ell_cfg: tuple) -> int:
    """A candidate ladder's allocated spine slots, from the histogram alone
    (mirrors ``core.sparse._sliced_ell_index`` without building tables)."""
    floor, stride = ell_cfg
    live = indeg[indeg > 0]
    max_d = int(live.max()) if len(live) else 0
    caps = np.asarray(quantize_ladder(floor, stride, max_d), np.int64)
    if not len(live):
        return int(caps[0])
    which = np.searchsorted(caps, live, side="left")
    counts = np.bincount(which, minlength=len(caps))
    counts[0] += 1  # the shared sentinel row
    return int((counts * caps).sum())


def layout_bytes(kind: str, cfg: KernelConfig, indeg: np.ndarray,
                 m: int) -> int:
    """The device bytes a candidate's tables take while they are built: the
    slice map (4 a slot) and the one view its step reads
    (``core.sparse._with_views``).  For a planned min-plus CSR that is
    K7's arcs, 12 bytes each beside the build's int64 positions, keys and
    order (24 more); otherwise the ELL order, 4 bytes a slot (bool) or 8
    (a source and a value), twice over while its pieces are concatenated."""
    slots = _predicted_e_alloc(indeg, cfg.ell_cfg)
    if cfg.use_kernel and kind == "minplus":
        return 4 * slots + 36 * m
    return 4 * slots + 2 * (4 if kind == "bool" else 8) * slots


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measure_fixpoint(csr, srcs, repeats: int = 3) -> float:
    """Median seconds of one batched fixpoint from its seed rows, the card
    synchronized before and after each run; a warm-up run (kernel build and
    load, allocator growth) is excluded."""
    init = _sparse.rows_from_sources(csr, srcs)
    _sparse.fixpoint_csr_cached(csr, init)
    ts = []
    for _ in range(repeats):
        _sync(csr.device)
        t0 = time.perf_counter()
        _sparse.fixpoint_csr_cached(csr, init)
        _sync(csr.device)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def autotune(edges: np.ndarray, n_alloc: int, kind: str, *, batch: int = 8,
             top_k: int = 2, include_kernels: Optional[bool] = None,
             slice_candidates: tuple = DEFAULT_SLICE_CANDIDATES,
             block_candidates: tuple = DEFAULT_BLOCK_CANDIDATES,
             hw=H100, use_cache: bool = True, device=None) -> TuneResult:
    """Pick a :class:`KernelConfig` for one relation by measured search on
    ``device`` (``None``: the card).

    ``include_kernels=None`` lets tile-skip candidates in only on a CUDA
    device; ``batch`` sizes the seed frontier the finalists are timed with.
    """
    device = resolve_device(device)
    edges = np.asarray(edges, np.int64).reshape(-1, 2 if kind == "bool" else 3)
    sig = graph_signature(edges, n_alloc, kind)
    if use_cache and sig in _CACHE:
        return dataclasses.replace(_CACHE[sig], cached=True)
    if include_kernels is None:
        include_kernels = device.type == "cuda"
    indeg = _indegree(edges, n_alloc)
    m = len(edges)
    itemsize = 1 if kind == "bool" else 4
    B = max(batch, 1)

    # -- 1. analytic seed: rank every layout by its roofline lower bound ----
    ranked = []
    for ell_cfg in slice_candidates:
        e_alloc = _predicted_e_alloc(indeg, ell_cfg)
        cost = csr_launch_cost(B, n_alloc, e_alloc, itemsize, iters=1)
        base = KernelConfig(slice_floor=ell_cfg[0], slice_stride=ell_cfg[1])
        ranked.append((predicted_seconds(cost, hw), base))
    ranked.sort(key=lambda t: t[0])

    def fits(cfg):
        return layout_bytes(kind, cfg, indeg, m) <= hw.hbm_bytes / 4

    shortlist = [cfg for _, cfg in ranked[:top_k] if fits(cfg)]
    baseline_cfg = SINGLE_WIDTH if fits(SINGLE_WIDTH) else KernelConfig()
    if baseline_cfg not in shortlist:
        shortlist.append(baseline_cfg)  # the gain denominator always runs
    if include_kernels:
        shortlist += [cfg for cfg in (
            dataclasses.replace(shortlist[0], use_kernel=True, chunk=c, bn=b)
            for c, b in block_candidates) if fits(cfg)]
    predicted = {cfg: p for p, cfg in ranked}

    # -- 2./3. measure the shortlist, score by useful-work roofline fraction
    srcs = (np.arange(B) % max(n_alloc, 1)).astype(np.int64)
    useful = csr_launch_cost(B, n_alloc, max(m, 1), itemsize, iters=1)
    rows = []
    for cfg in shortlist:
        csr = build_tuned(edges, n_alloc, kind, cfg, device=device)
        secs = _measure_fixpoint(csr, srcs)
        del csr
        rows.append({"config": cfg, "measured_s": secs,
                     "predicted_s": predicted.get(cfg)})
    for _, cfg in ranked[top_k:]:  # report the pruned tail too
        if all(r["config"] != cfg for r in rows):
            rows.append({"config": cfg, "measured_s": None,
                         "predicted_s": predicted.get(cfg)})
    measured = [r for r in rows if r["measured_s"] is not None]
    best = min(measured, key=lambda r: r["measured_s"])
    baseline = next(r for r in measured if r["config"] == baseline_cfg)
    fr = achieved_fractions(useful, best["measured_s"], hw)
    res = TuneResult(
        config=best["config"],
        gain=baseline["measured_s"] / max(best["measured_s"], 1e-12),
        baseline_seconds=baseline["measured_s"],
        best_seconds=best["measured_s"],
        frac_peak_flops=fr["frac_peak_flops"],
        frac_peak_bw=fr["frac_peak_bw"],
        signature=sig, candidates=rows)
    if use_cache:
        _CACHE[sig] = res
    return res
