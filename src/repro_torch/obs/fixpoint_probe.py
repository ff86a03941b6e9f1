"""Opt-in probed fixpoint twins: per-iteration frontier/Δ visibility.

Port of ``repro.obs.fixpoint_probe``.  JAX keeps a probed twin of each
fixpoint because its unprobed fixpoint is a device loop that never reads
back to the host.  Here the unprobed fixpoints (``seminaive.fixpoint_dense``,
``sparse.fixpoint_csr``) are host loops that already read three counters a
step in one device→host transfer (``seminaive.semi_naive_loop``): the rows
still active, the entries the step changed (semi-naive's Δ) and the facts
it produced before dedup.  The probed twins run that same loop, so their
results are bit-identical by construction and probing costs no transfer of
its own: they add the seed and final fact counts, the trace counts and
the ``FixpointProbe`` record.

- **Pure observer.** JAX jits each probed step as an entry point of its
  own, traced once per shape; the port counts those traces under caches of
  the probe's own (``seminaive.note_trace``), so probing never moves the
  unprobed fixpoints' counts and a warm probed batch moves nothing.
- **Δ accounting.** For idempotent carriers (bool) every table entry flips
  zero→one at most once, so ``seed_facts + sum(delta_facts)`` equals the
  closure's fact count.  For min-plus, ``delta_facts`` counts per-iteration
  *improvements* (an entry may improve several times).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from ..core.seminaive import (GEN_DTYPE, GEN_MAX, DenseResult, _ne,
                              _shape_sig, bump_trace_count,  # noqa: F401
                              dense_propagate, note_trace, semi_naive_loop)
from ..core.sparse import (CSRMatrix, _csr_signature,
                           csr_frontier_step)  # noqa: F401

__all__ = ["FixpointProbe", "fixpoint_dense_probed", "fixpoint_csr_probed"]


@dataclasses.dataclass
class FixpointProbe:
    """Per-iteration observations from one probed fixpoint run."""

    repr: str                 # "dense" | "csr"
    iterations: int
    frontier_rows: List[int]  # active (unconverged) rows entering each step
    delta_facts: List[int]    # entries changed by each step (semi-naive Δ)
    generated: List[int]      # pre-dedup facts produced by each step
    seed_facts: int           # non-zero entries in the init frontier
    final_facts: int          # non-zero entries in the fixpoint table

    @property
    def total_delta(self) -> int:
        return sum(self.delta_facts)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _count_facts(sr, x: torch.Tensor, zero: torch.Tensor) -> int:
    return int(_ne(sr, x, zero).sum(dtype=GEN_DTYPE))


def _probed(sr, init: torch.Tensor, max_iters: int, propagate: Callable,
            repr_name: str, trace: Tuple[str, tuple, tuple]
            ) -> Tuple[DenseResult, FixpointProbe]:
    zero = torch.tensor(sr.zero, dtype=init.dtype, device=init.device)
    seed_facts = _count_facts(sr, init, zero)
    res, counts = semi_naive_loop(sr, propagate, init, max_iters)
    if res.iterations:  # JAX traces the probed step at its first call
        note_trace(*trace)
    # the Δ accounting (seed + ΣΔ == final for idempotent carriers) is only
    # meaningful if no per-step counter saturated
    assert all(0 <= g < int(GEN_MAX) and 0 <= d < int(GEN_MAX) for g, d
               in zip(counts.generated, counts.delta_facts)), \
        "fixpoint probe counter saturated GEN_DTYPE"
    assert res.generated < int(GEN_MAX), \
        "fixpoint probe generated-facts total overflows GEN_DTYPE"
    probe = FixpointProbe(
        repr=repr_name, iterations=res.iterations,
        frontier_rows=counts.frontier_rows, delta_facts=counts.delta_facts,
        generated=counts.generated, seed_facts=seed_facts,
        final_facts=_count_facts(sr, res.table, zero))
    return res, probe


def fixpoint_dense_probed(
    sr,
    arc: torch.Tensor,
    init: torch.Tensor,
    form: str = "vector",
    matmul: Optional[Callable] = None,
    max_iters: Optional[int] = None,
) -> Tuple[DenseResult, FixpointProbe]:
    """Probed twin of ``fixpoint_dense_cached`` (vector form only — the
    serving hot path). Returns ``(DenseResult, FixpointProbe)`` with the
    result bit-identical to the unprobed fixpoint."""
    if form != "vector":
        raise NotImplementedError(
            f"probed fixpoints cover the serving path (form='vector'); "
            f"got form={form!r}")
    if not sr.idempotent:
        raise NotImplementedError(
            f"the probed twins replicate the masked vector form; the "
            f"additive {sr.name} carrier runs the accumulate form unprobed")
    if max_iters is None:
        max_iters = 4 * init.shape[-1] + 8
    trace = ("probe_dense", (sr.name, matmul),
             (_shape_sig(arc), _shape_sig(init)))
    return _probed(sr, init, max_iters,
                        dense_propagate(sr, arc, "vector", matmul), "dense",
                        trace)


def fixpoint_csr_probed(
    csr: CSRMatrix,
    init: torch.Tensor,
    spmv: Optional[Callable] = None,
    max_iters: Optional[int] = None,
) -> Tuple[DenseResult, FixpointProbe]:
    """Probed twin of ``fixpoint_csr_cached``; result bit-identical."""
    if not csr.semiring.idempotent:
        raise NotImplementedError(
            f"the probed twins replicate the masked vector form; the "
            f"additive {csr.semiring.name} carrier runs the accumulate "
            f"form unprobed")
    if max_iters is None:
        max_iters = 4 * init.shape[-1] + 8
    trace = ("probe_csr", (spmv,), _csr_signature(csr, init))
    if spmv is None:
        from ..kernels import ops
        spmv = ops.csr_frontier_step(csr.kind)
    return _probed(csr.semiring, init, max_iters,
                        lambda dm, _: spmv(dm, csr), "csr", trace)
