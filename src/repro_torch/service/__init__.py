"""Query serving over the port's carriers.

``DatalogService`` (``session.py``) loads a program + EDB once and answers
query streams with memoized plans, one frontier fixpoint per batch
(``batch.py``), an LRU result cache (``cache.py``) and monotone EDB appends
that resume cached fixpoints (``incremental.py``).
``AsyncDatalogService`` (``admission.py``) puts a continuous-batching
admission front-end over it: callers submit single queries and get futures
while a dispatcher coalesces arrivals into batched fixpoints, overlapping
one batch's host work with the next one's fixpoint on the card.

Observability (``repro_torch.obs``) threads through the stack:
``DatalogService(tracer=True)`` records Chrome-exportable spans,
``svc.metrics`` is the unified counter/histogram registry, ``probe=True``
surfaces per-iteration fixpoint Δs, and ``explain()["kernels"]`` reports
roofline attribution.  ``MetricsRegistry`` and ``Tracer`` are re-exported
here, as in the JAX package.  ``python -m repro_torch.service.serve`` is the
CLI front-end.

Durability (``durable.py``): ``DatalogService(durable_dir=...)`` logs every
append before it mutates anything, snapshots the serving state through the
background checkpoint writer, and recovers warm (the newest complete
snapshot plus the log's suffix, replayed through the append-resume path),
degrading to older generations and then a cold rebuild on corruption.  Its
files are the JAX package's, so either package recovers the other's.
"""
from ..obs.metrics import MetricsRegistry
from ..obs.trace import Tracer
from .admission import AdmissionStats, AsyncDatalogService, QueueFullError
from .cache import CacheEntry, LRUCache
from .durable import DurabilityManager, WriteAheadLog
from .session import DatalogService, ServiceStats

__all__ = ["AdmissionStats", "AsyncDatalogService", "CacheEntry",
           "DatalogService", "DurabilityManager", "LRUCache",
           "MetricsRegistry", "QueueFullError", "ServiceStats", "Tracer",
           "WriteAheadLog"]
