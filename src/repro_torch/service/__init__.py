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
here, as in the JAX package; its durability (``DurabilityManager``,
``WriteAheadLog``) is not ported yet (ROADMAP A.6e).
"""
from ..obs.metrics import MetricsRegistry
from ..obs.trace import Tracer
from .admission import AdmissionStats, AsyncDatalogService, QueueFullError
from .cache import CacheEntry, LRUCache
from .session import DatalogService, ServiceStats

__all__ = ["AdmissionStats", "AsyncDatalogService", "CacheEntry",
           "DatalogService", "LRUCache", "MetricsRegistry", "QueueFullError",
           "ServiceStats", "Tracer"]
