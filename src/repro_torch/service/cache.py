"""LRU result cache for the query-serving layer.

Entries are whole query answers keyed by the query's constant pattern
(``("tc", 1, None)``).  Two invalidation regimes, both driven by
:meth:`repro.service.session.DatalogService.append`:

* **tuple** entries (answers computed by the PSN engine) are dropped on any
  append — the restricted model may have grown arbitrarily;
* **dense** entries keep the raw closure row of their source alongside the
  formatted answer, so an append *refreshes* them in place: the service
  resumes the fixpoint from the cached rows (``incremental.py``) and calls
  :meth:`LRUCache.replace`, keeping the cache warm across appends instead of
  cold-starting every hot source.

Every entry records the ``epoch`` (append counter) it was computed at —
``assert entry.epoch == service.epoch`` is the staleness invariant.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable


@dataclasses.dataclass
class CacheEntry:
    kind: str  # 'dense' | 'tuple'
    pred: str
    result: Any  # formatted answer: np rows, or (rows, values)
    epoch: int  # service append-epoch the answer is valid for
    src: int | None = None  # dense: the bound pivot (source vertex)
    raw: Any = None  # dense: (n_alloc,) closure row in the semiring carrier
    #: times this entry served a query since it was (re)computed — the
    #: eviction-aware append-resume policy refreshes hot entries and drops
    #: the cold tail instead of paying maintenance for answers nobody asks
    #: for (``DatalogService(resume_min_hits=...)``)
    hits: int = 0

    @property
    def nbytes(self) -> int:
        """Resident bytes: the raw carrier row an append-resume re-enters
        from plus the formatted answer arrays — what the byte-budget resume
        policy (``DatalogService(resume_max_bytes=...)``) charges."""
        total = 0
        if self.raw is not None:
            total += int(getattr(self.raw, "nbytes", 0))
        if self.result is not None:
            arrays = self.result if isinstance(self.result, tuple) \
                else (self.result,)
            total += sum(int(getattr(a, "nbytes", 0)) for a in arrays)
        return total


class LRUCache:
    """Ordered-dict LRU with hit/miss/eviction counters.

    ``capacity <= 0`` disables caching (every ``get`` misses, ``put`` is a
    no-op) so the serving benchmarks can measure uncached throughput through
    the same code path.

    Thread safety: the async front-end's submit-time short-circuit probes
    the cache from *caller* threads while the dispatcher/finalizer mutate
    it, so every method (including the ``hits``/``ent.hits`` bumps that
    used to be bare ``+=``) runs under an internal lock.  The lock never
    calls out while held, so it composes with the service lock in either
    order without deadlock.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._entries: "OrderedDict[Hashable, CacheEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def get(self, key: Hashable) -> CacheEntry | None:
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            ent.hits += 1
            return ent

    def peek(self, key: Hashable) -> CacheEntry | None:
        """Read an entry without touching LRU order or hit/miss counters —
        for maintenance passes (append-resume policy), not serving."""
        with self._lock:
            return self._entries.get(key)

    def get_fresh(self, key: Hashable, epoch: int) -> CacheEntry | None:
        """:meth:`get`, but only when the entry's epoch matches.

        The admission front-end's submit-time short-circuit probes the cache
        from caller threads; unlike the batch path (which *asserts* epoch
        freshness under the fence) a mismatched entry here is simply a miss
        — the query is admitted and recomputed at the current epoch."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None or ent.epoch != epoch:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            ent.hits += 1
            return ent

    def put(self, key: Hashable, entry: CacheEntry) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
            self._entries[key] = entry
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1

    def replace(self, key: Hashable, entry: CacheEntry) -> None:
        """Refresh an entry in place without bumping its LRU position —
        append-driven refreshes are maintenance, not access recency."""
        with self._lock:
            if key in self._entries:
                self._entries[key] = entry

    def drop_where(self, pred: Callable[[Hashable, CacheEntry], bool]) -> int:
        with self._lock:
            stale = [k for k, e in self._entries.items() if pred(k, e)]
            for k in stale:
                del self._entries[k]
            return len(stale)

    def items(self) -> list[tuple[Hashable, CacheEntry]]:
        with self._lock:
            return list(self._entries.items())

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
