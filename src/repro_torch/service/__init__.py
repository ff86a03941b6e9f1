"""Query serving over the port's carriers.

``DatalogService`` (``session.py``) loads a program + EDB once and answers
batched single-source queries with one frontier fixpoint per batch
(``batch.py``) and an LRU result cache (``cache.py``).
"""
from .cache import CacheEntry, LRUCache
from .session import DatalogService, ServiceStats

__all__ = ["CacheEntry", "DatalogService", "LRUCache", "ServiceStats"]
