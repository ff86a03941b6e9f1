"""Packed tuple tables over torch tensors: the tuple engine's relational
substrate, ported from ``repro.core.relation``.

A tuple is bit-packed into one int64 key, column 0 in the high bits, so the
key order is the lexicographic tuple order and set algebra (union,
difference, dedup, membership) becomes sort + ``searchsorted``.

Two table kinds:

``FactTable``  -- a *set* of tuples (a Datalog relation).
``AggTable``   -- a *map* group-key -> aggregate value with a lattice merge
                  (min / max / sum / count): what aggregates in recursion
                  evaluate into under PreM.

The JAX package pads every table to its capacity with ``EMPTY`` so that XLA
sees static shapes.  Here a table holds exactly its keys, sorted and
distinct, and keeps ``capacity`` as a number: a transitive closure of 10^8
facts joined at 5 × 10^8 bindings an iteration cannot afford a padded copy
of every table and join.  ``overflow`` is set exactly where the JAX flag is:
a compaction of more distinct keys than the capacity (the table then keeps
its ``capacity`` smallest keys, as JAX's does), and a join whose total
exceeds its output capacity.  ``EMPTY`` keys in an input are dropped, as
the JAX sentinel is.

Values are int32 (``_MERGE_INIT`` holds int32's max and min), and sums wrap
as int32 sums do.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device

EMPTY = torch.iinfo(torch.int64).max  # sentinel key of the JAX layout


# ---------------------------------------------------------------------------
# Bit packing
# ---------------------------------------------------------------------------


def _as_tensor(c, device=None) -> torch.Tensor:
    if isinstance(c, torch.Tensor):
        return c if device is None else c.to(device)
    return torch.as_tensor(np.asarray(c), device=device)


@dataclasses.dataclass(frozen=True)
class Schema:
    """Bit layout of a packed tuple: ``bits[i]`` bits for column i, column 0
    in the high bits, so that the packed int64 order is the lexicographic
    tuple order."""

    bits: tuple[int, ...]

    def __post_init__(self):
        if sum(self.bits) > 62:  # keep sign bit + sentinel headroom
            raise ValueError(f"schema too wide: {self.bits} (> 62 bits)")

    @property
    def arity(self) -> int:
        return len(self.bits)

    @property
    def shifts(self) -> tuple[int, ...]:
        out, acc = [], 0
        for b in reversed(self.bits):
            out.append(acc)
            acc += b
        return tuple(reversed(out))

    def pack(self, cols: Sequence) -> torch.Tensor:
        """Pack per-column int tensors (or arrays) into one int64 key tensor."""
        assert len(cols) == self.arity
        first = _as_tensor(cols[0])
        key = torch.zeros(first.shape, dtype=torch.int64, device=first.device)
        for c, shift in zip(cols, self.shifts):
            key |= _as_tensor(c, first.device).to(torch.int64) << shift
        return key

    def unpack(self, keys: torch.Tensor) -> list[torch.Tensor]:
        """Inverse of :meth:`pack` (int32 columns)."""
        return [((keys >> shift) & ((1 << b) - 1)).to(torch.int32)
                for b, shift in zip(self.bits, self.shifts)]

    def max_values(self) -> tuple[int, ...]:
        return tuple((1 << b) - 1 for b in self.bits)


def default_schema(arity: int, bits: int = 20) -> Schema:
    return Schema(tuple([bits] * arity))


def _rows_to_keys(rows, schema: Schema, device) -> torch.Tensor:
    rows = np.asarray(rows, np.int64).reshape((-1, schema.arity))
    t = torch.from_numpy(rows).to(device)
    return schema.pack([t[:, i] for i in range(schema.arity)])


def _unpack_rows(keys: torch.Tensor, schema: Schema) -> np.ndarray:
    if not keys.numel():
        return np.zeros((0, schema.arity), np.int32)
    return torch.stack(schema.unpack(keys), dim=1).cpu().numpy()


# ---------------------------------------------------------------------------
# Sorted-set helpers
# ---------------------------------------------------------------------------


def sorted_unique(raw: torch.Tensor) -> torch.Tensor:
    """The distinct non-``EMPTY`` keys of ``raw``, ascending."""
    if raw.numel() and bool((raw == EMPTY).any()):
        raw = raw[raw != EMPTY]
    return torch.unique(raw, sorted=True)


def sorted_member(queries: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Membership of each query key in a sorted distinct key tensor."""
    if not table.numel() or not queries.numel():
        return torch.zeros(queries.shape, dtype=torch.bool,
                           device=queries.device)
    idx = torch.searchsorted(table, queries).clamp_(max=table.numel() - 1)
    return (table[idx] == queries) & (queries != EMPTY)


def merge_sorted(a: torch.Tensor, b: torch.Tensor, a_vals=None, b_vals=None):
    """Merge two sorted key tensors with no key in common into one sorted
    tensor (and their values alongside), in linear time."""
    if not b.numel():
        return a, a_vals
    if not a.numel():
        return b, b_vals
    at = torch.searchsorted(a, b) + torch.arange(b.numel(), device=b.device)
    keys = torch.empty(a.numel() + b.numel(), dtype=a.dtype, device=a.device)
    from_a = torch.ones(keys.numel(), dtype=torch.bool, device=a.device)
    from_a[at] = False
    keys[at] = b
    keys[from_a] = a
    if a_vals is None:
        return keys, None
    vals = torch.empty(keys.numel(), dtype=a_vals.dtype, device=a.device)
    vals[at] = b_vals
    vals[from_a] = a_vals
    return keys, vals


# ---------------------------------------------------------------------------
# FactTable -- a set of packed tuples
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FactTable:
    """Sorted distinct packed tuples, at most ``capacity`` of them."""

    keys: torch.Tensor  # (count,) int64, ascending, distinct
    capacity: int
    overflow: bool = False  # a producing op had more tuples than capacity

    @property
    def count(self) -> int:
        return int(self.keys.numel())

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @staticmethod
    def empty(capacity: int, device=None) -> "FactTable":
        return FactTable(torch.zeros((0,), dtype=torch.int64,
                                     device=resolve_device(device)), capacity)

    @staticmethod
    def from_keys(raw: torch.Tensor, capacity: int) -> "FactTable":
        """Build from an unsorted, possibly duplicated key tensor
        (``EMPTY`` = invalid)."""
        return _compact(raw, capacity)

    @staticmethod
    def from_numpy(rows: np.ndarray, schema: Schema, capacity: int,
                   device=None) -> "FactTable":
        return _compact(_rows_to_keys(rows, schema, resolve_device(device)),
                        capacity)

    def to_numpy(self, schema: Schema) -> np.ndarray:
        return _unpack_rows(self.keys, schema)

    # -- set algebra ---------------------------------------------------------

    def union(self, other: "FactTable", capacity: int | None = None) -> "FactTable":
        cap = capacity or max(self.capacity, other.capacity)
        out = _compact(torch.cat([self.keys, other.keys]), cap)
        out.overflow |= self.overflow or other.overflow
        return out

    def difference(self, other: "FactTable") -> "FactTable":
        """self - other."""
        keys = self.keys[~sorted_member(self.keys, other.keys)]
        return FactTable(keys, self.capacity, self.overflow)

    def member(self, keys: torch.Tensor) -> torch.Tensor:
        return sorted_member(keys, self.keys)


def _compact(raw: torch.Tensor, capacity: int) -> FactTable:
    """Sort, dedup and truncate to ``capacity``; ``EMPTY`` entries drop."""
    keys = sorted_unique(raw)
    overflow = keys.numel() > capacity
    return FactTable(keys[:capacity] if overflow else keys, capacity, overflow)


# ---------------------------------------------------------------------------
# AggTable -- group-key -> value map with a lattice merge
# ---------------------------------------------------------------------------

_MERGE_INIT = {
    "min": torch.iinfo(torch.int32).max,
    "max": torch.iinfo(torch.int32).min,
    "sum": 0,
    "count": 0,
}
_REDUCE = {"min": "amin", "max": "amax", "sum": "sum", "count": "sum"}


def _combine(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if kind == "min":
        return torch.minimum(a, b)
    if kind == "max":
        return torch.maximum(a, b)
    if kind in ("sum", "count"):
        return a + b
    raise ValueError(kind)


@dataclasses.dataclass
class AggTable:
    """Sorted distinct packed group keys with their aggregate values.

    ``kind`` is 'min' | 'max' | 'sum' | 'count'.  min/max merges are
    idempotent (a lattice meet/join); sum/count merges add, the paper's
    msum/mcount semantics: a value only moves one way."""

    keys: torch.Tensor  # (count,) int64, ascending, distinct
    values: torch.Tensor  # (count,) int32 -- aggregate totals
    incs: torch.Tensor  # (count,) -- for a delta of an additive kind, the
    # increment this wave contributed; equals ``values`` otherwise
    capacity: int
    overflow: bool = False
    kind: str = "min"

    @property
    def count(self) -> int:
        return int(self.keys.numel())

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @staticmethod
    def empty(capacity: int, kind: str, dtype=torch.int32,
              device=None) -> "AggTable":
        dev = resolve_device(device)
        vals = torch.zeros((0,), dtype=dtype, device=dev)
        return AggTable(torch.zeros((0,), dtype=torch.int64, device=dev),
                        vals, vals, capacity, False, kind)

    @staticmethod
    def from_pairs(keys: torch.Tensor, values: torch.Tensor, capacity: int,
                   kind: str) -> "AggTable":
        """Aggregate raw (key, value) pairs (``EMPTY`` key = invalid)."""
        return _agg_compact(keys, values, capacity, kind)

    @staticmethod
    def from_numpy(rows: np.ndarray, values: np.ndarray, schema: Schema,
                   capacity: int, kind: str, device=None) -> "AggTable":
        dev = resolve_device(device)
        return _agg_compact(_rows_to_keys(rows, schema, dev),
                            _as_tensor(values, dev), capacity, kind)

    def to_numpy(self, schema: Schema) -> tuple[np.ndarray, np.ndarray]:
        return _unpack_rows(self.keys, schema), self.values.cpu().numpy()

    def merge(self, keys: torch.Tensor, values) -> tuple["AggTable", "AggTable"]:
        """Merge raw pairs in; return (new_table, delta_table).

        delta = keys whose aggregate value *changed*, carrying
          * min/max: the new (improved) value;
          * sum/count: the total in ``values`` and the INCREMENT (new - old)
            in ``incs`` -- earlier waves' contributions already propagated,
            so only the increment may flow (else mixed-length path counts
            are billed twice)."""
        uk, uv = _agg_reduce(keys, _as_tensor(values, keys.device).to(
            self.values.dtype), self.kind)
        return self.merge_reduced(uk, uv)

    def merge_reduced(self, uk: torch.Tensor, uv: torch.Tensor
                      ) -> tuple["AggTable", "AggTable"]:
        """:meth:`merge` of pairs already reduced to distinct sorted keys."""
        kind, init = self.kind, _MERGE_INIT[self.kind]
        had, at = _locate(self.keys, uk)
        oldv = torch.where(had, self.values[at] if self.count else uv,
                           torch.full_like(uv, init))
        newv = torch.where(had, _combine(kind, oldv, uv), uv)
        changed = newv != oldv
        n_new = int((~had).sum())
        keys, vals = self.keys, self.values
        if had.any():
            vals = vals.clone()
            vals[at[had]] = newv[had]
        if n_new:
            keys, vals = merge_sorted(keys, uk[~had], vals, newv[~had])
        overflow = keys.numel() > self.capacity
        if overflow:  # JAX's compaction keeps the smallest keys
            keys, vals = keys[:self.capacity], vals[:self.capacity]
        new = AggTable(keys, vals, vals, self.capacity,
                       overflow or self.overflow, kind)
        dtot = newv[changed]
        dinc = dtot - oldv[changed] if kind in ("sum", "count") else dtot
        delta = AggTable(uk[changed], dtot, dinc, self.capacity, False, kind)
        return new, delta

    def lookup(self, keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Return (found, value) for each query key."""
        hit, at = _locate(self.keys, keys)
        init = torch.full(keys.shape, _MERGE_INIT[self.kind],
                          dtype=self.values.dtype, device=keys.device)
        return hit, torch.where(hit, self.values[at], init) \
            if self.count else init


def _locate(table: torch.Tensor, keys: torch.Tensor):
    """(found, index) of each key in a sorted distinct key tensor."""
    if not table.numel():
        z = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
        return z.bool(), z
    at = torch.searchsorted(table, keys).clamp_(max=table.numel() - 1)
    return (table[at] == keys) & (keys != EMPTY), at


def _agg_reduce(keys: torch.Tensor, values: torch.Tensor, kind: str,
                drop_empty: bool = True):
    """⊕-reduce (key, value) pairs to (distinct sorted keys, values);
    ``EMPTY`` keys drop (``drop_empty=False``: the caller has none)."""
    if drop_empty:
        keep = keys != EMPTY
        if not bool(keep.all()):
            keys, values = keys[keep], values[keep]
    uk, inv = torch.unique(keys, sorted=True, return_inverse=True)
    red = torch.zeros(uk.shape, dtype=values.dtype, device=values.device)
    red.scatter_reduce_(0, inv, values, _REDUCE[kind], include_self=False)
    return uk, red


def _agg_compact(keys: torch.Tensor, values: torch.Tensor, capacity: int,
                 kind: str) -> AggTable:
    """Sort by key, ⊕-reduce equal keys, truncate to capacity."""
    uk, uv = _agg_reduce(keys, values, kind)
    overflow = uk.numel() > capacity
    if overflow:
        uk, uv = uk[:capacity], uv[:capacity]
    return AggTable(uk, uv, uv, capacity, overflow, kind)


# ---------------------------------------------------------------------------
# Joins
# ---------------------------------------------------------------------------


def match_ranges(build_sorted: torch.Tensor, lo_keys: torch.Tensor,
                 hi_keys: torch.Tensor | None = None):
    """Per probe: the first build position at or above its ``lo_keys`` and
    the match count, up to ``hi_keys`` (exclusive; ``None``: equal keys)."""
    lo = torch.searchsorted(build_sorted, lo_keys)
    hi = torch.searchsorted(build_sorted, lo_keys, right=True) \
        if hi_keys is None else torch.searchsorted(build_sorted, hi_keys)
    return lo, (hi - lo).clamp_(min=0)


def expand_matches(lo: torch.Tensor, matches: torch.Tensor, total: int):
    """(probe_idx, build_idx) of every match: probe order, then build
    order (the JAX expansion's slot order)."""
    dev = lo.device
    probe_idx = torch.repeat_interleave(
        torch.arange(lo.numel(), device=dev), matches, output_size=total)
    starts = torch.cumsum(matches, 0) - matches
    rank = torch.arange(total, device=dev) - starts[probe_idx]
    return probe_idx, lo[probe_idx] + rank


def expand_join(
    probe_keys: torch.Tensor,
    probe_valid: torch.Tensor,
    build_sorted: torch.Tensor,
    build_count: int,
    out_capacity: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, bool]:
    """Equi-join probe keys against a sorted build key tensor.

    Returns ``(probe_idx, build_idx, valid, overflow)``: every matching
    pair in the JAX expansion's order, cut to ``out_capacity`` pairs, with
    ``overflow`` set when there were more.  ``valid`` is all true (the
    tensors hold only matches; JAX's are padded to ``out_capacity``)."""
    build = build_sorted[:int(build_count)]
    lo, matches = match_ranges(build, probe_keys)
    matches = torch.where(probe_valid, matches, torch.zeros_like(matches))
    total = int(matches.sum())
    pi, bi = expand_matches(lo, matches, total)
    n_out = min(total, out_capacity)
    return (pi[:n_out], bi[:n_out],
            torch.ones(n_out, dtype=torch.bool, device=pi.device),
            total > out_capacity)


#: Fibonacci hashing's multiplier, 11400714819323198485 as a signed int64
#: (an int64 product wraps to the same bits as JAX's uint64 one)
_FIB = 11400714819323198485 - (1 << 64)


def hash32(x: torch.Tensor, n: int) -> torch.Tensor:
    """Deterministic partition hash (Fibonacci hashing) -> [0, n)."""
    h = (x.to(torch.int64) * _FIB) >> 40
    return ((h & ((1 << 24) - 1)) % n).to(torch.int32)
