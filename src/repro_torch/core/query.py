"""Query normalization and row selection, ported from ``repro.core.engine``
(``as_query_literal``, ``repeated_var_groups``, ``query_row_mask``), with
the planner's ``PlanError`` re-exported, and the host-side row-set helpers
the serving layer dedupes and filters with (sorting, never ``np.unique``'s
hash table)."""
from __future__ import annotations

from typing import Union

import numpy as np

from .ir import Const, Literal, Term, Var, fresh_var
from .parser import parse_query
from .planner import PlanError

__all__ = ["PlanError", "QuerySpec", "as_query_literal", "repeated_var_groups",
           "query_row_mask", "row_keys", "sorted_unique", "unique_rows",
           "RowSet", "new_rows", "sorted_contains", "normalize_db"]


QuerySpec = Union[str, Literal, tuple]


def as_query_literal(query: QuerySpec, constants: dict[str, int] | None = None) -> Literal:
    """Normalize the query forms ``"tc(1, X)"`` / ``("tc", (1, None))`` /
    :class:`Literal` into a query goal literal (None/vars = free)."""
    if isinstance(query, Literal):
        return query
    if isinstance(query, str):
        return parse_query(query, constants)
    if isinstance(query, tuple) and len(query) == 2 and isinstance(query[0], str):
        pred, args = query
        terms: list[Term] = []
        for a in args:
            if a is None:
                terms.append(fresh_var("_q"))
            elif isinstance(a, (Var, Const)):
                terms.append(a)
            else:
                terms.append(Const(int(a)))
        return Literal(pred, tuple(terms))
    raise ValueError(f"cannot interpret query spec {query!r}")


def repeated_var_groups(q: Literal) -> list[list[int]]:
    """Argument positions sharing a variable (``tc(X, X)`` -> [[0, 1]])."""
    groups: dict[str, list[int]] = {}
    for i, a in enumerate(q.args):
        if isinstance(a, Var):
            groups.setdefault(a.name, []).append(i)
    return [ps for ps in groups.values() if len(ps) > 1]


def query_row_mask(q: Literal, rows, vals=None, info=None) -> np.ndarray:
    """Row mask restricting an evaluated model to a query goal: constants
    match their column, repeated variables must be pairwise equal.

    The one filtering semantics shared by ``Engine.ask`` (EDB selections),
    the engine's query finalization and verification, and the serving
    layer's templates.  ``info`` (a planner ``PredInfo``) maps aggregate
    literal positions onto key columns / the ``vals`` array; ``info=None``
    treats every position as a direct row column (EDB relations)."""
    def col(pos):
        if info is not None and info.is_agg and pos == info.agg_pos:
            return np.asarray(vals)
        return np.asarray(rows[:, pos if info is None else info.key_rank(pos)])

    mask = np.ones(len(rows), bool)
    for i, a in enumerate(q.args):
        if isinstance(a, Const):
            mask &= col(i) == a.value
    for ps in repeated_var_groups(q):
        for pos in ps[1:]:
            mask &= col(ps[0]) == col(pos)
    return mask


def row_keys(v: np.ndarray, bits: int | None = None) -> np.ndarray | None:
    """One int64 key per row of an (m, c) int64 array of values in
    ``[0, 2**bits)`` (``None``: the width of the largest value), column 0
    most significant, so the key order is the row order; ``None`` when a
    row does not pack into 63 bits or a value is negative."""
    if len(v) and v.min() < 0:
        return None
    if bits is None:
        bits = max(int(v.max()).bit_length(), 1) if len(v) else 1
    c = v.shape[1]
    if c * bits > 63:
        return None
    key = np.zeros(len(v), np.int64)
    for j in range(c):
        key = (key << bits) | v[:, j]
    return key


def sorted_unique(key: np.ndarray) -> np.ndarray:
    """The distinct values of ``key``, sorted: a sort and a neighbour
    compare (not ``np.unique``, slow on numpy 2.3)."""
    key = np.sort(key)
    return key[np.concatenate(([True], key[1:] != key[:-1]))] \
        if len(key) else key


def unique_rows(v: np.ndarray, bits: int | None = None) -> np.ndarray:
    """``np.unique(v, axis=0)`` for an (m, c) int64 array of values below
    ``2**bits`` (``None``: the width of the largest value).  When a row
    packs into one int64 key (:func:`row_keys`) a sort of the keys and a
    neighbour compare give the same array far faster than the row-wise
    sort, and than ``np.unique`` of the keys, which numpy 2.3 computes
    through a hash table."""
    if not len(v):
        return np.unique(v, axis=0)
    if bits is None:
        bits = max(int(v.max()).bit_length(), 1)
    key = row_keys(v, bits)
    if key is None:
        return np.unique(v, axis=0)
    return _unpack(sorted_unique(key), bits, v.shape[1])


def _unpack(key: np.ndarray, bits: int, c: int) -> np.ndarray:
    """The (m, c) rows of :func:`row_keys`' keys."""
    mask = (1 << bits) - 1
    return np.stack([(key >> (bits * (c - 1 - j))) & mask for j in range(c)],
                    axis=1)


class RowSet:
    """A set of (m, c) int64 rows with values below ``2**bits``: the set
    filter of an additive append.  Sorted packed keys (:func:`row_keys`,
    membership by ``np.searchsorted``), or a set of tuples where a row does
    not pack into 63 bits."""

    def __init__(self, rows: np.ndarray, bits: int):
        rows = np.asarray(rows, np.int64)
        self.bits, self.width = bits, rows.shape[1]
        keys = row_keys(rows, bits)
        self.keys = None if keys is None else np.sort(keys)
        self.tuples = None if keys is not None else \
            set(map(tuple, rows.tolist()))

    def _held(self) -> set:
        if self.tuples is None:  # a row to test does not pack: unpack all
            self.tuples = set(map(tuple, _unpack(self.keys, self.bits,
                                                 self.width).tolist()))
            self.keys = None
        return self.tuples

    def new(self, rows: np.ndarray) -> np.ndarray:
        """The distinct rows of ``rows`` the set does not hold, sorted."""
        rows = np.asarray(rows, np.int64).reshape(-1, self.width)
        rows = unique_rows(rows, self.bits) if len(rows) else rows
        keys = None if self.keys is None else row_keys(rows, self.bits)
        if keys is not None:
            return rows[~sorted_contains(self.keys, keys)]
        held = self._held()
        return rows[np.asarray([tuple(r) not in held for r in rows.tolist()],
                               bool).reshape(-1)]

    def add(self, rows: np.ndarray) -> None:
        """Hold ``rows`` too (distinct rows the set does not hold yet)."""
        keys = None if self.keys is None else row_keys(rows, self.bits)
        if keys is None:
            self._held().update(map(tuple, rows.tolist()))
        else:
            self.keys = np.insert(self.keys, np.searchsorted(self.keys, keys),
                                  keys)


def new_rows(rows: np.ndarray, have: np.ndarray,
             bits: int | None = None) -> np.ndarray:
    """The distinct rows of ``rows`` that ``have`` does not hold, sorted
    (both (m, c) int64 with values below ``2**bits``; ``None``: the width
    of the largest value in either), through a :class:`RowSet`."""
    rows = np.asarray(rows, np.int64)
    have = np.asarray(have, np.int64).reshape(-1, rows.shape[1])
    if bits is None:
        top = max([int(a.max()) for a in (rows, have) if a.size], default=0)
        bits = max(top.bit_length(), 1)
    return RowSet(have, bits).new(rows)


def sorted_contains(sorted_keys: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Membership of each of ``keys`` in the sorted array ``sorted_keys``."""
    if not len(sorted_keys):
        return np.zeros(len(keys), bool)
    at = np.minimum(np.searchsorted(sorted_keys, keys), len(sorted_keys) - 1)
    return sorted_keys[at] == keys


def normalize_db(db: dict, bits: int) -> dict[str, np.ndarray]:
    """EDB relations as sets of int64 rows inside the ``bits``-bit packed
    domain (``Engine.__init__``'s normalization): out-of-domain values raise
    and exact duplicate rows collapse."""
    out = {}
    limit = (1 << bits) - 1
    for k, v in db.items():
        v = np.asarray(v, np.int64)
        v = v[:, None] if v.ndim == 1 else v
        if v.size and (v.min() < 0 or v.max() > limit):
            raise ValueError(f"relation {k} exceeds {bits}-bit domain")
        out[k] = unique_rows(v, bits) if len(v) else v
    return out
