"""Query normalization and EDB selection, ported from ``repro.core.engine``
(``as_query_literal``, ``repeated_var_groups``, ``query_row_mask``) and the
planner's ``PlanError``.  The port has no tuple engine yet (ROADMAP A.6), so
these pieces live on their own."""
from __future__ import annotations

from typing import Union

import numpy as np

from .ir import Const, Literal, Term, Var, fresh_var
from .parser import parse_query


class PlanError(ValueError):
    """A query or program the engine cannot plan."""


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


def query_row_mask(q: Literal, rows: np.ndarray) -> np.ndarray:
    """Row mask restricting an EDB relation to a query goal: constants match
    their column, repeated variables must be pairwise equal."""
    mask = np.ones(len(rows), bool)
    for i, a in enumerate(q.args):
        if isinstance(a, Const):
            mask &= rows[:, i] == a.value
    for ps in repeated_var_groups(q):
        for pos in ps[1:]:
            mask &= rows[:, ps[0]] == rows[:, pos]
    return mask


def _unique_rows(v: np.ndarray, bits: int) -> np.ndarray:
    """``np.unique(v, axis=0)`` for rows of ``bits``-bit values.  When a row
    packs into one int64 key (column 0 most significant, so the key order is
    the row order) the 1-D unique on the keys gives the same array far
    faster than the row-wise sort."""
    c = v.shape[1]
    if c * bits > 63:
        return np.unique(v, axis=0)
    key = np.zeros(len(v), np.int64)
    for j in range(c):
        key = (key << bits) | v[:, j]
    key = np.unique(key)
    mask = (1 << bits) - 1
    return np.stack([(key >> (bits * (c - 1 - j))) & mask for j in range(c)],
                    axis=1)


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
        out[k] = _unique_rows(v, bits) if len(v) else v
    return out
