"""Verticalized tables and rollup prefix tables — Examples 8/9 of the paper.

The "@" verticalization construct becomes :func:`verticalize`; the rollup
prefix table (Table 4, logically an FP-tree) is built by running Example 8's
Datalog program — aggregates in recursion and all — on the core engine; the
longest-maximal-pattern query is Example 9 verbatim.

Port of ``repro.analytics.rollup`` on the port's tuple ``Engine``: the same
programs, defaults and renumbering, so the same tables come out.  Every
function takes ``device=`` (``None``: the card).  The packed keys bound the
sizes, as in the JAX package: ``bits`` per column within 62 bits, so
Example 8's ``repr`` (key arity 4) takes ``bits`` <= 15 (at most 32,767
tuples) and Example 9's ``myrupt`` (key arity 5) ``bits`` <= 12 (node ids
and counts below 4,096).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.engine import Engine
from ..core.ir import SymbolTable


@dataclasses.dataclass
class Verticalized:
    """vtrain(ID, Col, Val) + the symbol table interning cell values."""

    rows: np.ndarray  # (n*ncols, 3) int: (tuple_id, col, val_id); ids are 1-based
    symbols: SymbolTable
    n_tuples: int
    n_cols: int


def verticalize(table: list[list[str]]) -> Verticalized:
    """Table 1 -> Table 2: one (ID, Col, Val) row per cell (the '@' construct)."""
    sym = SymbolTable()
    out = []
    for tid, row in enumerate(table, start=1):
        for col, cell in enumerate(row, start=1):
            out.append((tid, col, sym.intern(cell) + 1))  # 0 reserved
    return Verticalized(np.asarray(out, np.int64), sym, len(table), len(table[0]))


EXAMPLE8 = """
repr(T1, C, V, T) <- vtrain(T, C, V), C = 1, T1 = 1.
rupt(min<T>, C, V, Ta) <- repr(Ta, C, V, T).
repr(T1, C, V, T) <- vtrain(T, C, V), C1 = C - 1, repr(Ta, C1, V1, T),
                     rupt(T1, C1, V1, Ta).
myrupt(T, C, V, count<TID>, Ta) <- rupt(T, C, V, Ta), repr(Ta, C, V, TID).
"""


def build_rollup_prefix_table(vt: Verticalized, caps: int = 1 << 16,
                              bits: int = 12, device=None):
    """Run Example 8; return myrupt rows as (ID, Col, Val, count, PID).

    A representative is the min row id *within its column group*, so the same
    row id names a node at every column along that row's path (the paper's
    Table 4 sidesteps this by renumbering).  We renumber likewise: node
    identity is (T, C); ids are reassigned 2.. with 1 reserved for the root,
    giving the globally-unique IDs that Example 9's parent tests require.
    """
    eng = Engine(EXAMPLE8, db={"vtrain": vt.rows}, default_cap=caps,
                 bits=bits, device=device)
    eng.run()
    rows, counts = eng.query_agg("myrupt")
    # myrupt keys are (T, C, V, Ta) with the count value at literal position 3
    t, c, v, ta = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
    out = np.stack([t, c, v, counts, ta], axis=1)
    out = out[np.lexsort((out[:, 0], out[:, 1]))]
    ids = {(int(r[0]), int(r[1])): i + 2 for i, r in enumerate(out)}
    renum = out.copy()
    for i, r in enumerate(out):
        renum[i, 0] = ids[(int(r[0]), int(r[1]))]
        renum[i, 4] = 1 if r[1] == 1 else ids[(int(r[4]), int(r[1]) - 1)]
    return renum, eng


def compact_rollup(myrupt: np.ndarray, vt: Verticalized) -> dict:
    """Table 5 view: nested {val: (count, children)} per root node."""

    children: dict[int, list[np.ndarray]] = {}
    for row in myrupt:
        children.setdefault(int(row[4]), []).append(row)

    def build(node_id: int, col: int):
        out = {}
        for row in children.get(node_id, []):
            if int(row[1]) != col:
                continue
            name = vt.symbols.name(int(row[2]) - 1)
            out[name] = (int(row[3]), build(int(row[0]), col + 1))
        return out

    # roots: C == 1 nodes have parent T1 = 1 (their own convention)
    return {"root": build(1, 1)}


EXAMPLE9 = """
items(C, V, sum<Cnt>) <- myrupt(T, C, V, Cnt, P).
freqItems(C, V) <- items(C, V, Cnt), Cnt >= {K}.
len(T, 0) <- myrupt(T, C, V, N, P), ~myrupt(A, B, D, E, T), ~freqItems(C, V).
len(T, 1) <- myrupt(T, C, V, N, P), ~myrupt(A, B, D, E, T), freqItems(C, V).
len(T, max<L>) <- len(TC, L1), myrupt(TC, B1, B2, B3, T), myrupt(T, C, V, N2, P2),
                  ~freqItems(C, V), L = L1.
len(T, max<L>) <- len(TC, L1), myrupt(TC, B1, B2, B3, T), myrupt(T, C, V, N2, P2),
                  freqItems(C, V), L = L1 + 1.
longest(Z, max<L>) <- len(T, L), Z = 0.
"""


def longest_maximal_pattern(myrupt: np.ndarray, k: int, caps: int = 1 << 16,
                            bits: int = 12, device=None) -> int:
    """Example 9: length of the longest maximal pattern above threshold k."""
    eng = Engine(EXAMPLE9.replace("{K}", str(k)), db={"myrupt": myrupt},
                 default_cap=caps, bits=bits, device=device)
    eng.run()
    rows, vals = eng.query_agg("longest")
    assert len(vals) == 1
    return int(vals[0])
