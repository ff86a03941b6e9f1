"""Naive Bayes over the verticalized representation (§4, footnote 8).

Expressed the way the paper's tutorial does: all sufficient statistics are
group-by counts over ``vtrain`` — i.e. non-recursive Datalog count rules —
executed here through the same engine, then combined with Laplace smoothing.

Port of ``repro.analytics.nbc`` on the port's tuple ``Engine``
(``device=``: ``None`` is the card).
"""
from __future__ import annotations

import numpy as np

from ..core.engine import Engine
from .rollup import Verticalized

NBC_COUNTS = """
classCnt(V, count<T>) <- vtrain(T, C, V), C = {LABEL}.
featCnt(C, V, L, count<T>) <- vtrain(T, C, V), vtrain(T, C2, L), C2 = {LABEL}, C != {LABEL}.
"""


def naive_bayes_train(vt: Verticalized, label_col: int | None = None,
                      caps: int = 1 << 16, bits: int = 12, device=None):
    label_col = label_col or vt.n_cols
    eng = Engine(NBC_COUNTS.replace("{LABEL}", str(label_col)),
                 db={"vtrain": vt.rows}, default_cap=caps, bits=bits,
                 device=device)
    eng.run()
    crow, cval = eng.query_agg("classCnt")
    frow, fval = eng.query_agg("featCnt")
    class_counts = {int(r[0]): int(v) for r, v in zip(crow, cval)}
    feat_counts = {(int(r[0]), int(r[1]), int(r[2])): int(v) for r, v in zip(frow, fval)}
    return {"classes": class_counts, "features": feat_counts,
            "n": vt.n_tuples, "label_col": label_col,
            "n_values": len(vt.symbols) + 1}


def naive_bayes_predict(model, example: dict[int, int]) -> int:
    """example: {col: val_id}; returns the argmax class id (log-space, Laplace)."""
    best, best_lp = None, -np.inf
    v = model["n_values"]
    for cls, ccnt in model["classes"].items():
        lp = np.log(ccnt / model["n"])
        for col, val in example.items():
            num = model["features"].get((col, val, cls), 0) + 1
            lp += np.log(num / (ccnt + v))
        if lp > best_lp:
            best, best_lp = cls, lp
    return best
