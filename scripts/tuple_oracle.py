#!/usr/bin/env python3
"""Counts the tuple engine must reproduce on the smoke's graphs, from scipy
and numpy on the CPU (no GPU, no JAX):

* G10K (``gnp_graph(10_000, 0.001, seed=0)``), linear TC: the closure's
  size (pairs at finite hop distance, a vertex with itself when it lies on
  a cycle), the PSN iterations (the largest hop distance) and the join
  bindings of each iteration (each pair (x, z) at distance k meets z's
  out-degree), whose sum with |arc| is ``generated``;
* G1K (``gnp_graph(1_000, 0.005, seed=10)``), non-linear TC: the same per
  semi-naive iteration of ``tc(X,Y) <- tc(X,Z), tc(Z,Y)``, whose two
  δ-rules join Δ with the whole table on either side.

    python3 scripts/tuple_oracle.py [--n 10000] [--p 0.001] [--nl-n 1000]

About 30 s for G10K (scipy's all-pairs BFS) and a few seconds for G1K.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def linear_tc(edges: np.ndarray, n: int) -> dict:
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path
    a = csr_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                   shape=(n, n))
    outdeg = np.asarray(a.sum(1)).ravel().astype(np.int64)
    d = shortest_path(a, unweighted=True, directed=True)
    # a vertex reaches itself through a cycle: 1 + the least distance back
    back = np.full(n, np.inf)
    for x in range(n):
        succ = a.indices[a.indptr[x]:a.indptr[x + 1]]
        if len(succ):
            back[x] = d[succ, x].min() + 1
    np.fill_diagonal(d, back)
    reach = np.isfinite(d)
    hops = int(d[reach].max())
    per = [int(((d == k).sum(0).astype(np.int64) * outdeg).sum())
           for k in range(1, hops + 1)]
    return {"facts": int(reach.sum()), "iterations": hops,
            "generated": len(edges) + sum(per), "per_iteration": per}


def nonlinear_tc(edges: np.ndarray, n: int) -> dict:
    a = np.zeros((n, n), bool)
    a[edges[:, 0], edges[:, 1]] = True
    full, delta = a.copy(), a.copy()
    gen, per = len(edges), []
    while delta.any():
        rows = full.sum(1).astype(np.int64)  # |tc(z, .)|
        cols = full.sum(0).astype(np.int64)  # |tc(., z)|
        joined = int((delta.sum(0) * rows).sum()) \
            + int((delta.sum(1) * cols).sum())
        f, dl = full.astype(np.float32), delta.astype(np.float32)
        new = (((dl @ f) > 0) | ((f @ dl) > 0)) & ~full
        full |= new
        delta = new
        gen += joined
        per.append(joined)
    return {"facts": int(full.sum()), "iterations": len(per),
            "generated": gen, "per_iteration": per}


def main() -> None:
    from repro_torch.data import gnp_graph
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--p", type=float, default=0.001)
    ap.add_argument("--nl-n", type=int, default=1_000)
    ap.add_argument("--nl-p", type=float, default=0.005)
    args = ap.parse_args()
    t0 = time.perf_counter()
    e = gnp_graph(args.n, args.p, seed=0)
    print(f"G10K linear TC ({len(e)} arcs):", linear_tc(e, args.n),
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    e = gnp_graph(args.nl_n, args.nl_p, seed=10)
    print(f"G1K non-linear TC ({len(e)} arcs):", nonlinear_tc(e, args.nl_n),
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
