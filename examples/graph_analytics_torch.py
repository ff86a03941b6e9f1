"""In-database graph analytics on the PyTorch/CUDA port:
``examples/graph_analytics.py`` (§3 of the paper) on ``repro_torch``.

k-cores (Example 7) and the effective diameter (Example 6) as Datalog
programs with aggregates in recursion on the tuple ``Engine``; then dense
transitive closure and connected components on a Gn-p graph through the
kernel-backed semiring products (K1, K2), and single-source shortest paths
driven by the fused relaxation kernel (K8), checked against the dense
engine's ``shortest_paths_dense``.

Usage:  PYTHONPATH=src python examples/graph_analytics_torch.py [--device cpu]

With no ``--device`` it runs on ``cuda`` (and raises without a GPU);
``--device cpu`` runs the kernels' plain PyTorch versions.
"""
import argparse
import collections

import numpy as np
import torch

from repro_torch.core.engine import Engine
from repro_torch.core.seminaive import (connected_components_dense,
                                        shortest_paths_dense,
                                        transitive_closure_dense)
from repro_torch.data.graphs import gnp_graph, graph_to_adj, grid_graph
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    dev = resolve_device(parser.parse_args(argv).device)

    # ------------------------------------------------- k-cores (Example 7)
    arc = np.array([[a, b] for a in range(5) for b in range(5) if a != b]
                   + [[0, 5], [5, 0], [5, 6], [6, 5]])
    eng = Engine("""
    degree(X, count<Y>) <- arc(X,Y).
    validArc(X,Y) <- arc(X,Y), degree(X,D1), D1 >= 4, degree(Y,D2), D2 >= 4.
    connComp(A,A) <- validArc(A,B).
    connComp(C,min<B>) <- connComp(A,B), validArc(A,C).
    kCores(A,B) <- connComp(A,B).
    """, db={"arc": arc}, default_cap=4096, device=dev).run()
    core = sorted({int(r[0]) for r in eng.query("kCores")})
    print("4-core members:", core)

    # ----------------------------------- effective diameter (Example 6)
    path_arcs = np.array([[i, i + 1] for i in range(9)] +
                         [[i + 1, i] for i in range(9)])
    eng = Engine("""
    hops(X,Y,min<H>) <- arc(X,Y), H = 1.
    hops(X,Z,min<H>) <- hops(X,Y,H1), arc(Y,Z), H = H1 + 1.
    """, db={"arc": path_arcs}, default_cap=1 << 14, device=dev).run()
    _, hop_vals = eng.query_agg("hops")
    hist = collections.Counter(int(v) for v in hop_vals)
    total, cov = sum(hist.values()), 0
    for diameter in sorted(hist):
        cov += hist[diameter]
        if cov >= 0.9 * total:
            print(f"effective diameter (90% coverage): {diameter} hops "
                  f"({cov}/{total} pairs)")
            break

    # ------------------------------------- dense TC and CC on G300
    edges = gnp_graph(300, 0.01, seed=1)
    adj = torch.from_numpy(graph_to_adj(edges)).to(dev)
    tc = transitive_closure_dense(adj)
    tc_pairs = int(tc.table.sum())
    print(f"dense TC on G300: {tc_pairs} pairs in {tc.iterations} "
          "semiring-matmul iterations")

    cc = connected_components_dense(adj)
    labels = cc.table.cpu().numpy()
    components = len(set(labels[np.isfinite(labels)].tolist()))
    print(f"dense CC: {components} components")

    # ---------------------------- the fused relaxation kernel driving SSSP
    n = 256
    g = grid_graph(15)
    w = np.full((n, n), np.inf, np.float32)
    g = g[(g < n).all(axis=1)]
    rng = np.random.default_rng(0)
    w[g[:, 0], g[:, 1]] = rng.integers(1, 5, len(g))
    w = torch.from_numpy(w).to(dev)
    d = w
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    iters = 0
    while bool(mask.any()):
        d, mask = ops.relax(d, w, mask, bm=64, bn=64, bk=32)
        iters += 1
    ref = shortest_paths_dense(w)
    matches = bool(torch.equal(d, ref.table))
    print(f"relax kernel fixpoint: {iters} iterations, "
          f"matches dense engine: {matches}")
    if not matches or iters != ref.iterations:
        raise SystemExit("the relaxation loop disagrees with "
                         "shortest_paths_dense")
    return {"k_core": core, "hops": dict(hist), "diameter": diameter,
            "tc_pairs": tc_pairs, "tc_iterations": tc.iterations,
            "components": components, "relax_iterations": iters,
            "relax_matches": matches}


if __name__ == "__main__":
    main()
