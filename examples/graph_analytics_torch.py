"""Dense graph analytics on the PyTorch/CUDA port: the dense half of
``examples/graph_analytics.py`` (§3 of the paper) on ``repro_torch``.

Dense transitive closure and connected components on a Gn-p graph through
the kernel-backed semiring products (K1, K2), then single-source shortest
paths driven by the fused relaxation kernel (K8), checked against the dense
engine's ``shortest_paths_dense``.  The k-core and effective-diameter halves
of the JAX example run on the tuple ``Engine``, which the port does not have
yet (ROADMAP A.6), so they are left out here.

Usage:  PYTHONPATH=src python examples/graph_analytics_torch.py [--device cpu]

With no ``--device`` it runs on ``cuda`` (and raises without a GPU);
``--device cpu`` runs the kernels' plain PyTorch versions.
"""
import argparse

import numpy as np
import torch

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
    return {"tc_pairs": tc_pairs, "tc_iterations": tc.iterations,
            "components": components, "relax_iterations": iters,
            "relax_matches": matches}


if __name__ == "__main__":
    main()
