"""Synthetic graph generators — Table 6 of the paper.

Tree-N: trees of height N, non-leaf out-degree uniform in [2, 6].
Grid-N: (N+1) × (N+1) grid, arcs right and down.
Gn-p:   n-vertex Erdős–Rényi directed random graphs (default p = 0.001).

Full-size Table 6 graphs (Tree17: 13.7M vertices; G80K: 6.4e9-row TC) are
cluster-scale; ``table6_scaled`` provides the same *families* at CPU-testable
sizes, and the benchmarks report the family + scale so results read against
the paper's Figures 5-7 / Tables 6-8.
"""
from __future__ import annotations

import numpy as np


def tree_graph(height: int, seed: int = 0, min_deg: int = 2, max_deg: int = 6) -> np.ndarray:
    rng = np.random.default_rng(seed)
    edges = []
    frontier = [0]
    next_id = 1
    for _ in range(height):
        new_frontier = []
        for v in frontier:
            for _ in range(int(rng.integers(min_deg, max_deg + 1))):
                edges.append((v, next_id))
                new_frontier.append(next_id)
                next_id += 1
        frontier = new_frontier
    return np.asarray(edges, np.int64)


def grid_graph(n: int) -> np.ndarray:
    """(n+1)x(n+1) grid with arcs right and down (the paper's GridN)."""
    side = n + 1
    vid = lambda i, j: i * side + j
    edges = []
    for i in range(side):
        for j in range(side):
            if j + 1 < side:
                edges.append((vid(i, j), vid(i, j + 1)))
            if i + 1 < side:
                edges.append((vid(i, j), vid(i + 1, j)))
    return np.asarray(edges, np.int64)


def gnp_graph(n: int, p: float = 0.001, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < p
    np.fill_diagonal(mask, False)
    src, dst = np.nonzero(mask)
    return np.stack([src, dst], axis=1).astype(np.int64)


def dag_graph(n: int, p: float = 0.01, seed: int = 0,
              max_w: int = 1) -> np.ndarray:
    """Random weighted DAG: (src, dst, w) arcs with src < dst — the acyclic
    regime the additive (+,×) carrier requires (count/sum-in-recursion has
    no finite fixpoint on cycles).  ``max_w=1`` keeps all-ones weights, so
    the counting closure is exact path counts; larger ``max_w`` draws
    integer weights uniformly from [1, max_w] for weighted sums and
    longest-path (max-plus) workloads."""
    rng = np.random.default_rng(seed)
    mask = np.triu(rng.random((n, n)) < p, k=1)
    src, dst = np.nonzero(mask)
    w = (np.ones(len(src), np.int64) if max_w <= 1
         else rng.integers(1, max_w + 1, len(src)))
    return np.stack([src, dst, w], axis=1).astype(np.int64)


def powerlaw_graph(n: int, m: int, alpha: float = 1.5, seed: int = 0) -> np.ndarray:
    """m-edge digraph whose IN-degrees follow a Zipf(alpha) law over n vertices.

    Sources are uniform; destinations are drawn from a rank-based power law,
    so a handful of hub vertices absorb most arcs — the heavy-tail regime
    where single-width ELL pads every row to the hub's capacity and the
    sliced-ELL ladder (``core.sparse``) is designed to win.  Duplicate arcs
    and self-loops are dropped, so the result can land under ``m`` edges.
    """
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** alpha
    weights /= weights.sum()
    # oversample, then dedup: keeps the degree law while returning ~m arcs
    k = int(m * 1.5) + 8
    src = rng.integers(0, n, k)
    dst = rng.choice(n, size=k, p=weights)
    keep = src != dst
    edges = np.unique(np.stack([src[keep], dst[keep]], axis=1), axis=0)
    if len(edges) > m:
        edges = edges[rng.permutation(len(edges))[:m]]
    return np.ascontiguousarray(edges[np.lexsort((edges[:, 1], edges[:, 0]))],
                                dtype=np.int64)


def graph_to_adj(edges: np.ndarray, n: int | None = None) -> np.ndarray:
    n = n or int(edges.max()) + 1
    adj = np.zeros((n, n), bool)
    adj[edges[:, 0], edges[:, 1]] = True
    return adj


def graph_to_weighted(edges: np.ndarray, n: int | None = None,
                      weights: np.ndarray | None = None, seed: int = 0) -> np.ndarray:
    n = n or int(edges.max()) + 1
    if weights is None:
        weights = np.random.default_rng(seed).integers(1, 10, len(edges))
    w = np.full((n, n), np.inf, np.float32)
    w[edges[:, 0], edges[:, 1]] = np.minimum(
        w[edges[:, 0], edges[:, 1]], weights.astype(np.float32))
    return w


def table6_scaled() -> dict[str, np.ndarray]:
    """CPU-scale instances of the Table 6 families (same generators)."""
    return {
        "Tree6": tree_graph(6, seed=11),
        "Tree8": tree_graph(8, seed=17),
        "Grid20": grid_graph(20),
        "Grid30": grid_graph(30),
        "G500": gnp_graph(500, 0.01, seed=5),
        "G1K": gnp_graph(1000, 0.005, seed=10),
    }


# ---------------------------------------------------------------------------
# oracles (for validation tests)
# ---------------------------------------------------------------------------


def tc_size_oracle(edges: np.ndarray, n: int | None = None) -> int:
    """|TC| by boolean-matrix fixpoint (numpy)."""
    adj = graph_to_adj(edges, n)
    tc = adj.copy()
    while True:
        new = tc | (tc @ adj)
        if (new == tc).all():
            return int(tc.sum())
        tc = new


def sg_size_oracle(edges: np.ndarray, n: int | None = None) -> int:
    adj = graph_to_adj(edges, n)
    sg = (adj.T @ adj) & ~np.eye(adj.shape[0], dtype=bool)
    while True:
        new = sg | (adj.T @ (sg @ adj).astype(bool)).astype(bool) & ~np.eye(adj.shape[0], dtype=bool)
        new |= sg
        if (new == sg).all():
            return int(sg.sum())
        sg = new
