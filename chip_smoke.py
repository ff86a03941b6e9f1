#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script stops at the first failure with
a non-zero exit and prints no result):

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles the hand-written kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel);
3. kernel parity at ragged shapes: K1-K6 and K2's max-plus instantiation
   against their plain PyTorch versions, exact equality (bool is exact; min
   and max of sums of small integers in f32 are exact and order-independent;
   K5's inputs are small integers whose sums stay below 2^24, where f32
   sums are exact in any order); B = 3, 32 and 130 (over the CSR kernels'
   128-row split), hub rows wider than one 1024-position segment, and a
   COO tail built by hand; then K7 (the min-plus step over a tile-skip
   plan) against its plain version and K4's at (chunk, bn) = (32, 128),
   (64, 128), (32, 256) and (16, 64) and B = 3, 32 and 130, on a graph with
   empty column tiles, an allocation no tile width divides, a hub tile
   split into several work units and a COO tail made by ``csr_append``;
   then K8 (the fused relaxation step) against its plain version at n = 1,
   50, 130, 1000 and 1025, with Δ masks all true, all false and random with
   a whole 64-row tile false, and a ``d`` with whole +inf rows;
4. dense main path: ``DatalogService`` TC and SPATH on ``gnp_graph(10_000,
   0.1)`` (the paper's Table-6 Gn-p family; density 0.1 picks the dense
   carrier), ``ask_batch`` of 100 sources, a second batch of 100, a repeat
   of the first (all cache hits) and one ``ask``; then appends to both
   services: 1,000 arcs, and one arc to vertex 10,200, which grows
   ``n_alloc`` from 10,112 to 10,240 (cached rows re-padded): 3 resumed
   batch sources, the single one and the new vertex against the oracle;
5. CSR main path: TC and SPATH on ``powerlaw_graph(2**20, 16_000_000,
   alpha=0.8)`` (a social-graph shape; the density heuristic picks CSR),
   ``ask_batch`` of 32 sources, a second batch of 32 and a repeat;
5b. the tuned CSR path on phase 5's weighted arcs (not generated again):
   ``DatalogService(SPATH, sparse=True, tune=KernelConfig(use_kernel=True))``
   (tile-skip plan (32, 128)), the same traffic; K7 must launch once per
   iteration plus one seed step per fixpoint and K4 never; the plan's
   length, padding and host build time; K7 timed beside its plain version,
   its bound and K4 at the same frontier, then K7 against K4 (equal
   exactly, and timed) at a frontier with every value finite.  Then two
   appends to that
   service: 10,000 arcs (to the COO tail) and 4,100,000 (past
   ``csr_rebuild_frac``: a fold that rebuilds the pinned layout and its
   plan), each resuming every cached source, the resumed iterations beside
   the cold ones, 4 sources against Dijkstra on the union.  Then
   ``tune=True`` on the same arcs: the measured search (the analytic
   shortlist of layouts and the three tile-skip configs), each candidate's
   predicted and measured seconds, the pick and its gain, and 4 sources
   against Dijkstra;
6. ``max<>`` and ``sum<>`` paths, the same traffic: dense LPATH (longest
   paths, K2's max-plus instantiation) on ``dag_graph(10_000, 0.05,
   max_w=9)`` (density 0.025 picks the dense carrier); dense CPATH (path
   counts, a full-f32 ``torch.matmul`` per iteration) on ``dag_graph(10_000,
   8/10_000)`` with the dense carrier forced, the JAX package's own counting
   regime (per-source totals near e^8), then 500 new arcs with src < dst
   appended (increment replay, held to the int64 DP oracle) and the same
   500 again (set semantics: no fixpoint, no count changes); CSR LPATH (K6, weights 1..9) and
   CSR CPATH (K5, unit weights) on the arcs of phase 5's power-law graph
   with src > dst (a DAG of about 13.2M arcs, hub in-degrees near 183k);
   then a 3-cycle CPATH on both carriers must raise
   ``FixpointDivergenceError`` and cache nothing;
7. the dense all-pairs path on the paper's Table-6 G10K,
   ``gnp_graph(10_000, 0.001)`` (about 100k arcs, SSSP weights 1..9), as
   (n, n) matrices on the card: APSP three ways, ``shortest_paths_dense``
   (the linear form, K2 at M = n), the relaxation loop ``d, mask =
   ops.relax(d, w, mask)`` from ``d = w`` (K8, one launch per trip) and
   the nonlinear form (K2, log depth), whose tables must be equal and the
   first two's iteration counts too, 64 rows against scipy's Dijkstra;
   ``transitive_closure_dense`` (K1), 64 rows against scipy's BFS;
   ``same_generation_dense`` (the sandwich form, K1 twice an iteration)
   against the same fixpoint with the plain boolean product on the card;
   ``connected_components_dense`` (K2 with B = 1) against scipy's
   components, each labelled by its least vertex.  Per path: iterations,
   wall time and K1, K2 and K8 launches.  K8 is timed at the inputs of the
   loop's first, middle and last steps, held to its plain version in row
   blocks of 1,024 (the plain version cannot run whole at this width),
   beside one K2 linear step with its merge and changed test at the same
   inputs; K1 and K2 are timed at M = n;
8. checks: the chosen carriers (and semirings), every kernel's launch count
   during its path (counts reset just before each path and read just
   after), and the answers of 4 sources per path against oracles that
   share no code with either package: scipy's csgraph for TC and SPATH
   (BFS, Dijkstra), and for LPATH and CPATH scipy's BFS for the reached
   vertices, then dynamic programming over them in topological order in
   int64 (any path count at or above 2^24 fails the run: f32 would no
   longer hold it exactly); each kernel is timed at the shapes its path
   gave it (the first fixpoint iteration's frontier) beside its plain
   version and, where one PyTorch call computes the same function, that
   call; a warm batch is split into fixpoint, copy to the host and
   formatting.

The line before the last is one JSON object of kernel measurements; the last
line is ``{"ok": true, "device": {...}}``.  Needs no network; the graphs are
made from fixed seeds.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
DEVICE = "cuda"
DENSE_N, DENSE_P, DENSE_BATCH = 10_000, 0.1, 100
CSR_N, CSR_M, CSR_ALPHA, CSR_BATCH = 2 ** 20, 16_000_000, 0.8, 32

# Published H100 SXM peaks (NVIDIA data sheet; dense, no sparsity): HBM3
# bytes/s, f32 outside the tensor cores, int8 tensor-core ops/s.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
INT8_OPS_S = 1979e12

TC = """
tc(X,Y) <- arc(X,Y).
tc(X,Y) <- tc(X,Z), arc(Z,Y).
"""
SPATH = """
dpath(X,Z,min<D>) <- darc(X,Z,D).
dpath(X,Z,min<D>) <- dpath(X,Y,Dxy), darc(Y,Z,Dyz), D = Dxy + Dyz.
"""
LPATH = """
lpath(X,Z,max<D>) <- d(X,Z,D).
lpath(X,Z,max<D>) <- lpath(X,Y,D1), d(Y,Z,D2), D = D1 + D2.
"""
CPATH = """
cpath(X,Z,sum<C>) <- d(X,Z,C).
cpath(X,Z,sum<C>) <- cpath(X,Y,C1), d(Y,Z,C2), C = C1 * C2.
"""
LPATH_N, LPATH_P, LPATH_W = 10_000, 0.05, 9
CPATH_N, CPATH_P = 10_000, 8 / 10_000

KERNELS = {
    "bool_matmul": ("src/repro_torch/kernels/csrc/boolmm.cu",
                    "src/repro/kernels/boolmm.py:47"),
    "minplus_matmul": ("src/repro_torch/kernels/csrc/minplus.cu",
                       "src/repro/kernels/minplus.py:49"),
    # K2's max-plus instantiation: the JAX package serves max-plus through
    # the same Pallas kernel by negation (ops.maxplus_frontier)
    "maxplus_matmul": ("src/repro_torch/kernels/csrc/minplus.cu",
                       "src/repro/kernels/minplus.py:49"),
    "csr_bool_step": ("src/repro_torch/kernels/csrc/spmv.cu",
                      "src/repro/kernels/spmv.py:149"),
    "csr_minplus_step": ("src/repro_torch/kernels/csrc/spmv.cu",
                         "src/repro/kernels/spmv.py:251"),
    "csr_plustimes_step": ("src/repro_torch/kernels/csrc/spmv.cu",
                           "src/repro/kernels/spmv.py:211"),
    "csr_maxplus_step": ("src/repro_torch/kernels/csrc/spmv.cu",
                         "src/repro/kernels/spmv.py:297"),
    "csr_minplus_tiled_step": ("src/repro_torch/kernels/csrc/spmv.cu",
                               "src/repro/kernels/spmv.py:359"),
    "relax_step": ("src/repro_torch/kernels/csrc/relax.cu",
                   "src/repro/kernels/relax.py:75"),
}
#: K7's ragged cases: (chunk, bn) plans and batch sizes (130 crosses the
#: 32-row passes more than four times)
K7_PLANS = ((32, 128), (64, 128), (32, 256), (16, 64))
K7_BATCHES = (3, 32, 130)
TAIL_APPEND, FOLD_APPEND = 10_000, 4_100_000
#: the vertex the dense append phase adds: past n_alloc 10,112 (Gn-p 10k)
DENSE_GROW = 10_200
#: K8's ragged sizes (1025: a last row tile of one row)
K8_SIZES = (1, 50, 130, 1000, 1025)
#: the all-pairs phase: the paper's Table-6 G10K (Gn-p, n = 10,000,
#: p = 0.001), rows sampled against scipy, and the plain versions' row block
AP_N, AP_P, AP_SAMPLE, ROW_BLOCK = 10_000, 0.001, 64, 1024


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def equal_and_err(torch, got, want) -> float:
    """Exact equality (dtype, shape, every element) and the max abs error."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{got.dtype}{tuple(got.shape)} vs {want.dtype}{tuple(want.shape)}")
    if got.dtype == torch.bool:
        err = float((got != want).any())
    else:
        diff = torch.where(got == want, torch.zeros_like(got),
                           (got - want).abs())
        err = float(diff.max()) if diff.numel() else 0.0
    check(torch.equal(got, want), f"kernel != plain (max abs err {err})")
    return err


def time_ms(torch, fn, calls: int, rounds: int = 3) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``calls`` back-to-back
    calls, per call (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        per_call.append(start.elapsed_time(stop) / calls)
    return float(np.median(per_call))


# -- phases 1-2 ---------------------------------------------------------------


def check_device() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return card


def build_kernels():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build(verbose=True)
    say(f"build: {time.perf_counter() - t0:.1f} s for {list(build.SOURCES)}")
    for line in report.splitlines():
        if line.startswith("==") or "Used" in line or (
                "spill" in line and "0 bytes spill stores, 0 bytes spill "
                "loads" not in line):
            say("  " + line.strip())


# -- phase 3: ragged parity ---------------------------------------------------


def _rand_dist(rng, shape, p):
    return np.where(rng.random(shape) < p, rng.integers(1, 10, shape),
                    np.inf).astype(np.float32)


def _hand_tailed_csr(kind, n, edges, tail, device):
    """``build_csr`` plus a COO tail packed by hand, as an append leaves it."""
    import torch
    from repro_torch.core import sparse
    from repro_torch.core.seminaive import quantize_rows
    csr = sparse.build_csr(edges, n, kind, device=device)
    t = len(tail)
    cap = quantize_rows(t + 1)
    zero = csr.semiring.zero
    tsrc = np.zeros(cap, np.int32)
    tdst = np.zeros(cap, np.int32)
    tsrc[:t], tdst[:t] = tail[:, 0], tail[:, 1]
    if kind == "bool":
        tval = np.zeros(cap, bool)
        tval[:t] = True
    else:
        tval = np.full(cap, zero, np.float32)
        tval[:t] = tail[:, 2]
    tell = sparse._ell_index(tdst, t, n, cap - 1)
    dev = torch.device(device)
    return dataclasses.replace(
        csr, tail_src=torch.from_numpy(tsrc).to(dev),
        tail_dst=torch.from_numpy(tdst).to(dev),
        tail_val=torch.from_numpy(tval).to(dev),
        tail_ell=torch.from_numpy(tell).to(dev),
        tail_nnz=torch.tensor(t, dtype=torch.int32, device=dev))


def _ragged_graph(rng, n, m, hub_deg):
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    if hub_deg:  # vertex 1 gets hub_deg in-arcs: a slice wider than one segment
        src = np.concatenate([src, rng.permutation(n)[:hub_deg]])
        dst = np.concatenate([dst, np.ones(hub_deg, np.int64)])
    edges = np.unique(np.stack([src, dst], 1), axis=0)
    tail = np.stack([rng.integers(0, n, 40), rng.integers(0, n, 40)], 1)
    return edges, tail


def _neg_inf(x):
    """A min-plus array re-zeroed for max-plus (+inf -> -inf)."""
    return np.where(np.isinf(x), -np.inf, x).astype(np.float32)


def _rand_count(rng, shape, p):
    """Small integers (0 = no fact): K5's sums stay far below 2^24."""
    return np.where(rng.random(shape) < p, rng.integers(1, 4, shape),
                    0).astype(np.float32)


def ragged_parity():
    import torch
    from repro_torch.kernels import boolmm, minplus, spmv
    rng = np.random.default_rng(SEED)
    rng2 = np.random.default_rng(SEED + 2)  # the max-plus and plus-times cases
    dev = DEVICE
    cases = 0
    for B, n in ((3, 1000), (5, 1003), (130, 257)):
        f = torch.from_numpy(rng.random((B, n)) < 0.2).to(dev)
        a = torch.from_numpy(rng.random((n, n)) < 0.05).to(dev)
        equal_and_err(torch, boolmm.bool_frontier_matmul(f, a),
                      boolmm.plain(f, a))
        fw = torch.from_numpy(_rand_dist(rng, (B, n), 0.3)).to(dev)
        w = torch.from_numpy(_rand_dist(rng, (n, n), 0.05)).to(dev)
        equal_and_err(torch, minplus.minplus_frontier_matmul(fw, w),
                      minplus.plain(fw, w))
        fm = torch.from_numpy(_neg_inf(_rand_dist(rng2, (B, n), 0.3))).to(dev)
        wm = torch.from_numpy(_neg_inf(_rand_dist(rng2, (n, n), 0.05))).to(dev)
        equal_and_err(torch, minplus.maxplus_frontier_matmul(fm, wm),
                      minplus.plain_max(fm, wm))
        cases += 3
    for B, n, m, hub in ((3, 1000, 8000, 0), (130, 5000, 30000, 4000),
                         (32, 3000, 20000, 2500)):
        edges, tail = _ragged_graph(rng, n, m, hub)
        csr = _hand_tailed_csr("bool", n, edges, tail, dev)
        check(int(csr.tail_nnz) > 0, "tail not built")
        f = torch.from_numpy(rng.random((B, n)) < 0.1).to(dev)
        equal_and_err(torch, spmv.csr_bool_step(f, csr),
                      spmv.plain_bool(f, csr))
        w = rng.integers(1, 10, (len(edges), 1))
        tw = np.concatenate([tail, rng.integers(1, 10, (len(tail), 1))], 1)
        csr_w = _hand_tailed_csr("minplus", n, np.concatenate([edges, w], 1),
                                 tw, dev)
        fw = torch.from_numpy(_rand_dist(rng, (B, n), 0.1)).to(dev)
        equal_and_err(torch, spmv.csr_minplus_step(fw, csr_w),
                      spmv.plain_minplus(fw, csr_w))
        for kind, step, plain, hi, frontier in (
                ("maxplus", spmv.csr_maxplus_step, spmv.plain_maxplus, 10,
                 lambda: _neg_inf(_rand_dist(rng2, (B, n), 0.1))),
                ("plustimes", spmv.csr_plustimes_step, spmv.plain_plustimes,
                 4, lambda: _rand_count(rng2, (B, n), 0.1))):
            w = rng2.integers(1, hi, (len(edges), 1))
            tw = np.concatenate([tail, rng2.integers(1, hi, (len(tail), 1))], 1)
            csr_k = _hand_tailed_csr(kind, n, np.concatenate([edges, w], 1),
                                     tw, dev)
            fk = torch.from_numpy(frontier()).to(dev)
            equal_and_err(torch, step(fk, csr_k), plain(fk, csr_k))
        cases += 4
    torch.cuda.synchronize()
    say(f"parity (ragged): {cases} kernel cases exactly equal to plain")


def k7_ragged_parity():
    """K7 against its plain version, exactly: a graph whose upper column
    tiles are empty, an allocation that is no multiple of any tile width, a
    hub whose tile's items split into several work units, and a COO tail
    made by ``csr_append``; every plan of :data:`K7_PLANS` at every batch
    size of :data:`K7_BATCHES`."""
    import torch
    from repro_torch.core import sparse
    from repro_torch.kernels import spmv
    rng = np.random.default_rng(SEED + 5)
    n_alloc, m, hub = 3000, 24000, 6000
    src = np.concatenate([rng.integers(0, n_alloc, m),
                          rng.integers(0, n_alloc, hub)])
    dst = np.concatenate([rng.integers(0, 1000, m // 2),
                          rng.integers(2000, 2950, m - m // 2),
                          np.ones(hub, np.int64)])  # 1000..1999: empty tiles
    edges = np.stack([src, dst, rng.integers(1, 10, len(src))], 1)
    tail = np.stack([rng.integers(0, n_alloc, 40),
                     rng.integers(0, n_alloc, 40),
                     rng.integers(1, 10, 40)], 1)
    cases = 0
    for plan in K7_PLANS:
        csr = sparse.csr_append(sparse.build_csr(
            edges, n_alloc, "minplus", kernel_plan=plan, device=DEVICE), tail)
        units = csr.plan_unit.cpu().numpy()
        check(int(csr.tail_nnz) == len(tail) and csr.plan_cfg == plan,
              f"K7 case {plan}: tail or plan not built")
        check(int(np.diff(units).max()) == sparse.PLAN_UNIT,
              f"K7 case {plan}: no tile was split into work units")
        for B in K7_BATCHES:
            f = torch.from_numpy(_rand_dist(rng, (B, n_alloc), 0.2)).to(DEVICE)
            got = spmv.csr_minplus_tiled_step(f, csr)
            equal_and_err(torch, got, spmv.plain_minplus_tiled(f, csr))
            equal_and_err(torch, got, spmv.plain_minplus(f, csr))
            cases += 1
    torch.cuda.synchronize()
    say(f"parity (K7, ragged): {cases} cases exactly equal to plain "
        f"(plans {list(K7_PLANS)}, B {list(K7_BATCHES)}, n_alloc {n_alloc})")


def k8_ragged_parity():
    """K8 against its plain version, exactly, at every size of
    :data:`K8_SIZES`: a ``d`` with whole +inf rows, and Δ masks all true,
    all false (every row tile runs no K loop) and random with rows 64..127
    false (one whole row tile without a Δ row)."""
    import torch
    from repro_torch.kernels import relax
    rng = np.random.default_rng(SEED + 9)
    cases = 0
    for n in K8_SIZES:
        d = _rand_dist(rng, (n, n), 0.3)
        d[::7] = np.inf
        a = _rand_dist(rng, (n, n), 0.05)
        some = rng.random(n) < 0.5
        some[64:128] = False
        for mask in (np.ones(n, bool), np.zeros(n, bool), some):
            args = [torch.from_numpy(x).to(DEVICE) for x in (d, a, mask)]
            got, want = relax.relax_step(*args), relax.plain(*args)
            for g, w in zip(got, want):
                equal_and_err(torch, g, w)
            cases += 1
    torch.cuda.synchronize()
    say(f"parity (K8, ragged): {cases} cases exactly equal to plain "
        f"(n {list(K8_SIZES)}; masks all, none, random with a false tile)")


# -- phases 4-7: the main path ------------------------------------------------


def _weighted(rng, edges):
    return np.concatenate([edges, rng.integers(1, 10, (len(edges), 1))], 1)


class Oracle:
    """Single-source answers in one or more arcs from scipy's csgraph: BFS
    reachability or Dijkstra distances (the source itself is an answer only
    when it lies on a cycle)."""

    def __init__(self, edges, n, weighted):
        from scipy.sparse import csr_matrix
        self.n, self.weighted = n, weighted
        if weighted:  # parallel arcs: keep the lightest (scipy would add)
            edges = edges[np.lexsort((edges[:, 2], edges[:, 1], edges[:, 0]))]
            keep = np.ones(len(edges), bool)
            keep[1:] = (edges[1:, 0] != edges[:-1, 0]) | \
                (edges[1:, 1] != edges[:-1, 1])
            edges = edges[keep]
        w = edges[:, 2].astype(np.float64) if weighted else \
            np.ones(len(edges), np.float64)
        self.g = csr_matrix((w, (edges[:, 0], edges[:, 1])), shape=(n, n))
        self.gt = self.g.T.tocsr()

    def answer(self, s):
        from scipy.sparse.csgraph import breadth_first_order, dijkstra
        lo, hi = self.gt.indptr[s], self.gt.indptr[s + 1]
        into_s, w_into_s = self.gt.indices[lo:hi], self.gt.data[lo:hi]
        if not self.weighted:
            order = breadth_first_order(self.g, s, directed=True,
                                        return_predecessors=False)
            reach = np.zeros(self.n, bool)
            reach[order] = True
            reach[s] = bool(reach[into_s].any())
            return np.nonzero(reach)[0], None
        dist = dijkstra(self.g, directed=True, indices=s)
        back = dist[into_s] + w_into_s
        dist[s] = back.min() if len(back) else np.inf
        dst = np.nonzero(np.isfinite(dist))[0]
        return dst, dist[dst].astype(np.int64)

    def check(self, s, ans):
        dst, vals = self.answer(s)
        rows = ans[0] if self.weighted else ans
        check(np.array_equal(rows[:, 0], np.full(len(dst), s)) and
              np.array_equal(rows[:, 1], dst),
              f"source {s}: {len(rows)} answers vs {len(dst)} from the "
              "oracle")
        if self.weighted:
            check(np.array_equal(ans[1], vals), f"source {s}: distances differ")


class DagOracle(Oracle):
    """Single-source longest paths (``agg="max"``) or path counts
    (``agg="sum"``) over a DAG whose arcs all run one way in vertex-id order
    (the topological order), in int64: scipy's BFS finds the vertices the
    source reaches, then each of them, in topological order, folds its
    in-arcs from reached vertices (max of d[u] + w, or sum of c[u] * w).
    The edge list is a set of arcs; the source never answers for itself."""

    weighted = True

    def __init__(self, edges, n, agg):
        from scipy.sparse import csr_matrix
        src, dst = edges[:, 0], edges[:, 1]
        fwd, back = bool((src < dst).all()), bool((src > dst).all())
        check(fwd or back, "DagOracle: the arcs are not in vertex-id order")
        self.n, self.agg, self.step = n, agg, 1 if fwd else -1
        self.g = csr_matrix((np.ones(len(edges), np.float32), (src, dst)),
                            shape=(n, n))
        order = np.argsort(dst, kind="stable")
        self.in_src = src[order]
        self.in_w = edges[order, 2].astype(np.int64)
        self.in_ptr = np.concatenate(
            [[0], np.cumsum(np.bincount(dst, minlength=n))])

    def answer(self, s):
        from scipy.sparse.csgraph import breadth_first_order
        reach = breadth_first_order(self.g, s, directed=True,
                                    return_predecessors=False)
        dst = np.sort(reach[reach != s])
        val = np.zeros(self.n, np.int64)
        val[s] = 0 if self.agg == "max" else 1
        seen = np.zeros(self.n, bool)
        seen[s] = True
        for v in dst[::self.step]:
            lo, hi = self.in_ptr[v], self.in_ptr[v + 1]
            us, ws = self.in_src[lo:hi], self.in_w[lo:hi]
            live = seen[us]
            us, ws = us[live], ws[live]
            val[v] = (val[us] + ws).max() if self.agg == "max" else \
                (val[us] * ws).sum()
            seen[v] = True
        if self.agg == "sum":
            check(not len(dst) or val[dst].max() < 2 ** 24,
                  f"source {s}: a path count reaches 2^24, past f32's exact "
                  "integers")
        return dst, val[dst]


def drive(label, svc, pred, oracle, srcs, srcs2, single, weighted, repr_):
    """One service's traffic: batch, second batch, repeat (cache hits), one
    ask; then the oracle on 3 batch sources and the single one."""
    import torch

    def q(s):
        return (pred, (s, None)) if not weighted else (pred, (s, None, None))

    def timed(call):
        st = dataclasses.replace(svc.stats)
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return (out, secs,
                svc.stats.fixpoint_iterations - st.fixpoint_iterations,
                svc.stats.dense_fixpoints - st.dense_fixpoints)

    first, s1, it1, _ = timed(lambda: svc.ask_batch([q(s) for s in srcs]))
    _, s2, it2, _ = timed(lambda: svc.ask_batch([q(s) for s in srcs2]))
    hits0 = svc.cache.hits
    again, s3, _, fx3 = timed(lambda: svc.ask_batch([q(s) for s in srcs]))
    check(fx3 == 0 and svc.cache.hits - hits0 == len(srcs),
          f"{label}: the repeated batch was not all cache hits")
    check(all(a is b for a, b in zip(again, first)), f"{label}: cache miss")
    one, s4, it4, _ = timed(lambda: svc.ask(*q(single)))
    rel = svc.explain()["relations"][pred]
    check(rel["repr"] == repr_, f"{label}: carrier {rel['repr']} != {repr_}")
    say(f"{label}: carrier={rel['repr']} n_alloc={rel['n_alloc']} | "
        f"batch {len(srcs)}: {len(srcs) / s1:.1f} qps (cold: packs the "
        f"carrier; {it1} iterations) | batch {len(srcs2)}: "
        f"{len(srcs2) / s2:.1f} qps ({it2} iterations) | repeat: "
        f"{len(srcs) / s3:.1f} qps (cache) | ask: {s4 * 1e3:.1f} ms "
        f"({it4} iterations)")
    t0 = time.perf_counter()
    for s, ans in [*zip(srcs[:3], first[:3]), (single, one)]:
        oracle.check(s, ans)
    say(f"{label}: 4 sources equal the {type(oracle).__name__} "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"qps_cold": len(srcs) / s1, "qps_warm": len(srcs2) / s2,
            "iterations": [it1, it2, it4]}


def breakdown(torch, label, svc, pred, srcs):
    """Where a warm batch's time goes, measured after the path's launch
    counts are read: the batched fixpoint on the card (seed step
    included), the copy of its table to the host, and formatting the
    answers.  The rest of ``ask_batch`` is cache and bookkeeping.  Also
    times packing the carrier again (what a cold batch adds), on the host
    and into device memory."""
    ds = svc._dense_state(pred)
    torch.cuda.synchronize()
    tp = time.perf_counter()
    repacked = type(ds)(svc, ds.low)
    torch.cuda.synchronize()
    pack_ms = (time.perf_counter() - tp) * 1e3
    del repacked
    t0 = time.perf_counter()
    res = ds.run_batch(svc, srcs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    table = res.table[:len(srcs)].cpu().numpy()
    t2 = time.perf_counter()
    for j, s in enumerate(srcs):
        svc._format(ds, s, table[j])
    t3 = time.perf_counter()
    out = {"fixpoint_ms": (t1 - t0) * 1e3, "copy_ms": (t2 - t1) * 1e3,
           "format_ms": (t3 - t2) * 1e3, "iterations": res.iterations,
           "pack_ms": pack_ms}
    say(f"{label} warm batch of {len(srcs)}: fixpoint {out['fixpoint_ms']:.1f}"
        f" ms ({res.iterations} iterations), copy to host "
        f"{out['copy_ms']:.1f} ms, formatting {out['format_ms']:.1f} ms; "
        f"packing the carrier again {pack_ms:.1f} ms")
    return out


def _sources(rng, n, k):
    picks = rng.permutation(n)[:k + k + 1]
    return [int(s) for s in picks[:k]], [int(s) for s in picks[k:2 * k]], \
        int(picks[-1])


def _seed_rows(torch, take, srcs, pads, zero):
    """The first iteration's frontier, as the batch layer builds it: the
    sources' carrier rows padded to the pad level with ⊕-zero rows."""
    from repro_torch.service.batch import pad_batch_size
    bp = pad_batch_size(len(srcs), pads)
    idx = np.asarray(srcs + [srcs[0]] * (bp - len(srcs)), np.int64)
    init = take(idx)
    init[len(srcs):] = zero
    return init


def measure(torch, name, kernel, plain, args, calls, bound, library=None):
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = equal_and_err(torch, got, want)
    del got, want
    ms = time_ms(torch, lambda: kernel(*args), calls)
    plain_ms = time_ms(torch, lambda: plain(*args), 2, rounds=3)
    lib_ms = time_ms(torch, library, calls) if library else None
    bound_ms, bound_by = bound
    say(f"{name}: {ms:.3f} ms (plain {plain_ms:.3f} ms, library "
        f"{'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
        f"{bound_ms:.4f} ms by {bound_by}) at "
        f"{[tuple(a.shape) for a in args if hasattr(a, 'shape')]}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def _bound(bytes_, ops, ops_rate):
    t_bytes, t_ops = bytes_ / HBM_BYTES_S, ops / ops_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def dense_phase(results):
    import torch
    from repro_torch.data import gnp_graph
    from repro_torch.kernels import boolmm, minplus, ops
    from repro_torch.service import DatalogService
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    n = DENSE_N
    edges = gnp_graph(n, DENSE_P, seed=SEED)
    wedges = _weighted(rng, edges)
    say(f"dense graph: gnp_graph({n}, {DENSE_P}): {len(edges)} arcs "
        f"({time.perf_counter() - t0:.1f} s)")
    srcs, srcs2, single = _sources(rng, n, DENSE_BATCH)
    tc = DatalogService(TC, db={"arc": edges})
    sp = DatalogService(SPATH, db={"darc": wedges})
    ops.reset_launch_counts()
    phase = {"tc": drive("dense TC", tc, "tc", Oracle(edges, n, False), srcs,
                         srcs2, single, False, "dense"),
             "spath": drive("dense SPATH", sp, "dpath",
                            Oracle(wedges, n, True), srcs, srcs2, single,
                            True, "dense")}
    counts = ops.launch_counts()
    say(f"dense path launches: {counts}")
    for k in ("bool_matmul", "minplus_matmul"):
        check(counts[k] > 0, f"{k} never launched on the dense path")
        results[k] = {"launches": counts[k]}
    phase["tc"]["breakdown"] = breakdown(torch, "dense TC", tc, "tc", srcs2)
    phase["spath"]["breakdown"] = breakdown(torch, "dense SPATH", sp, "dpath",
                                            srcs2)
    results["dense_phase"] = phase

    adj = tc._dense_state("tc").matrix
    w = sp._dense_state("dpath").matrix
    f = _seed_rows(torch, lambda i: adj[torch.from_numpy(i).to(adj.device)],
                   srcs, tc.batch_pads, False)
    fw = _seed_rows(torch, lambda i: w[torch.from_numpy(i).to(w.device)],
                    srcs, sp.batch_pads, float("inf"))
    B, na = f.shape
    # ops: one AND + one OR per live frontier entry and live row entry it
    # meets; bytes: each operand read once, the result written once
    live_ops = 2 * float((f.double() @ adj.sum(1).double()).sum())
    results["bool_matmul"].update(measure(
        torch, "K1 bool_frontier_matmul", boolmm.bool_frontier_matmul,
        boolmm.plain, (f, adj), 20,
        _bound(2 * B * na + na * na, live_ops, INT8_OPS_S),
        library=_matmul_call(torch, f, adj)))
    fin = torch.isfinite
    live_ops = 2 * float((fin(fw).double() @ fin(w).sum(1).double()).sum())
    results["minplus_matmul"].update(measure(
        torch, "K2 minplus_frontier_matmul", minplus.minplus_frontier_matmul,
        minplus.plain, (fw, w), 10,
        _bound(4 * (2 * B * na + na * na), live_ops, F32_OPS_S)))
    del adj, w, f, fw
    phase["appends"] = dense_appends(tc, sp, edges, wedges, srcs, single)
    del tc, sp
    torch.cuda.empty_cache()


def _matmul_call(torch, f, adj):
    ff, af = f.float(), adj.float()
    return lambda: torch.matmul(ff, af)


def _sparse_mm_call(torch, csr, f):
    """``torch.sparse.mm`` of the transposed f32 adjacency (spine arcs)
    with the f32 frontier: the same segment sum the bool step thresholds
    (all-ones values) and the plus-times step computes (the arc weights)."""
    m = int(csr.nnz)
    idx = torch.stack([csr.col_idx[:m].long(), csr.src_idx[:m].long()])
    vals = csr.edge_val[:m].float() if csr.kind == "plustimes" else \
        torch.ones(m, device=f.device)
    at = torch.sparse_coo_tensor(
        idx, vals, (csr.n_alloc, csr.n_alloc),
        check_invariants=False).coalesce().to_sparse_csr()
    ft = f.T.float().contiguous()
    return lambda: torch.sparse.mm(at, ft)


def dense_appends(tc, sp, edges, wedges, srcs, single):
    """Appends on the warm dense Gn-p services: 1,000 arcs, then one arc to
    vertex :data:`DENSE_GROW`, past the allocation (a rebuild; the cached
    rows are re-padded).  Each cached closure resumes; K1 and K2 must run;
    3 resumed sources, the single one and the new vertex equal the oracle
    on the union."""
    import torch
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED + 6)
    n = DENSE_N
    extra = np.stack([rng.integers(0, n, 1000), rng.integers(0, n, 1000)], 1)
    grow = np.array([[srcs[0], DENSE_GROW]], np.int64)
    out = {}
    ops.reset_launch_counts()
    for label, svc, pred, edb, base in (("dense TC", tc, "tc", "arc", edges),
                                        ("dense SPATH", sp, "dpath", "darc",
                                         wedges)):
        weighted = base.shape[1] == 3
        union = [base]
        st0 = dataclasses.replace(svc.stats)
        t0 = time.perf_counter()
        for rows in (extra, grow):
            rows = _weighted(rng, rows) if weighted else rows
            union.append(rows)
            svc.append(edb, rows)
        torch.cuda.synchronize()
        rel = svc.explain()["relations"][pred]
        rep = {"seconds": time.perf_counter() - t0, "n_alloc": rel["n_alloc"],
               "resumed_rows": svc.stats.resumed_rows - st0.resumed_rows,
               "resumed_iterations":
                   svc.stats.fixpoint_iterations - st0.fixpoint_iterations}
        grown = -(-(DENSE_GROW + 1) // svc.n_align) * svc.n_align
        check(rel["n_alloc"] == grown and rel["repr"] == "dense",
              f"{label} append: n_alloc {rel['n_alloc']}, {rel['repr']}")
        say(f"{label} appends (1,000 arcs, then one to vertex {DENSE_GROW})"
            f": {rep}")
        oracle = Oracle(np.concatenate(union), DENSE_GROW + 1, weighted)
        qs = srcs[:3] + [single, DENSE_GROW]
        answers = svc.ask_batch([(pred, (s, None, None) if weighted
                                  else (s, None)) for s in qs])
        for s, ans in zip(qs, answers):
            oracle.check(s, ans)
        say(f"{label} after the appends: 5 sources equal the Oracle")
        out[label] = rep
    counts = ops.launch_counts()
    say(f"dense appends launches: {counts}")
    for k in ("bool_matmul", "minplus_matmul"):
        check(counts[k] > 0, f"{k} never launched on the dense appends")
    return out


def cpath_appends(cp, cedges, srcs):
    """Appends on the warm dense CPATH service: 500 new arcs with src < dst
    resume the cached counts by increment replay and must equal the int64
    DP oracle on the union; the same append again must launch nothing and
    change no count."""
    import torch
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED + 7)
    have = set(map(tuple, cedges[:, :2].tolist()))
    cand = np.sort(rng.integers(0, CPATH_N, (4000, 2)), axis=1)
    cand = cand[cand[:, 0] < cand[:, 1]]
    new = np.array([r for r in map(tuple, cand.tolist()) if r not in have],
                   np.int64)
    new = np.unique(new, axis=0)[:500]
    new = np.concatenate([new, np.ones((len(new), 1), np.int64)], 1)
    check(len(new) == 500, "CPATH append: too few new arcs")
    q = [("cpath", (s, None, None)) for s in srcs]
    out = {}
    for label in ("new", "repeat"):
        before = cp.ask_batch(q)
        ops.reset_launch_counts()
        st0 = dataclasses.replace(cp.stats)
        t0 = time.perf_counter()
        cp.append("d", new)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        check(not any(counts.values()),
              f"CPATH append ({label}): a counted kernel launched")
        fixpoints = cp.stats.dense_fixpoints - st0.dense_fixpoints
        rep = {"seconds": secs, "fixpoints": fixpoints,
               "resumed_rows": cp.stats.resumed_rows - st0.resumed_rows,
               "resumed_iterations":
                   cp.stats.fixpoint_iterations - st0.fixpoint_iterations}
        after = cp.ask_batch(q)
        if label == "new":
            check(fixpoints == 1, "CPATH append: no increment replay ran")
            oracle = DagOracle(np.concatenate([cedges, new]), CPATH_N, "sum")
            for s, ans in zip(srcs, after):
                oracle.check(s, ans)
        else:
            check(fixpoints == 0, "CPATH repeated append ran a fixpoint")
            check(all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                      for a, b in zip(after, before)),
                  "CPATH repeated append changed a count")
        say(f"dense CPATH append ({label}, 500 arcs): {rep}; "
            f"{len(srcs)} sources {'equal the DagOracle' if label == 'new' else 'unchanged'}")
        out[label] = rep
    return out


def _csr_seed_work(torch, csr, f, live, s):
    """The least (bytes, operations) of a CSR step at frontier ``f``: a push
    over the live sources' out-arcs, one ⊗ and one ⊕ per (row, live
    source, arc); bytes: the frontier in and out (``s`` bytes a value),
    those arcs' (dst, val) once, the row pointers."""
    B, na = f.shape
    outdeg = (csr.row_ptr[1:] - csr.row_ptr[:-1]).double()
    work = float((live.double() @ outdeg).sum())
    arcs = float((live.any(0).double() * outdeg).sum())
    return 2 * B * na * s + arcs * (4 + s) + 4 * (na + 1), 2 * work


def _csr_seed_bound(torch, csr, f, live, s, rate):
    return _bound(*_csr_seed_work(torch, csr, f, live, s), rate)


def csr_phase(results):
    import torch
    from repro_torch.core.sparse import rows_from_sources
    from repro_torch.data import powerlaw_graph
    from repro_torch.kernels import ops, spmv
    from repro_torch.service import DatalogService
    rng = np.random.default_rng(SEED + 1)
    n, m = CSR_N, CSR_M
    t0 = time.perf_counter()
    edges = powerlaw_graph(n, m, alpha=CSR_ALPHA, seed=SEED)
    wedges = _weighted(rng, edges)
    say(f"CSR graph: powerlaw_graph({n}, {m}, alpha={CSR_ALPHA}): "
        f"{len(edges)} arcs ({time.perf_counter() - t0:.1f} s)")
    srcs, srcs2, single = _sources(rng, n, CSR_BATCH)
    tc = DatalogService(TC, db={"arc": edges}, bits=20)
    sp = DatalogService(SPATH, db={"darc": wedges}, bits=20)
    sp_oracle = Oracle(wedges, n, True)
    ops.reset_launch_counts()
    phase = {"tc": drive("CSR TC", tc, "tc", Oracle(edges, n, False), srcs,
                         srcs2, single, False, "csr"),
             "spath": drive("CSR SPATH", sp, "dpath", sp_oracle,
                            srcs, srcs2, single, True, "csr")}
    counts = ops.launch_counts()
    say(f"CSR path launches: {counts}")
    for k in ("csr_bool_step", "csr_minplus_step"):
        check(counts[k] > 0, f"{k} never launched on the CSR path")
        results[k] = {"launches": counts[k]}
    phase["tc"]["breakdown"] = breakdown(torch, "CSR TC", tc, "tc", srcs2)
    phase["spath"]["breakdown"] = breakdown(torch, "CSR SPATH", sp, "dpath",
                                            srcs2)
    results["csr_phase"] = phase
    rel = tc.explain()["relations"]["tc"]
    say(f"CSR layout: nnz={rel['nnz']} e_alloc={rel['e_alloc']} slices="
        f"{[(s['rows'], s['cap']) for s in rel['padding']['slices']]}")

    for key, svc, pred, step, plain, s, rate, zero in (
            ("csr_bool_step", tc, "tc", spmv.csr_bool_step, spmv.plain_bool,
             1, INT8_OPS_S, False),
            ("csr_minplus_step", sp, "dpath", spmv.csr_minplus_step,
             spmv.plain_minplus, 4, F32_OPS_S, float("inf"))):
        csr = svc._dense_state(pred).csr
        f = _seed_rows(torch, lambda i: rows_from_sources(csr, i), srcs,
                       svc.batch_pads, zero)
        live = f if f.dtype == torch.bool else torch.isfinite(f)
        results[key].update(measure(
            torch, f"{key} ({pred})", step, plain, (f, csr), 10,
            _csr_seed_bound(torch, csr, f, live, s, rate),
            library=_sparse_mm_call(torch, csr, f) if s == 1 else None))
    del tc, sp
    torch.cuda.empty_cache()
    return edges, wedges, sp_oracle


def _path_launches(counts, label, want, results):
    """Check the kernel ``want`` (None: no counted kernel at all) ran on the
    path just driven, and record its launches."""
    say(f"{label} launches: {counts}")
    if want is None:
        check(not any(counts.values()), f"{label}: a counted kernel launched")
        return
    check(counts[want] > 0, f"{want} never launched on the {label} path")
    results[want] = {"launches": counts[want]}


def dag_phase(results, csr_edges):
    """The max<> and sum<> carriers: LPATH and CPATH, dense and CSR (module
    docstring, phase 6), each path driven alone between launch-count reads,
    then the divergence check and the kernels timed at their paths' first
    frontiers."""
    import torch
    from repro_torch.core.seminaive import FixpointDivergenceError
    from repro_torch.core.sparse import rows_from_sources
    from repro_torch.data import dag_graph
    from repro_torch.kernels import minplus, ops, spmv
    from repro_torch.service import DatalogService
    rng = np.random.default_rng(SEED + 3)
    phase = {}

    def run(label, program, pred, edges, n, batch, repr_, semiring, kernel,
            **kw):
        srcs, srcs2, single = _sources(rng, n, batch)
        svc = DatalogService(program, db={"d": edges}, bits=20, **kw)
        oracle = DagOracle(edges, n, "max" if pred == "lpath" else "sum")
        ops.reset_launch_counts()
        out = drive(label, svc, pred, oracle, srcs, srcs2, single, True,
                    repr_)
        _path_launches(ops.launch_counts(), label, kernel, results)
        rel = svc.explain()["relations"][pred]
        check(rel["semiring"] == semiring,
              f"{label}: semiring {rel['semiring']} != {semiring}")
        out["breakdown"] = breakdown(torch, label, svc, pred, srcs2)
        phase[label] = out
        return svc, srcs

    t0 = time.perf_counter()
    ledges = dag_graph(LPATH_N, LPATH_P, seed=SEED, max_w=LPATH_W)
    say(f"dense LPATH graph: dag_graph({LPATH_N}, {LPATH_P}, max_w={LPATH_W})"
        f": {len(ledges)} arcs ({time.perf_counter() - t0:.1f} s)")
    lp, lsrcs = run("dense LPATH", LPATH, "lpath", ledges, LPATH_N,
                    DENSE_BATCH, "dense", "max_plus", "maxplus_matmul")
    w = lp._dense_state("lpath").matrix
    fw = _seed_rows(torch, lambda i: w[torch.from_numpy(i).to(w.device)],
                    lsrcs, lp.batch_pads, float("-inf"))
    fin = torch.isfinite
    live_ops = 2 * float((fin(fw).double() @ fin(w).sum(1).double()).sum())
    B, na = fw.shape
    results["maxplus_matmul"].update(measure(
        torch, "K2 maxplus_frontier_matmul", minplus.maxplus_frontier_matmul,
        minplus.plain_max, (fw, w), 10,
        _bound(4 * (2 * B * na + na * na), live_ops, F32_OPS_S)))
    del lp, w, fw
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cedges = dag_graph(CPATH_N, CPATH_P, seed=SEED)
    say(f"dense CPATH graph: dag_graph({CPATH_N}, {CPATH_P}): {len(cedges)} "
        f"arcs ({time.perf_counter() - t0:.1f} s)")
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "f32 products may use TF32: dense path counts would be inexact")
    cp, csrcs = run("dense CPATH", CPATH, "cpath", cedges, CPATH_N,
                    DENSE_BATCH, "dense", "plus_times", None, sparse=False)
    phase["dense CPATH"]["appends"] = cpath_appends(cp, cedges, csrcs[:4])
    del cp
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dag = csr_edges[csr_edges[:, 0] > csr_edges[:, 1]]
    lw = np.concatenate([dag, rng.integers(1, 10, (len(dag), 1))], 1)
    cw = np.concatenate([dag, np.ones((len(dag), 1), np.int64)], 1)
    indeg = np.bincount(dag[:, 1], minlength=CSR_N)
    say(f"CSR DAG: the {len(dag)} arcs of the power-law graph with src > dst"
        f", largest in-degree {int(indeg.max())} "
        f"({time.perf_counter() - t0:.1f} s)")
    del dag, indeg
    for label, program, pred, edges, semiring, key, plain, zero in (
            ("CSR LPATH", LPATH, "lpath", lw, "max_plus", "csr_maxplus_step",
             spmv.plain_maxplus, float("-inf")),
            ("CSR CPATH", CPATH, "cpath", cw, "plus_times",
             "csr_plustimes_step", spmv.plain_plustimes, 0.0)):
        svc, srcs = run(label, program, pred, edges, CSR_N, CSR_BATCH, "csr",
                        semiring, key)
        csr = svc._dense_state(pred).csr
        f = _seed_rows(torch, lambda i: rows_from_sources(csr, i), srcs,
                       svc.batch_pads, zero)
        live = torch.isfinite(f) if key == "csr_maxplus_step" else f != 0
        results[key].update(measure(
            torch, f"{key} ({pred})", ops.csr_frontier_step(csr.kind), plain,
            (f, csr), 10, _csr_seed_bound(torch, csr, f, live, 4, F32_OPS_S),
            library=_sparse_mm_call(torch, csr, f)
            if key == "csr_plustimes_step" else None))
        del svc, csr, f, live
        torch.cuda.empty_cache()

    cycle = np.array([[0, 1, 1], [1, 2, 1], [2, 0, 1], [2, 3, 1]], np.int64)
    for sparse in (False, True):
        svc = DatalogService(CPATH, db={"d": cycle}, sparse=sparse)
        try:
            svc.ask_batch([("cpath", (0, None, None)), ("cpath", (3, None, None))])
        except FixpointDivergenceError as err:
            msg = str(err)
        else:
            check(False, "a cyclic CPATH served answers")
        rel = svc.explain()["relations"]["cpath"]
        check(rel["repr"] == ("csr" if sparse else "dense")
              and len(svc.cache) == 0 and svc.stats.dense_fixpoints == 0,
              f"cyclic CPATH ({rel['repr']}): something was cached")
        say(f"cyclic CPATH ({rel['repr']}): FixpointDivergenceError ({msg})")
    results["dag_phase"] = phase


def measure_rows(torch, name, kernel, plain, args, rows, calls, bound):
    """:func:`measure` for a kernel whose plain version cannot run whole at
    this width: the plain version runs on blocks of :data:`ROW_BLOCK` rows
    (``rows(r0, r1)`` gives its arguments for one block), each block is
    held to the kernel's rows, and its time is that of one more pass over
    all the blocks (the checked pass warmed it up; a pass takes seconds)."""
    got = kernel(*args)
    got = got if isinstance(got, tuple) else (got,)
    n = got[0].shape[0]
    blocks = [(r0, min(r0 + ROW_BLOCK, n)) for r0 in range(0, n, ROW_BLOCK)]
    err = 0.0
    for r0, r1 in blocks:
        want = plain(*rows(r0, r1))
        for g, w in zip(got, want if isinstance(want, tuple) else (want,)):
            err = max(err, equal_and_err(torch, g[r0:r1], w))
        del want
    del got
    torch.cuda.synchronize()
    ms = time_ms(torch, lambda: kernel(*args), calls)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for r0, r1 in blocks:
        plain(*rows(r0, r1))
    stop.record()
    stop.synchronize()
    plain_ms = start.elapsed_time(stop)
    bound_ms, bound_by = bound
    say(f"{name}: {ms:.3f} ms (plain in {len(blocks)} row blocks "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by}) at "
        f"{[tuple(a.shape) for a in args]}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _k8_bound(torch, d, a, mask):
    """K8's bound at (d, a, mask): an add and a min per live candidate (a
    finite d[m, k] of a Δ row m against a finite a[k, j]) and a min and a
    compare per output; bytes: d, a and dnew at 4 bytes, the mask and the
    flags at 1."""
    n = d.shape[0]
    fin = torch.isfinite
    live = float(((fin(d) & mask[:, None]).double()
                  @ fin(a).sum(1).double()).sum())
    return _bound(3 * 4 * n * n + 2 * n, 2 * live + 2 * n * n, F32_OPS_S)


def _check_rows(label, table, srcs, oracle):
    """Rows ``srcs`` of an all-pairs table against the single-source
    oracle (Dijkstra distances, or BFS reachability for a bool table)."""
    rows = table[srcs].cpu().numpy()
    for s, row in zip(srcs, rows):
        dst, vals = oracle.answer(s)
        got = np.nonzero(np.isfinite(row) if oracle.weighted else row)[0]
        check(np.array_equal(got, dst), f"{label}: row {s} reaches "
              f"{len(got)} vertices, the oracle {len(dst)}")
        if oracle.weighted:
            check(np.array_equal(row[got].astype(np.int64), vals),
                  f"{label}: row {s}: distances differ")
    say(f"{label}: {len(srcs)} sampled rows equal the "
        f"{'Dijkstra' if oracle.weighted else 'BFS'} oracle")


def allpairs_phase(results):
    """The dense all-pairs path on G10K (module docstring, phase 7): each
    path driven alone between launch-count reads, then K8, K2 and K1 timed
    at its shapes."""
    import torch
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    from repro_torch.core import seminaive as sn
    from repro_torch.core.semiring import MIN_PLUS
    from repro_torch.data import gnp_graph
    from repro_torch.kernels import boolmm, minplus, ops, relax
    rng = np.random.default_rng(SEED + 8)
    n = AP_N
    t_phase = t0 = time.perf_counter()
    edges = gnp_graph(n, AP_P, seed=SEED)
    wedges = _weighted(rng, edges)
    src = torch.from_numpy(edges[:, 0]).to(DEVICE)
    dst = torch.from_numpy(edges[:, 1]).to(DEVICE)
    adj = torch.zeros((n, n), dtype=torch.bool, device=DEVICE)
    adj[src, dst] = True
    w = torch.full((n, n), float("inf"), device=DEVICE)
    w[src, dst] = torch.from_numpy(wedges[:, 2].astype(np.float32)).to(DEVICE)
    del src, dst
    say(f"all-pairs graph (G10K): gnp_graph({n}, {AP_P}): {len(edges)} arcs,"
        f" (n, n) bool and f32 matrices on the card "
        f"({time.perf_counter() - t0:.1f} s)")
    sample = [int(s) for s in rng.permutation(n)[:AP_SAMPLE]]
    phase = {}

    def path(label, fn, iterations, want):
        """Drive one path between launch-count reads; ``want`` maps each
        counted kernel to its launches as a function of the iterations."""
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        it = iterations(out)
        say(f"{label}: {it} iterations, {secs:.2f} s; launches K1 "
            f"{counts['bool_matmul']}, K2 {counts['minplus_matmul']}, K8 "
            f"{counts['relax_step']}")
        expect = {k: 0 for k in counts}
        expect.update({k: f(it) for k, f in want.items()})
        check(counts == expect, f"{label}: launches {counts}, expected "
              f"{ {k: v for k, v in expect.items() if v} }")
        phase[label] = {"iterations": it, "seconds": secs,
                        "launches": {k: v for k, v in counts.items() if v}}
        return out

    # (a) APSP three ways
    lin = path("APSP linear", lambda: sn.shortest_paths_dense(w),
               lambda r: r.iterations, {"minplus_matmul": lambda i: i})

    def k8_loop():
        d, mask = w, torch.ones(n, dtype=torch.bool, device=DEVICE)
        inputs = []  # each trip's (d, mask), kept to time K8 at them
        while bool(mask.any()):
            inputs.append((d, mask))
            d, mask = ops.relax(d, w, mask)
        return d, len(inputs), inputs

    d8, trips, inputs = path("APSP K8 loop", k8_loop, lambda r: r[1],
                             {"relax_step": lambda i: i})
    steps = {"first": inputs[0], "middle": inputs[trips // 2],
             "last": inputs[-1]}
    del inputs
    results["relax_step"] = {"launches": trips}
    check(trips == lin.iterations, f"K8 loop: {trips} trips, the linear "
          f"form {lin.iterations} iterations")
    check(torch.equal(d8, lin.table), "K8 loop table != shortest_paths_dense")
    del d8
    nonlin = path("APSP nonlinear",
                  lambda: sn.fixpoint_dense(MIN_PLUS, w, w, form="nonlinear"),
                  lambda r: r.iterations,
                  {"minplus_matmul": lambda i: 2 * i})
    check(torch.equal(nonlin.table, lin.table),
          "nonlinear APSP table != the linear form's")
    del nonlin
    _check_rows("APSP", lin.table, sample, Oracle(wedges, n, True))
    phase["APSP linear"]["finite_pairs"] = int(torch.isfinite(lin.table).sum())
    del lin

    # (b) TC through K1
    tc = path("TC", lambda: sn.transitive_closure_dense(adj),
              lambda r: r.iterations, {"bool_matmul": lambda i: i})
    _check_rows("TC", tc.table, sample, Oracle(edges, n, False))
    phase["TC"]["pairs"] = int(tc.table.sum())
    del tc

    # (c) SG: the sandwich form, K1 twice an iteration
    sg = path("SG", lambda: sn.same_generation_dense(adj),
              lambda r: r.iterations, {"bool_matmul": lambda i: 2 * i})
    t0 = time.perf_counter()
    sg_plain = sn.same_generation_dense(adj, matmul=boolmm.plain)
    torch.cuda.synchronize()
    phase["SG"].update(pairs=int(sg.table.sum()),
                       plain_seconds=time.perf_counter() - t0)
    check(torch.equal(sg.table, sg_plain.table)
          and (sg.iterations, sg.generated)
          == (sg_plain.iterations, sg_plain.generated),
          "SG != its run with the plain boolean product")
    say(f"SG: {phase['SG']['pairs']} pairs; equal to its plain-product run "
        f"({phase['SG']['plain_seconds']:.2f} s)")
    del sg, sg_plain

    # (d) CC: K2 with B = 1
    cc = path("CC", lambda: sn.connected_components_dense(adj),
              lambda r: r.iterations, {"minplus_matmul": lambda i: i})
    k, lab = connected_components(
        csr_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                   shape=(n, n)), directed=False)
    least = np.full(k, n)
    np.minimum.at(least, lab, np.arange(n))
    check(np.array_equal(cc.table.cpu().numpy(), least[lab].astype(np.float32)),
          "CC labels != scipy's components")
    phase["CC"]["components"] = int(k)
    say(f"CC: {k} components, equal to scipy's")
    del cc

    # K8 at the loop's first, middle and last steps' inputs, beside one K2
    # linear step with its merge and changed test at the same inputs
    def k2_step(d, mask):
        dm = torch.where(mask[:, None], d, float("inf"))
        dn = torch.minimum(d, minplus.minplus_matmul(dm, w))
        return dn, sn._ne(MIN_PLUS, dn, d).any(-1)

    timed = {}
    for label, (d, mask) in steps.items():
        got, ref = relax.relax_step(d, w, mask), k2_step(d, mask)
        check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
              f"K8 != K2 + merge at the {label} step")
        del got, ref
        timed[label] = measure_rows(
            torch, f"K8 relax_step ({label} step, {int(mask.sum())} Δ rows)",
            relax.relax_step, relax.plain, (d, w, mask),
            lambda r0, r1: (d[r0:r1], w, mask[r0:r1]), 3,
            _k8_bound(torch, d, w, mask))
        timed[label]["delta_rows"] = int(mask.sum())
        timed[label]["k2_merge_ms"] = time_ms(
            torch, lambda: k2_step(d, mask), 3)
        say(f"K2 + merge + changed ({label} step): "
            f"{timed[label]['k2_merge_ms']:.3f} ms")
    results["relax_step"].update(
        {k: timed["first"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms")})
    phase["k8_timed"] = timed
    del steps, d, mask

    # K2 and K1 at M = n: the first linear APSP and TC steps
    fin = torch.isfinite
    live_ops = 2 * float((fin(w).double() @ fin(w).sum(1).double()).sum())
    phase["k2_full"] = measure_rows(
        torch, "K2 minplus_matmul (M = n)", minplus.minplus_matmul,
        minplus.plain, (w, w), lambda r0, r1: (w[r0:r1], w), 3,
        _bound(4 * 3 * n * n, live_ops, F32_OPS_S))
    live_ops = 2 * float((adj.double() @ adj.sum(1).double()).sum())
    phase["k1_full"] = measure(
        torch, "K1 bool_matmul (M = n)", boolmm.bool_matmul, boolmm.plain,
        (adj, adj), 3, _bound(3 * n * n, live_ops, INT8_OPS_S),
        library=_matmul_call(torch, adj, adj))
    phase["seconds"] = time.perf_counter() - t_phase
    say(f"all-pairs phase: {phase['seconds']:.1f} s")
    results["allpairs_phase"] = phase
    del adj, w
    torch.cuda.empty_cache()


def _k7_bound(torch, csr, f):
    """K7's bound at frontier ``f``: K4's (the same function,
    :func:`_csr_seed_work`) plus the plan entries the kernel must read, the
    live items' chunk indices and the unit offsets (pad items are never
    read; each unit reads its tile and first flags once, a few KB)."""
    bytes_, ops = _csr_seed_work(torch, csr, f, torch.isfinite(f), 4)
    plan = 4 * (int(csr.plan_unit[-1]) + csr.plan_unit.numel())
    return _bound(bytes_ + plan, ops, F32_OPS_S)


def _plan_report(csr):
    units = csr.plan_unit.cpu().numpy()
    items, live = int(csr.plan_tile.numel()), int(units[-1])
    return {"items": items, "live": live, "pad": items - live,
            "units": len(units) - 1, "plan_cfg": list(csr.plan_cfg)}


def _launch_check(label, counts, stats0, svc, kernel, absent):
    """``kernel`` launched once per fixpoint iteration plus one seed step
    per fixpoint since ``stats0``; ``absent`` never launched."""
    st = svc.stats
    want = (st.fixpoint_iterations - stats0.fixpoint_iterations
            + st.dense_fixpoints - stats0.dense_fixpoints)
    say(f"{label} launches: {counts} (iterations + seed steps: {want})")
    check(counts[kernel] == want and want > 0,
          f"{label}: {kernel} launched {counts[kernel]} times, iterations "
          f"+ seed steps {want}")
    check(counts[absent] == 0, f"{label}: {absent} launched")


def _check_sources(label, svc, pred, oracle, srcs):
    """Ask ``srcs`` (cache hits where resumed) and hold 4 of them to the
    oracle."""
    answers = svc.ask_batch([(pred, (s, None, None)) for s in srcs])
    for s, ans in list(zip(srcs, answers))[:4]:
        oracle.check(s, ans)
    say(f"{label}: 4 sources equal the {type(oracle).__name__}")


def tuned_phase(results, wedges, oracle):
    """The tuned CSR path on phase 5's weighted power-law arcs: a pinned
    ``KernelConfig(use_kernel=True)`` SPATH service (K7 on every step),
    appends to it (tail, then a fold), then ``tune=True``'s measured
    search."""
    import torch
    from repro_torch.core import sparse
    from repro_torch.kernels import autotune, ops, spmv
    from repro_torch.service import DatalogService
    rng = np.random.default_rng(SEED + 4)
    n = CSR_N
    srcs, srcs2, single = _sources(rng, n, CSR_BATCH)
    sp = DatalogService(SPATH, db={"darc": wedges}, bits=20, sparse=True,
                        tune=autotune.KernelConfig(use_kernel=True))
    ops.reset_launch_counts()
    st0 = dataclasses.replace(sp.stats)
    phase = {"spath": drive("tuned CSR SPATH", sp, "dpath", oracle, srcs,
                            srcs2, single, True, "csr")}
    counts = ops.launch_counts()
    _launch_check("tuned CSR SPATH", counts, st0, sp, "csr_minplus_tiled_step",
                  "csr_minplus_step")
    results["csr_minplus_tiled_step"] = {
        "launches": counts["csr_minplus_tiled_step"]}
    csr = sp._dense_state("dpath").csr
    tuning = sp.explain()["kernels"]["tuning"]["dpath"]
    check(tuning == {"config": autotune.KernelConfig(use_kernel=True).as_dict(),
                     "pinned": True}, f"tuned SPATH: explain tuning {tuning}")
    dst = csr.col_idx.cpu().numpy()
    t0 = time.perf_counter()
    sparse._tile_plan(dst, int(csr.nnz), csr.capacity, csr.n_alloc,
                      *csr.plan_cfg)
    plan = {**_plan_report(csr), "build_s": time.perf_counter() - t0}
    del dst
    say(f"tuned SPATH plan: {plan}")
    phase["plan"] = plan

    f = _seed_rows(torch, lambda i: sparse.rows_from_sources(csr, i), srcs,
                   sp.batch_pads, float("inf"))
    results["csr_minplus_tiled_step"].update(measure(
        torch, "K7 csr_minplus_tiled_step (dpath)",
        spmv.csr_minplus_tiled_step, spmv.plain_minplus_tiled, (f, csr), 10,
        _k7_bound(torch, csr, f)))
    phase["k4_ms_same_frontier"] = time_ms(
        torch, lambda: spmv.csr_minplus_step(f, csr), 10)
    say(f"K4 csr_minplus_step at the same frontier and CSR: "
        f"{phase['k4_ms_same_frontier']:.3f} ms")
    # a frontier with every value finite: K7 and K4 agree exactly there too
    g = torch.Generator(device=f.device).manual_seed(SEED)
    fd = torch.randint(0, 64, f.shape, generator=g, device=f.device,
                       dtype=torch.float32)
    check(torch.equal(spmv.csr_minplus_tiled_step(fd, csr),
                      spmv.csr_minplus_step(fd, csr)),
          "K7 != K4 at a finite frontier")
    phase["dense_frontier_ms"] = {
        "k7": time_ms(torch, lambda: spmv.csr_minplus_tiled_step(fd, csr), 10),
        "k4": time_ms(torch, lambda: spmv.csr_minplus_step(fd, csr), 10)}
    say(f"K7 / K4 at a finite {tuple(fd.shape)} frontier: "
        f"{phase['dense_frontier_ms']['k7']:.3f} / "
        f"{phase['dense_frontier_ms']['k4']:.3f} ms")
    del f, fd

    # appends: a tail append, then one past csr_rebuild_frac (a fold)
    appended = [wedges]
    for label, k in (("tail", TAIL_APPEND), ("fold", FOLD_APPEND)):
        rows = np.stack([rng.integers(0, n, k), rng.integers(0, n, k),
                         rng.integers(1, 10, k)], 1)
        appended.append(rows)
        ops.reset_launch_counts()
        st0 = dataclasses.replace(sp.stats)
        t0 = time.perf_counter()
        sp.append("darc", rows)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        _launch_check(f"append ({label})", counts, st0, sp,
                      "csr_minplus_tiled_step", "csr_minplus_step")
        csr = sp._dense_state("dpath").csr
        resumed = sp.stats.fixpoint_iterations - st0.fixpoint_iterations
        rep = {"arcs": k, "seconds": secs, "resumed_rows":
               sp.stats.resumed_rows - st0.resumed_rows,
               "resumed_iterations": resumed,
               "cold_iterations": phase["spath"]["iterations"][0],
               "tail_nnz": int(csr.tail_nnz), "nnz": int(csr.nnz),
               "plan": _plan_report(csr)}
        check(csr.plan_cfg == (32, 128) and
              sp.explain()["kernels"]["tuning"]["dpath"]["pinned"],
              f"append ({label}): the pinned config or plan was lost")
        check((rep["tail_nnz"] == 0) == (label == "fold"),
              f"append ({label}): tail {rep['tail_nnz']}")
        say(f"append ({label}): {rep}")
        phase[f"append_{label}"] = rep
        _check_sources(f"after append ({label})", sp, "dpath",
                       Oracle(np.concatenate(appended), n, True),
                       srcs + [single])
    del sp, csr
    torch.cuda.empty_cache()

    # tune=True: the measured search
    autotune.clear_cache()
    svc = DatalogService(SPATH, db={"darc": wedges}, bits=20, sparse=True,
                         tune=True)
    t0 = time.perf_counter()
    svc.ask_batch([("dpath", (s, None, None)) for s in srcs])
    secs = time.perf_counter() - t0
    tuning = svc.explain()["kernels"]["tuning"]["dpath"]
    say(f"tune=True: first batch {secs:.1f} s (search included); chose "
        f"{tuning['config']} gain {tuning['gain']:.3f} (baseline "
        f"{tuning['baseline_seconds']:.4f} s, best "
        f"{tuning['best_seconds']:.4f} s)")
    for c in tuning["candidates"]:
        say(f"  candidate {c['config']}: predicted {c['predicted_s']} s, "
            f"measured {c['measured_s']} s")
    check(tuning["pinned"] is False and sum(
        c["measured_s"] is not None and c["config"]["use_kernel"]
        for c in tuning["candidates"]) == 3,
        "tune=True: the three tile-skip candidates were not measured")
    _check_sources("tune=True", svc, "dpath", oracle, srcs)
    phase["tune_true"] = {"seconds": secs, **tuning}
    del svc
    torch.cuda.empty_cache()
    results["tuned_phase"] = phase


def main():
    t_start = time.perf_counter()
    card = check_device()
    build_kernels()
    import torch
    ragged_parity()
    k7_ragged_parity()
    k8_ragged_parity()
    results: dict = {}
    dense_phase(results)
    edges, wedges, sp_oracle = csr_phase(results)
    tuned_phase(results, wedges, sp_oracle)
    del wedges, sp_oracle
    dag_phase(results, edges)
    del edges
    allpairs_phase(results)
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **{k: results[name][k] for k in (
             "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")}}
        for name, (src, rep) in KERNELS.items()]}
    say("phases: " + json.dumps({k: results[k]
                                 for k in ("dense_phase", "csr_phase",
                                           "tuned_phase", "dag_phase",
                                           "allpairs_phase")}))
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(card)
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
