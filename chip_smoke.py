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
   128-row split), hub rows wider than one 256-slot piece, and a COO tail
   built by hand; then K1, K2 and K2-max at B = 1, 8, 64, 65, 128
   and 129 and n = 15, 16, 17, 1003, 1024 and 4097 (across the 128 x 128
   tiles, the K splits and both load routes), fully dead frontiers, and
   operands off 16-byte boundaries; then K3, K5 and K6 at B = 1, 31, 32,
   33, 64, 65, 128 and 130 and frontier densities 0, 0.001, 0.1 and 1.0,
   on a graph with a hub of in-degree about 4,000 (wider than the 256-slot
   piece), 37 empty rows and a COO
   tail (K5 on small-integer counts), and K5 on a non-integer frontier: two
   calls bitwise equal, and equal to ``spmv.ell_step_in_kernel_order``;
   then K7 (the min-plus step over a tile-skip plan) against its plain
   version and K4's at (chunk, bn) = (32, 128), (64, 128), (32, 256) and
   (16, 64) and B = 3, 32 and 130, on a graph with empty column tiles, an
   allocation no tile width divides, a hub tile split into several work
   units (``core.sparse.TILE_UNIT`` arcs each) and a COO tail made by
   ``csr_append``; then K8 (the fused
   relaxation step) against its plain version at n = 1, 50, 130, 1000 and
   1025, with Δ masks all true, all false and random with a whole 64-row
   tile false, and a ``d`` with whole +inf rows, by each route (the
   arc-list route and the tiled one, each call checked to launch its
   route) on a sparse and on a dense ``a``, and through ``relax_step``,
   whose route must follow ``relax.arcs_pay``; then the
   JAX API's raw-triple CSR entries (``ops.csr_bool``, ``csr_minplus``,
   ``csr_maxplus``, ``csr_plustimes``, ``csr_minplus_tiled``) against
   their plain versions, exactly, on the spine and on the COO-tail arrays
   of a CSR with a hub, each call launching its kernel (K3, K4, K6, K5,
   K7) once; then K10 at its ragged shapes (listed in phase 8);
4. dense main path: ``DatalogService`` TC and SPATH on ``gnp_graph(10_000,
   0.1)`` (the paper's Table-6 Gn-p family; density 0.1 picks the dense
   carrier), ``ask_batch`` of 100 sources, a second batch of 100, a repeat
   of the first (all cache hits) and one ``ask``; K1 and K2 at the ``ask``
   shapes (the seed's first 1 and 8 rows) and K1 at every frontier of a
   warm TC batch, each equal to plain and timed beside the f32 ``matmul``
   and the bound at that input; then appends to both
   services: 1,000 arcs, and one arc to vertex 10,200, which grows
   ``n_alloc`` from 10,112 to 10,240 (cached rows re-padded): 3 resumed
   batch sources, the single one and the new vertex against the oracle;
5. CSR main path: TC and SPATH on ``powerlaw_graph(2**20, 16_000_000,
   alpha=0.8)`` (a social-graph shape; the density heuristic picks CSR),
   ``ask_batch`` of 32 sources, a second batch of 32 and a repeat; then
   K3 and K4 at every frontier one warm TC or SPATH batch passes its step
   (:func:`capture_frontiers`: a spy on ``fixpoint_csr``'s step), each
   output equal to the plain step, timed beside the bound at the same
   input (K3 also beside ``sparse.mm``);
5b. the tuned CSR path on phase 5's weighted arcs (not generated again):
   ``DatalogService(SPATH, sparse=True, tune=KernelConfig(use_kernel=True))``
   (tile-skip plan (32, 128)), the same traffic; K7 must launch once per
   iteration plus one seed step per fixpoint and K4 never; the plan's
   length, padding and host build time, and K7's view of it (planned arcs,
   work units, split tiles); K7 timed beside its plain version, its bound
   and K4 at the same frontier, then K7 against K4 (equal exactly, and
   timed) at a frontier with every value finite; K7 at every frontier one
   warm batch passes its step, each equal to the plain step.  Then two
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
   with src > dst (a DAG of about 13.2M arcs, hub in-degrees near 183k),
   K6 and K5 also at every frontier of a warm LPATH and CPATH batch, as K3
   in phase 5 (K6 with no ``sparse.mm`` beside it: it cannot take a max), and
   K2-max at the ``ask`` shapes and at every 20th frontier of a warm dense
   LPATH batch (each equal to plain, with its live share and bound);
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
   wall time and K1, K2 and K8 launches (K8 by its arc-list route: the
   tiled route must not launch).  K8 is timed at the inputs of the
   loop's first, middle and last steps, held to its plain version in row
   blocks of 1,024 (the plain version cannot run whole at this width),
   beside its tiled route, its pre-pass alone (the column lists) and one
   K2 linear step with its merge and changed test at the same inputs; then
   both routes at a first step (d = a, every row in Δ) of Gn-p arc
   matrices drawn on the card at densities 0.1%, 1%, 3%, 10%, 20% and 30%
   (equal to each other), the sweep that sets ``relax.ARC_DENSITY``; K1
   and K2 are timed at M = n;
7b. the tuple engine (``core.engine.Engine`` and the service's tuple
   path; no hand-written kernel runs in it, so each step is driven between
   launch-count reads that must show none, ``ask_dense`` aside): the full
   model of TC on G10K (``Engine.run``, ``caps={"tc": 1 << 27}``,
   ``join_cap=1 << 30``; 10^8 facts, a 5 × 10^8-binding iteration, joins
   expanded in chunks) equal to the nonzeros of ``transitive_closure_dense``
   (K1) on the card, its ``iterations`` and ``generated`` equal to the BFS
   hop layers computed by K1 (each pair at hop distance k meets its end's
   out-degree), with its wall time, facts a second, peak device memory and
   a ``torch.profiler`` breakdown of its largest iteration by stage (join,
   project, compact, merge, host sync); magic sets on G10K: ``ask`` for 4
   sources, ``ask_batch`` of 32 as ONE qid-batched fixpoint (a spy on
   ``Engine._try_batch``), each the closure's row, and ``ask_dense`` (K3)
   equal to ``ask``; ``ask_batch`` of 32 ``dpath(s, X, min<D>)`` on G10K
   with phase 7's weights against Dijkstra; ``ask_batch`` of 16
   ``cpath(s, X, sum<C>)`` on phase 6's CPATH DAG against the int64 DP; the
   non-linear TC (the shuffle join) on G1K (``gnp_graph(1_000, 0.005,
   seed=10)``) equal to its K1 closure; and ``DatalogService(TC + SG,
   device="cuda")`` on G1K: 8 ``tc(X, s)`` and 8 ``sg(s, X)`` in one batch,
   each equal to a full-model engine's rows, the repeat from the cache, an
   append of 1,000 new arcs that resumes the ``sg`` batch's snapshot, and 4
   resumed answers equal to a cold engine's on the union;
8. the LM serving path: RecurrentGemma-2B (``recurrentgemma-2b``) at its
   published widths and depth (26 layers, 18 ``rg`` and 8 ``local``,
   d_model 2560, vocab 256,000; 2.89 × 10^9 parameters drawn on the card
   from a seeded generator, 11.6 GB of f32 masters) prefills 2 × 4,096
   tokens through ``make_prefill_step`` (cut from ``prefill_32k``, 32,768 ×
   32: its every-position bf16 logits alone would be 537 GB; S = 4,096 is
   twice the window, so K9 skips kv tiles on both sides): K9 must launch 8
   times on its tensor-core route (bf16) and K10 18, and nothing else (its
   f32 route included); the prefill's wall time, tokens a
   second and a ``torch.profiler`` breakdown of its device time (K9, K10,
   GEMMs, the rest; the idle share).  K9 and K10 are held to their plain
   versions at the inputs captured from the first ``local`` and ``rg``
   blocks (K9 within the tolerance of :data:`K9_ATOL`, K10 exactly), timed
   beside them, their bounds and, for K9, ``scaled_dot_product_attention``
   on the same tensors (kv repeated, a boolean mask), and K10 also at a
   one-prompt (1, 4096, 2560) input with its bound; then K9 at ragged
   shapes (sq = sk in 1, 63, 130, 2049 across windows (all-masked
   rows too), softcaps, causal or not, GQA repeats 1/2/10, head dims
   16/128/256, bf16 on the tensor-core route and f32 on the CUDA-core
   route, each case checked to launch its route; K10's ragged cases run
   in phase 3, before any other K10 launch: B 1/3, S 1, T - 1, T, T + 1,
   2T + 1, 4T + 1 (the ring wraps at its default plan's 2 and 4 stages)
   and 4097, W 1, 4, 16, 33, 130 and 2564, and the widths that are
   multiples of 4 again off a 16-byte boundary, so that both routes (TMA
   and cp.async) run, each case awaited by a watchdog that fails the run
   on a hang).  Then ``launch.serve``'s loop
   through ``make_serve_step``: batch 4, a 64-token prompt fed token by
   token, 16 generated; ms a token, every logit finite, and the logits at
   the prompt's last position against the prefill's on the same tokens
   (:data:`DECODE_MAX_FRAC`, :data:`DECODE_MEAN_FRAC`), and a profiled
   decode step;
9. checks: the chosen carriers (and semirings), every kernel's launch count
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
import os
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
BF16_OPS_S = 989e12

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
#: K2-max is held to its plain version at every LPATH_EVERY-th frontier of
#: a warm dense LPATH batch (836 iterations: 42 frontiers)
LPATH_EVERY = 20
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
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:95"),
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan.py:49"),
}
#: K3/K5's ragged cases: batch sizes crossing every 32-row word and the
#: wrapper's 128-row split, and frontier densities
K35_BATCHES = (1, 31, 32, 33, 64, 65, 128, 130)
K35_DENSITIES = (0.0, 0.001, 0.1, 1.0)
#: K1/K2's ragged cases: batch sizes across the 64-row warpgroups and the
#: 128-row tiles, and widths across the 128-column tiles, the K splits and
#: both load routes (n % 16 and n % 4 nonzero take the predicated one)
K12_BATCHES = (1, 8, 64, 65, 128, 129)
K12_SIZES = (15, 16, 17, 1003, 1024, 4097)
#: K7's ragged cases: (chunk, bn) plans and batch sizes (33 takes the
#: transpose's two-word instantiation and a one-row second pass; 130
#: crosses the 32-row passes more than four times)
K7_PLANS = ((32, 128), (64, 128), (32, 256), (16, 64))
K7_BATCHES = (3, 32, 33, 130)
TAIL_APPEND, FOLD_APPEND = 10_000, 4_100_000
#: the vertex the dense append phase adds: past n_alloc 10,112 (Gn-p 10k)
DENSE_GROW = 10_200
#: K8's ragged sizes (1025: a last row tile of one row)
K8_SIZES = (1, 50, 130, 1000, 1025)
#: the densities of K8's route sweep (:func:`k8_density_sweep`)
K8_SWEEP = (0.001, 0.01, 0.03, 0.1, 0.2, 0.3)
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
    if hub_deg:  # vertex 1 gets hub_deg in-arcs: a row of several pieces
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
    k35_ragged_parity()


def k35_ragged_parity():
    """K3, K4, K5 and K6 against their plain versions at every batch size
    of :data:`K35_BATCHES` and density of :data:`K35_DENSITIES`, on a graph
    whose vertex 1 has an in-degree near 4,000 (wider than the 256-slot
    piece), whose last 37 vertices
    have no arc (empty rows) and whose COO tail holds 40 arcs: K3, K4 and
    K6 exactly, K5 exactly on small-integer counts (sums far below 2^24).
    Then K5 on a non-integer frontier: two calls bitwise identical and
    bitwise equal to ``spmv.ell_step_in_kernel_order``; its max abs error
    against the plain step is printed."""
    import torch
    from repro_torch.kernels import spmv
    rng = np.random.default_rng(SEED + 11)
    n, n_alloc = 5000, 5037
    edges, tail = _ragged_graph(rng, n, 30000, 4000)
    bcsr = _hand_tailed_csr("bool", n_alloc, edges, tail, DEVICE)
    pcsr = _hand_tailed_csr(
        "plustimes", n_alloc,
        np.concatenate([edges, rng.integers(1, 4, (len(edges), 1))], 1),
        np.concatenate([tail, rng.integers(1, 4, (len(tail), 1))], 1),
        DEVICE)
    mcsr = _hand_tailed_csr(
        "maxplus", n_alloc,
        np.concatenate([edges, rng.integers(1, 10, (len(edges), 1))], 1),
        np.concatenate([tail, rng.integers(1, 10, (len(tail), 1))], 1),
        DEVICE)
    wcsr = _hand_tailed_csr(
        "minplus", n_alloc,
        np.concatenate([edges, rng.integers(1, 10, (len(edges), 1))], 1),
        np.concatenate([tail, rng.integers(1, 10, (len(tail), 1))], 1),
        DEVICE)
    hub = int(np.bincount(edges[:, 1]).max())
    check(hub > 1024 and int(pcsr.tail_nnz) == len(tail),
          f"K3/K5 ragged graph: hub in-degree {hub}, tail {pcsr.tail_nnz}")
    cases = 0
    for B in K35_BATCHES:
        for p in K35_DENSITIES:
            hit = rng.random((B, n_alloc)) < p
            f = torch.from_numpy(hit).to(DEVICE)
            equal_and_err(torch, spmv.csr_bool_step(f, bcsr),
                          spmv.plain_bool(f, bcsr))
            fc = torch.from_numpy(np.where(
                hit, rng.integers(1, 4, hit.shape), 0).astype(
                    np.float32)).to(DEVICE)
            equal_and_err(torch, spmv.csr_plustimes_step(fc, pcsr),
                          spmv.plain_plustimes(fc, pcsr))
            fm = torch.from_numpy(np.where(
                hit, rng.integers(0, 50, hit.shape), -np.inf).astype(
                    np.float32)).to(DEVICE)
            equal_and_err(torch, spmv.csr_maxplus_step(fm, mcsr),
                          spmv.plain_maxplus(fm, mcsr))
            fw = torch.from_numpy(np.where(
                hit, rng.integers(0, 50, hit.shape), np.inf).astype(
                    np.float32)).to(DEVICE)
            equal_and_err(torch, spmv.csr_minplus_step(fw, wcsr),
                          spmv.plain_minplus(fw, wcsr))
            cases += 4
    fr = torch.from_numpy(rng.random((130, n_alloc)).astype(
        np.float32)).to(DEVICE)
    one, two = (spmv.csr_plustimes_step(fr, pcsr) for _ in range(2))
    ordered = spmv.ell_step_in_kernel_order(fr, pcsr)
    check(torch.equal(one.view(torch.int32), two.view(torch.int32)),
          "K5: two calls on one non-integer frontier differ")
    check(torch.equal(one.view(torch.int32), ordered.view(torch.int32)),
          "K5: != ell_step_in_kernel_order on a non-integer frontier")
    err = float((one - spmv.plain_plustimes(fr, pcsr)).abs().max())
    torch.cuda.synchronize()
    say(f"parity (K3-K6, ragged): {cases} cases exactly equal to plain (B "
        f"{list(K35_BATCHES)}, densities {list(K35_DENSITIES)}, a hub of "
        f"in-degree {hub}, {n_alloc - n} empty rows, a 40-arc tail); K5 on "
        f"a non-integer (130, {n_alloc}) frontier: two calls bitwise equal "
        f"and equal to its order in PyTorch, max abs err vs plain {err:.3e}")


def _misaligned(torch, x):
    """``x``'s values in a contiguous tensor that starts one element past a
    16-byte boundary (the predicated load route, whatever the width)."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


def k12_ragged_parity():
    """K1, K2 (min-plus) and K2's max-plus instantiation against their plain
    versions, exactly, at every batch size of :data:`K12_BATCHES` and width
    of :data:`K12_SIZES` (square (n, n) operands, frontier density 0.2,
    matrix density 8/n), each also with a fully dead frontier (all false,
    +inf, -inf), and at B = 65 with every operand one element off a 16-byte
    boundary; the launch plans' splits and routes that ran are printed."""
    import torch
    from repro_torch.kernels import boolmm, build, minplus
    rng = np.random.default_rng(SEED + 20)
    cases, routes = 0, set()
    for n in K12_SIZES:
        p = min(0.5, 8 / n)
        adj = torch.from_numpy(rng.random((n, n)) < p).to(DEVICE)
        w = torch.from_numpy(_rand_dist(rng, (n, n), p)).to(DEVICE)
        wm = torch.from_numpy(_neg_inf(_rand_dist(rng, (n, n), p))).to(DEVICE)
        for B in K12_BATCHES:
            f = torch.from_numpy(rng.random((B, n)) < 0.2).to(DEVICE)
            fw = torch.from_numpy(_rand_dist(rng, (B, n), 0.2)).to(DEVICE)
            fm = torch.from_numpy(_neg_inf(_rand_dist(rng, (B, n), 0.2))).to(
                DEVICE)
            runs = [(f, adj, fw, w, fm, wm),
                    (torch.zeros_like(f), adj, torch.full_like(fw, np.inf), w,
                     torch.full_like(fm, -np.inf), wm)]
            if B == 65:
                runs.append(tuple(_misaligned(torch, x) for x in runs[0]))
            for f1, a1, f2, w2, f3, w3 in runs:
                equal_and_err(torch, boolmm.bool_frontier_matmul(f1, a1),
                              boolmm.plain(f1, a1))
                equal_and_err(torch, minplus.minplus_frontier_matmul(f2, w2),
                              minplus.plain(f2, w2))
                equal_and_err(torch, minplus.maxplus_frontier_matmul(f3, w3),
                              minplus.plain_max(f3, w3))
                cases += 3
                sms = build.sm_count(f1.device)
                k1 = boolmm.plan(B, n, n, build.aligned(f1, a1), sms)
                k2 = minplus.plan(B, n, n, build.aligned(f2, w2), sms)
                routes |= {("K1", k1.splits, k1.vec), ("K2", k2.splits, k2.vec)}
    torch.cuda.synchronize()
    say(f"parity (K1/K2, ragged): {cases} cases exactly equal to plain (B "
        f"{list(K12_BATCHES)}, n {list(K12_SIZES)}, fully dead frontiers, "
        f"operands off 16-byte boundaries); (kernel, splits, aligned route) "
        f"run: {sorted(routes)}")
    for kernel in ("K1", "K2"):
        for vec in (True, False):
            check(any(r[0] == kernel and r[2] == vec for r in routes),
                  f"{kernel}: the {'aligned' if vec else 'predicated'} route "
                  "never ran")
        check(any(r[0] == kernel and r[1] > 1 for r in routes)
              and any(r[0] == kernel and r[1] == 1 for r in routes),
              f"{kernel}: split and unsplit launches did not both run")


def k7_ragged_parity():
    """K7 against its plain version, exactly: a graph whose upper column
    tiles are empty, an allocation that is no multiple of any tile width, a
    hub of 3 x ``TILE_UNIT`` in-arcs whose tile splits into several work
    units, and a COO tail
    made by ``csr_append``; every plan of :data:`K7_PLANS` at every batch
    size of :data:`K7_BATCHES`."""
    import torch
    from repro_torch.core import sparse
    from repro_torch.kernels import spmv
    rng = np.random.default_rng(SEED + 5)
    n_alloc, m, hub = 3000, 24000, 3 * sparse.TILE_UNIT
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
        flags = csr.tile_units[:, 3].cpu().numpy()
        check(int(csr.tail_nnz) == len(tail) and csr.plan_cfg == plan,
              f"K7 case {plan}: tail or plan not built")
        check(bool((flags & sparse.UNIT_WHOLE == 0).any()),
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
    false (one whole row tile without a Δ row); by each route
    (``relax_arcs``, ``relax_tiled``, each launching its own kernel once)
    on a sparse ``a`` (half of ``relax.ARC_DENSITY``, one column all +inf)
    and a dense one (60%), and through ``relax_step``, which must take the
    route ``relax.arcs_pay`` names."""
    import torch
    from repro_torch.kernels import relax
    rng = np.random.default_rng(SEED + 9)
    cases, routes = 0, {"relax_step": 0, "relax_step_tiled": 0}
    for n in K8_SIZES:
        d = _rand_dist(rng, (n, n), 0.3)
        d[::7] = np.inf
        some = rng.random(n) < 0.5
        some[64:128] = False
        for p in (relax.ARC_DENSITY / 2, 0.6):
            a = _rand_dist(rng, (n, n), p)
            a[:, n // 3] = np.inf
            live = int(np.isfinite(a).sum())
            chosen = "relax_step" if relax.arcs_pay(n, live) \
                else "relax_step_tiled"
            routes[chosen] += 1
            for mask in (np.ones(n, bool), np.zeros(n, bool), some):
                args = [torch.from_numpy(x).to(DEVICE) for x in (d, a, mask)]
                want = relax.plain(*args)
                for counter, fn in (("relax_step", relax.relax_arcs),
                                    ("relax_step_tiled", relax.relax_tiled),
                                    (chosen, relax.relax_step)):
                    got = _counted(counter, lambda: fn(*args))
                    for g, w in zip(got, want):
                        equal_and_err(torch, g, w)
                    cases += 1
    torch.cuda.synchronize()
    check(all(routes.values()), f"K8 route choice: {routes}")
    say(f"parity (K8, ragged): {cases} cases exactly equal to plain (n "
        f"{list(K8_SIZES)}; masks all, none, random with a false tile; "
        f"each route and relax_step on a sparse and a dense a; relax_step "
        f"chose {routes})")


def _counted(counter: str, fn):
    """``fn()``, checked to have launched the kernel counted by ``counter``
    once and no other kernel."""
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    out = fn()
    after = ops.launch_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    check(moved == {counter: 1}, f"launched {moved}, want {counter} once")
    return out


def raw_entry_parity():
    """The JAX API's raw-triple CSR entries (``ops.csr_bool``,
    ``csr_minplus``, ``csr_maxplus``, ``csr_plustimes``: K3, K4, K6, K5;
    ``csr_minplus_tiled``: K7) against their plain versions, exactly, each
    call launching its kernel once: on the spine arrays (sentinel pads
    included) and on the COO-tail arrays of a CSR whose vertex 1 has
    in-degree 2,500 (a hub), B = 32; K7 at plans (32, 128) and (16, 64)
    of the spine, also against the untiled plain step.  Plus-times counts
    are small integers, so its sums are exact integers below 2^24."""
    import torch
    from repro_torch.core import sparse
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(SEED + 17)
    n, B = 3000, 32
    edges, tail = _ragged_graph(rng, n, 20000, 2500)
    cases = 0
    for kind, entry, counter, hi, frontier in (
            ("bool", ops.csr_bool, "csr_bool_step", 0,
             lambda: rng.random((B, n)) < 0.1),
            ("minplus", ops.csr_minplus, "csr_minplus_step", 10,
             lambda: _rand_dist(rng, (B, n), 0.1)),
            ("maxplus", ops.csr_maxplus, "csr_maxplus_step", 10,
             lambda: _neg_inf(_rand_dist(rng, (B, n), 0.1))),
            ("plustimes", ops.csr_plustimes, "csr_plustimes_step", 4,
             lambda: _rand_count(rng, (B, n), 0.1))):
        rows, trows = edges, tail
        if hi:
            rows = np.concatenate([edges, rng.integers(1, hi, (len(edges),
                                                               1))], 1)
            trows = np.concatenate([tail, rng.integers(1, hi, (len(tail),
                                                               1))], 1)
        csr = _hand_tailed_csr(kind, n, rows, trows, DEVICE)
        f = torch.from_numpy(frontier()).to(DEVICE)
        for arcs in ((csr.src_idx, csr.col_idx, csr.edge_val),
                     (csr.tail_src, csr.tail_dst, csr.tail_val)):
            got = _counted(counter, lambda: entry(f, *arcs))
            equal_and_err(torch, got, ref.csr_raw_ref(kind, f, *arcs))
            if kind == "plustimes":
                check(bool((got == got.round()).all())
                      and float(got.max()) < 2 ** 24,
                      "csr_plustimes: sums not exact integers below 2^24")
            cases += 1
    weighted = np.concatenate([edges, rng.integers(1, 10, (len(edges), 1))],
                              1)
    for plan in ((32, 128), (16, 64)):
        csr = sparse.build_csr(weighted, n, "minplus", kernel_plan=plan,
                               device=DEVICE)
        f = torch.from_numpy(_rand_dist(rng, (B, n), 0.1)).to(DEVICE)
        arcs = (csr.src_idx, csr.col_idx, csr.edge_val)
        chunk, bn = csr.plan_cfg
        got = _counted("csr_minplus_tiled_step", lambda: ops.csr_minplus_tiled(
            f, *arcs, csr.plan_tile, csr.plan_chunk, csr.plan_first,
            chunk=chunk, bn=bn))
        equal_and_err(torch, got, ref.csr_raw_minplus_tiled_ref(
            f, *arcs, csr.plan_tile, csr.plan_chunk, chunk, bn))
        equal_and_err(torch, got, ref.csr_raw_ref("minplus", f, *arcs))
        cases += 1
    torch.cuda.synchronize()
    say(f"parity (raw-triple CSR entries): {cases} cases exactly equal to "
        f"plain, each launching its kernel (K3/K4/K6/K5 on spine and tail "
        f"arrays, K7 at plans (32, 128) and (16, 64); n {n}, B {B}, a hub "
        f"of in-degree 2500)")


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


def _dense_bound(torch, f, w, live, vbytes, rate):
    """A dense frontier product's bound at (f, w): each operand read once and
    the result written once (``vbytes`` a value); an add and a ⊕ (or an AND
    and an OR) per live f[m, k] and live w[k, n] it meets."""
    B, na = f.shape
    ops = 2 * float((live(f).double() @ live(w).sum(1).double()).sum())
    return _bound(vbytes * (2 * B * na + na * na), ops, rate)


def ask_shapes(torch, name, kernel, plain, f, w, live, vbytes, rate,
               library=None):
    """The kernel at the ``ask`` shapes: the first 1 and 8 rows of the
    frontier ``f``, each held to the plain version and timed beside its
    bound (and ``library``'s call on the same operands)."""
    out = {}
    for m in (1, 8):
        fm = f[:m].contiguous()
        out[m] = measure(torch, f"{name} (M = {m})", kernel, plain, (fm, w),
                         20, _dense_bound(torch, fm, w, live, vbytes, rate),
                         library=library(torch, fm, w) if library else None)
    return out


def capture_dense_frontiers(svc, pred, srcs, every):
    """One warm batch of ``srcs`` on ``pred``'s dense carrier, run as
    ``ask_batch`` runs its fixpoint (``run_batch``), with a spy on the
    fixpoint's product (``ops.semiring_matmul``) that keeps a copy of every
    ``every``-th input frontier, the first included.  Returns [(iteration,
    frontier)] and the batch's result."""
    from repro_torch.kernels import ops
    kept, real, calls = [], ops.semiring_matmul, [0]

    def spy(name):
        mm = real(name)

        def recording(f, arc):
            if calls[0] % every == 0:
                kept.append((calls[0] + 1, f.clone()))
            calls[0] += 1
            return mm(f, arc)

        return recording

    ops.semiring_matmul = spy
    try:
        res = svc._dense_state(pred).run_batch(svc, srcs)
    finally:
        ops.semiring_matmul = real
    return kept, res


def captured_dense(torch, name, svc, pred, srcs, kernel, plain, live, vbytes,
                   rate, every, library=None):
    """The dense product at every ``every``-th frontier one warm batch passes
    (:func:`capture_dense_frontiers`): each output held to the plain
    version, exactly; per input the live share (finite, or true, entries),
    the kernel's ms, ``library``'s ms and the bound (:func:`_dense_bound`);
    their sums."""
    kept, res = capture_dense_frontiers(svc, pred, srcs, every)
    check(len(kept) == -(-res.iterations // every),
          f"{name}: kept {len(kept)} frontiers of {res.iterations} iterations")
    w = svc._dense_state(pred).matrix
    its, share, rows, ms, lib_ms, bound_ms = [], [], [], [], [], []
    for it, f in kept:
        equal_and_err(torch, kernel(f, w), plain(f, w))
        lf = live(f)
        its.append(it)
        share.append(float(lf.double().mean()))
        rows.append(int(lf.any(1).sum()))
        ms.append(time_ms(torch, lambda: kernel(f, w), 10))
        if library:
            lib_ms.append(time_ms(torch, library(torch, f, w), 10))
        bound_ms.append(_dense_bound(torch, f, w, live, vbytes, rate)[0])
    out = {"iterations": res.iterations, "generated": res.generated,
           "kept": its, "live": share, "live_rows": rows,
           "ms_each": ms, "ms": float(sum(ms)),
           "library_ms": float(sum(lib_ms)) if library else None,
           "bound_ms": float(sum(bound_ms))}
    say(f"{name} ({pred}) at {len(kept)} of the {res.iterations} frontiers of "
        f"a warm batch (every {every}; generated {res.generated}), each equal "
        f"to plain: {out['ms']:.3f} ms in all"
        + (f" (f32 matmul {out['library_ms']:.3f} ms)" if library else "")
        + f", bound {out['bound_ms']:.4f} ms; per frontier (iteration, live "
        f"share, live rows, ms): "
        f"{[(i, round(a, 4), r, round(t, 4)) for i, a, r, t in zip(its, share, rows, ms)]}")
    del kept
    torch.cuda.empty_cache()
    return out


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
    results["bool_matmul"].update(measure(
        torch, "K1 bool_frontier_matmul", boolmm.bool_frontier_matmul,
        boolmm.plain, (f, adj), 20,
        _dense_bound(torch, f, adj, lambda x: x, 1, INT8_OPS_S),
        library=_matmul_call(torch, f, adj)))
    results["bool_matmul"]["ask"] = ask_shapes(
        torch, "K1 bool_frontier_matmul", boolmm.bool_frontier_matmul,
        boolmm.plain, f, adj, lambda x: x, 1, INT8_OPS_S, _matmul_call)
    results["bool_matmul"]["captured"] = captured_dense(
        torch, "K1 bool_frontier_matmul", tc, "tc", srcs2,
        boolmm.bool_frontier_matmul, boolmm.plain, lambda x: x, 1,
        INT8_OPS_S, 1, _matmul_call)
    fin = torch.isfinite
    results["minplus_matmul"].update(measure(
        torch, "K2 minplus_frontier_matmul", minplus.minplus_frontier_matmul,
        minplus.plain, (fw, w), 10,
        _dense_bound(torch, fw, w, fin, 4, F32_OPS_S)))
    results["minplus_matmul"]["ask"] = ask_shapes(
        torch, "K2 minplus_frontier_matmul", minplus.minplus_frontier_matmul,
        minplus.plain, fw, w, fin, 4, F32_OPS_S)
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


def capture_frontiers(svc, pred, srcs):
    """One warm batch of ``srcs`` on ``pred``'s CSR carrier, run as
    ``ask_batch`` runs its fixpoint (``run_batch``), with a spy on
    ``core.sparse.fixpoint_csr``'s step that records a copy of each
    iteration's input frontier.  Returns the frontiers and the batch's
    result; the seed step (``rows_from_sources``) is not one of them."""
    from repro_torch.core import sparse
    from repro_torch.kernels import ops
    frontiers = []
    real = sparse.fixpoint_csr

    def spy(csr, init, spmv=None, max_iters=None):
        step = spmv or ops.csr_frontier_step(csr.kind)

        def recording(f, c):
            frontiers.append(f.clone())
            return step(f, c)

        return real(csr, init, spmv=recording, max_iters=max_iters)

    sparse.fixpoint_csr = spy
    try:
        res = svc._dense_state(pred).run_batch(svc, srcs)
    finally:
        sparse.fixpoint_csr = real
    return frontiers, res


def captured_frontiers(torch, name, svc, pred, srcs, plain, s, rate,
                       library=True):
    """The kernel of ``pred``'s CSR step at every frontier one warm batch
    passes (:func:`capture_frontiers`): each output held to the plain
    step, exactly; per input the share of active sources, the kernel's and
    (with ``library``) ``sparse.mm``'s ms (:func:`_sparse_mm_call`) and the
    bound (:func:`_csr_seed_bound`); their
    sums, and the densest input's."""
    from repro_torch.kernels import ops
    frontiers, res = capture_frontiers(svc, pred, srcs)
    check(len(frontiers) == res.iterations,
          f"{name}: captured {len(frontiers)} frontiers in "
          f"{res.iterations} iterations")
    csr = svc._dense_state(pred).csr
    step = ops.csr_frontier_step(csr.kind)
    zero = csr.semiring.zero
    active, ms, lib_ms, bound_ms = [], [], [], []
    for f in frontiers:
        equal_and_err(torch, step(f, csr), plain(f, csr))
        live = f if f.dtype == torch.bool else f != zero
        active.append(float(live.any(0).double().mean()))
        ms.append(time_ms(torch, lambda: step(f, csr), 10))
        if library:
            lib_ms.append(time_ms(torch, _sparse_mm_call(torch, csr, f), 10))
        bound_ms.append(_csr_seed_bound(torch, csr, f, live, s, rate)[0])
    d = int(np.argmax(active))
    out = {"iterations": res.iterations, "generated": res.generated,
           "active": active, "ms": float(sum(ms)),
           "library_ms": float(sum(lib_ms)) if library else None,
           "bound_ms": float(sum(bound_ms)), "densest": d,
           "densest_ms": ms[d],
           "densest_library_ms": lib_ms[d] if library else None,
           "densest_bound_ms": bound_ms[d]}
    lib = (lambda t: f"sparse.mm {t:.3f} ms, ") if library else \
        (lambda t: "")
    say(f"{name} ({pred}) at the {res.iterations} frontiers of a warm batch "
        f"(generated {res.generated}), each equal to plain: "
        f"{out['ms']:.3f} ms in all ({lib(sum(lib_ms))}bound "
        f"{out['bound_ms']:.4f} ms); densest (iteration {d + 1}, "
        f"{active[d]:.4f} of sources active) {ms[d]:.3f} ms "
        f"({lib(lib_ms[d] if library else 0)}bound {bound_ms[d]:.4f} ms); "
        f"active share per iteration {[round(a, 6) for a in active]}")
    del frontiers
    torch.cuda.empty_cache()
    return out


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
        del f, live
    results["csr_bool_step"]["captured"] = captured_frontiers(
        torch, "csr_bool_step", tc, "tc", srcs2, spmv.plain_bool, 1,
        INT8_OPS_S)
    results["csr_minplus_step"]["captured"] = captured_frontiers(
        torch, "csr_minplus_step", sp, "dpath", srcs2, spmv.plain_minplus, 4,
        F32_OPS_S, library=False)
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
        return svc, srcs, srcs2

    t0 = time.perf_counter()
    ledges = dag_graph(LPATH_N, LPATH_P, seed=SEED, max_w=LPATH_W)
    say(f"dense LPATH graph: dag_graph({LPATH_N}, {LPATH_P}, max_w={LPATH_W})"
        f": {len(ledges)} arcs ({time.perf_counter() - t0:.1f} s)")
    lp, lsrcs, lsrcs2 = run("dense LPATH", LPATH, "lpath", ledges, LPATH_N,
                            DENSE_BATCH, "dense", "max_plus", "maxplus_matmul")
    w = lp._dense_state("lpath").matrix
    fw = _seed_rows(torch, lambda i: w[torch.from_numpy(i).to(w.device)],
                    lsrcs, lp.batch_pads, float("-inf"))
    fin = torch.isfinite
    results["maxplus_matmul"].update(measure(
        torch, "K2 maxplus_frontier_matmul", minplus.maxplus_frontier_matmul,
        minplus.plain_max, (fw, w), 10,
        _dense_bound(torch, fw, w, fin, 4, F32_OPS_S)))
    results["maxplus_matmul"]["ask"] = ask_shapes(
        torch, "K2 maxplus_frontier_matmul", minplus.maxplus_frontier_matmul,
        minplus.plain_max, fw, w, fin, 4, F32_OPS_S)
    results["maxplus_matmul"]["captured"] = captured_dense(
        torch, "K2 maxplus_frontier_matmul", lp, "lpath", lsrcs2,
        minplus.maxplus_frontier_matmul, minplus.plain_max, fin, 4,
        F32_OPS_S, LPATH_EVERY)
    del lp, w, fw
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cedges = dag_graph(CPATH_N, CPATH_P, seed=SEED)
    say(f"dense CPATH graph: dag_graph({CPATH_N}, {CPATH_P}): {len(cedges)} "
        f"arcs ({time.perf_counter() - t0:.1f} s)")
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "f32 products may use TF32: dense path counts would be inexact")
    cp, csrcs, _ = run("dense CPATH", CPATH, "cpath", cedges, CPATH_N,
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
        svc, srcs, srcs2 = run(label, program, pred, edges, CSR_N,
                               CSR_BATCH, "csr", semiring, key)
        csr = svc._dense_state(pred).csr
        f = _seed_rows(torch, lambda i: rows_from_sources(csr, i), srcs,
                       svc.batch_pads, zero)
        live = torch.isfinite(f) if key == "csr_maxplus_step" else f != 0
        results[key].update(measure(
            torch, f"{key} ({pred})", ops.csr_frontier_step(csr.kind), plain,
            (f, csr), 10, _csr_seed_bound(torch, csr, f, live, 4, F32_OPS_S),
            library=_sparse_mm_call(torch, csr, f)
            if key == "csr_plustimes_step" else None))
        del csr, f, live
        # sparse.mm computes the sum, not the max
        results[key]["captured"] = captured_frontiers(
            torch, key, svc, pred, srcs2, plain, 4, F32_OPS_S,
            library=key == "csr_plustimes_step")
        del svc
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


def k8_density_sweep(torch, n):
    """Both K8 routes at a first step (d = a, every row in Δ) of (n, n)
    Gn-p arc matrices drawn on the card (weights 1..9, seeded) at each
    density of :data:`K8_SWEEP`: the arc-list route (its pre-pass
    included, as ``relax_step`` runs it) and the tiled one, equal to each
    other exactly (each holds its plain version at the ragged sizes), each
    timed, with the bound.  ``relax.ARC_DENSITY`` is set from where they
    cross."""
    from repro_torch.kernels import relax
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 10)
    mask = torch.ones(n, dtype=torch.bool, device=DEVICE)
    out = []
    for p in K8_SWEEP:
        w = torch.where(
            torch.rand((n, n), generator=gen, device=DEVICE) < p,
            torch.randint(1, 10, (n, n), generator=gen, device=DEVICE,
                          dtype=torch.int32).float(), float("inf"))
        arcs = relax.relax_arcs(w, w, mask)
        tiled = relax.relax_tiled(w, w, mask)
        check(all(torch.equal(x, y) for x, y in zip(arcs, tiled)),
              f"K8 routes differ at density {p}")
        del arcs, tiled
        row = {"density": p, "live": int(torch.isfinite(w).sum()),
               "arcs_ms": time_ms(torch, lambda: relax.relax_arcs(w, w, mask),
                                  3),
               "tiled_ms": time_ms(torch,
                                   lambda: relax.relax_tiled(w, w, mask), 3),
               "bound_ms": _k8_bound(torch, w, w, mask)[0]}
        say(f"K8 sweep, density {p}: arc-list route {row['arcs_ms']:.3f} ms, "
            f"tiled route {row['tiled_ms']:.3f} ms (bound "
            f"{row['bound_ms']:.4f} ms; {row['live']} live arcs)")
        out.append(row)
        del w
        torch.cuda.empty_cache()
    return out


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

    # K8 at the loop's first, middle and last steps' inputs (its arc-list
    # route, as relax_step takes it here), beside its tiled route, its
    # pre-pass alone and one K2 linear step with its merge and changed test
    # at the same inputs
    def k2_step(d, mask):
        dm = torch.where(mask[:, None], d, float("inf"))
        dn = torch.minimum(d, minplus.minplus_matmul(dm, w))
        return dn, sn._ne(MIN_PLUS, dn, d).any(-1)

    check(relax.arcs_pay(n, int(torch.isfinite(w).sum())),
          "G10K's arcs do not take K8's arc-list route")
    timed = {}
    for label, (d, mask) in steps.items():
        got, ref = relax.relax_step(d, w, mask), k2_step(d, mask)
        tiled = relax.relax_tiled(d, w, mask)
        check(all(torch.equal(x, y) for x, y in zip(got, ref))
              and all(torch.equal(x, y) for x, y in zip(got, tiled)),
              f"K8 != K2 + merge or != its tiled route at the {label} step")
        del got, ref, tiled
        timed[label] = measure_rows(
            torch, f"K8 relax_step ({label} step, {int(mask.sum())} Δ rows)",
            relax.relax_step, relax.plain, (d, w, mask),
            lambda r0, r1: (d[r0:r1], w, mask[r0:r1]), 10,
            _k8_bound(torch, d, w, mask))
        timed[label].update(
            delta_rows=int(mask.sum()),
            tiled_ms=time_ms(torch, lambda: relax.relax_tiled(d, w, mask), 3),
            lists_ms=time_ms(torch, lambda: relax.column_lists(w), 10),
            k2_merge_ms=time_ms(torch, lambda: k2_step(d, mask), 3))
        say(f"K8 ({label} step): tiled route "
            f"{timed[label]['tiled_ms']:.3f} ms, the arc-list route's "
            f"pre-pass alone {timed[label]['lists_ms']:.4f} ms; K2 + merge + "
            f"changed {timed[label]['k2_merge_ms']:.3f} ms")
    results["relax_step"].update(
        {k: timed["first"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms")})
    phase["k8_timed"] = timed
    del steps, d, mask
    phase["k8_sweep"] = k8_density_sweep(torch, n)

    # K2 and K1 at M = n: the first linear APSP and TC steps
    phase["k2_full"] = measure_rows(
        torch, "K2 minplus_matmul (M = n)", minplus.minplus_matmul,
        minplus.plain, (w, w), lambda r0, r1: (w[r0:r1], w), 3,
        _dense_bound(torch, w, w, torch.isfinite, 4, F32_OPS_S))
    phase["k1_full"] = measure(
        torch, "K1 bool_matmul (M = n)", boolmm.bool_matmul, boolmm.plain,
        (adj, adj), 3, _dense_bound(torch, adj, adj, lambda x: x, 1,
                                    INT8_OPS_S),
        library=_matmul_call(torch, adj, adj))
    results["minplus_matmul"]["full"] = phase["k2_full"]
    results["bool_matmul"]["full"] = phase["k1_full"]
    phase["seconds"] = time.perf_counter() - t_phase
    say(f"all-pairs phase: {phase['seconds']:.1f} s")
    results["allpairs_phase"] = phase
    del adj, w
    torch.cuda.empty_cache()


def _plan_report(csr):
    """The plan's items and K7's view of it: planned arcs, work units and
    the tiles split over several units."""
    from repro_torch.core.sparse import UNIT_FIRST, UNIT_WHOLE
    flags = csr.tile_units[:, 3].cpu().numpy()
    return {"items": int(csr.plan_tile.numel()),
            "arcs": int(csr.tile_dst.numel()), "units": len(flags),
            "split_tiles": int(((flags & UNIT_FIRST != 0)
                                & (flags & UNIT_WHOLE == 0)).sum()),
            "plan_cfg": list(csr.plan_cfg)}


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
        _csr_seed_bound(torch, csr, f, torch.isfinite(f), 4, F32_OPS_S)))
    # K4 on the same CSR: a planned min-plus CSR carries only K7's view, so
    # K4's ELL order is built here for the comparison
    k4csr = dataclasses.replace(csr, **sparse._ell_order(
        csr.kind, csr.src_idx, csr.edge_val, csr.ell_slices))
    phase["k4_ms_same_frontier"] = time_ms(
        torch, lambda: spmv.csr_minplus_step(f, k4csr), 10)
    say(f"K4 csr_minplus_step at the same frontier and CSR: "
        f"{phase['k4_ms_same_frontier']:.3f} ms")
    # a frontier with every value finite: K7 and K4 agree exactly there too
    g = torch.Generator(device=f.device).manual_seed(SEED)
    fd = torch.randint(0, 64, f.shape, generator=g, device=f.device,
                       dtype=torch.float32)
    check(torch.equal(spmv.csr_minplus_tiled_step(fd, csr),
                      spmv.csr_minplus_step(fd, k4csr)),
          "K7 != K4 at a finite frontier")
    phase["dense_frontier_ms"] = {
        "k7": time_ms(torch, lambda: spmv.csr_minplus_tiled_step(fd, csr), 10),
        "k4": time_ms(torch, lambda: spmv.csr_minplus_step(fd, k4csr), 10)}
    say(f"K7 / K4 at a finite {tuple(fd.shape)} frontier: "
        f"{phase['dense_frontier_ms']['k7']:.3f} / "
        f"{phase['dense_frontier_ms']['k4']:.3f} ms")
    del f, fd, k4csr
    results["csr_minplus_tiled_step"]["captured"] = captured_frontiers(
        torch, "csr_minplus_tiled_step", sp, "dpath", srcs2,
        spmv.plain_minplus_tiled, 4, F32_OPS_S, library=False)

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


# -- phase 7b: the tuple engine ------------------------------------------------

#: non-linear TC (the shuffle join) and the service run on the paper's
#: Table-6 G1K; G10K is the all-pairs phase's graph
NL_N, NL_P, NL_SEED = 1_000, 0.005, 10
TC_NONLINEAR = """
tc(X,Y) <- arc(X,Y).
tc(X,Y) <- tc(X,Z), tc(Z,Y).
"""
SG = """
sg(X,Y) <- arc(P,X), arc(P,Y), X != Y.
sg(X,Y) <- arc(A,X), sg(A,B), arc(B,Y).
"""
#: G10K's full TC: table and join capacities, and the PSN iteration whose
#: join is the largest (the 4th), profiled in a second run
TUPLE_CAP, TUPLE_JOIN_CAP, TUPLE_PROFILE_ITER = 1 << 27, 1 << 30, 3
#: the service's table and join capacities: its ``sg`` batch holds a (qid,
#: X, Y) row for each of 8 sources and nearly every pair of G1K, and the
#: qid-batched plan (the planner's, as in JAX) probes the magic set by qid
#: before the arc, so each Δ row meets every vertex its query demands:
#: 2-3 × 10^9 bindings in the largest join
TUPLE_SVC_CAP, TUPLE_SVC_JOIN_CAP = 1 << 24, 1 << 34
#: sources: ``ask`` and ``ask_dense`` (4), the ``tc``/``dpath`` batches
#: (32), the ``cpath`` batch (16), the service's ``tc(X, s)``/``sg(s, X)``
#: batches (8 each) and arcs appended to it
TUPLE_ASK, TUPLE_BATCH, TUPLE_CPATH, TUPLE_SVC, TUPLE_APPEND = 4, 32, 16, 8, 1000
TUPLE_LABELS = ("tuple.join", "tuple.project", "tuple.compact",
                "tuple.merge", "tuple.sync")


def _hop_layers(torch, adj):
    """The closure of ``adj`` by BFS layers on the card (K1 at M = n):
    layer k holds the pairs at hop distance k.  Returns the closure and,
    per layer, its pair count and the join bindings a linear PSN iteration
    over it produces (each pair (x, z) meets z's out-degree), the oracle of
    the tuple engine's ``iterations`` and ``generated``."""
    from repro_torch.kernels import ops
    mm = ops.semiring_matmul("bool")
    outdeg = adj.sum(1, dtype=torch.int64)
    seen, layer, per = adj.clone(), adj, []
    while bool(layer.any()):
        per.append((int(layer.sum()),
                    int((layer.sum(0, dtype=torch.int64) * outdeg).sum())))
        layer = mm(layer, adj) & ~seen
        seen |= layer
    return seen, per


def _tuple_profile(torch, eng, it):
    """Run ``eng`` with PSN iteration ``it`` traced by ``torch.profiler``:
    per stage label (``GroupExecutor``'s), host ms and device ms, and the
    iteration's wall ms, device busy ms and idle share."""
    import contextlib
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}

    @contextlib.contextmanager
    def traced():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            out["wall_ms"] = (time.perf_counter() - t0) * 1e3
        out["prof"] = prof

    eng.iteration_hook = lambda i: traced() if i == it else \
        contextlib.nullcontext()
    eng.run()
    eng.iteration_hook = None
    prof = out.pop("prof")
    busy, stages = 0.0, {}
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = getattr(e, "cuda_time_total", 0)
        if e.key in TUPLE_LABELS:
            st = stages.setdefault(e.key, {})
            if e.device_type == DeviceType.CUDA:  # the label's device span
                st["device_ms"] = dev / 1e3
            else:  # the host's time inside the label
                st.update(host_ms=e.cpu_time_total / 1e3, calls=e.count)
        elif e.device_type == DeviceType.CUDA:
            selfdev = getattr(e, "self_device_time_total", None)
            busy += (selfdev if selfdev is not None
                     else getattr(e, "self_cuda_time_total", 0)) / 1e3
    out.update(device_ms=busy, stages=stages,
               idle_share=max(0.0, 1.0 - busy / out["wall_ms"])
               if busy > 0 else None)
    if busy <= 0:
        say("tuple iteration breakdown: not measured (no device time in the "
            "trace)")
    say(f"G10K TC, iteration {it + 1} traced: wall {out['wall_ms']:.1f} ms, "
        f"device {busy:.1f} ms, idle {out['idle_share']}; " + ", ".join(
            f"{k.split('.')[1]} host {v.get('host_ms', 0):.1f} / device "
            f"{v.get('device_ms', 0):.1f} ms ({v.get('calls', 0)} calls)"
            for k, v in stages.items()))
    return out


def _rows_equal_closure(torch, rows, closure, label):
    """The tuple engine's rows (numpy, lexicographic) equal the closure
    matrix's nonzeros (row-major, hence lexicographic), exactly."""
    n = closure.shape[0]
    got = torch.from_numpy(rows).to(closure.device).to(torch.int64)
    got = got[:, 0] * n + got[:, 1]
    want = closure.reshape(-1).nonzero().reshape(-1)
    check(torch.equal(got, want), f"{label}: {len(rows)} rows against "
          f"{len(want)} nonzeros of the K1 closure")


def tuple_phase(results):
    """The tuple engine (module docstring, phase 7b), each step between
    launch-count reads."""
    import torch
    from repro_torch.core import engine as eng_mod
    from repro_torch.core import seminaive as sn
    from repro_torch.core.engine import Engine
    from repro_torch.data import dag_graph, gnp_graph
    from repro_torch.kernels import ops
    from repro_torch.service import DatalogService
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    phase = {}

    def counted(label, want):
        counts = ops.launch_counts()
        launched = {k: v for k, v in counts.items() if v}
        say(f"{label} launches: {launched}")
        check(set(launched) == set(want),
              f"{label}: launched {launched}, expected {sorted(want)}")
        return launched

    # (1) the full model of TC on G10K
    n = AP_N
    edges = gnp_graph(n, AP_P, seed=SEED)
    rng = np.random.default_rng(SEED + 8)
    wedges = _weighted(rng, edges)  # phase 7's weights
    adj = torch.zeros((n, n), dtype=torch.bool, device=DEVICE)
    adj[torch.from_numpy(edges[:, 0]).to(DEVICE),
        torch.from_numpy(edges[:, 1]).to(DEVICE)] = True
    closure = sn.transitive_closure_dense(adj).table
    layers, per = _hop_layers(torch, adj)
    check(torch.equal(layers, closure), "the BFS layers' closure differs "
          "from transitive_closure_dense")
    del layers
    want_iters = len(per)
    want_gen = len(edges) + sum(b for _, b in per)
    say(f"G10K TC oracle (K1 on the card): {int(closure.sum())} facts, "
        f"{want_iters} hop layers, generated {want_gen}, largest iteration "
        f"{max(b for _, b in per)} bindings; per layer "
        f"{[p for p, _ in per]}")
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = Engine(TC, db={"arc": edges}, caps={"tc": TUPLE_CAP},
                 join_cap=TUPLE_JOIN_CAP, device=DEVICE).run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counted("G10K TC (tuple engine)", ())
    rows, st = eng.query("tc"), eng.stats["tc"]
    _rows_equal_closure(torch, rows, closure, "G10K TC")
    check(st.iterations == want_iters and st.generated == want_gen,
          f"G10K TC: iterations {st.iterations}, generated {st.generated}; "
          f"the oracle {want_iters}, {want_gen}")
    say(f"G10K TC (Engine.run, full model): {len(rows)} facts in {secs:.2f} s "
        f"({len(rows) / secs:.4g} facts/s), {st.iterations} iterations, "
        f"generated {st.generated} ({st.generated / secs:.4g} bindings/s), "
        f"peak {peak / 2 ** 30:.2f} GiB allocated; join chunk "
        f"{eng_mod.JOIN_CHUNK} bindings")
    phase["tc_full"] = {"facts": len(rows), "seconds": secs,
                        "facts_per_s": len(rows) / secs,
                        "iterations": st.iterations,
                        "generated": st.generated,
                        "largest_iteration": max(b for _, b in per),
                        "peak_bytes": peak}
    del eng, rows
    # the largest iteration again, traced (the run stops after it)
    prof_eng = Engine(TC, db={"arc": edges}, caps={"tc": TUPLE_CAP},
                      join_cap=TUPLE_JOIN_CAP,
                      max_iters=TUPLE_PROFILE_ITER + 1, device=DEVICE)
    phase["tc_full"]["iteration_profile"] = _tuple_profile(
        torch, prof_eng, TUPLE_PROFILE_ITER)
    del prof_eng
    torch.cuda.empty_cache()

    # (2) magic sets on G10K: ask, one qid-batched fixpoint, ask_dense
    picks = [int(s) for s in rng.permutation(n)[:TUPLE_BATCH]]
    crow = closure[torch.tensor(picks, device=DEVICE)].cpu().numpy()
    want_row = dict(zip(picks, crow))

    def check_tc(label, s, ans):
        dst = np.nonzero(want_row[s])[0]
        check(np.array_equal(ans[:, 0], np.full(len(dst), s))
              and np.array_equal(ans[:, 1], dst),
              f"{label} tc({s}, X): {len(ans)} answers, the closure row "
              f"{len(dst)}")

    eng = Engine(TC, db={"arc": edges}, default_cap=1 << 22, device=DEVICE)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    asked = {s: eng.ask("tc", (s, None)) for s in picks[:TUPLE_ASK]}
    ask_s = (time.perf_counter() - t0) / TUPLE_ASK
    counted("G10K ask", ())
    for s, ans in asked.items():
        check_tc("ask", s, ans)
    tries, asks = [], []
    try_batch, ask = Engine._try_batch, Engine.ask
    Engine._try_batch = lambda self, *a, **k: tries.append(
        try_batch(self, *a, **k)) or tries[-1]
    Engine.ask = lambda self, *a, **k: asks.append(1) or ask(self, *a, **k)
    ops.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        batch = eng.ask_batch([("tc", (s, None)) for s in picks])
        batch_s = time.perf_counter() - t0
    finally:
        Engine._try_batch, Engine.ask = try_batch, ask
    check(len(tries) == 1 and tries[0] is not None and not asks,
          f"G10K ask_batch: {len(tries)} batch attempts "
          f"({sum(t is not None for t in tries)} ran), {len(asks)} asks")
    counted("G10K ask_batch", ())
    for s, ans in zip(picks, batch):
        check_tc("ask_batch", s, ans)
    bst = eng.stats["tc__bf"]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dense = {s: eng.ask_dense("tc", (s, None)) for s in picks[:TUPLE_ASK]}
    dense_s = (time.perf_counter() - t0) / TUPLE_ASK
    counted("G10K ask_dense", ("csr_bool_step",))
    for s, d in dense.items():
        check(np.array_equal(d, asked[s]), f"ask_dense tc({s}, X) != ask")
    say(f"G10K magic sets: ask {ask_s * 1e3:.1f} ms a query, ask_batch of "
        f"{len(picks)} as one fixpoint in {batch_s:.2f} s ({bst.iterations} "
        f"iterations, generated {bst.generated}), ask_dense {dense_s * 1e3:.1f}"
        " ms a query; every answer the closure's row")
    phase["magic"] = {"ask_ms": ask_s * 1e3, "batch_s": batch_s,
                      "batch_iterations": bst.iterations,
                      "batch_generated": bst.generated,
                      "ask_dense_ms": dense_s * 1e3}
    del eng, closure, crow, want_row

    # (3) min<> in recursion: dpath on G10K, phase 7's weights
    eng = Engine(SPATH, db={"darc": wedges}, default_cap=1 << 22,
                 device=DEVICE)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ans = eng.ask_batch([("dpath", (s, None, None)) for s in picks])
    dp_s = time.perf_counter() - t0
    counted("G10K dpath ask_batch", ())
    oracle = Oracle(wedges, n, True)
    for s, a in zip(picks, ans):
        oracle.check(s, a)
    dst = eng.stats["dpath__bff"]
    say(f"G10K dpath: ask_batch of {len(picks)} in {dp_s:.2f} s "
        f"({dst.iterations} iterations, generated {dst.generated}); every "
        "answer Dijkstra's")
    phase["dpath"] = {"batch_s": dp_s, "iterations": dst.iterations,
                      "generated": dst.generated}

    # (4) sum<> increments: cpath on phase 6's DAG
    cedges = dag_graph(CPATH_N, CPATH_P, seed=SEED)
    csrcs = [int(s) for s in rng.permutation(CPATH_N)[:TUPLE_CPATH]]
    eng = Engine(CPATH, db={"d": cedges}, default_cap=1 << 22, device=DEVICE)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ans = eng.ask_batch([("cpath", (s, None, None)) for s in csrcs])
    cp_s = time.perf_counter() - t0
    counted("cpath ask_batch", ())
    oracle = DagOracle(cedges, CPATH_N, "sum")
    for s, a in zip(csrcs, ans):
        oracle.check(s, a)
    cst = eng.stats.get("cpath__bff")
    say(f"DAG cpath: ask_batch of {len(csrcs)} in {cp_s:.2f} s"
        + (f" ({cst.iterations} iterations, generated {cst.generated})"
           if cst else "") + "; every count the int64 DP's")
    phase["cpath"] = {"batch_s": cp_s}
    del eng, oracle

    # (5) non-linear TC on G1K: the shuffle join
    g1k = gnp_graph(NL_N, NL_P, seed=NL_SEED)
    adj1 = torch.zeros((NL_N, NL_N), dtype=torch.bool, device=DEVICE)
    adj1[torch.from_numpy(g1k[:, 0]).to(DEVICE),
         torch.from_numpy(g1k[:, 1]).to(DEVICE)] = True
    closure1 = sn.transitive_closure_dense(adj1).table
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = Engine(TC_NONLINEAR, db={"arc": g1k}, caps={"tc": 1 << 21},
                 join_cap=TUPLE_JOIN_CAP, device=DEVICE).run()
    torch.cuda.synchronize()
    nl_s = time.perf_counter() - t0
    counted("G1K non-linear TC", ())
    _rows_equal_closure(torch, eng.query("tc"), closure1, "G1K non-linear TC")
    nst = eng.stats["tc"]
    say(f"G1K non-linear TC: {len(eng.query('tc'))} facts in {nl_s:.2f} s, "
        f"{nst.iterations} iterations, generated {nst.generated}; equal to "
        "the K1 closure")
    phase["tc_nonlinear"] = {"seconds": nl_s, "iterations": nst.iterations,
                             "generated": nst.generated}
    del eng, closure1, adj1
    torch.cuda.empty_cache()

    # (6) the service's tuple path on G1K
    svc = DatalogService(TC + SG, db={"arc": g1k}, default_cap=TUPLE_SVC_CAP,
                         join_cap=TUPLE_SVC_JOIN_CAP, device=DEVICE)
    full = Engine(TC + SG, db={"arc": g1k}, default_cap=TUPLE_SVC_CAP,
                  join_cap=TUPLE_JOIN_CAP, device=DEVICE).run()
    spicks = [int(s) for s in rng.permutation(NL_N)[:TUPLE_SVC]]
    qs = [f"tc(X, {s})" for s in spicks] + [f"sg({s}, X)" for s in spicks]

    def check_svc(label, answers, model):
        tc_rows, sg_rows = model.query("tc"), model.query("sg")
        for q, a, s in zip(qs, answers, spicks + spicks):
            want = tc_rows[tc_rows[:, 1] == s] if q.startswith("tc") \
                else sg_rows[sg_rows[:, 0] == s]
            check(np.array_equal(a, want), f"{label} {q}: {len(a)} answers, "
                  f"the full model {len(want)}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    answers = svc.ask_batch(qs)
    svc_s = time.perf_counter() - t0
    counted("G1K service batch", ())
    check_svc("service", answers, full)
    st0 = dict(svc.explain()["service"])
    check(st0["tuple_fixpoints"] == 1
          and st0["tuple_batched_queries"] == TUPLE_SVC,
          f"the sg(s, X) batch did not run as one qid-batched fixpoint: {st0}")
    hits0 = svc.cache.hits
    check_svc("service (repeat)", svc.ask_batch(qs), full)
    check(svc.cache.hits - hits0 == len(qs),
          f"the repeated batch hit the cache {svc.cache.hits - hits0} times")
    have = {tuple(r) for r in g1k.tolist()}
    extra = []
    while len(extra) < TUPLE_APPEND:
        a, b = (int(x) for x in rng.integers(0, NL_N, 2))
        if a != b and (a, b) not in have:
            have.add((a, b))
            extra.append((a, b))
    extra = np.asarray(extra, np.int64)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    svc.append("arc", extra)
    app_s = time.perf_counter() - t0
    counted("G1K service append", ())
    resumed = svc.stats.resumed_tuple_rows
    check(resumed > 0, "the append resumed no tuple snapshot")
    union = np.concatenate([g1k, extra])
    cold = Engine(SG, db={"arc": union}, default_cap=TUPLE_SVC_CAP,
                  join_cap=TUPLE_JOIN_CAP, device=DEVICE)
    hits0 = svc.cache.hits
    for s in spicks[:TUPLE_ASK]:
        got = svc.ask("sg", (s, None))
        check(np.array_equal(got, cold.ask("sg", (s, None))),
              f"resumed sg({s}, X) differs from a cold engine on the union")
    check(svc.cache.hits - hits0 == TUPLE_ASK,
          "the resumed answers were not served from the refreshed cache")
    rep = svc.explain()
    say(f"G1K service: batch of {len(qs)} ({TUPLE_SVC} tc(X, s), "
        f"{TUPLE_SVC} sg(s, X)) in {svc_s:.2f} s, {st0['tuple_fixpoints']} "
        f"qid-batched fixpoint(s) for {st0['tuple_batched_queries']} queries, "
        f"{st0['tuple_runs']} tuple runs, {st0['plans_built']} plans; "
        f"the repeat from the cache; append of {len(extra)} arcs in "
        f"{app_s:.2f} s resumed {resumed} answers; templates "
        f"{rep['templates']}")
    phase["service"] = {"batch_s": svc_s, "append_s": app_s,
                        "resumed_tuple_rows": resumed,
                        "stats": rep["service"]}
    del svc, full, cold
    torch.cuda.empty_cache()
    phase["seconds"] = time.perf_counter() - t_phase
    say(f"tuple phase: {phase['seconds']:.1f} s")
    results["tuple_phase"] = phase


# -- phase 8: the LM serving path ----------------------------------------------

#: RecurrentGemma-2B at its published widths and depth; the prefill is cut
#: from ``prefill_32k`` (32,768 x 32) to B x S (module docstring, phase 8)
LM_ARCH, LM_BATCH, LM_SEQ = "recurrentgemma-2b", 2, 4096
DECODE_BATCH, DECODE_PROMPT, DECODE_GEN = 4, 64, 16
#: K9's ragged cases: sq = sk, windows (0 and -3: causal rows with no
#: valid key, which softmax to the uniform row, and non-causal windows that
#: admit only keys past q + 0 or q + 3), softcaps (with a scale of 0.1, as
#: gemma2 passes ``attn_scale`` beside its softcap), causal or not, GQA
#: repeats, head dims, f32 and bf16
K9_SEQS = (1, 63, 130, 2049)
K9_WINDOWS = (None, 64, 2048, 0, -3)
K9_SOFTCAPS = (None, 50.0)
K9_REPS = (1, 2, 10)
K9_DIMS = (16, 128, 256)
#: K10's ragged cases: B, W and the longest S; the other S straddle the
#: default plan's ring (:func:`k10_ragged_parity`).  Widths that are
#: multiples of 4 take the TMA route, the others (and copies of the former
#: off a 16-byte boundary) the cp.async route
K10_BATCHES, K10_WIDTHS, K10_LONG = (1, 3), (1, 4, 16, 33, 130, 2564), 4097
#: seconds a K10 case may take before the run fails as hung
K10_WATCHDOG_S = 30.0
#: decode's logits at the prompt's last position against the prefill's on
#: the same tokens: max |Δ| within DECODE_MAX_FRAC of the largest |logit|,
#: mean |Δ| within DECODE_MEAN_FRAC.  The two paths compute the same
#: function, but round bf16 activations after GEMMs of other shapes (M =
#: 256 rows in the prefill, 4 in a decode step: other kernels, other sum
#: orders), and the differences compound over 26 layers (the JAX package's
#: own decode test allows 0.15 on logits near 0.6 for 4-5 layers)
DECODE_MAX_FRAC, DECODE_MEAN_FRAC = 0.1, 0.02
#: K9's tolerance against its plain version (the same f32 arithmetic: the
#: 256-term dots and the softmax sums are taken in another order, and the
#: online softmax rescales; a bf16 output adds one rounding step of bf16,
#: 2^-7 of the value): |got - want| <= K9_ATOL * max(1, max|v|) + (bf16
#: only) 2^-7 * |want|
K9_ATOL = 5e-5


def flash_err(torch, got, want, v) -> float:
    """K9's output against its plain version's, within :data:`K9_ATOL`
    (and a bf16 rounding step): returns the max abs error."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{got.dtype}{tuple(got.shape)} vs {want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = K9_ATOL * max(1.0, float(v.float().abs().max()))
    if got.dtype == torch.bfloat16:
        tol = tol + w.abs() * 2.0 ** -7
    err = float(diff.max()) if diff.numel() else 0.0
    check(bool(torch.isfinite(g).all()) and bool((diff <= tol).all()),
          f"K9 != plain beyond tolerance (max abs err {err})")
    return err


def k9_ragged_parity():
    """K9 against its plain version within :func:`flash_err`'s tolerance at
    every case of the ``K9_*`` grids (sq = sk): bf16 cases on the
    tensor-core kernel, f32 cases on the CUDA-core kernel, each call
    checked to have launched its dtype's kernel."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
    t0 = time.perf_counter()
    cases, worst = 0, {torch.float32: 0.0, torch.bfloat16: 0.0}
    for s in K9_SEQS:
        b = 1 if s > 1024 else 2
        for rep in K9_REPS:
            hkv = 1 if rep == 10 else 2
            for d in K9_DIMS:
                for dtype in (torch.float32, torch.bfloat16):
                    counter = fa.ROUTES[dtype][1]
                    q, k, v = (torch.randn((b, h, s, d), generator=gen,
                                           device=DEVICE).to(dtype)
                               for h in (hkv * rep, hkv, hkv))
                    for causal in (True, False):
                        for window in K9_WINDOWS:
                            for cap in K9_SOFTCAPS:
                                kw = dict(causal=causal, window=window,
                                          softcap=cap,
                                          scale=None if cap is None else 0.1)
                                got = _counted(counter, lambda: (
                                    fa.flash_attention(q, k, v, **kw)))
                                err = flash_err(torch, got,
                                                fa.plain(q, k, v, **kw), v)
                                worst[dtype] = max(worst[dtype], err)
                                cases += 1
    torch.cuda.synchronize()
    say(f"parity (K9, ragged): {cases} cases within tolerance (sq = sk "
        f"{list(K9_SEQS)}, windows {list(K9_WINDOWS)}, softcaps "
        f"{list(K9_SOFTCAPS)}, causal and not, rep {list(K9_REPS)}, d "
        f"{list(K9_DIMS)}; {cases // 2} f32 cases on the CUDA cores, "
        f"{cases // 2} bf16 on the tensor cores); max abs err f32 (CUDA "
        f"cores) {worst[torch.float32]:.3e}, bf16 (tensor cores) "
        f"{worst[torch.bfloat16]:.3e} ({time.perf_counter() - t0:.1f} s)")


def _watchdog(torch, what: str, seconds: float) -> None:
    """Wait for the work queued so far on the current stream, failing the
    run (at once, without the interpreter's teardown, which would wait on
    the card) if it has not finished within ``seconds``: a ring whose
    barriers never complete hangs instead of giving a wrong answer."""
    done = torch.cuda.Event()
    done.record()
    deadline = time.monotonic() + seconds
    while not done.query():
        if time.monotonic() > deadline:
            say(f"chip_smoke FAILED: {what} still running after {seconds} s "
                f"(hung)")
            sys.stderr.flush()
            os._exit(1)
        time.sleep(0.001)


def k10_ragged_parity():
    """K10 against its plain version, exactly, at every (B, S, W) of the
    ``K10_*`` grids, S across the default plan's ring (1, T - 1, T, T + 1,
    2T + 1 and 4T + 1, where 2 and 4 stages wrap, and :data:`K10_LONG`),
    and at the widths that are multiples of 4 again from operands off a
    16-byte boundary; each launch awaited by :func:`_watchdog`, and both
    routes must have run."""
    import torch
    from repro_torch.kernels import rglru_scan as rg
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    seqs = (1, rg.T - 1, rg.T, rg.T + 1, 2 * rg.T + 1, 4 * rg.T + 1,
            K10_LONG)
    t0 = time.perf_counter()
    routes: dict = {}
    for b in K10_BATCHES:
        for s in seqs:
            for w in K10_WIDTHS:
                a = torch.rand((b, s, w), generator=gen, device=DEVICE)
                a = 0.5 + 0.49 * a
                x = torch.randn((b, s, w), generator=gen, device=DEVICE)
                pairs = [(a, x)]
                if w % 4 == 0 and b == K10_BATCHES[-1] and s == seqs[-2]:
                    pairs.append((_misaligned(torch, a),
                                  _misaligned(torch, x)))
                for pa, px in pairs:
                    route = rg.route(pa, px)
                    got = rg.rglru_scan(pa, px)
                    _watchdog(torch, f"K10 at {(b, s, w)} ({route})",
                              K10_WATCHDOG_S)
                    equal_and_err(torch, got, rg.plain(pa, px))
                    routes[route] = routes.get(route, 0) + 1
    torch.cuda.synchronize()
    check(set(routes) == {"tma", "cp.async"},
          f"K10's ragged cases ran the routes {routes}, want both")
    say(f"parity (K10, ragged): {sum(routes.values())} cases exactly equal "
        f"to plain (B {list(K10_BATCHES)}, S {list(seqs)}, W "
        f"{list(K10_WIDTHS)}; default plan (CW, T) = {(rg.CW, rg.T)}; "
        f"routes {routes}) "
        f"({time.perf_counter() - t0:.1f} s)")


#: kernel-name fragments of the device-time breakdown, in the order tried
KERNEL_CLASSES = (("K9", ("flash_kernel",)), ("K10", ("rglru_scan",)),
                  ("GEMM", ("gemm", "nvjet", "xmma", "cutlass")))


def profile_breakdown(torch, label, fn, top=6):
    """Device time of one call of ``fn`` by kernel class (K9, K10, GEMM,
    the rest), the top kernels by name and the device's idle share of the
    synced wall time, from ``torch.profiler``.  Returns None (and says
    "not measured") when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        kernels[e.key] = (kernels.get(e.key, (0.0, 0))[0] + us / 1e3,
                          kernels.get(e.key, (0.0, 0))[1] + e.count)
    busy = sum(ms for ms, _ in kernels.values())
    if busy <= 0:
        say(f"{label} breakdown: not measured (no device time in the trace)")
        return None
    classes = {}
    for name, (ms, _) in kernels.items():
        cls = next((c for c, frags in KERNEL_CLASSES
                    if any(f in name.lower() for f in frags)), "other")
        classes[cls] = classes.get(cls, 0.0) + ms
    tops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    out = {"wall_ms": wall_ms, "device_ms": busy,
           "idle_share": max(0.0, 1.0 - busy / wall_ms),
           "classes_ms": classes,
           "top": [(name[:80], ms, n) for name, (ms, n) in tops]}
    say(f"{label} breakdown (torch.profiler, traced): wall {wall_ms:.2f} ms, "
        f"device {busy:.2f} ms, idle {out['idle_share']:.3f}; "
        + ", ".join(f"{c} {ms:.2f} ms" for c, ms in sorted(
            classes.items(), key=lambda kv: -kv[1])))
    for name, ms, n in out["top"]:
        say(f"  {ms:9.3f} ms  {n:5d} x  {name}")
    return out


def _spy(captured, name, fn):
    """``fn``, recording the arguments of its first call under ``name``."""
    def spy(*args, **kw):
        captured.setdefault(name, (args, kw))
        return fn(*args, **kw)
    return spy


def _k9_bound(torch, q, k, v, kw):
    """K9's bound: 4·d flops a live (query, key) pair of every (batch, q
    head) over the bf16 tensor-core peak, against q, k, v and o read or
    written once."""
    b, hq, sq, d = q.shape
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(k.shape[2], device=q.device)[None, :]
    ok = torch.ones((sq, k.shape[2]), dtype=torch.bool, device=q.device)
    if kw.get("causal", True):
        ok &= qp >= kp
    if kw.get("window") is not None:
        ok &= (qp - kp) < kw["window"]
    live = int(ok.sum())
    bytes_ = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return _bound(bytes_, 4 * b * hq * d * live, BF16_OPS_S), live, ok


def _k9_at_path(torch, q, k, v, kw):
    """K9 at the prefill's first ``local`` block inputs: held to its plain
    version within :func:`flash_err`'s tolerance, timed beside it, its
    bound and ``scaled_dot_product_attention`` (kv heads repeated, a
    boolean causal/window mask; timed only).  Says which route ran."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    route = fa.ROUTES[q.dtype][1]
    got = _counted(route, lambda: fa.flash_attention(q, k, v, **kw))
    err = flash_err(torch, got, fa.plain(q, k, v, **kw), v)
    del got
    (bound_ms, bound_by), live, ok = _k9_bound(torch, q, k, v, kw)
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw), 10)
    plain_ms = time_ms(torch, lambda: fa.plain(q, k, v, **kw), 2)
    rep = q.shape[1] // k.shape[1]
    kx, vx = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, kx, vx, attn_mask=ok, scale=kw.get("scale")), 10)
    say(f"flash_attention (K9, route {route}): {ms:.3f} ms (plain "
        f"{plain_ms:.3f} ms, sdpa {lib_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"by {bound_by}; {live} live pairs a head) at q {tuple(q.shape)} "
        f"{q.dtype}, kv {tuple(k.shape)}, {kw}; max abs err {err:.3e}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def lm_phase(results):
    """The LM serving path (module docstring, phase 8)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import Model
    from repro_torch.train import make_prefill_step, make_serve_step
    t_phase = t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    model = Model(cfg, device=DEVICE).init(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"{LM_ARCH}: {len(model.layers)} layers ({model.ltypes.count('rg')} "
        f"rg, {model.ltypes.count('local')} local), d_model {cfg.d_model}, "
        f"vocab {model.vocab}: {n_params} parameters, "
        f"{n_params * 4 / 1e9:.2f} GB f32, drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (LM_BATCH, LM_SEQ))).to(DEVICE)}
    prefill = make_prefill_step(model)

    # a first prefill, its K9/K10 inputs captured; then the counted run
    captured = {}
    flash, rglru = ops.flash, ops.rglru
    ops.flash = _spy(captured, "flash", flash)
    ops.rglru = _spy(captured, "rglru", rglru)
    try:
        t0 = time.perf_counter()
        prefill(batch)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
    finally:
        ops.flash, ops.rglru = flash, rglru
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    last = prefill(batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_local, n_rg = model.ltypes.count("local"), model.ltypes.count("rg")
    # K9's bf16 inputs take the tensor-core route (counter
    # "flash_attention"); its f32 route ("flash_attention_f32") is one of
    # the other kernels, which must not launch
    check(counts["flash_attention"] == n_local and counts["rglru_scan"] == n_rg,
          f"prefill launches K9 {counts['flash_attention']} on the tensor "
          f"cores (want {n_local}), K10 {counts['rglru_scan']} (want {n_rg})")
    check(not any(v for k, v in counts.items()
                  if k not in ("flash_attention", "rglru_scan")),
          f"prefill launched other kernels: {counts}")
    check(last.shape == (LM_BATCH, model.vocab)
          and bool(torch.isfinite(last.float()).all()),
          f"prefill logits {tuple(last.shape)} not all finite")
    tokens = LM_BATCH * LM_SEQ
    say(f"prefill ({LM_BATCH} x {LM_SEQ} tokens): {secs:.3f} s synced, "
        f"{tokens / secs:.0f} tokens/s (first call {cold:.3f} s); launches "
        f"K9 {counts['flash_attention']} (tensor cores), K10 "
        f"{counts['rglru_scan']}; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del last
    phase = {"prefill_s": secs, "prefill_cold_s": cold,
             "prefill_tokens_per_s": tokens / secs, "params": n_params,
             "prefill_breakdown": profile_breakdown(
                 torch, "prefill", lambda: prefill(batch))}

    # the kernels at the path's inputs, then at ragged shapes
    (q, k, v), kw = captured["flash"]
    results["flash_attention"] = {
        "launches": counts["flash_attention"], **_k9_at_path(torch, q, k, v,
                                                             kw)}
    (a, b), _ = captured["rglru"]
    say(f"rglru_scan (K10) at the prefill's input: route {rg.route(a, b)}, "
        f"plan (CW, T, stages) = "
        f"{(rg.CW, rg.T, rg.stages(a.shape[0], a.shape[2]))}")
    results["rglru_scan"] = {
        "launches": counts["rglru_scan"],
        **measure(torch, "rglru_scan (K10)", rg.rglru_scan, rg.plain, (a, b),
                  20, _bound(12 * a.numel(), 2 * a.numel(), F32_OPS_S))}
    # one prompt: half the CTAs of the captured input; a in [0, 1), the
    # gates' range
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 17)
    a1 = torch.rand((1,) + tuple(a.shape[1:]), generator=gen, device=DEVICE)
    b1 = torch.randn(a1.shape, generator=gen, device=DEVICE)
    one = measure(torch, "rglru_scan (K10, one prompt)", rg.rglru_scan,
                  rg.plain, (a1, b1), 20,
                  _bound(12 * a1.numel(), 2 * a1.numel(), F32_OPS_S))
    results["rglru_scan"]["one_prompt"] = {
        k: one[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")}
    del captured, q, k, v, a, b, a1, b1
    k9_ragged_parity()

    # decode: the serve loop, checked against the prefill on its prompt
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (DECODE_BATCH, DECODE_PROMPT))).to(DEVICE)
    want = prefill({"tokens": prompts}).float()
    out = generate(model, prompts, DECODE_GEN)
    check(bool(torch.isfinite(out["logits"].float()).all()),
          "decode logits not all finite")
    got = out["logits"][:, DECODE_PROMPT - 1].float()
    diff = (got - want).abs()
    scale = float(want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    check(float(diff.max()) <= DECODE_MAX_FRAC * scale
          and float(diff.mean()) <= DECODE_MEAN_FRAC * scale,
          f"decode vs prefill logits: max {float(diff.max())}, mean "
          f"{float(diff.mean())}, largest |logit| {scale}")
    ms_tok = out["seconds"] / DECODE_GEN * 1e3
    say(f"decode (batch {DECODE_BATCH}, {DECODE_PROMPT}-token prompt fed "
        f"token by token, {DECODE_GEN} generated): {ms_tok:.2f} ms a token "
        f"({DECODE_BATCH * 1e3 / ms_tok:.0f} tokens/s); prompt-end logits "
        f"vs prefill: max |d| {float(diff.max()):.4f}, mean "
        f"{float(diff.mean()):.5f} (largest |logit| {scale:.3f}), argmax "
        f"agrees on {agree:.2f} of rows")
    serve = make_serve_step(model)
    cache = model.init_cache(DECODE_BATCH, DECODE_PROMPT + 1)
    for t in range(DECODE_PROMPT):
        _, _, cache = serve(cache, prompts[:, t], t)
    phase["decode_breakdown"] = profile_breakdown(
        torch, "decode step", lambda: serve(cache, prompts[:, 0],
                                            DECODE_PROMPT))
    phase.update(decode_ms_per_token=ms_tok, decode_max_abs=float(diff.max()),
                 decode_mean_abs=float(diff.mean()), logit_scale=scale,
                 argmax_agree=agree, seconds=time.perf_counter() - t_phase)
    say(f"LM phase: {phase['seconds']:.1f} s")
    del model, prefill, serve, out, cache
    torch.cuda.empty_cache()
    results["lm_phase"] = phase


def main():
    t_start = time.perf_counter()
    card = check_device()
    build_kernels()
    import torch
    ragged_parity()
    k12_ragged_parity()
    k7_ragged_parity()
    k8_ragged_parity()
    raw_entry_parity()
    k10_ragged_parity()
    results: dict = {}
    dense_phase(results)
    edges, wedges, sp_oracle = csr_phase(results)
    tuned_phase(results, wedges, sp_oracle)
    del wedges, sp_oracle
    dag_phase(results, edges)
    del edges
    allpairs_phase(results)
    tuple_phase(results)
    lm_phase(results)
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **{k: results[name][k] for k in (
             "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")},
         **{k: v for k, v in results[name].items()
            if k in ("captured", "ask", "full", "one_prompt")}}
        for name, (src, rep) in KERNELS.items()]}
    say("phases: " + json.dumps({k: results[k]
                                 for k in ("dense_phase", "csr_phase",
                                           "tuned_phase", "dag_phase",
                                           "allpairs_phase", "tuple_phase",
                                           "lm_phase")}))
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(card)
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
