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

10. observability, admission and analytics (run inside the phases whose
   services and graphs they reuse, so that no carrier is packed twice; the
   counts reset just before each step and read just after):
   (1) probes: phase 4's dense TC and SPATH, phase 5's CSR TC and SPATH,
   phase 5b's tuned SPATH (K7, after its appends) and phase 6's dense and
   CSR LPATH (K2-max, K6) answer their second warm batch (100 dense, 32
   CSR sources) unprobed and then through ``svc.probe`` (the result cache
   emptied before each): every answer and cached carrier row bit for bit
   the unprobed one, the probe's ``iterations`` the unprobed batch's,
   ``seed_facts + total_delta == final_facts`` for bool, and equal launch
   counts; phase 7b's ``Engine.ask_dense("tc", (s, None), probe=True)``
   for 4 G10K sources equals ``ask_dense``, its ``final_facts`` the BFS
   reach; (2) spans, metrics, attribution: phases 4 and 5 build their TC
   services with ``tracer=True``: ``fixpoint`` spans nest in
   ``launch_batch`` and ``cache_fill`` in ``finalize_batch``, the Chrome
   export parses with ``json.load``, ``to_prometheus()`` holds
   :data:`PROM_NAMES`, ``explain()["kernels"]`` holds
   ``frontier_matmul:bool`` / ``csr_spmv:bool`` with launches, device
   wall seconds (CUDA events around the fixpoint, the host loop's gaps
   included), the dominant term and non-negative shares
   (printed, not bounded: JAX's analytic model bills work the kernels
   skip), and warm qps with ``metrics=False`` beside the default registry
   (two services that share the carrier); (3) admission on phase 5's CSR
   TC service: 256 new sources answered by 8 sequential ``ask_batch``
   calls of 32, the cache emptied, then ``AsyncDatalogService(max_wait_ms
   =2, max_batch=32)`` with 8 submitter threads x 32 sources (every future
   awaited with :data:`FUTURE_TIMEOUT`): each answer the sequential one, 4
   scipy's BFS, at least 8 flushes of at most 32, a ``finalize_batch``
   span overlapping a ``launch_batch`` span; then 1,000 arcs appended
   through the front-end's fence with 64 queries in flight, each answer one
   epoch's whole answer and 4 post-append answers scipy's BFS on the union;
   async and sequential qps, the queue wait's p50/p99 and the flush sizes;
   (4) analytics at the largest sizes the packed keys admit, each against
   a numpy oracle of the smoke's own, with seconds and peak memory: naive
   Bayes (``bits=16``) on a seeded table of UCI Adult's shape (48,842 rows,
   10 categorical columns, :data:`ADULT_CARDS`; 1,000 rows held out): the
   counts numpy's group-by counts, the predictions the oracle's argmax;
   Example 8 (``bits=15``) on the first 32,767 rows: every prefix count a
   numpy trie's; Example 9 (``bits=12``) on the most rows whose prefix
   table keeps node ids below 4,096 (all 10 columns), against a walk of
   the table; Example 7 (k-cores, out-degree >= 16) on phase 5's 16M arcs
   against min-label propagation by ``scatter_reduce`` on the card; and
   Example 6 (``hops``, the effective diameter) on G10K in phase 7b, its
   histogram equal to the K1 hop layers.
11. durability (``DatalogService(durable_dir=...)``, in a temporary
   directory deleted at the end): WAL appends of 1,000 and 10,000 rows
   timed with ``fsync`` on and off; (a) a durable CSR TC service on phase
   5's 16M power-law arcs, uncut: a batch of 32 sources (its construction
   plus this batch is the cold start: it packs the CSR), a 10,000-arc tail
   append, ``snapshot()`` (the copy to the host under the lock, timed) and
   its publication (timed; bytes on disk), a 1,000-arc append left in the
   WAL, then, with no ``close()``, a second service on the genesis arcs and
   the same directory: recovery ``warm`` with 1 WAL record replayed (K3
   launched by the replay's resume), the first service's epoch, the 32
   answers bit for bit the first service's, 4 of them scipy's BFS, a
   repeat batch of restored-cache hits with no launch, and a new batch
   through K3 equal to the first service's; peak device memory with both
   services resident; then a second generation from the recovered service,
   one byte of it flipped by the smoke's own code: the third service
   recovers ``degraded`` from the first generation, bit for bit again;
   (b) a durable dense SPATH service on phase 4's Gn-p graph: 32 sources, a
   snapshot, a 100-arc append, one warm restart (K2 launched by the
   replay), the answers bit for bit, 4 Dijkstra's, the repeat batch with
   no launch; (c) ``python -m repro_torch.service.serve --synthetic
   gnp:10000:0.001 --durable DIR`` with queries and an append, run twice
   in subprocesses: ``fresh`` then ``warm``, the same answer lines; and
   ``examples/serve_quickstart_torch.py`` once on the card.
12. distribution (``core.distributed``, ``DatalogService(mesh=...)``), on
   a worker mesh of :data:`MESH_SHARDS` shards that all share the card
   (``make_worker_mesh(4, devices=["cuda:0"] * 4)``), run inside the
   phases whose graphs and services it reuses; each step between
   launch-count and census reads, every check exact: (1) mesh TC and
   SPATH services on phase 4's Gn-p graph (their own carriers): the cold
   and warm batches of 100 sources equal the unsharded services' answers,
   K1 / K2 launched 4 x iterations and nothing else, one broadcast a
   fixpoint and one scalar psum an iteration; then phase 4's appends
   reach the mesh services too, which resume through the mesh and answer
   the resumed batch and the appended sources as the unsharded ones do;
   (2) mesh services on phase 5's CSR TC and SPATH carriers, phase 5b's
   tuned SPATH (K7) and phase 6's CSR LPATH (K6) (each takes the
   unsharded service's packed carrier): batches of 32 equal to the
   unsharded answers, launches 4 x iterations + one seed step a fixpoint;
   (3) on G10K (phase 7) ``tc_decomposable`` (K1 at M = 2,500),
   ``spath_decomposable`` (K2) and ``sg_allreduce`` (f32 ``matmul``, no
   counted kernel) equal to ``transitive_closure_dense``,
   ``shortest_paths_dense`` and ``same_generation_dense``, with their
   census: Fig. 4's one broadcast and one scalar psum an iteration, SG's
   one gather, then one (n, n) and one scalar all-reduce an iteration
   after the exit rule's; (4) connected components by ``psn_shuffle_agg``
   on phase 5's arcs made symmetric (32M arcs), every label the least
   vertex of its scipy component, the iterations min-label propagation's
   changing rounds + 1, no overflow, two all-to-alls and one psum an
   iteration; (5) the scale-out table: G10K's ``tc_decomposable`` and the
   CSR TC batch's ``csr_frontier_decomposable`` at :data:`SCALE_SHARDS`
   shards, each equal to the unsharded table, with rows a shard,
   iterations, launches, census and device ms (one card: structure, not
   speedup); (6) with two or more cards, 12.1's TC batch on
   ``make_worker_mesh(2)`` (distinct cards, peer copies); with one, a line
   saying that route was not run.
13. the LM training path (after phase 8): (a) K9-bwd
   (``flash_attention_bwd``) against its plain version within
   :data:`K9_BWD_TOL` at every case of K9's ragged grid (``K9_*``: all-masked
   rows too; bf16 and f32, each call checked to launch K9-bwd) and at the
   path's tiling (:data:`K9_BWD_PATH_SEQ`, no floor), given the plain
   forward's output and log-sum-exp, and K9's own log-sum-exp
   (``return_lse``, each route) against the plain one within
   :data:`K9_ATOL`; K10-bwd (``rglru_scan_bwd``) exactly at K10's ragged
   cases, each awaited by the watchdog; at one small shape each,
   ``ops.flash`` and ``ops.rglru`` differentiated on the card (K9 + K9-bwd,
   K10 + K10-bwd) against ``torch.autograd`` of the plain forwards; (b)
   RecurrentGemma-2B at its published widths and depth, from seed 0 on the
   card, ``make_train_step`` with AdamW (``warmup_steps=1``), ``remat=True``,
   sequence :data:`TRAIN_SEQ` (``train_4k``'s length), global batch
   :data:`TRAIN_BATCH` in :data:`TRAIN_ACCUM` microbatches (cut from
   ``train_4k``'s 256 to fit one card), :data:`TRAIN_STEPS` steps: every
   loss and grad norm finite, step 1's loss equal to ``model.loss`` on the
   same microbatches under ``no_grad`` (:data:`TRAIN_LOSS_RTOL`), each
   step's launches exactly K9 2 x 16, K9-bwd 2 x 8, K10 2 x 34, K10-bwd
   2 x 18 and nothing else (each microbatch runs its 8 ``local`` and 16
   group ``rg`` blocks twice under remat, its 2 tail ``rg`` blocks once,
   and every block's backward once); s a step (synced), tokens/s, peak
   memory, a ``torch.profiler`` breakdown of one step (GEMM, K9, K9-bwd,
   K10, K10-bwd, other; the optimizer's device ms from one ``adamw_update``
   profiled alone) and the idle share; K9-bwd and K10-bwd timed at the
   inputs of the first call each of a step's backward (the last ``local``
   and ``rg`` blocks) beside their plain versions, their bounds and, for
   K9-bwd, ``scaled_dot_product_attention``'s backward on the same tensors
   (K9-bwd held there with no floor, and what one bf16 rounding of P and
   dS would cost against the tolerance);
   (c) ``examples/train_lm_torch.py``'s ``demo`` model through
   ``runtime.TrainDriver`` for :data:`DRIVER_STEPS` steps, uninterrupted and
   with a failure at :data:`DRIVER_FAIL` under ``run_with_restarts`` (the
   driver's steps run in deterministic mode): the loss falls, and the
   resumed run's parameters, moments and losses equal the uninterrupted
   run's bit for bit; the kernels one demo step launches with
   ``torch.use_deterministic_algorithms`` off and on, by name; then
   ``python -m repro_torch.launch.train --arch recurrentgemma-2b --smoke
   --steps 3`` once; (c) runs in a process of its own whose environment
   sets ``CUBLAS_WORKSPACE_CONFIG`` (deterministic mode's cuBLAS
   workspace) from the start.

The line before the last is one JSON object of kernel measurements; the last
line is ``{"ok": true, "device": {...}}``.  Needs no network; the graphs are
made from fixed seeds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
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
    # the backward kernels of the training path: kernels of the port with
    # no TPU counterpart (the JAX package differentiates plain JAX)
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "none: the backward of src/repro/kernels/flash_attention.py:95, "
        "which has none"),
    "rglru_scan_bwd": (
        "src/repro_torch/kernels/csrc/rglru_scan_bwd.cu",
        "none: the backward of src/repro/kernels/rglru_scan.py:49, which "
        "has none"),
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
#: phase 12: the worker mesh's shards (all on the card) and the scale-out
#: table's shard counts
MESH_SHARDS = 4
SCALE_SHARDS = (1, 2, 4, 8)


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
    tc = DatalogService(TC, db={"arc": edges}, tracer=True)
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
    # phase 12.1: the same traffic on mesh services with their own carriers
    with phase12(results) as mesh:
        mtc = mesh_service(TC, {"arc": edges})
        msp = mesh_service(SPATH, {"darc": wedges})
        batches = (("cold", srcs), ("warm", srcs2))
        mesh["dense TC"] = mesh_batches("dense TC", tc, mtc, "tc", False,
                                        batches, "bool_matmul", False)
        mesh["dense SPATH"] = mesh_batches("dense SPATH", sp, msp, "dpath",
                                           True, batches, "minplus_matmul",
                                           False)
        mesh["cross_device"] = mesh_cross_device(tc, edges, srcs)
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
    with phase12(results) as mesh:
        mesh["appends"] = mesh_appends(
            (("dense TC", tc, mtc, "tc", "arc", "bool_matmul"),
             ("dense SPATH", sp, msp, "dpath", "darc", "minplus_matmul")),
            dense_append_rows(srcs), srcs, single)
    del mtc, msp
    obs = results["obs_phase"]
    obs.setdefault("probe", {}).update({
        "dense TC": probe_twin("dense TC", tc, "tc", srcs2, False),
        "dense SPATH": probe_twin("dense SPATH", sp, "dpath", srcs2, True)})
    obs["dense TC"] = obs_checks("dense TC", tc, "tc", srcs2,
                                 "frontier_matmul:bool", TC, tc.bits)
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


def dense_append_rows(srcs) -> dict:
    """The rows :func:`dense_appends` appends, by service: 1,000 seeded
    arcs, then one arc from ``srcs[0]`` to vertex :data:`DENSE_GROW`
    (SPATH's weighted by the same generator)."""
    rng = np.random.default_rng(SEED + 6)
    n = DENSE_N
    extra = np.stack([rng.integers(0, n, 1000), rng.integers(0, n, 1000)], 1)
    grow = np.array([[srcs[0], DENSE_GROW]], np.int64)
    return {"dense TC": [extra, grow],
            "dense SPATH": [_weighted(rng, extra), _weighted(rng, grow)]}


def dense_appends(tc, sp, edges, wedges, srcs, single):
    """Appends on the warm dense Gn-p services: 1,000 arcs, then one arc to
    vertex :data:`DENSE_GROW`, past the allocation (a rebuild; the cached
    rows are re-padded).  Each cached closure resumes; K1 and K2 must run;
    3 resumed sources, the single one and the new vertex equal the oracle
    on the union."""
    import torch
    from repro_torch.kernels import ops
    appended = dense_append_rows(srcs)
    out = {}
    ops.reset_launch_counts()
    for label, svc, pred, edb, base in (("dense TC", tc, "tc", "arc", edges),
                                        ("dense SPATH", sp, "dpath", "darc",
                                         wedges)):
        weighted = base.shape[1] == 3
        union = [base]
        st0 = dataclasses.replace(svc.stats)
        t0 = time.perf_counter()
        for rows in appended[label]:
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
    tc = DatalogService(TC, db={"arc": edges}, bits=20, tracer=True)
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
    # phase 12.2 (mesh services on these services' carriers) and 12.5
    with phase12(results) as mesh:
        for label, svc, program, db, pred, weighted, kernel in (
                ("CSR TC", tc, TC, {"arc": edges}, "tc", False,
                 "csr_bool_step"),
                ("CSR SPATH", sp, SPATH, {"darc": wedges}, "dpath", True,
                 "csr_minplus_step")):
            msvc = mesh_service(program, db, svc, pred, bits=20)
            mesh[label] = mesh_batches(label, svc, msvc, pred, weighted,
                                       (("first", srcs), ("second", srcs2)),
                                       kernel, True)
            del msvc
        mesh.setdefault("scaleout", {})["csr_tc"] = csr_scaleout(torch, tc,
                                                                 srcs)
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
    obs = results["obs_phase"]
    obs.setdefault("probe", {}).update({
        "CSR TC": probe_twin("CSR TC", tc, "tc", srcs2, False),
        "CSR SPATH": probe_twin("CSR SPATH", sp, "dpath", srcs2, True)})
    obs["CSR TC"] = obs_checks("CSR TC", tc, "tc", srcs2, "csr_spmv:bool", TC,
                               tc.bits)
    obs["admission"] = admission_check(tc, edges, n, rng,
                                       set(srcs + srcs2 + [single]))
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
    results["obs_phase"].setdefault("probe", {})["dense LPATH"] = probe_twin(
        "dense LPATH", lp, "lpath", lsrcs2, True)
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
        if label == "CSR LPATH":  # phase 12.2's K6 batch
            with phase12(results) as mesh:
                msvc = mesh_service(program, {"d": edges}, svc, pred,
                                    bits=20)
                mesh[label] = mesh_batches(label, svc, msvc, pred, True,
                                           (("first", srcs),), key, True)
                del msvc
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
        if svc._dense_state(pred).sr.idempotent:  # CPATH has no probed twin
            results["obs_phase"].setdefault("probe", {})[label] = probe_twin(
                label, svc, pred, srcs2, True)
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
    from repro_torch.core import distributed as dist
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
    # phase 12.3: the decomposable plans on MESH_SHARDS shards
    with phase12(results) as mesh:
        g10k = mesh.setdefault("g10k", {})
        g10k["spath_decomposable"] = mesh_plan(
            torch, "G10K spath_decomposable",
            lambda m: dist.spath_decomposable(m, w), MESH_SHARDS,
            "minplus_matmul", lin.table, _fig4)
    phase["APSP linear"]["finite_pairs"] = int(torch.isfinite(lin.table).sum())
    del lin

    # (b) TC through K1
    tc = path("TC", lambda: sn.transitive_closure_dense(adj),
              lambda r: r.iterations, {"bool_matmul": lambda i: i})
    _check_rows("TC", tc.table, sample, Oracle(edges, n, False))
    # phase 12.3 and 12.5: tc_decomposable at every shard count
    with phase12(results) as mesh:
        scale = [mesh_plan(torch, "G10K tc_decomposable",
                           lambda m: dist.tc_decomposable(m, adj), k,
                           "bool_matmul", tc.table, _fig4)
                 for k in SCALE_SHARDS]
        mesh.setdefault("scaleout", {})["g10k_tc"] = scale
        g10k["tc_decomposable"] = scale[SCALE_SHARDS.index(MESH_SHARDS)]
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
    with phase12(results):
        g10k["sg_allreduce"] = mesh_plan(
            torch, "G10K sg_allreduce", lambda m: dist.sg_allreduce(m, adj),
            MESH_SHARDS, None, sg.table,
            lambda it: {"all_gather": 1, "psum": 1 + 2 * it})
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
    with phase12(results) as mesh:
        msp = mesh_service(SPATH, {"darc": wedges}, sp, "dpath", bits=20,
                           sparse=True,
                           tune=autotune.KernelConfig(use_kernel=True))
        mesh["tuned CSR SPATH"] = mesh_batches(
            "tuned CSR SPATH", sp, msp, "dpath", True,
            (("first", srcs), ("second", srcs2)), "csr_minplus_tiled_step",
            True)
        del msp
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
    results["obs_phase"].setdefault("probe", {})["tuned CSR SPATH"] = probe_twin(
        "tuned CSR SPATH", sp, "dpath", srcs2, True)
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
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    probed = {s: eng.ask_dense("tc", (s, None), probe=True)
              for s in picks[:TUPLE_ASK]}
    probed_s = (time.perf_counter() - t0) / TUPLE_ASK
    counted("G10K ask_dense (probed)", ("csr_bool_step",))
    for s, (d, pr) in probed.items():
        reach = int(want_row[s].sum())
        check(np.array_equal(d, dense[s]) and d.dtype == dense[s].dtype,
              f"probed ask_dense tc({s}, X) != ask_dense")
        check(pr.final_facts == reach
              and pr.seed_facts + pr.total_delta == reach,
              f"probed ask_dense tc({s}, X): final {pr.final_facts}, seed "
              f"{pr.seed_facts} + ΣΔ {pr.total_delta}, BFS reach {reach}")
    say(f"G10K ask_dense(probe=True): {len(probed)} answers equal "
        f"ask_dense's, final_facts the BFS reach "
        f"{[p.final_facts for _, p in probed.values()]}, iterations "
        f"{[p.iterations for _, p in probed.values()]}; "
        f"{probed_s * 1e3:.1f} ms a query")
    results["obs_phase"]["ask_dense_probed_ms"] = probed_s * 1e3
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

    # (7) Example 6, the effective diameter, on G10K (phase 10.4)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = Engine(HOPS, db={"arc": edges}, caps={"hops": TUPLE_CAP},
                 join_cap=TUPLE_JOIN_CAP, device=DEVICE).run()
    torch.cuda.synchronize()
    hops_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counted("G10K hops", ())
    _, hop_vals = eng.query_agg("hops")
    hist = dict(zip(*(v.tolist() for v in np.unique(hop_vals,
                                                    return_counts=True))))
    want_hist = {k + 1: p for k, (p, _) in enumerate(per)}
    check(hist == want_hist, f"G10K hops histogram {hist}, the K1 hop "
          f"layers {want_hist}")
    total, cov = sum(hist.values()), 0
    for diameter in sorted(hist):
        cov += hist[diameter]
        if cov >= 0.9 * total:
            break
    say(f"G10K effective diameter (Example 6): {diameter} hops (90% of "
        f"{total} pairs); hops histogram the K1 hop layers'; {hops_s:.2f} s, "
        f"peak {peak / 2 ** 30:.2f} GiB")
    results["obs_phase"]["diameter"] = {"hops": hist, "diameter": diameter,
                                        "seconds": hops_s, "peak_bytes": peak}
    del eng, hop_vals
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
KERNEL_CLASSES = (("K9-bwd", ("flash_bwd",)), ("K10-bwd", ("rglru_bwd",)),
                  ("K9", ("flash_kernel",)), ("K10", ("rglru_scan",)),
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


# -- phase 13: the LM training path --------------------------------------------

#: the training steps (module docstring, phase 13): RecurrentGemma-2B at its
#: published widths and depth, ``train_4k``'s sequence length, a global batch
#: cut from ``train_4k``'s 256 to fit one card, one sequence a microbatch
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 4096, 2, 2, 3
#: step 1's loss against ``model.loss`` on the same microbatches under
#: ``no_grad``: the same kernels on the same inputs (remat recomputes in the
#: backward only, and K9's log-sum-exp does not change its output), so equal
#: up to the mean's f32 rounding
TRAIN_LOSS_RTOL = 1e-6
#: K9-bwd against its plain version: the same f32 arithmetic, with the
#: dot products, the row sums D and the dK/dV/dQ sums (up to 40,960 terms:
#: sq x rep at 4096 x 10) taken in other orders: |got - want| <= K9_BWD_TOL
#: * max(floor, max|want|) per output, plus (bf16 outputs) one bf16 rounding
#: step, 2^-7 * |want|.  The floor is 1 on K9's ragged grid, whose random
#: inputs give gradients of order 1 (and at sq = 1 gradients of dq and dk
#: that are rounding noise around 0), and 0 where the values are a training
#: step's (dO of a mean over 4,096 tokens: gradients near 1e-5) and at the
#: path's tiling (:data:`K9_BWD_PATH_SEQ`)
K9_BWD_TOL = 1e-4
#: K9-bwd also at the training path's tiling: b 1, 10 query heads on one kv
#: head, head dim 256, 4,096 queries, with window 2048 (key tiles from past
#: 0, query tiles skipped a key tile) or none, causal or not, softcap or
#: not, bf16 and f32, held with no floor
K9_BWD_PATH_SEQ, K9_BWD_PATH_WINDOWS = 4096, (2048, None)
#: ``ops.flash`` and ``ops.rglru`` differentiated on the card against
#: ``torch.autograd`` of the plain forwards (f32): within AUTOGRAD_TOL *
#: max(1, max|want|)
AUTOGRAD_TOL = 1e-4
#: phase 13c: ``examples/train_lm_torch.py``'s demo model through the driver
DRIVER_STEPS, DRIVER_FAIL, DRIVER_CKPT_EVERY = 40, 20, 8


def flash_bwd_err(torch, got, want, floor: float = 1.0) -> float:
    """K9-bwd's outputs against its plain version's within
    :data:`K9_BWD_TOL` of ``max(floor, max|want|)`` (and a bf16 rounding
    step): the max abs error."""
    worst = 0.0
    for g, w in zip(got, want):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        gf, wf = g.float(), w.float()
        diff = (gf - wf).abs()
        tol = K9_BWD_TOL * max(floor, float(wf.abs().max()))
        if g.dtype == torch.bfloat16:
            tol = tol + wf.abs() * 2.0 ** -7
        err = float(diff.max()) if diff.numel() else 0.0
        check(bool(torch.isfinite(gf).all()) and bool((diff <= tol).all()),
              f"K9-bwd != plain beyond tolerance (max abs err {err}, "
              f"max |want| {float(wf.abs().max())})")
        worst = max(worst, err)
    return worst


def flash_bwd_tol_ratio(torch, got, want) -> float:
    """The largest |got - want| over :func:`flash_bwd_err`'s tolerance with
    no floor (at most 1 where that check holds)."""
    worst = 0.0
    for g, w in zip(got, want):
        gf, wf = g.float(), w.float()
        tol = K9_BWD_TOL * wf.abs().max() + (
            wf.abs() * 2.0 ** -7 if g.dtype == torch.bfloat16 else 0.0)
        worst = max(worst, float(((gf - wf).abs() / torch.clamp(
            tol, min=torch.finfo(torch.float32).tiny)).max()))
    return worst


def k9_bwd_ragged_parity():
    """K9-bwd against its plain version at every case of K9's ragged grid
    and at the path's tiling (the plain forward's o and lse as its inputs),
    each call checked to launch K9-bwd once; and K9's own lse
    (``return_lse``) against the plain one on each route."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 18)
    t0 = time.perf_counter()
    cases, worst, lse_worst = 0, {torch.float32: 0.0, torch.bfloat16: 0.0}, 0.0
    grid = [(s, 1 if s > 1024 else 2, rep, d, K9_WINDOWS, 1.0)
            for s in K9_SEQS for rep in K9_REPS for d in K9_DIMS]
    grid.append((K9_BWD_PATH_SEQ, 1, 10, 256, K9_BWD_PATH_WINDOWS, 0.0))
    for s, b, rep, d, windows, floor in grid:
        hkv = 1 if rep == 10 else 2
        for dtype in (torch.float32, torch.bfloat16):
            counter = fa.ROUTES[dtype][1]
            q, k, v, do = (torch.randn((b, h, s, d), generator=gen,
                                       device=DEVICE).to(dtype)
                           for h in (hkv * rep, hkv, hkv, hkv * rep))
            for causal, window in itertools.product((True, False), windows):
                for cap in K9_SOFTCAPS:
                    kw = dict(causal=causal, window=window, softcap=cap,
                              scale=None if cap is None else 0.1)
                    o, lse = fa.plain(q, k, v, return_lse=True, **kw)
                    got = _counted(fa.BWD_ROUTES[dtype],
                                   lambda: fa.flash_attention_bwd(
                                       q, k, v, o, lse, do, **kw))
                    err = flash_bwd_err(torch, got, fa.plain_bwd(
                        q, k, v, o, lse, do, **kw), floor)
                    worst[dtype] = max(worst[dtype], err)
                    del got
                    _, klse = _counted(counter, lambda: (
                        fa.flash_attention(q, k, v, return_lse=True, **kw)))
                    dl = (klse - lse).abs()
                    check(bool((dl <= K9_ATOL * torch.clamp(
                        lse.abs(), min=1.0)).all()),
                          f"K9 lse != plain (max {float(dl.max())})")
                    lse_worst = max(lse_worst, float(dl.max()))
                    cases += 1
    torch.cuda.synchronize()
    say(f"parity (K9-bwd, ragged): {cases} cases within tolerance (K9's "
        f"grid and the path's tiling, seq {K9_BWD_PATH_SEQ} x windows "
        f"{list(K9_BWD_PATH_WINDOWS)} at GQA 10, head dim 256, no floor; "
        f"{cases // 2} f32, {cases // 2} bf16); max abs err f32 "
        f"{worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e}; K9's "
        f"lse on both routes within K9_ATOL (max abs err {lse_worst:.3e}) "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"cases": cases, "max_abs_err_f32": worst[torch.float32],
            "max_abs_err_bf16": worst[torch.bfloat16],
            "lse_max_abs_err": lse_worst}


def k10_bwd_ragged_parity():
    """K10-bwd against its plain version, exactly, at K10's ragged cases
    (:func:`k10_ragged_parity`'s shapes, the misaligned copies too), each
    launch awaited by :func:`_watchdog`."""
    import torch
    from repro_torch.kernels import rglru_scan as rg
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
    seqs = (1, rg.T - 1, rg.T, rg.T + 1, 2 * rg.T + 1, 4 * rg.T + 1,
            K10_LONG)
    t0 = time.perf_counter()
    cases = 0
    for b in K10_BATCHES:
        for s in seqs:
            for w in K10_WIDTHS:
                a = 0.5 + 0.49 * torch.rand((b, s, w), generator=gen,
                                            device=DEVICE)
                h, dh = (torch.randn((b, s, w), generator=gen, device=DEVICE)
                         for _ in range(2))
                triples = [(a, h, dh)]
                if w % 4 == 0 and b == K10_BATCHES[-1] and s == seqs[-2]:
                    triples.append(tuple(_misaligned(torch, t)
                                         for t in (a, h, dh)))
                for ta, th, tdh in triples:
                    got = _counted("rglru_scan_bwd",
                                   lambda: rg.rglru_scan_bwd(ta, th, tdh))
                    _watchdog(torch, f"K10-bwd at {(b, s, w)}",
                              K10_WATCHDOG_S)
                    for x, y in zip(got, rg.plain_bwd(ta, th, tdh)):
                        equal_and_err(torch, x, y)
                    cases += 1
    say(f"parity (K10-bwd, ragged): {cases} cases exactly equal to plain "
        f"(B {list(K10_BATCHES)}, S {list(seqs)}, W {list(K10_WIDTHS)}, "
        f"the multiples of 4 also off a 16-byte boundary) "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"cases": cases}


def autograd_parity():
    """``ops.flash`` and ``ops.rglru`` differentiated on the card (K9 then
    K9-bwd; K10 then K10-bwd, each launched once) against ``torch.autograd``
    of the plain forwards, in f32, within :data:`AUTOGRAD_TOL`."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rg
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    out = {}
    q, k, v, do = (torch.randn(shape, generator=gen, device=DEVICE)
                   for shape in ((2, 4, 130, 64), (2, 2, 130, 64),
                                 (2, 2, 130, 64), (2, 4, 130, 64)))
    a = 0.5 + 0.49 * torch.rand((2, 130, 40), generator=gen, device=DEVICE)
    x, dh = (torch.randn((2, 130, 40), generator=gen, device=DEVICE)
             for _ in range(2))
    kw = dict(causal=True, window=64, softcap=30.0)
    runs = (("K9", lambda *t: ops.flash(*t, **kw),
             lambda *t: fa.plain(*t, **kw), (q, k, v), do,
             {"flash_attention_f32": 1, "flash_attention_bwd_f32": 1}),
            ("K10", ops.rglru, rg.plain, (a, x), dh,
             {"rglru_scan": 1, "rglru_scan_bwd": 1}))
    for label, fn, plain_fn, inputs, grad_out, want_launches in runs:
        leaves = [t.clone().requires_grad_() for t in inputs]
        before = ops.launch_counts()
        got = torch.autograd.grad(fn(*leaves), leaves, grad_out)
        after = ops.launch_counts()
        moved = {c: after[c] - before[c] for c in after
                 if after[c] != before[c]}
        check(moved == want_launches,
              f"{label} autograd launched {moved}, want {want_launches}")
        plain_leaves = [t.clone().requires_grad_() for t in inputs]
        want = torch.autograd.grad(plain_fn(*plain_leaves), plain_leaves,
                                   grad_out)
        err = 0.0
        for g, w in zip(got, want):
            e = float((g - w).abs().max())
            check(e <= AUTOGRAD_TOL * max(1.0, float(w.abs().max())),
                  f"{label} autograd on the card != plain autograd ({e})")
            err = max(err, e)
        out[label] = err
    say(f"autograd on the card (ops.flash: K9 + K9-bwd at (2, 4, 130, 64) "
        f"GQA 2, window 64, softcap 30; ops.rglru: K10 + K10-bwd at (2, 130, "
        f"40)) against torch.autograd of the plain forwards: max abs err "
        f"K9 {out['K9']:.3e}, K10 {out['K10']:.3e}")
    return out


def _k9_bwd_bound(torch, args, kw):
    """K9-bwd's bound: 10·d flops a live (query, key) pair of every (batch,
    q head) (S, dP, dV, dQ, dK: 2.5x the forward's 4·d) over the peak of
    the inputs' type, against q, k, v, o, dO, lse read and dq, dk, dv
    written once."""
    q, k, v, o, lse, do = args
    (_, _), live, ok = _k9_bound(torch, q, k, v, kw)
    b, hq, _, d = q.shape
    bytes_ = (3 * q.numel() + 4 * k.numel() + o.numel()) * \
        q.element_size() + 4 * lse.numel()
    rate = BF16_OPS_S if q.dtype == torch.bfloat16 else F32_OPS_S
    return _bound(bytes_, 10 * b * hq * d * live, rate), live, ok


def _k9_bwd_at_path(torch, args, kw):
    """K9-bwd at a training step's captured inputs: held to its plain
    version with no floor (the gradients are near 1e-5), timed beside it,
    its bound, its f32 route (the CUDA-core kernels) on f32 copies of the
    same inputs, and the backward of ``scaled_dot_product_attention`` (kv
    heads repeated, a boolean mask) on the same tensors (timed only).  Also
    what one bf16 rounding of P and dS would cost in accuracy (the plain
    backward so rounded, ``operand_dtype``), as a ratio to the tolerance."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v, o, lse, do = args
    got = _counted(fa.BWD_ROUTES[q.dtype],
                   lambda: fa.flash_attention_bwd(*args, **kw))
    want = fa.plain_bwd(*args, **kw)
    err = flash_bwd_err(torch, got, want, floor=0.0)
    ratio = flash_bwd_tol_ratio(torch, got, want)
    scales = [float(w.float().abs().max()) for w in want]
    one_rounding = flash_bwd_tol_ratio(torch, ref.flash_attention_bwd_ref(
        *args, **kw, operand_dtype=torch.bfloat16), want)
    del got, want
    (bound_ms, bound_by), live, ok = _k9_bwd_bound(torch, args, kw)
    ms = time_ms(torch, lambda: fa.flash_attention_bwd(*args, **kw), 3)
    plain_ms = time_ms(torch, lambda: fa.plain_bwd(*args, **kw), 1)
    f32 = [t.float() for t in args]
    f32_ms = time_ms(torch, lambda: fa.flash_attention_bwd(*f32, **kw), 2)
    del f32
    rep = q.shape[1] // k.shape[1]
    qx, kx, vx = (t.detach().clone().requires_grad_() for t in (
        q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)))
    ox = F.scaled_dot_product_attention(qx, kx, vx, attn_mask=ok,
                                        scale=kw.get("scale"))
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        ox, (qx, kx, vx), do, retain_graph=True), 3)
    del ox, qx, kx, vx
    say(f"flash_attention_bwd (K9-bwd, route {fa.BWD_ROUTES[q.dtype]}): "
        f"{ms:.3f} ms (f32 route on f32 copies {f32_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, sdpa backward {lib_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by}; {live} live pairs a head) at q "
        f"{tuple(q.shape)} {q.dtype}, kv {tuple(k.shape)}, {kw}; max abs err "
        f"{err:.3e} (max |dq|, |dk|, |dv| {scales[0]:.3e}, {scales[1]:.3e}, "
        f"{scales[2]:.3e}; err / tolerance {ratio:.3f}); one bf16 rounding "
        f"of P and dS (emulated) would reach {one_rounding:.3f} x the "
        f"tolerance")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "f32_route_ms": f32_ms, "tol_ratio": ratio,
            "grad_scales": scales, "one_rounding_tol_ratio": one_rounding}


def _k10_bwd_at_path(torch, args):
    """K10-bwd at a training step's captured inputs: exactly its plain
    version, timed beside it and its bound (a, h, dh read, da, db written:
    20 bytes and 3 operations a channel-step)."""
    from repro_torch.kernels import rglru_scan as rg
    got = _counted("rglru_scan_bwd", lambda: rg.rglru_scan_bwd(*args))
    err = max(equal_and_err(torch, x, y)
              for x, y in zip(got, rg.plain_bwd(*args)))
    del got
    n = args[0].numel()
    bound_ms, bound_by = _bound(20 * n, 3 * n, F32_OPS_S)
    ms = time_ms(torch, lambda: rg.rglru_scan_bwd(*args), 10)
    plain_ms = time_ms(torch, lambda: rg.plain_bwd(*args), 1)
    say(f"rglru_scan_bwd (K10-bwd): {ms:.3f} ms (plain {plain_ms:.3f} ms, "
        f"library n/a, bound {bound_ms:.4f} ms by {bound_by}) at "
        f"{tuple(args[0].shape)}; max abs err {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


#: a training step's launches, per microbatch: the forward and remat's
#: recompute run each group's blocks twice, the tail once, the backward
#: every block once
def _step_launches(model) -> dict:
    cfg = model.cfg
    g_local = cfg.pattern.count("local") * cfg.n_groups
    g_rg = cfg.pattern.count("rg") * cfg.n_groups
    t_rg = cfg.tail.count("rg")
    return {"flash_attention": TRAIN_ACCUM * 2 * g_local,
            "flash_attention_bwd": TRAIN_ACCUM * g_local,
            "rglru_scan": TRAIN_ACCUM * (2 * g_rg + t_rg),
            "rglru_scan_bwd": TRAIN_ACCUM * (g_rg + t_rg)}


def train_steps(results):
    """Phase 13b: full-width RecurrentGemma-2B train steps on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.train import (AdamWConfig, adamw_update, init_optimizer,
                                   make_train_step)
    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    model = Model(cfg, remat=True, device=DEVICE).init(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS)
    opt_state = init_optimizer(model)
    step = make_train_step(model, opt_cfg, accum_steps=TRAIN_ACCUM)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, seed=SEED)
    torch.cuda.synchronize()
    say(f"phase 13b: {LM_ARCH} ({len(model.layers)} layers, "
        f"{sum(p.numel() for p in model.parameters())} parameters) and its "
        f"AdamW state on the card in {time.perf_counter() - t0:.1f} s; "
        f"sequence {TRAIN_SEQ}, global batch {TRAIN_BATCH} in {TRAIN_ACCUM} "
        f"microbatches, remat")

    # step 1's loss as model.loss computes it, before the step
    batch0 = pipe.batch(0)
    mb = TRAIN_BATCH // TRAIN_ACCUM
    with torch.no_grad():
        ref_loss = float(torch.stack([model.loss(
            {k: torch.as_tensor(v[i * mb:(i + 1) * mb], device=DEVICE)
             for k, v in batch0.items()}) for i in range(TRAIN_ACCUM)]).mean())
    want = _step_launches(model)
    captured = {}
    flash_bwd, rglru_bwd = ops.flash_attention_bwd, ops.rglru_scan_bwd
    steps = []
    for i in range(TRAIN_STEPS):
        batch = pipe.batch(i)
        if i == 1:  # a steady step: its first K9-bwd and K10-bwd inputs
            ops.flash_attention_bwd = _spy(captured, "flash_bwd", flash_bwd)
            ops.rglru_scan_bwd = _spy(captured, "rglru_bwd", rglru_bwd)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        try:
            opt_state, met = step(opt_state, batch)
            loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            torch.cuda.synchronize()
        finally:
            ops.flash_attention_bwd, ops.rglru_scan_bwd = flash_bwd, rglru_bwd
        secs = time.perf_counter() - t1
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(np.isfinite(loss) and np.isfinite(gnorm),
              f"train step {i + 1}: loss {loss}, grad norm {gnorm}")
        check(counts == want, f"train step {i + 1} launched {counts}, want "
              f"{want}")
        steps.append({"loss": loss, "grad_norm": gnorm, "seconds": secs,
                      "peak_gib": peak, "step": int(met["step"])})
        say(f"train step {i + 1}: loss {loss:.4f}, grad norm {gnorm:.4f}, "
            f"{secs:.3f} s synced ({TRAIN_BATCH * TRAIN_SEQ / secs:.0f} "
            f"tokens/s), peak {peak:.2f} GiB; launches {counts}")
    err = abs(steps[0]["loss"] - ref_loss)
    check(err <= TRAIN_LOSS_RTOL * abs(ref_loss),
          f"step 1's loss {steps[0]['loss']} != model.loss {ref_loss}")
    steady = [s["seconds"] for s in steps[1:]]
    phase = {"steps": steps, "ref_loss": ref_loss, "ref_loss_err": err,
             "launches_per_step": want,
             "step_s": float(np.mean(steady)),
             "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / float(np.mean(steady)),
             "peak_gib": max(s["peak_gib"] for s in steps)}
    say(f"train steps: step 1's loss {steps[0]['loss']:.6f} against "
        f"model.loss {ref_loss:.6f} (|d| {err:.2e}); steps 2-{TRAIN_STEPS} "
        f"{phase['step_s']:.3f} s each ({phase['tokens_per_s']:.0f} "
        f"tokens/s), peak {phase['peak_gib']:.2f} GiB")

    # one step profiled; the optimizer alone on gradients of the same shapes
    phase["step_breakdown"] = profile_breakdown(
        torch, "train step", lambda: step(opt_state, pipe.batch(TRAIN_STEPS)))
    params = dict(model.named_parameters())
    grads = {k: torch.full_like(p, 1e-3) for k, p in params.items()}
    phase["optimizer_breakdown"] = profile_breakdown(
        torch, "adamw_update alone",
        lambda: adamw_update(opt_cfg, params, grads, opt_state))
    del grads, params
    br, opt_br = phase["step_breakdown"], phase["optimizer_breakdown"]
    if br is not None and opt_br is not None:
        cls = dict(br["classes_ms"])
        cls["optimizer"] = opt_br["device_ms"]
        cls["other"] = max(0.0, cls.get("other", 0.0) - opt_br["device_ms"])
        phase["classes_ms"] = cls
        say("train step device ms by class (the optimizer's from "
            "adamw_update profiled alone, taken out of 'other'): "
            + ", ".join(f"{c} {ms:.2f}" for c, ms in sorted(
                cls.items(), key=lambda kv: -kv[1]))
            + f"; idle share {br['idle_share']:.3f}")

    # the backward kernels at the captured inputs
    # (the saved tensors a backward receives are its graph's; detached)
    (args, kw) = captured["flash_bwd"]
    results["flash_attention_bwd"] = {
        "launches": want["flash_attention_bwd"],
        **_k9_bwd_at_path(torch, tuple(t.detach() for t in args), kw)}
    (args, _) = captured["rglru_bwd"]
    results["rglru_scan_bwd"] = {
        "launches": want["rglru_scan_bwd"],
        **_k10_bwd_at_path(torch, tuple(t.detach() for t in args))}
    del captured, args, model, opt_state, step
    torch.cuda.empty_cache()
    phase["seconds"] = time.perf_counter() - t0
    return phase


def _demo_model(torch, device):
    """``examples/train_lm_torch.py``'s demo model, its pipeline and AdamW
    (the example's settings, :data:`DRIVER_STEPS` steps)."""
    import importlib.util
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.model import Model
    from repro_torch.train import AdamWConfig
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    dim, layers, vocab, _, batch, seq = example.PRESETS["demo"]
    cfg = example.make_config(dim, layers, vocab)
    model = Model(cfg, tp=1, use_chunked_attn=False, remat=False,
                  device=device)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                         seed=17)
    opt = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=DRIVER_STEPS)
    return model, pipe, opt


def _kernel_names(torch, fn) -> set:
    """The names of the device kernels one call of ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def driver_phase(tmp: Path) -> dict:
    """Phase 13c: the demo model through ``TrainDriver`` with and without
    an injected failure, bit for bit; deterministic mode's kernels; the
    training CLI."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.runtime import (DriverConfig, TrainDriver,
                                     run_with_restarts)
    from repro_torch.runtime.driver import deterministic_algorithms
    from repro_torch.train import init_optimizer, make_train_step
    t0 = time.perf_counter()
    model, pipe, opt = _demo_model(torch, DEVICE)

    def config(name, fail=()):
        return DriverConfig(ckpt_dir=str(tmp / name),
                            ckpt_every=DRIVER_CKPT_EVERY,
                            max_steps=DRIVER_STEPS, fail_at_steps=fail,
                            log_every=10 ** 9)

    ops.reset_launch_counts()
    t1 = time.perf_counter()
    a = TrainDriver(model, opt, pipe, config("a"), seed=SEED)
    log_a = a.run(DRIVER_STEPS)
    secs_a = time.perf_counter() - t1
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    n_attn = len(model.layers)
    check(counts == {"flash_attention": DRIVER_STEPS * n_attn,
                     "flash_attention_bwd": DRIVER_STEPS * n_attn},
          f"driver run launched {counts}")
    want = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    want_m = {k: v.cpu().clone() for k, v in a.opt_state["m"].items()}
    b = run_with_restarts(lambda: TrainDriver(
        model, opt, pipe, config("b", (DRIVER_FAIL,)), seed=SEED),
        DRIVER_STEPS)
    same = (b.step == DRIVER_STEPS
            and all(torch.equal(v.cpu(), want[k])
                    for k, v in model.state_dict().items())
            and all(torch.equal(v.cpu(), want_m[k])
                    for k, v in b.opt_state["m"].items()))
    resumed_from = DRIVER_FAIL - DRIVER_FAIL % DRIVER_CKPT_EVERY
    losses_same = [r["loss"] for r in b.metrics_log] == [
        r["loss"] for r in log_a[resumed_from:]]
    check(same and losses_same, "the resumed driver run is not bit-identical "
          "to the uninterrupted one")
    first, last = log_a[0]["loss"], log_a[-1]["loss"]
    check(last < first, f"the demo loss did not fall ({first} -> {last})")
    say(f"phase 13c: demo model ({sum(p.numel() for p in model.parameters())}"
        f" parameters) through TrainDriver, {DRIVER_STEPS} steps in "
        f"{secs_a:.1f} s (launches {counts}): loss {first:.4f} -> "
        f"{last:.4f}; failure at step {DRIVER_FAIL}, resumed from step "
        f"{resumed_from}: parameters, moments and losses bit-identical to the "
        f"uninterrupted run (deterministic mode)")

    # what deterministic mode changes: one demo step's kernels, off and on
    step = make_train_step(model, opt)
    state = init_optimizer(model)
    names = {}
    for mode in (False, True):
        with deterministic_algorithms(mode):
            step(state, pipe.batch(0))  # warm
            names[mode] = _kernel_names(torch,
                                        lambda: step(state, pipe.batch(1)))
    changed = {"only_deterministic": sorted(names[True] - names[False]),
               "only_default": sorted(names[False] - names[True])}
    say("deterministic mode, one demo step's kernels: only with it "
        f"{[n[:100] for n in changed['only_deterministic']]}; only without "
        f"{[n[:100] for n in changed['only_default']]}")
    del model, a, b, step, state

    # the training CLI, once
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t1 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         LM_ARCH, "--smoke", "--steps", "3", "--ckpt-dir", str(tmp / "cli"),
         "--device", DEVICE],
        capture_output=True, text=True, env=env, timeout=300)
    check(cli.returncode == 0 and "finished at step 3" in cli.stdout,
          f"launch.train: rc {cli.returncode}: {cli.stdout[-500:]} "
          f"{cli.stderr[-2000:]}")
    cli_s = time.perf_counter() - t1
    say(f"python -m repro_torch.launch.train --arch {LM_ARCH} --smoke "
        f"--steps 3: {cli.stdout.strip().splitlines()[-1]} ({cli_s:.1f} s)")
    return {"demo_seconds": secs_a, "first_loss": first, "last_loss": last,
            "launches": counts, "resumed_from": resumed_from,
            "bit_identical": True, "deterministic_kernels": changed,
            "cli_seconds": cli_s, "seconds": time.perf_counter() - t0}


#: the cuBLAS workspace setting of deterministic mode
#: (``repro_torch.runtime.driver.CUBLAS_DETERMINISTIC``)
CUBLAS_DETERMINISTIC = ":4096:8"


def _driver_phase_in_child(tmp: Path) -> dict:
    """:func:`driver_phase` in a process of its own whose environment holds
    ``CUBLAS_WORKSPACE_CONFIG`` from the start, as the training entry
    points set it: PyTorch reads it at its first GEMM, so in this process,
    which ran phases 1-13b without it, setting it would only quiet
    PyTorch's check; and set from the start here it would slow the
    serving path's host (phase 8's decode, PERF.md)."""
    out = tmp / "driver_phase.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_DETERMINISTIC)
    code = ("import json; from pathlib import Path; import chip_smoke as cs; "
            f"r = cs.driver_phase(Path({str(tmp)!r})); "
            f"Path({str(out)!r}).write_text(json.dumps(r, default=str))")
    rc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                        timeout=600).returncode
    check(rc == 0, f"phase 13c's process exited with {rc}")
    return json.loads(out.read_text())


def train_phase(results):
    """The LM training path (module docstring, phase 13)."""
    import tempfile
    t0 = time.perf_counter()
    phase = {"k9_bwd_parity": k9_bwd_ragged_parity(),
             "k10_bwd_parity": k10_bwd_ragged_parity(),
             "autograd": autograd_parity()}
    phase["train"] = train_steps(results)
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_") as tmp:
        phase["driver"] = _driver_phase_in_child(Path(tmp))
    phase["seconds"] = time.perf_counter() - t0
    say(f"training phase (13): {phase['seconds']:.1f} s")
    results["train_phase"] = phase


# -- phase 10: observability, admission and analytics --------------------------

#: the admission check: submitter threads, sources each, the window, the
#: queries in flight across the fenced append and the arcs it appends
ADM_THREADS, ADM_PER, ADM_WAIT_MS, ADM_BATCH = 8, 32, 2.0, 32
ADM_INFLIGHT, ADM_APPEND = 64, 1000
#: seconds any admission future may take before the run fails
FUTURE_TIMEOUT = 120.0
#: the seven names ``tests/test_obs.py`` requires of ``to_prometheus()``
PROM_NAMES = ("datalog_fixpoints_total", "datalog_cache_hits_total",
              "datalog_batched_queries_total", "datalog_appends_total",
              "datalog_epoch", "datalog_batch_size",
              "datalog_fixpoint_traces_total")
#: a table of UCI Adult's shape (Kohavi 1996): rows and the cardinalities of
#: workclass, education, marital-status, occupation, relationship, race,
#: sex, native-country, age (10 bins) and the income label (last)
ADULT_ROWS = 48_842
ADULT_CARDS = (9, 16, 7, 15, 6, 5, 2, 42, 10, 2)
#: naive Bayes' held-out rows; Example 8's rows (``bits=15``: ids below
#: 2^15); Example 9's node-id and count limit (``bits=12``)
NB_HELD_OUT, EX8_ROWS, EX9_LIMIT = 1000, 32_767, 4096
#: Example 7's degree threshold on phase 5's arcs (about the mean
#: out-degree, 16M / 2^20)
KCORE_DEGREE = 16
KCORE = f"""
degree(X, count<Y>) <- arc(X,Y).
validArc(X,Y) <- arc(X,Y), degree(X,D1), D1 >= {KCORE_DEGREE}, degree(Y,D2),
                 D2 >= {KCORE_DEGREE}.
connComp(A,A) <- validArc(A,B).
connComp(C,min<B>) <- connComp(A,B), validArc(A,C).
kCores(A,B) <- connComp(A,B).
"""
HOPS = """
hops(X,Y,min<H>) <- arc(X,Y), H = 1.
hops(X,Z,min<H>) <- hops(X,Y,H1), arc(Y,Z), H = H1 + 1.
"""


def _same_answer(a, b) -> bool:
    """Bit for bit: the same arrays (dtype, shape, values), pairs for
    aggregate predicates."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
        for x, y in zip(a, b))


def probe_twin(label, svc, pred, srcs, weighted):
    """Phase 10.1: one warm batch of ``srcs`` unprobed, then the same batch
    through the probed twin (``svc.probe``; the cache emptied before each,
    so both run the fixpoint).  The answers and the cached carrier rows
    must be bit for bit the unprobed ones, the probe's ``iterations`` the
    unprobed batch's, ``seed + ΣΔ == final`` for bool, and the kernel
    launch counts (reset before each run, read after) equal."""
    import torch
    from repro_torch.kernels import ops

    qs = [(pred, (s, None, None) if weighted else (s, None)) for s in srcs]
    keys = [svc._cache_key(svc._as_literal(q)) for q in qs]
    runs = {}
    for probe in (False, True):
        svc.cache.clear()
        svc.probe = probe
        svc.last_probes.clear()
        it0 = svc.stats.fixpoint_iterations
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers = svc.ask_batch(qs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        runs[probe] = (answers, [svc.cache.peek(k).raw for k in keys], ms,
                       ops.launch_counts(),
                       svc.stats.fixpoint_iterations - it0,
                       list(svc.last_probes))
    svc.probe = False
    (plain, plain_raw, plain_ms, plain_counts, iters, _), \
        (got, raw, ms, counts, piters, probes) = runs[False], runs[True]
    check(all(_same_answer(a, b) for a, b in zip(got, plain)),
          f"{label}: a probed answer differs from the unprobed one")
    check(all(np.array_equal(a, b) for a, b in zip(raw, plain_raw)),
          f"{label}: a probed carrier row differs from the unprobed one")
    check(len(probes) == 1, f"{label}: {len(probes)} probes recorded")
    pr = probes[0]
    check(pr.iterations == iters == piters,
          f"{label}: probe iterations {pr.iterations}, unprobed {iters}")
    if not weighted:
        check(pr.seed_facts + pr.total_delta == pr.final_facts,
              f"{label}: seed {pr.seed_facts} + ΣΔ {pr.total_delta} != "
              f"final {pr.final_facts}")
    check(counts == plain_counts, f"{label}: probed launches {counts}, "
          f"unprobed {plain_counts}")
    launched = {k: v for k, v in counts.items() if v}
    check(launched, f"{label}: no kernel launched")
    say(f"{label} probed twin: {len(srcs)} answers and rows bit for bit, "
        f"{pr.iterations} iterations, seed {pr.seed_facts} + ΣΔ "
        f"{pr.total_delta} -> final {pr.final_facts}; launches {launched} "
        f"either way; warm batch {ms:.1f} ms probed, {plain_ms:.1f} ms not")
    return {"iterations": pr.iterations, "probed_ms": ms,
            "plain_ms": plain_ms, "launches": launched,
            "seed_facts": pr.seed_facts, "total_delta": pr.total_delta,
            "final_facts": pr.final_facts}


def _nested(spans, inner, outer) -> bool:
    """Every ``inner`` span lies inside an ``outer`` span on its lane."""
    outs = [o for o in spans if o["name"] == outer]
    return all(any(o["tid"] == i["tid"] and o["ts"] <= i["ts"] and
                   i["ts"] + i["dur"] <= o["ts"] + o["dur"] for o in outs)
               for i in spans if i["name"] == inner)


def _warm_qps(torch, svcs, qs, rounds=3):
    """Median warm qps of each service over ``rounds`` interleaved batches
    of ``qs``, the result cache emptied before each."""
    secs = {label: [] for label in svcs}
    for _ in range(rounds):
        for label, svc in svcs.items():
            svc.cache.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc.ask_batch(qs)
            torch.cuda.synchronize()
            secs[label].append(time.perf_counter() - t0)
    return {label: len(qs) / float(np.median(v)) for label, v in secs.items()}


def obs_checks(label, svc, pred, srcs, kernel, program, bits):
    """Phase 10.2 on a ``tracer=True`` TC service: the spans nest as in the
    JAX service, the Chrome export parses, ``to_prometheus()`` holds the
    seven names, ``explain()["kernels"]`` attributes the launches in JAX's
    schema (shares printed, not bounded), and warm qps with ``metrics=False``
    beside the default registry (twins that share this carrier)."""
    import tempfile

    import torch
    from repro_torch.service import DatalogService
    spans = svc.tracer.spans()
    names = {e["name"] for e in spans}
    check({"launch_batch", "fixpoint", "finalize_batch", "device_sync",
           "cache_fill"} <= names, f"{label}: spans {sorted(names)}")
    check(_nested(spans, "fixpoint", "launch_batch")
          and _nested(spans, "cache_fill", "finalize_batch"),
          f"{label}: the spans do not nest as in the JAX service")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        svc.tracer.export_chrome(path)
        with open(path) as f:
            doc = json.load(f)
    check(len(doc["traceEvents"]) == len(svc.tracer.events()),
          f"{label}: the Chrome export lost events")
    text = svc.metrics.to_prometheus()
    missing = [n for n in PROM_NAMES if n not in text]
    check(not missing, f"{label}: to_prometheus() lacks {missing}")
    rep = svc.explain()["kernels"]
    k = rep.get(kernel)
    check(k is not None and k["launches"] >= 1 and k["seconds"] > 0
          and k["dominant"] in ("compute", "memory")
          and k["frac_peak_flops"] >= 0 and k["frac_peak_bw"] >= 0,
          f"{label}: explain()['kernels'][{kernel!r}] = {k}")
    qs = [(pred, (s, None)) for s in srcs]
    twins = {}
    for name, metrics in (("metrics=False", False), ("default registry",
                                                     None)):
        twin = DatalogService(program, db={"arc": np.zeros((1, 2), np.int64)},
                              bits=bits, metrics=metrics)
        twin._dense[pred] = svc._dense_state(pred)  # packed once
        twins[name] = twin
    qps = _warm_qps(torch, twins, qs)
    say(f"{label} observability: {len(spans)} spans nest as in JAX, the "
        f"Chrome export parses, Prometheus holds the {len(PROM_NAMES)} "
        f"names; {kernel}: {k['launches']} launches, {k['iterations']} "
        f"iterations, {k['seconds'] * 1e3:.2f} device ms, frac_peak_flops "
        f"{k['frac_peak_flops']:.4g}, frac_peak_bw {k['frac_peak_bw']:.4g} "
        f"({k['dominant']}); warm qps {qps}")
    return {"spans": len(spans), "kernel": {kernel: k}, "warm_qps": qps}


def admission_check(svc, edges, n, rng, used):
    """Phase 10.3: ``AsyncDatalogService`` over phase 5's CSR TC service."""
    import threading

    from repro_torch.obs import Tracer
    from repro_torch.service import AsyncDatalogService
    picks = [int(s) for s in rng.permutation(n) if int(s) not in used]
    fresh = picks[:ADM_THREADS * ADM_PER]
    groups = [fresh[i * ADM_PER:(i + 1) * ADM_PER] for i in range(ADM_THREADS)]
    t0 = time.perf_counter()
    seq = {}
    for g in groups:
        seq.update(zip(g, svc.ask_batch([("tc", (s, None)) for s in g])))
    seq_s = time.perf_counter() - t0
    svc.cache.clear()  # every async query misses and goes through a flush
    svc.tracer.clear()
    front = AsyncDatalogService(svc, max_wait_ms=ADM_WAIT_MS,
                                max_batch=ADM_BATCH)
    try:
        got, errors = {}, []

        def submitter(g):
            try:
                futs = [(s, front.submit(("tc", (s, None)))) for s in g]
                for s, f in futs:
                    got[s] = f.result(timeout=FUTURE_TIMEOUT)
            except Exception as e:  # noqa: BLE001 - fails the run below
                errors.append(e)

        threads = [threading.Thread(target=submitter, args=(g,))
                   for g in groups]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(FUTURE_TIMEOUT)
        async_s = time.perf_counter() - t0
        check(not errors and not any(t.is_alive() for t in threads),
              f"admission: {errors[:1] or 'a submitter hung'}")
        check(all(_same_answer(got[s], seq[s]) for s in fresh),
              "admission: an async answer differs from the sequential one")
        oracle = Oracle(edges, n, False)
        for s in fresh[:4]:
            oracle.check(s, got[s])
        st = front.stats
        check(st.flushes >= len(fresh) // ADM_BATCH
              and st.max_flush <= ADM_BATCH,
              f"admission: {st.flushes} flushes, largest {st.max_flush}")
        sizes = [e["args"]["batch"] for e in svc.tracer.spans("coalesce")]
        lbs = svc.tracer.spans("launch_batch")
        fbs = svc.tracer.spans("finalize_batch")
        overlaps = sum(any(Tracer.overlaps(f, lb) for lb in lbs) for f in fbs)
        check(overlaps >= 1, "admission: no finalize_batch span overlaps a "
              "launch_batch span")
        wait = svc.metrics.histogram("datalog_queue_wait_seconds")
        pct = wait.percentiles((50, 99))
        say(f"admission: {len(fresh)} queries from {ADM_THREADS} threads in "
            f"{async_s:.2f} s ({len(fresh) / async_s:.1f} qps) against "
            f"{len(groups)} sequential ask_batch calls of {ADM_PER} in "
            f"{seq_s:.2f} s ({len(fresh) / seq_s:.1f} qps); every answer "
            f"the sequential one, 4 scipy's BFS; {st.flushes} flushes, "
            f"sizes {sizes}; {overlaps} finalize spans overlap a launch; "
            f"queue wait p50 {pct['p50'] * 1e3:.2f} ms, p99 "
            f"{pct['p99'] * 1e3:.2f} ms")
        out = {"async_qps": len(fresh) / async_s,
               "sequential_qps": len(fresh) / seq_s, "flushes": st.flushes,
               "flush_sizes": sizes, "overlapping_finalizes": overlaps,
               "queue_wait_p50_s": pct["p50"], "queue_wait_p99_s": pct["p99"]}

        # a fenced append while ADM_INFLIGHT queries are in flight
        inflight = fresh[:ADM_INFLIGHT]
        svc.cache.clear()
        arcs = np.stack([rng.integers(0, n, ADM_APPEND),
                         rng.integers(0, n, ADM_APPEND)], 1)
        futs = [front.submit(("tc", (s, None))) for s in inflight]
        t0 = time.perf_counter()
        front.append("arc", arcs)
        append_s = time.perf_counter() - t0
        during = [f.result(timeout=FUTURE_TIMEOUT) for f in futs]
        after = front.ask_batch([("tc", (s, None)) for s in inflight],
                                timeout=FUTURE_TIMEOUT)
        pre = sum(_same_answer(a, seq[s]) for a, s in zip(during, inflight))
        check(all(_same_answer(a, seq[s]) or _same_answer(a, b)
                  for a, b, s in zip(during, after, inflight)),
              "admission: an answer in flight across the append is neither "
              "epoch's")
        union = Oracle(np.concatenate([edges, arcs]), n, False)
        for s, a in zip(inflight[:4], after):
            union.check(s, a)
        say(f"admission: append of {ADM_APPEND} arcs with {len(inflight)} "
            f"queries in flight in {append_s:.2f} s (epoch {front.epoch}); "
            f"{pre} answered before it, {len(inflight) - pre} after, each "
            "fenced to one epoch; 4 post-append answers scipy's BFS on the "
            "union")
        out.update(append_s=append_s, inflight_pre=pre)
    finally:
        front.close()
    return out


def _adult_table(rng):
    """A seeded table of UCI Adult's shape, as strings per column."""
    cols = [rng.integers(0, k, ADULT_ROWS) for k in ADULT_CARDS]
    codes = np.stack(cols, 1)
    table = [[f"{j}:{v}" for j, v in enumerate(row)] for row in codes.tolist()]
    return table, codes


def _prefix_counts(codes):
    """The numpy trie: {prefix tuple: rows} over every column depth."""
    out = {}
    for d in range(1, codes.shape[1] + 1):
        keys, counts = np.unique(codes[:, :d], axis=0, return_counts=True)
        out.update(zip(map(tuple, keys.tolist()), counts.tolist()))
    return out


def _myrupt_prefixes(myrupt, vt):
    """Each prefix-table node's path of cell values from the root, and its
    count (the renumbered Example 8 rows: id, column, value, count,
    parent)."""
    path, out = {1: ()}, {}
    for r in myrupt[np.argsort(myrupt[:, 1], kind="stable")].tolist():
        tid, _, val, cnt, parent = r
        name = vt.symbols.name(val - 1)
        path[tid] = path[parent] + (int(name.split(":")[1]),)
        out[path[tid]] = cnt
    return out


def _longest_oracle(myrupt, k):
    """Example 9 by hand: the most frequent items on one root-to-node path,
    an item (column, value) frequent when its nodes' counts sum to k."""
    items = {}
    for _, c, v, cnt, _ in myrupt.tolist():
        items[(c, v)] = items.get((c, v), 0) + cnt
    best = {1: 0}
    for tid, c, v, _, parent in myrupt[np.argsort(myrupt[:, 1],
                                                  kind="stable")].tolist():
        best[tid] = best[parent] + (items[(c, v)] >= k)
    return max(best.values())


def analytics_phase(results, csr_edges):
    """Phase 10.4: the §4 analytics and Example 7 at the largest sizes the
    design admits, each against a numpy oracle of its own."""
    import torch
    from repro_torch.analytics import (build_rollup_prefix_table,
                                       longest_maximal_pattern,
                                       naive_bayes_predict, naive_bayes_train,
                                       verticalize)
    from repro_torch.core.engine import Engine
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED + 10)
    phase = {}

    def step(label, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rep = {"seconds": time.perf_counter() - t0,
               "peak_bytes": torch.cuda.max_memory_allocated()}
        launched = {k: v for k, v in ops.launch_counts().items() if v}
        check(not launched, f"{label}: a kernel launched on the tuple path: "
              f"{launched}")
        phase[label] = rep
        return out, rep

    table, codes = _adult_table(rng)
    train, test = codes[:-NB_HELD_OUT], codes[-NB_HELD_OUT:]
    vt = verticalize(table[:-NB_HELD_OUT])
    model, rep = step("naive Bayes", lambda: naive_bayes_train(
        vt, caps=1 << 23, bits=16, device=DEVICE))
    sym = {vt.symbols.name(i): i + 1 for i in range(len(vt.symbols))}
    label_col = len(ADULT_CARDS)
    lab = train[:, -1]
    want_cls = {sym[f"{label_col - 1}:{c}"]: int(k)
                for c, k in zip(*np.unique(lab, return_counts=True))}
    want_feat = {}
    for j in range(label_col - 1):
        keys, counts = np.unique(np.stack([train[:, j], lab], 1), axis=0,
                                 return_counts=True)
        for (v, c), k in zip(keys.tolist(), counts.tolist()):
            want_feat[(j + 1, sym[f"{j}:{v}"],
                       sym[f"{label_col - 1}:{c}"])] = k
    check(model["classes"] == want_cls and model["features"] == want_feat,
          "naive Bayes: the counts differ from numpy's group-by")
    # the oracle's argmax: the same Laplace-smoothed log-likelihoods
    nv, classes = model["n_values"], sorted(want_cls)
    agree = 0
    for row in test.tolist():
        ex = {j + 1: sym[f"{j}:{v}"] for j, v in enumerate(row[:-1])}
        lp = [np.log(want_cls[c] / len(train)) + sum(
            np.log((want_feat.get((col, val, c), 0) + 1) / (want_cls[c] + nv))
            for col, val in ex.items()) for c in classes]
        agree += naive_bayes_predict(model, ex) == classes[int(np.argmax(lp))]
    check(agree == len(test), f"naive Bayes: {len(test) - agree} held-out "
          "predictions differ from the oracle's argmax")
    say(f"naive Bayes (Adult shape: {len(train)} rows x {label_col} "
        f"columns, {len(vt.rows)} vtrain facts, bits=16): counts equal "
        f"numpy's, {len(test)} held-out predictions the oracle's; "
        f"{rep['seconds']:.2f} s, peak {rep['peak_bytes'] / 2 ** 30:.2f} GiB")

    rows8 = codes[:EX8_ROWS]
    vt8 = verticalize(table[:EX8_ROWS])
    (myrupt, _), rep = step("Example 8", lambda: build_rollup_prefix_table(
        vt8, caps=1 << 22, bits=15, device=DEVICE))
    got = _myrupt_prefixes(myrupt, vt8)
    check(got == _prefix_counts(rows8), "Example 8: the prefix counts differ "
          "from the numpy trie")
    say(f"Example 8 (rollup prefix table, {EX8_ROWS} rows x {label_col} "
        f"columns, bits=15): {len(myrupt)} nodes, every count the numpy "
        f"trie's; {rep['seconds']:.2f} s, peak "
        f"{rep['peak_bytes'] / 2 ** 30:.2f} GiB")

    # Example 9: the most rows whose prefix table keeps ids below 2^12
    lo, hi = 1, EX9_LIMIT - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if len(_prefix_counts(codes[:mid])) + 1 < EX9_LIMIT:
            lo = mid
        else:
            hi = mid - 1
    vt9 = verticalize(table[:lo])
    my9, _ = build_rollup_prefix_table(vt9, bits=12, device=DEVICE)
    k9 = max(2, lo // 20)
    got9, rep = step("Example 9", lambda: longest_maximal_pattern(
        my9, k9, bits=12, device=DEVICE))
    want9 = _longest_oracle(my9, k9)
    check(got9 == want9, f"Example 9: {got9}, the oracle {want9}")
    say(f"Example 9 (longest maximal pattern, k={k9}) on the first {lo} rows "
        f"x {label_col} columns ({len(my9)} nodes, ids below {EX9_LIMIT}, "
        f"bits=12): {got9}, the oracle's; {rep['seconds']:.2f} s")

    # Example 7: k-cores on phase 5's power-law arcs
    deg = np.bincount(csr_edges[:, 0], minlength=CSR_N)
    eng, rep = step("Example 7", lambda: Engine(
        KCORE, db={"arc": csr_edges}, bits=20, default_cap=1 << 25,
        join_cap=1 << 30, device=DEVICE).run())
    rows = eng.query("kCores")
    got7 = rows[np.lexsort((rows[:, 1], rows[:, 0]))]
    # the oracle: min-label propagation over the valid arcs on the card
    keep = (deg[csr_edges[:, 0]] >= KCORE_DEGREE) & \
        (deg[csr_edges[:, 1]] >= KCORE_DEGREE)
    src = torch.from_numpy(csr_edges[keep, 0]).to(DEVICE)
    dst = torch.from_numpy(csr_edges[keep, 1]).to(DEVICE)
    big = torch.iinfo(torch.int64).max
    label = torch.full((CSR_N,), big, dtype=torch.int64, device=DEVICE)
    label[src] = src
    while True:
        nxt = label.scatter_reduce(0, dst, label[src], "amin")
        if torch.equal(nxt, label):
            break
        label = nxt
    v = torch.nonzero(label < big).flatten()
    want7 = torch.stack([v, label[v]], 1).cpu().numpy()
    check(np.array_equal(got7.astype(np.int64), want7),
          f"Example 7: {len(got7)} kCores rows, the oracle {len(want7)}")
    say(f"Example 7 (k-cores, degree >= {KCORE_DEGREE}) on {len(csr_edges)} "
        f"arcs ({int(keep.sum())} valid): {len(got7)} members in "
        f"{len(np.unique(want7[:, 1]))} components, the oracle's; "
        f"{rep['seconds']:.2f} s, peak {rep['peak_bytes'] / 2 ** 30:.2f} GiB")
    del eng, rows, src, dst, label
    torch.cuda.empty_cache()
    results["obs_phase"]["analytics"] = phase


# -- phase 11: durability -------------------------------------------------------

#: phase 11's appends to the CSR TC service: a tail before the snapshot
#: (well under a quarter of the spine: no fold) and the WAL suffix after it
DUR_TAIL, DUR_SUFFIX = 10_000, 1_000
#: phase 11's dense SPATH append after its snapshot (the WAL suffix)
DUR_DENSE_SUFFIX = 100
#: phase 11's CLI graph and actions (vertex 10,000 is new: nothing reaches
#: it, so every answer line is the same before and after the append)
DUR_CLI_GRAPH = "gnp:10000:0.001"
DUR_CLI_ACTIONS = ("--query", "tc(0, X)", "--query", "tc(17, X)",
                   "--append", "arc:10000,10001;10001,17", "--query",
                   "tc(10000, X)")
#: WAL appends timed per record size and fsync setting (median)
DUR_WAL_ROUNDS = 5


def _same_answers(label, got, want):
    check(len(got) == len(want), f"{label}: {len(got)} answers, "
          f"{len(want)} wanted")
    for g, w in zip(got, want):
        check(_same_answer(g, w), f"{label}: an answer differs")


def _flip_newest_generation(snap_dir: Path) -> Path:
    """Flip one byte in the middle of the newest published generation's
    first shard: same size, so only the manifest's CRC32 can see it."""
    newest = sorted(p for p in snap_dir.iterdir()
                    if p.name.startswith("step_")
                    and not p.name.endswith(".tmp"))[-1]
    shard = newest / "shard_0.npz"
    with open(shard, "r+b") as f:
        f.seek(shard.stat().st_size // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    return newest


def _dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def _wal_append_ms(torch, tmp: Path, rows: np.ndarray, fsync: bool) -> float:
    """Median ms of one WAL record of ``rows`` (frame, write, flush and,
    with ``fsync``, the fsync)."""
    from repro_torch.service import WriteAheadLog
    wal = WriteAheadLog(tmp / f"probe-{len(rows)}-{fsync}.log", fsync=fsync)
    times = []
    for i in range(DUR_WAL_ROUNDS):
        t0 = time.perf_counter()
        wal.append("arc", rows, i + 1)
        times.append((time.perf_counter() - t0) * 1e3)
    wal.close()
    return float(np.median(times))


def _restart(torch, program, db, d, **kw):
    """A service built on durable directory ``d`` (a restart: recovery
    runs in the constructor), its construction seconds and the launches
    the recovery made."""
    from repro_torch.kernels import ops
    from repro_torch.service import DatalogService
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    svc = DatalogService(program, db=db, durable_dir=d, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return svc, secs, {k: v for k, v in ops.launch_counts().items() if v}


def _load_s(snap_dir: Path, step: int) -> float:
    """Seconds to read one generation back (CRC checks included), the
    first part of a recovery: the restore onto the card and the WAL
    replay follow."""
    from repro_torch.checkpoint import load_checkpoint_raw
    t0 = time.perf_counter()
    load_checkpoint_raw(snap_dir, step=step)
    return time.perf_counter() - t0


def _timed_snapshot(torch, svc, snap_dir: Path) -> dict:
    """``snapshot()`` (the copy to the host under the lock, timed alone),
    then the wait for the background writer to publish it."""
    t0 = time.perf_counter()
    step = svc.snapshot()
    t1 = time.perf_counter()
    svc._durable.wait()
    t2 = time.perf_counter()
    nbytes = _dir_bytes(snap_dir / f"step_{step:08d}")
    return {"step": step, "lock_ms": (t1 - t0) * 1e3,
            "publish_s": t2 - t1, "bytes": nbytes}


def durable_csr(torch, edges, d: Path) -> dict:
    """Phase 11a: durable CSR TC on phase 5's 16M arcs, uncut."""
    from repro_torch.kernels import ops
    n = CSR_N
    rng = np.random.default_rng(SEED + 11)
    picks = rng.permutation(n)[:2 * CSR_BATCH]
    srcs = [int(s) for s in picks[:CSR_BATCH]]
    srcs2 = [int(s) for s in picks[CSR_BATCH:]]
    tail = rng.integers(0, n, (DUR_TAIL, 2)).astype(np.int64)
    suffix = rng.integers(0, n, (DUR_SUFFIX, 2)).astype(np.int64)

    def qs(ss):
        return [("tc", (s, None)) for s in ss]

    torch.cuda.reset_peak_memory_stats()
    svc, build_s, _ = _restart(torch, TC, {"arc": edges}, d, bits=20)
    check(svc.explain()["durability"]["recovery"]["mode"] == "fresh",
          "durable CSR TC: a new directory did not start fresh")
    t0 = time.perf_counter()
    svc.ask_batch(qs(srcs))
    torch.cuda.synchronize()
    cold_s = build_s + time.perf_counter() - t0
    check(svc.explain()["relations"]["tc"]["repr"] == "csr",
          "durable CSR TC: the carrier is not CSR")
    t0 = time.perf_counter()
    svc.append("arc", tail)
    torch.cuda.synchronize()
    tail_s = time.perf_counter() - t0
    snap1 = _timed_snapshot(torch, svc, d / "snapshots")
    t0 = time.perf_counter()
    svc.append("arc", suffix)
    torch.cuda.synchronize()
    suffix_s = time.perf_counter() - t0
    want = svc.ask_batch(qs(srcs))  # the resumed cached closures
    check(svc.stats.appends == 2, "durable CSR TC: appends not counted")
    # a crash: no close(), no final snapshot; the suffix lives in the WAL
    svc2, warm_s, rec_launch = _restart(torch, TC, {"arc": edges}, d, bits=20)
    rep = svc2.explain()["durability"]["recovery"]
    check(rep["mode"] == "warm" and rep["wal_replayed"] == 1,
          f"durable CSR TC: recovery {rep}")
    check(svc2.epoch == svc.epoch, f"durable CSR TC: epoch {svc2.epoch} "
          f"after recovery, {svc.epoch} before")
    check(rec_launch.get("csr_bool_step", 0) > 0, "durable CSR TC: the WAL "
          "replay launched no K3 (the resume of the restored closures)")
    load_s = _load_s(d / "snapshots", snap1["step"])
    ops.reset_launch_counts()
    hits0 = svc2.cache.hits
    got = svc2.ask_batch(qs(srcs))
    repeat_launch = {k: v for k, v in ops.launch_counts().items() if v}
    check(not repeat_launch, "durable CSR TC: the repeat batch after the "
          f"warm restart made launches {repeat_launch}")
    check(svc2.cache.hits - hits0 == len(srcs), "durable CSR TC: the "
          "repeat batch was not all restored-cache hits")
    _same_answers("durable CSR TC warm restart", got, want)
    ops.reset_launch_counts()
    fresh2 = svc2.ask_batch(qs(srcs2))
    serve_launch = ops.launch_counts()["csr_bool_step"]
    check(serve_launch > 0, "durable CSR TC: the recovered service's new "
          "batch launched no K3")
    _same_answers("durable CSR TC new batch", fresh2, svc.ask_batch(qs(srcs2)))
    peak = torch.cuda.max_memory_allocated()
    oracle = Oracle(np.concatenate([edges, tail, suffix]), n, False)
    for s, ans in zip(srcs[:4], got[:4]):
        oracle.check(s, ans)
    del oracle
    say(f"durable CSR TC: 4 restored answers equal the Oracle (BFS over the "
        f"{len(edges) + DUR_TAIL + DUR_SUFFIX} arcs)")
    # a second generation from the recovered service, then the newest
    # generation corrupted: the restart degrades to the first
    snap2 = _timed_snapshot(torch, svc2, d / "snapshots")
    del svc, svc2
    torch.cuda.empty_cache()
    flipped = _flip_newest_generation(d / "snapshots")
    svc3, degraded_s, _ = _restart(torch, TC, {"arc": edges}, d, bits=20)
    rep3 = svc3.explain()["durability"]["recovery"]
    check(rep3["mode"] == "degraded" and rep3["fallbacks"] == 1
          and rep3["snapshot_step"] == snap1["step"],
          f"durable CSR TC: recovery past {flipped.name}: {rep3}")
    ops.reset_launch_counts()
    _same_answers("durable CSR TC degraded restart",
                  svc3.ask_batch(qs(srcs)), want)
    check(not any(ops.launch_counts().values()), "durable CSR TC: the "
          "degraded restart's repeat batch made launches")
    del svc3
    torch.cuda.empty_cache()
    out = {"cold_s": cold_s, "warm_s": warm_s, "degraded_s": degraded_s,
           "warm_recover_s": rep["seconds"], "load_s": load_s,
           "degraded_recover_s": rep3["seconds"],
           "tail_append_s": tail_s, "suffix_append_s": suffix_s,
           "snapshot": snap1, "snapshot_recovered": snap2,
           "recovery_launches": rec_launch, "new_batch_k3": serve_launch,
           "peak_bytes_two_services": peak}
    say(f"durable CSR TC ({len(edges)} arcs): cold start {cold_s:.2f} s "
        f"(construction + first batch of {len(srcs)}, packs the CSR); "
        f"snapshot {snap1['lock_ms']:.1f} ms under the lock, published in "
        f"{snap1['publish_s']:.2f} s, {snap1['bytes'] / 2 ** 20:.1f} MiB; "
        f"warm restart {warm_s:.2f} s (recovery {rep['seconds']:.2f} s, of "
        f"which reading the generation back {load_s:.2f} s; 1 WAL record of "
        f"{DUR_SUFFIX} arcs replayed: {rec_launch}); repeat "
        f"batch all hits, no launch; degraded restart {degraded_s:.2f} s; "
        f"second snapshot {snap2['lock_ms']:.1f} ms / "
        f"{snap2['publish_s']:.2f} s; peak device memory with both services "
        f"{peak / 2 ** 30:.2f} GiB")
    return out


def durable_dense(torch, d: Path) -> dict:
    """Phase 11b: one warm restart of a durable dense SPATH service on
    phase 4's Gn-p graph: the ``rel/i/matrix`` route and min-plus rows."""
    from repro_torch.data import gnp_graph
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED + 12)
    n = DENSE_N
    wedges = _weighted(rng, gnp_graph(n, DENSE_P, seed=SEED))
    srcs = [int(s) for s in rng.permutation(n)[:CSR_BATCH]]
    suffix = np.concatenate([rng.integers(0, n, (DUR_DENSE_SUFFIX, 2)),
                             rng.integers(1, 10, (DUR_DENSE_SUFFIX, 1))], 1)
    qs = [("dpath", (s, None, None)) for s in srcs]
    svc, build_s, _ = _restart(torch, SPATH, {"darc": wedges}, d)
    t0 = time.perf_counter()
    svc.ask_batch(qs)
    torch.cuda.synchronize()
    cold_s = build_s + time.perf_counter() - t0
    check(svc.explain()["relations"]["dpath"]["repr"] == "dense",
          "durable dense SPATH: the carrier is not dense")
    snap = _timed_snapshot(torch, svc, d / "snapshots")
    svc.append("darc", suffix)
    want = svc.ask_batch(qs)
    svc2, warm_s, rec_launch = _restart(torch, SPATH, {"darc": wedges}, d)
    rep = svc2.explain()["durability"]["recovery"]
    check(rep["mode"] == "warm" and rep["wal_replayed"] == 1
          and svc2.epoch == svc.epoch, f"durable dense SPATH: recovery {rep}")
    check(rec_launch.get("minplus_matmul", 0) > 0, "durable dense SPATH: "
          "the WAL replay launched no K2")
    load_s = _load_s(d / "snapshots", snap["step"])
    ops.reset_launch_counts()
    got = svc2.ask_batch(qs)
    check(not any(ops.launch_counts().values()), "durable dense SPATH: the "
          "repeat batch after the warm restart made launches")
    _same_answers("durable dense SPATH warm restart", got, want)
    oracle = Oracle(np.concatenate([wedges, suffix]), n, True)
    for s, ans in zip(srcs[:4], got[:4]):
        oracle.check(s, ans)
    del svc, svc2, oracle
    torch.cuda.empty_cache()
    say(f"durable dense SPATH ({len(wedges)} arcs): cold start {cold_s:.2f} "
        f"s, snapshot {snap['lock_ms']:.1f} ms under the lock / "
        f"{snap['publish_s']:.2f} s / {snap['bytes'] / 2 ** 20:.1f} MiB, "
        f"warm restart {warm_s:.2f} s (recovery {rep['seconds']:.2f} s, of "
        f"which reading the generation back {load_s:.2f} s; {rec_launch}); "
        f"4 restored answers equal the Oracle (Dijkstra)")
    return {"cold_s": cold_s, "warm_s": warm_s, "load_s": load_s,
            "warm_recover_s": rep["seconds"], "snapshot": snap,
            "recovery_launches": rec_launch}


def _cli_run(d: Path) -> tuple[list[str], dict]:
    """One ``python -m repro_torch.service.serve --durable d`` run: its
    answer and append lines and its ``--stats`` report."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.service.serve", "--synthetic",
         DUR_CLI_GRAPH, "--durable", str(d), *DUR_CLI_ACTIONS, "--stats",
         "--device", DEVICE], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    check(proc.returncode == 0, f"serve CLI exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    out = proc.stdout
    start = out.index("\n{")
    stats = json.loads(out[start:])
    stats["wall_s"] = time.perf_counter() - t0
    return out[:start].splitlines(), stats


def durable_cli(d: Path) -> dict:
    """Phase 11c: the serving CLI run twice on one durable directory, and
    the serving example once."""
    lines1, st1 = _cli_run(d)
    lines2, st2 = _cli_run(d)
    r1, r2 = (st["durability"]["recovery"] for st in (st1, st2))
    check(r1["mode"] == "fresh" and r2["mode"] == "warm",
          f"serve CLI: recoveries {r1['mode']}, {r2['mode']}")
    answers1, answers2 = ([x for x in lines if not x.startswith("appended")]
                          for lines in (lines1, lines2))
    check(answers1 == answers2 and any(x.endswith("rows]") for x in answers1),
          "serve CLI: the second run's answer lines differ")
    check(st2["epoch"] == 2 * st1["epoch"] == 2, "serve CLI: the second run "
          f"ended at epoch {st2['epoch']}, not 2")
    check(st2["relations"]["tc"]["repr"] == "csr", "serve CLI: not CSR")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    ex = subprocess.run([sys.executable, str(ROOT / "examples" /
                                             "serve_quickstart_torch.py"),
                         "--device", DEVICE], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=600)
    check(ex.returncode == 0, f"serve_quickstart_torch.py exited "
          f"{ex.returncode}: {ex.stderr[-2000:]}")
    ex_s = time.perf_counter() - t0
    say(f"serve CLI --durable twice ({DUR_CLI_GRAPH}): {len(answers1)} equal "
        f"answer lines, recoveries {r1['mode']} then {r2['mode']} "
        f"({r2['seconds']:.2f} s), runs {st1['wall_s']:.1f} s and "
        f"{st2['wall_s']:.1f} s; serve_quickstart_torch.py exits 0 "
        f"({ex_s:.1f} s)")
    return {"recover_s": r2["seconds"], "run_s": [st1["wall_s"],
                                                   st2["wall_s"]],
            "example_s": ex_s}


def durable_phase(results, csr_edges):
    """Phase 11: durability on the card, in a temporary directory that is
    deleted at the end."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    phase = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_durable_") as tmp:
        tmp = Path(tmp)
        rows = {k: np.random.default_rng(SEED).integers(0, CSR_N, (k, 2))
                for k in (DUR_SUFFIX, DUR_TAIL)}
        phase["wal_append_ms"] = {
            f"{k} rows, fsync {'on' if fs else 'off'}": _wal_append_ms(
                torch, tmp, r, fs) for k, r in rows.items()
            for fs in (True, False)}
        say(f"WAL append (median of {DUR_WAL_ROUNDS}): "
            + ", ".join(f"{k}: {v:.2f} ms"
                        for k, v in phase["wal_append_ms"].items()))
        phase["csr_tc"] = durable_csr(torch, csr_edges, tmp / "csr")
        phase["dense_spath"] = durable_dense(torch, tmp / "dense")
        phase["cli"] = durable_cli(tmp / "cli")
    phase["seconds"] = time.perf_counter() - t0
    say(f"durability phase: {phase['seconds']:.1f} s")
    results["durable_phase"] = phase


# -- phase 12: distribution ---------------------------------------------------


@contextlib.contextmanager
def phase12(results):
    """A block of phase 12 inside another phase: yields its results dict
    and adds the block's wall time to its ``seconds``."""
    mesh = results.setdefault("mesh_phase", {})
    t0 = time.perf_counter()
    yield mesh
    mesh["seconds"] = mesh.get("seconds", 0.0) + time.perf_counter() - t0


def _worker_mesh(k: int = MESH_SHARDS):
    """A k-shard worker mesh whose shards all share the card."""
    from repro_torch.launch.mesh import make_worker_mesh
    return make_worker_mesh(k, devices=[DEVICE] * k)


def _census(mesh) -> dict:
    return {k: v for k, v in mesh.census().items() if v["count"]}


def _mesh_counts(label, msvc, kernel, seeded, st, counts, census):
    """Phase 12's checks of one counted window on a mesh service: ``kernel``
    launched ``shards x iterations`` times (plus one seed step a fixpoint
    on the CSR carrier, ``seeded``) and nothing else, one broadcast a
    fixpoint and one scalar psum an iteration.  ``st``: the service's stats
    at the window's start.  Returns (iterations, launches)."""
    it = msvc.stats.fixpoint_iterations - st.fixpoint_iterations
    fx = msvc.stats.dense_fixpoints - st.dense_fixpoints
    expect = msvc.mesh.size * it + (fx if seeded else 0)
    check(counts == {kernel: expect}, f"{label}: launches {counts}, "
          f"expected {kernel} {expect}")
    check(set(census) == {"broadcast", "psum"}
          and census["broadcast"]["count"] == fx
          and census["psum"]["count"] == it, f"{label}: census {census}")
    return it, expect


def mesh_batches(label, svc, msvc, pred, weighted, batches, kernel, seeded):
    """Phase 12.1/12.2: batches on a mesh service, each driven between
    launch-count and census reads: its answers equal the unsharded
    service's (whose cache holds them) and its launches and collectives are
    :func:`_mesh_counts`'s.  ``batches``: (name, sources) pairs."""
    import torch
    from repro_torch.kernels import ops
    mesh, k = msvc.mesh, msvc.mesh.size

    def q(s):
        return (pred, (s, None, None) if weighted else (s, None))

    out = {}
    for name, srcs in batches:
        mesh.reset_census()
        ops.reset_launch_counts()
        st = dataclasses.replace(msvc.stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = msvc.ask_batch([q(s) for s in srcs])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {c: v for c, v in ops.launch_counts().items() if v}
        census = _census(mesh)
        want = svc.ask_batch([q(s) for s in srcs])
        check(all(_same_answer(a, b) for a, b in zip(got, want)),
              f"{label} mesh {name} batch != the unsharded service's")
        it, expect = _mesh_counts(f"{label} mesh {name} batch", msvc, kernel,
                                  seeded, st, counts, census)
        out[name] = {"sources": len(srcs), "ms": ms, "iterations": it,
                     "launches": expect, "census": census}
        say(f"{label} on {k} shards, {name} batch of {len(srcs)}: {ms:.1f} "
            f"ms, {it} iterations, {kernel} x {expect}, census {census}; "
            "answers equal the unsharded service's")
    return out


def mesh_appends(services, appended, srcs, single):
    """Phase 12.1's appends, after :func:`dense_appends` has run them on the
    unsharded services: each mesh twin takes the same rows (``appended``,
    by label) between its own launch-count and census reads, one sync at
    the end as there; each cached closure resumes through the mesh
    (:func:`_mesh_counts`).  Then the resumed batch, the single source and
    the new vertex must equal the unsharded service's answers.
    ``services``: (label, service, twin, pred, edb, kernel) tuples."""
    import torch
    from repro_torch.kernels import ops
    out = {}
    for label, svc, twin, pred, edb, kernel in services:
        weighted = appended[label][0].shape[1] == 3
        twin.mesh.reset_census()
        ops.reset_launch_counts()
        st = dataclasses.replace(twin.stats)
        t0 = time.perf_counter()
        for rows in appended[label]:
            twin.append(edb, rows)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {c: v for c, v in ops.launch_counts().items() if v}
        census = _census(twin.mesh)
        it, expect = _mesh_counts(f"{label} mesh twin appends", twin, kernel,
                                  False, st, counts, census)
        q = [(pred, (s, None, None) if weighted else (s, None))
             for s in srcs + [single, DENSE_GROW]]
        check(all(_same_answer(a, b) for a, b in zip(twin.ask_batch(q),
                                                     svc.ask_batch(q))),
              f"{label} mesh twin after the appends != the service")
        out[label] = {"seconds": secs, "resumed_iterations": it,
                      "launches": expect, "census": census}
        say(f"{label} mesh twin appends: {secs:.2f} s, {it} resumed "
            f"iterations, {kernel} x {expect}, census {census}; the resumed "
            f"batch of {len(srcs)} and 2 more sources equal the service's")
    return out


def mesh_service(program, db, svc=None, pred=None, **kw):
    """A mesh service (phase 12.1/12.2).  With ``svc`` it takes ``svc``'s
    packed carrier for ``pred`` instead of packing its own (a CSR's host
    packing costs 9-14 s and is not what phase 12 measures).  The two
    services then share one carrier object, so such a mesh service must
    never append: its ``append`` raises."""
    from repro_torch.service import DatalogService
    msvc = DatalogService(program, db=db, mesh=_worker_mesh(), **kw)
    if svc is not None:
        msvc._dense[pred] = svc._dense_state(pred)

        def no_append(*args, **kwargs):
            raise AssertionError("a mesh service sharing its carrier with "
                                 "an unsharded service must not append")

        msvc.append = no_append
    return msvc


def mesh_cross_device(tc, edges, srcs):
    """Phase 12.6: 12.1's TC batch on two distinct cards when the machine
    has them (peer copies between the shards), against the unsharded
    service ``tc``."""
    import torch
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.service import DatalogService
    if torch.cuda.device_count() < 2:
        say(f"phase 12.6: {torch.cuda.device_count()} CUDA device(s); the "
            "cross-device mesh route (shards on distinct cards) was not run")
        return {"run": False, "devices": torch.cuda.device_count()}
    mesh = make_worker_mesh(2)
    mtc = DatalogService(TC, db={"arc": edges}, mesh=mesh)
    qs = [("tc", (s, None)) for s in srcs]
    t0 = time.perf_counter()
    got = mtc.ask_batch(qs)
    for d in mesh.devices:
        torch.cuda.synchronize(d)
    secs = time.perf_counter() - t0
    check(all(_same_answer(a, b) for a, b in zip(got, tc.ask_batch(qs))),
          "cross-device mesh TC batch != the unsharded service's")
    say(f"phase 12.6: TC batch of {len(srcs)} on {mesh}: {secs:.2f} s, "
        f"census {_census(mesh)}; answers equal the unsharded service's")
    return {"run": True, "seconds": secs, "census": _census(mesh)}


def _event_ms(torch, fn):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def _fig4(it: int) -> dict:
    """Fig. 4's collectives: one broadcast, one scalar psum an iteration."""
    return {"broadcast": 1, "psum": it}


def mesh_plan(torch, label, fn, k, kernel, want, collectives):
    """Phase 12.3/12.5: one distributed plan on a fresh k-shard mesh between
    launch-count reads: its table must equal ``want``, ``kernel`` must
    launch ``k x iterations`` times and nothing else (None: no counted
    kernel at all), and the census must count ``collectives(iterations)``
    of each kind and nothing else.  Device ms by CUDA events around the
    plan."""
    from repro_torch.kernels import ops
    mesh = _worker_mesh(k)
    ops.reset_launch_counts()
    (table, it), ms = _event_ms(torch, lambda: fn(mesh))
    counts = {c: v for c, v in ops.launch_counts().items() if v}
    check(torch.equal(table, want),
          f"{label} on {k} shards != the unsharded table")
    expect = {kernel: k * it} if kernel else {}
    check(counts == expect, f"{label} on {k} shards: launches {counts}, "
          f"expected {expect}")
    got = {c: v["count"] for c, v in _census(mesh).items()}
    check(got == collectives(it), f"{label} on {k} shards: collectives "
          f"{got}, expected {collectives(it)}")
    out = {"shards": k, "rows_per_shard": table.shape[0] // k,
           "iterations": it, "device_ms": ms, "launches": counts,
           "census": _census(mesh)}
    say(f"{label} on {k} shards ({out['rows_per_shard']} rows a shard): "
        f"{it} iterations, {ms:.1f} device ms, launches {counts}, census "
        f"{out['census']}; equal to the unsharded table")
    return out


def csr_scaleout(torch, svc, srcs):
    """Phase 12.5's CSR half: the CSR TC batch's Fig.-4 plan
    (``csr_frontier_decomposable``) at every shard count of
    :data:`SCALE_SHARDS` from the batch layer's padded seed rows, each equal
    to the unsharded masked fixpoint's table."""
    from repro_torch.core import sparse
    from repro_torch.core.distributed import csr_frontier_decomposable
    from repro_torch.service.batch import _padded_index, pad_batch_size
    csr = svc._dense_state("tc").csr
    bp = pad_batch_size(len(srcs), svc.batch_pads)
    init = sparse.rows_from_sources(csr, _padded_index(srcs, bp))
    init[len(srcs):] = False
    want = sparse.fixpoint_csr(csr, init).table
    return [mesh_plan(torch, "CSR TC batch",
                      lambda m: csr_frontier_decomposable(m, csr, init), k,
                      "csr_bool_step", want, _fig4) for k in SCALE_SHARDS]


def psn_cc(torch, label, edges, n):
    """Phase 12.4: connected components by the shuffled PSN
    (``psn_shuffle_agg``, min labels) over ``edges`` made symmetric, on
    :data:`MESH_SHARDS` shards of the card: every label the least vertex
    of its component (scipy's components), the iterations the changing
    rounds of synchronous min-label propagation (``scatter_reduce`` on the
    card) + 1, no overflow at a bucket capacity of the largest (source
    owner, destination owner) arc count, two all-to-alls and one scalar
    psum an iteration, and no counted kernel (sorts and merges only)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    from repro_torch.core.distributed import (EMPTY, partition_edges_by_src,
                                              psn_shuffle_agg)
    from repro_torch.kernels import ops
    k = MESH_SHARDS
    t0 = time.perf_counter()
    sym = np.concatenate([edges, edges[:, ::-1]])
    fib = np.uint64(11400714819323198485)

    def owner(v):
        return (((v.astype(np.uint64) * fib) >> np.uint64(40))
                % np.uint64(k)).astype(np.int64)

    src_owner, dst_owner = owner(sym[:, 0]), owner(sym[:, 1])
    per_shard = np.bincount(src_owner, minlength=k)
    bucket_cap = int(np.bincount(src_owner * k + dst_owner,
                                 minlength=k * k).max())
    parts = partition_edges_by_src(sym, k, int(per_shard.max()))
    del src_owner, dst_owner
    vowner = owner(np.arange(n))
    cap = int(np.bincount(vowner, minlength=k).max())
    keys = np.full((k, cap), EMPTY, np.int64)
    vals = np.full((k, cap), np.iinfo(np.int32).max, np.int32)
    for s in range(k):
        mine = np.nonzero(vowner == s)[0]
        keys[s, :len(mine)] = mine
        vals[s, :len(mine)] = mine
    host_s = time.perf_counter() - t0
    args = [torch.from_numpy(a).to(DEVICE)
            for a in (parts, keys.reshape(-1), vals.reshape(-1))]
    del parts
    mesh = _worker_mesh(k)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    got_k, got_v, it, overflow = psn_shuffle_agg(mesh, *args, n,
                                                 bucket_cap=bucket_cap)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    del args
    counts = {c: v for c, v in ops.launch_counts().items() if v}
    check(not counts, f"{label} PSN CC: a counted kernel launched ({counts})")
    check(not overflow, f"{label} PSN CC: overflow at the chosen capacities")
    got_k, got_v = got_k.cpu().numpy(), got_v.cpu().numpy()
    live = got_k != EMPTY
    labels = np.full(n, -1, np.int64)
    labels[got_k[live]] = got_v[live]
    ncomp, comp = connected_components(
        csr_matrix((np.ones(len(edges), np.int8), (edges[:, 0], edges[:, 1])),
                   shape=(n, n)), directed=False)
    least = np.full(ncomp, n)
    np.minimum.at(least, comp, np.arange(n))
    check(np.array_equal(labels, least[comp]),
          f"{label} PSN CC labels != scipy's components' least vertices")
    s_d = torch.from_numpy(sym[:, 0]).to(DEVICE)
    d_d = torch.from_numpy(sym[:, 1]).to(DEVICE)
    lab = torch.arange(n, device=DEVICE)
    rounds = 0
    while True:
        new = lab.scatter_reduce(0, d_d, lab[s_d], "amin")
        if torch.equal(new, lab):
            break
        lab, rounds = new, rounds + 1
    del s_d, d_d, lab, new
    check(it == rounds + 1, f"{label} PSN CC: {it} iterations, min-label "
          f"propagation {rounds} changing rounds")
    census = _census(mesh)
    check(set(census) == {"all_to_all", "psum"}
          and census["all_to_all"]["count"] == 2 * it
          and census["psum"]["count"] == it,
          f"{label} PSN CC: census {census}")
    out = {"arcs": len(sym), "components": int(ncomp), "shards": k,
           "cap": cap, "bucket_cap": bucket_cap,
           "arcs_per_shard": per_shard.tolist(), "iterations": it,
           "seconds": secs, "host_setup_s": host_s, "peak_gib": peak,
           "census": census}
    say(f"phase 12.4 {label} PSN CC on {len(sym)} symmetric arcs, {k} "
        f"shards: {it} iterations ({rounds} changing rounds + 1), "
        f"{secs:.2f} s (host partitioning {host_s:.1f} s), peak {peak:.2f} "
        f"GiB over the inputs, {ncomp} components equal to scipy's, census "
        f"{census}")
    return out


def psn_phase(results, edges):
    """Phase 12.4 on the power-law arcs (after phase 11; one component,
    reached in a few rounds from its hubs), then on an Erdős–Rényi G(n, m)
    with n = m = :data:`CSR_N` (mean degree 2: a giant component, many small
    ones and isolated vertices, and tens of rounds)."""
    import torch
    with phase12(results) as mesh:
        mesh["psn_cc"] = psn_cc(torch, "power-law", edges, CSR_N)
        er = np.random.default_rng(SEED + 12).integers(0, CSR_N, (CSR_N, 2))
        mesh["psn_cc_gnm"] = psn_cc(torch, "G(n, m)", er, CSR_N)


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
    results: dict = {"obs_phase": {}}
    dense_phase(results)
    edges, wedges, sp_oracle = csr_phase(results)
    tuned_phase(results, wedges, sp_oracle)
    del wedges, sp_oracle
    dag_phase(results, edges)
    analytics_phase(results, edges)
    durable_phase(results, edges)
    psn_phase(results, edges)
    del edges
    allpairs_phase(results)
    tuple_phase(results)
    lm_phase(results)
    train_phase(results)
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
                                           "lm_phase", "train_phase",
                                           "obs_phase", "durable_phase",
                                           "mesh_phase")},
                                default=str))
    say(f"phase 12 (distribution): {results['mesh_phase']['seconds']:.1f} "
        "s in all")
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(card)
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
