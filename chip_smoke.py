#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script stops at the first failure with
a non-zero exit and prints no result):

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles the four hand-written kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel);
3. kernel parity at ragged shapes: K1-K4 against their plain PyTorch
   versions, exact equality (bool is exact; min of sums of small integers
   in f32 is exact and order-independent);
4. dense main path: ``DatalogService`` TC and SPATH on ``gnp_graph(10_000,
   0.1)`` (the paper's Table-6 Gn-p family; density 0.1 picks the dense
   carrier), ``ask_batch`` of 100 sources, a second batch of 100, a repeat
   of the first (all cache hits) and one ``ask``;
5. CSR main path: TC and SPATH on ``powerlaw_graph(2**20, 16_000_000,
   alpha=0.8)`` (a social-graph shape; the density heuristic picks CSR),
   ``ask_batch`` of 32 sources, a second batch of 32 and a repeat;
6. checks: the chosen carriers, every kernel's launch count during its path
   (counts reset just before each path and read just after), and the
   answers of 4 sources per path against scipy's csgraph (BFS, Dijkstra);
   each kernel is timed at the shapes its path gave it (the first fixpoint
   iteration's frontier) beside its plain version and, where one PyTorch
   call computes the same function, that call; a warm batch is split into
   fixpoint, copy to the host and formatting.

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

KERNELS = {
    "bool_matmul": ("src/repro_torch/kernels/csrc/boolmm.cu",
                    "src/repro/kernels/boolmm.py:47"),
    "minplus_matmul": ("src/repro_torch/kernels/csrc/minplus.cu",
                       "src/repro/kernels/minplus.py:49"),
    "csr_bool_step": ("src/repro_torch/kernels/csrc/spmv.cu",
                      "src/repro/kernels/spmv.py:149"),
    "csr_minplus_step": ("src/repro_torch/kernels/csrc/spmv.cu",
                         "src/repro/kernels/spmv.py:251"),
}


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


def check_device():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    say(smi.stdout.strip())
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")


def build_kernels():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build(verbose=True)
    say(f"build: {time.perf_counter() - t0:.1f} s for {list(build.SOURCES)}")
    for line in report.splitlines():
        if line.startswith("==") or "Used" in line or "spill" in line:
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


def ragged_parity():
    import torch
    from repro_torch.kernels import boolmm, minplus, spmv
    rng = np.random.default_rng(SEED)
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
        cases += 2
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
        cases += 2
    torch.cuda.synchronize()
    say(f"parity (ragged): {cases} kernel cases exactly equal to plain")


# -- phases 4-6: the main path ------------------------------------------------


def _weighted(rng, edges):
    return np.concatenate([edges, rng.integers(1, 10, (len(edges), 1))], 1)


class Oracle:
    """Single-source answers in one or more arcs from scipy's csgraph: BFS
    reachability or Dijkstra distances (the source itself is an answer only
    when it lies on a cycle)."""

    def __init__(self, edges, n, weighted):
        from scipy.sparse import csr_matrix
        self.n, self.weighted = n, weighted
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


def drive(label, svc, pred, edges, n, srcs, srcs2, single, weighted, repr_):
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
    oracle = Oracle(edges, n, weighted)
    for s, ans in [*zip(srcs[:3], first[:3]), (single, one)]:
        oracle.check(s, ans)
    say(f"{label}: 4 sources equal the scipy oracle "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"qps_cold": len(srcs) / s1, "qps_warm": len(srcs2) / s2,
            "iterations": [it1, it2, it4]}


def breakdown(torch, label, svc, pred, srcs):
    """Where a warm batch's time goes, measured after the path's launch
    counts are read: the batched fixpoint on the card (seed step
    included), the copy of its table to the host, and formatting the
    answers.  The rest of ``ask_batch`` is cache and bookkeeping."""
    ds = svc._dense_state(pred)
    torch.cuda.synchronize()
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
           "format_ms": (t3 - t2) * 1e3, "iterations": res.iterations}
    say(f"{label} warm batch of {len(srcs)}: fixpoint {out['fixpoint_ms']:.1f}"
        f" ms ({res.iterations} iterations), copy to host "
        f"{out['copy_ms']:.1f} ms, formatting {out['format_ms']:.1f} ms")
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
    phase = {"tc": drive("dense TC", tc, "tc", edges, n, srcs, srcs2,
                         single, False, "dense"),
             "spath": drive("dense SPATH", sp, "dpath", wedges, n, srcs,
                            srcs2, single, True, "dense")}
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
    del tc, sp, adj, w, f, fw
    torch.cuda.empty_cache()


def _matmul_call(torch, f, adj):
    ff, af = f.float(), adj.float()
    return lambda: torch.matmul(ff, af)


def _sparse_mm_call(torch, csr, f):
    """``torch.sparse.mm`` of the transposed f32 adjacency (spine arcs)
    with the f32 frontier: the same segment sum the bool step thresholds."""
    m = int(csr.nnz)
    idx = torch.stack([csr.col_idx[:m].long(), csr.src_idx[:m].long()])
    at = torch.sparse_coo_tensor(
        idx, torch.ones(m, device=f.device), (csr.n_alloc, csr.n_alloc),
        check_invariants=False).coalesce().to_sparse_csr()
    ft = f.T.float().contiguous()
    return lambda: torch.sparse.mm(at, ft)


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
    ops.reset_launch_counts()
    phase = {"tc": drive("CSR TC", tc, "tc", edges, n, srcs, srcs2, single,
                         False, "csr"),
             "spath": drive("CSR SPATH", sp, "dpath", wedges, n, srcs, srcs2,
                            single, True, "csr")}
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
        B, na = f.shape
        live = f if f.dtype == torch.bool else torch.isfinite(f)
        outdeg = (csr.row_ptr[1:] - csr.row_ptr[:-1]).double()
        # a push over the live sources' out-arcs is the least work: one ⊗
        # and one ⊕ per (row, live source, arc); bytes: the frontier in and
        # out, those arcs' (dst, val) once, the row pointers
        work = float((live.double() @ outdeg).sum())
        arcs = float((live.any(0).double() * outdeg).sum())
        bytes_ = 2 * B * na * s + arcs * (4 + s) + 4 * (na + 1)
        results[key].update(measure(
            torch, f"{key} ({pred})", step, plain, (f, csr), 10,
            _bound(bytes_, 2 * work, rate),
            library=_sparse_mm_call(torch, csr, f) if s == 1 else None))
    del tc, sp
    torch.cuda.empty_cache()


def main():
    t_start = time.perf_counter()
    check_device()
    build_kernels()
    import torch
    ragged_parity()
    results: dict = {}
    dense_phase(results)
    csr_phase(results)
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **{k: results[name][k] for k in (
             "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")}}
        for name, (src, rep) in KERNELS.items()]}
    say("phases: " + json.dumps({k: results[k]
                                 for k in ("dense_phase", "csr_phase")}))
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
