#!/usr/bin/env python3
"""Trace and time K6 (``csr_maxplus_step``) and K8 (``relax_step``) of one
or more checkouts of the port on one card, in one run, at the shapes
``chip_smoke.py`` gives them:

* K8: the paper's G10K (``gnp_graph(10_000, 0.001, seed=0)``, weights 1..9
  from ``np.random.default_rng(8)``) as an (n, n) f32 matrix; the loop
  ``d, mask = relax_step(d, w, mask)`` from ``d = w``, every row in Δ,
  timed whole (host clock, synchronized); K8 at the inputs of its first,
  middle and last trips, each output equal to one K2 step with its merge
  and changed test (``minplus.minplus_matmul``), timed with CUDA events;
  one call at the first step traced with ``torch.profiler``;
* K6: the arcs of ``powerlaw_graph(2**20, 16_000_000, alpha=0.8, seed=0)``
  with src > dst (a DAG, 13.2M arcs), weights 1..9 from
  ``np.random.default_rng(3)``, as a max-plus CSR at n_alloc 2^20 (CSR
  LPATH); ``fixpoint_csr`` from the rows of 32 sources drawn with
  ``np.random.default_rng(5)``, as the batch layer's first step sees them,
  timed whole, with a step that records each input; K6 at every recorded
  input, held to the plain step exactly, timed; one step at the seed
  frontier traced.

    python3 scripts/k68_ab.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is a checkout (its ``src/`` is imported, its kernels built under
its own ``build/``), run in a process of its own in the order given, so A,
B, B, A shows drift across the run.  Prints the card's name and power
limit, then per ROOT its ``trace`` lines and one JSON line (median
CUDA-event ms over 3 rounds).  ``--n``/``--m``/``--ap-n`` shrink the
graphs and ``--device cpu`` runs the plain versions, to rehearse the
script without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 32


def sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_ms(torch, fn, calls=10, rounds=3):
    fn()
    sync(torch)
    per_call = []
    for _ in range(rounds):
        if torch.cuda.is_available():
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            stop.record()
            stop.synchronize()
            per_call.append(start.elapsed_time(stop) / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            per_call.append((time.perf_counter() - t0) * 1e3 / calls)
    return float(np.median(per_call))


def trace(torch, fn):
    """Every device kernel one call of ``fn`` launches, in launch order, as
    (name, ms)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):  # the trace may miss the first launch: keep the
            fn()            # second call's, read from the end
            torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    kern.sort(key=lambda e: e.time_range.start)
    kern = kern[len(kern) // 2:]
    return [(e.name.replace("(anonymous namespace)::", "").split("(")[0]
             .replace("void ", ""),
             (e.time_range.end - e.time_range.start) / 1e3) for e in kern]


def k8(torch, n, p, device):
    from repro_torch.data import gnp_graph
    from repro_torch.kernels import minplus, relax
    edges = gnp_graph(n, p, seed=0)
    wts = np.random.default_rng(8).integers(1, 10, len(edges))
    w = torch.full((n, n), float("inf"), device=device)
    w[torch.from_numpy(edges[:, 0]).to(device),
      torch.from_numpy(edges[:, 1]).to(device)] = torch.from_numpy(
          wts.astype(np.float32)).to(device)

    def loop():
        d, mask = w, torch.ones(n, dtype=torch.bool, device=device)
        inputs = []
        while bool(mask.any()):
            inputs.append((d, mask))
            d, mask = relax.relax_step(d, w, mask)
        return d, inputs

    loop()  # builds the kernels
    sync(torch)
    t0 = time.perf_counter()
    _, inputs = loop()
    sync(torch)
    out = {"trips": len(inputs), "loop_s": time.perf_counter() - t0}
    steps = {"first": inputs[0], "middle": inputs[len(inputs) // 2],
             "last": inputs[-1]}
    del inputs
    for label, (d, mask) in steps.items():
        got = relax.relax_step(d, w, mask)
        dm = torch.where(mask[:, None], d, float("inf"))
        dn = torch.minimum(d, minplus.minplus_matmul(dm, w))
        if not (torch.equal(got[0], dn) and torch.equal(got[1],
                                                        (dn < d).any(1))):
            raise SystemExit(f"K8 != K2 + merge at the {label} step")
        del got, dm, dn
        out[label] = {"delta_rows": int(mask.sum()),
                      "ms": time_ms(torch, lambda: relax.relax_step(d, w,
                                                                     mask))}
    if device == "cuda":
        d, mask = steps["first"]
        out["trace"] = trace(torch, lambda: relax.relax_step(d, w, mask))
    return out


def k6(torch, edges_path, n, device):
    from repro_torch.core import sparse
    from repro_torch.kernels import spmv
    edges = np.load(edges_path)
    dag = edges[edges[:, 0] > edges[:, 1]]
    del edges
    lw = np.concatenate([dag, np.random.default_rng(3).integers(
        1, 10, (len(dag), 1))], 1)
    del dag
    t0 = time.perf_counter()
    csr = sparse.build_csr(lw, n, "maxplus", device=device)
    build_s = time.perf_counter() - t0
    del lw
    srcs = np.random.default_rng(5).permutation(n)[:BATCH]
    seed = sparse.rows_from_sources(csr, srcs)
    captured = []

    def rec(f, c):
        captured.append(f.clone())
        return spmv.csr_maxplus_step(f, c)

    res = sparse.fixpoint_csr(csr, seed, spmv=rec)
    sync(torch)
    t0 = time.perf_counter()
    again = sparse.fixpoint_csr(csr, seed, spmv=spmv.csr_maxplus_step)
    sync(torch)
    fix_s = time.perf_counter() - t0
    if not torch.equal(again.table, res.table):
        raise SystemExit("K6: two fixpoints differ")
    active, ms = [], []
    for f in captured:
        if not torch.equal(spmv.csr_maxplus_step(f, csr),
                           spmv.plain_maxplus(f, csr)):
            raise SystemExit("K6 != plain")
        active.append(float((f != float("-inf")).any(0).float().mean()))
        ms.append(time_ms(torch, lambda: spmv.csr_maxplus_step(f, csr)))
    out = {"build_s": build_s, "iterations": res.iterations,
           "generated": res.generated, "fixpoint_s": fix_s,
           "seed_ms": time_ms(torch, lambda: spmv.csr_maxplus_step(seed,
                                                                   csr)),
           "ms": ms, "total_ms": float(sum(ms)), "active": active}
    if device == "cuda":
        out["trace"] = trace(torch, lambda: spmv.csr_maxplus_step(seed, csr))
    return out


def one(root, edges_path, n, ap_n, device):
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    name = os.path.basename(root.rstrip("/")) or root
    out = {"root": root}
    t0 = time.perf_counter()
    out["K8"] = k8(torch, ap_n, 0.001 if ap_n >= 1000 else 0.02, device)
    if device == "cuda":
        torch.cuda.empty_cache()
    out["K6"] = k6(torch, edges_path, n, device)
    out["seconds"] = time.perf_counter() - t0
    for kernel in ("K8", "K6"):
        for kname, kms in out[kernel].pop("trace", []):
            print(f"trace {name} {kernel}: {kms:.4f} ms {kname}", flush=True)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--one")
    ap.add_argument("--edges")
    ap.add_argument("--n", type=int, default=2 ** 20)
    ap.add_argument("--m", type=int, default=16_000_000)
    ap.add_argument("--ap-n", type=int, default=10_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.one:
        return one(a.one, a.edges, a.n, a.ap_n, a.device)
    if a.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("k68_ab: no CUDA device")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    path = os.path.join(HERE, "build", "k68_ab_edges.npy")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.data import powerlaw_graph
    np.save(path, powerlaw_graph(a.n, a.m, alpha=0.8, seed=0))
    try:
        for root in a.roots:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", os.path.abspath(root), "--edges", path,
                            "--n", str(a.n), "--ap-n", str(a.ap_n),
                            "--device", a.device], check=True)
    finally:
        os.remove(path)


if __name__ == "__main__":
    main()
