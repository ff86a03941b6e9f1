#!/usr/bin/env python3
"""Trace and time K3 (``csr_bool_step``) and K5 (``csr_plustimes_step``) of
one or more checkouts of the port on one card, in one run, at the CSR
paths' shapes in ``chip_smoke.py``: ``powerlaw_graph(2**20, 16_000_000,
alpha=0.8, seed=0)`` as a bool CSR (CSR TC) and its arcs with src > dst,
unit weights, as a plus-times CSR (CSR CPATH), both at n_alloc 2^20.

    python3 scripts/k35_ab.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is a checkout (its ``src/`` is imported, its ``spmv`` library
built under its own ``build/``), run in a process of its own in the order
given, so A, B, B, A shows drift across the run.  Per ROOT and kernel:

* the seed frontier: the (32, 2^20) adjacency rows of 32 sources drawn
  with ``np.random.default_rng(5)``, as the batch layer's first step sees
  them; one step traced with ``torch.profiler``, every device kernel it
  launched in order with its ms (a pull over one ELL slice is labelled
  with the slice's rows and capacity), the sum of those and the step's
  CUDA-event time;
* the fixpoint's frontiers: ``fixpoint_csr`` from that seed with a step
  that records each input (as the service's batch passes them), each
  input's output held to the plain step (K3 exactly; K5 exactly, the
  counts being integers below 2^24), and the kernel timed at every input;
  the share of active sources per input.

Prints the card's name and power limit, then per ROOT one ``trace`` line
per kernel and one JSON line: median CUDA-event ms over 3 rounds of 10
calls.  ``--n``/``--m`` shrink the graph and ``--device cpu`` runs the
plain versions, to rehearse the script without a card.
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


def time_ms(torch, fn, calls=10, rounds=3):
    fn()
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        if cuda:
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


def trace(torch, fn, slices):
    """Every device kernel one call of ``fn`` launches, in launch order, as
    (name, ms); slice pulls of the sliced-ELL template carry their slice."""
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
    rows, pulls = [], iter(slices)
    for e in kern:
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].replace("void ", "")
        if "slice_pull" in name:
            r, c = next(pulls, (None, None))
            name += f" [rows {r}, cap {c}]"
        rows.append((name, (e.time_range.end - e.time_range.start) / 1e3))
    return rows


def one(root, edges_path, n, device):
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.core import sparse
    from repro_torch.kernels import spmv
    edges = np.load(edges_path)
    dag = edges[edges[:, 0] > edges[:, 1]]
    cases = (("K3", "bool", edges, spmv.csr_bool_step, spmv.plain_bool),
             ("K5", "plustimes",
              np.concatenate([dag, np.ones((len(dag), 1), np.int64)], 1),
              spmv.csr_plustimes_step, spmv.plain_plustimes))
    del edges, dag
    out = {"root": root}
    srcs = np.random.default_rng(5).permutation(n)[:BATCH]
    for name, kind, arcs, step, plain in cases:
        t0 = time.perf_counter()
        csr = sparse.build_csr(arcs, n, kind, device=device)
        build_s = time.perf_counter() - t0
        del arcs
        slices = [tuple(t.shape) for t in csr.ell_slices]
        seed = sparse.rows_from_sources(csr, srcs)
        captured = []

        def rec(f, c, step=step):
            captured.append(f.clone())
            return step(f, c)

        res = sparse.fixpoint_csr(csr, seed, spmv=rec)
        zero = csr.semiring.zero
        active, ms = [], []
        for f in captured:
            if not torch.equal(step(f, csr), plain(f, csr)):
                raise SystemExit(f"{root}: {name} != plain")
            active.append(float((f != zero).any(0).float().mean()))
            ms.append(time_ms(torch, lambda: step(f, csr)))
        seed_ms = time_ms(torch, lambda: step(seed, csr))
        rep = {"build_s": build_s, "slices": slices,
               "iterations": res.iterations, "generated": res.generated,
               "seed_ms": seed_ms, "ms": ms, "total_ms": float(sum(ms)),
               "active": active}
        for k in ("ell_src", "ell_val", "ell_items", "ell_row_piece"):
            t = getattr(csr, k, None)
            if t is not None:
                rep[f"{k}_mb"] = t.numel() * t.element_size() / 1e6
        if device == "cuda":
            rows = trace(torch, lambda: step(seed, csr), slices)
            for kname, kms in rows:
                print(f"trace {os.path.basename(root) or root} {name}: "
                      f"{kms:.4f} ms {kname}", flush=True)
            rep["trace_ms"] = float(sum(k for _, k in rows))
            rep["trace_launches"] = len(rows)
        out[name] = rep
        del csr, seed, captured
        if device == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--one")
    ap.add_argument("--edges")
    ap.add_argument("--n", type=int, default=2 ** 20)
    ap.add_argument("--m", type=int, default=16_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.one:
        return one(a.one, a.edges, a.n, a.device)
    if a.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("k35_ab: no CUDA device")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    path = os.path.join(HERE, "build", "k35_ab_edges.npy")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.data import powerlaw_graph
    np.save(path, powerlaw_graph(a.n, a.m, alpha=0.8, seed=0))
    try:
        for root in a.roots:
            subprocess.run([sys.executable, __file__, "--one",
                            os.path.abspath(root), "--edges", path, "--n",
                            str(a.n), "--device", a.device], check=True)
    finally:
        os.remove(path)


if __name__ == "__main__":
    main()
