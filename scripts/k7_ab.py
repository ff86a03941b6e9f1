#!/usr/bin/env python3
"""Trace and time K4 (``csr_minplus_step``) and K7
(``csr_minplus_tiled_step``) of two or more checkouts of the port on one
card, in one run, at the CSR SPATH paths' shapes in ``chip_smoke.py``:
``powerlaw_graph(2**20, 16_000_000, alpha=0.8, seed=0)`` with weights 1..9,
K4 on the default layout (CSR SPATH) and K7 on the pinned
``KernelConfig(use_kernel=True)`` layout (tile-skip plan (32, 128); tuned
CSR SPATH), each at a (32, 2^20) frontier: the 32 sources' arc rows (the
seed step) and one with every value finite (K7 equal to K4 at both), then
at every frontier of a fixpoint from those rows (K7 equal to K4 at each;
summed), and one call of each traced with ``torch.profiler`` at the seed
frontier (every launch: transpose, pull or tile pass, gather).

    python3 scripts/k7_ab.py ROOT_A ROOT_B ROOT_B ROOT_A [--units 1024,4096]

Each ROOT is a checkout (its ``src/`` is imported, its kernels built under
its own ``build/``), run in a process of its own in the order given, so
A, B, B, A shows drift across the run.  The arcs are made once and kept in
``build/k7_ab_edges.npy`` of this checkout.  Prints the card's name and
power limit, then per ROOT its ``trace`` lines and one JSON line: median
CUDA-event ms over 3 rounds of 10 calls.  ``--units`` also times K7 with
its view cut into work units of each size given
(``core.sparse.TILE_UNIT``), where the checkout has one.
``--n``/``--m`` shrink the graph and ``--device cpu`` runs the plain
versions, to rehearse the script without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_ms(torch, fn, calls=10, rounds=3):
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
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
            import time
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


def one(root, edges_path, n, device, units):
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.core import sparse
    from repro_torch.kernels import autotune, spmv
    edges = np.load(edges_path)
    untuned = sparse.build_csr(edges, n, "minplus", device=device)
    tuned = autotune.build_tuned(edges, n, "minplus",
                                 autotune.KernelConfig(use_kernel=True),
                                 device=device)
    del edges
    k4 = lambda x: spmv.csr_minplus_step(x, untuned)  # noqa: E731
    k7 = lambda x: spmv.csr_minplus_tiled_step(x, tuned)  # noqa: E731
    rng = np.random.default_rng(4)  # the tuned phase's sources
    srcs = rng.permutation(n)[:32]
    f = sparse.rows_from_sources(untuned, srcs)
    g = torch.Generator(device=f.device).manual_seed(0)
    fd = torch.randint(0, 64, f.shape, generator=g, device=f.device,
                       dtype=torch.float32)
    out = {"root": root}
    for name, x in (("seed", f), ("finite", fd)):
        if not torch.equal(k7(x), k4(x)):
            raise SystemExit(f"{root}: K7 != K4 at the {name} frontier")
        out[f"k7_{name}_ms"] = time_ms(torch, lambda: k7(x))
        out[f"k4_{name}_ms"] = time_ms(torch, lambda: k4(x))
    captured = []

    def rec(x, c):
        captured.append(x.clone())
        return k4(x)

    res = sparse.fixpoint_csr(untuned, f, spmv=rec)
    k4_ms, k7_ms = [], []
    for x in captured:
        if not torch.equal(k7(x), k4(x)):
            raise SystemExit(f"{root}: K7 != K4 at a fixpoint frontier")
        k4_ms.append(time_ms(torch, lambda: k4(x)))
        k7_ms.append(time_ms(torch, lambda: k7(x)))
    out["fixpoint"] = {"iterations": res.iterations,
                       "generated": res.generated, "k4_ms": sum(k4_ms),
                       "k7_ms": sum(k7_ms), "k4_each": k4_ms,
                       "k7_each": k7_ms}
    del captured
    if units and hasattr(sparse, "_with_tile_order"):
        out["units"] = {}
        for u in units:
            c = sparse._with_tile_order(tuned, u)
            out["units"][u] = {
                "units": int(c.tile_units.shape[0]),
                **{name: time_ms(torch, lambda: spmv.csr_minplus_tiled_step(
                    x, c)) for name, x in (("seed", f), ("finite", fd))}}
            del c
    if device == "cuda":
        label = os.path.basename(root.rstrip("/")) or root
        for kname, fn in (("K4", lambda: k4(f)), ("K7", lambda: k7(f))):
            for ev, ms in trace(torch, fn):
                print(f"trace {label} {kname}: {ms:.4f} ms {ev}", flush=True)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--one")
    ap.add_argument("--edges")
    ap.add_argument("--n", type=int, default=2 ** 20)
    ap.add_argument("--m", type=int, default=16_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--units", default="")
    a = ap.parse_args()
    if a.one:
        return one(a.one, a.edges, a.n, a.device,
                   [int(u) for u in a.units.split(",") if u])
    if a.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("k7_ab: no CUDA device")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    path = os.path.join(HERE, "build", "k7_ab_edges.npy")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.data import powerlaw_graph
    edges = powerlaw_graph(a.n, a.m, alpha=0.8, seed=0)
    rng = np.random.default_rng(1)  # the CSR phase's weights
    np.save(path, np.concatenate(
        [edges, rng.integers(1, 10, (len(edges), 1))], 1))
    try:
        for root in a.roots:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", os.path.abspath(root), "--edges", path,
                            "--n", str(a.n), "--device", a.device,
                            "--units", a.units], check=True)
    finally:
        os.remove(path)


if __name__ == "__main__":
    main()
