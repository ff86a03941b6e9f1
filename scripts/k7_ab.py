#!/usr/bin/env python3
"""Time K7 (``csr_minplus_tiled_step``) and K4 (``csr_minplus_step``) of two
or more checkouts of the port on one card, in one run, at the tuned CSR
SPATH path's shapes in ``chip_smoke.py``: ``powerlaw_graph(2**20,
16_000_000, alpha=0.8, seed=0)`` with weights 1..9, the pinned
``KernelConfig(use_kernel=True)`` layout (tile-skip plan (32, 128)), and a
(32, 2^20) frontier, both the 32 sources' arc rows (the seed step) and one
with every value finite.

    python3 scripts/k7_ab.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is a checkout (its ``src/`` is imported, its kernels built under
its own ``build/``), run in a process of its own in the order given, so
A, B, B, A shows drift across the run.  The arcs are made once and kept in
``build/k7_ab_edges.npy`` of this checkout.  Prints the card's name and
power limit, then one JSON line per ROOT: median CUDA-event ms over 3
rounds of 10 calls.  ``--n``/``--m`` shrink the graph and ``--device cpu``
runs the plain versions, to rehearse the script without a card.
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


def one(root, edges_path, n, device):
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.core.sparse import rows_from_sources
    from repro_torch.kernels import autotune, spmv
    edges = np.load(edges_path)
    csr = autotune.build_tuned(edges, n, "minplus",
                               autotune.KernelConfig(use_kernel=True),
                               device=device)
    rng = np.random.default_rng(4)  # the tuned phase's sources
    srcs = rng.permutation(n)[:32]
    f = rows_from_sources(csr, srcs)
    g = torch.Generator(device=f.device).manual_seed(0)
    fd = torch.randint(0, 64, f.shape, generator=g, device=f.device,
                       dtype=torch.float32)
    for x in (f, fd):
        if not torch.equal(spmv.csr_minplus_tiled_step(x, csr),
                           spmv.csr_minplus_step(x, csr)):
            raise SystemExit(f"{root}: K7 != K4")
    out = {"root": root}
    for name, x in (("seed", f), ("finite", fd)):
        out[f"k7_{name}_ms"] = time_ms(
            torch, lambda: spmv.csr_minplus_tiled_step(x, csr))
        out[f"k4_{name}_ms"] = time_ms(
            torch, lambda: spmv.csr_minplus_step(x, csr))
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
            subprocess.run([sys.executable, __file__, "--one",
                            os.path.abspath(root), "--edges", path, "--n",
                            str(a.n), "--device", a.device], check=True)
    finally:
        os.remove(path)


if __name__ == "__main__":
    main()
