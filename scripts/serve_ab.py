#!/usr/bin/env python3
"""Warm-batch qps of the port's frontier serving paths in two or more
checkouts on one card, in one run, at ``chip_smoke.py``'s shapes: dense TC
and SPATH on ``gnp_graph(10_000, 0.1, seed=0)`` (batches of 100) and CSR
TC, SPATH and the tuned SPATH (``tune=KernelConfig(use_kernel=True)``) on
``powerlaw_graph(2**20, 16_000_000, alpha=0.8, seed=0)`` (batches of 32),
weights 1..9.

    python3 scripts/serve_ab.py ROOT_A ROOT_B ROOT_B ROOT_A [--rounds 7]

Each ROOT is a checkout (its ``src/`` is imported, its kernels built under
its own ``build/``), run in a process of its own in the order given, so
A, B, B, A shows drift across the run.  The graphs are made once and kept
in ``build/serve_ab_*.npy`` of this checkout.  In each process every
service answers one batch (packing its carrier), then ``--rounds`` rounds
in turn over the services of the same batch of sources with the result
cache emptied before each, timed on the host clock to a
``torch.cuda.synchronize()``.  Prints the card's name and power limit, then
one JSON line per ROOT: each path's median qps and every round's seconds.
``--profile K`` then runs ``cProfile`` over K more warm dense TC batches in
each process and adds the host functions with the most own time (per
batch: calls, own ms) under ``profile``.
``--n``/``--m``/``--dense-n`` shrink the graphs and ``--device cpu`` runs
the plain versions, to rehearse the script without a card.
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
TC = """
tc(X,Y) <- arc(X,Y).
tc(X,Y) <- tc(X,Z), arc(Z,Y).
"""
SPATH = """
dpath(X,Z,min<D>) <- darc(X,Z,D).
dpath(X,Z,min<D>) <- dpath(X,Y,Dxy), darc(Y,Z,Dyz), D = Dxy + Dyz.
"""


def host_profile(svc, queries, batches, sync, top=12):
    """The functions with the most own host time over ``batches`` warm
    batches (the result cache emptied before each): per batch, calls and
    own ms."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    for _ in range(batches):
        svc.cache.clear()
        sync()
        prof.enable()
        svc.ask_batch(queries)
        sync()
        prof.disable()
    st = pstats.Stats(prof).stats
    rows = sorted(st.items(), key=lambda kv: -kv[1][2])[:top]
    return [[f"{os.path.basename(f)}:{line}({fn})", nc / batches,
             tt / batches * 1e3] for (f, line, fn), (_, nc, tt, _, _)
            in rows]


def one(root, paths, device, rounds, profile=0):
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.kernels.autotune import KernelConfig
    from repro_torch.service import DatalogService

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    dense, csr = np.load(paths["dense"]), np.load(paths["csr"])
    kw = dict(device=device)
    svcs = {
        "dense TC": (DatalogService(TC, db={"arc": dense[:, :2]}, **kw),
                     "tc", 100, dense),
        "dense SPATH": (DatalogService(SPATH, db={"darc": dense}, **kw),
                        "dpath", 100, dense),
        "CSR TC": (DatalogService(TC, db={"arc": csr[:, :2]}, bits=20, **kw),
                   "tc", 32, csr),
        "CSR SPATH": (DatalogService(SPATH, db={"darc": csr}, bits=20, **kw),
                      "dpath", 32, csr),
        "tuned CSR SPATH": (DatalogService(
            SPATH, db={"darc": csr}, bits=20, sparse=True,
            tune=KernelConfig(use_kernel=True), **kw), "dpath", 32, csr),
    }
    rng = np.random.default_rng(0)
    queries = {}
    for label, (svc, pred, b, edges) in svcs.items():
        n = int(edges[:, :2].max()) + 1
        srcs = [int(s) for s in rng.permutation(n)[:b]]
        queries[label] = [(pred, (s, None) if pred == "tc" else
                           (s, None, None)) for s in srcs]
        svc.ask_batch(queries[label])  # packs the carrier
    secs = {label: [] for label in svcs}
    for _ in range(rounds):
        for label, (svc, _, _, _) in svcs.items():
            svc.cache.clear()
            sync()
            t0 = time.perf_counter()
            svc.ask_batch(queries[label])
            sync()
            secs[label].append(time.perf_counter() - t0)
    out = {"root": root, "qps": {
        label: len(queries[label]) / float(np.median(v))
        for label, v in secs.items()}, "seconds": secs}
    if profile:
        out["profile"] = host_profile(svcs["dense TC"][0],
                                      queries["dense TC"], profile, sync)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--one")
    ap.add_argument("--dense-path")
    ap.add_argument("--csr-path")
    ap.add_argument("--n", type=int, default=2 ** 20)
    ap.add_argument("--m", type=int, default=16_000_000)
    ap.add_argument("--dense-n", type=int, default=10_000)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", type=int, default=0)
    a = ap.parse_args()
    if a.one:
        return one(a.one, {"dense": a.dense_path, "csr": a.csr_path},
                   a.device, a.rounds, a.profile)
    if a.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("serve_ab: no CUDA device")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.data import gnp_graph, powerlaw_graph
    paths = {k: os.path.join(HERE, "build", f"serve_ab_{k}.npy")
             for k in ("dense", "csr")}
    os.makedirs(os.path.dirname(paths["dense"]), exist_ok=True)
    rng = np.random.default_rng(1)
    for k, edges in (("dense", gnp_graph(a.dense_n, 0.1, seed=0)),
                     ("csr", powerlaw_graph(a.n, a.m, alpha=0.8, seed=0))):
        np.save(paths[k], np.concatenate(
            [edges, rng.integers(1, 10, (len(edges), 1))], 1))
    try:
        for root in a.roots:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", os.path.abspath(root),
                            "--dense-path", paths["dense"],
                            "--csr-path", paths["csr"],
                            "--device", a.device,
                            "--rounds", str(a.rounds),
                            "--profile", str(a.profile)], check=True)
    finally:
        for p in paths.values():
            os.remove(p)


if __name__ == "__main__":
    main()
