#!/usr/bin/env python3
"""Trace and time K1 (``bool_matmul``) and K2 (``minplus_matmul`` /
``maxplus_matmul``) of one or more checkouts of the port on one card, in
one run, at the dense paths' shapes in ``chip_smoke.py``:

* dense LPATH: ``dag_graph(10_000, 0.05, max_w=9)`` through
  ``DatalogService`` (max-plus, n_alloc 10,112); one warm batch of 100
  sources (padded to 128) with a spy on the fixpoint's product that keeps
  every 20th input frontier; K2-max at each kept frontier;
* dense TC: ``gnp_graph(10_000, 0.1)`` the same way, every frontier kept;
  K1 at each;
* the ``ask`` shapes: K1 and K2-max at M = 1 and 8 (the first rows of the
  warm batch's seed);
* M = n: the paper's G10K (``gnp_graph(10_000, 0.001)``, weights 1..9) as
  (n, n) matrices; K2-min at (w, w), K1 at (adj, adj).

    python3 scripts/k12_ab.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is a checkout (its ``src/`` is imported, its kernels built under
its own ``build/``), run in a process of its own in the order given, so A,
B, B, A shows drift across the run.  Every kernel output is held to the
plain version, exactly (at M = n K2's in row blocks of 1,024).  Per input:
the live share (finite, or true, entries of the frontier), the kernel's
median CUDA-event ms over 3 rounds, and the bound (bytes over 3.35 TB/s,
live operations over the type's peak, the larger); K1 also the f32
``matmul`` of the same operands.  The warm LPATH and TC fixpoints are
timed whole (host clock, synchronized).  One call each of K1 and K2-max at
the seed frontier is traced with ``torch.profiler``: every device kernel
it launched, with its ms.

Prints the card's name and power limit, then per ROOT its ``trace`` lines
and one JSON line.  ``--n`` shrinks the graphs and ``--device cpu`` runs
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

HBM_BYTES_S, F32_OPS_S, INT8_OPS_S = 3.35e12, 67e12, 1979e12
LPATH = """
lpath(X,Z,max<D>) <- d(X,Z,D).
lpath(X,Z,max<D>) <- lpath(X,Y,D1), d(Y,Z,D2), D = D1 + D2.
"""
TC = """
tc(X,Y) <- arc(X,Y).
tc(X,Y) <- tc(X,Z), arc(Z,Y).
"""
EVERY, BATCH, ROW_BLOCK = 20, 100, 1024


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


def sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


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


def bound_ms(torch, f, w, live_f, live_w, bytes_, rate):
    """The larger of ``bytes_`` over HBM and the live operations (an add and
    a ⊕, or an AND and an OR, per live f[m, k] and live w[k, n] it meets)
    over ``rate``."""
    ops = 2 * float((live_f.double() @ live_w.sum(1).double()).sum())
    return max(bytes_ / HBM_BYTES_S, ops / rate) * 1e3


def captured(torch, svc, pred, srcs, every):
    """One warm batch of ``srcs`` on ``pred``'s dense carrier, with a spy on
    the fixpoint's product keeping every ``every``-th input frontier (the
    first included); returns (kept [(iteration, frontier)], result)."""
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


def dense_path(torch, label, program, pred, edges, n, every, kernel, plain,
               live, vbytes, rate, library, device):
    from repro_torch.service import DatalogService
    rng = np.random.default_rng(3)
    pick = rng.permutation(n)[:2 * BATCH]
    srcs, srcs2 = [int(s) for s in pick[:BATCH]], [int(s) for s in pick[BATCH:]]
    kw = {"bits": 20} if pred == "lpath" else {}
    db = {"d": edges} if pred == "lpath" else {"arc": edges}
    svc = DatalogService(program, db=db, device=device, **kw)
    svc.ask_batch([(pred, (s, None, None) if pred == "lpath" else (s, None))
                   for s in srcs])  # cold: packs the carrier
    rel = svc._dense_state(pred)
    sync(torch)
    t0 = time.perf_counter()
    res = rel.run_batch(svc, srcs2)
    sync(torch)
    warm_s = time.perf_counter() - t0
    kept, res2 = captured(torch, svc, pred, srcs2, every)
    assert (res2.iterations, res2.generated) == (res.iterations, res.generated)
    w = rel.matrix
    lw = live(w)
    rows = []
    for it, f in kept:
        got, want = kernel(f, w), plain(f, w)
        if not torch.equal(got, want):
            raise SystemExit(f"{label}: kernel != plain at iteration {it}")
        del got, want
        lf = live(f)
        B, na = f.shape
        rows.append({
            "iteration": it, "live": float(lf.double().mean()),
            "live_rows": int(lf.any(1).sum()),
            "ms": time_ms(torch, lambda: kernel(f, w)),
            "bound_ms": bound_ms(torch, f, w, lf, lw,
                                 vbytes * (2 * B * na + na * na), rate)})
        if library is not None:
            rows[-1]["library_ms"] = time_ms(torch, library(f, w))
    seed = kept[0][1]
    out = {"iterations": res.iterations, "generated": res.generated,
           "warm_fixpoint_s": warm_s, "frontiers": rows,
           "ms": float(sum(r["ms"] for r in rows)),
           "bound_ms": float(sum(r["bound_ms"] for r in rows))}
    for m in (1, 8):
        f = seed[:m].contiguous()
        if not torch.equal(kernel(f, w), plain(f, w)):
            raise SystemExit(f"{label}: kernel != plain at M = {m}")
        out[f"m{m}_ms"] = time_ms(torch, lambda: kernel(f, w))
        out[f"m{m}_bound_ms"] = bound_ms(
            torch, f, w, live(f), lw, vbytes * (2 * m * f.shape[1]
                                                + f.shape[1] ** 2), rate)
    if torch.cuda.is_available():
        out["trace"] = trace(torch, lambda: kernel(seed, w))
    del svc, rel, w, kept
    return out


def full_shape(torch, n, p, device):
    from repro_torch.data import gnp_graph
    from repro_torch.kernels import boolmm, minplus
    edges = gnp_graph(n, p, seed=0)
    wts = np.random.default_rng(8).integers(1, 10, len(edges))
    src = torch.from_numpy(edges[:, 0]).to(device)
    dst = torch.from_numpy(edges[:, 1]).to(device)
    adj = torch.zeros((n, n), dtype=torch.bool, device=device)
    adj[src, dst] = True
    w = torch.full((n, n), float("inf"), device=device)
    w[src, dst] = torch.from_numpy(wts.astype(np.float32)).to(device)
    got = minplus.minplus_matmul(w, w)
    for r0 in range(0, n, ROW_BLOCK):
        if not torch.equal(got[r0:r0 + ROW_BLOCK],
                           minplus.plain(w[r0:r0 + ROW_BLOCK], w)):
            raise SystemExit(f"K2 (M = n) != plain in rows {r0}..")
    del got
    if not torch.equal(boolmm.bool_matmul(adj, adj), boolmm.plain(adj, adj)):
        raise SystemExit("K1 (M = n) != plain")
    fin = torch.isfinite(w)
    ff = adj.float()
    return {"k2_ms": time_ms(torch, lambda: minplus.minplus_matmul(w, w), 3),
            "k2_bound_ms": bound_ms(torch, w, w, fin, fin, 12 * n * n,
                                    F32_OPS_S),
            "k1_ms": time_ms(torch, lambda: boolmm.bool_matmul(adj, adj), 3),
            "k1_bound_ms": bound_ms(torch, adj, adj, adj, adj, 3 * n * n,
                                    INT8_OPS_S),
            "k1_library_ms": time_ms(torch, lambda: ff @ ff, 3)}


def one(root, n, device):
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.data import dag_graph, gnp_graph
    from repro_torch.kernels import boolmm, minplus
    name = os.path.basename(root.rstrip("/")) or root
    out = {"root": root}

    def f32_matmul(f, a):
        ff, af = f.float(), a.float()
        return lambda: ff @ af

    t0 = time.perf_counter()
    out["lpath"] = dense_path(
        torch, "K2-max", LPATH, "lpath", dag_graph(n, 0.05, seed=0, max_w=9),
        n, EVERY, minplus.maxplus_frontier_matmul, minplus.plain_max,
        torch.isfinite, 4, F32_OPS_S, None, device)
    out["tc"] = dense_path(
        torch, "K1", TC, "tc", gnp_graph(n, 0.1, seed=0), n, 1,
        boolmm.bool_frontier_matmul, boolmm.plain, lambda x: x, 1,
        INT8_OPS_S, f32_matmul, device)
    out["full"] = full_shape(torch, n, 0.001 if n >= 1000 else 0.02, device)
    out["seconds"] = time.perf_counter() - t0
    for path in ("lpath", "tc"):
        for kname, kms in out[path].pop("trace", []):
            print(f"trace {name} {path}: {kms:.4f} ms {kname}", flush=True)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--one")
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.one:
        return one(a.one, a.n, a.device)
    if a.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("k12_ab: no CUDA device")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    for root in a.roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        os.path.abspath(root), "--n", str(a.n), "--device",
                        a.device], check=True)


if __name__ == "__main__":
    main()
