#!/usr/bin/env python3
"""Trace and time K10 (``rglru_scan``, the RG-LRU recurrence) of two or more
checkouts of the port on one card, in one run, at the prefill's shape in
``chip_smoke.py`` (RecurrentGemma-2B: B = 2, S = 4,096, W = 2,560) and at
one prompt (B = 1).  The inputs are made on the card from a seed as the
RG-LRU gates make them (``models.recurrent._rglru_gates``: a =
exp(-8·r·softplus(λ)) in (0, 1), b = sqrt(1 - a²)·x), and every output is
held to the plain version exactly.

    python3 scripts/k10_ab.py ROOT_A ROOT_B ROOT_B ROOT_A [--stages 2,4,6]

Each ROOT is a checkout (its ``src/`` is imported, its kernels built under
its own ``build/``), run in a process of its own in the order given, so A,
B, B, A shows drift across the run.  Per ROOT and shape: the default
plan's median CUDA-event ms over 3 rounds of 20 calls beside the byte
bound (12 bytes a channel-step at 3.35 TB/s); where the checkout's
wrapper takes a ``plan``, every (channels, steps) of its ``PLANS`` at each
``--stages`` count that fits a block's shared memory, each run equal to
plain; and one call of the default plan traced with ``torch.profiler``
(its ``trace`` lines).  Prints the card's name and power limit first and
one JSON line per ROOT.  ``--batches``/``--seq``/``--width`` shrink the
shapes and ``--device cpu`` runs the plain versions, to rehearse the
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

HBM_BYTES_S = 3.35e12
#: shared memory a block may take on sm_90, and the kernel's barriers and
#: alignment room (``csrc/rglru_scan.cu``; its ring takes a stage more for
#: the h boxes)
MAX_SMEM, SMEM_EXTRA = 232448, 384


def sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_ms(torch, fn, calls=20, rounds=3):
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
    """Every device kernel one call of ``fn`` launches, as (name, ms)."""
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


def gates(torch, shape, device, seed):
    """(a, b) as ``_rglru_gates`` makes them, from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    lam = torch.randn(shape[-1], generator=g, device=device)
    r = torch.sigmoid(torch.randn(shape, generator=g, device=device))
    log_a = -8.0 * r * torch.nn.functional.softplus(lam)
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, mult * torch.randn(shape, generator=g, device=device)


def one(root, shapes, device, stages):
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.kernels import rglru_scan as rg
    out = {"root": root}
    label = os.path.basename(root.rstrip("/")) or root
    for si, shape in enumerate(shapes):
        a, b = gates(torch, shape, device, 23 + si)
        want = rg.plain(a, b)
        if not torch.equal(rg.rglru_scan(a, b), want):
            raise SystemExit(f"{root}: K10 != plain at {shape}")
        n = a.numel()
        row = {"ms": time_ms(torch, lambda: rg.rglru_scan(a, b)),
               "bound_ms": 12 * n / HBM_BYTES_S * 1e3}
        if hasattr(rg, "PLANS"):
            if device == "cuda":
                row["plan"] = [rg.CW, rg.T, rg.stages(shape[0], shape[2])]
                row["route"] = rg.route(a, b)
            row["sweep"] = {}
            for cw, t in rg.PLANS:
                for s in stages:
                    if SMEM_EXTRA + (s + 1) * 2 * t * cw * 4 > MAX_SMEM:
                        continue
                    plan = (cw, t, s)
                    if not torch.equal(rg.rglru_scan(a, b, plan=plan), want):
                        raise SystemExit(f"{root}: K10 plan {plan} != plain "
                                         f"at {shape}")
                    row["sweep"]["x".join(map(str, plan))] = time_ms(
                        torch, lambda: rg.rglru_scan(a, b, plan=plan))
        out["x".join(map(str, shape))] = row
        if device == "cuda":
            for ev, ms in trace(torch, lambda: rg.rglru_scan(a, b)):
                print(f"trace {label} {shape}: {ms:.4f} ms {ev}", flush=True)
        del a, b, want
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--one")
    ap.add_argument("--batches", default="2,1")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--width", type=int, default=2560)
    ap.add_argument("--stages", default="2,3,4,6,8")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    shapes = [(int(b), a.seq, a.width) for b in a.batches.split(",") if b]
    stages = [int(s) for s in a.stages.split(",") if s]
    if a.one:
        return one(a.one, shapes, a.device, stages)
    if a.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("k10_ab: no CUDA device")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    for root in a.roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        os.path.abspath(root), "--batches", a.batches,
                        "--seq", str(a.seq), "--width", str(a.width),
                        "--stages", a.stages, "--device", a.device],
                       check=True)


if __name__ == "__main__":
    main()
