#!/usr/bin/env python3
"""Build K9 (``flash_attention``) and check it on one card, without the rest
of ``chip_smoke.py``.

    python3 scripts/k9_check.py [--no-grid] [--ab ROOT ...]

1. compiles ``csrc/flash_attention.cu`` with ``-Xptxas -v`` and prints the
   registers, shared memory and spills of each kernel;
2. runs ``chip_smoke.k9_ragged_parity`` (every case of the ``K9_*`` grids:
   bf16 on the tensor-core kernel, f32 on the CUDA-core one, each within
   ``chip_smoke.flash_err``'s tolerance of the plain version); ``--no-grid``
   skips it;
3. runs ``chip_smoke._k9_at_path`` at the RecurrentGemma-2B prefill's K9
   shape (q (2, 10, 4096, 256), kv (2, 1, 4096, 256), bf16, causal, window
   2048, scale 1/16) on seeded random inputs (the model's own inputs come
   only from ``chip_smoke.py``'s phase 8): the check against the plain
   version, the kernel's, the plain version's and
   ``scaled_dot_product_attention``'s CUDA-event times and the bound;
4. with ``--ab``, builds, checks and times ``flash_attention`` of each
   checkout ROOT at that shape in a process of its own, in the order given
   (A, B, B, A shows drift across the run), on the same seeded inputs: one
   JSON line per ROOT (ms, max abs error, the first ptxas lines of its
   build: registers and spills).

Prints the card's name and power limit first.  Fails on a host without CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the prefill's K9 call: q, kv shapes and keywords (``Model._attention``)
SHAPE_Q, SHAPE_KV = (2, 10, 4096, 256), (2, 1, 4096, 256)
KW = dict(causal=True, window=2048, softcap=None, scale=1 / 16)


def inputs(torch, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in (SHAPE_Q, SHAPE_KV, SHAPE_KV))


def time_root(root):
    """K9 of the checkout ``root`` at the path's shape: its build's
    registers and spills, its max abs error against the plain version
    (within ``chip_smoke.flash_err``'s tolerance) and its median CUDA-event
    ms over 3 rounds of 10 calls (``chip_smoke.time_ms``)."""
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    used = [line.split("info    :")[-1].strip()
            for line in build.build(["flash_attention"],
                                    verbose=True).splitlines()
            if "Used" in line or "spill stores" in line]
    q, k, v = inputs(torch)
    err = chip_smoke.flash_err(torch, fa.flash_attention(q, k, v, **KW),
                               fa.plain(q, k, v, **KW), v)
    ms = chip_smoke.time_ms(torch, lambda: fa.flash_attention(q, k, v, **KW),
                            10)
    print(json.dumps({"root": root, "ms": ms, "max_abs_err": err,
                      "ptxas": used[:4]}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--no-grid", action="store_true")
    ap.add_argument("--ab", nargs="*", default=[])
    ap.add_argument("--time-root", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_root:
        return time_root(args.time_root)
    sys.path.insert(0, HERE)
    import chip_smoke
    chip_smoke.check_device()
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    from repro_torch.kernels import build
    report = build.build(["flash_attention"], verbose=True)
    for line in report.splitlines():
        if "Compiling" in line or "Used" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    if not args.no_grid:
        chip_smoke.k9_ragged_parity()
    q, k, v = inputs(torch)
    chip_smoke._k9_at_path(torch, q, k, v, KW)
    del q, k, v
    torch.cuda.empty_cache()
    for root in args.ab:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--time-root", os.path.abspath(root)], check=True)


if __name__ == "__main__":
    main()
