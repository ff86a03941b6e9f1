#!/usr/bin/env python3
"""Time the EDB row dedupe at the size of the smoke's CSR CPATH relation.

    python3 scripts/probe_unique.py

For 13,166,328 rows of (src, dst, weight) in a 20-bit domain, random and
then sorted, prints the time of ``repro_torch.core.query.unique_rows``, of
``np.unique`` over the packed int64 keys, and of a plain sort of those keys,
with numpy's version.  ``unique_rows`` dedupes every EDB relation when a
service loads it and, again, the arcs of every additive (``sum<>``) carrier
it packs, so its time lands in service start-up and in cold batches.
"""
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.core.query import unique_rows  # noqa: E402

M, BITS = 13_166_328, 20


def main():
    print("numpy", np.__version__, flush=True)
    rng = np.random.default_rng(0)
    v = np.stack([rng.integers(0, 1 << BITS, M), rng.integers(0, 1 << BITS, M),
                  np.ones(M, np.int64)], 1)
    for name, a in (("random", v), ("sorted", unique_rows(v, BITS))):
        key = (a[:, 0] << 2 * BITS) | (a[:, 1] << BITS) | a[:, 2]
        t0 = time.perf_counter()
        unique_rows(a, BITS)
        t1 = time.perf_counter()
        np.unique(key)
        t2 = time.perf_counter()
        np.sort(key)
        t3 = time.perf_counter()
        print(f"{name}: unique_rows {t1 - t0:.2f} s, np.unique(keys) "
              f"{t2 - t1:.2f} s, np.sort(keys) {t3 - t2:.2f} s", flush=True)


if __name__ == "__main__":
    main()
