"""Hardware model for roofline bounds: the ``HW`` record of
``repro.roofline.report`` with an NVIDIA H100 entry in place of the TPU's.

The H100 numbers are NVIDIA's data-sheet peaks for the SXM part at its
700 W power limit (``nvidia-smi --query-gpu=name,power.limit``): HBM3 at
3.35 TB/s, 80 GB of it, and f32 outside the tensor cores at 67 TFLOP/s —
the rate the CSR segment steps run at, since they use no tensor cores.
``link_bw`` is NVLink's 450 GB/s each way.  A card set below 700 W runs
slower than these peaks under load.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 67e12  # f32, no tensor cores
    hbm_bw: float = 3.35e12
    link_bw: float = 450e9
    hbm_bytes: float = 80e9


H100 = HW()
