"""Worker meshes for the Datalog distributed plans (port of
``repro.launch.mesh``).

``make_worker_mesh`` builds the 1-D :class:`~repro_torch.core.distributed.
WorkerMesh` that ``core.distributed`` and ``DatalogService(mesh=...)`` run
on: one shard per card by default, or shards that share a device
(``devices=["cuda:0"] * k`` runs a k-shard mesh on one card,
``devices=["cpu"] * k`` k shards on the CPU).  The LM's production mesh is not
ported yet.
"""
from __future__ import annotations

import torch

from ..core.distributed import WorkerMesh


def make_production_mesh(*, multi_pod: bool = False):
    """The 256-chip TPU LM mesh of the JAX package: not ported."""
    raise NotImplementedError("make_production_mesh is not ported to "
                              "repro_torch yet (ROADMAP A.9)")


def make_worker_mesh(n_workers: int, axis: str = "data", *,
                     devices=None) -> WorkerMesh:
    """1-D mesh for the Datalog distributed plans / scale-out runs.

    No argument: ``cuda:0`` … ``cuda:{n-1}``, raising, as JAX's
    ``make_mesh`` does, when fewer cards are present.  ``devices=`` names
    each shard's device (a device may repeat)."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_workers:
            raise ValueError(
                f"a worker mesh of {n_workers} cards needs {n_workers} CUDA "
                f"devices, this host has {have}; pass devices=[...] (e.g. "
                f"['cuda:0'] * {n_workers}, shards sharing one card, or "
                f"['cpu'] * {n_workers})")
        devices = [f"cuda:{i}" for i in range(n_workers)]
    if len(devices) != n_workers:
        raise ValueError(f"{len(devices)} devices for {n_workers} workers")
    return WorkerMesh(devices, (axis,))
