"""Fault-tolerant training driver (port of ``repro.runtime.driver``).

* **checkpoint/restart** — async sharded checkpoints every K steps
  (``checkpoint.store``); on a crash the driver restores the latest complete
  checkpoint and *replays the data stream deterministically* (the pipeline
  is a pure function of the batch index, which the checkpoint records), so a
  restarted run is bit-identical to an uninterrupted one on the same device.
  On the card that needs deterministic kernels: the embedding gather's and
  the loss's backward accumulate with float atomics otherwise, so the steps
  run under ``torch.use_deterministic_algorithms(True)``, which on the card
  needs ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts
  (:func:`use_deterministic_cublas`).  K9-bwd and K10-bwd are deterministic
  by construction.
* **failure injection** — ``SimulatedFailure`` raised at configured steps;
  ``run_with_restarts`` is the supervisor loop (restore, resume, bounded
  retries).
* **straggler detection** — per-step wall-time EMA; steps slower than
  ``straggler_slack ×`` EMA are logged and counted.  A step's time ends when
  its loss reaches the host (``loss.item()``, where JAX blocks until
  ready).
* **elastic re-shard** — ``TrainDriver.reshard`` re-partitions the same
  global data stream over a new host count; checkpoints hold whole tensors,
  so scale-down is a restore.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from ..checkpoint import AsyncCheckpointer, latest_step, load_checkpoint
from ..data.tokens import TokenPipeline
from ..models.model import Model
from ..train import AdamWConfig, init_optimizer, make_train_step


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class DriverConfig:
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    n_ckpt_shards: int = 4
    max_steps: int = 200
    straggler_slack: float = 2.5
    ema_decay: float = 0.9
    fail_at_steps: tuple[int, ...] = ()  # failure injection
    log_every: int = 10


#: the cuBLAS workspace setting PyTorch's deterministic mode asks for.
#: PyTorch reads ``CUBLAS_WORKSPACE_CONFIG`` once, when it first uses cuBLAS,
#: so it must be in the environment before the process's first GEMM on the
#: card: the entry points (``launch.train``, ``examples/train_lm_torch.py``)
#: set it with :func:`use_deterministic_cublas` before any CUDA work.  Set
#: later, it only quiets PyTorch's check.  A deterministic run on the card
#: whose environment lacks it fails at its first GEMM with PyTorch's error.
CUBLAS_DETERMINISTIC = ":4096:8"


def use_deterministic_cublas() -> None:
    """Put :data:`CUBLAS_DETERMINISTIC` in the environment unless the
    caller set ``CUBLAS_WORKSPACE_CONFIG``; call it before CUDA starts."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_DETERMINISTIC)


@contextlib.contextmanager
def deterministic_algorithms(enabled: bool = True):
    """``torch.use_deterministic_algorithms(enabled)`` inside the block,
    restored after.  It leaves the environment alone: see
    :data:`CUBLAS_DETERMINISTIC`."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(enabled)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


class TrainDriver:
    def __init__(self, model: Model, opt_cfg: AdamWConfig,
                 pipeline: TokenPipeline, cfg: DriverConfig, params=None,
                 seed: int = 0, grad_transform: Callable | None = None,
                 step_fn: Callable | None = None):
        """``params``: a state dict to start from; else the model is drawn
        from ``seed`` (on its device).  ``step_fn(opt_state, batch) ->
        (opt_state, metrics)`` defaults to ``make_train_step``'s."""
        self.model = model
        self.opt_cfg = opt_cfg
        self.pipeline = pipeline
        self.cfg = cfg
        self.step_fn = step_fn or make_train_step(
            model, opt_cfg, grad_transform=grad_transform)
        if params is not None:
            model.load_state_dict(params)
        else:
            model.init(torch.Generator(device=model.device).manual_seed(seed))
        self.opt_state = init_optimizer(model)
        self.step = 0
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir, cfg.n_ckpt_shards)
        self.metrics_log: list[dict] = []
        self.straggler_events: list[dict] = []
        self._ema = None

    # -- checkpoint/restore ---------------------------------------------------

    def _state(self):
        return {"params": dict(self.model.named_parameters()),
                "opt": self.opt_state, "step": np.int64(self.step)}

    def try_restore(self) -> bool:
        if latest_step(self.cfg.ckpt_dir) is None:
            return False
        state, _ = load_checkpoint(self.cfg.ckpt_dir, self._state())
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(state["params"][name])
        self.opt_state = state["opt"]
        self.step = int(state["step"])
        return True

    # -- main loop --------------------------------------------------------------

    def run(self, n_steps: int | None = None) -> list[dict]:
        target = min(self.cfg.max_steps,
                     self.step + (n_steps or self.cfg.max_steps))
        with deterministic_algorithms():
            while self.step < target:
                if self.step in self.cfg.fail_at_steps and self.step > 0:
                    # consume the injection so the retry doesn't loop forever
                    self.cfg = dataclasses.replace(
                        self.cfg,
                        fail_at_steps=tuple(s for s in self.cfg.fail_at_steps
                                            if s != self.step))
                    raise SimulatedFailure(
                        f"injected failure at step {self.step}")
                batch = self.pipeline.batch(self.step)
                t0 = time.perf_counter()
                self.opt_state, metrics = self.step_fn(self.opt_state, batch)
                loss = metrics["loss"].item()  # the step's sync
                dt = time.perf_counter() - t0
                self._track_straggler(dt)
                self.step += 1
                rec = {"step": self.step, "loss": loss,
                       "grad_norm": float(metrics["grad_norm"]), "dt": dt}
                self.metrics_log.append(rec)
                if self.step % self.cfg.log_every == 0:
                    print(f"[driver] step {self.step} loss {rec['loss']:.4f} "
                          f"({dt*1e3:.0f} ms)", flush=True)
                if self.step % self.cfg.ckpt_every == 0:
                    self.ckpt.save(self.step, self._state())
        self.ckpt.wait()
        return self.metrics_log

    def _track_straggler(self, dt: float):
        if self._ema is None or self.step < 2:
            # warm-up: the first steps build the kernels and warm caches
            self._ema = dt
            return
        if dt > self.cfg.straggler_slack * self._ema:
            self.straggler_events.append({"step": self.step, "dt": dt,
                                          "ema": self._ema})
            print(f"[driver] straggler: step {self.step} took {dt*1e3:.0f}ms "
                  f"(ema {self._ema*1e3:.0f}ms)", flush=True)
        self._ema = self.cfg.ema_decay * self._ema + (1 - self.cfg.ema_decay) * dt

    # -- elastic re-shard ----------------------------------------------------------

    def reshard(self, n_hosts: int, host_id: int = 0):
        """Elastic rescale: same global stream, new host partitioning.

        Checkpoints are host-count independent (whole tensors per leaf), so
        the driver just rebuilds the pipeline shard and continues.
        """
        self.pipeline = dataclasses.replace(
            self.pipeline, n_hosts=n_hosts, host_id=host_id)


def run_with_restarts(make_driver: Callable[[], TrainDriver],
                      n_steps: int, max_restarts: int = 5) -> TrainDriver:
    """Supervisor loop: run, and on failure restore-from-checkpoint + resume."""
    restarts = 0
    driver = make_driver()
    while True:
        try:
            driver.run(n_steps - driver.step)
            return driver
        except SimulatedFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError("restart budget exhausted") from e
            print(f"[supervisor] {e}; restart #{restarts}", flush=True)
            cfg = driver.cfg
            driver.ckpt.close()
            driver = make_driver()
            driver.cfg = cfg  # carry the consumed failure schedule forward
            driver.try_restore()
