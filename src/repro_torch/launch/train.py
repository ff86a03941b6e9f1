"""Training launcher: an LM config (smoke or full) through the
fault-tolerant driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \
        --steps 50 --batch 8 --seq 64 [--device cpu]

The JAX package's ``launch/train.py`` with one more flag: ``--device``
(``cuda`` by default; ``cpu`` runs the kernels' plain versions).  As there,
``--smoke`` is the default (``--no-smoke``: the published size).  The
checkpoints go to ``--ckpt-dir``, by default under the temporary directory.
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.model import Model
from repro_torch.runtime import (DriverConfig, TrainDriver, run_with_restarts,
                                 use_deterministic_cublas)
from repro_torch.train import AdamWConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True, help="the config's smoke size (--no-smoke: "
                    "its published size)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    use_deterministic_cublas()  # before CUDA starts (the driver's mode)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.input_kind != "tokens":
        raise SystemExit(f"{args.arch}: use examples/ for frames/vlm pipelines")
    model = Model(cfg, tp=1, use_chunked_attn=False, remat=False,
                  device=args.device)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=0)
    opt = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    dcfg = DriverConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                        max_steps=args.steps, log_every=10)

    driver = run_with_restarts(
        lambda: TrainDriver(model, opt, pipe, dcfg), args.steps)
    print(f"finished at step {driver.step}; "
          f"final loss {driver.metrics_log[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
