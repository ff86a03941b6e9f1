"""End-to-end training on the PyTorch port: a small LM on the synthetic
corpus with the full runtime (async checkpoints, failure injection and
restart, straggler logging, deterministic data), as
``examples/train_lm.py`` does with the JAX package.

Defaults train a ~100M-parameter model for 300 steps.  ``--preset demo``
runs a ~5M model for 120 steps and shows the loss dropping and a mid-run
injected failure with a bit-exact resume.  Runs on the card unless
``--device cpu`` is given (the kernels' plain versions).

Usage:
  PYTHONPATH=src python examples/train_lm_torch.py --preset demo [--device cpu]
  PYTHONPATH=src python examples/train_lm_torch.py --dim 768 --layers 12 --steps 300
"""
import argparse
import os
import tempfile

from repro_torch.configs.base import ArchConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.model import Model
from repro_torch.runtime import (DriverConfig, TrainDriver, run_with_restarts,
                                 use_deterministic_cublas)
from repro_torch.train import AdamWConfig


def make_config(dim: int, layers: int, vocab: int) -> ArchConfig:
    return ArchConfig(
        name=f"lm-{dim}x{layers}", family="dense",
        n_layers=layers, d_model=dim, n_heads=max(dim // 64, 1),
        n_kv_heads=max(dim // 128, 1), d_ff=dim * 4, vocab=vocab,
        head_dim=64, pattern=("attn",), act="silu", tie_embeddings=True,
    )


#: the presets' (dim, layers, vocab, steps, batch, seq); None keeps a flag
PRESETS = {"demo": (256, 4, 2048, 120, 8, 128),
           "100m": (768, 12, 32768, None, None, None)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "train_lm_torch_ckpt"))
    ap.add_argument("--inject-failure", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    use_deterministic_cublas()  # before CUDA starts (the driver's mode)

    if args.preset:
        names = ("dim", "layers", "vocab", "steps", "batch", "seq")
        for name, value in zip(names, PRESETS[args.preset]):
            if value is not None:
                setattr(args, name, value)

    cfg = make_config(args.dim, args.layers, args.vocab)
    model = Model(cfg, tp=1, use_chunked_attn=False, remat=False,
                  device=args.device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params on {model.device}")

    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=17)
    opt = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    fail_at = (args.steps // 2,) if args.inject_failure else ()
    dcfg = DriverConfig(ckpt_dir=args.ckpt_dir, ckpt_every=25,
                        max_steps=args.steps, fail_at_steps=fail_at,
                        log_every=10)

    def mk():
        return TrainDriver(model, opt, pipe, dcfg, seed=0)

    driver = run_with_restarts(mk, args.steps)
    first = driver.metrics_log[0]["loss"] if driver.metrics_log else float("nan")
    last = driver.metrics_log[-1]["loss"]
    print(f"done: step {driver.step}, loss {first:.3f} -> {last:.3f}, "
          f"stragglers logged: {len(driver.straggler_events)}")
    return driver


if __name__ == "__main__":
    main()
