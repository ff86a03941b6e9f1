"""Serving launcher: batched greedy decoding with KV caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
        --batch 4 --gen 16 [--device cpu]

The JAX package's ``launch/serve.py`` with one more flag: ``--device``
(``cuda`` by default; ``cpu`` runs the kernels' plain versions).  As there,
``--smoke`` is the default; ``--no-smoke`` serves the published size.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.train import make_serve_step


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, prompts: torch.Tensor, gen: int) -> dict:
    """Feed ``prompts`` (b, p) token by token through
    ``make_serve_step(model)``, then decode ``gen`` greedy tokens.

    Returns the generated tokens (b, gen), the logits of every step (b, p +
    gen, V; step ``p - 1`` is the prompt's last position) and the seconds
    the ``gen`` steps took (synced)."""
    serve = make_serve_step(model)
    b, plen = prompts.shape
    cache = model.init_cache(b, plen + gen)
    logits = []
    for t in range(plen):
        tok, step_logits, cache = serve(cache, prompts[:, t], t)
        logits.append(step_logits)
    outs = []
    sync(model.device)
    t0 = time.perf_counter()
    for t in range(plen, plen + gen):
        tok, step_logits, cache = serve(cache, tok, t)
        outs.append(tok)
        logits.append(step_logits)
    sync(model.device)
    seconds = time.perf_counter() - t0
    return {"tokens": torch.stack(outs, 1), "logits": torch.stack(logits, 1),
            "seconds": seconds}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True, help="the config's smoke size (--no-smoke: "
                    "its published size)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    if not cfg.supports_decode:
        raise SystemExit(f"{args.arch} is encoder-only (no decode step)")
    model = Model(cfg, tp=1, use_chunked_attn=False, remat=False,
                  device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))).to(
            model.device)
    out = generate(model, prompts, args.gen)
    dt = out["seconds"]
    print(f"{args.arch}: {args.gen} tokens x {args.batch} seqs in "
          f"{dt*1e3:.0f} ms")
    print("first sequence:", out["tokens"][0].tolist())


if __name__ == "__main__":
    main()
