"""Batched greedy serving with KV caches on the PyTorch port (prefill by
stepping the decoder, then a decode loop), as ``examples/serve_lm.py``
does with the JAX package.

Serves a smoke-scale model: the dense cache, the ring-buffer local cache
and the recurrent state all ride the same decode path.  Runs on the card
unless ``--device cpu`` is given.

Usage:  PYTHONPATH=src python examples/serve_lm_torch.py [--arch recurrentgemma-2b] [--device cpu]
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    assert cfg.supports_decode, f"{args.arch} is encoder-only"
    model = Model(cfg, tp=1, use_chunked_attn=False, remat=False,
                  device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    serve = make_serve_step(model)

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len))).to(model.device)
    max_len = args.prompt_len + args.gen
    cache = model.init_cache(args.batch, max_len)

    # prefill by stepping the decoder (teacher-forcing the prompt)
    t0 = time.perf_counter()
    for t in range(args.prompt_len):
        nxt, _, cache = serve(cache, prompts[:, t], t)
    sync(model.device)
    prefill_s = time.perf_counter() - t0

    out = []
    tok = nxt
    t0 = time.perf_counter()
    for t in range(args.prompt_len, max_len):
        tok, logits, cache = serve(cache, tok, t)
        out.append(tok)
    sync(model.device)
    decode_s = time.perf_counter() - t0
    gen = torch.stack(out, dim=1).cpu().numpy()
    print(f"arch={cfg.name} batch={args.batch} device={model.device}")
    print(f"prefill {args.prompt_len} tokens: {prefill_s*1e3:.0f} ms; "
          f"decode {args.gen} tokens: {decode_s*1e3:.0f} ms "
          f"({args.gen*args.batch/decode_s:.1f} tok/s)")
    print("generated token ids (first sequence):", gen[0].tolist())
    return gen


if __name__ == "__main__":
    main()
