"""AdamW and a cosine schedule, as the JAX package's ``train/optim.py``.

The optimizer state is ``{"m", "v", "step"}``: ``m`` and ``v`` keyed like
``model.named_parameters()``, f32, on the parameters' device; ``step`` a
0-d int32 tensor there too.  The update changes parameters and state in
place under ``no_grad`` (JAX returns new trees) and reads nothing back to
the host.  Weight decay applies to every leaf, as JAX's does.  This is
plain elementwise work, which JAX leaves to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor): linear warmup, then a
    cosine decay to ``min_lr_frac`` of ``lr``; f32, on ``step``'s device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def adamw_init(params: dict[str, torch.Tensor]) -> dict:
    """Zero moments for ``params`` (``{name: tensor}``) and step 0."""
    dev = next(iter(params.values())).device
    return {"m": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's squared sum,
    f32."""
    total = 0
    for x in tree.values():
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: dict):
    """One AdamW step in place, the gradients clipped by their global norm.
    Returns ``(params, state, grad_norm)``: the same dicts, updated."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = cosine_lr(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** sf
    b2c = 1 - cfg.b2 ** sf
    for name, p in params.items():
        # JAX's arithmetic in its order, in place where a temporary can go
        g = grads[name].to(torch.float32) * scale
        m, v = state["m"][name], state["v"][name]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        g2 = (1 - cfg.b2) * g
        v.mul_(cfg.b2).add_(g2.mul_(g))
        del g, g2
        delta = m / b1c
        den = (v / b2c).sqrt_().add_(cfg.eps)
        delta.div_(den).add_(cfg.weight_decay * p)
        del den
        p.sub_(lr * delta)
    state["step"] = step
    return params, state, gnorm
