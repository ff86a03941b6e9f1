"""Train and serve steps around ``Model``.

``make_train_step``: loss -> gradients -> AdamW, with optional gradient
accumulation over consecutive row blocks of the batch (JAX's microbatch
scan) and an optional ``grad_transform`` (``compress.py``).  The forward
runs K9 and K10, the backward K9-bwd and K10-bwd (``kernels.ops``).
``make_serve_step``: one greedy decode step (token in, token out) around
``Model.decode_step``; ``make_prefill_step``: the full-sequence forward
returning the last position's logits.  The model holds its parameters, so
the JAX steps' ``params`` argument is gone.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from ..models.model import Model
from .optim import AdamWConfig, adamw_init, adamw_update


@contextlib.contextmanager
def trainable(model: Model):
    """``model``'s parameters require gradients inside the block only (they
    are registered without, so serving records nothing)."""
    params = list(model.parameters())
    before = [p.requires_grad for p in params]
    try:
        for p in params:
            p.requires_grad_(True)
        yield
    finally:
        for p, r in zip(params, before):
            p.requires_grad_(r)


def make_train_step(model: Model, opt_cfg: AdamWConfig, accum_steps: int = 1,
                    grad_transform: Callable | None = None):
    """train_step(opt_state, batch) -> (opt_state, metrics).

    ``batch`` holds arrays or tensors (``tokens``, ``labels``, optionally
    ``mask``), moved to the model's device.  With ``accum_steps`` > 1,
    microbatch ``i`` is rows ``[i·mb, (i+1)·mb)``; the gradients are summed
    in f32 and divided by ``accum_steps``, and the loss is the microbatches'
    mean; a batch that ``accum_steps`` does not divide raises
    ``ValueError``, as JAX's reshape does.  ``metrics`` holds ``loss``, ``grad_norm`` and ``step`` as
    tensors on the device (nothing is read back to the host).  Parameters
    and ``opt_state`` are updated in place; the gradients are freed."""
    params = dict(model.named_parameters())

    def train_step(opt_state: dict, batch: dict):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        rows = batch["tokens"].shape[0]
        if rows % accum_steps:
            raise ValueError(f"accum_steps {accum_steps} does not divide "
                             f"the batch's {rows} rows")
        mb = rows // accum_steps
        losses = []
        with trainable(model):
            for p in params.values():
                p.grad = None
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss = model.loss(micro)
                loss.backward()
                losses.append(loss.detach())
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
        if accum_steps > 1:
            grads = {k: g.div_(accum_steps) for k, g in grads.items()}
            loss = torch.stack(losses).mean()
        else:
            loss = losses[0]
        if grad_transform is not None:
            grads = grad_transform(grads)
        _, opt_state, gnorm = adamw_update(opt_cfg, params, grads, opt_state)
        del grads
        return opt_state, {"loss": loss, "grad_norm": gnorm,
                           "step": opt_state["step"]}

    return train_step


def make_serve_step(model: Model):
    """serve_step(cache, tokens (b,), pos) -> (next_tokens, logits, cache)."""

    @torch.inference_mode()
    def serve_step(cache, tokens, pos):
        logits, cache = model.decode_step(cache, tokens, pos)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, cache

    return serve_step


def make_prefill_step(model: Model):
    """prefill(batch) -> last-position logits (b, V)."""

    @torch.inference_mode()
    def prefill(batch):
        logits, _ = model.forward(batch)
        return logits[:, -1, :]

    return prefill


def init_optimizer(model: Model) -> dict:
    """AdamW's state for ``model``'s parameters (:func:`adamw_init`)."""
    return adamw_init(dict(model.named_parameters()))
