"""Serving steps around ``Model``.

``make_serve_step``: one greedy decode step (token in, token out) around
``Model.decode_step``; ``make_prefill_step``: the full-sequence forward
returning the last position's logits.  The model holds its parameters, so
the JAX steps' ``params`` argument is gone.  ``make_train_step`` and the
optimizer wait (ROADMAP A.7).
"""
from __future__ import annotations

import torch

from ..models.model import Model


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
