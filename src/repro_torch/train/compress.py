"""Gradient compression for the inter-pod hop (int8, stochastic rounding),
as the JAX package's ``train/compress.py``.

Int8 quantization with a per-tensor scale and stochastic rounding
(unbiased: E[dequant(quant(g))] = g), exposed as a ``grad_transform`` for
``make_train_step``.  Random draws come from an explicit
``torch.Generator`` (JAX's from a key): the two packages draw different
bits from one seed, so the tests compare the deterministic parts and the
distribution.  ``hierarchical_psum``, the two-level reduction across pods,
needs the sharded mesh of the port's ``parallel/`` (ROADMAP A.9).
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor, generator: torch.Generator
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor scale, stochastic rounding. Returns ``(q int8, scale)``;
    ``generator`` lives on ``x``'s device."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    y = xf / scale
    lo = torch.floor(y)
    p = y - lo  # probability of rounding up
    up = torch.rand(x.shape, generator=generator, device=x.device) < p
    q = torch.clamp(lo + up.to(torch.float32), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def make_int8_grad_transform(seed: int = 0):
    """grad_transform hook: quantize and dequantize every gradient (``{name:
    tensor}``, in order), drawing from a generator seeded with ``seed`` at
    each call (JAX splits the same key at each call)."""

    def transform(grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        if not grads:
            return grads
        dev = next(iter(grads.values())).device
        gen = torch.Generator(device=dev).manual_seed(seed)
        out = {}
        for name, leaf in grads.items():
            q, s = quantize_int8(leaf, gen)
            out[name] = dequantize_int8(q, s, leaf.dtype)
        return out

    return transform


def hierarchical_psum(x, *, intra_axes, pod_axis=None, compress=True,
                      key=None):
    """Reduce inside the pod at full precision, across pods compressed: a
    collective over the sharded LM mesh, which the port does not have yet."""
    raise NotImplementedError(
        "hierarchical_psum reduces over the sharded LM mesh of parallel/, "
        "which waits for ROADMAP A.9")
