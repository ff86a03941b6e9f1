"""The RG-LRU recurrent block (RecurrentGemma/Griffin) in PyTorch.

The JAX package's ``models/recurrent.py`` (its RG-LRU half) with its names
and arguments.  A full sequence runs the gated linear recurrence
``h_t = a_t ⊙ h_{t-1} + b_t`` through K10 (``kernels.ops.rglru``, the
Pallas kernel's counterpart); a decode step carries ``h`` and the causal
convolution's last inputs explicitly (O(1) state a token).  mLSTM and sLSTM
wait for their slice (ROADMAP A.8).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import DEFAULT_COMPUTE, Params, dense_init


@dataclasses.dataclass(frozen=True)
class RglruSpec:
    d_model: int
    d_rnn: int  # lru width (RecurrentGemma: ~d_model)
    conv_width: int = 4
    c: float = 8.0  # gate sharpness constant from the paper


def _lam_init(generator: torch.Generator, w: int) -> torch.Tensor:
    # a parameterized via Λ in (0.9, 0.999): a = exp(-c * softplus(λ))
    return 0.2 + 0.7 * torch.rand((w,), generator=generator,
                                  device=generator.device, dtype=torch.float32)


def _conv_init(generator: torch.Generator, cw: int, w: int) -> torch.Tensor:
    return torch.randn((cw, w), generator=generator, device=generator.device,
                       dtype=torch.float32) * 0.1


class RGLRU(Params):
    """The parameters of an RG-LRU block (the JAX ``rglru_init``)."""

    def __init__(self, spec: RglruSpec, device=None):
        super().__init__()
        d, w = spec.d_model, spec.d_rnn
        self.add("w_x", (d, w), device, dense_init)
        self.add("w_y", (d, w), device, dense_init)  # gate branch
        self.add("conv", (spec.conv_width, w), device, _conv_init)
        self.add("w_a", (w, w), device, dense_init)  # recurrence gate proj
        self.add("w_i", (w, w), device, dense_init)  # input gate proj
        self.add("lam", (w,), device, _lam_init)
        self.add("w_out", (w, d), device, dense_init)


def _rglru_gates(params, x: torch.Tensor, spec: RglruSpec):
    """Per-step decay a_t (0..1) and gated input; x: (b, s, w)."""
    r = torch.sigmoid((x @ params["w_a"].to(x.dtype)).to(torch.float32))
    i = torch.sigmoid((x @ params["w_i"].to(x.dtype)).to(torch.float32))
    log_a = -spec.c * r * F.softplus(params["lam"])  # (b, s, w)
    a = torch.exp(log_a)
    # maximum, not clamp: at the floor JAX's max sends half the gradient
    # each way, as torch.maximum does (clamp would send all of it)
    mult = torch.sqrt(torch.maximum(1.0 - torch.exp(2.0 * log_a),
                                    log_a.new_tensor(1e-6)))
    b = mult * i * x.to(torch.float32)
    return a, b


def _causal_conv(params, x: torch.Tensor, width: int) -> torch.Tensor:
    """Depthwise causal conv over time. x: (b, s, w)."""
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for t in range(width):
        out = out + xp[:, t: t + x.shape[1], :].to(torch.float32) * \
            params["conv"][t]
    return out.to(x.dtype)


def rglru_seq(params, spec: RglruSpec, x: torch.Tensor,
              compute=DEFAULT_COMPUTE) -> torch.Tensor:
    """Full-sequence RG-LRU block. x: (b, s, d_model) -> (b, s, d_model).

    The scan is K10 (``ops.rglru``), differentiable through K10-bwd."""
    gate = F.gelu((x @ params["w_y"].to(compute)).to(torch.float32),
                  approximate="tanh")
    h = x @ params["w_x"].to(compute)
    h = _causal_conv(params, h, spec.conv_width)
    a, b = _rglru_gates(params, h, spec)
    hs = ops.rglru(a, b)
    y = hs * gate
    return y.to(compute) @ params["w_out"].to(compute)


def rglru_step(params, spec: RglruSpec, x: torch.Tensor, state: dict,
               compute=DEFAULT_COMPUTE):
    """Single decode step. x: (b, 1, d); state: {'h': (b,w), 'conv':
    (b,cw-1,w)}.  Returns ``(out, new_state)``; ``state`` is not changed."""
    gate = F.gelu((x @ params["w_y"].to(compute)).to(torch.float32),
                  approximate="tanh")
    u = x @ params["w_x"].to(compute)  # (b, 1, w)
    window = torch.cat([state["conv"], u.to(torch.float32)], dim=1)  # (b,cw,w)
    conv = torch.einsum("btw,tw->bw", window, params["conv"])[:, None, :]
    a, b = _rglru_gates(params, conv.to(compute), spec)
    h = a[:, 0] * state["h"] + b[:, 0]  # (b, w)
    y = h[:, None, :] * gate
    out = y.to(compute) @ params["w_out"].to(compute)
    return out, {"h": h, "conv": window[:, 1:, :]}


def rglru_state_init(batch: int, spec: RglruSpec, device=None) -> dict:
    return {"h": torch.zeros((batch, spec.d_rnn), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, spec.conv_width - 1, spec.d_rnn),
                                dtype=torch.float32, device=device)}
