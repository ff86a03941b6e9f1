"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: entry points run on ``cuda`` unless the caller
    asks for the CPU.  A CUDA request on a host without a usable GPU raises —
    nothing quietly runs on the CPU instead."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on CUDA by default, and this host "
            "has no usable GPU; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    return dev


def canonical_device(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` names the current card, so
    two spellings of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
