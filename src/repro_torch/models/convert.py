"""Carry the JAX package's parameters and decode caches across to the port.

The JAX model stacks each pattern slot's parameters on a leading group axis
(``params["groups"]["i:type"]``, leaves of shape ``(G, ...)``) and keeps the
tail's blocks apart (``params["tail"]["i:type"]``); the port's ``Model``
holds one block a layer, in layer order (group ``g``'s slot ``i`` is layer
``g * len(pattern) + i``, tail block ``i`` is layer ``G * len(pattern) +
i``).  The caller hands over the JAX trees as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, tree)``); nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; bf16 arrays (ml_dtypes)
    pass through f32, which holds every bf16 value exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


def _per_layer(tree: dict, model) -> list[dict]:
    """The ``groups``/``tail`` subtrees of a JAX params or cache tree as one
    flat dict of numpy leaves a layer, in the port's layer order."""
    cfg = model.cfg
    P, G = len(cfg.pattern), cfg.n_groups
    layers: list[dict] = [{} for _ in range(G * P + len(cfg.tail))]
    for i, lt in enumerate(cfg.pattern):
        for name, leaf in _flatten(tree["groups"][f"{i}:{lt}"]).items():
            leaf = np.asarray(leaf)
            for g in range(G):
                layers[g * P + i][name] = leaf[g]
    for i, lt in enumerate(cfg.tail):
        layers[G * P + i] = _flatten(tree["tail"][f"{i}:{lt}"])
    return layers


def params_from_jax(tree: dict, model) -> dict[str, torch.Tensor]:
    """The JAX parameter tree of ``model``'s config as the port's
    parameters: a state dict on the model's device, for
    ``model.load_state_dict``.  Raises when a name or shape disagrees."""
    flat = {k: v for k, v in _flatten(tree).items()
            if not k.startswith(("groups.", "tail."))}
    for idx, layer in enumerate(_per_layer(tree, model)):
        flat.update({f"layers.{idx}.{k}": v for k, v in layer.items()})
    want = model.state_dict()
    if set(flat) != set(want):
        raise ValueError(f"params_from_jax: names differ; JAX only "
                         f"{sorted(set(flat) - set(want))}, port only "
                         f"{sorted(set(want) - set(flat))}")
    out = {}
    for name, leaf in flat.items():
        t = _tensor(leaf, model.device)
        if t.shape != want[name].shape:
            raise ValueError(f"params_from_jax: {name} is {tuple(t.shape)} "
                             f"in JAX, {tuple(want[name].shape)} here")
        out[name] = t.to(want[name].dtype)
    return out


def cache_from_jax(tree: dict, model) -> list[dict]:
    """A JAX decode cache (``Model.init_cache`` and ``decode_step``'s) as
    the port's: one dict of tensors a layer, in layer order."""
    return [{k: _tensor(v, model.device) for k, v in layer.items()}
            for layer in _per_layer(tree, model)]


def opt_state_from_jax(state: dict, model) -> dict:
    """A JAX AdamW state (``adamw_init``/``adamw_update``'s ``{"m", "v",
    "step"}``, ``m`` and ``v`` shaped like the params tree) as the port's:
    ``m`` and ``v`` keyed like ``model.named_parameters()`` (through
    :func:`params_from_jax`'s layout), f32, and ``step`` a 0-d int32
    tensor, all on the model's device."""
    names = [name for name, _ in model.named_parameters()]
    out = {}
    for k in ("m", "v"):
        tree = params_from_jax(state[k], model)
        out[k] = {name: tree[name].to(torch.float32) for name in names}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=model.device)
    return out
