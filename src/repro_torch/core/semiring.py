"""Semirings: the carriers of aggregates-in-recursion, over torch tensors.

    bool   (∨, ∧)      -- TC / CC reachability (plain Datalog recursion)
    min-plus (min, +)  -- shortest paths, Example 2/3 of the paper
    max-plus (max, +)  -- longest paths / critical paths (DAGs, or clamped)
    plus-times (+, ×)  -- path counting, Example 5 (count/sum in recursion)

Port of ``repro.core.semiring``: the same names, zeros and routing table.
``Semiring.matmul`` is the plain ⊕.⊗ product (the CPU path and the oracle);
the CUDA kernels for the bool and min-plus carriers live in
``repro_torch.kernels`` and are reached through ``kernels.ops``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    zero: float | int | bool  # ⊕ identity == "no fact"
    one: float | int | bool  # ⊗ identity
    add: Callable[[Tensor, Tensor], Tensor]  # ⊕, the aggregate
    mul: Callable[[Tensor, Tensor], Tensor]  # ⊗, the join combine
    idempotent: bool  # ⊕ idempotent => extrema-style PreM aggregate
    dtype: torch.dtype

    def matmul(self, a: Tensor, b: Tensor, k_chunk: int = 64) -> Tensor:
        """Plain blocked ⊕.⊗ matrix product ``(m, k) x (k, n) -> (m, n)``.

        Tropical contractions stream K in chunks so the (m, k, n) broadcast
        never materializes (m·k_chunk·n elements at a time)."""
        if self.name == "bool":
            return (a.to(torch.float32) @ b.to(torch.float32)) > 0
        if self.name == "plus_times":
            return a @ b
        red = torch.amin if self.name == "min_plus" else torch.amax
        m, k = a.shape
        out = torch.full((m, b.shape[1]), self.zero, dtype=a.dtype,
                         device=a.device)
        for k0 in range(0, k, k_chunk):
            ak = a[:, k0:k0 + k_chunk]
            bk = b[k0:k0 + k_chunk]
            out = self.add(out, red(self.mul(ak[:, :, None], bk[None]), dim=1))
        return out


BOOL = Semiring(
    name="bool", zero=False, one=True,
    add=torch.logical_or, mul=torch.logical_and,
    idempotent=True, dtype=torch.bool,
)

MIN_PLUS = Semiring(
    name="min_plus", zero=float("inf"), one=0.0,
    add=torch.minimum, mul=torch.add,
    idempotent=True, dtype=torch.float32,
)

MAX_PLUS = Semiring(
    name="max_plus", zero=float("-inf"), one=0.0,
    add=torch.maximum, mul=torch.add,
    idempotent=True, dtype=torch.float32,
)

PLUS_TIMES = Semiring(
    name="plus_times", zero=0.0, one=1.0,
    add=torch.add, mul=torch.mul,
    idempotent=False, dtype=torch.float32,
)

BY_NAME = {s.name: s for s in (BOOL, MIN_PLUS, MAX_PLUS, PLUS_TIMES)}


class CarrierError(ValueError):
    """An unknown/unsupported lowering kind asked for a semiring carrier."""


#: frontier-lowering kind (magic.FrontierLowering.kind) -> semiring carrier.
AGG_TO_SEMIRING = {
    "bool": BOOL,
    "minplus": MIN_PLUS,
    "maxplus": MAX_PLUS,
    "plustimes": PLUS_TIMES,
}


def carrier_for(kind: str) -> Semiring:
    """Resolve a lowering kind to its semiring, raising a typed error on
    unknown kinds."""
    try:
        return AGG_TO_SEMIRING[kind]
    except KeyError:
        raise CarrierError(
            f"no semiring carrier for lowering kind {kind!r}; known kinds: "
            f"{sorted(AGG_TO_SEMIRING)}") from None


def edge_arity(kind: str) -> int:
    """EDB row arity for a lowering kind: (src, dst) on the boolean carrier,
    (src, dst, weight) on every weighted one."""
    return 2 if carrier_for(kind) is BOOL else 3


#: aggregate name (as written in rule heads) -> semiring that carries it
AGGREGATE_SEMIRING = {
    "min": MIN_PLUS,
    "max": MAX_PLUS,
    "count": PLUS_TIMES,
    "sum": PLUS_TIMES,
    "mcount": PLUS_TIMES,
    "msum": PLUS_TIMES,
    None: BOOL,
}
