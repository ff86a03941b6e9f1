"""Semi-naive dense fixpoints over torch tensors.

Port of the dense half of ``repro.core.seminaive``.  Each iteration is one
⊕.⊗ product (two for the nonlinear and sandwich forms), with semi-naive
evaluation realized as delta-row masking (idempotent ⊕) or delta
accumulation (additive ⊕).  ``lax.while_loop`` becomes a host loop: the
convergence test (``any(mask)``, or ``any(delta != 0)`` for the accumulate
form) syncs the host once per iteration, and the loop reproduces the JAX
loop's ``iterations`` and ``generated`` exactly.

The default ⊗ is ``kernels.ops.semiring_matmul``: the CUDA kernel (K1 for
bool, K2 for min-plus and max-plus) on a CUDA tensor, the plain version on a
CPU tensor.  The all-pairs front-ends (transitive closure, shortest paths,
same generation, connected components) and the single-source ones run on
it; the fused relaxation step K8 is reached through ``kernels.ops.relax``,
as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .semiring import BOOL, MIN_PLUS, PLUS_TIMES, Semiring

#: generated-fact accumulator dtype (int64, as in the x64 JAX run)
GEN_DTYPE = torch.int64
#: the largest count :data:`GEN_DTYPE` holds (the JAX package's ``GEN_MAX``)
GEN_MAX = torch.iinfo(GEN_DTYPE).max


@dataclasses.dataclass
class DenseResult:
    table: torch.Tensor  # fixpoint matrix / vector
    iterations: int  # loop trips
    generated: int  # facts produced before dedup (Tables 7/8)


def _ne(sr: Semiring, a, b):
    if sr.dtype == torch.bool:
        return a != b
    # inf-aware compare for tropical semirings
    return ~((a == b) | (torch.isinf(a) & torch.isinf(b)
                         & (torch.sign(a) == torch.sign(b))))


def _zero_like(sr: Semiring, D: torch.Tensor) -> torch.Tensor:
    return torch.tensor(sr.zero, dtype=D.dtype, device=D.device)


def fixpoint_dense(
    sr: Semiring,
    arc: torch.Tensor,
    init: torch.Tensor,
    form: str = "linear",
    matmul: Callable | None = None,
    max_iters: int | None = None,
) -> DenseResult:
    """Dense fixpoint over a semiring.

    form:
      'linear'      D <- D ⊕ (Δmask·D) ⊗ arc          (tc r2 / dpath r2')
      'nonlinear'   D <- D ⊕ D ⊗ D                    (dpath r5; log-depth;
                                                       semi-naive as
                                                       Δ⊗D ⊕ D⊗Δ)
      'vector'      d <- d ⊕ arcᵀ-propagate(d)        (CC label propagation;
                                                       a (B, n) init runs B
                                                       frontiers as one
                                                       batched fixpoint with
                                                       per-row convergence
                                                       masking)
      'sandwich'    S <- S ⊕ arcᵀ ⊗ (S ⊗ arc)         (same-generation)
      'accumulate'  C = Σ Δ;  Δ <- Δ ⊗ arc             (path counting, +,×)
    """
    if form not in ("linear", "nonlinear", "vector", "sandwich", "accumulate"):
        raise ValueError(form)
    if matmul is None:
        from ..kernels import ops
        matmul = ops.semiring_matmul(sr.name)
    # domain size is the LAST dim: a batched (B, n) vector init must iterate
    # to the domain's depth, not the batch's
    n = init.shape[-1]
    if max_iters is None:
        max_iters = 4 * n + 8
    zero = _zero_like(sr, init)

    if form == "accumulate":
        if sr.idempotent:
            raise ValueError("accumulate form is for additive semirings")
        total = delta = init
        it = 0
        gen = torch.zeros((), dtype=GEN_DTYPE, device=init.device)
        while it < max_iters and bool((delta != zero).any()):
            new = matmul(delta[None, :], arc)[0] if delta.ndim == 1 \
                else matmul(delta, arc)
            gen = gen + (new != zero).sum(dtype=GEN_DTYPE)
            total, delta = total + new, new
            it += 1
        return DenseResult(total, it, int(gen))

    # the sandwich form's arcᵀ, made contiguous once (the kernels take
    # contiguous operands; XLA hoists the JAX package's per-step transpose)
    arc_t = arc.T.contiguous() if form == "sandwich" else None

    def step(D, mask):
        rmask = mask if D.ndim == 1 else mask[:, None]
        Dm = torch.where(rmask, D, zero)
        if D.ndim == 1:  # vector form over a single frontier
            upd = matmul(Dm[None, :], arc)[0]
        elif form in ("linear", "vector"):
            upd = matmul(Dm, arc)
        elif form == "nonlinear":
            upd = sr.add(matmul(Dm, D), matmul(D, Dm))
        else:  # sandwich
            upd = matmul(arc_t, matmul(Dm, arc))
        return sr.add(D, upd), upd

    D = init
    mask = torch.ones(init.shape[:-1] if init.ndim > 1 else init.shape,
                      dtype=torch.bool, device=init.device)
    it = 0
    gen = torch.zeros((), dtype=GEN_DTYPE, device=init.device)
    while it < max_iters and bool(mask.any()):
        Dn, upd = step(D, mask)
        changed = _ne(sr, Dn, D)
        gen = gen + (upd != zero).sum(dtype=GEN_DTYPE)
        mask = changed.any(dim=-1) if D.ndim > 1 else changed
        D = Dn
        it += 1
    return DenseResult(D, it, int(gen))


def fixpoint_dense_cached(
    sr: Semiring,
    arc: torch.Tensor,
    init: torch.Tensor,
    form: str = "linear",
    matmul: Callable | None = None,
    max_iters: int | None = None,
) -> DenseResult:
    """:func:`fixpoint_dense` with the JAX cached twin's signature.  There is
    no jit to cache; ``max_iters`` resolves here (``4n + 8`` over the domain
    size) exactly as the JAX twin resolves it."""
    if max_iters is None:
        max_iters = 4 * init.shape[-1] + 8
    return fixpoint_dense(sr, arc, init, form=form, matmul=matmul,
                          max_iters=max_iters)


# additive-⊕ termination -------------------------------------------------------
# Idempotent carriers converge unconditionally; the additive (+,×) carrier
# only terminates when the program is acyclic (paper §2.1's count/sum
# termination discussion).  Additive fixpoints run under a tight iteration
# bound and the caller checks it afterwards, as in the JAX package.


class FixpointDivergenceError(RuntimeError):
    """An additive (non-idempotent ⊕) fixpoint hit its iteration bound —
    the underlying graph is cyclic, so count/sum-in-recursion diverges."""


def additive_max_iters(n: int) -> int:
    """Iteration bound for accumulate-form fixpoints: an acyclic n-vertex
    graph's longest path has < n arcs, so the delta drains within n steps;
    hitting n + 2 means a cycle keeps feeding it."""
    return int(n) + 2


def check_additive_converged(res: DenseResult, max_iters: int,
                             what: str = "additive fixpoint") -> DenseResult:
    if int(res.iterations) >= max_iters:
        raise FixpointDivergenceError(
            f"{what} hit its iteration bound ({max_iters}): the graph is "
            "cyclic, so the (+,×) carrier has no finite fixpoint — additive "
            "aggregates in recursion require an acyclic EDB")
    return res


# convenience graph front-ends ------------------------------------------------


def transitive_closure_dense(adj: torch.Tensor, matmul=None) -> DenseResult:
    """tc(X,Y) over the boolean semiring; adj is (n,n) bool."""
    return fixpoint_dense(BOOL, adj, adj, form="linear", matmul=matmul)


def shortest_paths_dense(w: torch.Tensor, matmul=None) -> DenseResult:
    """All-pairs spath (Examples 2/3). w: (n,n) float32 with +inf for no arc."""
    return fixpoint_dense(MIN_PLUS, w, w, form="linear", matmul=matmul)


def same_generation_dense(adj: torch.Tensor, matmul=None) -> DenseResult:
    """sg(X,Y) (Example 11): exit = AᵀA \\ id, recurse S <- Aᵀ S A.

    Only the exit rule carries X != Y (the paper's r1); the recursive rule may
    re-derive diagonal entries (possible when the graph has self-loops).  The
    exit rule's AᵀA is a plain f32 product, as in the JAX package; it is
    exact on the card too (0/1 inputs, integer sums below 2^24)."""
    a = adj.to(torch.float32)
    exit_ = (a.T @ a) > 0
    exit_ &= ~torch.eye(adj.shape[0], dtype=torch.bool, device=adj.device)
    return fixpoint_dense(BOOL, adj, exit_, form="sandwich", matmul=matmul)


def connected_components_dense(adj: torch.Tensor) -> DenseResult:
    """connComp (Example 7 r7.3/r7.4): min-label propagation, undirected
    view; one (n,) label row through the min-plus ⊗ (K2 with B = 1)."""
    n = adj.shape[0]
    sym = adj | adj.T
    prop = torch.where(sym, 0.0, float("inf")).to(torch.float32)
    labels = torch.arange(n, dtype=torch.float32, device=adj.device)
    return fixpoint_dense(MIN_PLUS, prop, labels, form="vector")


# magic-restricted single-source fast paths ----------------------------------
# A query binding the pivot argument of a decomposable program reduces the
# matrix fixpoint to a *vector* fixpoint seeded with the query frontier row.


def reachable_from_dense(adj: torch.Tensor, src: int,
                         matmul=None) -> DenseResult:
    """``?- tc(src, Y)``: one-frontier reachability."""
    return fixpoint_dense(BOOL, adj, adj[src], form="vector", matmul=matmul)


def single_source_distances_dense(w: torch.Tensor, src: int,
                                  matmul=None) -> DenseResult:
    """``?- spath(src, Z, D)``: single-source min-plus distances."""
    return fixpoint_dense(MIN_PLUS, w, w[src], form="vector", matmul=matmul)


# batched front-ends (the serving layer's hot path) ----------------------------


def _as_index(srcs, device) -> torch.Tensor:
    return torch.as_tensor(srcs, dtype=torch.int64).to(device)


def reachable_batch_dense(adj: torch.Tensor, srcs, matmul=None,
                          max_iters: int | None = None) -> DenseResult:
    """``?- tc(s, Y)`` for a batch of sources: one (B, n) masked fixpoint."""
    init = adj[_as_index(srcs, adj.device)]
    return fixpoint_dense_cached(BOOL, adj, init, form="vector", matmul=matmul,
                                 max_iters=max_iters)


def distances_batch_dense(w: torch.Tensor, srcs, matmul=None,
                          max_iters: int | None = None) -> DenseResult:
    """``?- spath(s, Z, D)`` for a batch of sources (min-plus carrier)."""
    init = w[_as_index(srcs, w.device)]
    return fixpoint_dense_cached(MIN_PLUS, w, init, form="vector",
                                 matmul=matmul, max_iters=max_iters)


def counts_batch_dense(w: torch.Tensor, srcs, matmul=None,
                       max_iters: int | None = None) -> DenseResult:
    """``?- cpath(s, Z, C)`` for a batch of sources: plus-times path counts
    via the accumulate form (total = Σ_k w[s]·wᵏ), guarded by the additive
    iteration bound — raises :class:`FixpointDivergenceError` on cycles."""
    init = w[_as_index(srcs, w.device)]
    if max_iters is None:
        max_iters = additive_max_iters(w.shape[-1])
    res = fixpoint_dense_cached(PLUS_TIMES, w, init, form="accumulate",
                                matmul=matmul, max_iters=max_iters)
    return check_additive_converged(res, max_iters, "plus-times batch")


def quantize_rows(n: int, minimum: int = 8) -> int:
    """Shape bucket for data-dependent row counts: next power of two."""
    if n <= minimum:
        return minimum
    return 1 << (n - 1).bit_length()


def quantize_ladder(floor: int, stride: int, top: int) -> tuple[int, ...]:
    """Geometric capacity ladder for degree-class slices: power-of-two caps
    ``floor, floor<<stride, ...`` until the last rung covers ``top``.
    ``stride == 0`` degenerates to one rung at ``quantize_rows(top)``."""
    base = quantize_rows(max(int(floor), 1), minimum=1)
    if stride <= 0:
        return (quantize_rows(max(int(top), 1), minimum=base),)
    caps = [base]
    while caps[-1] < top:
        caps.append(caps[-1] << stride)
    return tuple(caps)
