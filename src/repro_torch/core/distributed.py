"""Distributed evaluation plans over a worker mesh — §6/§7 of the paper.

Port of ``repro.core.distributed``.  The JAX module runs each plan under
``shard_map``: one process holds every device and the body runs once per
shard.  The port keeps that single-controller model: a :class:`WorkerMesh`
is one ``torch.device`` per shard (several shards may share one card, the
port's counterpart of ``--xla_force_host_platform_device_count``), the plans
loop over the shards in this process, and the mesh performs the collectives
between them.  Three plans, as in the paper's taxonomy:

``tc_decomposable``   Figure 4: the recursive relation row-sharded on its GPS
    (first argument), the base relation broadcast once; the fixpoint body has
    **no collective** but the scalar convergence ``psum``.  Each shard's
    per-iteration join is one kernel-backed ⊗ of its rows with the relation
    (``kernels.ops.semiring_matmul``: K1, K2 or K2-max on the card).

``sg_allreduce``      Figures 2(b)/3: same-generation is not decomposable; the
    sandwich contraction Aᵀ(SA) needs one ``psum`` (all-reduce) per iteration
    — the collective playing the role of Spark's shuffle.

``psn_shuffle_agg``   §7.1 Example 12 generalized: tuple-level PSN where each
    worker owns the hash partition of the recursive relation given by its
    discriminating set; derived tuples are re-keyed and exchanged with
    ``all_to_all`` each iteration.  Its bucketing drops invalid candidates
    where the JAX module writes them to bucket (0, 0) and so loses the valid
    candidate stored there (ROADMAP C.9).

All three carry monotone state, so restart/replay is idempotent (the SetRDD
argument).  Each returns ``(result, iterations)`` as the JAX module's does
(``psn_shuffle_agg``: ``(keys, values, iterations, overflow)``); the result
is assembled on the device of the first shard.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..device import canonical_device
from .relation import _MERGE_INIT, EMPTY, AggTable, hash32
from .semiring import BOOL, MIN_PLUS, Semiring
from .seminaive import _ne

#: the collective kinds of the census, in the order :meth:`WorkerMesh.census`
#: reports them
COLLECTIVES = ("psum", "all_gather", "broadcast", "all_to_all")


def _nbytes(obj) -> int:
    """The bytes of every tensor in ``obj`` (a tensor, a tuple of them or a
    dataclass such as a CSR carrier)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(x) for x in obj)
    if dataclasses.is_dataclass(obj):
        return sum(_nbytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


def _to(obj, device: torch.device):
    """``obj`` on ``device``: itself where it already lies there, else a peer
    copy (tensors, tuples of them and dataclasses, field by field)."""
    if isinstance(obj, torch.Tensor):
        return obj if obj.device == device else obj.to(device,
                                                       non_blocking=True)
    if isinstance(obj, tuple):
        return tuple(_to(x, device) for x in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), (torch.Tensor, tuple))})
    return obj


class WorkerMesh:
    """A 1-D mesh of shards, one ``torch.device`` each, driven from this
    process (JAX's single-controller model), and the collectives the plans
    use between them: :meth:`psum`, :meth:`all_gather`, :meth:`broadcast`
    and :meth:`all_to_all`, each over a list of per-shard values.

    Between shards on distinct devices tensors move by peer copy; between
    shards that share a device nothing is copied.  The **census** counts
    each collective and the bytes a mesh of distinct devices would move for
    it, whether or not the shards share a device: ``psum`` of k parts of b
    bytes 2(k-1)b (reduce, then broadcast back), ``all_gather`` of k pieces
    of b bytes k(k-1)b, ``broadcast`` of B bytes (k-1)B, ``all_to_all`` of
    k blocks of b bytes on each shard k(k-1)b.  Placing a plan's input rows
    on the shards (:meth:`shard`) and assembling its result
    (:meth:`gather`) are placement, as JAX's input and output shardings
    are, and stay out of the census."""

    def __init__(self, devices, axis_names=("data",)):
        self.devices = tuple(canonical_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a worker mesh needs at least one shard")
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != 1:
            raise ValueError("a worker mesh has one axis, got "
                             f"{self.axis_names}")
        self.shape = {self.axis_names[0]: len(self.devices)}
        self.reset_census()

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"WorkerMesh({self.shape}, devices="
                f"{[str(d) for d in self.devices]})")

    # -- the census -----------------------------------------------------------

    def reset_census(self) -> None:
        self._census = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}

    def census(self) -> dict:
        """``{kind: {"count", "bytes"}}`` since the last reset."""
        return {k: dict(v) for k, v in self._census.items()}

    def _note(self, kind: str, nbytes: int) -> None:
        self._census[kind]["count"] += 1
        self._census[kind]["bytes"] += nbytes

    # -- placement ------------------------------------------------------------

    def shard(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Split ``x``'s rows into ``size`` equal blocks, one per shard (views
        where a shard lies on ``x``'s device).  A row count the mesh does not
        divide raises, as ``shard_map`` refuses it."""
        k = self.size
        if x.shape[0] % k:
            raise ValueError(f"{x.shape[0]} rows do not shard evenly over "
                             f"{k} workers")
        return [_to(p, d) for p, d in zip(x.chunk(k), self.devices)]

    def gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The shards' row blocks stacked on the first shard's device."""
        home = self.devices[0]
        return torch.cat([_to(p, home) for p in parts])

    def _per_device(self, make) -> list:
        """``make(device)`` once per distinct device, shared by its shards."""
        made: dict = {}
        for d in self.devices:
            if d not in made:
                made[d] = make(d)
        return [made[d] for d in self.devices]

    # -- collectives ----------------------------------------------------------

    def psum(self, parts: list) -> list:
        """All-reduce by sum: every shard gets the sum of the k parts (one
        tensor per distinct device; shards sharing a device share it).
        Parts that are Python ints, counts this process already holds, are
        summed here with no device work; the census counts them as int64
        scalars."""
        if not isinstance(parts[0], torch.Tensor):
            self._note("psum", 2 * (self.size - 1) * 8)
            return [sum(parts)] * self.size
        home = self.devices[0]
        total = _to(parts[0], home).clone()
        for p in parts[1:]:
            total += _to(p, home)
        self._note("psum", 2 * (self.size - 1) * _nbytes(parts[0]))
        return self._per_device(lambda d: _to(total, d))

    def all_gather(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Every shard gets the k parts concatenated along their first axis
        (JAX's ``all_gather(..., tiled=True)``)."""
        self._note("all_gather", self.size * (self.size - 1)
                   * _nbytes(parts[0]))
        return self._per_device(lambda d: torch.cat([_to(p, d)
                                                     for p in parts]))

    def broadcast(self, obj) -> list:
        """Every shard gets ``obj`` (a tensor or a carrier of tensors):
        itself on the devices it lies on, else one copy per device."""
        self._note("broadcast", (self.size - 1) * _nbytes(obj))
        return self._per_device(lambda d: _to(obj, d))

    def all_to_all(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """``parts[s]`` is shard s's (k, ...) blocks, block d bound for shard
        d; shard d gets the k blocks sent to it, in shard order, as one
        (k, ...) tensor (JAX's ``all_to_all(x, axis, 0, 0, tiled=True)``)."""
        k = self.size
        self._note("all_to_all", k * (k - 1) * _nbytes(parts[0][0]))
        return [torch.stack([_to(parts[s][d], dev) for s in range(k)])
                for d, dev in enumerate(self.devices)]


def _pad_rows(x: torch.Tensor, k: int, zero) -> torch.Tensor:
    """``x`` with ⊕-zero rows appended up to a multiple of ``k``."""
    pad = (-x.shape[0]) % k
    if not pad:
        return x
    fill = torch.full((pad, x.shape[1]), zero, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill])


def _decomposable_loop(mesh: WorkerMesh, sr: Semiring, step: Callable,
                       rows: list, bases: list, iters_cap: int):
    """Fig. 4's loop: each shard ⊕'s ``step(its rows, its base)`` into its
    rows; one scalar ``psum`` of the changed counts, read back once, is the
    loop's only collective and its only host sync."""
    it, alive = 0, True
    while alive and it < iters_cap:
        nxt = [sr.add(d, step(d, b)) for d, b in zip(rows, bases)]
        changed = [_ne(sr, dn, d).sum() for dn, d in zip(nxt, rows)]
        alive = int(mesh.psum(changed)[0]) > 0
        rows, it = nxt, it + 1
    return rows, it


# ---------------------------------------------------------------------------
# Dense decomposable TC / SSSP (GPS = first argument)
# ---------------------------------------------------------------------------


def tc_decomposable(mesh: WorkerMesh, adj: torch.Tensor, axis: str = "data",
                    sr: Semiring = BOOL, matmul=None,
                    max_iters: int | None = None,
                    init: torch.Tensor | None = None):
    """Row-sharded semiring fixpoint with a shuffle-free recursion.

    ``adj``: (n, n) dense relation in the semiring's carrier (bool for TC,
    float32 +inf-padded for shortest distances).  ``init`` overrides the
    fixpoint seed (default: ``adj`` itself, the all-pairs closure); a
    magic-restricted query seeds only its frontier rows instead (see
    :func:`tc_frontier_decomposable`).  ``matmul`` defaults to the
    kernel-backed ⊗ (``kernels.ops.semiring_matmul``), not the plain
    ``Semiring.matmul``.  Returns ``(closure, iterations)``.
    """
    from ..kernels import ops

    mm = matmul or ops.semiring_matmul(sr.name)
    n = adj.shape[0]
    iters_cap = max_iters or (4 * n + 8)
    rows = mesh.shard(adj if init is None else init)
    arcs = mesh.broadcast(adj)  # Fig. 4: the base relation, once
    rows, it = _decomposable_loop(mesh, sr, mm, rows, arcs, iters_cap)
    return mesh.gather(rows), it


def spath_decomposable(mesh: WorkerMesh, w: torch.Tensor, axis: str = "data",
                       matmul=None):
    """All-pairs shortest paths, decomposable plan (Example 2 distributed)."""
    return tc_decomposable(mesh, w, axis, MIN_PLUS, matmul)


def tc_frontier_decomposable(mesh: WorkerMesh, adj: torch.Tensor,
                             frontier: torch.Tensor, axis: str = "data",
                             sr: Semiring = BOOL, matmul=None,
                             max_iters: int | None = None):
    """Magic-restricted decomposable plan: close only the query's frontier.

    ``frontier``: (B, n) seed rows in the semiring carrier, one per source.
    They shard exactly like the full recursive relation in Fig. 4 (the GPS
    pivot is the source argument), so the recursion stays shuffle-free;
    rows are ⊕-zero-padded to a multiple of the mesh axis and sliced back
    after the fixpoint.
    """
    b = frontier.shape[0]
    frontier = _pad_rows(frontier, mesh.shape[axis], sr.zero)
    closed, iters = tc_decomposable(mesh, adj, axis, sr, matmul, max_iters,
                                    init=frontier)
    return closed[:b], iters


def csr_frontier_decomposable(mesh: WorkerMesh, csr, frontier: torch.Tensor,
                              axis: str = "data", spmv=None,
                              max_iters: int | None = None):
    """Fig.-4 sharding of the *sparse* frontier fixpoint (``core.sparse``).

    The (B, n) frontier rows shard as in :func:`tc_frontier_decomposable`;
    the packed carrier is broadcast once (not copied where a shard shares
    its device), so each shard runs its own O(|E|)-per-iteration segment
    fixpoint and the only collective in the loop is the scalar convergence
    ``psum``.  ``spmv`` defaults to the kernel-backed step
    (``kernels.ops.csr_frontier_step``: K3, K4 or K7, K6 by carrier).
    """
    from ..kernels import ops

    sr = csr.semiring
    step = spmv or ops.csr_frontier_step(csr.kind)
    b = frontier.shape[0]
    frontier = _pad_rows(frontier, mesh.shape[axis], sr.zero)
    iters_cap = max_iters or (4 * frontier.shape[1] + 8)
    rows = mesh.shard(frontier)
    rows, it = _decomposable_loop(mesh, sr, step, rows, mesh.broadcast(csr),
                                  iters_cap)
    return mesh.gather(rows)[:b], it


def resume_frontier_decomposable(mesh: WorkerMesh, adj: torch.Tensor,
                                 prev: torch.Tensor, seed: torch.Tensor,
                                 axis: str = "data", sr: Semiring = BOOL,
                                 matmul=None, max_iters: int | None = None):
    """Resume a sharded frontier fixpoint after a monotone EDB append: the
    Fig.-4 loop restarts from ``prev ⊕ seed`` (the closed rows joined with
    the post-append seed rows of the same sources) and converges in as many
    iterations as the delta needs (the SetRDD argument)."""
    return tc_frontier_decomposable(mesh, adj, sr.add(prev, seed), axis, sr,
                                    matmul, max_iters)


# ---------------------------------------------------------------------------
# SG: sandwich plan with one all-reduce per iteration
# ---------------------------------------------------------------------------


def sg_allreduce(mesh: WorkerMesh, adj: torch.Tensor, axis: str = "data",
                 max_iters: int | None = None):
    """Same generation over row-sharded ``adj`` (bool (n, n)).  The exit
    rule's AᵀA and each iteration's Aᵀ(SA) contract over the global rows,
    so each shard forms an (n, n) f32 partial from its rows and one
    ``psum`` sums them; the arc relation is gathered once before the loop.
    The products are f32 ``torch.matmul``, as the JAX module's
    ``jnp.matmul``; the counts are non-negative, so ``> 0`` is exact."""
    n = adj.shape[0]
    iters_cap = max_iters or (2 * n + 8)
    k = mesh.shape[axis]
    rows = n // k
    a_loc = mesh.shard(adj)
    a_f = [a.to(torch.float32) for a in a_loc]

    def own_rows(full: list, s: int) -> torch.Tensor:
        return full[s][s * rows:(s + 1) * rows] > 0

    # exit rule: sg0 = AᵀA minus the diagonal, rows sharded
    full = mesh.psum([a.T @ a for a in a_f])
    s_loc = []
    for s, dev in enumerate(mesh.devices):
        eye = torch.zeros((rows, n), dtype=torch.bool, device=dev)
        ar = torch.arange(rows, device=dev)
        eye[ar, s * rows + ar] = True
        s_loc.append(own_rows(full, s) & ~eye)
    del full
    ga = [g.to(torch.float32) for g in mesh.all_gather(a_loc)]  # once
    it, alive = 0, True
    while alive and it < iters_cap:
        # contraction over each shard's rows of A; the partials are released
        # as soon as the all-reduce has summed them
        full = mesh.psum([a.T @ (s.to(torch.float32) @ g)
                          for a, s, g in zip(a_f, s_loc, ga)])
        # no diagonal mask here: only the exit rule carries X != Y
        nxt = [s | own_rows(full, i) for i, s in enumerate(s_loc)]
        del full
        changed = [(sn != s).sum() for sn, s in zip(nxt, s_loc)]
        alive = int(mesh.psum(changed)[0]) > 0
        s_loc, it = nxt, it + 1
    return mesh.gather(s_loc), it


# ---------------------------------------------------------------------------
# Tuple-level distributed PSN with all_to_all shuffle (Example 12 generalized)
# ---------------------------------------------------------------------------


def _bucket_by_dest(keys: torch.Tensor, vals: torch.Tensor | None,
                    dest: torch.Tensor, n_dest: int, bucket_cap: int):
    """Scatter (key, value) pairs into per-destination buckets
    ``(n_dest, bucket_cap)``, ``EMPTY``-filled (values 0-filled), each
    bucket in input order; returns ``(buckets, vbuckets, overflow)``, the
    flag a 0-d bool tensor on the keys' device.

    An ``EMPTY`` key, or a pair past its bucket's capacity, is dropped: it is
    parked on a spare slot of its own past the buckets, which is cut off.
    (The JAX module writes every invalid pair to slot (0, 0) and so erases
    the valid key stored there, ROADMAP C.9.)  Every pair has a slot of its
    own, so the scatter is deterministic on the card too, and nothing is
    read back to the host."""
    n = keys.numel()
    empty = keys == EMPTY
    dest = torch.where(empty, n_dest - 1, dest.to(torch.int64))
    order = torch.sort(dest * 2 + empty.to(torch.int64), stable=True)[1]
    ks, ds = keys[order], dest[order]
    start = torch.searchsorted(ds, torch.arange(n_dest, device=ds.device))
    pos = torch.arange(n, device=ks.device)
    rank = pos - start[ds]
    live = ks != EMPTY
    ok = (rank < bucket_cap) & live
    size = n_dest * bucket_cap
    at = torch.where(ok, ds * bucket_cap + rank, size + pos)
    buckets = torch.full((size + n,), EMPTY, dtype=torch.int64,
                         device=keys.device)
    buckets.index_put_((at,), ks)
    vbuckets = None
    if vals is not None:
        vbuckets = torch.zeros((size + n,), dtype=vals.dtype,
                               device=vals.device)
        vbuckets.index_put_((at,), vals[order])
        vbuckets = vbuckets[:size].view(n_dest, bucket_cap)
    overflow = ((rank >= bucket_cap) & live).any()
    return buckets[:size].view(n_dest, bucket_cap), vbuckets, overflow


def _relax(src_s: torch.Tensor, dst_s: torch.Tensor, dkeys: torch.Tensor,
           dvals: torch.Tensor, slots: int):
    """Join a delta (vertex -> value) with a shard's source-sorted arcs:
    ``slots`` ``(dst, value)`` candidates in (delta key, arc) order,
    ``EMPTY`` past the last one derived, and whether more were derived
    (a 0-d bool tensor): JAX's candidate slots and overflow flag, with no
    read back to the host."""
    dev = dkeys.device
    if not dkeys.numel():
        return (torch.full((slots,), EMPTY, dtype=torch.int64, device=dev),
                torch.zeros((slots,), dtype=dvals.dtype, device=dev),
                torch.zeros((), dtype=torch.bool, device=dev))
    lo = torch.searchsorted(src_s, dkeys)
    m = torch.searchsorted(src_s, dkeys, right=True) - lo
    off = torch.cumsum(m, 0)
    slot = torch.arange(slots, device=dev)
    pi = torch.searchsorted(off, slot, right=True)
    pi.clamp_(max=dkeys.numel() - 1)
    ei = (lo[pi] + slot - (off - m)[pi]).clamp_(0, src_s.numel() - 1)
    ok = slot < off[-1]
    return (torch.where(ok, dst_s[ei].to(torch.int64), EMPTY),
            torch.where(ok, dvals[pi], 0), off[-1] > slots)


def psn_shuffle_agg(mesh: WorkerMesh, edges: torch.Tensor,
                    init_keys: torch.Tensor, init_vals: torch.Tensor,
                    n_vertices: int, axis: str = "data", kind: str = "min",
                    max_iters: int = 1 << 14, bucket_cap: int | None = None):
    """Distributed label-propagation-style PSN (CC / single-source distances).

    ``edges``: (k·m, 2) int64 arcs hash-partitioned by source
    (:func:`partition_edges_by_src`); ``init_keys``/``init_vals``: (k·cap,)
    per-shard initial aggregate keys (vertex ids, sorted, ``EMPTY``-padded)
    and values.  Each shard holds an aggregate table (vertex -> value) of the
    vertices hashed to it.  Each iteration joins its delta with its arcs on
    the source, buckets the (destination, value) candidates by the
    destination's owner, ``all_to_all``-exchanges keys and values, and
    ⊕-merges what it received; one scalar ``psum`` of the delta sizes is the
    convergence test.  Returns ``(keys, values, iterations, overflow)`` in
    the JAX layout: per shard ``cap`` slots, sorted keys, ``EMPTY``-padded.

    The join, the bucketing and the overflow flags stay on the device; the
    loop's host syncs are the merges': an ``AggTable`` has dynamic sizes,
    so each shard's merge reads its sizes back, every iteration.  The delta
    sizes the ``psum`` adds are therefore already on the host.
    """
    k = mesh.shape[axis]
    cap = init_keys.shape[0] // k
    bcap = bucket_cap or cap
    init = _MERGE_INIT[kind]
    tables, deltas, arcs = [], [], []
    for e, keys0, vals0 in zip(mesh.shard(edges), mesh.shard(init_keys),
                               mesh.shard(init_vals)):
        src_s, esort = torch.sort(e[:, 0], stable=True)
        arcs.append((src_s, e[:, 1][esort]))
        live = keys0 != EMPTY
        t = AggTable.from_pairs(keys0[live], vals0[live], cap, kind)
        tables.append(t)
        deltas.append((t.keys, t.values))
    # overflow: the tables' (host) flags, and per shard a device flag for
    # the candidate slots and buckets, read once after the loop
    overflow = any(t.overflow for t in tables)
    flags = [torch.zeros((), dtype=torch.bool, device=d) for d in mesh.devices]
    it, alive = 0, True
    while alive and it < max_iters:
        bk, bv = [], []
        for s, ((src_s, dst_s), (dk, dv)) in enumerate(zip(arcs, deltas)):
            ck, cv, o1 = _relax(src_s, dst_s, dk, dv, bcap * k)
            b_k, b_v, o2 = _bucket_by_dest(ck, cv, hash32(ck, k), k, bcap)
            bk.append(b_k)
            bv.append(b_v)
            flags[s] = flags[s] | o1 | o2
        rk = mesh.all_to_all(bk)
        rv = mesh.all_to_all(bv)
        del bk, bv
        counts = []
        for s in range(k):
            nt, dt = tables[s].merge(rk[s].reshape(-1), rv[s].reshape(-1))
            tables[s], deltas[s] = nt, (dt.keys, dt.values)
            overflow = overflow or nt.overflow
            counts.append(dt.count)
        del rk, rv
        alive = mesh.psum(counts)[0] > 0
        it += 1
    home = mesh.devices[0]
    overflow = overflow or bool(torch.stack([f.to(home) for f in flags]).any())
    keys = torch.full((k, cap), EMPTY, dtype=torch.int64, device=home)
    vals = torch.full((k, cap), init, dtype=init_vals.dtype, device=home)
    for s, t in enumerate(tables):
        keys[s, :t.count] = t.keys.to(keys.device)
        vals[s, :t.count] = t.values.to(vals.device)
    return keys.reshape(-1), vals.reshape(-1), it, overflow


def partition_edges_by_src(edges, n_shards: int, cap_per_shard: int
                           ) -> np.ndarray:
    """Host-side helper: hash-partition an edge list by source vertex
    (numpy in, numpy out, the JAX module's array exactly).  Shard s's arcs
    fill rows ``[s·cap, (s+1)·cap)`` in input order; unused slots are parked
    on an off-domain sentinel self-loop that owns no label."""
    edges = np.asarray(edges, np.int64).reshape((-1, 2))
    h = ((edges[:, 0].astype(np.uint64) * np.uint64(11400714819323198485))
         >> np.uint64(40)) % np.uint64(n_shards)
    dest = h.astype(np.int64)
    counts = np.bincount(dest, minlength=n_shards)
    if counts.size and counts.max() > cap_per_shard:
        raise ValueError("edge partition overflow; raise cap_per_shard")
    order = np.argsort(dest, kind="stable")
    sorted_dest = dest[order]
    starts = np.cumsum(counts) - counts  # first slot of each shard's run
    rank = np.arange(len(edges)) - starts[sorted_dest]
    out = np.full((n_shards, cap_per_shard, 2), 1 << 40, np.int64)
    out[sorted_dest, rank] = edges[order]
    return out.reshape(n_shards * cap_per_shard, 2)
