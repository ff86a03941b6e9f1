"""Port parity of the distributed plans: ``repro_torch.core.distributed`` on
CPU worker meshes of 1, 2 and 4 shards against ``repro.core.distributed``.

The JAX plans run in-process on a one-device mesh (as
``tests/test_magic.py`` runs ``tc_frontier_decomposable``); their
``iterations`` do not depend on the shard count (the decomposable loop
recomputes every row until the global ``psum`` is 0), so the port's must
equal them at every k.  The closures equal JAX's single-device fixpoints
bit for bit.  ``psn_shuffle_agg`` is held to an oracle, never to JAX's
output: JAX's bucketing loses the candidate stored in bucket (0, 0)
(ROADMAP C.9, pinned below).  The census is held to the paper's plans:
Fig. 4 is one broadcast, then one scalar all-reduce per iteration."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as JD
from repro.core import seminaive as jsn
from repro.core import semiring as jsr
from repro.core import sparse as jsp
from repro_torch.core import distributed as TD
from repro_torch.core import semiring as tsr
from repro_torch.core import sparse as tsp
from repro_torch.kernels import ops as tops
from repro_torch.launch.mesh import make_worker_mesh

EMPTY = np.iinfo(np.int64).max
SHARDS = (1, 2, 4)
KINDS = ("bool", "minplus", "maxplus")
N = 16
SOURCES = [0, 3, 5]  # B = 3: padded to 4 on two and four shards


@functools.lru_cache(maxsize=None)
def _jmesh():
    return jax.make_mesh((1,), ("data",))


def _tmesh(k):
    return make_worker_mesh(k, devices=["cpu"] * k)


@functools.lru_cache(maxsize=None)
def _graph(kind: str, n: int = N, seed: int = 0) -> np.ndarray:
    """JAX's own test graph (Gn-p, p = 0.15) in the carrier; max-plus keeps
    the arcs with src < dst (acyclic)."""
    rng = np.random.default_rng(seed)
    adj = rng.random((n, n)) < 0.15
    if kind == "bool":
        return adj
    if kind == "maxplus":
        adj &= np.triu(np.ones((n, n), bool), 1)
    w = rng.integers(1, 10, (n, n)).astype(np.float32)
    zero = np.inf if kind == "minplus" else -np.inf
    return np.where(adj, w, zero).astype(np.float32)


def _edges(kind: str, n: int = N, seed: int = 0) -> np.ndarray:
    g = _graph(kind, n, seed)
    live = g if kind == "bool" else np.isfinite(g)
    src, dst = np.nonzero(live)
    if kind == "bool":
        return np.stack([src, dst], 1).astype(np.int64)
    return np.stack([src, dst, g[src, dst].astype(np.int64)], 1)


def _jsr(kind):
    return {"bool": jsr.BOOL, "minplus": jsr.MIN_PLUS,
            "maxplus": jsr.MAX_PLUS}[kind]


def _tsr(kind):
    return {"bool": tsr.BOOL, "minplus": tsr.MIN_PLUS,
            "maxplus": tsr.MAX_PLUS}[kind]


@functools.lru_cache(maxsize=None)
def _jax_closure(kind: str) -> np.ndarray:
    """JAX's single-device all-pairs closure."""
    g = jnp.asarray(_graph(kind))
    return np.asarray(jsn.fixpoint_dense(_jsr(kind), g, g,
                                         form="linear").table)


@functools.lru_cache(maxsize=None)
def _jax_plan(kind: str, plan: str):
    """JAX's mesh-(1,) plan: (result, iterations)."""
    g = jnp.asarray(_graph(kind))
    sr = _jsr(kind)
    if plan == "all":
        out, it = JD.tc_decomposable(_jmesh(), g, sr=sr)
    elif plan == "frontier":
        out, it = JD.tc_frontier_decomposable(_jmesh(), g, g[np.array(SOURCES)],
                                              sr=sr)
    elif plan == "resume":
        old = jnp.asarray(_old_graph(kind))
        prev = JD.tc_frontier_decomposable(_jmesh(), old,
                                           old[np.array(SOURCES)], sr=sr)[0]
        out, it = JD.resume_frontier_decomposable(
            _jmesh(), g, prev, g[np.array(SOURCES)], sr=sr)
    elif plan == "csr":
        csr = jsp.build_csr(_edges(kind), N + 3, kind)
        f = jsp.rows_from_sources(csr, np.array(SOURCES))
        out, it = JD.csr_frontier_decomposable(_jmesh(), csr, f)
    else:
        out, it = JD.sg_allreduce(_jmesh(), g)
    return np.asarray(out), int(it)


@functools.lru_cache(maxsize=None)
def _old_graph(kind: str) -> np.ndarray:
    """The graph before an append: every third arc missing."""
    g = _graph(kind).copy()
    live = np.argwhere(g if kind == "bool" else np.isfinite(g))
    drop = live[::3]
    g[drop[:, 0], drop[:, 1]] = False if kind == "bool" else (
        np.inf if kind == "minplus" else -np.inf)
    return g


def _census(mesh) -> dict:
    return {k: (v["count"], v["bytes"]) for k, v in mesh.census().items()
            if v["count"]}


def _fig4(k: int, iters: int, broadcast_bytes: int) -> dict:
    """Fig. 4's census: one broadcast, one scalar psum per iteration."""
    return {"broadcast": (1, (k - 1) * broadcast_bytes),
            "psum": (iters, iters * 2 * (k - 1) * 8)}


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("kind", KINDS)
def test_tc_decomposable_matches_jax(kind, k):
    """All-pairs closure on k shards: JAX's single-device table bit for bit,
    JAX's mesh iterations, Fig. 4's census; ``spath_decomposable`` is the
    min-plus case."""
    mesh = _tmesh(k)
    g = torch.from_numpy(_graph(kind))
    if kind == "minplus":
        got, it = TD.spath_decomposable(mesh, g)
    else:
        got, it = TD.tc_decomposable(mesh, g, sr=_tsr(kind))
    want, jit_ = _jax_plan(kind, "all")
    assert np.array_equal(got.numpy(), _jax_closure(kind))
    assert np.array_equal(got.numpy(), want)
    assert it == jit_
    assert _census(mesh) == _fig4(k, it, g.numel() * g.element_size())


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("kind", KINDS)
def test_tc_frontier_decomposable_pads_and_matches_jax(kind, k):
    """B = 3 frontier rows (padded with ⊕-zero rows to a multiple of k and
    sliced back): the closure's rows and JAX's mesh iterations."""
    g = torch.from_numpy(_graph(kind))
    got, it = TD.tc_frontier_decomposable(
        _tmesh(k), g, g[torch.tensor(SOURCES)], sr=_tsr(kind))
    want, jit_ = _jax_plan(kind, "frontier")
    assert got.shape == (len(SOURCES), N)
    assert np.array_equal(got.numpy(), _jax_closure(kind)[SOURCES])
    assert np.array_equal(got.numpy(), want) and it == jit_


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("kind", KINDS)
def test_resume_frontier_decomposable_matches_jax(kind, k):
    """Rows closed before an append, ⊕ the post-append seed rows, resume to
    the new closure in JAX's iterations."""
    mesh = _tmesh(k)
    sr = _tsr(kind)
    old = torch.from_numpy(_old_graph(kind))
    g = torch.from_numpy(_graph(kind))
    idx = torch.tensor(SOURCES)
    prev, _ = TD.tc_frontier_decomposable(mesh, old, old[idx], sr=sr)
    got, it = TD.resume_frontier_decomposable(mesh, g, prev, g[idx], sr=sr)
    want, jit_ = _jax_plan(kind, "resume")
    assert np.array_equal(got.numpy(), _jax_closure(kind)[SOURCES])
    assert np.array_equal(got.numpy(), want) and it == jit_


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("kind", KINDS)
def test_csr_frontier_decomposable_matches_jax(kind, k):
    """The CSR carrier (n_alloc 19, which no k divides: only the frontier
    rows shard): JAX's rows and iterations, the carrier broadcast once."""
    mesh = _tmesh(k)
    csr = tsp.build_csr(_edges(kind), N + 3, kind, device="cpu")
    f = tsp.rows_from_sources(csr, np.array(SOURCES))
    got, it = TD.csr_frontier_decomposable(mesh, csr, f)
    want, jit_ = _jax_plan(kind, "csr")
    assert np.array_equal(got.numpy(), want) and it == jit_
    assert np.array_equal(got.numpy()[:, :N], _jax_closure(kind)[SOURCES])
    assert _census(mesh) == _fig4(k, it, TD._nbytes(csr))


@pytest.mark.parametrize("k", SHARDS)
def test_sg_allreduce_matches_jax(k):
    """Same generation: ``same_generation_dense``'s table, JAX's mesh
    iterations; one gather of the arcs, then the exit rule's (n, n)
    all-reduce and per iteration one (n, n) and one scalar all-reduce."""
    mesh = _tmesh(k)
    adj = _graph("bool")
    got, it = TD.sg_allreduce(mesh, torch.from_numpy(adj))
    want = np.asarray(jsn.same_generation_dense(jnp.asarray(adj)).table)
    jwant, jit_ = _jax_plan("bool", "sg")
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), jwant) and it == jit_
    part = N * N * 4
    assert _census(mesh) == {
        "all_gather": (1, k * (k - 1) * (N // k) * N),
        "psum": (1 + 2 * it,
                 2 * (k - 1) * ((1 + it) * part + it * 8))}


def test_default_products_are_the_kernel_backed_ones(monkeypatch):
    """The plans' default ⊗ and step are ``kernels.ops``' (K1/K2/K2-max and
    K3/K4/K6/K7 on the card), one call a shard an iteration — never the
    plain ``Semiring.matmul``."""
    calls = []

    def spy(get):
        def wrapped(name):
            fn = get(name)
            return lambda *a: calls.append(name) or fn(*a)
        return wrapped

    monkeypatch.setattr(tops, "semiring_matmul", spy(tops.semiring_matmul))
    monkeypatch.setattr(tops, "csr_frontier_step",
                        spy(tops.csr_frontier_step))
    for kind in KINDS:
        calls.clear()
        g = torch.from_numpy(_graph(kind))
        _, it = TD.tc_decomposable(_tmesh(4), g, sr=_tsr(kind))
        assert len(calls) == 4 * it
        calls.clear()
        csr = tsp.build_csr(_edges(kind), N, kind, device="cpu")
        f = tsp.rows_from_sources(csr, np.array(SOURCES), spmv=tsp.
                                  csr_frontier_step(kind))
        _, it = TD.csr_frontier_decomposable(_tmesh(2), csr, f)
        assert len(calls) == 2 * it


def test_partition_edges_by_src_is_jax_exactly():
    rng = np.random.default_rng(3)
    edges = rng.integers(0, 1000, (500, 2))
    h = (edges[:, 0].astype(np.uint64)
         * np.uint64(11400714819323198485)) >> np.uint64(40)
    for k in SHARDS:
        cap = int(np.bincount((h % np.uint64(k)).astype(np.int64)).max()) + 5
        got = TD.partition_edges_by_src(edges, k, cap)
        want = JD.partition_edges_by_src(edges, k, cap)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        with pytest.raises(ValueError, match="cap_per_shard"):
            TD.partition_edges_by_src(edges, k, cap - 6)


# -- the shuffled PSN ----------------------------------------------------------


def _psn_init(nv: int, k: int, cap: int):
    """Per-shard label tables: the vertices each shard owns (the hash
    ``partition_edges_by_src`` uses), sorted, own id as label, EMPTY-padded;
    int32 labels as in JAX's test."""
    keys = np.full((k, cap), EMPTY, np.int64)
    vals = np.full((k, cap), np.iinfo(np.int32).max, np.int32)
    h = ((np.arange(nv).astype(np.uint64) * np.uint64(11400714819323198485))
         >> np.uint64(40)) % np.uint64(k)
    for s in range(k):
        mine = np.nonzero(h == s)[0]
        keys[s, :len(mine)] = mine
        vals[s, :len(mine)] = mine
    return keys.reshape(-1), vals.reshape(-1)


def _min_label_oracle(edges: np.ndarray, nv: int):
    """Synchronous min-label propagation: (labels, rounds that changed)."""
    lab = np.arange(nv)
    rounds = 0
    while True:
        new = lab.copy()
        np.minimum.at(new, edges[:, 1], lab[edges[:, 0]])
        if np.array_equal(new, lab):
            return lab, rounds
        lab, rounds = new, rounds + 1


def _psn(edges, nv, k, cap=64, bucket_cap=None):
    mesh = _tmesh(k)
    ep = TD.partition_edges_by_src(edges, k, max(len(edges), 1))
    keys, vals = _psn_init(nv, k, cap)
    out = TD.psn_shuffle_agg(mesh, torch.from_numpy(ep),
                             torch.from_numpy(keys), torch.from_numpy(vals),
                             nv, bucket_cap=bucket_cap)
    return out, mesh


def _undirected(pairs) -> np.ndarray:
    pairs = np.asarray(pairs, np.int64)
    return np.concatenate([pairs, pairs[:, ::-1]])


def _random_graph():
    rng = np.random.default_rng(7)
    return _undirected(rng.integers(0, 40, (30, 2))), 40


PSN_GRAPHS = {
    # JAX's own test graph (tests/test_distributed.py::test_psn_shuffle_cc)
    "jax8": (np.array([[0, 1], [1, 0], [1, 2], [2, 1], [3, 4], [4, 3],
                       [5, 6], [6, 5], [6, 7], [7, 6]]), 8),
    "chain10": (_undirected([[i, i + 1] for i in range(9)]), 10),
    "chain10_reversed": (_undirected([[i, i + 1] for i in range(9)])[::-1],
                         10),
    "random40": _random_graph(),
}


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("graph", sorted(PSN_GRAPHS))
def test_psn_shuffle_agg_matches_the_oracle(graph, k):
    """Connected components: every vertex labelled by its component's least
    vertex; iterations = the oracle's changing rounds + 1 (the last round
    finds an empty delta); per iteration two all-to-alls (keys, values) and
    one scalar psum; no overflow."""
    edges, nv = PSN_GRAPHS[graph]
    (keys, vals, it, ovf), mesh = _psn(edges, nv, k)
    lab, rounds = _min_label_oracle(edges, nv)
    got = {int(a): int(b) for a, b in zip(keys.numpy(), vals.numpy())
           if a != EMPTY}
    assert got == {v: int(lab[v]) for v in range(nv)}
    assert it == rounds + 1 and not ovf
    counts = {kk: v["count"] for kk, v in mesh.census().items()}
    assert counts == {"psum": it, "all_gather": 0, "broadcast": 0,
                      "all_to_all": 2 * it}
    # keys then values: k·(k-1) blocks of (cap,) int64 and int32 each
    assert mesh.census()["all_to_all"]["bytes"] == \
        it * k * (k - 1) * 64 * (8 + 4)


def test_psn_shuffle_agg_sets_overflow_at_a_small_bucket_cap():
    edges, nv = PSN_GRAPHS["random40"]
    for k in (1, 2):
        (_, _, _, ovf), _ = _psn(edges, nv, k, bucket_cap=1)
        assert ovf


def test_c9_jax_bucketing_loses_the_candidate_at_slot_0_0():
    """ROADMAP C.9: JAX's ``_bucket_by_dest`` writes every invalid entry
    (EMPTY keys, entries past capacity) to slot (0, 0) and so erases key
    5; the port's drops them and keeps it."""
    keys = np.array([5, 7, EMPTY, EMPTY], np.int64)
    vals = np.array([50, 70, 0, 0], np.int32)
    dest = np.array([0, 1, 0, 0], np.int32)
    jb, jv, jo = JD._bucket_by_dest(jnp.asarray(keys), jnp.asarray(vals),
                                    jnp.asarray(dest), 2, 4)
    tb, tv, to = TD._bucket_by_dest(torch.from_numpy(keys),
                                    torch.from_numpy(vals),
                                    torch.from_numpy(dest), 2, 4)
    assert (np.asarray(jb)[0] == EMPTY).all()  # key 5 lost in JAX
    assert tb[0].tolist() == [5, EMPTY, EMPTY, EMPTY]
    assert tv[0].tolist() == [50, 0, 0, 0]
    assert tb[1].tolist() == np.asarray(jb)[1].tolist() == [7, EMPTY, EMPTY,
                                                            EMPTY]
    assert not to and not bool(jo)


@pytest.mark.parametrize("case", ["all_valid", "overflow_and_empty"])
def test_bucket_by_dest_matches_jax_where_slot_0_0_is_free(case):
    """Where JAX's stray writes land on an empty slot (0, 0), both
    bucketings agree: buckets, values and the overflow flag."""
    if case == "all_valid":
        keys = np.array([9, 4, 12, 3, 8, 1], np.int64)
        dest = np.array([1, 0, 2, 0, 1, 2], np.int32)
        n_dest, cap = 3, 2
    else:  # nothing bound for bucket 0, bucket 1 over its capacity
        keys = np.array([5, 7, EMPTY, 9, 11], np.int64)
        dest = np.array([1, 1, 0, 1, 1], np.int32)
        n_dest, cap = 2, 2
    vals = (keys % 97).astype(np.int32)
    want = JD._bucket_by_dest(jnp.asarray(keys), jnp.asarray(vals),
                              jnp.asarray(dest), n_dest, cap)
    got = TD._bucket_by_dest(torch.from_numpy(keys), torch.from_numpy(vals),
                             torch.from_numpy(dest), n_dest, cap)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == bool(want[2]) == (case != "all_valid")


@pytest.mark.parametrize("slots", [0, 5, 12, 40])
def test_relax_fills_fixed_slots_in_delta_then_arc_order(slots):
    """``_relax``'s candidates equal a plain enumeration of (delta key, arc)
    pairs in that order, cut at ``slots`` and ``EMPTY``-filled past the last
    one; its overflow flag is a 0-d tensor that says whether more were
    derived.  An empty delta gives no candidate."""
    rng = np.random.default_rng(7)
    edges = rng.integers(0, 10, (24, 2)).astype(np.int64)
    order = np.argsort(edges[:, 0], kind="stable")
    src_s, dst_s = edges[order, 0], edges[order, 1]
    dkeys = np.array([1, 4, 6, 9], np.int64)
    dvals = np.array([10, 40, 60, 90], np.int32)
    want = [(int(d), int(v)) for kk, v in zip(dkeys, dvals)
            for d in dst_s[src_s == kk]]
    ck, cv, ovf = TD._relax(*map(torch.from_numpy,
                                 (src_s, dst_s, dkeys, dvals)), slots)
    n = min(slots, len(want))
    assert list(zip(ck[:n].tolist(), cv[:n].tolist())) == want[:n]
    assert (ck[n:] == EMPTY).all()
    assert isinstance(ovf, torch.Tensor) and bool(ovf) == (len(want) > slots)
    ek, _, eo = TD._relax(torch.from_numpy(src_s), torch.from_numpy(dst_s),
                          torch.zeros(0, dtype=torch.int64),
                          torch.zeros(0, dtype=torch.int32), slots)
    assert (ek == EMPTY).all() and ek.numel() == slots and not eo


# -- the mesh itself ------------------------------------------------------------


def test_rows_the_mesh_does_not_divide_raise():
    g = torch.from_numpy(_graph("bool", n=15))
    with pytest.raises(ValueError, match="shard evenly"):
        TD.tc_decomposable(_tmesh(2), g)
    with pytest.raises(ValueError, match="shard evenly"):
        TD.sg_allreduce(_tmesh(4), g)


def test_make_worker_mesh_without_cards_raises(monkeypatch):
    """With no argument a mesh wants one card a shard and raises, naming
    ``devices=[...]``, on a host with fewer (here: none, whatever the host
    has); ``devices=`` places the shards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match=r"devices=\[\.\.\.\]"):
        make_worker_mesh(2)
    mesh = make_worker_mesh(3, "rows", devices=["cpu"] * 3)
    assert mesh.shape == {"rows": 3} and mesh.axis_names == ("rows",)
    assert mesh.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        make_worker_mesh(2, devices=["cpu"])


def test_collectives_and_census():
    """Each collective's result and census entry: shards sharing a device
    share one tensor; bytes are what distinct devices would move."""
    mesh = _tmesh(3)
    parts = [torch.full((2,), float(s)) for s in range(3)]
    out = mesh.psum(parts)
    assert all(o is out[0] for o in out) and out[0].tolist() == [3.0, 3.0]
    gathered = mesh.all_gather(parts)
    assert gathered[0].tolist() == [0.0, 0.0, 1.0, 1.0, 2.0, 2.0]
    blocks = [torch.arange(3) + 10 * s for s in range(3)]
    got = mesh.all_to_all(blocks)
    assert [g.tolist() for g in got] == [[0, 10, 20], [1, 11, 21],
                                         [2, 12, 22]]
    x = torch.ones(4, 4)
    assert all(b is x for b in mesh.broadcast(x))
    assert mesh.census() == {
        "psum": {"count": 1, "bytes": 2 * 2 * 8},
        "all_gather": {"count": 1, "bytes": 3 * 2 * 8},
        "broadcast": {"count": 1, "bytes": 2 * 64},
        "all_to_all": {"count": 1, "bytes": 3 * 2 * 8}}
    mesh.reset_census()
    assert all(v == {"count": 0, "bytes": 0} for v in mesh.census().values())
