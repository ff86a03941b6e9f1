"""Serving quickstart on the PyTorch/CUDA port:
``examples/serve_quickstart.py`` on ``repro_torch``.

Walks the ``repro_torch.service`` subsystem end to end:
  * start a ``DatalogService`` (program + EDB load once)
  * a cold query, then a warm-cache query burst (one micro-batched fixpoint)
  * a batched TUPLE-path burst on a non-decomposable predicate (one
    qid-tagged fixpoint answers the union of demands, split per seed)
  * an incremental EDB append that *resumes* cached closures
  * service introspection (``explain()``)

Usage:  PYTHONPATH=src python examples/serve_quickstart_torch.py [--device cpu]

With no ``--device`` it runs on ``cuda`` (and raises without a GPU);
``--device cpu`` runs the kernels' plain PyTorch versions.
"""
import argparse
import time

from repro_torch.data.graphs import gnp_graph, tree_graph
from repro_torch.device import resolve_device
from repro_torch.service import DatalogService

TC = """
tc(X,Y) <- arc(X,Y).
tc(X,Y) <- tc(X,Z), arc(Z,Y).
"""
SG = """
sg(X,Y) <- arc(P,X), arc(P,Y), X != Y.
sg(X,Y) <- arc(A,X), sg(A,B), arc(B,Y).
"""


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    dev = resolve_device(parser.parse_args(argv).device)

    edges = gnp_graph(256, 0.02, seed=7)
    svc = DatalogService(TC, db={"arc": edges}, default_cap=1 << 13,
                         device=dev)
    print(f"service up: {len(edges)} arcs loaded")

    # ------------------------------------------------------------ cold query
    t0 = time.perf_counter()
    rows = svc.ask("tc", (3, None))
    print(f"cold  tc(3, X): {len(rows)} rows in "
          f"{time.perf_counter() - t0:.3f}s (packs the carrier)")

    # ---------------------------------------------- warm burst, micro-batched
    # 32 single-source queries coalesce into ONE batched dense fixpoint: the
    # frontier is a (32, n) matrix, each iteration a single semiring matmul.
    burst = [("tc", (s, None)) for s in range(32)]
    t0 = time.perf_counter()
    svc.ask_batch(burst)
    dt = time.perf_counter() - t0
    print(f"burst of {len(burst)}: {dt:.3f}s total, "
          f"{len(burst) / dt:.0f} queries/sec "
          f"({svc.stats.dense_fixpoints} fixpoints run)")

    # repeat burst: pure result-cache hits
    t0 = time.perf_counter()
    svc.ask_batch(burst)
    dt = time.perf_counter() - t0
    print(f"repeat burst: {dt * 1e3:.1f}ms ({svc.cache.hits} cache hits)")

    # --------------------------------------- batched tuple-path (sg) burst
    # same-generation is NOT dense-decomposable: B same-shape queries share
    # ONE qid-tagged PSN fixpoint instead (the magic seed carries a query-id
    # column; finalization splits the union of demands back per query).
    tree = tree_graph(4, seed=7, min_deg=3, max_deg=4)  # sg blows up on Gn,p
    svg = DatalogService(SG, db={"arc": tree}, default_cap=1 << 13,
                         join_cap=1 << 15, device=dev)
    sg_burst = [("sg", (s, None)) for s in range(12, 20)]
    svg.ask_batch(sg_burst)  # cold: plans the batched fixpoint
    svg.cache.clear()
    t0 = time.perf_counter()
    svg.ask_batch(sg_burst)
    dt = time.perf_counter() - t0
    print(f"sg tuple burst of {len(sg_burst)}: {dt:.3f}s warm "
          f"({svg.stats.tuple_fixpoints} qid-tagged fixpoints, "
          f"{svg.stats.tuple_batched_queries} queries batched)")

    # --------------------------------------------------- incremental append
    # monotone EDB appends resume the cached fixpoints from the new-fact
    # delta frontier: the 32 cached closures refresh without recomputation,
    # and the post-append burst is served from cache again.
    before = len(svc.ask("tc", (3, None)))
    t0 = time.perf_counter()
    svc.append("arc", [[3, 300], [300, 301]])  # fresh vertices: domain grows
    print(f"append of 2 arcs: {time.perf_counter() - t0:.3f}s "
          f"({svc.stats.resumed_rows} cached closures resumed)")
    after = len(svc.ask("tc", (3, None)))
    print(f"tc(3, X): {before} rows -> {after} rows (served from refreshed "
          "cache)")

    print("\nservice state:")
    for k, v in svc.explain().items():
        print(f"  {k}: {v}")


if __name__ == "__main__":
    main()
