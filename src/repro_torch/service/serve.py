"""CLI front-end for :class:`~repro_torch.service.session.DatalogService`.

Load a program + EDB once, then answer query bursts, appends, or an
interactive stream::

    # demo graph, two queries, one append, service stats (on the GPU)
    PYTHONPATH=src python -m repro_torch.service.serve \\
        --synthetic gnp:400:0.005 \\
        --query "tc(0, X)" --query "tc(5, X)" \\
        --append "arc:0,399" --query "tc(0, X)" --stats

    # your own program/EDB (CSV rows, one relation per file: name.csv),
    # on the CPU
    PYTHONPATH=src python -m repro_torch.service.serve --device cpu \\
        --program prog.dl --edb arc=arcs.csv --query "tc(1, X)"

    # interactive: one query / append / command per line
    ... --repl        (tc(1,X)  |  +arc:4,5  |  .stats  |  :quit)

Actions execute in command-line order; ``--query`` answers print one row per
line.  ``--batch`` coalesces consecutive ``--query`` flags into one
micro-batched ``ask_batch`` call.  ``--async`` routes everything through the
continuous-batching admission front-end instead (``admission.py``): queries
are submitted as futures and coalesced by the dispatcher's arrival window
(``--max-wait-ms`` / ``--max-batch`` / ``--queue-depth``), appends are
epoch-fenced, and ``--stats`` adds the front-end's queue/flush counters.
``--durable DIR`` makes the service crash-safe: it recovers from DIR at
start, and a planned exit publishes a final snapshot.  ``--device`` picks
the torch device (default ``cuda``; ``cpu`` runs the kernels' plain
versions).  The output lines are those of ``python -m repro.service.serve``.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

TC_DEMO = """
tc(X,Y) <- arc(X,Y).
tc(X,Y) <- tc(X,Z), arc(Z,Y).
"""


def _synthetic(spec: str) -> np.ndarray:
    """gnp:N:P | dag:N:P:W | grid:N | tree:H | paths:COUNT:LEN -> 'arc'
    edge list (``dag`` rows carry a weight column for counting / min-plus /
    max-plus programs; the others are unweighted)."""
    from ..data.graphs import dag_graph, gnp_graph, grid_graph, tree_graph

    kind, *args = spec.split(":")
    if kind == "gnp":
        return gnp_graph(int(args[0]), float(args[1]) if len(args) > 1 else 0.001)
    if kind == "dag":
        return dag_graph(int(args[0]),
                         float(args[1]) if len(args) > 1 else 0.01,
                         max_w=int(args[2]) if len(args) > 2 else 1)
    if kind == "grid":
        return grid_graph(int(args[0]))
    if kind == "tree":
        return tree_graph(int(args[0]))
    if kind == "paths":
        count, length = int(args[0]), int(args[1]) if len(args) > 1 else 5
        edges, v = [], 0
        for _ in range(count):
            for _ in range(length):
                edges.append((v, v + 1))
                v += 1
            v += 1
        return np.asarray(edges, np.int64)
    raise SystemExit(f"unknown synthetic family {kind!r}")


def _load_edb(specs: list[str]) -> dict[str, np.ndarray]:
    db = {}
    for spec in specs:
        name, _, path = spec.partition("=")
        if not path:
            raise SystemExit(f"--edb wants name=file.csv, got {spec!r}")
        db[name] = np.loadtxt(path, delimiter=",", dtype=np.int64, ndmin=2)
    return db


def _print_answer(query: str, res) -> None:
    if isinstance(res, tuple):
        rows, vals = res
        print(f"{query}  [{len(rows)} rows]")
        for r, v in zip(rows.tolist(), vals.tolist()):
            print("  " + ", ".join(map(str, [*r, v])))
    else:
        print(f"{query}  [{len(res)} rows]")
        for r in np.asarray(res).tolist():
            print("  " + ", ".join(map(str, r)))


def _parse_append(spec: str) -> tuple[str, np.ndarray]:
    rel, _, rows = spec.partition(":")
    if not rows:
        raise SystemExit(f"--append wants rel:v1,v2[,w][;v1,v2...], got {spec!r}")
    parsed = [[int(x) for x in row.split(",")] for row in rows.split(";")]
    return rel, np.asarray(parsed, np.int64)


def _repl(svc) -> None:
    print("serve> tc(1,X) queries | +arc:4,5 appends | .stats | .metrics "
          "| .snapshot | :quit", file=sys.stderr)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        if line in (":quit", ":q", ".quit", ".q"):
            break
        if line in (".stats", ":stats"):  # :stats is the older spelling
            print(json.dumps(svc.explain(), indent=2, default=str))
            continue
        if line == ".metrics":
            metrics = getattr(svc, "svc", svc).metrics
            print(metrics.to_prometheus(), end="")
            continue
        if line == ".snapshot":
            try:
                step = svc.snapshot(wait=True)
                print(f"snapshot published (step {step})")
            except Exception as e:
                print(f"error: {e}", file=sys.stderr)
            continue
        try:
            if line.startswith("+"):
                rel, rows = _parse_append(line[1:])
                svc.append(rel, rows)
                print(f"appended {len(rows)} rows to {rel} "
                      f"(epoch {svc.epoch})")
            else:
                _print_answer(line, svc.ask(line))
        except Exception as e:  # keep serving on bad input
            print(f"error: {e}", file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--program", help="Datalog program file (default: TC demo)")
    ap.add_argument("--edb", action="append", default=[],
                    metavar="NAME=FILE.csv", help="load a relation from CSV")
    ap.add_argument("--synthetic", metavar="FAMILY:ARGS",
                    help="synthetic 'arc' relation: gnp:N[:P] | "
                         "dag:N[:P][:W] (weighted, acyclic: counting/"
                         "max-plus programs) | grid:N | tree:H | "
                         "paths:COUNT[:LEN]")
    ap.add_argument("--query", dest="actions", action="append",
                    type=lambda s: ("query", s), metavar="'tc(1, X)'")
    ap.add_argument("--append", dest="actions", action="append",
                    type=lambda s: ("append", s), metavar="rel:v1,v2[;...]")
    ap.set_defaults(actions=[])  # --query/--append interleave in CLI order
    ap.add_argument("--batch", action="store_true",
                    help="coalesce consecutive --query flags into ask_batch")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="serve through the continuous-batching admission "
                         "front-end (futures + windowed coalescing)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="async coalescing window: flush when the oldest "
                         "waiting query has aged this much")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="async flush size cap")
    ap.add_argument("--queue-depth", type=int, default=1024,
                    help="async admission bound; beyond it submits are shed "
                         "with QueueFullError")
    ap.add_argument("--cache", type=int, default=1024,
                    help="result-cache capacity (0 disables)")
    ap.add_argument("--sparse", choices=["auto", "csr", "dense"],
                    default="auto",
                    help="closure representation for decomposable predicates:"
                         " csr forces the O(|E|)-per-iteration packed engine,"
                         " dense the O(n^2) matrix, auto picks by density")
    ap.add_argument("--tune", action="store_true",
                    help="autotune the CSR kernel layout per relation "
                         "(measured search; see kernels/autotune.py)")
    ap.add_argument("--default-cap", type=int, default=1 << 16)
    ap.add_argument("--durable", metavar="DIR",
                    help="crash-safe serving state under DIR (WAL + "
                         "snapshots): appends write-ahead-log before "
                         "mutating, and startup recovers warm from the "
                         "newest complete snapshot + WAL replay")
    ap.add_argument("--snapshot-every", type=int, default=0, metavar="N",
                    help="with --durable: auto-snapshot after every N "
                         "appends (0 = only explicit .snapshot / exit)")
    ap.add_argument("--stats", action="store_true",
                    help="print service stats after all actions")
    ap.add_argument("--metrics-out", metavar="FILE",
                    help="export the unified metrics registry after all "
                         "actions: Prometheus text for .prom/.txt, JSON "
                         "otherwise")
    ap.add_argument("--trace-out", metavar="FILE.json",
                    help="record spans and export a Chrome trace_event "
                         "timeline (chrome://tracing / Perfetto) after all "
                         "actions")
    ap.add_argument("--repl", action="store_true",
                    help="read queries/appends from stdin after the actions")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    program = TC_DEMO
    if args.program:
        with open(args.program) as f:
            program = f.read()
    db = _load_edb(args.edb)
    if args.synthetic:
        db["arc"] = _synthetic(args.synthetic)
    if not db:
        raise SystemExit("no EDB: pass --edb and/or --synthetic")

    from .session import DatalogService
    svc = DatalogService(program, db, result_cache=args.cache,
                         default_cap=args.default_cap,
                         sparse={"auto": None, "csr": True,
                                 "dense": False}[args.sparse],
                         tune=args.tune or None,
                         tracer=bool(args.trace_out),
                         durable_dir=args.durable,
                         snapshot_every=args.snapshot_every,
                         device=args.device)
    front = None
    if args.use_async:
        from .admission import AsyncDatalogService
        front = AsyncDatalogService(svc, max_wait_ms=args.max_wait_ms,
                                    max_batch=args.max_batch,
                                    queue_depth=args.queue_depth)
    serve = front if front is not None else svc

    pending: list = []  # sync --batch: query strings; async: (query, future)

    def flush():
        if not pending:
            return
        if front is not None:
            for query, fut in pending:
                _print_answer(query, fut.result())
        else:
            for query, res in zip(pending, svc.ask_batch(list(pending))):
                _print_answer(query, res)
        pending.clear()

    for kind, spec in args.actions:
        if kind == "query":
            if front is not None:
                # submit now, gather at the next barrier: consecutive
                # queries land in one dispatcher window and coalesce
                pending.append((spec, front.submit(spec)))
            elif args.batch:
                pending.append(spec)
            else:
                _print_answer(spec, svc.ask(spec))
        else:
            flush()
            rel, rows = _parse_append(spec)
            serve.append(rel, rows)
            print(f"appended {len(rows)} rows to {rel} (epoch {serve.epoch})")
    flush()

    if args.repl:
        _repl(serve)
    if front is not None:
        front.drain()
    if args.stats:
        print(json.dumps(serve.explain(), indent=2, default=str))
    if args.metrics_out:
        svc.metrics.export(args.metrics_out)
        print(f"metrics -> {args.metrics_out}", file=sys.stderr)
    if args.trace_out:
        svc.tracer.export_chrome(args.trace_out)
        print(f"trace -> {args.trace_out}", file=sys.stderr)
    if front is not None:
        front.close()
    if args.durable:
        # planned shutdown: publish a final snapshot so the next start
        # recovers warm with an empty WAL suffix, then release the WAL
        svc.snapshot(wait=True)
        svc.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
