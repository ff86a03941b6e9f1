"""Quickstart on the PyTorch/CUDA port: ``examples/quickstart.py`` on
``repro_torch``.

Runs the paper's §2 examples end to end on the port's tuple engine:
  * transitive closure (Example 10)
  * shortest paths with min-in-recursion, linear + non-linear (Examples 2/3)
  * the ATTEND party query with count-in-recursion (Example 4)
  * query-driven evaluation: the magic-sets rewrite (``Engine.ask``)

Usage:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

With no ``--device`` it runs on ``cuda`` (and raises without a GPU);
``--device cpu`` runs the kernels' plain PyTorch versions.
"""
import argparse

import numpy as np

from repro_torch.core.engine import Engine
from repro_torch.core.parser import parse_program, parse_query
from repro_torch.core.planner import PlanOptions, plan_program
from repro_torch.device import resolve_device


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    dev = resolve_device(parser.parse_args(argv).device)

    # ------------------------------------------------------------ TC
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 1], [4, 0]])
    eng = Engine("""
    tc(X,Y) <- arc(X,Y).
    tc(X,Y) <- tc(X,Z), arc(Z,Y).
    """, db={"arc": edges}, default_cap=4096, device=dev).run()
    print(f"TC: {len(eng.query('tc'))} pairs, "
          f"{eng.stats['tc'].iterations} semi-naive iterations, "
          f"{eng.stats['tc'].generated} facts generated before dedup")

    # --------------------------------------------- shortest paths (PreM)
    darc = np.array([[0, 1, 4], [0, 2, 1], [2, 1, 1], [1, 3, 2], [3, 0, 7]])
    eng = Engine("""
    dpath(X,Z,min<D>) <- darc(X,Z,D).
    dpath(X,Z,min<D>) <- dpath(X,Y,Dxy), darc(Y,Z,Dyz), D = Dxy + Dyz.
    spath(X,Z,D) <- dpath(X,Z,D).
    """, db={"darc": darc}, default_cap=4096, device=dev).run()
    rows, vals = eng.query_agg("dpath")
    print("shortest distances (the is_min constraint transferred into "
          "recursion --")
    print("the graph has a cycle 0->...->3->0, yet the fixpoint terminates):")
    for r, v in sorted(zip(rows.tolist(), vals.tolist())):
        print(f"  spath({r[0]}, {r[1]}) = {v}")

    # non-linear variant (Example 3): same answers, log-depth convergence
    eng2 = Engine("""
    dpath(X,Z,min<D>) <- darc(X,Z,D).
    dpath(X,Z,min<D>) <- dpath(X,Y,D1), dpath(Y,Z,D2), D = D1 + D2.
    """, db={"darc": darc}, default_cap=4096, device=dev).run()
    print(f"non-linear r5 converges in {eng2.stats['dpath'].iterations} "
          f"iterations (linear took {eng.stats['dpath'].iterations})")

    # --------------------------------------------------- ATTEND (count)
    friend = np.array([[1, 0], [2, 0], [1, 2], [2, 1], [3, 1], [3, 2],
                       [4, 3], [4, 1], [5, 4], [5, 3]])
    organizer = np.array([[0], [2]])
    eng = Engine("""
    attend(X) <- organizer(X).
    attend(X) <- cntfriends(X,N), N >= 2.
    cntfriends(Y, count<X>) <- attend(X), friend(Y,X).
    """, db={"friend": friend, "organizer": organizer}, default_cap=4096,
        device=dev).run()
    print(f"ATTEND cascade: {sorted(int(r[0]) for r in eng.query('attend'))}")

    # --------------------------------------- query-driven (magic sets)
    eng = Engine("""
    tc(X,Y) <- arc(X,Y).
    tc(X,Y) <- tc(X,Z), arc(Z,Y).
    """, db={"arc": edges}, default_cap=4096, device=dev).run()
    src_rows = eng.ask("tc", (1, None))
    print(f"ask tc(1, X): {sorted(int(r[1]) for r in src_rows)} -- the magic "
          f"rewrite generated {eng.stats['tc__bf'].generated} facts vs "
          f"{eng.stats['tc'].generated} for the full model")
    dense_rows = eng.ask_dense("tc", (1, None))
    assert {tuple(map(int, r)) for r in dense_rows} == \
        {tuple(map(int, r)) for r in src_rows}
    print("ask_dense agrees: the decomposable query lowered to a "
          "frontier-seeded vector fixpoint")

    # the planner's view of TC: decomposable (GPS on the first argument)
    tc_prog = """
    tc(X,Y) <- arc(X,Y).
    tc(X,Y) <- tc(X,Z), arc(Z,Y).
    """
    plan = plan_program(parse_program(tc_prog))
    gp = [g for g in plan.groups if "tc" in g.preds][0]
    print(f"planner: tc pivot={gp.pivot['tc']} rwa_cost={gp.rwa_cost} "
          "(decomposable: the distributed plan runs shuffle-free, paper "
          "Fig. 4)")
    qplan = plan_program(parse_program(tc_prog),
                         PlanOptions(query=parse_query("tc(1, X)")))
    print(f"planner passes: {' -> '.join(qplan.passes)}; "
          f"query compiles to {qplan.query_pred}")


if __name__ == "__main__":
    main()
