"""The port's serving CLI (``python -m repro_torch.service.serve``) against
JAX's (``repro.service.serve``) on the same actions, and the two Datalog
examples ported onto ``repro_torch``.

Each case runs both ``main``s in this process (the port's with ``--device
cpu``) and compares every answer line and append line exactly: plain
queries, ``--batch``, ``--async``, a weighted program from a file, the REPL,
and ``--durable`` run twice, where the second run must recover warm in both
packages.  The examples run in a fresh interpreter and must exit 0."""
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.service import serve as jserve
from repro_torch.service import serve as tserve

ROOT = Path(__file__).resolve().parents[1]
GRAPH = ["--synthetic", "gnp:120:0.02"]
QUERIES = ["--query", "tc(0, X)", "--query", "tc(5, X)", "--query",
           "tc(7, 9)", "--query", "tc(X, 3)", "--append", "arc:0,119;119,5",
           "--query", "tc(0, X)", "--query", "tc(119, X)"]
LPATH = """
lpath(X,Z,max<D>) <- arc(X,Z,D).
lpath(X,Z,max<D>) <- lpath(X,Y,D1), arc(Y,Z,D2), D = D1 + D2.
"""


def _run(main, argv, capsys, stdin=None, monkeypatch=None):
    """stdout of one ``main(argv)``, split into the action lines and the
    ``--stats`` report (None without it)."""
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    assert main(argv) == 0
    out = capsys.readouterr().out
    start = out.find("\n{")
    if out.startswith("{"):
        start = 0
    if start < 0:
        return out.splitlines(), None
    return out[:start].splitlines(), json.loads(out[start:])


def _both(argv, capsys, **kw):
    jlines, jstats = _run(jserve.main, argv, capsys, **kw)
    tlines, tstats = _run(tserve.main, argv + ["--device", "cpu"], capsys,
                          **kw)
    assert tlines == jlines
    assert any(line.endswith("rows]") for line in tlines)
    return tlines, jstats, tstats


@pytest.mark.parametrize("mode", ["plain", "batch", "async"])
def test_actions_print_what_jax_prints(capsys, mode):
    flags = {"plain": [], "batch": ["--batch"], "async": ["--async"]}[mode]
    lines, jstats, tstats = _both(GRAPH + QUERIES + flags + ["--stats"],
                                  capsys)
    assert "appended 2 rows to arc (epoch 1)" in lines
    assert tstats["epoch"] == jstats["epoch"] == 1
    assert tstats["cache"] == jstats["cache"]
    if mode == "async":
        assert tstats["admission"]["counters"]["appends"] == 1
        assert tstats["admission"].keys() == jstats["admission"].keys()


@pytest.mark.parametrize("sparse", ["dense", "csr"])
def test_weighted_program_file(tmp_path, capsys, sparse):
    prog = tmp_path / "lpath.dl"
    prog.write_text(LPATH)
    _both(["--program", str(prog), "--synthetic", "dag:80:0.08:5",
           "--sparse", sparse, "--query", "lpath(0, X, D)",
           "--query", "lpath(3, X, D)", "--append", "arc:0,79,4",
           "--query", "lpath(0, X, D)"], capsys)


def test_durable_twice_recovers_warm(tmp_path, capsys):
    runs = {}
    for pkg in ("jax", "port"):
        argv = GRAPH + ["--durable", str(tmp_path / pkg)] + QUERIES + [
            "--stats"]
        main = jserve.main if pkg == "jax" else tserve.main
        extra = [] if pkg == "jax" else ["--device", "cpu"]
        runs[pkg] = [_run(main, argv + extra, capsys) for _ in range(2)]
    for k in range(2):
        assert runs["port"][k][0] == runs["jax"][k][0]
    for pkg in ("jax", "port"):
        (_, first), (_, second) = runs[pkg]
        assert first["durability"]["recovery"]["mode"] == "fresh"
        rec = second["durability"]["recovery"]
        # the planned exit published a final snapshot: no WAL suffix
        assert rec["mode"] == "warm" and rec["wal_replayed"] == 0
        assert second["durability"]["snapshots"]["steps"] == [1]
        assert second["epoch"] == 2
    # each package's directory recovers in the other, warm
    for reader, writer in (("port", "jax"), ("jax", "port")):
        main = jserve.main if reader == "jax" else tserve.main
        extra = [] if reader == "jax" else ["--device", "cpu"]
        lines, stats = _run(main, GRAPH + ["--durable", str(
            tmp_path / writer), "--query", "tc(0, X)", "--stats"] + extra,
            capsys)
        assert stats["durability"]["recovery"]["mode"] == "warm"
        assert lines == _last_answer(runs[writer][1][0], "tc(0, X)")


def _last_answer(lines, query):
    """The lines of the last answer to ``query``: its header and rows."""
    start = max(i for i, line in enumerate(lines)
                if line.startswith(f"{query}  ["))
    end = start + 1
    while end < len(lines) and lines[end].startswith("  "):
        end += 1
    return lines[start:end]


def test_repl_prints_what_jax_prints(tmp_path, capsys, monkeypatch):
    script = "\n".join(["tc(0,X)", "+arc:0,119", "tc(0,X)", "bogus(",
                        ".snapshot", ".metrics", ":quit", "tc(1,X)"]) + "\n"
    out = {}
    for pkg, main, extra in (("jax", jserve.main, []),
                             ("port", tserve.main, ["--device", "cpu"])):
        lines, _ = _run(main, GRAPH + ["--durable", str(tmp_path / pkg),
                                       "--repl"] + extra, capsys,
                        stdin=script, monkeypatch=monkeypatch)
        out[pkg] = lines
    # the .metrics dump differs in the port's extra counters; the answer,
    # append and snapshot lines do not
    keep = [line for line in out["jax"]
            if not line.startswith("#") and not line.startswith("datalog_")]
    assert [line for line in out["port"] if not line.startswith("#")
            and not line.startswith("datalog_")] == keep
    assert "snapshot published (step 1)" in keep
    assert "appended 1 rows to arc (epoch 1)" in keep
    assert any(line.startswith("datalog_recovery_total")
               for line in out["port"])


def test_metrics_and_trace_exports(tmp_path, capsys):
    m, t = tmp_path / "m.prom", tmp_path / "t.json"
    _run(tserve.main, GRAPH + ["--query", "tc(0, X)", "--metrics-out",
                               str(m), "--trace-out", str(t), "--device",
                               "cpu"], capsys)
    for line in m.read_text().splitlines():
        if line and not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])
    assert json.loads(t.read_text())["traceEvents"]


@pytest.mark.parametrize("example", ["quickstart_torch.py",
                                     "serve_quickstart_torch.py"])
def test_example_runs_on_cpu(example):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / example),
                           "--device", "cpu"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip()
