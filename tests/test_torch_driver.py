"""Port parity of the training runtime: ``data.tokens`` (``TokenPipeline``,
``masked_frame_batch``, ``vlm_batch``) bit-equal to the JAX package's;
``runtime.TrainDriver`` with failure injection and ``run_with_restarts``
bit-identical to an uninterrupted run; straggler detection and
``reshard``; and the launchers (``python -m repro_torch.launch.train``,
``examples/train_lm_torch.py``, ``examples/serve_lm_torch.py``) on the
CPU."""
import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import tokens as jtokens
from repro_torch.configs import get_config
from repro_torch.data import tokens
from repro_torch.models.model import Model
from repro_torch.runtime import (DriverConfig, SimulatedFailure, TrainDriver,
                                 run_with_restarts)
from repro_torch.train import AdamWConfig

ROOT = Path(__file__).resolve().parents[1]


def _tiny(seq=32):
    cfg = get_config("qwen3-14b", smoke=True)
    model = Model(cfg, tp=1, use_chunked_attn=False, remat=False,
                  device="cpu")
    pipe = tokens.TokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=8,
                                seed=3)
    return cfg, model, pipe


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 1), (4, 3)])
def test_token_pipeline_is_bit_equal_to_jax(n_hosts, host_id):
    """Batches 0..5 of each host's shard, and the motifs, equal JAX's."""
    kw = dict(vocab=1000, seq_len=48, global_batch=8, seed=7,
              n_hosts=n_hosts, host_id=host_id)
    mine, theirs = tokens.TokenPipeline(**kw), jtokens.TokenPipeline(**kw)
    assert np.array_equal(mine._motifs, theirs._motifs)
    for i in range(6):
        a, b = mine.batch(i), theirs.batch(i)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    it = iter(mine)
    assert np.array_equal(next(it)["tokens"], theirs.batch(0)["tokens"])


def test_frame_and_vlm_batches_are_bit_equal_to_jax():
    for fn in ("masked_frame_batch", "vlm_batch"):
        a = getattr(tokens, fn)(np.random.default_rng(5), 2, 40, 16, 100)
        b = getattr(jtokens, fn)(np.random.default_rng(5), 2, 40, 16, 100)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_restart_is_bit_identical(tmp_path):
    """20 steps uninterrupted against 20 with a failure injected at step
    13 (checkpoints every 8: restore step 8, replay 5): every parameter,
    every moment and the step equal bit for bit, and the losses after the
    restart equal the uninterrupted run's."""
    cfg, model, pipe = _tiny()
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60)
    dA = TrainDriver(model, opt, pipe,
                     DriverConfig(ckpt_dir=str(tmp_path / "a"), ckpt_every=8,
                                  max_steps=20, log_every=1000))
    logA = dA.run(20)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    wantm = {k: v.clone() for k, v in dA.opt_state["m"].items()}

    def mk():
        return TrainDriver(model, opt, pipe,
                           DriverConfig(ckpt_dir=str(tmp_path / "b"),
                                        ckpt_every=8, max_steps=20,
                                        log_every=1000, fail_at_steps=(13,)))
    dB = run_with_restarts(mk, 20)
    assert dB.step == 20 and int(dB.opt_state["step"]) == 20
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for k, v in dB.opt_state["m"].items():
        assert torch.equal(v, wantm[k]), k
    assert [r["loss"] for r in dB.metrics_log] == [
        r["loss"] for r in logA[8:]]
    assert logA[-1]["loss"] < logA[0]["loss"]


def test_failure_without_a_checkpoint_starts_over(tmp_path):
    """A failure before the first checkpoint restores nothing: the new
    driver starts from step 0 with the same seed, and ends where an
    uninterrupted run ends."""
    cfg, model, pipe = _tiny(seq=16)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    dA = TrainDriver(model, opt, pipe, DriverConfig(
        ckpt_dir=str(tmp_path / "a"), ckpt_every=100, max_steps=4))
    dA.run()
    want = {k: v.clone() for k, v in model.state_dict().items()}
    dB = run_with_restarts(lambda: TrainDriver(model, opt, pipe, DriverConfig(
        ckpt_dir=str(tmp_path / "b"), ckpt_every=100, max_steps=4,
        fail_at_steps=(2,))), 4)
    assert dB.step == 4
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    with pytest.raises(RuntimeError, match="restart budget"):
        run_with_restarts(lambda: TrainDriver(model, opt, pipe, DriverConfig(
            ckpt_dir=str(tmp_path / "c"), ckpt_every=100, max_steps=4,
            fail_at_steps=(1, 2, 3))), 4, max_restarts=1)
    assert issubclass(SimulatedFailure, RuntimeError)


def test_straggler_detection(tmp_path):
    """A step three times slower than the EMA is logged once (the driver
    times each step up to its loss reaching the host)."""
    import time
    cfg, model, pipe = _tiny(seq=16)
    d = TrainDriver(model, AdamWConfig(), pipe,
                    DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=10 ** 9,
                                 max_steps=10, log_every=1000,
                                 straggler_slack=3.0))
    orig = d.step_fn
    slow_at = 6

    def slow_step(o, b):
        if d.step == slow_at:
            time.sleep(max(0.5, 10 * d._ema))
        return orig(o, b)

    d.step_fn = slow_step
    d.run(10)
    assert [e["step"] for e in d.straggler_events] == [slow_at]


def test_reshard_keeps_the_global_stream(tmp_path):
    """``reshard`` re-partitions the global stream over a new host count:
    the driver's pipeline becomes host 1 of 2 (half the batch, its batches
    JAX's for that host), and the driver trains on."""
    cfg, model, pipe = _tiny(seq=16)
    d = TrainDriver(model, AdamWConfig(), pipe,
                    DriverConfig(ckpt_dir=str(tmp_path), max_steps=1))
    d.reshard(2, host_id=1)
    assert d.pipeline.n_hosts == 2 and d.pipeline.local_batch == 4
    want = jtokens.TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=8,
                                 seed=3, n_hosts=2, host_id=1).batch(3)
    assert np.array_equal(d.pipeline.batch(3)["tokens"], want["tokens"])
    d.run()
    assert d.step == 1 and d.metrics_log[0]["loss"] > 0


def test_driver_config_keeps_jax_fields():
    """The port's ``DriverConfig`` has JAX's fields and defaults; the
    driver's steps run in deterministic mode, which it restores after,
    leaving the environment as it was."""
    from repro.runtime import DriverConfig as JDriverConfig
    assert dataclasses.asdict(DriverConfig()) == dataclasses.asdict(
        JDriverConfig())
    before = torch.are_deterministic_algorithms_enabled()
    from repro_torch.runtime.driver import deterministic_algorithms
    env = dict(os.environ)
    with deterministic_algorithms():
        assert torch.are_deterministic_algorithms_enabled()
        assert dict(os.environ) == env
    assert torch.are_deterministic_algorithms_enabled() == before


def test_use_deterministic_cublas_keeps_a_callers_setting(monkeypatch):
    """The entry points' cuBLAS setting: the deterministic workspace when
    the environment has none, the caller's own otherwise."""
    from repro_torch.runtime import use_deterministic_cublas
    from repro_torch.runtime.driver import CUBLAS_DETERMINISTIC
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    use_deterministic_cublas()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == CUBLAS_DETERMINISTIC
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    use_deterministic_cublas()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"


def test_launch_train_runs_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu`` trains the
    RecurrentGemma-2B smoke config 3 steps through the driver."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "recurrentgemma-2b", "--smoke", "--steps", "3", "--batch", "2",
         "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    assert "finished at step 3; final loss" in out.stdout


def test_examples_run_on_cpu(tmp_path, capsys):
    """``examples/train_lm_torch.py`` at a tiny size (its injected failure
    halfway, a restart) and ``examples/serve_lm_torch.py``, on the CPU;
    with no ``--device`` both ask for the card and, without one, raise."""
    train = _example("train_lm_torch")
    d = train.main(["--dim", "64", "--layers", "1", "--vocab", "256",
                    "--steps", "6", "--batch", "2", "--seq", "16",
                    "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert d.step == 6
    out = capsys.readouterr().out
    assert "injected failure at step 3" in out and "done: step 6" in out
    serve = _example("serve_lm_torch")
    gen = serve.main(["--arch", "recurrentgemma-2b", "--batch", "2",
                      "--prompt-len", "4", "--gen", "3", "--device", "cpu"])
    assert gen.shape == (2, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--gen", "1"])
