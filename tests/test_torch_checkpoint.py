"""The port's checkpoint store (``repro_torch.checkpoint.store``) against
``repro.checkpoint.store``: round trips of tensors and arrays (bf16
included), path keys spelled as JAX's ``tree_flatten_with_path`` spells
them, the CRC gate, the fallback ladder, the asynchronous writer's
raise-once latch and its copy in the caller's thread, and generations
saved by either package loaded by the other's ``load_checkpoint_raw``."""
import numpy as np
import pytest
import torch
from _faults import bit_flip_shard, stale_manifest

from repro.checkpoint import store as jstore
from repro_torch.checkpoint import store as tstore
from repro_torch.checkpoint.store import (AsyncCheckpointer,
                                          CheckpointCorrupt,
                                          CheckpointWriteError,
                                          complete_steps, latest_step,
                                          load_checkpoint,
                                          load_checkpoint_raw,
                                          save_checkpoint)


def _tree(seed: int = 0) -> dict:
    """A nested tree of numpy leaves: dicts (keys out of order), a list, a
    tuple, several dtypes and a 0-d leaf."""
    rng = np.random.default_rng(seed)
    return {"w": {"b": rng.standard_normal(3).astype(np.float32),
                  "a": rng.integers(0, 9, (2, 3)).astype(np.int64)},
            "layers": [{"k": rng.random((2, 2)) < 0.5},
                       {"k": rng.integers(-5, 5, 4).astype(np.int8)}],
            "pair": (np.float32(2.5) * np.ones(()), np.arange(5, dtype=np.uint8)),
            "count": np.asarray(7, np.int64)}


def _as_tensors(tree):
    return tstore._map(tree, lambda a: torch.from_numpy(np.array(a)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64,
                                   torch.int8, torch.bool, torch.float64])
def test_round_trip_tensors(tmp_path, dtype):
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(4, 5, generator=g) * 7).to(dtype)
    tree = {"x": x, "nested": [x[:2], {"y": x[1]}]}
    save_checkpoint(tmp_path, 3, tree, n_shards=2)
    got, step = load_checkpoint(tmp_path, tree)
    assert step == 3
    for want, have in ((x, got["x"]), (x[:2], got["nested"][0]),
                       (x[1], got["nested"][1]["y"])):
        assert have.dtype == dtype and torch.equal(have, want)
    raw, _ = load_checkpoint_raw(tmp_path)
    if dtype == torch.bfloat16:  # widened in the npz, narrowed on load
        assert isinstance(raw["x"], torch.Tensor)
        assert raw["x"].dtype == torch.bfloat16 and torch.equal(raw["x"], x)
    else:
        assert isinstance(raw["x"], np.ndarray)
        assert np.array_equal(raw["x"], x.numpy())


def test_round_trip_numpy_template_and_device(tmp_path):
    tree = _tree(1)
    save_checkpoint(tmp_path, 1, tree)
    got, _ = load_checkpoint(tmp_path, tree)
    for (p, want), (q, have) in zip(tstore._leaves(tree), tstore._leaves(got)):
        assert p == q and isinstance(have, np.ndarray)
        assert have.dtype == np.asarray(want).dtype
        assert np.array_equal(have, want)
    assert isinstance(got["pair"], tuple) and isinstance(got["layers"], list)
    tens, _ = load_checkpoint(tmp_path, _as_tensors(tree), device="cpu")
    assert isinstance(tens["w"]["a"], torch.Tensor)
    assert torch.equal(tens["w"]["a"], torch.from_numpy(tree["w"]["a"]))


def test_path_keys_match_jax():
    tree = _tree(2)
    jflat = jstore._flatten(tree)
    tflat, dtypes = tstore._flatten(_as_tensors(tree))
    assert list(tflat) == list(jflat)  # same keys, same order
    for k in jflat:
        assert tflat[k].dtype == jflat[k].dtype and dtypes[k] == str(
            jflat[k].dtype)
        assert np.array_equal(tflat[k], jflat[k]), k


def test_shard_layout_matches_jax(tmp_path):
    """Both stores put the same leaves under the same npz member names in
    the same shards, with the same manifest (bar the byte counts and CRCs
    of the zip containers)."""
    import json
    tree = _tree(4)
    jstore.save_checkpoint(tmp_path / "jax", 5, tree, n_shards=3)
    save_checkpoint(tmp_path / "port", 5, _as_tensors(tree), n_shards=3)
    mj, mt = (json.loads((tmp_path / w / "step_00000005" / "manifest.json")
                         .read_text()) for w in ("jax", "port"))
    for k in ("step", "n_shards", "keys", "shapes", "dtypes"):
        assert mj[k] == mt[k], k
    for si in range(3):
        with np.load(tmp_path / "jax" / "step_00000005" / f"shard_{si}.npz") \
                as zj, np.load(tmp_path / "port" / "step_00000005" /
                               f"shard_{si}.npz") as zt:
            assert zj.files == zt.files
            for f in zj.files:
                assert zj[f].dtype == zt[f].dtype
                assert np.array_equal(zj[f], zt[f])


def test_crc_catches_a_flipped_byte(tmp_path):
    save_checkpoint(tmp_path, 1, {"a": np.arange(64, dtype=np.float32)},
                    n_shards=1)
    bit_flip_shard(tmp_path, step=1)  # same size: only the CRC sees it
    with pytest.raises(CheckpointCorrupt, match="CRC"):
        load_checkpoint_raw(tmp_path, step=1)
    with pytest.raises(CheckpointCorrupt):
        load_checkpoint_raw(tmp_path)  # no older generation to fall to


def test_fallback_ladder(tmp_path):
    t1 = {"a": torch.arange(6, dtype=torch.float32)}
    t2 = {"a": torch.arange(6, dtype=torch.float32) * 2}
    template = {"a": torch.zeros(6)}
    assert latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path, template)
    save_checkpoint(tmp_path, 1, t1, n_shards=1)
    save_checkpoint(tmp_path, 2, t2, n_shards=1)
    assert complete_steps(tmp_path) == [2, 1] and latest_step(tmp_path) == 2
    bit_flip_shard(tmp_path, step=2)
    got, step = load_checkpoint(tmp_path, template)
    assert step == 1 and torch.equal(got["a"], t1["a"])
    save_checkpoint(tmp_path, 3, t2, n_shards=1)
    stale_manifest(tmp_path, step=3)  # a shard vanished after publish
    _, step = load_checkpoint(tmp_path, template)
    assert step == 1
    # a template mismatch is corruption of that generation too
    save_checkpoint(tmp_path, 4, {"a": torch.zeros(7)}, n_shards=1)
    _, step = load_checkpoint(tmp_path, template)
    assert step == 1
    with pytest.raises(CheckpointCorrupt):
        load_checkpoint(tmp_path, template, step=4)  # pinned: one attempt
    bit_flip_shard(tmp_path, step=1)
    with pytest.raises(CheckpointCorrupt, match="every checkpoint"):
        load_checkpoint(tmp_path, template)


def test_async_checkpointer_raises_once(tmp_path):
    ckpt = AsyncCheckpointer(tmp_path / "not" / "a" / "dir")
    (tmp_path / "not").mkdir()
    (tmp_path / "not" / "a").write_text("in the way")  # a file, not a dir
    ckpt.save(1, {"x": torch.zeros(3)})
    with pytest.raises(CheckpointWriteError):
        ckpt.wait()
    ckpt.wait()  # the latch cleared: no second raise
    (tmp_path / "not" / "a").unlink()
    ckpt.save(2, {"x": torch.ones(3)})
    ckpt.close()
    got, step = load_checkpoint(tmp_path / "not" / "a" / "dir",
                                {"x": torch.zeros(3)})
    assert step == 2 and torch.equal(got["x"], torch.ones(3))


def test_async_save_copies_in_the_callers_thread(tmp_path, monkeypatch):
    """``save`` returns with its own copy of every leaf: changing the
    tensors (and an ndarray view of one) in place afterwards, while the
    writer is held back, does not change what is written."""
    import threading
    gate = threading.Event()
    real = tstore.save_checkpoint

    def held(*a, **k):
        gate.wait(timeout=60)
        return real(*a, **k)

    monkeypatch.setattr(tstore, "save_checkpoint", held)
    x = torch.arange(8, dtype=torch.float32)
    b = torch.ones(4, dtype=torch.bfloat16)
    view = x.numpy()[2:6]  # shares x's memory
    ckpt = AsyncCheckpointer(tmp_path)
    ckpt.save(1, {"x": x, "b": b, "view": view})
    x.add_(100)
    b.mul_(3)
    gate.set()
    ckpt.close()
    raw, _ = load_checkpoint_raw(tmp_path)
    assert np.array_equal(raw["x"], np.arange(8, dtype=np.float32))
    assert np.array_equal(raw["view"], np.arange(2, 6, dtype=np.float32))
    assert torch.equal(raw["b"], torch.ones(4, dtype=torch.bfloat16))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_generations_cross_packages(tmp_path, writer):
    """A generation saved by either store loads through the other's
    ``load_checkpoint_raw`` with the same keys, dtypes and values."""
    tree = _tree(5)
    if writer == "jax":
        jstore.save_checkpoint(tmp_path, 7, tree, n_shards=2)
        got, step = load_checkpoint_raw(tmp_path)
    else:
        save_checkpoint(tmp_path, 7, _as_tensors(tree), n_shards=2)
        got, step = jstore.load_checkpoint_raw(tmp_path)
    assert step == 7
    want = jstore._flatten(tree)
    assert sorted(got) == sorted(want)
    for k, arr in want.items():
        have = np.asarray(got[k])
        assert have.dtype == arr.dtype and np.array_equal(have, arr), k


def test_port_bf16_narrows_in_jax(tmp_path):
    """The port records a bf16 leaf as ``bfloat16``: JAX's raw loader
    narrows it back, to the same values."""
    x = torch.tensor([1.5, -2.25, 3.0e5, 0.0], dtype=torch.bfloat16)
    save_checkpoint(tmp_path, 1, {"x": x}, n_shards=1)
    got, _ = jstore.load_checkpoint_raw(tmp_path)
    assert str(got["x"].dtype) == "bfloat16"
    assert np.array_equal(np.asarray(got["x"], np.float32), x.float().numpy())
