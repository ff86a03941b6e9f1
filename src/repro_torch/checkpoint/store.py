"""Sharded, crash-consistent checkpoints (port of ``repro.checkpoint.store``).

Layout:  <dir>/step_<N>/shard_<k>.npz  +  manifest.json

The on-disk format is the JAX store's, so either package loads what the
other wrote:

* leaves are flattened with stable path keys (nested ``dict``s in sorted key
  order, ``list``s and ``tuple``s by index: ``"a/0/b"``, as JAX's
  ``tree_flatten_with_path`` spells them) and round-robined over
  ``n_shards`` npz files;
* writes go to ``step_<N>.tmp`` and are atomically renamed, so a crash
  mid-write never corrupts the latest checkpoint;
* the manifest records paths, shapes, dtypes, per-shard byte sizes and
  CRC32s, checked on load: a same-size bit flip inside a shard is caught
  before any array is trusted;
* ``load_checkpoint``/``load_checkpoint_raw`` degrade instead of dying: with
  no pinned step, a corrupt or torn generation falls back to the next-older
  complete one, and only when every generation fails does
  :class:`CheckpointCorrupt` escape;
* ``AsyncCheckpointer`` writes on a worker thread; the caller's thread copies
  every leaf to the host first, so no CUDA tensor and no view of a live
  tensor reaches the writer.  A failed background save surfaces ONCE as a
  :class:`CheckpointWriteError` on the next ``save()``/``wait()``, then
  clears.

bf16 leaves (npz has no bf16) are widened to f32 in the shard, recorded as
``"bfloat16"`` in the manifest, and narrowed back to ``torch.bfloat16`` on
load.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import zlib
from pathlib import Path

import numpy as np
import torch


def _leaves(tree, prefix: tuple = ()):
    """``(path, leaf)`` pairs in JAX's flattening order: dict keys sorted,
    sequences by index; ``None`` is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def _key(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def _unflatten(template, leaves):
    """Rebuild ``template``'s structure from its leaves in flattening order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # the template's own key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    return build(template)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host ndarray (bf16 widened to f32) and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten(tree) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    flat, dtypes = {}, {}
    for path, leaf in _leaves(tree):
        key = _key(path)
        flat[key], dtypes[key] = _to_numpy(leaf)
    return flat, dtypes


def save_checkpoint(ckpt_dir: str | Path, step: int, tree,
                    n_shards: int = 4) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat, dtypes = _flatten(tree)
    keys = sorted(flat)
    shards: list[dict[str, np.ndarray]] = [{} for _ in range(n_shards)]
    for i, k in enumerate(keys):
        shards[i % n_shards][k.replace("/", "__")] = flat[k]
    manifest = {"step": step, "n_shards": n_shards,
                "keys": keys,
                "shapes": {k: list(flat[k].shape) for k in keys},
                "dtypes": {k: dtypes[k] for k in keys},
                "shard_bytes": [], "shard_crc": []}
    for si, shard in enumerate(shards):
        path = tmp / f"shard_{si}.npz"
        np.savez(path, **shard)
        manifest["shard_bytes"].append(path.stat().st_size)
        manifest["shard_crc"].append(zlib.crc32(path.read_bytes()) & 0xFFFFFFFF)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    return final


class CheckpointCorrupt(RuntimeError):
    pass


class CheckpointWriteError(RuntimeError):
    """A background checkpoint save failed (disk full, permissions, a
    non-serializable leaf...).  Raised ONCE by the next
    ``AsyncCheckpointer.save()``/``wait()`` and then cleared: the writer
    stays usable for later steps."""


def latest_step(ckpt_dir: str | Path) -> int | None:
    steps = complete_steps(ckpt_dir)
    return steps[0] if steps else None


def complete_steps(ckpt_dir: str | Path) -> list[int]:
    """Steps with a published manifest, newest first: the fallback ladder
    ``load_checkpoint*`` walks when a generation turns out corrupt."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    steps = []
    for p in ckpt_dir.iterdir():
        if p.name.startswith("step_") and not p.name.endswith(".tmp") and (
                p / "manifest.json").exists():
            steps.append(int(p.name.split("_")[1]))
    return sorted(steps, reverse=True)


def _load_step_flat(ckpt_dir: Path, step: int):
    """Read one generation as ``(flat {path-key: array}, manifest)``; every
    failure mode (torn manifest, missing shard, size drift, bit flip)
    surfaces as :class:`CheckpointCorrupt`, so the caller falls back
    uniformly."""
    d = ckpt_dir / f"step_{step:08d}"
    try:
        manifest = json.loads((d / "manifest.json").read_text())
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(f"{d}: unreadable manifest: {e}") from e
    flat: dict[str, np.ndarray] = {}
    for si in range(manifest["n_shards"]):
        path = d / f"shard_{si}.npz"
        try:
            raw = path.read_bytes()
        except OSError as e:
            raise CheckpointCorrupt(f"{path}: unreadable shard: {e}") from e
        if len(raw) != manifest["shard_bytes"][si]:
            raise CheckpointCorrupt(f"{path} size mismatch vs manifest")
        want_crc = manifest.get("shard_crc")  # absent on older saves
        if want_crc is not None and (
                zlib.crc32(raw) & 0xFFFFFFFF) != want_crc[si]:
            raise CheckpointCorrupt(f"{path} CRC mismatch vs manifest")
        try:
            with np.load(path) as z:
                for k in z.files:
                    flat[k.replace("__", "/")] = z[k]
        except Exception as e:  # zip/npz-level damage the CRC gate missed
            raise CheckpointCorrupt(f"{path}: undecodable shard: {e}") from e
    missing = [k for k in manifest["keys"] if k not in flat]
    if missing:
        raise CheckpointCorrupt(f"{d}: shards lost leaves {missing[:4]}")
    return flat, manifest


def _fallback_load(ckpt_dir: Path, step: int | None, restore):
    """Shared degradation ladder: a pinned step is one attempt; ``step=None``
    walks complete generations newest first and raises only after ALL
    fail."""
    if step is not None:
        return restore(*_load_step_flat(ckpt_dir, step)), step
    steps = complete_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    errors = []
    for s in steps:
        try:
            return restore(*_load_step_flat(ckpt_dir, s)), s
        except CheckpointCorrupt as e:
            errors.append(str(e))
    raise CheckpointCorrupt(
        f"every checkpoint generation under {ckpt_dir} is corrupt: "
        + "; ".join(errors[:4]))


def load_checkpoint(ckpt_dir: str | Path, template, step: int | None = None,
                    device=None):
    """Restore into the structure of ``template``, a nested dict/list/tuple
    of tensors or ndarrays (shapes verified, dtypes taken from it).  Tensor
    leaves land on ``device``, or on their template leaf's device when it is
    None; ndarray leaves come back as ndarrays.

    With ``step=None`` a corrupt newest generation (torn shard, bit flip,
    template mismatch) falls back to the next-older complete one."""
    ckpt_dir = Path(ckpt_dir)

    def restore(flat: dict[str, np.ndarray], manifest: dict):
        out = []
        for path, leaf in _leaves(template):
            key = _key(path)
            if key not in flat:
                raise CheckpointCorrupt(f"missing leaf {key}")
            arr = flat[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise CheckpointCorrupt(
                    f"{key}: shape {arr.shape} != {tuple(leaf.shape)}")
            if isinstance(leaf, torch.Tensor):
                out.append(torch.from_numpy(np.array(arr)).to(
                    device=leaf.device if device is None else device,
                    dtype=leaf.dtype))
            else:
                out.append(np.asarray(arr, np.asarray(leaf).dtype))
        return _unflatten(template, out)

    return _fallback_load(ckpt_dir, step, restore)


def load_checkpoint_raw(ckpt_dir: str | Path, step: int | None = None):
    """Template-free restore: the flat ``{path-key: array}`` dict plus the
    step it came from.  Leaves are ndarrays, except those the manifest
    records as ``bfloat16``, which come back as ``torch.bfloat16`` CPU
    tensors.  The durable serving layer uses this: its snapshot trees are
    dynamic (cache contents, relation counts), so no template exists ahead
    of the load.  Same fallback ladder as :func:`load_checkpoint`."""
    ckpt_dir = Path(ckpt_dir)

    def restore(flat: dict[str, np.ndarray], manifest: dict):
        dtypes = manifest.get("dtypes", {})
        out = {}
        for k, arr in flat.items():
            if dtypes.get(k) == "bfloat16":  # widened to f32 in the npz
                arr = torch.from_numpy(np.array(arr, np.float32)).to(
                    torch.bfloat16)
            out[k] = arr
        return out

    return _fallback_load(ckpt_dir, step, restore)


def _host_copy(leaf):
    """A host copy that shares no memory with ``leaf``: ``.cpu()`` copies a
    CUDA tensor but returns a CPU tensor itself, so those are cloned."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.cpu() if t.device.type != "cpu" else t.clone()
    return np.array(leaf, copy=True)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return None if tree is None else fn(tree)


class AsyncCheckpointer:
    """Background-thread checkpoint writer with at most one save in
    flight."""

    def __init__(self, ckpt_dir: str | Path, n_shards: int = 4):
        self.ckpt_dir = Path(ckpt_dir)
        self.n_shards = n_shards
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Exception | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree = item
            try:
                save_checkpoint(self.ckpt_dir, step, tree, self.n_shards)
            except Exception as e:  # noqa: BLE001
                self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        # raise once, then clear: one failed write reports and recovers
        err, self._err = self._err, None
        if err is not None:
            raise CheckpointWriteError(
                f"background checkpoint save failed: {err}") from err

    def save(self, step: int, tree, copy: bool = True):
        """Queue ``tree`` for writing as ``step``.  The copy to the host
        happens here, in the caller's thread; ``copy=False`` hands over a
        tree of host arrays that nothing else references (the caller made
        them) without copying them again."""
        self._raise_pending()
        host_tree = _map(tree, _host_copy) if copy else tree
        self._q.put((step, host_tree))  # blocks iff a save is in flight

    def wait(self):
        self._q.join()
        self._raise_pending()

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=10)
