"""Crash-safe durability for the serving tier: WAL + snapshots + recovery.

Port of ``repro.service.durable``, with its file formats byte for byte, so a
durable directory written by either package recovers in the other.  It
gives a :class:`~repro_torch.service.session.DatalogService` the durability
story of a relational system, in three layers:

* **write-ahead log** (:class:`WriteAheadLog`): every monotone EDB append is
  framed (length + CRC32 over the payload), appended to ``wal.log`` and
  fsync'd *before* the in-memory state mutates.  Replay walks the frames in
  order; the first bad CRC or short read marks a torn tail, which is
  truncated (a crash mid-append loses at most the append in flight).  A
  record is the relation name, the validated ``(m, arity)`` int64 rows and
  the post-append epoch.

* **snapshots**: :func:`snapshot_state` flattens the hot serving state to a
  flat ``{positional-key: ndarray}`` tree (the EDB, the dense/CSR carrier
  relations through ``core.sparse.csr_to_state``, the answer cache's raw
  closure rows and the batched tuple templates' fixpoint snapshots) plus a
  JSON ``meta`` leaf naming everything.  It copies every array to the host
  under the service lock; the checkpoint store's background writer
  (:class:`~repro_torch.checkpoint.store.AsyncCheckpointer`) then writes the
  copies, so the serving path never waits on file I/O.  Keys are positional
  (``db/0``, ``cache/3/rows``) because the store escapes ``/`` as ``__`` in
  npz member names: relation names like ``__qseed_tc__bf`` never appear in
  a key.

* **recovery** (:meth:`DurabilityManager.recover`): the newest *complete*
  snapshot is restored through the template-free loader onto the service's
  device, then the WAL records past its ``wal_seq`` replay through the
  ordinary ``DatalogService.append``, which resumes cached closures through
  the fixpoints (the CUDA kernels on the card).  A restarted service is
  therefore *warm* (caches, carriers and tuple snapshots populated) and
  bit-identical to a twin that never restarted.

Graceful degradation, never a crash: a corrupt newest snapshot falls back to
the previous generation (``keep_snapshots`` are kept), then to a cold
rebuild from the genesis EDB and a full WAL replay.  Replaying a record
twice is a no-op (EDB relations are sets under appends, and the additive
carriers filter resident arcs), so replaying from an older point is safe,
only slower.  The path taken is reported in ``explain()["durability"]`` and
the ``datalog_recovery_*`` / ``datalog_wal_*`` / ``datalog_snapshot*``
metrics, with ``wal_append`` / ``snapshot`` / ``recover`` spans.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from ..checkpoint.store import (AsyncCheckpointer, CheckpointCorrupt,
                                CheckpointWriteError, complete_steps,
                                load_checkpoint_raw)
from ..core import sparse as _sparse
from ..core.query import RowSet, unique_rows
from ..core.semiring import BOOL, carrier_for, edge_arity
from ..obs.trace import NULL_TRACER
from . import incremental as _inc
from .cache import CacheEntry
from .session import _DenseRelation, _freeze

__all__ = ["WriteAheadLog", "DurabilityManager", "WalCorrupt",
           "snapshot_state", "restore_state"]

_WAL_MAGIC = b"DWAL0001"
_WAL_HDR = struct.Struct("<II")  # (payload byte length, CRC32 of payload)


class WalCorrupt(RuntimeError):
    """A WAL frame failed validation where replay cannot repair it (bad
    magic).  Torn *tails* never raise: they truncate."""


def _crc(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


def _pack_record(rel: str, rows: np.ndarray, epoch: int) -> bytes:
    rows = np.ascontiguousarray(np.asarray(rows, np.int64))
    head = json.dumps({"rel": rel, "shape": list(rows.shape),
                       "epoch": int(epoch)}).encode()
    return head + b"\n" + rows.tobytes()


def _unpack_record(payload: bytes):
    head, _, body = payload.partition(b"\n")
    meta = json.loads(head.decode())
    rows = np.frombuffer(body, np.int64).reshape(meta["shape"]).copy()
    return meta["rel"], rows, int(meta["epoch"])


def _frames(f):
    """Yield ``(payload, end offset)`` for every intact frame after the
    magic; stops at the first short or CRC-failing one."""
    while True:
        hdr = f.read(_WAL_HDR.size)
        if len(hdr) < _WAL_HDR.size:
            return  # clean EOF or torn header
        length, crc = _WAL_HDR.unpack(hdr)
        payload = f.read(length)
        if len(payload) < length or _crc(payload) != crc:
            return  # torn tail: short payload or bit rot in the last frame
        yield payload, f.tell()


class WriteAheadLog:
    """Append-only, CRC32-framed, fsync'd log of EDB appends.

    Frame layout after the 8-byte magic: ``<u32 len><u32 crc32>payload``.
    ``fsync=False`` trades the durability of the last few records for append
    latency (the OS still orders the writes); recovery is the same either
    way."""

    def __init__(self, path: str | Path, fsync: bool = True):
        self.path = Path(path)
        self.fsync = fsync
        self.records = 0  # records currently in the file (set by the scan)
        self.torn_bytes = 0  # bytes truncated off the tail at open
        if not (self.path.exists() and self.path.stat().st_size > 0):
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.path, "wb") as f:
                f.write(_WAL_MAGIC)
                f.flush()
                os.fsync(f.fileno())
        self._f = open(self.path, "r+b")
        self._scan_and_repair()
        self._f.seek(0, os.SEEK_END)

    def _scan_and_repair(self) -> None:
        """Walk the frames; truncate at the first torn or corrupt one."""
        f = self._f
        f.seek(0)
        magic = f.read(len(_WAL_MAGIC))
        if magic != _WAL_MAGIC:
            raise WalCorrupt(f"{self.path}: bad WAL magic {magic!r}")
        good_end = f.tell()
        n = 0
        for payload, end in _frames(f):
            try:
                _unpack_record(payload)
            except Exception:  # undecodable despite its CRC: treat as torn
                break
            good_end = end
            n += 1
        end = f.seek(0, os.SEEK_END)
        if end > good_end:
            self.torn_bytes = end - good_end
            f.truncate(good_end)
            f.flush()
            os.fsync(f.fileno())
        self.records = n

    def append(self, rel: str, rows: np.ndarray, epoch: int) -> int:
        """Frame, append and (optionally) fsync one record; returns its
        sequence number (0-based position in the log)."""
        payload = _pack_record(rel, rows, epoch)
        self._f.write(_WAL_HDR.pack(len(payload), _crc(payload)) + payload)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        seq = self.records
        self.records += 1
        return seq

    def replay(self):
        """Yield ``(rel, rows, epoch)`` for every intact record (the torn
        tail, if any, was truncated at open)."""
        with open(self.path, "rb") as f:
            f.read(len(_WAL_MAGIC))
            for payload, _ in _frames(f):
                yield _unpack_record(payload)

    @property
    def nbytes(self) -> int:
        return self.path.stat().st_size if self.path.exists() else 0

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self._f.close()


# ---------------------------------------------------------------------------
# Snapshot (de)construction
# ---------------------------------------------------------------------------


def _host(x, dtype=None) -> np.ndarray:
    """A host copy of a tensor or array that shares no memory with it: a
    CPU tensor's ``.numpy()`` and a numpy view would otherwise let a later
    in-place update tear a snapshot still waiting for the writer."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        arr = t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()
        return arr if dtype is None else arr.astype(dtype, copy=False)
    return np.array(x, dtype=dtype, copy=True)


def _carrier_dtype(kind: str):
    """The numpy dtype the JAX package stores a carrier's matrix and cache
    rows in: bool for the boolean carrier, float32 for the others."""
    return np.bool_ if kind == "bool" else np.float32


def snapshot_state(svc, wal_seq: int) -> dict:
    """Flatten the hot serving state to ``{positional-key: ndarray}``.

    Must run under ``svc.lock``: the tree is a consistent cut of (EDB,
    carrier relations, answer cache, tuple snapshots) at one epoch.  Every
    array is copied to the host here, so appends after the call cannot
    change what the writer thread later puts on disk."""
    meta: dict = {"epoch": svc.epoch, "wal_seq": int(wal_seq),
                  "db": [], "dense": [], "cache": [], "snaps": []}
    flat: dict[str, np.ndarray] = {}
    for i, rel in enumerate(sorted(svc.db)):
        meta["db"].append(rel)
        flat[f"db/{i}"] = _host(svc.db[rel])
    for i, (pred, ds) in enumerate(sorted(svc._dense.items())):
        d = {"pred": pred, "n": int(ds.n), "n_alloc": int(ds.n_alloc),
             "flips": int(ds.flips), "last_flip": ds.last_flip}
        if ds.is_csr:
            arrays, cmeta = _sparse.csr_to_state(ds.csr)
            d["repr"], d["csr_meta"] = "csr", cmeta
            # from the card, csr_to_state's .cpu() made the copies already
            copied = ds.csr.row_ptr.device.type != "cpu"
            for name, arr in arrays.items():
                flat[f"rel/{i}/{name}"] = arr if copied else _host(arr)
        else:
            d["repr"] = "dense"
            flat[f"rel/{i}/matrix"] = _host(ds.matrix,
                                            _carrier_dtype(ds.low.kind))
        meta["dense"].append(d)
    # dense entries' raw carrier rows stack into one array per (shape,
    # dtype) group: a handful of npz members instead of one per entry
    groups: dict[tuple, list[np.ndarray]] = {}
    group_ids: dict[tuple, int] = {}
    for i, (key, ent) in enumerate(svc.cache.items()):  # oldest -> newest
        c = {"key": list(key), "kind": ent.kind, "pred": ent.pred,
             "src": ent.src, "hits": int(ent.hits)}
        if ent.kind == "dense":
            raw = np.asarray(ent.raw,
                             _carrier_dtype(svc._lowering(ent.pred).kind))
            gkey = (raw.shape, str(raw.dtype))
            g = group_ids.setdefault(gkey, len(group_ids))
            rows = groups.setdefault(gkey, [])
            c["g"], c["i"] = g, len(rows)
            rows.append(raw)
        else:
            res = ent.result
            if isinstance(res, tuple):
                c["agg"] = True
                flat[f"cache/{i}/rows"] = _host(res[0])
                flat[f"cache/{i}/vals"] = _host(res[1])
            else:
                c["agg"] = False
                flat[f"cache/{i}/rows"] = _host(res)
        meta["cache"].append(c)
    for gkey, g in group_ids.items():
        flat[f"craw/{g}"] = np.stack(groups[gkey])  # a copy
    si = 0
    for (pred, adn), tpl in sorted(svc._templates.items()):
        for skey, snap in tpl._snaps.items():
            prefix = f"snap/{si}/"
            smeta = _inc.snapshot_to_state(
                snap, lambda name, arr, p=prefix: flat.__setitem__(
                    p + name, _host(arr)))
            smeta.update(pred=pred, adn=adn, skey=[list(k) for k in skey])
            meta["snaps"].append(smeta)
            si += 1
    flat["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8).copy()
    return flat


def _restore_relation(svc, d: dict, arrays: dict):
    """One carrier relation from its snapshot entry, on ``svc.device``:
    every field ``_DenseRelation.__init__`` sets, without repacking."""
    low = svc._lowering(d["pred"])
    if low is None:
        raise CheckpointCorrupt(
            f"snapshot names a non-decomposable predicate {d['pred']!r}")
    ds = _DenseRelation.__new__(_DenseRelation)
    ds.low = low
    ds.sr = carrier_for(low.kind)
    ds.n = int(d["n"])
    ds.n_alloc = int(d["n_alloc"])
    ds.flips = int(d["flips"])
    ds.last_flip = d["last_flip"]
    ds.tuning = None
    width = edge_arity(low.kind)
    ds.last_delta = np.zeros((0, width), np.int64)
    if not ds.sr.idempotent:
        # the additive carrier's arc set: the snapshot's EDB, as _rebuild
        # builds it from the same relation
        edges = svc.db.get(low.edb, np.zeros((0, width), np.int64))
        if len(edges):
            edges = unique_rows(edges, svc.bits)
        ds._arcs = RowSet(edges, svc.bits)
    ds.matrix = ds.csr = None
    if d["repr"] == "csr":
        ds.csr = _sparse.csr_from_state(arrays, d["csr_meta"],
                                        device=svc.device)
    else:
        mat = np.asarray(arrays["matrix"])
        dtype = torch.bool if ds.sr is BOOL else torch.float32
        ds.matrix = torch.from_numpy(np.array(mat)).to(svc.device, dtype)
    return ds


def restore_state(svc, flat: dict) -> dict:
    """Inverse of :func:`snapshot_state`: rebuild the service's hot state in
    place from a loaded flat tree, its carriers on the service's device.
    Raises :class:`CheckpointCorrupt` on any structural problem so the
    recovery ladder can fall back."""
    try:
        meta = json.loads(bytes(bytearray(
            np.asarray(flat["meta"], np.uint8))).decode())
    except (KeyError, ValueError) as e:
        raise CheckpointCorrupt(f"snapshot meta unreadable: {e}") from e
    try:
        # -- the EDB (normalized by the engine before it was saved)
        for i, rel in enumerate(meta["db"]):
            svc.db[rel] = np.asarray(flat[f"db/{i}"], np.int64)
            svc._base.invalidate(rel)
        svc.epoch = int(meta["epoch"])
        # -- carrier relations: the exact representation, COO tail included
        svc._dense.clear()
        for i, d in enumerate(meta["dense"]):
            prefix = f"rel/{i}/"
            arrays = {k[len(prefix):]: v for k, v in flat.items()
                      if k.startswith(prefix)}
            svc._dense[d["pred"]] = _restore_relation(svc, d, arrays)
        # -- batched tuple templates' fixpoint snapshots (each template is
        #    rebuilt from the persisted query literals: a cold plan, not a
        #    cold fixpoint)
        for si, smeta in enumerate(meta["snaps"]):
            prefix = f"snap/{si}/"
            snap = _inc.snapshot_from_state(
                smeta, lambda name, p=prefix: flat[p + name])
            tpl, _ = svc._template(smeta["pred"], smeta["adn"],
                                   snap.qlits[0])
            if not tpl.resumable:
                continue
            tpl._ensure_qid_engine(svc)
            tpl._snaps[tuple(tuple(k) for k in smeta["skey"])] = snap
        # -- the answer cache, oldest -> newest (the exact LRU order); dense
        #    entries keep host views into the stacked raw groups and format
        #    at their first hit
        svc.cache.clear()
        craw = {}
        g = 0
        while f"craw/{g}" in flat:
            craw[g] = np.asarray(flat[f"craw/{g}"])
            g += 1
        for i, c in enumerate(meta["cache"]):
            key = tuple(c["key"])
            if c["kind"] == "dense":
                ent = CacheEntry("dense", c["pred"], None, svc.epoch,
                                 src=c["src"], raw=craw[c["g"]][c["i"]])
            else:
                rows = flat[f"cache/{i}/rows"]
                res = (rows, flat[f"cache/{i}/vals"]) if c["agg"] else rows
                ent = CacheEntry("tuple", c["pred"], _freeze(res), svc.epoch)
            ent.hits = int(c["hits"])
            svc.cache.put(key, ent)
    except CheckpointCorrupt:
        raise
    except Exception as e:  # a malformed snapshot of any other stripe
        raise CheckpointCorrupt(f"snapshot restore failed: {e}") from e
    return meta


# ---------------------------------------------------------------------------
# The manager: WAL + snapshot cadence + the recovery ladder
# ---------------------------------------------------------------------------


class DurabilityManager:
    """Owns a service's durable directory: ``wal.log`` + ``snapshots/``.

    ``snapshot_every=N`` snapshots after every N logged appends (0 = explicit
    ``DatalogService.snapshot()`` calls only).  ``keep_snapshots`` bounds
    the generations retained; at least 2 keeps the degradation ladder
    meaningful.  ``fsync=False`` relaxes the WAL's per-append fsync.
    """

    def __init__(self, path: str | Path, *, snapshot_every: int = 0,
                 keep_snapshots: int = 3, n_shards: int = 2,
                 fsync: bool = True, tracer=None):
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.snap_dir = self.dir / "snapshots"
        self.snapshot_every = int(snapshot_every)
        self.keep_snapshots = max(1, int(keep_snapshots))
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.wal = WriteAheadLog(self.dir / "wal.log", fsync=fsync)
        self._ckpt = AsyncCheckpointer(self.snap_dir, n_shards=n_shards)
        self._replaying = False
        self._appends_since_snap = 0
        self._last_step = 0  # the newest step handed to the writer
        self.counters = {"wal_records": 0, "wal_bytes": 0,
                         "snapshots": 0, "snapshot_errors": 0}
        #: recovery report, filled by :meth:`recover` (explain()/metrics)
        self.recovery: dict = {"mode": "fresh", "snapshot_step": None,
                               "wal_replayed": 0, "wal_skipped": 0,
                               "fallbacks": 0, "torn_bytes": 0,
                               "seconds": 0.0}

    # -- write path ----------------------------------------------------------

    def log_append(self, rel: str, rows: np.ndarray, epoch: int) -> None:
        """WAL the append BEFORE the in-memory mutation; a no-op during
        recovery replay."""
        if self._replaying:
            return
        with self.tracer.span("wal_append", cat="durable", rel=rel,
                              rows=int(len(rows))):
            self.wal.append(rel, rows, epoch)
        self.counters["wal_records"] += 1
        self.counters["wal_bytes"] = self.wal.nbytes

    def maybe_snapshot(self, svc) -> None:
        """Auto-snapshot cadence hook, called at the end of every append."""
        if self._replaying or self.snapshot_every <= 0:
            return
        self._appends_since_snap += 1
        if self._appends_since_snap >= self.snapshot_every:
            self.snapshot(svc)

    def snapshot(self, svc) -> int | None:
        """Copy a consistent snapshot tree to the host (the caller holds
        ``svc.lock``) and hand it to the background writer; returns the
        step, or None when the previous background save failed (counted in
        ``datalog_snapshot_errors``, then the writer recovers)."""
        with self.tracer.span("snapshot", cat="durable", epoch=svc.epoch):
            flat = snapshot_state(svc, self.wal.records)
            # past the newest published step AND the one still in flight:
            # numbering from the published steps alone would reuse the
            # in-flight step's number, and its generation would be lost
            steps = complete_steps(self.snap_dir)
            step = max(steps[0] if steps else 0, self._last_step) + 1
            try:
                self._ckpt.save(step, flat, copy=False)  # copied above
            except CheckpointWriteError:
                self.counters["snapshot_errors"] += 1
                return None
            self._last_step = step
            self.counters["snapshots"] += 1
            self._appends_since_snap = 0
            self._prune(keep_from=step)
            return step

    def wait(self) -> None:
        """Block until the in-flight snapshot (if any) is published;
        re-raises a background :class:`CheckpointWriteError` once."""
        self._ckpt.wait()

    def _prune(self, keep_from: int) -> None:
        """Drop generations beyond ``keep_snapshots``: the step just handed
        over plus the ``keep_snapshots - 1`` newest published before it.
        Counting only steps below ``keep_from`` holds whether or not the
        writer has published the new step yet (counting it among them
        would drop one generation too many when it has)."""
        older = [s for s in complete_steps(self.snap_dir) if s < keep_from]
        for step in older[self.keep_snapshots - 1:]:
            shutil.rmtree(self.snap_dir / f"step_{step:08d}",
                          ignore_errors=True)

    # -- recovery ------------------------------------------------------------

    def recover(self, svc) -> dict:
        """The degradation ladder: the newest complete snapshot, then older
        generations, then a cold rebuild from the genesis EDB; then WAL
        replay through the ordinary append/resume path.  Never raises for
        data faults: the report records what happened."""
        t0 = time.monotonic()
        rep = self.recovery
        rep["torn_bytes"] = self.wal.torn_bytes
        with self.tracer.span("recover", cat="durable"):
            steps = complete_steps(self.snap_dir)
            wal_from = 0
            restored = None
            for gen, step in enumerate(steps):
                try:
                    flat, _ = load_checkpoint_raw(self.snap_dir, step=step)
                    meta = restore_state(svc, flat)
                except CheckpointCorrupt:
                    rep["fallbacks"] += 1
                    continue
                restored = (step, gen, meta)
                break
            if restored is not None:
                step, gen, meta = restored
                rep["mode"] = "degraded" if gen else "warm"
                rep["snapshot_step"] = step
                wal_from = int(meta["wal_seq"])
            elif self.wal.records or steps:
                rep["mode"] = "cold"  # genesis EDB + full WAL replay
            else:
                rep["mode"] = "fresh"  # empty directory: nothing to recover
            self._replaying = True
            try:
                for seq, (rel, rows, _epoch) in enumerate(self.wal.replay()):
                    if seq < wal_from:
                        continue
                    try:
                        svc.append(rel, rows)
                        rep["wal_replayed"] += 1
                    except Exception:  # noqa: BLE001 -- degrade, don't die
                        rep["wal_skipped"] += 1
            finally:
                self._replaying = False
        rep["seconds"] = time.monotonic() - t0
        return rep

    # -- introspection -------------------------------------------------------

    def report(self) -> dict:
        """The ``explain()["durability"]`` section."""
        return {
            "dir": str(self.dir),
            "wal": {"records": self.wal.records, "bytes": self.wal.nbytes,
                    "fsync": self.wal.fsync},
            "snapshots": {"written": self.counters["snapshots"],
                          "errors": self.counters["snapshot_errors"],
                          "every": self.snapshot_every,
                          "keep": self.keep_snapshots,
                          "steps": complete_steps(self.snap_dir)},
            "recovery": dict(self.recovery),
        }

    def absorb_metrics(self, m) -> None:
        """Collector for the unified registry (``datalog_recovery_*`` and
        friends); registered by the owning service."""
        m.counter("datalog_wal_records_total",
                  "EDB appends written to the WAL").set(
            self.counters["wal_records"])
        m.gauge("datalog_wal_bytes", "WAL file size").set(self.wal.nbytes)
        m.counter("datalog_snapshots_total",
                  "serving-state snapshots handed to the background writer"
                  ).set(self.counters["snapshots"])
        m.counter("datalog_snapshot_errors_total",
                  "background snapshot saves that failed").set(
            self.counters["snapshot_errors"])
        rec = self.recovery
        c = m.counter("datalog_recovery_total",
                      "service recoveries at startup, by degradation mode")
        for mode in ("warm", "degraded", "cold"):
            c.set(1 if rec["mode"] == mode else 0, {"mode": mode})
        m.counter("datalog_recovery_wal_replayed_total",
                  "WAL records replayed through append-resume at recovery"
                  ).set(rec["wal_replayed"])
        m.counter("datalog_recovery_fallbacks_total",
                  "snapshot generations skipped as corrupt at recovery").set(
            rec["fallbacks"])
        m.gauge("datalog_recovery_seconds",
                "wall time of the last recovery").set(rec["seconds"])

    def close(self) -> None:
        try:
            self._ckpt.close()
        except CheckpointWriteError:
            self.counters["snapshot_errors"] += 1
        self.wal.close()
