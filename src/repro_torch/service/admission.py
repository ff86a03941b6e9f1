"""Continuous-batching admission front-end: async coalescing for a
:class:`~repro_torch.service.session.DatalogService` (port of
``repro.service.admission``).

``DatalogService.ask_batch`` converts batch-*shaped* traffic into batched
fixpoints, but production traffic arrives as individual queries, each of
which would otherwise pay a whole fixpoint, a whole copy to the host and
the per-batch bookkeeping alone.  This module moves the batching *inside*
the service, the way LLM serving systems run continuous batching:

* **submit → future** — callers hand in one query and immediately get a
  :class:`concurrent.futures.Future`; nobody builds batches by hand.
* **windowed coalescing** — a dispatcher thread accumulates arrivals for a
  bounded window (``max_wait_ms``, capped at ``max_batch``), then flushes
  the window as ONE :meth:`DatalogService.launch_batch`, which groups the
  queries by (pred, adornment) shape (``batch.coalesce_by_shape``) and runs
  each shape group as one dense/CSR/tuple-qid batched fixpoint.
* **device/host overlap (double buffering)** — launch and finalize run on
  different threads with a bounded in-flight queue between them: while the
  finalizer splits/formats batch *k*'s answers on the host, the dispatcher
  is already launching batch *k+1*'s device fixpoint.  The port's launch
  ends with its tables on the host (``session._DenseLaunch``: the host
  loop has synced every iteration anyway), so the finalizer's work is all
  host work and never queues behind the next launch's kernels.
* **admission control** — the waiting queue is depth-bounded; beyond
  ``queue_depth`` a submit is *shed* with a typed :class:`QueueFullError`
  (report-and-retry), so overload degrades to latency and explicit sheds
  rather than unbounded memory growth.
* **cache short-circuit** — result-cache hits resolve at submit time, on
  the caller's thread, without occupying a batch slot or waking the
  dispatcher (warm traffic never queues behind cold fixpoints).
* **epoch fencing** — :meth:`append` takes the write side of an
  :class:`~repro_torch.service.incremental.EpochFence`: it drains in-flight
  flushes and holds off new launches, so the epoch-tagged LRU and the
  append-resume paths never see a batch that spans an epoch boundary.

    front = AsyncDatalogService(DatalogService(TC, db={"arc": edges}),
                                max_wait_ms=2.0, max_batch=128)  # on the card
    fut = front.submit("tc(7, X)")        # returns immediately
    rows = fut.result()                   # coalesced with concurrent arrivals
    front.append("arc", [[7, 8]])         # fenced against in-flight flushes
    front.explain()["admission"]          # queue depth, flush stats, sheds
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from collections import deque
from concurrent.futures import Future

from . import incremental as _inc
from .session import DatalogService


class QueueFullError(RuntimeError):
    """Admission queue at capacity: the query was shed, not enqueued.

    Typed so callers (and load generators) can distinguish overload
    shedding from evaluation failures; carries the depth at rejection."""

    def __init__(self, depth: int):
        super().__init__(
            f"admission queue full ({depth} queries waiting); query shed — "
            "retry later or raise queue_depth")
        self.depth = depth


@dataclasses.dataclass
class AdmissionStats:
    """Front-end counters (engine-side counters stay on ``svc.stats``)."""

    submitted: int = 0  # accepted submits (short-circuits included)
    completed: int = 0  # futures resolved by a flush
    short_circuits: int = 0  # answered from the result cache at submit time
    shed: int = 0  # rejected by the queue-depth bound
    flushes: int = 0  # dispatcher windows flushed
    flushed_queries: int = 0  # queries across those flushes
    max_flush: int = 0  # largest single flush
    failed_flushes: int = 0  # flushes whose futures got an exception
    appends: int = 0  # fenced appends applied


class AsyncDatalogService:
    """Async admission wrapper: single-query futures over batched fixpoints.

    ``service`` is an existing :class:`DatalogService` (or anything its
    constructor accepts, forwarded with ``**svc_kw``).  Knobs:

    ``max_wait_ms``   the coalescing window: the dispatcher flushes when the
                      oldest waiting query has aged this much (or the window
                      filled).  Bounds the latency cost of batching.
    ``max_batch``     flush size cap; also the natural knob to align with
                      the service's ``batch_pads`` (a flush pads up to the
                      next level, so ``max_batch`` = a pad level wastes no
                      padding at full load).
    ``queue_depth``   admission bound on *waiting* (unflushed) queries;
                      beyond it submits shed with :class:`QueueFullError`.
    ``inflight``      launched-but-unfinalized batches allowed at once (2 =
                      classic double buffering: one on device, one in host
                      finalize).

    The sync surface (:meth:`ask` / :meth:`ask_batch` / :meth:`append` /
    :meth:`explain` / ``.epoch``) mirrors ``DatalogService``, so the CLI,
    REPL and tests swap front-ends freely.
    """

    def __init__(self, service, *, max_wait_ms: float = 2.0,
                 max_batch: int = 64, queue_depth: int = 1024,
                 inflight: int = 2, start: bool = True, **svc_kw):
        if not isinstance(service, DatalogService):
            service = DatalogService(service, **svc_kw)
        elif svc_kw:
            raise TypeError("service kwargs are only accepted when "
                            "constructing the DatalogService here; got "
                            f"{sorted(svc_kw)} with a ready service")
        self.svc = service
        self.max_wait = max_wait_ms / 1000.0
        self.max_batch = max(1, int(max_batch))
        self.queue_depth = max(1, int(queue_depth))
        self.stats = AdmissionStats()
        self._fence = _inc.EpochFence()
        self._cv = threading.Condition()
        #: (future, qlit, t_submit): admitted, unflushed — t_submit feeds the
        #: queue-wait histogram at flush time
        self._waiting: deque = deque()
        self._h_qwait = service.metrics.histogram(
            "datalog_queue_wait_seconds",
            "admission to flush wait per admitted query")
        service.metrics.register_collector(self._absorb_stats)
        self._outstanding = 0  # admitted futures not yet resolved
        self._inflight: "_queue.Queue" = _queue.Queue(maxsize=max(1, inflight))
        self._closed = False
        self._started = False
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="admission-dispatch", daemon=True)
        self._finalizer = threading.Thread(
            target=self._finalize_loop, name="admission-finalize", daemon=True)
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "AsyncDatalogService":
        """Start the dispatcher/finalizer threads (idempotent).  Tests pass
        ``start=False`` to stage a queue deterministically first."""
        if not self._started:
            self._started = True
            self._dispatcher.start()
            self._finalizer.start()
        return self

    def close(self, timeout: float = 60.0) -> "AsyncDatalogService":
        """Stop admitting, flush everything already admitted, join threads.
        Safe to call twice; the service itself stays usable synchronously."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._started:
            self._dispatcher.join(timeout)
            self._inflight.put(None)  # sentinel after the last real flush
            self._finalizer.join(timeout)
            self._started = False
        return self

    def __enter__(self) -> "AsyncDatalogService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submission ----------------------------------------------------------

    def submit(self, query) -> Future:
        """Admit one query; returns a future resolving to the same answer
        ``DatalogService.ask`` would produce.

        Malformed queries raise synchronously (the caller's bug must not
        poison a shared flush); cache hits resolve before this returns;
        a full queue sheds with :class:`QueueFullError`.
        """
        if self._closed:
            raise RuntimeError("AsyncDatalogService is closed")
        svc = self.svc
        qlit = svc._as_literal(query)
        fut: Future = Future()
        with svc.lock:
            ent = svc.cache.get_fresh(svc._cache_key(qlit), svc.epoch)
            if ent is not None:
                self.stats.submitted += 1
                self.stats.short_circuits += 1
                fut.set_result(svc._entry_result(ent))
                return fut
        with self._cv:
            if self._closed:
                raise RuntimeError("AsyncDatalogService is closed")
            if len(self._waiting) >= self.queue_depth:
                self.stats.shed += 1
                raise QueueFullError(len(self._waiting))
            self.stats.submitted += 1
            self._outstanding += 1
            self._waiting.append((fut, qlit, time.monotonic()))
            self._cv.notify_all()
        svc.tracer.instant("submit", cat="admission", pred=qlit.pred)
        return fut

    def ask(self, query, timeout: float | None = None):
        """Synchronous convenience: ``submit(query).result()``."""
        return self.submit(query).result(timeout)

    def ask_batch(self, queries: list, timeout: float | None = None) -> list:
        """Submit a burst and gather in order — the burst still flows
        through the admission window (and may coalesce with other callers'
        queries), unlike ``DatalogService.ask_batch``'s caller-built batch."""
        futs = [self.submit(q) for q in queries]
        return [f.result(timeout) for f in futs]

    # -- appends (epoch-fenced) ----------------------------------------------

    def append(self, rel: str, rows) -> "AsyncDatalogService":
        """Monotone EDB append, fenced against in-flight flushes: waits for
        launched batches to finalize, holds off new launches, then runs the
        service's resume/invalidation under the new epoch."""
        with self._fence.writing():
            with self.svc.lock:
                self.svc.append(rel, rows)
            self.stats.appends += 1
        return self

    def snapshot(self, wait: bool = False) -> int | None:
        """Durable snapshot fenced like an append: in-flight flushes drain
        first, so the persisted cut never falls inside a batch's
        launch-to-finalize window."""
        with self._fence.writing():
            return self.svc.snapshot(wait=wait)

    @property
    def epoch(self) -> int:
        return self.svc.epoch

    # -- introspection -------------------------------------------------------

    def explain(self) -> dict:
        """:meth:`DatalogService.explain`'s report with an ``admission``
        section in the unified schema::

            admission:
              queue:    {depth, limit}
              window:   {max_wait_ms, max_batch, mean_flush, max_flush}
              counters: AdmissionStats as a flat dict

        The pre-unification flat keys (``queue_depth``, ``queue_limit``,
        ``max_wait_ms``, ``max_batch``, ``mean_flush`` and the bare counter
        names) are GONE after their one-release deprecation window — read
        the nested sections.
        """
        with self.svc.lock:
            rep = self.svc.explain()
        with self._cv:
            depth = len(self._waiting)
        st = dataclasses.asdict(self.stats)
        mean_flush = (self.stats.flushed_queries / self.stats.flushes
                      if self.stats.flushes else 0.0)
        rep["admission"] = {
            "queue": {"depth": depth, "limit": self.queue_depth},
            "window": {"max_wait_ms": self.max_wait * 1000.0,
                       "max_batch": self.max_batch,
                       "mean_flush": mean_flush,
                       "max_flush": st["max_flush"]},
            "counters": dict(st),
        }
        return rep

    def _absorb_stats(self, m) -> None:
        """Absorb :class:`AdmissionStats` + queue depth into the unified
        metric schema at export time (see ``DatalogService._absorb_stats``)."""
        st = dataclasses.asdict(self.stats)
        with self._cv:
            depth = len(self._waiting)
        adm = m.counter("datalog_admission_total",
                        "admission front-end counters, by event")
        for k, v in st.items():
            if k != "max_flush":
                adm.set(v, {"event": k})
        m.gauge("datalog_queue_depth",
                "waiting (admitted, unflushed) queries").set(depth)
        m.gauge("datalog_admission_max_flush",
                "largest single flush").set(st["max_flush"])

    def drain(self, timeout: float = 60.0) -> "AsyncDatalogService":
        """Block until every admitted query has resolved (load generators
        and tests call this between phases)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._outstanding:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"admission queue failed to drain: "
                        f"{self._outstanding} queries outstanding")
                self._cv.wait(timeout=min(left, 0.05))
        return self

    # -- dispatcher / finalizer threads --------------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                while not self._waiting and not self._closed:
                    self._cv.wait()
                if self._closed and not self._waiting:
                    return
                # coalescing window: flush when the oldest arrival has aged
                # max_wait or the window filled to max_batch
                span = self.svc.tracer.span("coalesce", cat="admission")
                deadline = time.monotonic() + self.max_wait
                while len(self._waiting) < self.max_batch and not self._closed:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
                take = min(len(self._waiting), self.max_batch)
                items = [self._waiting.popleft() for _ in range(take)]
                span.annotate(batch=take)
                span.end()
                self._cv.notify_all()
            if items:
                self._flush(items)

    def _flush(self, items: list) -> None:
        """Launch one flush under the fence's read side; hand the pending
        batch to the finalizer.  The read side stays held (by the pending)
        until finalize completes — appends drain us, not the reverse."""
        futs = [f for f, _, _ in items]
        qlits = [q for _, q, _ in items]
        now = time.monotonic()
        for _, _, t_submit in items:
            self._h_qwait.observe(now - t_submit)
        self._fence.acquire_read()
        try:
            with self.svc.lock:
                pending = self.svc.launch_batch(qlits)
        except BaseException as e:  # noqa: BLE001 — futures carry the error
            self._fence.release_read()
            self._fail(futs, e)
            return
        self.stats.flushes += 1
        self.stats.flushed_queries += len(items)
        self.stats.max_flush = max(self.stats.max_flush, len(items))
        # double buffer: blocks while `inflight` batches await finalize —
        # the device/host overlap depth, and backpressure toward the window
        self._inflight.put((pending, futs))

    def _finalize_loop(self) -> None:
        while True:
            got = self._inflight.get()
            if got is None:
                return
            pending, futs = got
            try:
                answers = self.svc.finalize_batch(pending)
            except BaseException as e:  # noqa: BLE001
                self._fail(futs, e)
            else:
                for f, a in zip(futs, answers):
                    f.set_result(a)
                self.stats.completed += len(futs)
                self._done(len(futs))
            finally:
                self._fence.release_read()

    def _fail(self, futs: list, exc: BaseException) -> None:
        self.stats.failed_flushes += 1
        for f in futs:
            f.set_exception(exc)
        self._done(len(futs))

    def _done(self, n: int) -> None:
        with self._cv:
            self._outstanding -= n
            self._cv.notify_all()
