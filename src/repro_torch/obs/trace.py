"""Span tracing with Chrome ``trace_event`` export.

Port of ``repro.obs.trace`` (pure Python, the same events).

A :class:`Tracer` records *complete* ("X") events: each span carries a
monotonic start timestamp and a duration, plus the recording thread's id.
Chrome's trace viewer (``chrome://tracing`` / Perfetto) reconstructs
parent/child nesting per (pid, tid) lane from containment, which is exactly
how the serving stack uses it: the admission dispatcher and finalizer
threads each get a lane, so the launch/finalize double-buffering shows
up as overlapping spans on *different* lanes.

Design constraints:

- **Low overhead.** A span records two ``time.monotonic()`` calls, one
  dict build, and one lock-guarded list append. The disabled path
  (:data:`NULL_TRACER`) reuses a single no-op context manager so tracing
  code can stay unconditional on hot paths.
- **Thread safe.** Multiple submitter/dispatcher/finalizer threads append
  concurrently; the event list is guarded by one lock.
- **Self-contained export.** ``to_chrome()`` emits the JSON-object form
  (``{"traceEvents": [...]}``) with the required trace_event fields
  (name, cat, ph, ts, pid, tid and dur for "X" events); timestamps are
  microseconds since the tracer's epoch.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER"]

_PID = 1  # single-process service; one trace "process" lane


class Span:
    """A live span; use as a context manager or call :meth:`end` directly."""

    __slots__ = ("tracer", "name", "cat", "args", "tid", "t0", "_done")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.tid = threading.get_ident()
        self.t0 = time.monotonic()
        self._done = False

    def annotate(self, **kv: Any) -> None:
        """Attach (or overwrite) args on a live span."""
        if self.args is None:
            self.args = {}
        self.args.update(kv)

    def end(self) -> None:
        if self._done:  # idempotent: with-block after explicit end()
            return
        self._done = True
        t1 = time.monotonic()
        self.tracer._emit(self, t1)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.end()


class _NullSpan:
    """Shared no-op span: zero allocation on the disabled path."""

    __slots__ = ()

    def annotate(self, **kv: Any) -> None:
        pass

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe collector of Chrome trace events."""

    enabled = True

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._t0 = time.monotonic()

    # -- recording -----------------------------------------------------

    def span(self, name: str, cat: str = "service",
             **args: Any) -> Span:
        """Open a span; close it via ``with`` or ``.end()``."""
        return Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "service", **args: Any) -> None:
        """Record a zero-duration instant event ("i" phase)."""
        ev = {
            "name": name, "cat": cat, "ph": "i",
            "ts": (time.monotonic() - self._t0) * 1e6,
            "pid": _PID, "tid": threading.get_ident(), "s": "t",
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def _emit(self, span: Span, t1: float) -> None:
        ev = {
            "name": span.name, "cat": span.cat, "ph": "X",
            "ts": (span.t0 - self._t0) * 1e6,
            "dur": (t1 - span.t0) * 1e6,
            "pid": _PID, "tid": span.tid,
        }
        if span.args:
            ev["args"] = span.args
        with self._lock:
            self._events.append(ev)

    # -- inspection / export -------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of recorded events (copies the list, not the dicts)."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-viewer JSON object form."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    # -- analysis helpers (used by tests and bench) --------------------

    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        """Complete ("X") events, optionally filtered by name."""
        evs = [e for e in self.events() if e.get("ph") == "X"]
        if name is not None:
            evs = [e for e in evs if e["name"] == name]
        return evs

    @staticmethod
    def overlaps(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
        """True iff two "X" events overlap in time (open intervals)."""
        a0, a1 = a["ts"], a["ts"] + a["dur"]
        b0, b1 = b["ts"], b["ts"] + b["dur"]
        return a0 < b1 and b0 < a1


class NullTracer:
    """Disabled tracer: every method is a cheap no-op."""

    enabled = False

    def span(self, name: str, cat: str = "service", **args: Any) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "service", **args: Any) -> None:
        pass

    def events(self) -> List[Dict[str, Any]]:
        return []

    def clear(self) -> None:
        pass

    def to_chrome(self) -> Dict[str, Any]:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        return []

    overlaps = staticmethod(Tracer.overlaps)


NULL_TRACER = NullTracer()
