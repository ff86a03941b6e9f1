"""Unified metrics registry: counters / gauges / histograms + exporters.

Port of ``repro.obs.metrics`` (pure Python): the same calls give the same
Prometheus text and JSON.

One `MetricsRegistry` replaces the three scattered stats mechanisms
(`ServiceStats` dataclass, `AdmissionStats` dataclass, `LRUCache.hits`
bare ints). The dataclasses stay as the cheap hot-path mutation sites —
a `+= 1` on a dataclass field under the service lock costs less than a
labeled registry lookup — and the registry *absorbs* them at export/read
time via registered collect callbacks. Latency histograms are observed
directly (per batch, not per query) so default-on overhead stays small.

Naming schema (Prometheus conventions, ``datalog_`` prefix):

- ``datalog_<noun>_total``            — monotone counters
- ``datalog_<noun>``                  — gauges (point-in-time values)
- ``datalog_<stage>_seconds``         — latency histograms
- labels in ``{}``, e.g. ``datalog_fixpoints_total{repr="csr"}``

Exporters: ``to_prometheus()`` (text exposition format v0.0.4) and
``to_json()``.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_BUCKETS",
]

# Latency buckets spanning 100us .. ~100s — fixpoints run 1ms-10s.
DEFAULT_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

_MAX_SAMPLES = 8192  # raw-sample cap per histogram (reservoir for pXX)


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


def _label_str(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    """Monotone counter with optional labels.

    ``set()`` exists for absorption of externally-maintained tallies
    (the stats dataclasses); direct users should only ``inc()``.
    """

    kind = "counter"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def inc(self, amount: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set(self, value: float,
            labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def _snapshot(self) -> Dict[Tuple[Tuple[str, str], ...], float]:
        with self._lock:
            return dict(self._values)


class Gauge(Counter):
    """Point-in-time value; ``set()`` is the normal mutation."""

    kind = "gauge"

    def dec(self, amount: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        self.inc(-amount, labels)


class _HistState:
    __slots__ = ("count", "sum", "bucket_counts", "samples")

    def __init__(self, nbuckets: int):
        self.count = 0
        self.sum = 0.0
        self.bucket_counts = [0] * (nbuckets + 1)  # +1 for +Inf
        self.samples: List[float] = []


class Histogram:
    """Bucketed histogram that also keeps capped raw samples for pXX."""

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._lock = lock
        self._states: Dict[Tuple[Tuple[str, str], ...], _HistState] = {}

    def observe(self, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        key = _label_key(labels)
        with self._lock:
            st = self._states.get(key)
            if st is None:
                st = self._states[key] = _HistState(len(self.buckets))
            st.count += 1
            st.sum += value
            i = 0
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    st.bucket_counts[i] += 1
                    break
            else:
                st.bucket_counts[len(self.buckets)] += 1
            if len(st.samples) < _MAX_SAMPLES:
                st.samples.append(value)
            else:  # deterministic decimating reservoir: overwrite cyclically
                st.samples[st.count % _MAX_SAMPLES] = value

    def count(self, labels: Optional[Dict[str, str]] = None) -> int:
        with self._lock:
            st = self._states.get(_label_key(labels))
            return st.count if st else 0

    def percentiles(self, pcts: Sequence[float] = (50, 95, 99),
                    labels: Optional[Dict[str, str]] = None
                    ) -> Dict[str, float]:
        """Percentiles from retained raw samples (approx once capped)."""
        with self._lock:
            st = self._states.get(_label_key(labels))
            samples = sorted(st.samples) if st else []
        out: Dict[str, float] = {}
        for p in pcts:
            if not samples:
                out[f"p{p:g}"] = math.nan
            else:
                idx = min(len(samples) - 1,
                          max(0, math.ceil(p / 100.0 * len(samples)) - 1))
                out[f"p{p:g}"] = samples[idx]
        return out

    def _snapshot(self) -> Dict[Tuple[Tuple[str, str], ...], Dict[str, Any]]:
        with self._lock:
            out = {}
            for key, st in self._states.items():
                # cumulative bucket counts, Prometheus-style
                cum, acc = [], 0
                for c in st.bucket_counts:
                    acc += c
                    cum.append(acc)
                out[key] = {"count": st.count, "sum": st.sum, "cum": cum}
            return out


class MetricsRegistry:
    """Thread-safe registry of named metrics plus collect callbacks.

    Collect callbacks run at export/read time (``collect()``) and are
    how the stats dataclasses get absorbed: the service registers a
    callback that ``set()``s the counter family from its dataclass
    fields, so the hot path keeps its cheap ``+=`` while every consumer
    sees one schema.
    """

    enabled = True

    def __init__(self) -> None:
        self._lock = threading.Lock()        # registry structure
        self._mlock = threading.Lock()       # metric values (shared)
        self._metrics: Dict[str, Any] = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []

    # -- registration --------------------------------------------------

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(name, help, Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(name, help, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Histogram(
                    name, help, self._mlock, buckets)
            elif not isinstance(m, Histogram):
                raise TypeError(f"metric {name!r} already registered "
                                f"as {m.kind}")
            return m

    def _get_or_make(self, name: str, help: str, cls: type) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, self._mlock)
            elif type(m) is not cls:
                raise TypeError(f"metric {name!r} already registered "
                                f"as {m.kind}")
            return m

    def register_collector(
            self, fn: Callable[["MetricsRegistry"], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def collect(self) -> None:
        """Run absorption callbacks so exported values are current."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn(self)

    # -- export --------------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        self.collect()
        with self._lock:
            metrics = dict(self._metrics)
        out: Dict[str, Any] = {}
        for name, m in sorted(metrics.items()):
            if isinstance(m, Histogram):
                snap = m._snapshot()
                out[name] = {
                    "kind": m.kind,
                    "series": {
                        _label_str(k) or "_": {"count": v["count"],
                                               "sum": v["sum"]}
                        for k, v in snap.items()
                    },
                }
            else:
                out[name] = {
                    "kind": m.kind,
                    "series": {_label_str(k) or "_": v
                               for k, v in m._snapshot().items()},
                }
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        self.collect()
        with self._lock:
            metrics = dict(self._metrics)
        lines: List[str] = []
        for name, m in sorted(metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for key, v in sorted(m._snapshot().items()):
                    ls = dict(key)
                    for ub, c in zip(list(m.buckets) + [math.inf], v["cum"]):
                        le = "+Inf" if math.isinf(ub) else repr(ub)
                        lbl = _label_str(tuple(sorted(
                            {**ls, "le": le}.items())))
                        lines.append(f"{name}_bucket{lbl} {c}")
                    base = _label_str(key)
                    lines.append(f"{name}_sum{base} {v['sum']}")
                    lines.append(f"{name}_count{base} {v['count']}")
            else:
                for key, v in sorted(m._snapshot().items()):
                    val = int(v) if float(v).is_integer() else v
                    lines.append(f"{name}{_label_str(key)} {val}")
        return "\n".join(lines) + "\n"

    def export(self, path: str) -> None:
        """Write Prometheus text to ``*.prom``/``*.txt``, else JSON."""
        if path.endswith((".prom", ".txt")):
            with open(path, "w") as f:
                f.write(self.to_prometheus())
        else:
            with open(path, "w") as f:
                json.dump(self.to_json(), f, indent=1)


class NullMetrics:
    """Disabled registry: accepts the same calls, records nothing."""

    enabled = False

    class _NullMetric:
        def inc(self, *a: Any, **k: Any) -> None: pass
        def dec(self, *a: Any, **k: Any) -> None: pass
        def set(self, *a: Any, **k: Any) -> None: pass
        def observe(self, *a: Any, **k: Any) -> None: pass
        def value(self, *a: Any, **k: Any) -> float: return 0.0
        def count(self, *a: Any, **k: Any) -> int: return 0
        def percentiles(self, pcts: Sequence[float] = (50, 95, 99),
                        **k: Any) -> Dict[str, float]:
            return {f"p{p:g}": math.nan for p in pcts}

    _NULL = _NullMetric()

    def counter(self, name: str, help: str = "") -> Any:
        return self._NULL

    def gauge(self, name: str, help: str = "") -> Any:
        return self._NULL

    def histogram(self, name: str, help: str = "", **k: Any) -> Any:
        return self._NULL

    def register_collector(self, fn: Callable[..., None]) -> None:
        pass

    def collect(self) -> None:
        pass

    def to_json(self) -> Dict[str, Any]:
        return {}

    def to_prometheus(self) -> str:
        return ""

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            if path.endswith((".prom", ".txt")):
                f.write("")
            else:
                json.dump({}, f)


NULL_METRICS = NullMetrics()
__all__ += ["NullMetrics", "NULL_METRICS"]
