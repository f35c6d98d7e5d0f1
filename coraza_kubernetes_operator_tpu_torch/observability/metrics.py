"""Minimal, dependency-free Prometheus metrics.

The reference gets Prometheus metrics for free from controller-runtime
(reference ``cmd/main.go:153-165`` wires the authn/authz-filtered metrics
server; the Helm chart ships a ServiceMonitor,
``charts/.../templates/servicemonitor.yaml``). This module is the
first-party equivalent: Counter / Gauge / Histogram with labels, rendered
in the text exposition format (version 0.0.4) that any Prometheus scraper
accepts. Thread-safe; hot-path increments are a dict update under a lock —
negligible next to a device batch step.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left


def _fmt_labels(label_names: tuple[str, ...], label_values: tuple[str, ...]) -> str:
    if not label_names:
        return ""
    inner = ",".join(
        f'{k}="{_escape(v)}"' for k, v in zip(label_names, label_values)
    )
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._lock = threading.Lock()

    def render(self) -> list[str]:  # pragma: no cover - overridden
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, tuple(label_names))
        self._values: dict[tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(str(labels.get(k, "")) for k in self.label_names)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = tuple(str(labels.get(k, "")) for k in self.label_names)
        with self._lock:
            return self._values.get(key, 0.0)

    def render(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        if not items and not self.label_names:
            items = [((), 0.0)]
        for key, v in items:
            lines.append(
                f"{self.name}{_fmt_labels(self.label_names, key)} {_fmt_value(v)}"
            )
        return lines


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, tuple(label_names))
        self._values: dict[tuple[str, ...], float] = {}
        self._fns: dict[tuple[str, ...], object] = {}

    def set(self, value: float, **labels) -> None:
        key = tuple(str(labels.get(k, "")) for k in self.label_names)
        with self._lock:
            self._values[key] = float(value)

    def set_function(self, fn, **labels) -> None:
        """Sample ``fn()`` at render time (for cache sizes etc.)."""
        key = tuple(str(labels.get(k, "")) for k in self.label_names)
        with self._lock:
            self._fns[key] = fn

    def value(self, **labels) -> float:
        key = tuple(str(labels.get(k, "")) for k in self.label_names)
        with self._lock:
            if key in self._fns:
                return float(self._fns[key]())  # type: ignore[operator]
            return self._values.get(key, 0.0)

    def render(self) -> list[str]:
        with self._lock:
            items = dict(self._values)
            for key, fn in self._fns.items():
                try:
                    items[key] = float(fn())  # type: ignore[operator]
                except Exception:
                    continue
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        if not items and not self.label_names:
            items = {(): 0.0}
        for key, v in sorted(items.items()):
            lines.append(
                f"{self.name}{_fmt_labels(self.label_names, key)} {_fmt_value(v)}"
            )
        return lines


# Default buckets sized for batch latencies (seconds): 100us .. 10s.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, label_names=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_, tuple(label_names))
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}
        self._totals: dict[tuple[str, ...], int] = {}
        # (key, bucket index) -> (trace_id, value, unix_ts). Last write
        # wins per bucket — an exemplar is a pointer, not a log.
        self._exemplars: dict[tuple[tuple[str, ...], int], tuple[str, float, float]] = {}

    def observe(self, value: float, exemplar: str | None = None, **labels) -> None:
        key = tuple(str(labels.get(k, "")) for k in self.label_names)
        idx = bisect_left(self.buckets, value)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            if idx < len(counts):
                counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1
            if exemplar:
                self._exemplars[(key, idx)] = (exemplar, value, time.time())

    @staticmethod
    def _exemplar_suffix(ex: tuple[str, float, float] | None) -> str:
        """OpenMetrics exemplar rendered after a bucket's value:
        ``# {trace_id="..."} <value> <timestamp>``."""
        if ex is None:
            return ""
        trace_id, value, ts = ex
        return f' # {{trace_id="{_escape(trace_id)}"}} {_fmt_value(value)} {ts:.3f}'

    def render(self) -> list[str]:
        with self._lock:
            keys = sorted(self._totals)
            snapshot = {
                k: (list(self._counts[k]), self._sums[k], self._totals[k])
                for k in keys
            }
            exemplars = dict(self._exemplars)
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        for key, (counts, total_sum, total) in snapshot.items():
            cum = 0
            for i, (le, c) in enumerate(zip(self.buckets, counts)):
                cum += c
                lk = self.label_names + ("le",)
                lv = key + (_fmt_value(le),)
                lines.append(
                    f"{self.name}_bucket{_fmt_labels(lk, lv)} {cum}"
                    f"{self._exemplar_suffix(exemplars.get((key, i)))}"
                )
            lk = self.label_names + ("le",)
            lines.append(
                f"{self.name}_bucket{_fmt_labels(lk, key + ('+Inf',))} {total}"
                f"{self._exemplar_suffix(exemplars.get((key, len(self.buckets))))}"
            )
            lines.append(
                f"{self.name}_sum{_fmt_labels(self.label_names, key)} {_fmt_value(total_sum)}"
            )
            lines.append(
                f"{self.name}_count{_fmt_labels(self.label_names, key)} {total}"
            )
        return lines


class MetricsRegistry:
    """Collection of metrics rendered together at ``/metrics``."""

    def __init__(self):
        self._metrics: list[_Metric] = []
        self._lock = threading.Lock()

    def counter(self, name, help_, label_names=()) -> Counter:
        return self._register(Counter(name, help_, label_names))

    def gauge(self, name, help_, label_names=()) -> Gauge:
        return self._register(Gauge(name, help_, label_names))

    def histogram(self, name, help_, label_names=(), buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help_, label_names, buckets))

    def _register(self, m):
        with self._lock:
            if any(x.name == m.name for x in self._metrics):
                raise ValueError(f"duplicate metric {m.name}")
            self._metrics.append(m)
        return m

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics)
        out: list[str] = []
        for m in metrics:
            out.extend(m.render())
        return "\n".join(out) + "\n"
