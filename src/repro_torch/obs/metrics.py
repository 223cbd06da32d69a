"""Process-global metrics registry: labeled counters, gauges, histograms
(port of ``repro.obs.metrics``).

Host-side only and stdlib apart from the capture guard.  Recording is a
plain dict update under the GIL -- no lock is taken on the hot path; a lock
guards only metric *creation*, which happens once per (name) per process.
Every mutation is guarded by :func:`host_clean`: a record issued while a
step is being staged for a CUDA graph (``optrace.staging()``, which
``serve.step_graph.StepGraphs`` enters around its warm-up and capture),
while the current CUDA stream is capturing, or carrying a meta or fake
tensor is silently dropped -- the counterpart of the reference's tracer
guard, so instrumented code runs inside a captured step without counting
its warm-up or capture runs as executions.

Two exposition formats:

  * :func:`snapshot` -- a plain-JSON dict ``{metric: {"type", "help",
    "values": [{"labels": {...}, "value": ...}]}}`` (histograms carry
    bucket counts, sum, count);
  * :func:`prometheus_text` -- the Prometheus text exposition format
    (``# HELP`` / ``# TYPE`` / ``name{label="x"} value`` lines,
    ``_bucket``/``_sum``/``_count`` series for histograms).

The module-level :data:`REGISTRY` is the process default; engines and the
dispatcher record into it via the convenience constructors below.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Any, Iterable

import torch

METRIC_TYPES = ("counter", "gauge", "histogram")

# generic latency-ish buckets (seconds): 100us .. 60s, plus +Inf implicitly
DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 5.0,
                   10.0, 60.0)

# depth of ``optrace.staging()`` blocks open (in any thread): while above 0
# nothing is recorded
_STAGING = 0
# per-thread flag of threads that must make no CUDA call (the streaming
# exporter: a CUDA call from another thread during a capture invalidates it)
_THREAD = threading.local()


def host_only_thread() -> None:
    """Mark the calling thread as one that makes no CUDA call:
    :func:`host_clean` skips its capture query there."""
    _THREAD.host_only = True


def _capturing() -> bool:
    """True while the current CUDA stream is capturing a graph (never
    asked from a host-only thread, nor before CUDA is initialized)."""
    if getattr(_THREAD, "host_only", False) or not torch.cuda.is_initialized():
        return False
    return torch.cuda.is_current_stream_capturing()


def _abstract(v: Any) -> bool:
    """A tensor with no data: on the meta device, or a fake tensor."""
    if not isinstance(v, torch.Tensor):
        return False
    if v.is_meta:
        return True
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(v)


def host_clean(*values: Any) -> bool:
    """True when recording is safe: nothing is staging a CUDA graph, the
    current stream is not capturing, and none of ``values`` is a meta or
    fake tensor."""
    if _STAGING or _capturing():
        return False
    return not any(_abstract(v) for v in values)


def _label_key(label_names: tuple[str, ...], labels: dict[str, Any]
               ) -> tuple[str, ...]:
    if set(labels) != set(label_names):
        raise ValueError(
            f"expected labels {label_names}, got {tuple(labels)}")
    return tuple(str(labels[n]) for n in label_names)


class Metric:
    """Base: one named metric with a fixed label schema."""

    type: str = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._values: dict[tuple[str, ...], Any] = {}

    def _series(self) -> Iterable[tuple[tuple[str, ...], Any]]:
        return list(self._values.items())

    def labels_dict(self, key: tuple[str, ...]) -> dict[str, str]:
        return dict(zip(self.label_names, key))


class Counter(Metric):
    type = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment")
        if not host_clean(amount, *labels.values()):
            return
        key = _label_key(self.label_names, labels)
        self._values[key] = self._values.get(key, 0.0) + float(amount)

    def value(self, **labels: Any) -> float:
        return float(self._values.get(
            _label_key(self.label_names, labels), 0.0))


class Gauge(Metric):
    type = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        if not host_clean(value, *labels.values()):
            return
        self._values[_label_key(self.label_names, labels)] = float(value)

    def add(self, amount: float, **labels: Any) -> None:
        if not host_clean(amount, *labels.values()):
            return
        key = _label_key(self.label_names, labels)
        self._values[key] = self._values.get(key, 0.0) + float(amount)

    def value(self, **labels: Any) -> float:
        return float(self._values.get(
            _label_key(self.label_names, labels), 0.0))


class Histogram(Metric):
    type = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs or any(not math.isfinite(b) for b in bs):
            raise ValueError(f"histogram {name}: bad buckets {buckets}")
        self.buckets = bs

    def observe(self, value: float, **labels: Any) -> None:
        if not host_clean(value, *labels.values()):
            return
        key = _label_key(self.label_names, labels)
        st = self._values.get(key)
        if st is None:
            st = self._values[key] = {
                "counts": [0] * (len(self.buckets) + 1),   # +Inf tail
                "sum": 0.0, "count": 0}
        v = float(value)
        idx = len(self.buckets)
        for i, b in enumerate(self.buckets):
            if v <= b:
                idx = i
                break
        st["counts"][idx] += 1
        st["sum"] += v
        st["count"] += 1

    def percentile(self, q: float, **labels: Any) -> float:
        """Approximate percentile from bucket counts (upper bound of the
        bucket containing the q-th observation; +Inf tail reports the last
        finite bound)."""
        st = self._values.get(_label_key(self.label_names, labels))
        if not st or not st["count"]:
            return 0.0
        target = q / 100.0 * st["count"]
        seen = 0
        for i, c in enumerate(st["counts"]):
            seen += c
            if seen >= target and c:
                return self.buckets[min(i, len(self.buckets) - 1)]
        return self.buckets[-1]


class MetricsRegistry:
    """Get-or-create registry; re-registration with a different type or
    label schema is an error (one meaning per name per process)."""

    def __init__(self) -> None:
        self._metrics: dict[str, Metric] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._metrics)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def get(self, name: str) -> Metric | None:
        return self._metrics.get(name)

    def _get_or_create(self, cls, name: str, help: str,
                       labels: tuple[str, ...], **kw) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, help, tuple(labels), **kw)
                    self._metrics[name] = m
        if not isinstance(m, cls) or m.label_names != tuple(labels):
            raise ValueError(
                f"metric {name!r} already registered as {m.type} with "
                f"labels {m.label_names}; asked for {cls.type} with "
                f"{tuple(labels)}")
        return m

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: tuple[str, ...] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # ------------------------------------------------------------ exposition

    def snapshot(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            entry: dict[str, Any] = {"type": m.type, "help": m.help,
                                     "values": []}
            if isinstance(m, Histogram):
                entry["buckets"] = list(m.buckets)
            for key, val in m._series():
                row: dict[str, Any] = {"labels": m.labels_dict(key)}
                if isinstance(m, Histogram):
                    row.update(counts=list(val["counts"]), sum=val["sum"],
                               count=val["count"])
                else:
                    row["value"] = val
                entry["values"].append(row)
            out[name] = entry
        return out

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)

    def prometheus_text(self) -> str:
        lines: list[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {name} {m.type}")
            for key, val in m._series():
                labels = m.labels_dict(key)
                if isinstance(m, Histogram):
                    cum = 0
                    for i, b in enumerate(m.buckets):
                        cum += val["counts"][i]
                        lines.append(_prom_line(
                            name + "_bucket", {**labels, "le": _fmt(b)},
                            cum))
                    cum += val["counts"][-1]
                    lines.append(_prom_line(
                        name + "_bucket", {**labels, "le": "+Inf"}, cum))
                    lines.append(_prom_line(name + "_sum", labels,
                                            val["sum"]))
                    lines.append(_prom_line(name + "_count", labels,
                                            val["count"]))
                else:
                    lines.append(_prom_line(name, labels, val))
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(v: float) -> str:
    return repr(v) if v != int(v) else str(int(v))


def _prom_line(name: str, labels: dict[str, str], value: Any) -> str:
    if labels:
        inner = ",".join(
            f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items()))
        return f"{name}{{{inner}}} {value}"
    return f"{name} {value}"


def _escape(s: str) -> str:
    """Label-value escaping per the exposition-format spec: backslash,
    double-quote, and newline (in that order, so the escapes themselves
    survive)."""
    return s.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _escape_help(s: str) -> str:
    """HELP-text escaping: only backslash and newline (quotes are legal
    verbatim in help text, unlike in label values)."""
    return s.replace("\\", r"\\").replace("\n", r"\n")


# the process-default registry and its convenience constructors
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "",
            labels: tuple[str, ...] = ()) -> Counter:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: tuple[str, ...] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: tuple[str, ...] = (),
              buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labels, buckets)


def snapshot() -> dict[str, Any]:
    return REGISTRY.snapshot()


def prometheus_text() -> str:
    return REGISTRY.prometheus_text()


def clear() -> None:
    REGISTRY.clear()
