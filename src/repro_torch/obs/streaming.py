"""Background streaming telemetry exporter for production-rate serving
(port of ``repro.obs.streaming``).

``launch/serve.py``-style runs previously exposed metrics exactly once, at
the end of ``generate()`` -- useless for a serve that runs for minutes.
:class:`StreamingExporter` is a daemon thread that, every ``interval_s``:

  1. invokes the registered *collectors* (engines register one for the
     duration of ``generate()`` so pool/mapper gauges update on the
     streaming cadence, not just at the end);
  2. appends one complete JSON line to ``metrics.jsonl`` (each line is a
     self-contained snapshot: a scrape that reads a prefix of the file
     sees only whole snapshots -- the line is written and flushed in one
     call);
  3. rewrites ``metrics.prom`` (Prometheus textfile-collector format)
     atomically: write to a temp file in the same directory, then
     ``os.replace`` -- a concurrent reader never observes a torn file.

Lifecycle is module-level (one exporter per process, like the metrics
registry): ``start(out_dir)`` / ``stop()`` / ``active()``.  ``stop()``
performs a final flush, so short runs still get at least one snapshot.
Collector callbacks are exception-isolated: a failing collector is
dropped from that flush, never kills the exporter thread.  They read host
state only (the engines' collectors publish mapper and ``PagePool``
gauges), and the exporter thread makes no CUDA call at all
(``metrics.host_only_thread``): a CUDA call from another thread while an
engine captures a step graph would invalidate that capture.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable

from repro_torch.obs import metrics, optrace

DEFAULT_INTERVAL_S = 10.0

JSONL_NAME = "metrics.jsonl"
PROM_NAME = "metrics.prom"


class StreamingExporter:
    """Periodic atomic snapshot writer (JSONL + Prometheus textfile)."""

    def __init__(self, out_dir: str, *,
                 interval_s: float = DEFAULT_INTERVAL_S):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.out_dir = out_dir
        self.interval_s = float(interval_s)
        self.jsonl_path = os.path.join(out_dir, JSONL_NAME)
        self.prom_path = os.path.join(out_dir, PROM_NAME)
        self.snapshots_written = 0
        self._collectors: list[Callable[[], None]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "StreamingExporter":
        os.makedirs(self.out_dir, exist_ok=True)
        # truncate any previous run's stream so seq numbers stay monotone
        open(self.jsonl_path, "w").close()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="obs-streaming", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(5.0, 2 * self.interval_s))
            self._thread = None
        self.flush()                           # final snapshot on the way out

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _run(self) -> None:
        metrics.host_only_thread()
        while not self._stop.wait(self.interval_s):
            self.flush()

    # ------------------------------------------------------------ collectors

    def add_collector(self, fn: Callable[[], None]) -> None:
        """Register a callback run before each snapshot (engines publish
        their pool/mapper gauges here)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def remove_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    # ------------------------------------------------------------ snapshots

    def flush(self) -> int:
        """Collect, then write one JSONL snapshot and rewrite the prom
        textfile atomically.  Returns the snapshot sequence number."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                pass                           # never kill the exporter
        with self._lock:
            self.snapshots_written += 1
            seq = self.snapshots_written
            line = json.dumps({
                "seq": seq,
                "ts_unix_s": time.time(),
                "uptime_s": round(optrace.now_s(), 6),
                "dropped_ops": optrace.dropped_ops(),
                "sampled_out_ops": optrace.sampled_out_ops(),
                "metrics": metrics.snapshot(),
            }, sort_keys=True)
            with open(self.jsonl_path, "a") as f:
                f.write(line + "\n")
                f.flush()
            tmp = self.prom_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(metrics.prometheus_text())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.prom_path)
        return seq


# ---------------------------------------------------------------------------
# module-level singleton (one exporter per process)
# ---------------------------------------------------------------------------

_EXPORTER: StreamingExporter | None = None


def start(out_dir: str, *,
          interval_s: float = DEFAULT_INTERVAL_S) -> StreamingExporter:
    """Start the process streaming exporter (stops any previous one)."""
    global _EXPORTER
    if _EXPORTER is not None:
        _EXPORTER.stop()
    _EXPORTER = StreamingExporter(out_dir, interval_s=interval_s).start()
    return _EXPORTER


def stop() -> None:
    global _EXPORTER
    if _EXPORTER is not None:
        _EXPORTER.stop()
        _EXPORTER = None


def active() -> StreamingExporter | None:
    """The running exporter, or None (engines use this to decide whether
    to register their per-run collector)."""
    if _EXPORTER is not None and _EXPORTER.running():
        return _EXPORTER
    return None


def add_collector(fn: Callable[[], None]) -> bool:
    """Register ``fn`` on the running exporter; False if none is active."""
    exp = active()
    if exp is None:
        return False
    exp.add_collector(fn)
    return True


def remove_collector(fn: Callable[[], None]) -> None:
    exp = _EXPORTER
    if exp is not None:
        exp.remove_collector(fn)


def read_jsonl(path: str) -> list[dict[str, Any]]:
    """Parse a streamed ``metrics.jsonl`` (complete lines only -- a
    trailing partial line from a crashed writer is ignored)."""
    out: list[dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            if not line.endswith("\n"):
                break
            out.append(json.loads(line))
    return out
