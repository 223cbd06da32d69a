"""repro_torch.obs -- runtime telemetry (port of ``repro.obs``): metrics
registry, dispatch op tracing, Chrome-trace export, and opt-in profiler
hooks.

Everything is off by default.  ``obs.enable()`` flips on the op-trace ring
and span recording; the metrics registry is always importable but only
ever mutated from instrumented call sites that first read ``optrace.ON``
-- so with telemetry off, the hot loops perform one module-attribute read
and no allocation.  A replayed CUDA graph runs no Python and pays nothing.

Quick start::

    import repro_torch.obs as obs

    obs.enable()
    ... run a workload ...
    obs.write_chrome_trace("trace.json")    # load in ui.perfetto.dev
    obs.metrics.REGISTRY.write_json("metrics.json")
    print(obs.metrics.prometheus_text())

Or from the shell (on the card unless ``--device cpu``)::

    python -m repro_torch.obs --smoke --trace-out trace.json \\
        --metrics-out metrics.json
"""
from repro_torch.obs import (annotate, attribution, metrics, optrace,
                             profiler, streaming, trace_export)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, REGISTRY, host_clean)
from repro_torch.obs.optrace import (OpEvent, SpanEvent, configure, disable,
                                     enable, enabled, record_dispatch, span,
                                     staging)
from repro_torch.obs.trace_export import (chrome_trace, validate_chrome_trace,
                                          write_chrome_trace)

__all__ = [
    "annotate", "attribution", "metrics", "optrace", "profiler",
    "streaming", "trace_export",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "host_clean",
    "OpEvent", "SpanEvent", "configure", "disable", "enable", "enabled",
    "record_dispatch", "span", "staging",
    "chrome_trace", "validate_chrome_trace", "write_chrome_trace",
]
