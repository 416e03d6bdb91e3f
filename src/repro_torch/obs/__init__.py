"""repro_torch.obs — the port's observability layer.

Three pillars, one import (the reference's ``repro.obs`` surface, with
``torchmon`` in place of ``jaxmon``):

  * ``metrics`` — thread-safe process-local registry of counters /
    gauges / log-bucket histograms; ``snapshot()`` (stable JSON dict)
    and Prometheus text exposition.
  * ``trace`` — nested host spans (``with span("pad"):``, and the
    ``traced`` decorator at the serving routes' layer boundaries) on the
    Unix-time clock of ``torch.profiler``, exported as Chrome trace-event
    JSON. A span records while its tracer is enabled (the process
    ``TRACER`` starts disabled) or while a profiler capture runs, and
    costs one check otherwise; ``device=True`` enters
    ``torch.profiler.record_function`` only under a capture.
  * ``torchmon`` — kernel builds and CUDA graph captures (the port's
    reading of "recompiles"), per-device memory gauges and the
    ``assert_no_rebuilds`` steady-state helper.

Plus the entry points' plumbing: ``setup_logging`` (``--log-json``) and
``EventLog`` (append-only JSONL run-event streams). Importing it needs
no GPU.
"""
from repro_torch.obs import metrics, torchmon, trace
from repro_torch.obs.logs import EventLog, JsonFormatter, setup_logging
from repro_torch.obs.metrics import (
    REGISTRY, counter, gauge, histogram, log_buckets, render_prometheus,
    snapshot, timed_ms,
)
from repro_torch.obs.torchmon import (
    SteadyStateError, assert_no_rebuilds, count_rebuilds, install,
    update_memory_gauges,
)
from repro_torch.obs.trace import TRACER, export_chrome_trace, span, traced

__all__ = [
    "metrics", "trace", "torchmon",
    "REGISTRY", "counter", "gauge", "histogram", "log_buckets",
    "snapshot", "render_prometheus", "timed_ms",
    "TRACER", "span", "traced", "export_chrome_trace",
    "install", "count_rebuilds", "assert_no_rebuilds",
    "SteadyStateError", "update_memory_gauges",
    "setup_logging", "EventLog", "JsonFormatter",
]
