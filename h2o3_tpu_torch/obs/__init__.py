"""Observability of the port (h2o3_tpu/obs/): a process-global metrics
registry (Prometheus and OpenMetrics text, JSON, the cluster merge), a
bounded ring of timed spans nested per thread, trace ids carried in a
per-thread context (`tracing`), and the flight recorder (`recorder`),
which keeps traces by tail sampling in segment files under the ice root;
`usage` (device-time attribution, request stage waterfalls, the pressure
model), `modelmon` (drift against a training baseline), `slo` (multi-window
burn-rate alerts) and `watchdog` (stalls turned into pinned diagnostic
traces). The structured logger is `utils/log.py`, and the lock-order
checker `analysis/lockdep.py`.

Env surface:
  H2O3_OBS_TIMELINE_CAPACITY  span ring size (default 4096)
  H2O3_OBS_TRACE_DIR          profiler bridge: torch.profiler Chrome-trace
                              output dir
  H2O3_OBS_TRACE_SPAN         span-name prefix that triggers the capture
  H2O3_TRACING                "0" disables trace-id minting
"""

from h2o3_tpu_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                        MetricsRegistry, counter, gauge,
                                        histogram)
from h2o3_tpu_torch.obs.timeline import SPANS, Span, SpanTimeline, span
from h2o3_tpu_torch.obs import tracing

__all__ = ["REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "counter", "gauge", "histogram",
           "SPANS", "Span", "SpanTimeline", "span", "tracing"]
