"""Unified telemetry layer: tracing, metrics, run logs, and the black box.

The port of ``distributed_inference_demo_tpu/telemetry/``.  Its modules
do no JAX work, so they are copies, on the port's own registry and
singletons, except where the card differs from the TPU:

- ``tracing``: per-request trace ids, spans, Chrome trace-event export
  for Perfetto (``GET /trace``);
- ``metrics``: a hand-rolled Prometheus registry + ``catalog``, the
  standard ``dwt_*`` series bridging the engines' stats, the flight
  recorder, the observatory and host memory to ``GET /metrics``;
- ``runlog``: structured JSONL run logs (``serve --run-log``);
- ``flightrecorder``: a bounded always-on ring of recent runtime events;
- ``slo``: per-request timelines and per-tenant SLO/goodput accounting
  (``GET /timeline``);
- ``anomaly``: online detectors over the stats surfaces;
- ``postmortem``: on trigger or crash, dump a bundle (flight ring,
  metrics snapshot, Chrome trace, config, run-log tail);
- ``profiling``: the cost observatory.  Its sampled timer synchronizes
  the CUDA device, its bandwidth ceiling is the card's, and CUDA graph
  captures count as compiles (``GET /sketch`` serves its workload
  sketch).

``catalog`` is imported lazily by its consumers; importing this package
stays light so the engine hot path can use ``runlog`` without the whole
metric set.
"""

from .flightrecorder import (FlightRecorder, get_flight_recorder,
                             set_flight_recorder)
from .metrics import (Counter, Gauge, Histogram, MetricError,
                      MetricsHTTPServer, REGISTRY, Registry)
from .runlog import RunLog, get_run_log, new_run_id, set_run_log
from .tracing import (SpanClock, TraceRecorder, new_trace_id,
                      to_chrome_trace, write_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricError", "MetricsHTTPServer",
    "REGISTRY", "Registry",
    "RunLog", "get_run_log", "new_run_id", "set_run_log",
    "FlightRecorder", "get_flight_recorder", "set_flight_recorder",
    "SpanClock", "TraceRecorder", "new_trace_id", "to_chrome_trace",
    "write_chrome_trace",
]
