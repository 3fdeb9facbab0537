"""obs — request-lifecycle tracing + metrics for serve/train (a copy of
the JAX package's ``obs``, which imports only the standard library and
numpy; the port keeps its own so that nothing here reaches ``repro``).

Three pieces, all zero-dependency (stdlib + numpy):

* :class:`Tracer` (``obs.trace``) — request-lifecycle spans (submitted
  -> admitted -> prefilling -> decoding -> drained, plus drops) with
  host wall-clock timestamps AND device step counters, exported as
  Chrome trace-event JSON;
* :class:`Metrics` (``obs.metrics``) — counters, gauges and fixed
  log-bucket histograms, snapshotted to JSONL;
* instrumentation hooks in ``serve.engine`` (both batchers),
  ``serve.pages`` (pool occupancy, prefix hits, COW) and the
  ``launch.serve`` driver (``--trace`` / ``--metrics-out``).

The instrumented-OFF hot path is unchanged: the device batcher's fused
step is the same with a tracer attached (lifecycles are replayed on the
host from the drained state), and token streams are bit-exact either
way.
"""
from .metrics import Counter, Gauge, Histogram, Metrics
from .trace import RequestTrace, Tracer, step_time_interp

__all__ = ["Counter", "Gauge", "Histogram", "Metrics", "RequestTrace",
           "Tracer", "step_time_interp"]
