"""Observability for the port: metrics, tracing, the operator log, the
flight recorder and per-phase profiling (copies of
``kyverno_tpu/observability/{metrics,tracing,log,flightrecorder,
profiling}.py``; profiling traces with ``torch.profiler``). The rule
analytics, events and shadow verification are not ported yet."""
