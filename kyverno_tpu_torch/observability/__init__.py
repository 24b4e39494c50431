"""Observability for the port: metrics, tracing, the operator log, the
flight recorder, per-phase profiling and the rule analytics (copies of
``kyverno_tpu/observability/{metrics,tracing,log,flightrecorder,
profiling,analytics}.py``; profiling traces with ``torch.profiler``).
Events and shadow verification are not ported yet."""
