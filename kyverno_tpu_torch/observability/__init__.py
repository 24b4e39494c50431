"""Observability for the port: events, metrics, tracing, the operator log,
the flight recorder, shadow verification, per-phase profiling and the
rule analytics (copies of ``kyverno_tpu/observability``; profiling traces
with ``torch.profiler``)."""

from .analytics import (RuleIdent, RuleStatsAccumulator, SloTracker,
                        StarvationTracker, global_rule_stats, global_slo,
                        global_starvation)
from .events import Event, EventGenerator
from .metrics import MetricsRegistry, global_registry
from .profiling import PhaseProfiler, global_profiler
from .tracing import (OTLPJsonFileExporter, Span, SpanContext, Tracer,
                      global_tracer)
from .verification import ShadowVerifier, global_verifier
