# Copied verbatim from kyverno_tpu/observability/tracing.py.
"""Tracing — causally-connected spans across the whole request path.

The reference wraps every rule and policy evaluation in OTel spans
(pkg/tracing, engine.go:243). This layer gives the batch engine the
same causality story with real identifiers: 128-bit trace IDs, 64-bit
span IDs, and an explicit ``SpanContext`` that crosses thread
boundaries by value — the serving queue attaches the submitting
request's context to its pending-request record so the flusher thread's
queue-wait / flush / dispatch / verdict spans land in the SAME trace,
and ``parallel/sharding.py`` propagates a scan-level context to every
tile's encode/device/host spans.

Exporters are pluggable: the tracer always keeps a bounded in-memory
ring buffer (the ``/debug/traces`` source), and callers may attach an
``OTLPJsonFileExporter`` (newline-delimited OTLP-JSON, one span per
line — ``serve --trace-export PATH``) or any ``callable(Span)``.

Clock discipline: span ``start``/``end`` are ``time.monotonic()``
(comparable with the serving queue's arrival/deadline stamps, so
retroactively recorded spans — ``record_span`` — line up with live
ones); export converts to wall-clock nanoseconds via the tracer's
monotonic->epoch anchor.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

STATUS_OK = "ok"
STATUS_ERROR = "error"


def new_trace_id() -> str:
    """128-bit trace id, lowercase hex (W3C traceparent width)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """64-bit span id, lowercase hex."""
    return os.urandom(8).hex()


@dataclass(frozen=True)
class SpanContext:
    """The propagatable identity of a span: pass it by VALUE across
    threads/queues and start children with ``tracer.span(...,
    parent=ctx)`` — never rely on thread-locals across a handoff."""

    trace_id: str
    span_id: str


def context_to_wire(ctx: Optional[SpanContext]) -> Optional[Dict[str, str]]:
    """Serialize a SpanContext for a JSON RPC envelope (the fleet peer
    protocol carries the caller's context so the receiver can open a
    child span — one connected trace across replicas)."""
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id, "span_id": ctx.span_id}


def context_from_wire(doc: Any) -> Optional[SpanContext]:
    """Parse a wire envelope back into a SpanContext; None for
    anything malformed — a corrupt envelope degrades to an unlinked
    span, never an error on the serving path."""
    if not isinstance(doc, dict):
        return None
    tid, sid = doc.get("trace_id"), doc.get("span_id")
    if not (isinstance(tid, str) and isinstance(sid, str) and tid and sid):
        return None
    return SpanContext(trace_id=tid, span_id=sid)


@dataclass
class SpanEvent:
    name: str
    timestamp: float  # monotonic, same clock as Span.start/end
    attributes: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Span:
    name: str
    context: SpanContext
    start: float
    end: float = 0.0
    parent_span_id: Optional[str] = None
    attributes: Dict[str, Any] = field(default_factory=dict)
    events: List[SpanEvent] = field(default_factory=list)
    status: str = STATUS_OK
    status_message: str = ""

    @property
    def trace_id(self) -> str:
        return self.context.trace_id

    @property
    def span_id(self) -> str:
        return self.context.span_id

    @property
    def parent(self) -> Optional[str]:
        """Parent SPAN ID (identity, not name — two nested spans with
        the same name stay distinct)."""
        return self.parent_span_id

    @property
    def duration(self) -> float:
        return (self.end or time.monotonic()) - self.start

    def add_event(self, name: str, **attributes: Any) -> None:
        self.events.append(SpanEvent(name, time.monotonic(), attributes))

    def set_status(self, status: str, message: str = "") -> None:
        self.status = status
        self.status_message = message

    def to_dict(self) -> Dict[str, Any]:
        """Plain-JSON shape for /debug/traces."""
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "start": self.start,
            "duration_ms": round(self.duration * 1e3, 4),
            "status": self.status,
            **({"status_message": self.status_message}
               if self.status_message else {}),
            "attributes": dict(self.attributes),
            "events": [{"name": e.name,
                        "offset_ms": round((e.timestamp - self.start) * 1e3, 4),
                        "attributes": dict(e.attributes)} for e in self.events],
        }


def _otlp_value(v: Any) -> Dict[str, Any]:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _otlp_attrs(attrs: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [{"key": k, "value": _otlp_value(v)} for k, v in attrs.items()]


class OTLPJsonFileExporter:
    """Newline-delimited OTLP-JSON file exporter for offline runs: one
    ExportTraceServiceRequest per line, one span per request — greppable
    and streamable, loadable by any OTLP-JSON-aware tool."""

    def __init__(self, path: str, service_name: str = "kyverno-tpu") -> None:
        from ..resilience import storage as st

        self.path = path
        self.service_name = service_name
        self._lock = threading.Lock()
        # monotonic -> wall anchor taken once, so a run's spans share a
        # consistent epoch even if the system clock steps mid-run
        self._epoch = time.time() - time.monotonic()
        try:
            self._fh = st.open_append(path, st.SURFACE_TRACE, buffering=1)
        except OSError:
            # degraded from birth (read-only/full disk at boot): spans
            # drop-and-count; __call__'s probes retry the open
            self._fh = None

    def _nanos(self, monotonic_t: float) -> str:
        return str(int((monotonic_t + self._epoch) * 1e9))

    def __call__(self, span: Span) -> None:
        otlp_span: Dict[str, Any] = {
            "traceId": span.trace_id,
            "spanId": span.span_id,
            "name": span.name,
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": self._nanos(span.start),
            "endTimeUnixNano": self._nanos(span.end or time.monotonic()),
            "attributes": _otlp_attrs(span.attributes),
            "events": [{
                "timeUnixNano": self._nanos(e.timestamp),
                "name": e.name,
                "attributes": _otlp_attrs(e.attributes),
            } for e in span.events],
            "status": {"code": 2 if span.status == STATUS_ERROR else 1,
                       **({"message": span.status_message}
                          if span.status_message else {})},
        }
        if span.parent_span_id:
            otlp_span["parentSpanId"] = span.parent_span_id
        line = json.dumps({"resourceSpans": [{
            "resource": {"attributes": _otlp_attrs(
                {"service.name": self.service_name})},
            "scopeSpans": [{"scope": {"name": "kyverno_tpu"},
                            "spans": [otlp_span]}],
        }]})
        # degraded-storage ladder (surface trace_export): a span is
        # never worth blocking or crashing the span-finishing thread
        # for — while the disk is sick, export is a counted drop, and
        # a due re-probe retries the open/write until it heals
        from ..resilience import storage as st

        if not st.storage_health(st.SURFACE_TRACE).allow():
            return
        with self._lock:
            try:
                if self._fh is None:
                    self._fh = st.open_append(self.path, st.SURFACE_TRACE,
                                              buffering=1)
                st.write_frame(self._fh, line + "\n", st.SURFACE_TRACE,
                               path=self.path)
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            try:
                if self._fh is not None:
                    self._fh.close()
            except Exception:
                pass


class Tracer:
    """Span factory + bounded in-memory store.

    Context propagation is a per-thread stack of live spans; an explicit
    ``parent=SpanContext`` overrides it (the cross-thread path). The
    stack is keyed by span ID, so nested spans sharing a name — or
    sibling spans on other threads — can never corrupt each other's
    parentage (the former name-keyed restore bug)."""

    def __init__(self, exporter: Optional[Callable[[Span], None]] = None,
                 max_spans: int = 4096) -> None:
        self._exporters: List[Callable[[Span], None]] = []
        if exporter is not None:
            self._exporters.append(exporter)
        self._spans: List[Span] = []
        self._lock = threading.Lock()
        self._max = max_spans
        self._local = threading.local()

    # -- exporter plumbing

    def add_exporter(self, exporter: Callable[[Span], None]) -> None:
        with self._lock:
            self._exporters.append(exporter)

    def remove_exporter(self, exporter: Callable[[Span], None]) -> None:
        with self._lock:
            try:
                self._exporters.remove(exporter)
            except ValueError:
                pass

    def _export(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self._max:
                self._spans = self._spans[-self._max:]
            exporters = list(self._exporters)
        for exp in exporters:
            try:
                exp(span)
            except Exception:
                pass  # a broken exporter must not fail the traced path

    # -- context propagation

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current_context(self) -> Optional[SpanContext]:
        """The active span's context on THIS thread — capture it before
        a queue/thread handoff and pass it as ``parent=`` on the far
        side."""
        stack = self._stack()
        return stack[-1].context if stack else None

    def current_span(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def add_event(self, name: str, **attributes: Any) -> None:
        """Attach an event to this thread's active span, if any — the
        hook resilience sites (breaker transitions, fault injections,
        retry attempts) use without needing a span handle."""
        span = self.current_span()
        if span is not None:
            span.add_event(name, **attributes)

    # -- span lifecycle

    def _make_span(self, name: str, parent: Optional[SpanContext],
                   attributes: Dict[str, Any]) -> Span:
        if parent is None:
            parent = self.current_context()
        ctx = SpanContext(
            trace_id=parent.trace_id if parent else new_trace_id(),
            span_id=new_span_id())
        return Span(name=name, context=ctx, start=time.monotonic(),
                    parent_span_id=parent.span_id if parent else None,
                    attributes=dict(attributes))

    @contextmanager
    def span(self, name: str, parent: Optional[SpanContext] = None,
             **attributes: Any):
        """Start a span as a child of ``parent`` (explicit cross-thread
        context) or of this thread's current span."""
        s = self._make_span(name, parent, attributes)
        stack = self._stack()
        stack.append(s)
        try:
            yield s
        except Exception as e:
            s.set_status(STATUS_ERROR, f"{type(e).__name__}: {e}")
            raise
        finally:
            s.end = time.monotonic()
            # pop by IDENTITY: a mis-nested exit removes this span only,
            # never a same-named ancestor
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is s:
                    del stack[i]
                    break
            self._export(s)

    def start_span(self, name: str, parent: Optional[SpanContext] = None,
                   **attributes: Any) -> Span:
        """Manual lifecycle for spans that outlive a lexical scope (a
        request parked in a queue). Does NOT touch the thread-local
        stack; finish with ``end_span``."""
        return self._make_span(name, parent, attributes)

    def end_span(self, span: Span) -> None:
        if not span.end:
            span.end = time.monotonic()
        self._export(span)

    def record_span(self, name: str, start: float, end: float,
                    parent: Optional[SpanContext] = None,
                    status: str = STATUS_OK, **attributes: Any) -> Span:
        """Retroactively record a span from explicit monotonic
        timestamps — how the flusher thread materializes a request's
        queue-wait span after the fact, parented into the request's
        trace via the context the queue carried across the handoff."""
        ctx = SpanContext(
            trace_id=parent.trace_id if parent else new_trace_id(),
            span_id=new_span_id())
        s = Span(name=name, context=ctx, start=start, end=end,
                 parent_span_id=parent.span_id if parent else None,
                 attributes=dict(attributes), status=status)
        self._export(s)
        return s

    # -- introspection

    def finished(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            return [s for s in self._spans if name is None or s.name == name]

    def traces(self) -> Dict[str, List[Span]]:
        """Finished spans grouped by trace id (insertion-ordered)."""
        out: Dict[str, List[Span]] = {}
        for s in self.finished():
            out.setdefault(s.trace_id, []).append(s)
        return out

    def trace(self, trace_id: str) -> List[Span]:
        return [s for s in self.finished() if s.trace_id == trace_id]

    def recent_traces(self, min_duration_s: float = 0.0,
                      limit: int = 50) -> List[Dict[str, Any]]:
        """JSON-ready recent traces, newest last, filterable by total
        trace duration (max span end - min span start) — the
        /debug/traces payload."""
        out = []
        for tid, spans in self.traces().items():
            t0 = min(s.start for s in spans)
            t1 = max(s.end or s.start for s in spans)
            if (t1 - t0) < min_duration_s:
                continue
            out.append({
                "trace_id": tid,
                "duration_ms": round((t1 - t0) * 1e3, 4),
                "spans": [s.to_dict() for s in spans],
            })
        return out[-limit:]

    def reset(self) -> None:
        """Drop stored spans (tests); exporters stay attached."""
        with self._lock:
            self._spans = []


global_tracer = Tracer()
