# Copied verbatim from kyverno_tpu/observability/flightrecorder.py.
"""Flight recorder — a bounded black box over the admission/scan ladder.

Every rung of the dispatch ladder (device, breaker-OPEN scalar,
quarantine, pipelined, pooled-encode, cached replay, DFA-confirm)
claims bit-identical verdicts, but a running deployment recorded
nothing about what was actually decided. This module keeps a bounded
in-memory ring of per-decision records — the evaluated resource body
(by reference; serialized and size-capped only at dump/spool time),
its content sha, the policy-set revision + content key, the dispatch
path and breaker state, the full verdict column, the trace id, and
phase timings — with head-based sampling:

- outcomes in ``ALWAYS_CAPTURE`` (error / scalar fallback / pattern
  CONFIRM / shed / expired / hedged race) are captured unconditionally
  — the rare paths are exactly the ones an incident needs;
- everything else (ok, cached) is captured at ``sample_rate`` (the
  ``serve --flight-sample-rate`` knob, default 1%), so the recorder's
  hot-path cost is one outcome classification + one RNG draw.

The ring dumps via ``/debug/flight?last=N`` and ``kyverno-tpu
flight-dump``, and spools to ``--flight-dir`` as newline-delimited
JSON automatically when a breaker transition or an SLO burn fires
(with a cooldown so a flapping breaker cannot flood the disk). Spooled
captures feed ``kyverno-tpu replay`` (offline re-evaluation + diff)
and the shadow verifier (observability/verification.py), which
replays sampled records through the scalar oracle at the pinned
revision and counts divergences.

Records hold a reference to the engine (compiled policy-set version)
that produced them so the verifier evaluates at the PINNED revision,
not whatever is active by the time the low-priority thread gets to it;
the reference is dropped from serialized output.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# outcomes captured regardless of the sample rate ("mutated" records
# are the shadow verifier's only evidence that a template-stamped patch
# matched the scalar oracle — they must never sample out)
ALWAYS_CAPTURE = frozenset({"error", "fallback", "shed", "confirm",
                            "expired", "hedged", "mutated"})

OUTCOME_OK = "ok"
OUTCOME_ERROR = "error"
OUTCOME_FALLBACK = "fallback"
OUTCOME_SHED = "shed"
OUTCOME_CONFIRM = "confirm"
OUTCOME_CACHED = "cached"
OUTCOME_EXPIRED = "expired"
# a hedged scalar dispatch raced an in-flight device batch; the record
# path names the winner ("hedged_scalar" / "hedged_device") and the
# race always captures — bit-identity under racing is exactly the
# claim the audit trail exists to witness
OUTCOME_HEDGED = "hedged"
# a batched-mutation decision: the record carries the patched body +
# its sha next to the original, and the verifier diffs the PATCHED
# output against a scalar re-patch (rows are routing, not verdicts)
OUTCOME_MUTATED = "mutated"

# verdict code mirror (tpu/evaluator.py order; this module must stay
# importable without jax, like the rest of observability/)
_ERROR_CODE = 4

_SPOOL_COOLDOWN_S = 5.0


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def policyset_key(engine: Any) -> str:
    """Content key of the compiled policy set an engine serves —
    memoized on the engine (cache_key() digests every policy)."""
    if engine is None:
        return ""
    key = getattr(engine, "_flight_ps_key", None)
    if key is None:
        try:
            key = engine.cps.cache_key()
        except Exception:
            key = ""
        try:
            engine._flight_ps_key = key
        except Exception:
            pass
    return key


def patched_digest(doc: Optional[Dict[str, Any]]) -> Optional[str]:
    """Content sha of a patched body — the SAME canonical hash the
    verdict cache keys resources with, so the webhook's recorded
    ``patched_sha`` and the verifier's scalar re-patch digest are
    directly comparable."""
    if doc is None:
        return None
    try:
        from ..tpu.cache import resource_content_hash

        return resource_content_hash(doc)
    except Exception:
        return None


def _replica_id() -> Optional[str]:
    """This process's fleet replica id (None outside a fleet) — the
    per-record tag that attributes spooled decisions to a failure
    domain."""
    try:
        from ..fleet.manager import current_replica_id

        return current_replica_id()
    except Exception:
        return None


class FlightRecord:
    """One recorded decision. Bodies and verdict rows are held by
    reference — building a record costs dict-slot assignments, never a
    serialization; the JSON shape materializes at to_dict() time."""

    __slots__ = ("kind", "seq", "ts", "trace_id", "outcome", "path",
                 "breaker", "revision", "ps_key", "resource",
                 "resource_sha", "namespace", "operation", "userinfo",
                 "ns_labels", "verdicts", "timings", "engine",
                 "patched", "patched_sha")

    def __init__(self, kind: str, outcome: str, path: str,
                 resource: Optional[Dict[str, Any]],
                 verdicts: Optional[List[Tuple[Tuple[str, str], int]]],
                 *, trace_id: str = "", breaker: str = "",
                 revision: Optional[int] = None, ps_key: str = "",
                 resource_sha: Optional[str] = None, namespace: str = "",
                 operation: str = "", userinfo: Optional[Dict] = None,
                 ns_labels: Optional[Dict[str, str]] = None,
                 timings: Optional[Dict[str, float]] = None,
                 engine: Any = None, ts: Optional[float] = None,
                 seq: int = 0, patched: Optional[Dict[str, Any]] = None,
                 patched_sha: Optional[str] = None):
        self.kind = kind
        self.seq = seq
        self.ts = time.time() if ts is None else ts
        self.trace_id = trace_id or ""
        self.outcome = outcome
        self.path = path
        self.breaker = breaker
        self.revision = revision
        self.ps_key = ps_key
        self.resource = resource
        self.resource_sha = resource_sha
        self.namespace = namespace
        self.operation = operation
        self.userinfo = userinfo
        self.ns_labels = ns_labels
        self.verdicts = verdicts
        self.timings = timings
        self.engine = engine
        self.patched = patched
        self.patched_sha = patched_sha

    def to_dict(self, body_cap: Optional[int] = None) -> Dict[str, Any]:
        doc: Dict[str, Any] = {
            "kind": self.kind, "seq": self.seq,
            "ts": round(self.ts, 3), "trace_id": self.trace_id,
            "outcome": self.outcome, "path": self.path,
            "breaker": self.breaker,
            "policyset_revision": self.revision,
            "policyset_key": self.ps_key,
            "resource_sha": self.resource_sha,
            "namespace": self.namespace, "operation": self.operation,
        }
        # fleet: records are tagged with the replica that made the
        # decision, so a spooled capture from a 3-replica incident
        # says WHICH failure domain each verdict came from
        replica = _replica_id()
        if replica:
            doc["replica"] = replica
        if self.userinfo:
            doc["userinfo"] = self.userinfo
        if self.ns_labels:
            doc["ns_labels"] = self.ns_labels
        if self.timings:
            doc["timings"] = {k: round(v, 6)
                              for k, v in self.timings.items()}
        if self.verdicts is not None:
            doc["verdicts"] = [[p, r, int(c)]
                               for (p, r), c in self.verdicts]
        body = self.resource
        if body is not None:
            try:
                blob = json.dumps(body, sort_keys=True,
                                  separators=(",", ":"))
            except (TypeError, ValueError):
                blob = None
            cap = self._body_cap() if body_cap is None else body_cap
            if blob is not None and len(blob) <= cap:
                doc["resource"] = body
                doc["resource_bytes"] = len(blob)
            else:
                # the sha still identifies the body; replay/verify skip
                doc["resource"] = None
                doc["resource_truncated"] = True
                if blob is not None:
                    doc["resource_bytes"] = len(blob)
        if self.patched_sha is not None:
            doc["patched_sha"] = self.patched_sha
        if self.patched is not None:
            try:
                blob = json.dumps(self.patched, sort_keys=True,
                                  separators=(",", ":"))
            except (TypeError, ValueError):
                blob = None
            cap = self._body_cap() if body_cap is None else body_cap
            if blob is not None and len(blob) <= cap:
                doc["patched"] = self.patched
            else:
                doc["patched"] = None
                doc["patched_truncated"] = True
        return doc

    @staticmethod
    def _body_cap() -> int:
        return global_flight.body_cap


class FlightRecorder:
    """Process-wide bounded ring + spool of FlightRecords."""

    def __init__(self, capacity: Optional[int] = None,
                 sample_rate: Optional[float] = None,
                 spool_dir: Optional[str] = None, metrics=None,
                 clock=time.monotonic):
        self._default_capacity = (
            capacity if capacity is not None
            else _env_int("KYVERNO_TPU_FLIGHT_CAPACITY", 2048))
        self._default_sample = (
            sample_rate if sample_rate is not None
            else _env_float("KYVERNO_TPU_FLIGHT_SAMPLE", 0.01))
        self._default_body_cap = _env_int("KYVERNO_TPU_FLIGHT_BODY_CAP",
                                          65536)
        # spool bounds: a soak that spools for hours must not grow the
        # disk without limit — keep the newest N flight-*.ndjson
        # segments, and rotate divergences.ndjson through N size-capped
        # segments (dropped segments are counted, never silent)
        self._default_spool_segments = _env_int(
            "KYVERNO_TPU_FLIGHT_SPOOL_SEGMENTS", 32)
        self._default_divergence_bytes = _env_int(
            "KYVERNO_TPU_FLIGHT_DIVERGENCE_MAX_BYTES", 16 << 20)
        self._clock = clock
        self._metrics = metrics
        self._lock = threading.Lock()
        self._rng = random.Random()
        self._sinks: List[Callable[[FlightRecord], None]] = []
        with self._lock:
            self._reset_state_locked()

    def _reset_state_locked(self) -> None:
        self.capacity = self._default_capacity
        self.sample_rate = self._default_sample
        self.body_cap = self._default_body_cap
        self.spool_dir: Optional[str] = None
        self.max_spool_segments = self._default_spool_segments
        self.divergence_max_bytes = self._default_divergence_bytes
        self._ring: deque = deque(maxlen=max(1, self.capacity))  # guarded-by: _lock
        self._seq = 0            # guarded-by: _lock
        self._last_spool_at = -1e9   # guarded-by: _lock
        self._spool_seq = 0          # guarded-by: _lock
        # guarded-by: _lock
        self.stats: Dict[str, Any] = {
            "captured": 0, "sampled_out": 0, "spools": 0,
            "by_outcome": {}, "divergences_spooled": 0,
            "spool_segments_dropped": 0,
            "divergence_segments_dropped": 0}

    # -- configuration

    def configure(self, capacity: Optional[int] = None,
                  sample_rate: Optional[float] = None,
                  spool_dir: Optional[str] = None,
                  body_cap: Optional[int] = None,
                  max_spool_segments: Optional[int] = None,
                  divergence_max_bytes: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None and capacity != self.capacity:
                self.capacity = max(1, capacity)
                self._ring = deque(self._ring, maxlen=self.capacity)
            if sample_rate is not None:
                self.sample_rate = min(1.0, max(0.0, sample_rate))
            if spool_dir is not None:
                self.spool_dir = spool_dir or None
            if body_cap is not None:
                self.body_cap = body_cap
            if max_spool_segments is not None:
                self.max_spool_segments = max(0, max_spool_segments)
            if divergence_max_bytes is not None:
                self.divergence_max_bytes = max(0, divergence_max_bytes)

    def reset(self) -> None:
        """Back to construction defaults (per-test isolation)."""
        with self._lock:
            self._reset_state_locked()
        self._sinks = []

    def add_sink(self, fn: Callable[[FlightRecord], None]) -> None:
        """Post-capture hook (the shadow verifier registers here): runs
        for every CAPTURED record, outside the ring lock."""
        if fn not in self._sinks:
            self._sinks.append(fn)

    @property
    def enabled(self) -> bool:
        """The recorder is always on (the ring is cheap); `enabled` is
        the short-circuit for callers that build record *inputs*: with
        rate 0 only ALWAYS_CAPTURE outcomes land, which still needs the
        inputs — so this is True unless capacity is zeroed."""
        return self.capacity > 0

    def _registry(self):
        if self._metrics is None:
            from .metrics import global_registry

            self._metrics = global_registry
        return self._metrics

    # -- capture

    @staticmethod
    def classify(rows: Optional[Sequence[Tuple[Tuple[str, str], int]]],
                 path: str, error: Optional[BaseException] = None,
                 confirm: bool = False, mutated: bool = False) -> str:
        """Outcome classification, most-interesting-wins: error >
        shed/expired > mutated > hedged > fallback > confirm > cached >
        ok. ``mutated`` outranks the path-derived classes so every
        successful mutate decision — including ``hedged_mutate`` and
        ``cached_mutate`` paths — lands in the mutate outcome class the
        verifier's patched-output diff selects on (the path string
        still says HOW it resolved)."""
        if error is not None:
            from ..serving.queue import DeadlineExceededError

            return (OUTCOME_EXPIRED
                    if isinstance(error, DeadlineExceededError)
                    else OUTCOME_ERROR)
        if rows is not None and any(c == _ERROR_CODE for _, c in rows):
            return OUTCOME_ERROR
        if path == "shed":
            return OUTCOME_SHED
        if mutated:
            return OUTCOME_MUTATED
        if path.startswith("hedged"):
            return OUTCOME_HEDGED
        if path in ("scalar_fallback", "pure_scalar"):
            return OUTCOME_FALLBACK
        if confirm:
            return OUTCOME_CONFIRM
        if path == "cached":
            return OUTCOME_CACHED
        return OUTCOME_OK

    def should_capture(self, outcome: str) -> bool:
        if self.capacity <= 0:
            return False
        if outcome in ALWAYS_CAPTURE:
            return True
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0 or self._rng.random() >= self.sample_rate:
            with self._lock:
                self.stats["sampled_out"] += 1
            try:
                self._registry().flight_sampled_out.inc()
            except Exception:
                pass
            return False
        return True

    def record(self, rec: FlightRecord) -> Optional[FlightRecord]:
        """Append one already-built record (sampling must have been
        decided via should_capture — record() always captures)."""
        with self._lock:
            self._seq += 1
            rec.seq = self._seq
            self._ring.append(rec)
            self.stats["captured"] += 1
            by = self.stats["by_outcome"]
            by[rec.outcome] = by.get(rec.outcome, 0) + 1
            ring_n = len(self._ring)
        try:
            reg = self._registry()
            reg.flight_records.inc({"outcome": rec.outcome})
            reg.flight_ring_size.set(ring_n)
        except Exception:
            pass
        for sink in self._sinks:
            try:
                sink(rec)
            except Exception:
                pass
        # the engine reference exists for the shadow verifier, which
        # has now either verified the record (synchronous), enqueued
        # its own strong reference (async), or declined it. The RING
        # must not pin superseded compiled versions in memory until
        # 2048 records turn over — under policy churn that is every
        # dead engine ever recorded
        rec.engine = None
        return rec

    def record_admission(self, resource: Optional[Dict[str, Any]],
                         rows: Optional[List[Tuple[Tuple[str, str], int]]],
                         path: str, *, error: Optional[BaseException] = None,
                         engine: Any = None,
                         revision: Optional[int] = None,
                         namespace: str = "", operation: str = "",
                         userinfo: Optional[Dict] = None,
                         ns_labels: Optional[Dict[str, str]] = None,
                         trace_id: str = "",
                         timings: Optional[Dict[str, float]] = None,
                         confirm: bool = False,
                         kind: str = "admission",
                         outcome: Optional[str] = None,
                         patched: Optional[Dict[str, Any]] = None,
                         patched_sha: Optional[str] = None
                         ) -> Optional[FlightRecord]:
        """Classify + sample + build + append one admission (or scan)
        record. All the potentially-expensive derivations (sha, policy-
        set key, breaker state) happen only after the sampling
        decision. A caller that already gated on classify() +
        should_capture() (to keep ITS expensive inputs behind the gate
        too) passes the decided ``outcome`` — sampling is not re-run."""
        if outcome is None:
            outcome = self.classify(rows, path, error=error,
                                    confirm=confirm,
                                    mutated=kind == "mutate")
            if not self.should_capture(outcome):
                return None
        # every mutate capture path must label its records: a mutate
        # record classified into a validate-shaped class (ok/cached/
        # fallback/...) would silently fall out of the verifier's
        # patched-output diff. Failure classes are the only exceptions
        # — there is no patched output to diff.
        assert kind != "mutate" or outcome in (
            OUTCOME_MUTATED, OUTCOME_ERROR, OUTCOME_EXPIRED,
            OUTCOME_SHED), f"unlabeled mutate record: {outcome!r}"
        sha = None
        if resource is not None:
            try:
                from ..tpu.cache import resource_content_hash

                sha = resource_content_hash(resource)
            except Exception:
                sha = None
        try:
            from ..resilience.breaker import tpu_breaker

            breaker = tpu_breaker().state
        except Exception:
            breaker = ""
        if patched is not None and patched_sha is None:
            patched_sha = patched_digest(patched)
        rec = FlightRecord(
            kind=kind, outcome=outcome, path=path, resource=resource,
            verdicts=list(rows) if rows is not None else None,
            trace_id=trace_id, breaker=breaker, revision=revision,
            ps_key=policyset_key(engine), resource_sha=sha,
            namespace=namespace, operation=operation, userinfo=userinfo,
            ns_labels=ns_labels, timings=timings, engine=engine,
            patched=patched, patched_sha=patched_sha)
        return self.record(rec)

    def record_scan_chunk(self, chunk, result, engine: Any = None,
                          ns_labels: Optional[Dict[str, Dict[str, str]]]
                          = None, revision: Optional[int] = None,
                          path: str = "scan", fallback: bool = False,
                          confirm: bool = False) -> int:
        """Per-resource sampled records for one evaluated (or cache-
        served) scan chunk. ``chunk`` is the scanner's list of
        (uid, resource, sha) triples; the chunk's verdict table supplies
        one column per resource. ``fallback``/``confirm`` are chunk-
        level signals from the caller (dispatch-path thread-local,
        engine confirm flag): the always-capture contract covers the
        scan side too — a breaker-OPEN scan tick must land in the ring
        regardless of the sample rate. Returns records captured."""
        if self.capacity <= 0 or result is None:
            return 0
        if getattr(result, "infra_error", False):
            # ERROR fill-in rows (the scan ladder's escape hatch) are
            # served but are NOT content truth: the verifier comparing
            # them to the oracle would raise a false divergence alarm
            engine = None
        import numpy as np

        verdicts = np.asarray(result.verdicts)
        if verdicts.ndim != 2 or verdicts.shape[1] < len(chunk):
            return 0
        err_cols = (verdicts == _ERROR_CODE).any(axis=0)
        chunk_outcome = (OUTCOME_FALLBACK if fallback
                         else OUTCOME_CONFIRM if confirm else OUTCOME_OK)
        nsmap = ns_labels or {}
        # ONE breaker-state read per chunk: the state cannot usefully
        # change per resource, and the read takes the same lock the
        # admission dispatch path contends on
        try:
            from ..resilience.breaker import tpu_breaker

            breaker = tpu_breaker().state
        except Exception:
            breaker = ""
        captured = 0
        for ci, (uid, res, h) in enumerate(chunk):
            outcome = OUTCOME_ERROR if err_cols[ci] else chunk_outcome
            if not self.should_capture(outcome):
                continue
            meta = (res.get("metadata") or {}) if isinstance(res, dict) \
                else {}
            ns = (meta.get("name", "")
                  if isinstance(res, dict) and res.get("kind") == "Namespace"
                  else meta.get("namespace", ""))
            rows = list(zip(result.rules,
                            (int(c) for c in verdicts[:, ci])))
            self.record(FlightRecord(
                kind="scan", outcome=outcome, path=path, resource=res,
                verdicts=rows, breaker=breaker, revision=revision,
                ps_key=policyset_key(engine), resource_sha=h,
                namespace=ns, operation="",
                ns_labels=nsmap.get(ns, {}) or None, engine=engine))
            captured += 1
        return captured

    # -- read side

    def dump(self, last: int = 100) -> List[Dict[str, Any]]:
        with self._lock:
            # [-0:] would be the WHOLE ring, not zero records
            records = list(self._ring)[-last:] if last > 0 else []
        return [r.to_dict(self.body_cap) for r in records]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def state(self) -> Dict[str, Any]:
        with self._lock:
            stats = {k: (dict(v) if isinstance(v, dict) else v)
                     for k, v in self.stats.items()}
            ring_n = len(self._ring)
        return {"capacity": self.capacity,
                "sample_rate": self.sample_rate,
                "records": ring_n,
                "spool_dir": self.spool_dir,
                "body_cap": self.body_cap,
                "max_spool_segments": self.max_spool_segments,
                "divergence_max_bytes": self.divergence_max_bytes,
                "stats": stats}

    # -- spool

    def spool(self, reason: str = "manual", force: bool = False
              ) -> Optional[str]:
        """Write the current ring to the spool dir as NDJSON; returns
        the path, or None (no dir / cooldown). Auto-triggers (breaker
        transitions, SLO burns) respect a cooldown so a flapping
        breaker cannot flood the disk; explicit dumps force."""
        from ..resilience import storage as st

        spool_dir = self.spool_dir
        if not spool_dir:
            return None
        # degraded-storage ladder (surface flight_spool): while the
        # disk is sick, spools are counted drops — the in-memory ring
        # keeps recording, and a due re-probe lets one spool attempt
        # through to heal the surface
        if not st.storage_health(st.SURFACE_FLIGHT).allow():
            return None
        now = self._clock()
        with self._lock:
            if not force and now - self._last_spool_at < _SPOOL_COOLDOWN_S:
                return None
            self._last_spool_at = now
            self._spool_seq += 1
            seq = self._spool_seq
            records = list(self._ring)
            self.stats["spools"] += 1
        try:
            st.makedirs(spool_dir, st.SURFACE_FLIGHT)
            safe = "".join(c if (c.isalnum() or c in "-_.") else "_"
                           for c in reason)[:60] or "spool"
            path = os.path.join(
                spool_dir, f"flight-{int(time.time())}-{seq:04d}-"
                           f"{safe}.ndjson")
            # one frame per record: a write that dies mid-segment
            # leaves whole-line prefixes load_capture() can still read
            with st.open_truncate(path, st.SURFACE_FLIGHT) as fh:
                for rec in records:
                    st.write_frame(
                        fh,
                        json.dumps(rec.to_dict(self.body_cap),
                                   default=str) + "\n",
                        st.SURFACE_FLIGHT, path=path)
        except OSError:
            return None
        dropped = self._prune_spool_segments(spool_dir)
        if dropped:
            with self._lock:
                self.stats["spool_segments_dropped"] = \
                    self.stats.get("spool_segments_dropped", 0) + dropped
        try:
            self._registry().flight_spools.inc({"reason": safe})
        except Exception:
            pass
        try:
            from .log import global_oplog

            global_oplog.emit("flight_spool", reason=reason, path=path,
                              records=len(records))
        except Exception:
            pass
        return path

    def spool_divergence(self, record_doc: Dict[str, Any],
                         expected: List[Tuple[Tuple[str, str], int]],
                         got: List[Tuple[Tuple[str, str], int]]
                         ) -> Optional[str]:
        """Append one shadow-verification divergence (the full record +
        both verdict tables) to ``divergences.ndjson`` in the spool
        dir — no cooldown: every divergence is evidence."""
        from ..resilience import storage as st

        spool_dir = self.spool_dir
        if not spool_dir:
            return None
        # its own surface (``divergences``): divergence evidence and
        # routine flight spools degrade independently
        if not st.storage_health(st.SURFACE_DIVERGENCES).allow():
            return None
        doc = {"kind": "divergence", "ts": round(time.time(), 3),
               "record": record_doc,
               "expected": [[p, r, int(c)] for (p, r), c in expected],
               "got": [[p, r, int(c)] for (p, r), c in got]}
        try:
            st.makedirs(spool_dir, st.SURFACE_DIVERGENCES)
            path = os.path.join(spool_dir, "divergences.ndjson")
            dropped = self._rotate_divergences(path)
            with self._lock:
                self.stats["divergences_spooled"] += 1
                if dropped:
                    self.stats["divergence_segments_dropped"] = \
                        self.stats.get("divergence_segments_dropped", 0) \
                        + dropped
            with st.open_append(path, st.SURFACE_DIVERGENCES) as fh:
                st.write_frame(fh, json.dumps(doc, default=str) + "\n",
                               st.SURFACE_DIVERGENCES, path=path)
        except OSError:
            return None
        return path

    # -- spool bounds (a soak must not grow the disk without limit)

    def _prune_spool_segments(self, spool_dir: str) -> int:
        """Keep only the newest ``max_spool_segments`` flight-*.ndjson
        files (names sort chronologically: epoch + spool seq). Returns
        how many segments were dropped; 0 disables the cap."""
        keep = self.max_spool_segments
        if keep <= 0:
            return 0
        try:
            names = sorted(n for n in os.listdir(spool_dir)
                           if n.startswith("flight-")
                           and n.endswith(".ndjson"))
        except OSError:
            return 0
        dropped = 0
        for name in names[:-keep]:
            try:
                os.remove(os.path.join(spool_dir, name))
                dropped += 1
            except OSError:
                pass
        if dropped:
            try:
                self._registry().flight_spool_dropped.inc(
                    {"kind": "segment"}, dropped)
            except Exception:
                pass
        return dropped

    def _rotate_divergences(self, path: str) -> int:
        """Size-capped rotation for divergences.ndjson: once the live
        file exceeds ``divergence_max_bytes`` it shifts to ``.1`` (and
        ``.1``->``.2``, ...), keeping the newest ``max_spool_segments``
        rotated segments. Returns segments dropped off the end.

        Every step of the replace chain goes through the storage shim:
        each rename either fully lands or leaves the previous file
        intact (os.replace is atomic), so a mid-rotation EIO is a
        counted degrade that leaves every segment a loadable NDJSON
        prefix — never a torn or vanished file."""
        from ..resilience import storage as st

        cap = self.divergence_max_bytes
        if cap <= 0:
            return 0
        try:
            if os.path.getsize(path) < cap:
                return 0
        except OSError:
            return 0
        keep = max(1, self.max_spool_segments)
        dropped = 0
        oldest = f"{path}.{keep}"
        if os.path.exists(oldest):
            try:
                os.remove(oldest)
                dropped = 1
            except OSError:
                return 0
        for i in range(keep - 1, 0, -1):
            src = f"{path}.{i}"
            if os.path.exists(src):
                try:
                    st.atomic_replace(src, f"{path}.{i + 1}",
                                      st.SURFACE_DIVERGENCES)
                except OSError:
                    pass  # counted + degraded by the shim; chain goes on
        try:
            st.atomic_replace(path, f"{path}.1", st.SURFACE_DIVERGENCES)
        except OSError:
            return dropped
        if dropped:
            try:
                self._registry().flight_spool_dropped.inc(
                    {"kind": "divergence"}, dropped)
            except Exception:
                pass
        return dropped

    # -- auto-spool triggers

    def on_breaker_transition(self, breaker: str, frm: str, to: str) -> None:
        # forced: a breaker transition is the definitive incident
        # moment and the breaker's own reset timeout already rate-
        # limits flapping — the SLO-burn cooldown must not starve it.
        # DETACHED: the caller holds the breaker lock (every admission
        # thread contends on it via allow()/record_*), so serializing
        # the whole ring to disk inline would stall serving exactly at
        # the recovery moment; the spool snapshots the ring itself
        if not self.spool_dir:
            return
        threading.Thread(
            target=self.spool,
            kwargs={"reason": f"breaker-{breaker}-{frm}-{to}",
                    "force": True},
            daemon=True, name="flight-spool").start()

    def on_slo_burn(self, slos: Sequence[str]) -> None:
        # DETACHED like the breaker spool: the burn is observed by
        # whatever thread refreshed the SLO gauges — including the
        # /metrics scrape via the collect hook — and serializing the
        # whole ring inline would time out the scrape at incident onset
        if not self.spool_dir:
            return
        threading.Thread(
            target=self.spool,
            kwargs={"reason": "slo-" + "-".join(sorted(slos))},
            daemon=True, name="flight-spool").start()


global_flight = FlightRecorder()


def load_capture(path: str) -> List[Dict[str, Any]]:
    """Read a spooled capture (flight-*.ndjson or divergences.ndjson):
    one JSON object per line; divergence lines are unwrapped to their
    embedded record. Malformed lines are skipped, not fatal — a capture
    truncated by a dying process must still mostly load."""
    out: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                continue
            if not isinstance(doc, dict):
                continue
            if doc.get("kind") == "divergence" and \
                    isinstance(doc.get("record"), dict):
                doc = doc["record"]
            out.append(doc)
    return out
