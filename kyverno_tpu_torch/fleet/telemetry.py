# Copied verbatim from kyverno_tpu/fleet/telemetry.py.
"""Fleet telemetry plane — cross-replica observability that composes
with the same never-wrong discipline the peered verdict caches use.

Every replica serves a structured, checksummed **snapshot** of its own
telemetry over ``/fleet/telemetry``: lifetime monotonic counters
(admissions, slow admissions, scan ticks, shadow-verification checks
and divergences), per-window SLO sample counts, and a few health
gauges — stamped with the replica id, a per-boot nonce, a monotonic
sequence number, the membership epoch, and a wall-clock timestamp,
then sealed with a sha256 checksum over the canonical JSON body.

The fleet **leader** (the existing lowest-live-id bit) pulls peers on
the heartbeat cadence and folds snapshots through a trust ladder:

1. **checksum** — the canonical-JSON sha must verify (a truncated,
   tampered, or bit-flipped snapshot rejects here);
2. **schema_version** — a replica speaking a different telemetry
   schema (rolling upgrade) is dropped, not misparsed;
3. **replay/ordering** — within one boot the sequence number must
   advance and the epoch must not regress (a replayed or reordered
   snapshot cannot rewind the view); a NEW boot id resets both;
4. **staleness** — a snapshot older than ``max_age_s`` is history,
   not state.

A snapshot that fails any rung is dropped and counted on
``kyverno_fleet_telemetry_rejects_total{reason}`` — never merged
wrong. Accepted counters merge as **deltas**: the fold adds
``current - last_seen`` (or ``current`` after a reset, detected by a
new boot id or a value that went backwards), so a replica restarting
with zeroed counters can never drive a fleet aggregate backwards and
the running total equals the ground-truth work the fleet actually
did, including work a dead replica finished before it died.

The leader publishes the fold as the ``kyverno_fleet_agg_*`` families
plus a fleet-wide SLO burn computed over the merged window samples
(sum of slow over sum of requests — a weighted merge, not an average
of per-replica averages), and gossips the rollup document back on the
heartbeat exchange so ANY replica can answer ``/debug/fleet`` with
the fleet-level view.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

TELEMETRY_SCHEMA_VERSION = 1

# names a snapshot's counters section may carry; the aggregator folds
# exactly these (an unknown name in a verified snapshot is ignored, so
# a newer replica adding counters stays mergeable by an older leader)
COUNTER_NAMES = ("admission_requests", "admission_slow", "scan_ticks",
                 "verification_checked", "verification_divergences")

# counter name -> aggregate family attribute on the registry
_AGG_FAMILY = {
    "admission_requests": "fleet_agg_admissions",
    "admission_slow": "fleet_agg_admission_slow",
    "scan_ticks": "fleet_agg_scan_ticks",
    "verification_checked": "fleet_agg_verification_checked",
    "verification_divergences": "fleet_agg_divergence",
}


def snapshot_checksum(doc: Dict[str, Any]) -> str:
    """Checksum over the canonical JSON of everything but the seal
    itself — any field mutated, dropped, or spliced in flight fails
    verification (the column_checksum idea applied to a document)."""
    body = {k: v for k, v in doc.items() if k != "sha"}
    canon = json.dumps(body, sort_keys=True, separators=(",", ":"),
                       default=str)
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()[:16]


class TelemetrySource:
    """Builds this replica's telemetry snapshots. The sequence number
    is monotonic per boot; the boot nonce is what lets an aggregator
    tell a legitimate restart (new boot id, seq back at 1) from a
    replayed old snapshot (same boot id, seq going backwards)."""

    def __init__(self, manager, slo=None, verifier=None):
        self._manager = manager
        self._slo = slo
        self._verifier = verifier
        self._lock = threading.Lock()
        self._seq = 0                                # guarded-by: _lock
        self.boot_id = os.urandom(4).hex()
        # test/bench hooks: override where counters / window samples
        # come from (in-process multi-replica tests share the process
        # globals, so per-replica ground truth needs injection)
        self.counters_provider: Optional[Callable[[], Dict[str, Any]]] = None
        self.windows_provider: Optional[Callable[[], Dict[str, Any]]] = None

    def _slo_tracker(self):
        if self._slo is None:
            from ..observability.analytics import global_slo

            self._slo = global_slo
        return self._slo

    def _verifier_ref(self):
        if self._verifier is None:
            from ..observability.verification import global_verifier

            self._verifier = global_verifier
        return self._verifier

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    def counters(self) -> Dict[str, float]:
        if self.counters_provider is not None:
            return dict(self.counters_provider())
        out: Dict[str, float] = dict(
            self._slo_tracker().telemetry_counters())
        try:
            v = self._verifier_ref().totals()
            out["verification_checked"] = v["checked"]
            out["verification_divergences"] = v["divergences"]
        except Exception:
            out.setdefault("verification_checked", 0)
            out.setdefault("verification_divergences", 0)
        return out

    def _windows(self) -> Dict[str, Any]:
        if self.windows_provider is not None:
            return dict(self.windows_provider())
        try:
            return self._slo_tracker().telemetry_windows()
        except Exception:
            return {}

    def _gauges(self) -> Dict[str, Any]:
        mgr = self._manager
        hit_rate = None
        try:
            fn = getattr(mgr.cache, "hit_rate", None)
            if fn is not None:
                hit_rate = round(float(fn()), 4)
        except Exception:
            hit_rate = None
        return {
            "shards_owned": len(mgr.owned_view()),
            "cache_hit_rate": hit_rate,
        }

    def build(self) -> Dict[str, Any]:
        """One sealed snapshot of this replica's telemetry — the
        ``/fleet/telemetry`` response body. Everything read here is
        local state; building a snapshot never triggers compute or a
        remote call (the no-amplification rule of the peer protocol)."""
        mgr = self._manager
        with self._lock:
            self._seq += 1
            seq = self._seq
        doc: Dict[str, Any] = {
            "schema_version": TELEMETRY_SCHEMA_VERSION,
            "replica_id": mgr.config.replica_id,
            "boot_id": self.boot_id,
            "seq": seq,
            "epoch": mgr.membership.epoch,
            "at": round(time.time(), 6),
            "counters": self.counters(),
            "slo_windows": self._windows(),
            "gauges": self._gauges(),
        }
        doc["sha"] = snapshot_checksum(doc)
        return doc


class TelemetryAggregator:
    """Leader-side fold of replica snapshots into fleet aggregates.

    Per replica the aggregator remembers the last accepted (boot id,
    seq, epoch, counter values); counters merge as deltas with reset
    detection, so the running totals are monotonic by construction.
    ``prune()`` drops replicas that left the live set from the health
    matrix and the per-replica gauge series — their already-folded
    contribution stays in the totals (work that happened, happened)."""

    def __init__(self, metrics=None, clock=time.monotonic,
                 max_age_s: float = 30.0):
        self._metrics = metrics
        self._clock = clock
        self.max_age_s = max_age_s
        self._lock = threading.Lock()
        self._replicas: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        self._totals: Dict[str, float] = {}             # guarded-by: _lock
        self._rejects: Dict[str, int] = {}              # guarded-by: _lock

    def _registry(self):
        if self._metrics is None:
            from ..observability.metrics import global_registry

            self._metrics = global_registry
        return self._metrics

    # -- ingest (the trust ladder)

    def ingest(self, doc: Any) -> str:
        """Fold one snapshot. Returns "" on acceptance or the reject
        reason; a rejected snapshot is counted and changes NOTHING."""
        reason, deltas = self._verify_and_fold(doc)
        if reason:
            m = self._registry()
            m.fleet_telemetry_rejects.inc({"reason": reason})
            with self._lock:
                self._count_reject_locked(reason)
            return reason
        if deltas:
            m = self._registry()
            for name, delta in deltas.items():
                fam = _AGG_FAMILY.get(name)
                if fam is not None and delta:
                    getattr(m, fam).inc(value=delta)
        return ""

    def _verify_and_fold(self, doc: Any
                         ) -> Tuple[str, Optional[Dict[str, float]]]:
        # rung 0: shape — a non-document can't even reach the checksum
        if not isinstance(doc, dict):
            return "decode", None
        sha = doc.get("sha")
        rid = doc.get("replica_id")
        counters = doc.get("counters")
        if not isinstance(sha, str) or not isinstance(rid, str) \
                or not rid or not isinstance(counters, dict):
            return "decode", None
        # rung 1: checksum — nothing below may trust a field until the
        # seal verifies (a tampered reason field must not pick its own
        # reject reason)
        if snapshot_checksum(doc) != sha:
            return "checksum", None
        # rung 2: schema — a rolling upgrade speaking a different
        # telemetry schema is dropped whole, never half-parsed
        if doc.get("schema_version") != TELEMETRY_SCHEMA_VERSION:
            return "schema_version", None
        try:
            boot_id = str(doc.get("boot_id") or "")
            seq = int(doc["seq"])
            epoch = int(doc.get("epoch", 0))
            at = float(doc["at"])
            vals = {n: float(counters.get(n, 0.0)) for n in COUNTER_NAMES
                    if isinstance(counters.get(n, 0.0), (int, float))}
        except (KeyError, TypeError, ValueError):
            return "decode", None
        # rung 4 (staleness) checked before taking the lock — it needs
        # no per-replica state
        if self.max_age_s > 0 and time.time() - at > self.max_age_s:
            return "stale", None
        now = self._clock()
        with self._lock:
            prev = self._replicas.get(rid)
            same_boot = prev is not None and prev["boot_id"] == boot_id
            # rung 3: replay/ordering — within one boot, seq must
            # advance and epoch must not regress
            if same_boot and seq <= prev["seq"]:
                return "stale_seq", None
            if same_boot and epoch < prev["epoch"]:
                return "epoch", None
            deltas: Dict[str, float] = {}
            for name, cur in vals.items():
                last = prev["counters"].get(name, 0.0) if same_boot else 0.0
                # reset detection: a value that went backwards within a
                # boot (or any value after a restart) folds as the full
                # current value — the delta is never negative, so the
                # aggregate is monotonic by construction
                delta = cur - last if cur >= last else cur
                if delta:
                    deltas[name] = delta
                    self._totals[name] = self._totals.get(name, 0.0) + delta
            self._replicas[rid] = {
                "boot_id": boot_id, "seq": seq, "epoch": epoch, "at": at,
                "counters": vals,
                "windows": dict(doc.get("slo_windows") or {}),
                "gauges": dict(doc.get("gauges") or {}),
                "received": now,
            }
        return "", deltas

    def _count_reject_locked(self, reason: str) -> None:
        self._rejects[reason] = self._rejects.get(reason, 0) + 1

    def note_reject(self, reason: str) -> None:
        with self._lock:
            self._count_reject_locked(reason)

    def prune(self, live_ids) -> None:
        """Drop replicas that left the live set: they disappear from
        the health matrix and their per-replica gauge series is
        removed (label cardinality tracks the LIVE fleet), while their
        folded contribution stays in the totals."""
        live = set(live_ids)
        with self._lock:
            gone = [rid for rid in self._replicas if rid not in live]
            for rid in gone:
                del self._replicas[rid]
        if gone:
            m = self._registry()
            for rid in gone:
                m.fleet_agg_snapshot_age.remove({"replica": rid})

    # -- read side

    def totals(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._totals)

    def rejects(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._rejects)

    def rollup(self, computed_by: str, epoch: int,
               slo_config=None) -> Dict[str, Any]:
        """The fleet-level document: per-replica health matrix + merged
        totals + fleet SLO burn. The leader computes it once per pull
        round and gossips it back on heartbeats, so any replica can
        serve it from /debug/fleet."""
        if slo_config is None:
            from ..observability.analytics import global_slo

            slo_config = global_slo.config
        budget = max(getattr(slo_config, "admission_error_budget", 0.01),
                     1e-9)
        now = self._clock()
        with self._lock:
            replicas = {rid: dict(rec) for rid, rec in
                        self._replicas.items()}
            totals = dict(self._totals)
            rejects = dict(self._rejects)
        matrix: Dict[str, Any] = {}
        merged_windows: Dict[str, Dict[str, float]] = {}
        for rid, rec in sorted(replicas.items()):
            windows = rec.get("windows") or {}
            burn = None
            for _name, w in sorted(windows.items()):
                req = float(w.get("requests", 0) or 0)
                slow = float(w.get("slow", 0) or 0)
                if burn is None:  # matrix shows the SHORTEST window
                    burn = round((slow / req) / budget, 4) if req else 0.0
            for name, w in windows.items():
                agg = merged_windows.setdefault(
                    name, {"requests": 0.0, "slow": 0.0,
                           "divergences": 0.0})
                agg["requests"] += float(w.get("requests", 0) or 0)
                agg["slow"] += float(w.get("slow", 0) or 0)
                agg["divergences"] += float(w.get("divergences", 0) or 0)
            gauges = rec.get("gauges") or {}
            matrix[rid] = {
                "seq": rec["seq"],
                "epoch": rec["epoch"],
                "snapshot_age_s": round(max(0.0, now - rec["received"]), 3),
                "slo_burn": burn if burn is not None else 0.0,
                "divergences": rec["counters"].get(
                    "verification_divergences", 0.0),
                "admission_requests": rec["counters"].get(
                    "admission_requests", 0.0),
                "shards_owned": gauges.get("shards_owned"),
                "cache_hit_rate": gauges.get("cache_hit_rate"),
                "windows": windows,
            }
        burn_by_window = {
            name: (round((w["slow"] / w["requests"]) / budget, 4)
                   if w["requests"] else 0.0)
            for name, w in sorted(merged_windows.items())}
        degraded = totals.get("verification_divergences", 0.0) > 0
        return {
            "schema_version": TELEMETRY_SCHEMA_VERSION,
            "computed_by": computed_by,
            "epoch": epoch,
            "at": round(time.time(), 6),
            "replicas": matrix,
            "totals": totals,
            "burn": burn_by_window,
            "merged_windows": merged_windows,
            "degraded": degraded,
            "rejects": rejects,
        }

    def publish_gauges(self) -> None:
        """Refresh the leader-side aggregate gauges (the counters were
        already advanced delta-by-delta at ingest)."""
        m = self._registry()
        now = self._clock()
        with self._lock:
            replicas = {rid: rec["received"]
                        for rid, rec in self._replicas.items()}
            totals = dict(self._totals)
        fresh = 0
        for rid, received in sorted(replicas.items()):
            age = max(0.0, now - received)
            m.fleet_agg_snapshot_age.set(round(age, 3), {"replica": rid})
            if self.max_age_s <= 0 or age <= self.max_age_s:
                fresh += 1
        m.fleet_agg_replicas_reporting.set(fresh)
        m.fleet_agg_degraded.set(
            1.0 if totals.get("verification_divergences", 0.0) > 0 else 0.0)

    def publish_burn(self, rollup: Dict[str, Any]) -> None:
        m = self._registry()
        for name, rate in (rollup.get("burn") or {}).items():
            m.fleet_agg_burn.set(float(rate), {"window": str(name)})
