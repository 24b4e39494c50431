# Copied verbatim from kyverno_tpu/reports/store.py.
"""Crash-consistent incremental report store.

PAPER.md layers 6-7 (PolicyReport / ClusterPolicyReport /
EphemeralReport aggregation) re-expressed as a columnar fold: the
engine already produces exact per-resource verdict columns, so report
maintenance is a delta fold keyed by ``(resource sha, policy-set
content key)``:

- an upsert whose ``(sha, ps_key)`` pair is unchanged is ZERO work —
  no journal append, no count updates (``reports_fold_skipped``);
- a changed upsert unfolds the resource's previous rows from the
  derived counts and folds the new ones (``reports_fold_ops``) —
  report cost scales with what moved, never with cluster size;
- a delete unfolds and forgets;
- ``rebuild()`` recomputes the derived counts from the base rows from
  scratch — the bit-identity oracle every delta path is checked
  against (``digest()`` compares the full state canonically).

Crash consistency (journal.py): each delta appends to a
length-prefixed CRC'd journal BEFORE it folds, with periodic compacted
snapshots; recovery replays the good prefix and counts every
degradation on ``kyverno_reports_recoveries_total{reason}``. A fold
that dies midway (fault site ``reports.fold``) degrades to a full
derived-count rebuild from base — slower, never wrong.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ..cluster.reports import RESULT_NAMES, PolicyReport, ReportResult
from ..observability.metrics import global_registry
from ..resilience import storage as st
from ..resilience.faults import (SITE_REPORTS_FOLD, SITE_REPORTS_JOURNAL,
                                 global_faults)
from . import journal as jn

# base record: (sha, ps_key, namespace, kind, name, rows) with rows a
# list of [policy, rule, result] triples — plain JSON types only, so a
# journal/snapshot round trip reproduces the in-memory value exactly
# (digest bit-identity across restarts depends on it)
Rec = Tuple[str, str, str, str, str, List[List[str]]]


class ReportStore:
    """Incremental report state: base rows + derived counts, journaled.

    ``directory=None`` runs in-memory (no journal, no snapshots) —
    same fold semantics, no durability."""

    def __init__(self, directory: Optional[str] = None,
                 journal_max_bytes: int = 4 << 20) -> None:
        self.directory = directory
        self.journal_max_bytes = max(4096, int(journal_max_bytes))
        self.metrics = global_registry
        self._lock = threading.Lock()
        # base state: uid -> Rec
        self._rows: Dict[str, Rec] = {}          # guarded-by: _lock
        # derived state, incrementally folded (pruned at zero so a
        # fold/unfold sequence is bit-identical to a fresh rebuild)
        self._ns_counts: Dict[str, Dict[str, int]] = {}      # guarded-by: _lock
        self._policy_counts: Dict[str, Dict[str, int]] = {}  # guarded-by: _lock
        self._totals: Dict[str, int] = {}        # guarded-by: _lock
        self._seq = 0                            # guarded-by: _lock
        self._journal_fh = None                  # guarded-by: _lock
        self._journal_bytes = 0                  # guarded-by: _lock
        self._heal_compact = False               # guarded-by: _lock
        self.stats = {"recovered_records": 0, "verify_checks": 0,
                      "compactions": 0}          # guarded-by: _lock
        if directory:
            try:
                st.makedirs(directory, st.SURFACE_REPORTS)
            except OSError:
                pass  # degraded at boot: fold in memory, heal by probe
            with self._lock:
                self._load_locked()

    # -- the fold

    def apply(self, uid: str, sha: str, ps_key: str, ns: str, kind: str,
              name: str, rows: Iterable[Sequence[str]]) -> bool:
        """Fold one resource's verdict rows. Returns True when a delta
        was journaled+folded, False on the unchanged zero-work path."""
        norm = [[str(p), str(r), str(s)] for (p, r, s) in rows]
        with self._lock:
            old = self._rows.get(uid)
            if old is not None and old[0] == sha and old[1] == ps_key:
                self.metrics.reports_fold_skipped.inc()
                return False
            new: Rec = (str(sha), str(ps_key), str(ns), str(kind),
                        str(name), norm)
            self._journal_locked({"op": "put", "uid": uid, "sha": new[0],
                                  "ps": new[1], "ns": new[2],
                                  "kind": new[3], "name": new[4],
                                  "rows": norm})
            self._fold_locked(uid, old, new)
            self._maybe_compact_locked()
        return True

    def delete(self, uid: str) -> bool:
        """Unfold and forget a deleted resource's rows."""
        with self._lock:
            old = self._rows.get(uid)
            if old is None:
                return False
            self._journal_locked({"op": "del", "uid": uid})
            self._fold_locked(uid, old, None)
            self._maybe_compact_locked()
        return True

    def _fold_locked(self, uid: str, old: Optional[Rec],
                     new: Optional[Rec]) -> None:
        if new is None:
            self._rows.pop(uid, None)
        else:
            self._rows[uid] = new
        try:
            global_faults.fire(SITE_REPORTS_FOLD, payload=uid)
            if old is not None:
                self._count_locked(old, -1)
            if new is not None:
                self._count_locked(new, +1)
            self.metrics.reports_fold_ops.inc()
        except Exception:
            # the fold died midway: derived counts may be half-updated.
            # Base rows are already correct, so degrade to a full
            # derived rebuild — slower, counted, never a wrong report.
            self._rebuild_derived_locked()
            self.metrics.reports_rebuilds.inc()
        self.metrics.reports_resources.set(float(len(self._rows)))

    def _count_locked(self, rec: Rec, delta: int) -> None:
        ns = rec[2]
        for policy, _rule, result in rec[5]:
            _bump(self._ns_counts, ns, result, delta)
            _bump(self._policy_counts, policy, result, delta)
            v = self._totals.get(result, 0) + delta
            if v:
                self._totals[result] = v
            else:
                self._totals.pop(result, None)

    def _rebuild_derived_locked(self) -> None:
        self._ns_counts = {}
        self._policy_counts = {}
        self._totals = {}
        for rec in self._rows.values():
            self._count_locked(rec, +1)

    # -- the oracle

    def rebuild(self) -> str:
        """From-scratch recompute of derived state from base rows — the
        bit-identity oracle for every delta path. Returns the
        post-rebuild digest."""
        with self._lock:
            self._rebuild_derived_locked()
            self.metrics.reports_rebuilds.inc()
            return self._digest_locked()

    def digest(self) -> str:
        """Canonical sha256 over the ENTIRE report state (base rows +
        derived counts). Two stores with equal digests hold
        bit-identical reports."""
        with self._lock:
            return self._digest_locked()

    def _digest_locked(self) -> str:
        body = {"rows": self._rows, "ns": self._ns_counts,
                "policy": self._policy_counts, "totals": self._totals}
        return hashlib.sha256(jn.canonical(body).encode("utf-8")).hexdigest()

    def verify_rebuild(self) -> bool:
        """Delta-state == rebuild() bit-identity check. On mismatch the
        rebuilt (correct) derived state replaces the drifted one."""
        with self._lock:
            before = self._digest_locked()
            self._rebuild_derived_locked()
            self.stats["verify_checks"] += 1
            return before == self._digest_locked()

    # -- journal + snapshot

    def _journal_locked(self, doc: Dict[str, Any]) -> None:
        self._seq += 1
        doc["seq"] = self._seq
        if not self.directory:
            return
        health = st.storage_health(st.SURFACE_REPORTS)
        if not health.allow():
            # degraded storage, no re-probe due: memory-only folding.
            # The fold stays bit-identical; only durability is lost,
            # and the loss is counted like any other failed append.
            self.metrics.reports_recoveries.inc(
                {"reason": jn.REASON_APPEND_ERROR})
            return
        was_degraded = health.degraded
        jpath = os.path.join(self.directory, jn.JOURNAL_NAME)
        try:
            if self._journal_fh is None:
                # a boot-time or mid-run open failure left us without a
                # WAL: each granted probe retries the open itself
                self._journal_fh = st.open_append(jpath, st.SURFACE_REPORTS,
                                                  binary=True)
                self._journal_bytes = self._journal_fh.tell()
            global_faults.fire(SITE_REPORTS_JOURNAL,
                               payload=str(doc.get("uid", "")))
            text = jn.canonical(doc)
            payload = text.encode("utf-8")
            # corrupt-fault hook: the length/CRC header still describes
            # the TRUE payload, so a mangled wire record is exactly the
            # torn/bit-flipped write the replay ladder must truncate at
            wire_text = global_faults.corrupt(SITE_REPORTS_JOURNAL, text)
            wire = payload if wire_text is text \
                else str(wire_text or "").encode("utf-8")
            rec = jn.frame(payload, wire=wire)
            st.write_frame(self._journal_fh, rec, st.SURFACE_REPORTS,
                           path=jpath, flush=True)
            self._journal_bytes += len(rec)
            self.metrics.reports_journal_records.inc()
            self.metrics.reports_journal_bytes.set(float(self._journal_bytes))
        except Exception:
            # a failed append must not take report maintenance down:
            # the delta still folds in memory and the LOSS is counted —
            # after a restart the state is older, never wrong. (An
            # OSError also degraded the reports surface via the shim.)
            self.metrics.reports_recoveries.inc(
                {"reason": jn.REASON_APPEND_ERROR})
            return
        if was_degraded and not health.degraded:
            # the probe append landed: the surface just healed. The
            # on-disk journal has a hole (drops while degraded), so
            # durability is re-established by an immediate compaction.
            # Deferred to after the caller's fold: compacting HERE
            # would snapshot state without this very delta and then
            # truncate its journal record — losing the healing row.
            self._heal_compact = True

    def _maybe_compact_locked(self) -> None:
        if self._heal_compact:
            # full in-memory state (healing delta now folded) to
            # snapshot, journal truncated: durability re-established
            self._heal_compact = False
            self._compact_locked()
            return
        if self._journal_fh is not None \
                and self._journal_bytes > self.journal_max_bytes \
                and not st.storage_health(st.SURFACE_REPORTS).degraded:
            # while degraded, compaction would just hammer the sick
            # disk — the journal-append probes own the heal path, and
            # healing compacts immediately anyway
            self._compact_locked()

    def _compact_locked(self) -> None:
        if self._journal_fh is None or not self.directory:
            return
        rows = [[uid, rec[0], rec[1], rec[2], rec[3], rec[4], rec[5]]
                for uid, rec in sorted(self._rows.items())]
        try:
            jn.write_snapshot(os.path.join(self.directory, jn.SNAPSHOT_NAME),
                              self._seq, rows)
        except OSError:
            return  # disk trouble: keep journaling, retry next tick
        # snapshot is durable first, THEN the journal resets — a crash
        # between the two leaves duplicate-seq records the replay skips
        self._journal_fh.seek(0)
        self._journal_fh.truncate()
        self._journal_bytes = 0
        self.stats["compactions"] += 1
        self.metrics.reports_snapshots.inc()
        self.metrics.reports_journal_bytes.set(0.0)

    def _load_locked(self) -> None:
        snap_path = os.path.join(self.directory, jn.SNAPSHOT_NAME)
        jpath = os.path.join(self.directory, jn.JOURNAL_NAME)
        if os.path.exists(snap_path):
            loaded = jn.load_snapshot(snap_path)
            if loaded is None:
                # validate-or-rebuild-cold: a bad snapshot discards
                # BOTH files (journal deltas without their base are not
                # a report) and starts empty — degraded, never wrong;
                # the next scan tick repopulates from live verdicts
                self.metrics.reports_recoveries.inc(
                    {"reason": jn.REASON_SNAPSHOT})
                for stale in (snap_path, jpath):
                    try:
                        os.remove(stale)
                    except OSError:
                        pass
            else:
                self._seq, rows = loaded
                for row in rows:
                    try:
                        uid, sha, ps, ns, kind, name, rws = row
                        self._rows[str(uid)] = (
                            str(sha), str(ps), str(ns), str(kind), str(name),
                            [[str(c) for c in r] for r in rws])
                    except (TypeError, ValueError):
                        continue
        data = b""
        if os.path.exists(jpath):
            try:
                with open(jpath, "rb") as f:
                    data = f.read()
            except OSError:
                data = b""
        docs, good, reason = jn.scan_records(data)
        if reason is not None:
            self.metrics.reports_recoveries.inc({"reason": reason})
            try:
                with open(jpath, "r+b") as f:
                    f.truncate(good)
            except OSError:
                pass
            data = data[:good]
        last = self._seq
        replayed = 0
        for doc in docs:
            seq = doc.get("seq")
            if not isinstance(seq, int) or seq <= last:
                self.metrics.reports_recoveries.inc(
                    {"reason": jn.REASON_DUPLICATE})
                continue
            last = seq
            if self._replay_doc_locked(doc):
                replayed += 1
        self._seq = last
        self._rebuild_derived_locked()
        if replayed:
            # journal records at boot = the previous process died
            # without a clean close: the recovery itself is counted
            self.metrics.reports_recoveries.inc({"reason": jn.REASON_REPLAY})
            self.stats["recovered_records"] += replayed
        try:
            self._journal_fh = st.open_append(jpath, st.SURFACE_REPORTS,
                                              binary=True)
        except OSError:
            self._journal_fh = None  # degraded: appends probe the re-open
        self._journal_bytes = len(data)
        self.metrics.reports_journal_bytes.set(float(self._journal_bytes))
        self.metrics.reports_resources.set(float(len(self._rows)))

    def _replay_doc_locked(self, doc: Dict[str, Any]) -> bool:
        op, uid = doc.get("op"), doc.get("uid")
        if not isinstance(uid, str):
            self.metrics.reports_recoveries.inc({"reason": jn.REASON_DECODE})
            return False
        if op == "del":
            self._rows.pop(uid, None)
            return True
        if op != "put":
            self.metrics.reports_recoveries.inc({"reason": jn.REASON_DECODE})
            return False
        try:
            rows = [[str(c) for c in r] for r in doc.get("rows", [])]
            self._rows[uid] = (str(doc["sha"]), str(doc["ps"]),
                               str(doc.get("ns", "")),
                               str(doc.get("kind", "")),
                               str(doc.get("name", "")), rows)
            return True
        except (KeyError, TypeError, ValueError):
            self.metrics.reports_recoveries.inc({"reason": jn.REASON_DECODE})
            return False

    def sync(self) -> None:
        """Compact when the journal is over threshold — called once per
        scan tick, mirroring the columnar store's per-tick sync."""
        with self._lock:
            self._maybe_compact_locked()

    def close(self, compact: bool = True) -> None:
        """Clean shutdown: compact unconditionally (an empty journal at
        next boot means no replay recovery to count) and close the WAL.
        ``compact=False`` is the read-only close (`kyverno-tpu report`):
        the directory is left exactly as recovered."""
        with self._lock:
            if self._journal_fh is not None:
                if compact:
                    self._compact_locked()
                try:
                    self._journal_fh.close()
                except OSError:
                    pass
                self._journal_fh = None

    # -- readers

    def aggregate(self) -> Dict[str, PolicyReport]:
        """Reconstruct wgpolicyk8s.io/v1alpha2-shaped reports from base
        rows — the same shape as ReportAggregator.aggregate(), so
        ``/reports`` can serve either source interchangeably."""
        with self._lock:
            recs = sorted(self._rows.items())
        reports: Dict[str, PolicyReport] = {}
        for uid, (sha, _ps, ns, kind, name, rows) in recs:
            for policy, rule, result in rows:
                reports.setdefault(ns, PolicyReport(ns)).results.append(
                    ReportResult(policy=policy, rule=rule, result=result,
                                 resource_uid=uid, resource_kind=kind,
                                 resource_name=name, resource_namespace=ns))
        return reports

    def summary(self) -> Dict[str, int]:
        with self._lock:
            out = {k: 0 for k in RESULT_NAMES}
            for result, n in self._totals.items():
                if result in out:
                    out[result] = n
            return out

    def namespaces(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {ns: dict(counts)
                    for ns, counts in sorted(self._ns_counts.items())}

    def policies(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {policy: dict(counts)
                    for policy, counts in sorted(self._policy_counts.items())}

    def state(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": True,
                "directory": self.directory,
                "persistent": self._journal_fh is not None,
                "resources": len(self._rows),
                "namespaces": len(self._ns_counts),
                "seq": self._seq,
                "journal_bytes": self._journal_bytes,
                "journal_max_bytes": self.journal_max_bytes,
                "totals": dict(self._totals),
                **self.stats,
            }


def _bump(table: Dict[str, Dict[str, int]], key: str, result: str,
          delta: int) -> None:
    """Count-table bump that prunes zeros: fold/unfold sequences leave
    the table bit-identical to one built fresh (no zero-count ghosts)."""
    cell = table.setdefault(key, {})
    v = cell.get(result, 0) + delta
    if v:
        cell[result] = v
    else:
        cell.pop(result, None)
    if not cell:
        table.pop(key, None)


# -- process-global store (mirrors cluster/columnar.py's singleton)

_store: Optional[ReportStore] = None
_store_lock = threading.Lock()


def configure_reports(directory: Optional[str] = None, enabled: bool = True,
                      journal_max_bytes: Optional[int] = None
                      ) -> Optional[ReportStore]:
    """(Re)build the process-global report store. ``directory=None``
    falls back to ``KYVERNO_TPU_REPORTS_DIR`` (else in-memory);
    ``journal_max_bytes`` falls back to
    ``KYVERNO_TPU_REPORTS_JOURNAL_MAX`` (else 4 MiB)."""
    global _store
    directory = directory or os.environ.get("KYVERNO_TPU_REPORTS_DIR") or None
    if journal_max_bytes is None:
        try:
            journal_max_bytes = int(
                os.environ.get("KYVERNO_TPU_REPORTS_JOURNAL_MAX", ""))
        except ValueError:
            journal_max_bytes = None
    with _store_lock:
        if _store is not None:
            try:
                _store.close()
            except Exception:
                pass
        if not enabled:
            _store = None
            return None
        if directory:
            try:
                os.makedirs(directory, exist_ok=True)
            except OSError:
                pass  # ReportStore.__init__ routes this through the ladder
        kw: Dict[str, Any] = {}
        if journal_max_bytes is not None:
            kw["journal_max_bytes"] = journal_max_bytes
        _store = ReportStore(directory=directory, **kw)
        return _store


def get_report_store() -> Optional[ReportStore]:
    with _store_lock:
        return _store


def reset_reports() -> None:
    global _store
    with _store_lock:
        if _store is not None:
            try:
                _store.close()
            except Exception:
                pass
        _store = None


def reports_state() -> Dict[str, Any]:
    with _store_lock:
        if _store is None:
            return {"enabled": False}
        store = _store
    return store.state()
