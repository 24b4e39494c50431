# Copied verbatim from kyverno_tpu/fleet/peering.py.
"""Verdict-cache peering — fetch-on-miss and async push, made safe by
content addressing.

A verdict-cache key (tpu/cache.py) is (policy-set content key,
resource content hash, request digest): a peer running an older or
newer policy revision holds entries under a DIFFERENT content key, so
a skewed peer can never satisfy a lookup — key mismatch is a miss by
construction, there is no invalidation protocol to get wrong. What
content addressing cannot rule out is a corrupted wire payload or a
lying peer, so every received column is re-verified on receipt:

- the echoed key must equal the requested key (a response for any
  other key is rejected, reason=key_mismatch);
- the column checksum (sha256 over key + raw bytes) must verify
  (truncated/bit-flipped payloads reject, reason=checksum);
- the column length must match the requester's compiled rule count
  (reason=shape) and decode cleanly (reason=decode).

A rejected entry counts on kyverno_fleet_peer_rejects_total and is
treated as a MISS — the ladder falls through to local compute, never
to a wrong verdict. Every remote call runs through a per-peer circuit
breaker and inside a deadline budget with jittered retry
(resilience/), so a dead peer costs one bounded timeout and then
nothing at all until its breaker half-opens.
"""

from __future__ import annotations

import base64
import hashlib
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..resilience.breaker import CircuitBreaker
from ..resilience.faults import global_faults
from ..resilience.retry import Deadline, RetryPolicy, retry_call

CacheKey = Tuple[str, str, str]


def column_checksum(key: CacheKey, raw: bytes) -> str:
    """Checksum binding a column's bytes to its content-addressed key
    — shared by sender and receiver, so a payload that was truncated,
    spliced, or re-keyed in flight cannot verify."""
    h = hashlib.sha256()
    for part in key:
        h.update(part.encode("utf-8", "surrogatepass"))
        h.update(b"\x00")
    h.update(raw)
    return h.hexdigest()[:16]


def encode_entry(key: CacheKey, column: np.ndarray) -> Dict[str, Any]:
    raw = np.ascontiguousarray(column, dtype=np.int32).tobytes()
    return {"k": list(key), "c": base64.b64encode(raw).decode("ascii"),
            "n": int(column.shape[0]), "sha": column_checksum(key, raw)}


def decode_entry(doc: Dict[str, Any], want_key: Optional[CacheKey] = None,
                 expect_rows: Optional[int] = None,
                 ) -> Tuple[Optional[CacheKey], Optional[np.ndarray], str]:
    """Verify + decode one wire entry. Returns (key, column, reason)
    — column None and a reject reason when verification fails."""
    try:
        key = tuple(doc["k"])
        if len(key) != 3 or not all(isinstance(p, str) for p in key):
            return None, None, "decode"
        raw = base64.b64decode(doc["c"], validate=True)
        n = int(doc["n"])
        sha = doc["sha"]
    except (KeyError, TypeError, ValueError):
        return None, None, "decode"
    if want_key is not None and key != tuple(want_key):
        return key, None, "key_mismatch"
    if column_checksum(key, raw) != sha:
        return key, None, "checksum"
    if len(raw) != n * 4 or (expect_rows is not None and n != expect_rows):
        return key, None, "shape"
    col = np.frombuffer(raw, dtype=np.int32).copy()
    return key, col, ""


def _http_post_json(url: str, path: str, doc: Dict[str, Any],
                    timeout_s: float) -> Dict[str, Any]:
    """One JSON POST to a peer base url (http://127.0.0.1:PORT)."""
    import http.client
    from urllib.parse import urlparse

    parsed = urlparse(url)
    conn = http.client.HTTPConnection(parsed.hostname,
                                      parsed.port or 80,
                                      timeout=max(timeout_s, 0.05))
    try:
        conn.request("POST", path, json.dumps(doc),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise ConnectionError(f"peer {path} -> {resp.status}")
        return json.loads(body)
    finally:
        conn.close()


class PeerLink:
    """One peer: its URL, breaker, and call plumbing. The breaker is
    the degradation valve — once a peer has failed ``failure_threshold``
    consecutive calls every further interaction skips it instantly
    until the reset timeout half-opens one probe."""

    def __init__(self, replica_id: str, url: str,
                 failure_threshold: int = 2, reset_timeout_s: float = 5.0):
        self.replica_id = replica_id
        self.url = url
        self.breaker = CircuitBreaker(
            name=f"fleet:{replica_id}",
            failure_threshold=failure_threshold,
            reset_timeout_s=reset_timeout_s)

    # a call that SUCCEEDS but eats this fraction of its budget counts
    # as a breaker failure anyway: a slow-but-responsive peer (GC
    # pressure, CPU contention) must demote to local compute exactly
    # like a dead one, or every admission miss pays its latency —
    # the result is still used, only the peer's standing suffers
    SLOW_FRACTION = 0.8

    def call(self, path: str, doc: Dict[str, Any], budget_s: float,
             site: str, payload: Any = None,
             use_breaker: bool = True) -> Optional[Dict[str, Any]]:
        """POST under the breaker + one jittered retry inside the
        budget. None when the breaker is open or the call failed —
        callers degrade, they never raise to the serving path.

        ``use_breaker=False`` is the CONTROL-PLANE mode (heartbeats):
        already rate-limited by the heartbeat interval and bounded by
        the budget, they neither consult nor feed the breaker — a
        cheap succeeding heartbeat must not reset the consecutive-
        failure count of a broken data plane, and an open breaker
        must not mute heartbeats into a false failover."""
        if use_breaker and not self.breaker.allow():
            return None
        # trace propagation: if this call happens inside a span (an
        # admission-path peer fetch under admission.submit, a traced
        # heartbeat), ship the SpanContext in the envelope so the
        # receiver's handler joins OUR trace — one connected trace
        # across replicas. No active span, no envelope.
        try:
            from ..observability.tracing import (context_to_wire,
                                                 global_tracer)

            wire = context_to_wire(global_tracer.current_context())
            if wire is not None:
                doc = dict(doc)
                doc["trace"] = wire
        except Exception:
            pass
        deadline = Deadline(budget_s)
        t0 = time.monotonic()
        try:
            global_faults.fire(site, payload)
            out = retry_call(
                lambda: _http_post_json(self.url, path, doc,
                                        min(budget_s,
                                            deadline.remaining())),
                policy=RetryPolicy(max_attempts=2, base_delay_s=0.01,
                                   max_delay_s=0.05,
                                   deadline_s=budget_s),
                deadline=deadline, site=site)
            if use_breaker:
                if time.monotonic() - t0 > budget_s * self.SLOW_FRACTION:
                    self.breaker.record_failure()
                else:
                    self.breaker.record_success()
            return out
        except Exception:
            if use_breaker:
                self.breaker.record_failure()
            return None


class PushQueue:
    """Bounded queue of freshly computed (key, column) pairs awaiting
    async push to peers. Overflow drops the OLDEST entry (newest
    columns are the hottest) and counts the drop — backpressure must
    never reach the verdict-cache put path."""

    def __init__(self, maxlen: int = 4096, metrics=None):
        self._lock = threading.Lock()
        self._q: deque = deque(maxlen=maxlen)  # guarded-by: _lock
        self._metrics = metrics

    def _registry(self):
        if self._metrics is None:
            from ..observability.metrics import global_registry

            self._metrics = global_registry
        return self._metrics

    def offer(self, key: CacheKey, column: np.ndarray) -> None:
        with self._lock:
            dropped = len(self._q) == self._q.maxlen
            self._q.append((key, np.array(column, dtype=np.int32,
                                          copy=True)))
        if dropped:
            self._registry().fleet_gossip.inc({"outcome": "dropped"})

    def drain(self, max_batch: int = 256
              ) -> List[Tuple[CacheKey, np.ndarray]]:
        out: List[Tuple[CacheKey, np.ndarray]] = []
        with self._lock:
            while self._q and len(out) < max_batch:
                out.append(self._q.popleft())
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


class PeerCacheClient:
    """Fetch-on-miss + push across a set of PeerLinks. Links are
    created lazily per live peer and remembered (breaker state must
    survive membership flaps, or a flapping peer resets its own
    penalty)."""

    def __init__(self, metrics=None, fetch_budget_s: float = 0.15,
                 scan_fetch_budget_s: float = 1.0):
        self.fetch_budget_s = fetch_budget_s
        self.scan_fetch_budget_s = scan_fetch_budget_s
        self._lock = threading.Lock()
        self._links: Dict[str, PeerLink] = {}  # guarded-by: _lock
        self._metrics = metrics

    def _registry(self):
        if self._metrics is None:
            from ..observability.metrics import global_registry

            self._metrics = global_registry
        return self._metrics

    def link(self, replica_id: str, url: str) -> PeerLink:
        with self._lock:
            lk = self._links.get(replica_id)
            if lk is None or lk.url != url:
                lk = PeerLink(replica_id, url)
                self._links[replica_id] = lk
            return lk

    def rekey(self, old_key: str, replica_id: str, url: str) -> PeerLink:
        """Discovery resolved a URL-keyed link to its real replica id:
        drop the provisional entry so breaker_states() (and the
        breaker-state metric family) never carry a stale duplicate."""
        with self._lock:
            self._links.pop(old_key, None)
        return self.link(replica_id, url)

    def links_for(self, peers: Sequence[Tuple[str, str]]) -> List[PeerLink]:
        return [self.link(rid, url) for rid, url in peers]

    # -- fetch

    def fetch(self, peers: Sequence[Tuple[str, str]],
              keys: Sequence[CacheKey], expect_rows: int,
              budget_s: Optional[float] = None,
              ) -> Dict[CacheKey, np.ndarray]:
        """Batch fetch: ask each live peer for the still-missing keys
        until everything resolved or the budget is gone. Rejected
        entries count and stay missing."""
        m = self._registry()
        budget = self.scan_fetch_budget_s if budget_s is None else budget_s
        deadline = Deadline(budget)
        found: Dict[CacheKey, np.ndarray] = {}
        missing = [tuple(k) for k in keys]
        for lk in self.links_for(peers):
            if not missing or deadline.expired():
                break
            resp = lk.call(
                "/fleet/fetch", {"keys": [list(k) for k in missing]},
                min(budget, deadline.remaining()),
                site="fleet.peer_fetch", payload=lk.replica_id)
            if resp is None:
                m.fleet_peer_fetch.inc({"peer": lk.replica_id,
                                        "outcome": "error"},
                                       value=len(missing))
                continue
            got: Dict[CacheKey, np.ndarray] = {}
            missing_set = set(missing)
            for doc in resp.get("entries", ()):
                key, col, reason = decode_entry(doc,
                                               expect_rows=expect_rows)
                if col is None:
                    m.fleet_peer_rejects.inc({"reason": reason or "decode"})
                    m.fleet_peer_fetch.inc({"peer": lk.replica_id,
                                            "outcome": "rejected"})
                    continue
                if key not in missing_set:
                    # an answer we never asked for is a lying peer
                    m.fleet_peer_rejects.inc({"reason": "key_mismatch"})
                    m.fleet_peer_fetch.inc({"peer": lk.replica_id,
                                            "outcome": "rejected"})
                    continue
                got[key] = col
            if got:
                m.fleet_peer_fetch.inc({"peer": lk.replica_id,
                                        "outcome": "hit"}, value=len(got))
            misses = len(missing) - len(got)
            if misses:
                m.fleet_peer_fetch.inc({"peer": lk.replica_id,
                                        "outcome": "miss"}, value=misses)
            found.update(got)
            missing = [k for k in missing if k not in found]
        return found

    def fetch_one(self, peers: Sequence[Tuple[str, str]], key: CacheKey,
                  expect_rows: int) -> Optional[np.ndarray]:
        """Single-key fetch for the admission submit path — the tight
        budget (one bounded peer timeout) is the p99 envelope
        guarantee when every peer is down."""
        got = self.fetch(peers, [key], expect_rows,
                         budget_s=self.fetch_budget_s)
        return got.get(tuple(key))

    # -- push

    def push(self, peers: Sequence[Tuple[str, str]],
             entries: Sequence[Tuple[CacheKey, np.ndarray]]) -> int:
        """Fire one /fleet/push of ``entries`` at every live peer.
        Returns the number of peer sends that succeeded."""
        if not entries:
            return 0
        m = self._registry()
        doc = {"entries": [encode_entry(k, c) for k, c in entries]}
        sent = 0
        for lk in self.links_for(peers):
            resp = lk.call("/fleet/push", doc, self.scan_fetch_budget_s,
                           site="fleet.gossip", payload=lk.replica_id)
            if resp is None:
                m.fleet_gossip.inc({"outcome": "error"})
            else:
                sent += 1
                m.fleet_gossip.inc({"outcome": "sent"},
                                   value=len(entries))
        return sent

    def breaker_states(self) -> Dict[str, str]:
        with self._lock:
            links = list(self._links.values())
        return {lk.replica_id: lk.breaker.state for lk in links}
