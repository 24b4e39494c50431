# Copied verbatim from kyverno_tpu/fleet/membership.py.
"""Lease-based fleet membership — liveness as a lease ledger.

Extends cluster/leaderelection.py: the same ``LeaseStore`` TTL
semantics that elect singleton controllers also decide which replicas
are alive. Every replica renews its OWN lease locally on each
heartbeat tick and renews a PEER's lease whenever that peer's
heartbeat arrives over the peer protocol; a replica that stops
heartbeating (SIGKILL, hang, partition) simply stops renewing and
falls out of ``live()`` when its lease duration elapses — crash
detection without a failure detector beyond the lease clock.

Leadership is derived, not elected: the lexicographically smallest
live replica id is the leader (every replica computes the same answer
from its own ledger), and the leader stamps the rebalance epoch the
shard map is versioned by. A dead leader loses its lease like any
other replica and leadership moves with no extra protocol.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..cluster.leaderelection import LeaseStore

_LEASE_PREFIX = "fleet/replica/"


class FleetMembership:
    """One replica's view of the fleet, backed by a LeaseStore."""

    def __init__(self, replica_id: str, url: str = "",
                 lease_s: float = 3.0, store: Optional[LeaseStore] = None,
                 clock=time.monotonic):
        self.replica_id = replica_id
        self.url = url
        self.lease_s = float(lease_s)
        self._clock = clock
        self.store = store if store is not None else LeaseStore(clock=clock)
        self._lock = threading.Lock()
        self._urls: Dict[str, str] = {replica_id: url}  # guarded-by: _lock
        self._epoch = 0                                 # guarded-by: _lock
        self._live_view: Tuple[str, ...] = ()           # guarded-by: _lock
        # per-replica wall-clock freshness stamps for the shards each
        # peer reported owning+scanning (heartbeat payload); survivors
        # seed takeover freshness from the dead owner's last report
        self._shard_fresh: Dict[int, float] = {}        # guarded-by: _lock

    # -- lease plumbing

    def renew_self(self) -> None:
        self.store.try_acquire_or_renew(
            _LEASE_PREFIX + self.replica_id, self.replica_id, self.lease_s)

    def observe_heartbeat(self, replica_id: str, url: str = "",
                          lease_s: Optional[float] = None,
                          shard_fresh: Optional[Dict[str, float]] = None,
                          ) -> None:
        """A peer's heartbeat arrived: renew its lease in OUR ledger.
        Only direct heartbeats renew — a third party's stale view of a
        dead replica must never keep its lease alive here."""
        if not replica_id or replica_id == self.replica_id:
            return
        self.store.try_acquire_or_renew(
            _LEASE_PREFIX + replica_id, replica_id,
            float(lease_s) if lease_s else self.lease_s)
        with self._lock:
            if url:
                self._urls[replica_id] = url
            if shard_fresh:
                for shard, ts in shard_fresh.items():
                    try:
                        s, t = int(shard), float(ts)
                    except (TypeError, ValueError):
                        continue
                    if t > self._shard_fresh.get(s, 0.0):
                        self._shard_fresh[s] = t

    def forget(self, replica_id: str) -> None:
        """Graceful leave: release the peer's lease immediately instead
        of waiting out the TTL."""
        self.store.release(_LEASE_PREFIX + replica_id, replica_id)

    # -- views

    def live(self) -> List[str]:
        """Replica ids with a fresh lease, self included, sorted —
        the deterministic input every replica feeds rendezvous."""
        with self._lock:
            known = list(self._urls)
        alive = [rid for rid in known
                 if self.store.holder(_LEASE_PREFIX + rid) == rid]
        return sorted(alive)

    def leader(self) -> Optional[str]:
        alive = self.live()
        return alive[0] if alive else None

    def is_leader(self) -> bool:
        return self.leader() == self.replica_id

    def url_of(self, replica_id: str) -> Optional[str]:
        with self._lock:
            return self._urls.get(replica_id)

    def learn_url(self, replica_id: str, url: str) -> None:
        """Discovery WITHOUT liveness: remember where a replica can be
        reached (third-party views may teach us URLs, never leases)."""
        if not replica_id or not url or replica_id == self.replica_id:
            return
        with self._lock:
            self._urls.setdefault(replica_id, url)

    def known_urls(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._urls)

    def peers(self) -> List[Tuple[str, str]]:
        """Live (replica_id, url) pairs excluding self."""
        urls = {}
        with self._lock:
            urls = dict(self._urls)
        return [(rid, urls.get(rid, "")) for rid in self.live()
                if rid != self.replica_id and urls.get(rid)]

    def gossiped_freshness(self, shard: int) -> Optional[float]:
        """Last wall-clock scan stamp any peer reported for ``shard``
        — the takeover seed (the new owner is at LEAST this stale)."""
        with self._lock:
            return self._shard_fresh.get(shard)

    def note_epoch_if_changed(self) -> Tuple[bool, int, Tuple[str, ...]]:
        """Compare the current live set against the last observed one;
        bump the epoch on change. Returns (changed, epoch, live)."""
        alive = tuple(self.live())
        with self._lock:
            changed = alive != self._live_view
            if changed:
                self._live_view = alive
                self._epoch += 1
            return changed, self._epoch, alive

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def state(self) -> Dict[str, Any]:
        alive = self.live()
        with self._lock:
            urls = dict(self._urls)
            epoch = self._epoch
        return {
            "replica_id": self.replica_id,
            "url": self.url,
            "lease_s": self.lease_s,
            "epoch": epoch,
            "leader": alive[0] if alive else None,
            "is_leader": bool(alive) and alive[0] == self.replica_id,
            "live": alive,
            "known": sorted(urls),
        }
