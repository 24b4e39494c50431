# Copied verbatim from kyverno_tpu/fleet/manager.py.
"""FleetManager — membership, shard ownership, and cache peering as
one lifecycle the control plane starts and stops.

The manager runs two daemon threads next to the peer server:

- the **heartbeat loop** renews this replica's own lease, heartbeats
  every known peer (per-peer breaker, ``fleet.heartbeat`` fault
  site), merges discovered peer URLs, and recomputes the rendezvous
  shard map whenever the live set changes — a takeover marks the
  gained shards for forced rescan and seeds their freshness from the
  dead owner's last gossiped stamp, so the scan-freshness SLO tells
  the truth about data that went stale with its owner;
- the **gossip loop** drains the push queue of freshly computed
  verdict columns and fans them to live peers (``fleet.gossip``
  site) so one replica's scan warms the whole fleet.

Everything here degrades, nothing here blocks serving: the scanner
and webhooks consult the manager through lock-free-per-tick snapshot
views, remote calls happen on the fleet threads or inside explicit
deadline budgets, and a fleet with zero live peers behaves exactly
like the single-replica engine.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

from .membership import FleetMembership
from .peering import CacheKey, PeerCacheClient, PushQueue
from .shards import DEFAULT_NUM_SHARDS, owned_shards, shard_of
from .telemetry import (TELEMETRY_SCHEMA_VERSION, TelemetryAggregator,
                        TelemetrySource)


@dataclass(frozen=True)
class FleetConfig:
    replica_id: str
    listen_port: int = 0
    peers: Tuple[str, ...] = ()       # static peer base URLs
    lease_s: float = 3.0
    heartbeat_interval_s: Optional[float] = None   # default lease_s / 4
    num_shards: int = DEFAULT_NUM_SHARDS
    fetch_budget_s: float = 0.15      # admission-path single-key fetch
    scan_fetch_budget_s: float = 1.0  # scan-path batch fetch
    push_interval_s: float = 0.2
    push_max_batch: int = 256
    fetch_max_keys: int = 1024
    # a telemetry snapshot older than this is history, not state — the
    # aggregator's staleness rung drops it (0 disables the age check)
    telemetry_max_age_s: float = 30.0

    @property
    def heartbeat_s(self) -> float:
        hb = self.heartbeat_interval_s
        return hb if hb else max(self.lease_s / 4.0, 0.05)


class FleetManager:
    def __init__(self, config: FleetConfig, cache=None, metrics=None,
                 clock=time.monotonic):
        from .server import FleetPeerServer

        if config.num_shards <= 0:
            # zero shards = every replica owns nothing = the scanner
            # silently skips everything while freshness stays green —
            # a misconfiguration, never a mode
            raise ValueError(
                f"fleet num_shards must be positive, got "
                f"{config.num_shards}")
        self.config = config
        self._clock = clock
        self._metrics = metrics
        if cache is None:
            from ..tpu.cache import global_verdict_cache

            cache = global_verdict_cache
        self.cache = cache
        self.server = FleetPeerServer(self, port=config.listen_port)
        self.url = f"http://127.0.0.1:{self.server.port}"
        self.membership = FleetMembership(
            config.replica_id, url=self.url, lease_s=config.lease_s,
            clock=clock)
        self.client = PeerCacheClient(
            metrics=metrics, fetch_budget_s=config.fetch_budget_s,
            scan_fetch_budget_s=config.scan_fetch_budget_s)
        self._push_q = PushQueue(metrics=metrics)
        # optional provider of the active compiled set's rule count —
        # the push-receive shape check (ControlPlane wires it)
        self.rows_provider: Optional[Callable[[], Optional[int]]] = None
        self._lock = threading.Lock()
        self._owned: FrozenSet[int] = frozenset()       # guarded-by: _lock
        self._pending_takeover: Set[int] = set()        # guarded-by: _lock
        # wall-clock stamp of the last scan tick covering each owned
        # shard (wall, not monotonic: stamps cross process boundaries
        # in heartbeats)
        self._shard_fresh: Dict[int, float] = {}        # guarded-by: _lock
        self._started = False
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._gossip_thread: Optional[threading.Thread] = None
        # peers added after construction (tests wire ephemeral ports;
        # production uses config.peers + heartbeat discovery)
        self._extra_peers: Set[str] = set()             # guarded-by: _lock
        # telemetry plane: every replica SERVES snapshots; only the
        # leader PULLS and folds them, then gossips the rollup back so
        # any replica can answer /debug/fleet with the fleet view
        self.telemetry = TelemetrySource(self)
        self.aggregator = TelemetryAggregator(
            metrics=metrics, clock=clock,
            max_age_s=config.telemetry_max_age_s)
        self._rollup: Optional[Dict[str, Any]] = None   # guarded-by: _lock

    def _registry(self):
        if self._metrics is None:
            from ..observability.metrics import global_registry

            self._metrics = global_registry
        return self._metrics

    # -- lifecycle

    @property
    def active(self) -> bool:
        return self._started and not self._stop.is_set()

    def start(self) -> "FleetManager":
        self.server.start()
        self.membership.renew_self()
        self._recompute_shards(reason="initial")
        # local puts of freshly computed columns fan out to peers
        # asynchronously; receive-side stores use cache_store (no
        # re-push, so a column cannot ping-pong across the fleet)
        try:
            self.cache.on_put = self._on_local_put
        except Exception:
            pass
        self._stop.clear()
        self._started = True
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True, name="fleet-heartbeat")
        self._hb_thread.start()
        self._gossip_thread = threading.Thread(
            target=self._gossip_loop, daemon=True, name="fleet-gossip")
        self._gossip_thread.start()
        return self

    def stop(self, leave: bool = True) -> None:
        self._stop.set()
        if getattr(self.cache, "on_put", None) is self._on_local_put:
            self.cache.on_put = None
        if leave and self._started:
            # graceful leave: tell peers now instead of making them
            # wait out the lease TTL (a SIGKILLed replica never gets
            # here — that IS the failover path)
            try:
                self._send_heartbeats(leaving=True)
            except Exception:
                pass
        for t in (self._hb_thread, self._gossip_thread):
            if t is not None:
                t.join(timeout=5)
        self.server.stop()
        self._started = False

    def kill(self) -> None:
        """Test hook: die like SIGKILL — stop renewing and answering
        with NO leave notification, so peers must detect the expired
        lease."""
        self._stop.set()
        if getattr(self.cache, "on_put", None) is self._on_local_put:
            self.cache.on_put = None
        for t in (self._hb_thread, self._gossip_thread):
            if t is not None:
                t.join(timeout=5)
        self.server.stop()

    # -- heartbeat / membership

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                pass  # the heartbeat loop must survive anything
            self._stop.wait(self.config.heartbeat_s)

    def tick(self) -> None:
        """One heartbeat round: renew self, heartbeat peers, absorb
        membership changes. Public so tests can drive time."""
        self.membership.renew_self()
        self._send_heartbeats()
        changed, _epoch, _live = self.membership.note_epoch_if_changed()
        if changed:
            self._recompute_shards(reason="membership")
        self._telemetry_round()
        self._publish_gauges()

    def add_peers(self, *urls: str) -> None:
        """Add peer base URLs after construction (ephemeral-port test
        wiring; equivalent to listing them in config.peers)."""
        with self._lock:
            self._extra_peers.update(u.rstrip("/") for u in urls if u)

    def _heartbeat_targets(self) -> List[Tuple[str, str]]:
        """Static config peers + everything discovered, keyed by URL —
        heartbeats go to configured peers even before we know their
        replica ids (that IS the discovery)."""
        targets: Dict[str, str] = {}
        with self._lock:
            extra = list(self._extra_peers)
        for url in list(self.config.peers) + extra:
            targets[url.rstrip("/")] = ""
        for rid, url in self.membership.peers():
            targets[url.rstrip("/")] = rid
        targets.pop(self.url, None)
        return [(rid, url) for url, rid in targets.items()]

    def _send_heartbeats(self, leaving: bool = False) -> None:
        m = self._registry()
        with self._lock:
            fresh = {str(s): t for s, t in self._shard_fresh.items()
                     if s in self._owned}
        doc = {
            "replica_id": self.config.replica_id,
            "url": self.url,
            "lease_s": self.config.lease_s,
            "epoch": self.membership.epoch,
            "shard_fresh": fresh,
        }
        if leaving:
            doc["leaving"] = True
        if self.membership.is_leader():
            # the leader piggybacks its fleet rollup on every heartbeat
            # it SENDS, so followers hold the fleet view without a
            # second RPC (and serve /debug/fleet themselves)
            rollup = self.rollup_view()
            if rollup is not None:
                doc = dict(doc)
                doc["rollup"] = rollup
        for rid, url in self._heartbeat_targets():
            link = self.client.link(rid or url, url)
            resp = link.call("/fleet/heartbeat", doc,
                             budget_s=max(self.config.heartbeat_s, 0.25),
                             site="fleet.heartbeat",
                             payload=rid or url,
                             # control plane: interval-limited and
                             # budget-bounded, never breaker-gated (a
                             # healthy heartbeat must not whitewash a
                             # broken data plane, and an open breaker
                             # must not fabricate a failover)
                             use_breaker=False)
            if resp is None:
                m.fleet_heartbeats.inc({"peer": rid or url,
                                        "outcome": "error"})
                continue
            m.fleet_heartbeats.inc({"peer": rid or url, "outcome": "ok"})
            # the response is the peer's own heartbeat back at us:
            # renew its lease and learn any members it knows
            peer_id = resp.get("replica_id", "")
            if peer_id:
                self.membership.observe_heartbeat(
                    peer_id, url=url, lease_s=resp.get("lease_s"))
                if (rid or url) != peer_id:
                    # re-key the breaker link under the real id (the
                    # provisional URL-keyed one is dropped)
                    self.client.rekey(rid or url, peer_id, url)
            for other, other_url in (resp.get("members") or {}).items():
                # discovery only — a third-party view never renews
                self.membership.learn_url(other, other_url)
            # the response may carry the leader's rollup back at us
            self._absorb_rollup(resp.get("rollup"))

    def on_heartbeat(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        """Server side of /fleet/heartbeat."""
        rid = doc.get("replica_id", "")
        if doc.get("leaving"):
            self.membership.forget(rid)
        else:
            self.membership.observe_heartbeat(
                rid, url=doc.get("url", ""), lease_s=doc.get("lease_s"),
                shard_fresh=doc.get("shard_fresh"))
        changed, _epoch, _live = self.membership.note_epoch_if_changed()
        if changed:
            self._recompute_shards(reason="membership")
        self._absorb_rollup(doc.get("rollup"))
        members = self.membership.known_urls()
        resp = {"replica_id": self.config.replica_id,
                "lease_s": self.config.lease_s,
                "epoch": self.membership.epoch,
                "members": members}
        if self.membership.is_leader():
            rollup = self.rollup_view()
            if rollup is not None:
                resp["rollup"] = rollup
        return resp

    # -- telemetry plane

    def _telemetry_round(self) -> None:
        """Leader-only fold on the heartbeat cadence: ingest our own
        snapshot, pull every live peer's ``/fleet/telemetry``, run each
        through the aggregator's trust ladder, then recompute and store
        the rollup (heartbeats gossip it back out). Followers do
        nothing here — they serve snapshots and absorb rollups."""
        if not self.membership.is_leader():
            return
        m = self._registry()
        agg = self.aggregator
        agg.ingest(self.telemetry.build())
        for rid, url in self.membership.peers():
            link = self.client.link(rid, url)
            resp = link.call("/fleet/telemetry", {},
                             budget_s=max(self.config.heartbeat_s, 0.25),
                             site="fleet.telemetry",
                             payload=rid,
                             # control plane, like heartbeats: interval-
                             # limited and budget-bounded, not breaker-
                             # gated
                             use_breaker=False)
            if resp is None:
                m.fleet_telemetry_pulls.inc({"peer": rid,
                                             "outcome": "error"})
                continue
            reason = agg.ingest(resp)
            m.fleet_telemetry_pulls.inc(
                {"peer": rid,
                 "outcome": "rejected" if reason else "ok"})
        live = set(self.membership.live()) | {self.config.replica_id}
        agg.prune(live)
        rollup = agg.rollup(self.config.replica_id, self.membership.epoch)
        with self._lock:
            self._rollup = rollup
        agg.publish_gauges()
        agg.publish_burn(rollup)

    def _absorb_rollup(self, rollup: Any) -> None:
        """Keep the newest rollup we have seen (by its wall stamp); a
        rollup from a different telemetry schema is ignored, never
        half-trusted."""
        if not isinstance(rollup, dict):
            return
        if rollup.get("schema_version") != TELEMETRY_SCHEMA_VERSION:
            return
        try:
            at = float(rollup.get("at", 0.0))
        except (TypeError, ValueError):
            return
        with self._lock:
            cur = self._rollup
            if cur is None or float(cur.get("at", 0.0)) <= at:
                self._rollup = rollup

    def rollup_view(self) -> Optional[Dict[str, Any]]:
        """The newest fleet rollup this replica holds — computed here
        if we lead, gossiped to us otherwise (None before the first
        fold reaches us)."""
        with self._lock:
            return self._rollup

    def slo_advisory(self) -> Dict[str, Any]:
        """The advisory fleet block /readyz attaches under its slo
        detail: fleet-aggregated divergence flips the degraded bit —
        advisory like the rest of the slo block, never a hard fail."""
        rollup = self.rollup_view()
        if rollup is None:
            return {"rollup": False, "degraded": False}
        return {
            "rollup": True,
            "degraded": bool(rollup.get("degraded")),
            "computed_by": rollup.get("computed_by"),
            "rollup_age_s": round(
                max(0.0, time.time() - float(rollup.get("at", 0.0))), 3),
            "divergence_total": (rollup.get("totals") or {}).get(
                "verification_divergences", 0.0),
            "burn": rollup.get("burn") or {},
        }

    # -- shard ownership

    def _recompute_shards(self, reason: str) -> None:
        live = self.membership.live() or [self.config.replica_id]
        mine = frozenset(owned_shards(self.config.replica_id, live,
                                      self.config.num_shards))
        now_wall = time.time()
        m = self._registry()
        with self._lock:
            gained = mine - self._owned
            self._owned = mine
            # a shard lost again before its takeover rescan ran is the
            # new owner's problem now — keep pending truthful
            self._pending_takeover &= set(mine)
            for shard in gained:
                self._pending_takeover.add(shard)
                if shard not in self._shard_fresh:
                    seed = self.membership.gossiped_freshness(shard)
                    if seed is None:
                        # no prior owner report: fresh at birth for the
                        # initial assignment, one lease TTL stale for a
                        # takeover (the data is at LEAST that old)
                        seed = (now_wall if reason == "initial"
                                else now_wall - self.config.lease_s)
                    self._shard_fresh[shard] = seed
            # shards we lost stop feeding our freshness view
            for shard in list(self._shard_fresh):
                if shard not in mine:
                    del self._shard_fresh[shard]
        if gained:
            m.fleet_shard_reassignments.inc(
                {"reason": reason}, value=len(gained))
            try:
                from ..observability.log import global_oplog

                global_oplog.emit(
                    "fleet_shards_reassigned", reason=reason,
                    gained=len(gained), owned=len(mine),
                    epoch=self.membership.epoch, live=live)
            except Exception:
                pass
        self._publish_gauges()

    def owned_view(self) -> FrozenSet[int]:
        """One consistent ownership snapshot per scan tick."""
        with self._lock:
            return self._owned

    def owns(self, uid: str) -> bool:
        return shard_of(uid, self.config.num_shards) in self.owned_view()

    def take_newly_owned(self) -> FrozenSet[int]:
        """Shards gained since the last call — the scanner force-
        rescans their resources (the dead owner's reports died with
        it; clean-skip bookkeeping must not hide that)."""
        with self._lock:
            pending = frozenset(self._pending_takeover)
            self._pending_takeover.clear()
        return pending

    def pending_takeover(self) -> FrozenSet[int]:
        """Non-destructive view of the takeover set: the scanner peeks
        at tick START and clears at tick COMPLETION (note_scan_tick),
        so a tick that dies mid-scan retries the takeover instead of
        silently losing it."""
        with self._lock:
            return frozenset(self._pending_takeover)

    def note_scan_tick(self, covered: FrozenSet[int],
                       taken: Optional[FrozenSet[int]] = None) -> float:
        """A scan tick covering ``covered`` completed: stamp them
        fresh and return the fleet-aware freshness LAG — seconds by
        which the OLDEST owned shard trails now (0 when everything
        owned was just covered). The scan service feeds this into the
        scan-freshness SLO so a takeover shows as staleness until the
        takeover rescan lands."""
        now_wall = time.time()
        with self._lock:
            for shard in covered:
                if shard in self._owned:
                    self._shard_fresh[shard] = now_wall
            if taken:
                # this completed tick honored the takeover rescan —
                # but ONLY for shards the tick actually covered: a
                # shard gained between the scanner's owned_view() and
                # pending_takeover() reads was skipped as unowned this
                # tick and must stay pending for the next one
                self._pending_takeover -= (set(taken) & set(covered))
            stamps = [self._shard_fresh.get(s, now_wall - self.config.lease_s)
                      for s in self._owned]
        lag = max(0.0, now_wall - min(stamps)) if stamps else 0.0
        self._registry().fleet_shard_staleness.set(round(lag, 3))
        return lag

    # -- cache peering

    def _on_local_put(self, key: CacheKey, column: np.ndarray) -> None:
        self._push_q.offer(key, column)

    def cache_peek(self, key: CacheKey) -> Optional[np.ndarray]:
        """Local-only lookup for the peer-fetch server path (peers
        probing us must not skew our own hit-rate accounting)."""
        peek = getattr(self.cache, "peek", None)
        return peek(key) if peek is not None else None

    def cache_store(self, key: CacheKey, column: np.ndarray) -> None:
        """Store a verified peer column WITHOUT re-fanout."""
        self.cache.put(key, column, fanout=False)

    def expected_rows(self) -> Optional[int]:
        if self.rows_provider is None:
            return None
        try:
            return self.rows_provider()
        except Exception:
            return None

    def fetch_missing(self, keys, expect_rows: int
                      ) -> Dict[CacheKey, np.ndarray]:
        """Scan-path batch fetch from live peers; verified hits land
        in the local cache (no re-fanout) and are returned."""
        peers = self.membership.peers()
        if not peers or not keys:
            return {}
        got = self.client.fetch(peers, keys, expect_rows)
        for key, col in got.items():
            self.cache_store(key, col)
        return got

    def fetch_one(self, key, expect_rows: int) -> Optional[np.ndarray]:
        """Admission-path single-key fetch under the tight budget."""
        peers = self.membership.peers()
        if not peers:
            return None
        col = self.client.fetch_one(peers, key, expect_rows)
        if col is not None:
            self.cache_store(tuple(key), col)
        return col

    # -- gossip

    def _gossip_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.gossip_once()
            except Exception:
                pass
            self._stop.wait(self.config.push_interval_s)

    def gossip_once(self) -> int:
        """Drain one push batch to live peers; returns entries sent.
        With no live peer the queue is left intact (the bounded deque
        drops-oldest under pressure) — columns computed before the
        first heartbeat exchange still warm peers that join late."""
        peers = self.membership.peers()
        if not peers:
            return 0
        entries = self._push_q.drain(self.config.push_max_batch)
        if not entries:
            return 0
        self.client.push(peers, entries)
        return len(entries)

    # -- introspection

    def _publish_gauges(self) -> None:
        m = self._registry()
        live = self.membership.live()
        m.fleet_replicas.set(len(live))
        m.fleet_is_leader.set(1 if self.membership.is_leader() else 0)
        m.fleet_epoch.set(self.membership.epoch)
        with self._lock:
            m.fleet_shards_owned.set(len(self._owned))

    def state(self) -> Dict[str, Any]:
        with self._lock:
            owned = sorted(self._owned)
            pending = sorted(self._pending_takeover)
            now_wall = time.time()
            fresh = {str(s): round(now_wall - t, 3)
                     for s, t in sorted(self._shard_fresh.items())}
            rollup = self._rollup
        return {
            "enabled": True,
            "schema_version": TELEMETRY_SCHEMA_VERSION,
            "membership": self.membership.state(),
            "shards": {
                "num_shards": self.config.num_shards,
                "owned": owned,
                "owned_count": len(owned),
                "pending_takeover": pending,
                "staleness_s": fresh,
            },
            "peering": {
                "breakers": self.client.breaker_states(),
                "push_queue_depth": len(self._push_q),
                "fetch_budget_s": self.config.fetch_budget_s,
                "scan_fetch_budget_s": self.config.scan_fetch_budget_s,
            },
            "telemetry": {
                "boot_id": self.telemetry.boot_id,
                "seq": self.telemetry.seq,
                "is_leader": self.membership.is_leader(),
                "max_age_s": self.config.telemetry_max_age_s,
                "rollup_age_s": (round(max(
                    0.0, time.time() - float(rollup.get("at", 0.0))), 3)
                    if rollup else None),
                "rollup": rollup,
            },
        }


# ---------------------------------------------------------------------------
# process-global fleet (like the caches: one replica per process)

_fleet_lock = threading.Lock()
_global_fleet: Optional[FleetManager] = None


def configure_fleet(config: Optional[FleetConfig] = None,
                    **kw) -> Optional[FleetManager]:
    """Install (and start) the process-wide FleetManager; None/empty
    config tears it down. Keyword form builds the config in place."""
    global _global_fleet
    if config is None and kw:
        config = FleetConfig(**kw)
    with _fleet_lock:
        old, _global_fleet = _global_fleet, None
    if old is not None:
        try:
            old.stop()
        except Exception:
            pass
    if config is None:
        return None
    mgr = FleetManager(config).start()
    with _fleet_lock:
        _global_fleet = mgr
    return mgr


def get_fleet() -> Optional[FleetManager]:
    with _fleet_lock:
        return _global_fleet


def reset_fleet() -> None:
    configure_fleet(None)


def current_replica_id() -> Optional[str]:
    """The replica id flight records and op-log events are tagged
    with (None outside a fleet)."""
    mgr = get_fleet()
    return mgr.config.replica_id if mgr is not None else None
