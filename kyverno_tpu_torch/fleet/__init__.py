# Copied verbatim from kyverno_tpu/fleet/__init__.py.
"""Fleet layer — multi-replica scan sharding, failover, and peered
verdict caches (ROADMAP item 1, the scale-out pillar).

One process is one failure domain. The fleet layer turns N replica
processes (``serve --fleet-listen/--fleet-peers/--replica-id``) into
one logical engine:

- **membership** (membership.py): lease-based liveness extending
  cluster/leaderelection.py — every replica heartbeats its peers over
  localhost HTTP; a replica whose lease expires (crash, hang,
  partition) drops out of the live set within the lease TTL. The
  lowest-id live replica is the leader and stamps the rebalance epoch.
- **shards** (shards.py): the resource keyspace is split into fixed
  shards; rendezvous hashing assigns each shard to exactly one live
  replica, so a membership change moves ONLY the dead replica's
  shards — the rest of the fleet keeps its warm state.
- **peering** (peering.py): verdict-cache fetch-on-miss plus async
  push of freshly computed columns between replicas. Content-addressed
  keys (tpu/cache.py) make peering safe by construction: a
  wrong-revision entry never matches the requested key, and every
  response is checksum- and key-re-verified on receipt — a poisoned
  or truncated peer answer is a MISS, never a wrong verdict.
- **manager** (manager.py): ties the above into one FleetManager the
  scanner, webhooks, and /debug/fleet consume.
- **telemetry** (telemetry.py): the fleet observability plane — every
  replica serves a checksummed telemetry snapshot on
  ``/fleet/telemetry``; the leader pulls on the heartbeat cadence,
  folds snapshots through a trust ladder (checksum -> schema ->
  replay/ordering -> staleness, rejects dropped-and-counted) into the
  monotonic ``kyverno_fleet_agg_*`` families and a fleet-wide SLO
  burn, and gossips the rollup back so any replica answers
  ``/debug/fleet``. Peer RPCs carry the caller's trace context, so a
  peer-served admission is ONE connected trace across replicas.

Degradation ladder: peer fetch -> local compute -> scalar oracle.
Every remote interaction runs under a per-peer circuit breaker and a
deadline budget (fault sites fleet.heartbeat / fleet.peer_fetch /
fleet.gossip / fleet.telemetry), so a dead or partitioned peer costs
one bounded timeout, never a retry storm and never a missing verdict.
"""

from .manager import (FleetConfig, FleetManager, configure_fleet,
                      get_fleet, reset_fleet)
from .shards import rendezvous_owner, shard_of
from .telemetry import (TELEMETRY_SCHEMA_VERSION, TelemetryAggregator,
                        TelemetrySource, snapshot_checksum)

__all__ = [
    "FleetConfig", "FleetManager", "configure_fleet", "get_fleet",
    "reset_fleet", "shard_of", "rendezvous_owner",
    "TELEMETRY_SCHEMA_VERSION", "TelemetryAggregator",
    "TelemetrySource", "snapshot_checksum",
]
