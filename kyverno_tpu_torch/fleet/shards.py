# Copied verbatim from kyverno_tpu/fleet/shards.py.
"""Rendezvous-hash shard assignment over the resource keyspace.

The keyspace is split into a fixed number of shards (uid -> shard by
stable hash); each shard is owned by exactly one live replica, chosen
by highest-random-weight (rendezvous) hashing. Two properties make
this the right primitive for failover:

- **determinism**: every replica with the same live-membership view
  computes the same assignment — no assignment state to replicate,
  the lease ledger IS the assignment input;
- **minimal movement**: when a replica dies, only ITS shards change
  owner (each surviving shard's argmax is unchanged by removing a
  non-winning candidate), so a failover never reshuffles the warm
  majority of the fleet.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence

DEFAULT_NUM_SHARDS = 64


def shard_of(uid: str, num_shards: int = DEFAULT_NUM_SHARDS) -> int:
    """Stable shard index for a resource uid (or any string key)."""
    h = hashlib.sha256(uid.encode("utf-8", "surrogatepass")).digest()
    return int.from_bytes(h[:8], "big") % max(num_shards, 1)


def _score(shard: int, replica_id: str) -> int:
    h = hashlib.sha256(f"{shard}:{replica_id}".encode()).digest()
    return int.from_bytes(h[:8], "big")


def rendezvous_owner(shard: int,
                     replicas: Sequence[str]) -> Optional[str]:
    """The live replica owning ``shard`` — highest rendezvous score
    wins (ties broken by replica id so the result is total)."""
    if not replicas:
        return None
    return max(replicas, key=lambda rid: (_score(shard, rid), rid))


def assign_shards(replicas: Sequence[str],
                  num_shards: int = DEFAULT_NUM_SHARDS
                  ) -> Dict[int, Optional[str]]:
    """Full shard -> owner map for a live set."""
    return {s: rendezvous_owner(s, replicas) for s in range(num_shards)}


def owned_shards(replica_id: str, replicas: Sequence[str],
                 num_shards: int = DEFAULT_NUM_SHARDS) -> List[int]:
    """The shards ``replica_id`` owns under the given live set."""
    return [s for s in range(num_shards)
            if rendezvous_owner(s, replicas) == replica_id]
