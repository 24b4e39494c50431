"""The port's fleet layer (kyverno_tpu_torch/fleet/, copies of the
reference's) against the JAX package's, on the CPU.

- ``shard_of`` and ``rendezvous_owner`` give the reference's shard and
  owner for 10,000 seeded keys and several replica sets;
- ``encode_entry`` gives the reference's wire document for the same
  entry, and each package's ``decode_entry`` accepts the other's (a port
  replica and a reference replica can exchange cache entries), and
  rejects the same poisoned documents for the same reasons;
- copies of the reference's membership, trio, peer fetch, poisoned and
  revision-skewed peer, push, fault-site and heartbeat-fault tests
  (tests/test_fleet.py) on the port's managers;
- the port's scan service under a fleet: it scans only the shards it
  owns and takes over a dead peer's; two replicas' report stores
  together hold the one-replica store's rows, and after a graceful
  leave the survivor's takeover rescan gives its digest;
- the admission server under a fleet (the reference's tests of
  ``webhooks/server.py`` with the fleet, on ``Handlers(device="cpu")``):
  a local miss served from a peer's cache at submit, one trace across
  both replicas, and the ``/debug/fleet`` route.

No test races a lease: the leases of the threaded tests are 2 s or
longer (the reference's 0.5-1 s leases expire under a loaded host) and
every wait is on a condition; the scan-service tests drive ``tick()``
by hand on a clock the test sets."""

import json
import random
import time
import urllib.request
from contextlib import contextmanager

import numpy as np
import pytest

from kyverno_tpu.fleet import peering as jpeering
from kyverno_tpu.fleet import shards as jshards
from kyverno_tpu_torch.api.policy import ClusterPolicy
from kyverno_tpu_torch.cluster import (BackgroundScanService,
                                       ClusterSnapshot, PolicyCache)
from kyverno_tpu_torch.cluster.leaderelection import LeaseStore
from kyverno_tpu_torch.fleet import (FleetConfig, FleetManager,
                                     configure_fleet, get_fleet, reset_fleet,
                                     shard_of)
from kyverno_tpu_torch.fleet import manager as fm
from kyverno_tpu_torch.fleet import shards as tshards
from kyverno_tpu_torch.fleet.membership import FleetMembership
from kyverno_tpu_torch.fleet.peering import (column_checksum, decode_entry,
                                             encode_entry)
from kyverno_tpu_torch.observability.metrics import global_registry as reg
from kyverno_tpu_torch.reports import store as rstore
from kyverno_tpu_torch.resilience.faults import global_faults
from kyverno_tpu_torch.tpu.cache import VerdictCache, global_verdict_cache

from torch_parity_util import fresh_port_state  # noqa: F401
from torch_parity_util import no_port_verdict_cache  # noqa: F401

N_SHARDS = 64
LEASE_S = 2.0


def _pol(name="fleet-pol", value="false"):
    return ClusterPolicy.from_dict({
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": name},
        "spec": {"rules": [{
            "name": "r1",
            "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
            "validate": {"message": "m", "pattern": {"spec": {"containers": [
                {"=(securityContext)": {"=(privileged)": value}}]}}},
        }]}})


def _pods(n, ns="default"):
    return [{
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": f"p{i}", "namespace": ns, "uid": f"u-{i}"},
        "spec": {"containers": [{
            "name": "c", "image": "nginx",
            **({"securityContext": {"privileged": True}}
               if i % 3 == 0 else {})}]},
    } for i in range(n)]


def _mgr(rid, cache=None, lease_s=LEASE_S, hb=0.1, clock=None, **kw):
    cfg = FleetConfig(replica_id=rid, listen_port=0, lease_s=lease_s,
                      heartbeat_interval_s=hb, push_interval_s=0.05,
                      num_shards=N_SHARDS, **kw)
    extra = {"clock": clock} if clock is not None else {}
    return FleetManager(cfg, cache=cache if cache is not None
                        else VerdictCache(capacity=256), **extra)


def _wait(cond, timeout=15.0, interval=0.03):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def _trio():
    """Three started managers with isolated caches, fully peered."""
    mgrs = [_mgr(f"r{i}") for i in range(3)]
    for i, m in enumerate(mgrs):
        m.add_peers(*[x.url for j, x in enumerate(mgrs) if j != i])
    for m in mgrs:
        m.start()
    assert _wait(lambda: all(len(m.membership.live()) == 3 for m in mgrs)), \
        [m.membership.live() for m in mgrs]
    return mgrs


def _key(i=0, ck="ck-new"):
    return (ck, f"rh-{i}", "rd-0")


def _pair(prefix, **kw):
    a, b = _mgr(prefix + "a", **kw), _mgr(prefix + "b", **kw)
    a.add_peers(b.url)
    b.add_peers(a.url)
    a.start()
    b.start()
    return a, b


# ---------------------------------------------------------------------------
# the reference's shard assignment and wire documents


def _seeded_keys(n=10000, seed=16):
    rng = random.Random(seed)
    alphabet = "abcdefghijklmnopqrstuvwxyz0123456789-/:é中"
    return [f"{rng.choice(['default', 'kube-system', 'prod-é'])}/"
            f"{rng.choice(['Pod', 'Deployment', 'Namespace'])}:"
            + "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 40)))
            for _ in range(n)]


REPLICA_SETS = [["r0"], ["r0", "r1"], ["r0", "r1", "r2"],
                [f"replica-{i}" for i in range(7)], ["b", "a", "c", "d"]]


def test_shard_of_matches_reference():
    keys = _seeded_keys()
    for num in (1, 7, N_SHARDS, 1000):
        got = [shard_of(k, num) for k in keys]
        assert got == [jshards.shard_of(k, num) for k in keys], num
    assert len(set(shard_of(k, N_SHARDS) for k in keys)) == N_SHARDS


@pytest.mark.parametrize("replicas", REPLICA_SETS,
                         ids=lambda r: f"{len(r)}-replicas")
def test_rendezvous_owner_matches_reference(replicas):
    keys = _seeded_keys()
    for shard in range(N_SHARDS):
        assert tshards.rendezvous_owner(shard, replicas) == \
            jshards.rendezvous_owner(shard, replicas)
    assert tshards.assign_shards(replicas, N_SHARDS) == \
        jshards.assign_shards(replicas, N_SHARDS)
    for rid in replicas:
        assert tshards.owned_shards(rid, replicas, N_SHARDS) == \
            jshards.owned_shards(rid, replicas, N_SHARDS)
    owners = {tshards.rendezvous_owner(shard_of(k, N_SHARDS), replicas)
              for k in keys}
    assert owners <= set(replicas)


def _entries():
    rng = np.random.default_rng(16)
    out = []
    for i, n in enumerate((0, 1, 7, 66, 69, 300)):
        key = (f"ck-{i}", f"rh-{rng.integers(1 << 30)}", f"rd-é{i}")
        out.append((key, rng.integers(0, 7, size=n).astype(np.int32)))
    return out


def test_encode_entry_gives_the_reference_document():
    for key, col in _entries():
        doc = encode_entry(key, col)
        assert doc == jpeering.encode_entry(key, col)
        assert json.dumps(doc, sort_keys=True) == json.dumps(
            jpeering.encode_entry(key, col), sort_keys=True)
        assert column_checksum(key, col.tobytes()) == \
            jpeering.column_checksum(key, col.tobytes())


def test_each_package_decodes_the_others_entries():
    for key, col in _entries():
        for enc, dec in ((encode_entry, jpeering.decode_entry),
                         (jpeering.encode_entry, decode_entry)):
            doc = json.loads(json.dumps(enc(key, col)))  # over the wire
            k, c, reason = dec(doc, want_key=key, expect_rows=len(col))
            assert reason == "" and k == key
            assert c.dtype == np.int32 and np.array_equal(c, col)
    # poisoned documents reject for the same reason in both packages
    key, col = _entries()[2]
    good = jpeering.encode_entry(key, col)
    flipped = dict(good, sha="0" * 16)
    trunc = dict(good, c=good["c"][:len(good["c"]) // 2])
    short = jpeering.encode_entry(key, col[:5])
    for doc, kw in ((flipped, {}), (trunc, {}), (short, {"expect_rows": 7}),
                    (good, {"want_key": _key(1)}), ({"k": 3}, {})):
        want = jpeering.decode_entry(doc, **kw)
        got = decode_entry(doc, **kw)
        assert got[2] == want[2] != "" and got[1] is None


# ---------------------------------------------------------------------------
# membership (tests/test_fleet.py)


def test_membership_lease_expiry_and_leader():
    now = [0.0]
    m = FleetMembership("r-b", url="http://x", lease_s=2.0,
                        clock=lambda: now[0])
    m.renew_self()
    m.observe_heartbeat("r-a", url="http://y", lease_s=2.0)
    assert m.live() == ["r-a", "r-b"]
    assert m.leader() == "r-a" and not m.is_leader()
    # r-a stops heartbeating: dead at the TTL, not before
    now[0] = 1.9
    m.renew_self()
    assert m.live() == ["r-a", "r-b"]
    now[0] = 4.1  # r-a's lease (renewed at 0) is now expired
    m.renew_self()
    assert m.live() == ["r-b"]
    assert m.is_leader()
    # epoch bumps exactly on view changes
    changed, epoch, live = m.note_epoch_if_changed()
    assert changed and live == ("r-b",)
    changed2, epoch2, _ = m.note_epoch_if_changed()
    assert not changed2 and epoch2 == epoch
    # a returning heartbeat revives the replica
    m.observe_heartbeat("r-a", url="http://y")
    assert m.live() == ["r-a", "r-b"]


def test_membership_third_party_view_never_renews():
    now = [0.0]
    m = FleetMembership("r-a", lease_s=1.0, clock=lambda: now[0])
    m.renew_self()
    m.learn_url("r-ghost", "http://ghost")  # discovery only
    assert "r-ghost" in m.known_urls()
    assert m.live() == ["r-a"], "URL discovery must not grant a lease"


# ---------------------------------------------------------------------------
# a live trio over localhost HTTP


def test_trio_converges_partitions_and_fails_over():
    mgrs = _trio()
    try:
        # a manager recomputes its shards on the tick or heartbeat after
        # its live set changed: wait for all three to have done so
        assert _wait(lambda: sum(len(m.owned_view()) for m in mgrs)
                     == N_SHARDS)
        assert {m.membership.leader() for m in mgrs} == {"r0"}
        views = {m.config.replica_id: m.owned_view() for m in mgrs}
        assert set().union(*views.values()) == set(range(N_SHARDS))
        assert sum(len(v) for v in views.values()) == N_SHARDS
        # the port's owners are the reference's for this live set
        for rid, view in views.items():
            assert sorted(view) == jshards.owned_shards(
                rid, ["r0", "r1", "r2"], N_SHARDS)
        with urllib.request.urlopen(mgrs[0].url + "/fleet/state",
                                    timeout=5) as resp:
            doc = json.loads(resp.read())
        assert doc["membership"]["is_leader"] is True
        assert doc["shards"]["owned_count"] == len(views["r0"])
        for m in mgrs:
            m.take_newly_owned()
        victim = mgrs[1]
        victim_shards = views["r1"]
        victim.kill()  # no leave: the lease just ages out
        survivors = [mgrs[0], mgrs[2]]
        assert _wait(lambda: all(len(m.membership.live()) == 2
                                 for m in survivors))
        assert _wait(lambda: set().union(
            *[m.owned_view() for m in survivors]) == set(range(N_SHARDS)))
        new_views = {m.config.replica_id: m.owned_view() for m in survivors}
        gained = survivors[0].take_newly_owned() | \
            survivors[1].take_newly_owned()
        assert gained == victim_shards, "exactly the dead shards move"
        for m in survivors:
            assert views[m.config.replica_id] <= new_views[m.config.replica_id]
    finally:
        for m in mgrs:
            try:
                m.stop(leave=False)
            except Exception:
                pass


def test_graceful_leave_rebalances_without_waiting_out_the_lease():
    mgrs = [_mgr(f"g{i}", lease_s=60.0) for i in range(3)]
    for i, m in enumerate(mgrs):
        m.add_peers(*[x.url for j, x in enumerate(mgrs) if j != i])
    for m in mgrs:
        m.start()
    try:
        assert _wait(lambda: all(len(m.membership.live()) == 3
                                 for m in mgrs))
        for m in mgrs:
            m.take_newly_owned()
        mgrs[2].stop(leave=True)
        survivors = mgrs[:2]
        # a 60 s lease: only the leave notice can drop g2 this soon
        assert _wait(lambda: all(len(m.membership.live()) == 2
                                 for m in survivors))
        assert _wait(lambda: set().union(
            survivors[0].owned_view(), survivors[1].owned_view())
            == set(range(N_SHARDS)))
    finally:
        for m in mgrs[:2]:
            m.stop(leave=False)


# ---------------------------------------------------------------------------
# cache peering


def test_peer_fetch_bit_identical_and_counted():
    a, b = _pair("p")
    try:
        assert _wait(lambda: len(a.membership.live()) == 2)
        col = np.array([0, 2, 4, 6, 1, 3, 5], dtype=np.int32)
        b.cache.put(_key(), col, fanout=False)
        h0 = reg.fleet_peer_fetch.value({"peer": "pb", "outcome": "hit"})
        got = a.fetch_one(_key(), expect_rows=7)
        assert got is not None and np.array_equal(got, col)
        assert a.cache.peek(_key()) is not None
        assert reg.fleet_peer_fetch.value(
            {"peer": "pb", "outcome": "hit"}) == h0 + 1
    finally:
        a.stop(leave=False)
        b.stop(leave=False)


def test_poisoned_peer_response_is_a_miss_not_a_verdict():
    col = np.arange(7, dtype=np.int32)
    key = _key()
    good = encode_entry(key, col)
    bad_trunc = dict(good)
    bad_trunc["c"] = good["c"][: len(good["c"]) // 2]
    k, c, reason = decode_entry(bad_trunc, expect_rows=7)
    assert c is None and reason in ("checksum", "decode")
    flipped = encode_entry(key, np.array([2, 1, 2, 3, 4, 5, 6],
                                         dtype=np.int32))
    bad_flip = dict(flipped)
    bad_flip["sha"] = good["sha"]
    k, c, reason = decode_entry(bad_flip, expect_rows=7)
    assert c is None and reason == "checksum"
    k, c, reason = decode_entry(good, want_key=_key(1), expect_rows=7)
    assert c is None and reason == "key_mismatch"
    short = encode_entry(key, np.arange(5, dtype=np.int32))
    k, c, reason = decode_entry(short, expect_rows=7)
    assert c is None and reason == "shape"
    k, c, reason = decode_entry(good, want_key=key, expect_rows=7)
    assert c is not None and np.array_equal(c, col) and reason == ""


def test_poisoned_fetch_end_to_end_counts_rejects(monkeypatch):
    a, b = _pair("q")
    try:
        assert _wait(lambda: len(a.membership.live()) == 2)
        col = np.arange(7, dtype=np.int32)
        key = _key()
        b.cache.put(key, col, fanout=False)
        import kyverno_tpu_torch.fleet.server as fsrv

        orig = fsrv.encode_entry

        def poisoned(k, c):
            doc = orig(k, c)
            doc["c"] = doc["c"][:8] + doc["c"][10:]  # truncated mid-base64
            return doc

        monkeypatch.setattr(fsrv, "encode_entry", poisoned)
        r0 = sum(v for _, v in reg.fleet_peer_rejects.series())
        got = a.fetch_one(key, expect_rows=7)
        assert got is None, "a poisoned payload must be a miss"
        assert a.cache.peek(key) is None
        assert sum(v for _, v in reg.fleet_peer_rejects.series()) > r0
    finally:
        a.stop(leave=False)
        b.stop(leave=False)


def test_revision_skewed_peer_never_satisfies_lookup():
    a, b = _pair("s")
    try:
        assert _wait(lambda: len(a.membership.live()) == 2)
        col = np.arange(7, dtype=np.int32)
        b.cache.put(("ck-old", "rh-0", "rd-0"), col, fanout=False)
        got = a.fetch_one(("ck-new", "rh-0", "rd-0"), expect_rows=7)
        assert got is None
        assert a.cache.peek(("ck-new", "rh-0", "rd-0")) is None
        assert a.cache.peek(("ck-old", "rh-0", "rd-0")) is None
    finally:
        a.stop(leave=False)
        b.stop(leave=False)


def test_gossip_push_warms_peers_and_cannot_pingpong():
    a, b = _pair("g")
    try:
        assert _wait(lambda: len(a.membership.live()) == 2)
        col = np.array([1, 2, 3, 4, 5, 6, 0], dtype=np.int32)
        a.cache.put(_key(5), col)
        assert _wait(lambda: b.cache.peek(_key(5)) is not None), \
            "gossip never arrived"
        assert np.array_equal(b.cache.peek(_key(5)), col)
        assert _wait(lambda: len(b._push_q) == 0, timeout=2.0)
        assert reg.fleet_gossip.value({"outcome": "received"}) >= 1
    finally:
        a.stop(leave=False)
        b.stop(leave=False)


def test_push_receive_verifies_before_store():
    a = _mgr("va")
    a.start()
    try:
        col = np.arange(7, dtype=np.int32)
        good = encode_entry(_key(0), col)
        bad = encode_entry(_key(1), col)
        bad["sha"] = "0" * 16
        r0 = reg.fleet_peer_rejects.value({"reason": "checksum"})
        req = urllib.request.Request(
            a.url + "/fleet/push",
            data=json.dumps({"entries": [good, bad]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5) as resp:
            doc = json.loads(resp.read())
        assert doc["accepted"] == 1 and doc["rejected"] == 1
        assert a.cache.peek(_key(0)) is not None
        assert a.cache.peek(_key(1)) is None
        assert reg.fleet_peer_rejects.value({"reason": "checksum"}) == r0 + 1
    finally:
        a.stop(leave=False)


def test_push_from_a_reference_document_is_stored():
    """A reference replica's pushed entry verifies at a port replica."""
    a = _mgr("xa")
    a.start()
    try:
        col = np.arange(69, dtype=np.int32) % 7
        req = urllib.request.Request(
            a.url + "/fleet/push",
            data=json.dumps({"entries": [jpeering.encode_entry(_key(3),
                                                               col)]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5) as resp:
            doc = json.loads(resp.read())
        assert doc["accepted"] == 1 and doc["rejected"] == 0
        assert np.array_equal(a.cache.peek(_key(3)), col)
    finally:
        a.stop(leave=False)


def test_checksum_binds_key_to_bytes():
    col = np.arange(4, dtype=np.int32)
    raw = col.tobytes()
    assert column_checksum(("a", "b", "c"), raw) != \
        column_checksum(("a", "b", "d"), raw)
    assert column_checksum(("a", "b", "c"), raw) != \
        column_checksum(("a", "b", "c"), raw[:-1])


# ---------------------------------------------------------------------------
# fault sites


def test_fleet_fault_sites_registered_and_fire():
    from kyverno_tpu_torch.resilience.faults import (KNOWN_SITES,
                                                     FaultRegistry)

    for site in ("fleet.heartbeat", "fleet.peer_fetch", "fleet.gossip"):
        assert site in KNOWN_SITES
    fr = FaultRegistry()
    fr.arm("fleet.peer_fetch", mode="raise")
    with pytest.raises(Exception):
        fr.fire("fleet.peer_fetch")


def test_heartbeat_fault_is_a_partition_and_heals():
    """An armed ``fleet.heartbeat`` raise is a network partition: leases
    age out on both sides and each side owns the whole keyspace;
    disarming heals and the fleet re-splits."""
    a, b = _pair("h")
    try:
        assert _wait(lambda: len(a.membership.live()) == 2
                     and len(b.membership.live()) == 2)
        assert _wait(lambda: len(a.owned_view()) + len(b.owned_view())
                     == N_SHARDS)
        e0 = reg.fleet_heartbeats.value({"peer": "hb", "outcome": "error"})
        global_faults.arm("fleet.heartbeat", mode="raise")
        assert _wait(lambda: a.membership.live() == ["ha"]
                     and b.membership.live() == ["hb"])
        assert _wait(lambda: a.owned_view() == frozenset(range(N_SHARDS))
                     and b.owned_view() == frozenset(range(N_SHARDS)))
        assert reg.fleet_heartbeats.value(
            {"peer": "hb", "outcome": "error"}) > e0
        global_faults.disarm("fleet.heartbeat")
        assert _wait(lambda: len(a.membership.live()) == 2
                     and len(b.membership.live()) == 2, timeout=30.0)
        assert _wait(lambda: len(a.owned_view()) + len(b.owned_view())
                     == N_SHARDS)
    finally:
        global_faults.disarm()
        a.stop(leave=False)
        b.stop(leave=False)


# ---------------------------------------------------------------------------
# the scan service under a fleet (manual ticks on a test clock)


@contextmanager
def _as_replica(mgr, store=None):
    """Install ``mgr`` as the process-global fleet (and ``store`` as the
    report store) for a scan tick of one in-process replica."""
    with fm._fleet_lock:
        prev_fleet, fm._global_fleet = fm._global_fleet, mgr
    with rstore._store_lock:
        prev_store = rstore._store
        if store is not None:
            rstore._store = store
    try:
        yield
    finally:
        with fm._fleet_lock:
            fm._global_fleet = prev_fleet
        with rstore._store_lock:
            rstore._store = prev_store


def test_scanner_scans_only_owned_shards_and_takes_over():
    now = [0.0]
    mgr = _mgr("rz", cache=global_verdict_cache, hb=3600.0,
               clock=lambda: now[0])
    mgr.start()
    try:
        with _as_replica(mgr):
            # a fake peer holds a fresh lease: rendezvous splits the space
            mgr.membership.observe_heartbeat("rz-peer",
                                             url="http://127.0.0.1:1")
            mgr.tick()
            owned = mgr.owned_view()
            assert 0 < len(owned) < N_SHARDS
            assert sorted(owned) == jshards.owned_shards(
                "rz", ["rz", "rz-peer"], N_SHARDS)
            mgr.take_newly_owned()

            snap = ClusterSnapshot()
            cache = PolicyCache()
            cache.set(_pol())
            svc = BackgroundScanService(snap, cache, device="cpu")
            pods = _pods(40)
            uids = [snap.upsert(p) for p in pods]
            mine = [u for u in uids if shard_of(u, N_SHARDS) in owned]
            n = svc.scan_once(full=True)
            assert n == len(mine), (n, len(mine))
            assert svc.stats.get("skipped_unowned", 0) == len(uids) - len(mine)
            # the fake peer dies: its lease ages out on the test clock
            now[0] += 3 * LEASE_S
            mgr.tick()
            assert mgr.membership.live() == ["rz"]
            assert mgr.owned_view() == frozenset(range(N_SHARDS))
            n2 = svc.scan_once()
            # every resource of the taken-over shards rescans
            assert n2 >= len(uids) - len(mine), (n2, len(uids) - len(mine))
            assert svc.stats["scans"] == 2
            assert not mgr.pending_takeover()
    finally:
        mgr.stop(leave=False)


def test_two_replicas_give_the_one_replica_reports(no_port_verdict_cache):
    """Two in-process replicas on one lease store: their report stores
    partition the one-replica store's rows; after one leaves gracefully,
    the survivor's takeover rescan gives the one-replica digest."""
    pods = _pods(64)
    for p in pods[48:]:
        p["metadata"]["namespace"] = "prod"
    policy = _pol()

    def service():
        snap, cache = ClusterSnapshot(), PolicyCache()
        cache.set(policy)
        for p in pods:
            snap.upsert(p)
        return BackgroundScanService(snap, cache, device="cpu"), snap

    one_store = rstore.ReportStore()
    svc1, snap1 = service()
    with _as_replica(None, one_store):
        assert svc1.scan_once(full=True) == len(pods)
    want_rows, want_digest = dict(one_store._rows), one_store.digest()
    assert len(want_rows) == len(pods)

    now = [0.0]
    leases = LeaseStore(clock=lambda: now[0])
    a = _mgr("ra", hb=3600.0, clock=lambda: now[0])
    b = _mgr("rb", hb=3600.0, clock=lambda: now[0])
    for m in (a, b):
        m.membership.store = leases
    a.add_peers(b.url)
    b.add_peers(a.url)
    a.start()
    b.start()
    try:
        for _ in range(3):
            a.tick()
            b.tick()
        assert a.membership.live() == b.membership.live() == ["ra", "rb"]
        assert a.owned_view() | b.owned_view() == frozenset(range(N_SHARDS))
        assert not a.owned_view() & b.owned_view()
        stores = {"ra": rstore.ReportStore(), "rb": rstore.ReportStore()}
        svcs = {"ra": service()[0], "rb": service()[0]}
        for m in (a, b):
            rid = m.config.replica_id
            with _as_replica(m, stores[rid]):
                n = svcs[rid].scan_once(full=True)
            assert n == sum(shard_of(u, N_SHARDS) in m.owned_view()
                            for u, _, _ in snap1.items())
        ra, rb = stores["ra"]._rows, stores["rb"]._rows
        assert not set(ra) & set(rb)
        assert {**ra, **rb} == want_rows
        # rb leaves gracefully: ra drops it now, no lease wait
        b.stop(leave=True)
        a.tick()
        assert a.membership.live() == ["ra"]
        assert a.owned_view() == frozenset(range(N_SHARDS))
        with _as_replica(a, stores["ra"]):
            n = svcs["ra"].scan_once()
        assert n == len(rb)
        assert stores["ra"]._rows == want_rows
        assert stores["ra"].digest() == want_digest
    finally:
        a.stop(leave=False)
        b.stop(leave=False)


# ---------------------------------------------------------------------------
# the hooks of earlier slices now resolve


def test_flight_records_tagged_with_replica_id():
    from kyverno_tpu_torch.observability.flightrecorder import FlightRecord

    rec = FlightRecord("admission", "ok", "device", {"kind": "Pod"},
                       [(("p", "r"), 0)])
    assert "replica" not in rec.to_dict()
    configure_fleet(FleetConfig(replica_id="tag-1", listen_port=0,
                                lease_s=LEASE_S, heartbeat_interval_s=0.2))
    try:
        assert rec.to_dict()["replica"] == "tag-1"
    finally:
        reset_fleet()
    assert get_fleet() is None


# ---------------------------------------------------------------------------
# the admission server under a fleet (the reference's tests that waited on
# webhooks/server.py): the port's handlers run with device="cpu"


@contextmanager
def _fleet_admission(prefix):
    """A batching ``Handlers`` with its lifecycle worker running, a warm
    peer holding one admission's verdict column, and the local replica
    peered with it after the local cache was emptied."""
    from kyverno_tpu_torch.engine.match import RequestInfo
    from kyverno_tpu_torch.webhooks import build_handlers
    from kyverno_tpu_torch.webhooks.server import AdmissionPayload

    cache = PolicyCache()
    cache.set(_pol())
    h = build_handlers(cache, batching=True, device="cpu")
    h.lifecycle.start()
    peer = _mgr(prefix + "b")
    try:
        assert _wait(lambda: h.lifecycle.active is not None, timeout=120)
        pod = _pods(1)[0]
        payload = AdmissionPayload(pod, "CREATE", RequestInfo(), "default")
        r1 = h.pipeline.submit(payload)  # computes + populates local
        eng = h.lifecycle.active.engine
        key = eng.verdict_cache_keys([pod], {}, ["CREATE"],
                                     [RequestInfo()])[0]
        col = global_verdict_cache.peek(key)
        assert col is not None
        # move the column to the PEER and cold-start the local cache
        peer.cache.put(key, col, fanout=False)
        global_verdict_cache.clear()
        peer.start()
        local = configure_fleet(FleetConfig(
            replica_id=prefix + "a", listen_port=0, lease_s=LEASE_S,
            heartbeat_interval_s=0.1, num_shards=N_SHARDS))
        local.rows_provider = lambda: len(eng.cps.rules)
        local.add_peers(peer.url)
        peer.add_peers(local.url)
        assert _wait(lambda: len(local.membership.live()) == 2)
        yield h, payload, r1, peer
    finally:
        reset_fleet()
        peer.stop(leave=False)
        h.lifecycle.stop()
        h.pipeline.stop()
        h.batcher.stop()


def test_admission_submit_serves_from_peer_cache():
    with _fleet_admission("w") as (h, payload, r1, peer):
        h0 = reg.fleet_peer_fetch.value({"peer": "wb", "outcome": "hit"})
        hits0 = h.pipeline.stats.get("cache_hits", 0)
        r2 = h.pipeline.submit(payload)
        assert list(r2) == list(r1), "peer-served verdicts bit-identical"
        assert h.pipeline.stats.get("cache_hits", 0) == hits0 + 1, \
            "peer hit must resolve at submit (no flush)"
        assert reg.fleet_peer_fetch.value(
            {"peer": "wb", "outcome": "hit"}) == h0 + 1


def test_peer_served_admission_is_one_connected_trace():
    """An admission served from a PEER's cache is one trace across both
    replicas: the caller's admission.submit root and the peer's
    fleet.rpc.fetch share a trace id, and the cached-path flight record
    carries it."""
    from kyverno_tpu_torch.observability.tracing import global_tracer

    flights = []
    with _fleet_admission("t") as (h, payload, r1, peer):
        h.pipeline._flight = lambda *a, **kw: flights.append((a, kw))
        n0 = len(global_tracer.finished("admission.submit"))
        r2 = h.pipeline.submit(payload)
        assert list(r2) == list(r1)
        roots = global_tracer.finished("admission.submit")
        assert len(roots) == n0 + 1
        root = roots[-1]
        assert _wait(lambda: any(
            s.name == "fleet.rpc.fetch"
            for s in global_tracer.trace(root.trace_id))), \
            [s.name for s in global_tracer.trace(root.trace_id)]
        fetch = [s for s in global_tracer.trace(root.trace_id)
                 if s.name == "fleet.rpc.fetch"][0]
        assert fetch.attributes["replica"] == "tb"
        assert flights, "cached path must record a flight"
        args, _kw = flights[-1]
        assert args[2] == "cached" and args[4] == root.trace_id, args


def test_debug_fleet_route_and_state_block():
    from kyverno_tpu_torch.webhooks.server import handle_debug_path

    # no fleet: enabled false, never starts one
    code, body, ctype = handle_debug_path("/debug/fleet")
    assert code == 200 and json.loads(body) == {"enabled": False}
    configure_fleet(FleetConfig(replica_id="dz", listen_port=0,
                                lease_s=LEASE_S, heartbeat_interval_s=0.2,
                                num_shards=N_SHARDS))
    try:
        code, body, ctype = handle_debug_path("/debug/fleet")
        doc = json.loads(body)
        assert doc["enabled"] is True
        assert doc["membership"]["replica_id"] == "dz"
        assert doc["shards"]["owned_count"] == N_SHARDS  # alone = all
        assert "breakers" in doc["peering"]
    finally:
        reset_fleet()
    assert get_fleet() is None
