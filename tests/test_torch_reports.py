"""The port's incremental report store (kyverno_tpu_torch/reports/)
against the JAX package's, exactly.

The same seeded sequence of ``apply`` and ``delete`` goes through both
stores: digests, ``aggregate()`` documents, ``summary()``, the count
tables and the metric deltas are equal, the journals and snapshots are
byte-equal, a directory that one package writes loads in the other to
the same digest, and both recover from the same damage to the same
prefix with the same recovery reasons. Each package keeps its own fault
registry, storage health and metrics: a test arms, resets and reads
both."""

from __future__ import annotations

import json
import os
import random

import pytest

from kyverno_tpu.observability.metrics import global_registry as jreg
from kyverno_tpu.reports import ReportStore as JStore
from kyverno_tpu.reports import journal as jjn
from kyverno_tpu.resilience import faults as jfaults
from kyverno_tpu.resilience.storage import reset_storage as jreset_storage
from kyverno_tpu_torch.observability.metrics import global_registry as treg
from kyverno_tpu_torch.reports import ReportStore as TStore
from kyverno_tpu_torch.reports import journal as tjn
from kyverno_tpu_torch.resilience import faults as tfaults
from kyverno_tpu_torch.resilience.storage import reset_storage as treset_storage

from torch_parity_util import fresh_port_state  # noqa: F401 - autouse

REASONS = ("short_header", "truncated_record", "checksum", "decode",
           "duplicate", "snapshot", "replay", "append_error")
COUNTERS = ("reports_fold_ops", "reports_fold_skipped", "reports_rebuilds",
            "reports_journal_records", "reports_snapshots")
PACKAGES = {"jax": (JStore, jreg, jfaults, jjn),
            "torch": (TStore, treg, tfaults, tjn)}


@pytest.fixture(autouse=True)
def _clean_both():
    for faults in (jfaults, tfaults):
        faults.global_faults.disarm()
    jreset_storage()
    treset_storage()
    yield
    for faults in (jfaults, tfaults):
        faults.global_faults.disarm()
    jreset_storage()
    treset_storage()


def metric_state(reg):
    out = {name: getattr(reg, name).value() for name in COUNTERS}
    out.update({f"recoveries.{r}": reg.reports_recoveries.value({"reason": r})
                for r in REASONS})
    return out


def delta(after, before):
    return {k: after[k] - before[k] for k in after}


def seeded_ops(seed: int, n: int = 400):
    """A seeded mix of applies (new, changed, unchanged, policy-set key
    changes) and deletes over 60 uids in 5 namespaces."""
    rng = random.Random(seed)
    results = ("pass", "fail", "warn", "error", "skip")
    shas = {}
    ops = []
    for _ in range(n):
        uid = f"u{rng.randrange(60)}"
        roll = rng.random()
        if roll < 0.15:
            ops.append(("delete", uid))
            shas.pop(uid, None)
            continue
        if roll < 0.35 and uid in shas:
            sha, ps = shas[uid]  # unchanged: the zero-work path
        else:
            sha = f"h{rng.randrange(1 << 20):05x}"
            ps = "ps1" if rng.random() < 0.9 else "ps2"
        shas[uid] = (sha, ps)
        i = int(uid[1:])
        ns = "" if i % 7 == 0 else f"ns{i % 5}"
        kind = "Namespace" if not ns else "Pod"
        rows = [(f"pol-{rng.randrange(4)}", f"r{rng.randrange(3)}",
                 rng.choice(results)) for _ in range(rng.randrange(5))]
        ops.append(("apply", uid, sha, ps, ns, kind, f"res-{i}", rows))
    return ops


def run_ops(store, ops):
    out = []
    for op in ops:
        if op[0] == "delete":
            out.append(store.delete(op[1]))
        else:
            out.append(store.apply(*op[1:]))
    return out


def strip_timestamps(doc):
    for r in doc.get("results", []):
        r.pop("timestamp", None)
    return doc


def store_view(store):
    state = store.state()
    state.pop("directory")
    return {"digest": store.digest(),
            "aggregate": {ns: strip_timestamps(rep.to_dict())
                          for ns, rep in store.aggregate().items()},
            "summary": store.summary(),
            "namespaces": store.namespaces(),
            "policies": store.policies(),
            "state": state}


@pytest.mark.parametrize("persistent", [False, True],
                         ids=["in_memory", "journaled"])
def test_same_sequence_same_state(tmp_path, persistent):
    ops = seeded_ops(1)
    views, returns, deltas = {}, {}, {}
    for name, (Store, reg, _, _) in PACKAGES.items():
        d = str(tmp_path / name) if persistent else None
        m0 = metric_state(reg)
        store = Store(directory=d, journal_max_bytes=8192)
        returns[name] = run_ops(store, ops)
        store.sync()
        views[name] = store_view(store)
        assert store.rebuild() == views[name]["digest"]
        assert store.verify_rebuild()
        deltas[name] = delta(metric_state(reg), m0)
        store.close()
    assert returns["torch"] == returns["jax"]
    assert views["torch"] == views["jax"]
    assert deltas["torch"] == deltas["jax"]
    # the zero-work path and the compactions were both exercised
    assert deltas["jax"]["reports_fold_skipped"] > 0
    if persistent:
        assert deltas["jax"]["reports_snapshots"] > 0


def test_journals_and_snapshots_byte_equal(tmp_path):
    ops = seeded_ops(2, n=120)
    files = {}
    for name, (Store, _, _, jn) in PACKAGES.items():
        d = str(tmp_path / name)
        store = Store(directory=d)
        run_ops(store, ops)
        store.close(compact=False)
        with open(os.path.join(d, jn.JOURNAL_NAME), "rb") as f:
            journal = f.read()
        store = Store(directory=d)  # replays the journal
        store.close()  # compacts: the snapshot, an empty journal
        with open(os.path.join(d, jn.SNAPSHOT_NAME), "rb") as f:
            files[name] = (journal, f.read())
    assert files["torch"][0] == files["jax"][0] and files["jax"][0]
    assert files["torch"][1] == files["jax"][1]
    # the framing and the record walk are the same functions
    for payload in (b"{}", b'{"seq":3}', b"x" * 300):
        assert tjn.frame(payload) == jjn.frame(payload)
    data = files["jax"][0]
    assert tjn.scan_records(data) == jjn.scan_records(data)
    assert tjn.scan_records(data[:-5]) == jjn.scan_records(data[:-5])


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("compact", [False, True], ids=["journal", "snapshot"])
def test_directory_loads_in_the_other_package(tmp_path, writer, reader,
                                              compact):
    d = str(tmp_path / "r")
    store = PACKAGES[writer][0](directory=d, journal_max_bytes=4096)
    run_ops(store, seeded_ops(3))
    want = store_view(store)
    store.close(compact=compact)
    other = PACKAGES[reader][0](directory=d)
    got = store_view(other)
    for k in ("journal_bytes", "journal_max_bytes", "persistent",
              "recovered_records", "compactions", "verify_checks"):
        want["state"].pop(k)
        got["state"].pop(k)
    assert got == want
    other.close()


def damage(d, jn, how):
    """Damage a closed store's directory in one of the recovery
    ladder's ways (tests/test_reports.py's cases, and a decode)."""
    jpath = os.path.join(d, jn.JOURNAL_NAME)
    size = os.path.getsize(jpath)
    if how == "truncated_record":
        with open(jpath, "r+b") as f:
            f.truncate(size - 7)
    elif how == "checksum":
        with open(jpath, "r+b") as f:
            f.seek(size - 12)
            f.write(b"\xff\xff\xff\xff")
    elif how == "short_header":
        with open(jpath, "ab") as f:
            f.write(b"\x01\x02\x03")
    elif how == "decode":
        with open(jpath, "ab") as f:
            f.write(jn.frame(b"not json {"))
            f.write(jn.frame(b'{"op":"put","uid":"late","seq":999}'))
    elif how == "duplicate":
        payload = jn.canonical(
            {"op": "put", "uid": "u0", "sha": "base", "ps": "ps1",
             "ns": "ns0", "kind": "Pod", "name": "pod-0",
             "rows": [["pol-a", "r1", "pass"]], "seq": 1}).encode()
        with open(jpath, "ab") as f:
            f.write(jn.frame(payload))
    else:  # tampered snapshot: a row edited, the checksum left as it was
        path = os.path.join(d, jn.SNAPSHOT_NAME)
        with open(path) as f:
            body = json.load(f)
        body["rows"][0][3] = "evil-ns"
        with open(path, "w") as f:
            json.dump(body, f)


@pytest.mark.parametrize("how", ["short_header", "truncated_record",
                                 "checksum", "decode", "duplicate",
                                 "tampered_snapshot"])
def test_recovery_same_prefix_same_reasons(tmp_path, how):
    got = {}
    for name, (Store, reg, _, jn) in PACKAGES.items():
        d = str(tmp_path / name)
        store = Store(directory=d)
        for i in range(4):
            store.apply(f"u{i}", "base", "ps1", f"ns{i % 2}", "Pod",
                        f"pod-{i}", [("pol-a", "r1", "pass"),
                                     ("pol-b", "r2", "fail")])
        if how == "tampered_snapshot":
            store.close()  # the rows go to the snapshot
        else:
            store.apply("u9", "h9", "ps1", "ns9", "Pod", "pod-9",
                        [("pol-a", "r1", "fail")])
            store.close(compact=False)
        damage(d, jn, how)
        m0 = metric_state(reg)
        recovered = Store(directory=d)
        view = store_view(recovered)
        view["state"].pop("journal_bytes")
        assert recovered.rebuild() == view["digest"]
        got[name] = (sorted(recovered._rows), view,
                     {k: v for k, v in delta(metric_state(reg), m0).items()
                      if k.startswith("recoveries.") and v})
        recovered.close()
    assert got["torch"] == got["jax"]
    reasons = got["jax"][2]
    want = {"tampered_snapshot": "snapshot"}.get(how, how)
    assert reasons.get(f"recoveries.{want}", 0) >= 1, reasons


@pytest.mark.parametrize("site,mode", [("reports.fold", "raise"),
                                       ("reports.journal", "raise"),
                                       ("reports.journal", "corrupt")])
def test_faults_degrade_alike(tmp_path, site, mode):
    ops = seeded_ops(4, n=150)
    got = {}
    for name, (Store, reg, faults, _) in PACKAGES.items():
        d = str(tmp_path / name)
        m0 = metric_state(reg)
        store = Store(directory=d)
        run_ops(store, ops[:50])
        faults.global_faults.arm(site, mode=mode, p=0.2, seed=5)
        run_ops(store, ops[50:])
        faults.global_faults.disarm()
        live = store_view(store)
        live["state"].pop("journal_bytes")
        assert store.rebuild() == live["digest"]
        store.close(compact=False)
        reopened = Store(directory=d)
        again = store_view(reopened)
        again["state"].pop("journal_bytes")
        got[name] = (live, again, delta(metric_state(reg), m0))
        reopened.close()
    assert got["torch"] == got["jax"]
    deltas = got["jax"][2]
    if site == "reports.fold":
        assert deltas["reports_rebuilds"] > 0
    elif mode == "raise":
        assert deltas["recoveries.append_error"] > 0
    else:
        assert deltas["recoveries.checksum"] + deltas[
            "recoveries.truncated_record"] + deltas["recoveries.decode"] > 0
