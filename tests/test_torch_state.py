"""The port's process-global state is reset between tests as the JAX
package's is.

``tests/conftest.py`` resets the reference's caches, stores, analytics,
op-log, flight recorder, shadow verifier, storage ladder and fleet
around every test. ``torch_port_state.reset_port_state`` does the same
for the port. A global that one test dirties and the next one reads
(the op-log registering its storage surface, read back by
``/debug/state``) makes a test's result depend on which tests ran
before it in the same process."""

from __future__ import annotations

import ast
import errno
import inspect
import os

import numpy as np

import torch_port_state
from torch_parity_util import fresh_port_state  # noqa: F401 - autouse
from torch_port_state import reset_port_state

TESTS = os.path.dirname(os.path.abspath(__file__))


def test_reset_port_state_leaves_every_global_fresh(tmp_path):
    from kyverno_tpu_torch.cluster.columnar import configure_store, get_store
    from kyverno_tpu_torch.observability.analytics import global_slo
    from kyverno_tpu_torch.observability.flightrecorder import (
        FlightRecorder, global_flight)
    from kyverno_tpu_torch.observability.log import global_oplog
    from kyverno_tpu_torch.observability.verification import global_verifier
    from kyverno_tpu_torch.resilience.storage import (SURFACE_OPLOG,
                                                      storage_health,
                                                      storage_state)
    from kyverno_tpu_torch.tpu.cache import global_verdict_cache

    # dirty each one; the SLO before the flight recorder's spool
    # directory, as a burn with one configured spools the ring on a
    # thread of its own, whose op-log event could land after the reset
    global_slo.record_scan(coverage=0.5)
    global_oplog.configure(path=str(tmp_path / "op.jsonl"))
    global_oplog.emit("dirty", n=1)
    storage_health("journal").record_error(
        OSError(errno.ENOSPC, "no space left on device"), op="write")
    global_flight.configure(capacity=7, sample_rate=0.5,
                            spool_dir=str(tmp_path))
    global_verifier.configure(rate=0.5, synchronous=True)
    global_verdict_cache.put(("k",), np.zeros(3, dtype=np.int32))
    configure_store(str(tmp_path / "col"))
    assert global_oplog.state()["events_emitted"] >= 1
    assert {SURFACE_OPLOG, "journal"} <= set(storage_state())
    assert storage_state()["journal"]["state"] == "degraded"
    assert global_flight.capacity == 7 and global_verifier.rate == 0.5
    assert len(global_verdict_cache) == 1 and get_store() is not None

    reset_port_state()

    assert global_oplog.state() == {"stderr": False, "file": None,
                                    "events_emitted": 0}
    assert storage_state() == {}
    fresh = FlightRecorder()
    assert (global_flight.capacity, global_flight.sample_rate,
            global_flight.spool_dir) == (fresh.capacity, fresh.sample_rate,
                                         None)
    assert global_flight.stats["captured"] == 0
    assert global_verifier.rate == 0.0
    assert not global_verifier.synchronous
    assert global_verifier.stats["offered"] == 0
    assert len(global_verdict_cache) == 0 and get_store() is None


def _imported(fn_node) -> dict:
    """name -> module of every ``from M import name`` inside a function."""
    out = {}
    for node in ast.walk(fn_node):
        if isinstance(node, ast.ImportFrom) and node.module:
            out.update((a.name, node.module) for a in node.names)
    return out


def _resets(fn_node) -> set:
    """(module, name, action) of what a function does to the globals it
    imports: ``name()`` is action ``()``, ``name.attr(...)`` is ``attr``
    and ``name.attr = ...`` is ``=attr``. A loop variable over a tuple of
    imported names stands for each of them."""
    imported = _imported(fn_node)
    alias = {}
    for node in ast.walk(fn_node):
        if (isinstance(node, ast.For) and isinstance(node.target, ast.Name)
                and isinstance(node.iter, ast.Tuple)):
            alias[node.target.id] = [e.id for e in node.iter.elts
                                     if isinstance(e, ast.Name)]

    def names(expr):
        if not isinstance(expr, ast.Name):
            return []
        return [n for n in alias.get(expr.id, [expr.id]) if n in imported]

    out = set()
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Call):
            f = node.func
            out |= {(imported[n], n, "()") for n in names(f)}
            if isinstance(f, ast.Attribute):
                out |= {(imported[n], n, f.attr) for n in names(f.value)}
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute):
                    out |= {(imported[n], n, "=" + t.attr)
                            for n in names(t.value)}
    return out


def _autouse(fn) -> bool:
    for d in fn.decorator_list:
        if isinstance(d, ast.Call) and any(
                k.arg == "autouse" and getattr(k.value, "value", False)
                for k in d.keywords):
            return True
    return False


def test_reset_covers_every_reference_reset():
    """Each reset that an autouse fixture of tests/conftest.py does to a
    JAX-package global (a call of it, a method called on it, an
    attribute set on it) ``reset_port_state`` does to the port's
    counterpart: a reset added on the reference's side cannot be missed
    on the port's again."""
    with open(os.path.join(TESTS, "conftest.py")) as f:
        conftest = ast.parse(f.read())
    ref = set()
    for node in conftest.body:
        if isinstance(node, ast.FunctionDef) and _autouse(node):
            ref |= {(m, n, a) for m, n, a in _resets(node)
                    if m.split(".")[0] == "kyverno_tpu"}
    assert len(ref) >= 16, ref
    port_fn = ast.parse(inspect.getsource(torch_port_state.reset_port_state))
    port = _resets(port_fn)
    missing = sorted((m, n, a) for m, n, a in ref
                     if ("kyverno_tpu_torch" + m[len("kyverno_tpu"):], n, a)
                     not in port)
    assert not missing, f"reset_port_state lacks {missing}"
