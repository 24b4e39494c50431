"""The port's process-global state, reset between tests.

``tests/conftest.py`` resets the JAX package's process-global state
before and after every test; ``reset_port_state`` does the same for the
port's counterparts, and the autouse ``fresh_port_state`` fixture calls
it around each test of a module that imports it. This module imports
neither JAX nor ``kyverno_tpu``, so the GPU tests (run without the repo
conftest, on a machine without JAX) can import it too;
``torch_parity_util`` re-exports both names."""

from __future__ import annotations

import threading

import pytest


def reset_port_state() -> None:
    """Empty the port's verdict and encode caches, columnar store,
    report store, rule analytics, last static analysis, shadow
    verifier, flight recorder, op-log, storage ladder and fleet manager
    (each one that tests/conftest.py resets for the JAX package)."""
    from kyverno_tpu_torch.analysis import global_analysis
    from kyverno_tpu_torch.cluster.columnar import reset_store
    from kyverno_tpu_torch.fleet import get_fleet, reset_fleet
    from kyverno_tpu_torch.observability.analytics import (
        global_pattern_cells, global_rule_stats, global_slo,
        global_starvation)
    from kyverno_tpu_torch.observability.flightrecorder import global_flight
    from kyverno_tpu_torch.observability.log import global_oplog
    from kyverno_tpu_torch.observability.verification import global_verifier
    from kyverno_tpu_torch.reports import reset_reports
    from kyverno_tpu_torch.resilience.storage import reset_storage
    from kyverno_tpu_torch.tpu.cache import (global_encode_cache,
                                             global_verdict_cache)

    # the fleet first, and the flight recorder's detached spools: their
    # threads may still write into the state reset below
    if get_fleet() is not None:
        reset_fleet()
    for t in threading.enumerate():
        if t.name == "flight-spool":
            t.join(timeout=5)
    global_verdict_cache.on_put = None
    global_verdict_cache.clear()
    global_encode_cache.clear()
    reset_store()
    reset_reports()
    global_analysis.reset()
    for acc in (global_rule_stats, global_starvation, global_slo,
                global_pattern_cells):
        acc.reset()
    global_verifier.reset()
    global_flight.reset()
    global_oplog.reset()
    # after the op-log: its reset may re-register the oplog surface
    reset_storage()


@pytest.fixture(autouse=True)
def fresh_port_state():
    """Every test starts from fresh port state and leaves none behind
    (``reset_port_state`` before and after). Autouse in each test module
    that imports it."""
    reset_port_state()
    yield
    reset_port_state()
