# Copied verbatim from kyverno_tpu/cluster/leaderelection.py.
"""Lease-based leader election (pkg/leaderelection/leaderelection.go).

The reference elects singleton controllers via coordination.k8s.io
Lease objects (leaseDuration=12s, renewDeadline=10s, retryPeriod=2s,
leaderelection.go:77-79). Here the lease lives in a pluggable
``LeaseStore`` — in-memory for single-host/tests, a CR-backed store in
a cluster — and the elector drives the scan coordinator: in the
multi-host mesh, every host computes its verdict shard but only the
leader writes reports (SURVEY §2.7 'one coordinator (leader) for
compile cache + report writes')."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional


@dataclass
class LeaseRecord:
    holder: str
    acquire_time: float
    renew_time: float
    lease_duration_s: float


class LeaseStore:
    """In-memory coordination.k8s.io/Lease equivalent. get/update are
    atomic under the lock, mirroring the apiserver's optimistic
    concurrency for our single-process tests."""

    def __init__(self, clock=time.monotonic):
        self._lock = threading.Lock()
        self._leases: Dict[str, LeaseRecord] = {}  # guarded-by: _lock
        self.clock = clock

    def try_acquire_or_renew(self, name: str, identity: str,
                             lease_duration_s: float) -> bool:
        now = self.clock()
        with self._lock:
            rec = self._leases.get(name)
            if rec is None or rec.holder == identity \
                    or now - rec.renew_time > rec.lease_duration_s:
                acquire = rec.acquire_time if rec and rec.holder == identity else now
                self._leases[name] = LeaseRecord(
                    holder=identity, acquire_time=acquire, renew_time=now,
                    lease_duration_s=lease_duration_s)
                return True
            return False

    def holder(self, name: str) -> Optional[str]:
        with self._lock:
            rec = self._leases.get(name)
            if rec is None:
                return None
            if self.clock() - rec.renew_time > rec.lease_duration_s:
                return None
            return rec.holder

    def release(self, name: str, identity: str) -> None:
        with self._lock:
            rec = self._leases.get(name)
            if rec is not None and rec.holder == identity:
                del self._leases[name]


class LeaderElector:
    """leaderelection.go:51 New: run callbacks around leadership; renew
    on retryPeriod, lose leadership when the lease cannot be renewed
    within the lease duration."""

    def __init__(
        self,
        name: str,
        identity: str,
        store: LeaseStore,
        lease_duration_s: float = 12.0,
        retry_period_s: float = 2.0,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ):
        self.name = name
        self.identity = identity
        self.store = store
        self.lease_duration_s = lease_duration_s
        self.retry_period_s = retry_period_s
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._leading = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def is_leader(self) -> bool:
        return self._leading and self.store.holder(self.name) == self.identity

    def tick(self) -> bool:
        """One acquire/renew attempt; fires callbacks on transitions.
        Returns current leadership."""
        got = self.store.try_acquire_or_renew(
            self.name, self.identity, self.lease_duration_s)
        if got and not self._leading:
            self._leading = True
            if self.on_started_leading:
                self.on_started_leading()
        elif not got and self._leading:
            self._leading = False
            if self.on_stopped_leading:
                self.on_stopped_leading()
        return self._leading

    def run(self) -> None:
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(self.retry_period_s)
        if self._leading:
            self.store.release(self.name, self.identity)
            self._leading = False
            if self.on_stopped_leading:
                self.on_stopped_leading()

    def start(self) -> "LeaderElector":
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
