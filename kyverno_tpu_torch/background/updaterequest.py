# Copied verbatim from kyverno_tpu/background/updaterequest.py.
"""UpdateRequest — the async work item between admission and the
background controller.

Mirror of api/kyverno/v1beta1/updaterequest_types.go + pkg/background/
update_request_controller.go: admission (or a policy change) enqueues a
UR naming the policy, rule type, and trigger resource; workers process
with bounded retries and Pending -> Completed/Failed status transitions.
State lives in the queue object (the reference persists URs as CRs so
work survives restarts; a persistence hook point is kept here).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

UR_PENDING = "Pending"
UR_COMPLETED = "Completed"
UR_FAILED = "Failed"

MAX_RETRIES = 10  # update_request_controller.go:34


@dataclass
class UpdateRequest:
    policy: str
    rule_type: str              # generate | mutate
    trigger: Dict[str, Any]     # the triggering resource
    operation: str = "CREATE"
    name: str = ""
    status: str = UR_PENDING
    retries: int = 0
    message: str = ""


class UpdateRequestQueue:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._items: List[UpdateRequest] = []
        self._seq = itertools.count(1)

    def add(self, ur: UpdateRequest) -> UpdateRequest:
        with self._lock:
            if not ur.name:
                ur.name = f"ur-{next(self._seq)}"
            self._items.append(ur)
        return ur

    def pending(self) -> List[UpdateRequest]:
        with self._lock:
            return [u for u in self._items if u.status == UR_PENDING]

    def all(self) -> List[UpdateRequest]:
        with self._lock:
            return list(self._items)

    def process(self, handler: Callable[[UpdateRequest], None]) -> int:
        """One reconcile pass: run handler over pending URs; exceptions
        retry up to MAX_RETRIES then mark Failed."""
        done = 0
        for ur in self.pending():
            try:
                handler(ur)
                ur.status = UR_COMPLETED
                ur.message = ""
                done += 1
            except Exception as e:
                ur.retries += 1
                ur.message = str(e)
                if ur.retries >= MAX_RETRIES:
                    ur.status = UR_FAILED
        return done
