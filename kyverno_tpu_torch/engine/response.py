# Copied verbatim from kyverno_tpu/engine/response.py.
"""Engine response model.

Mirrors pkg/engine/api: RuleResponse (ruleresponse.go) with
pass/fail/skip/error status, PolicyResponse, EngineResponse
(engineresponse.go). These are the objects every consumer (CLI,
admission, reports, TPU batch evaluator) produces and consumes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

RULE_STATUS_PASS = "pass"
RULE_STATUS_FAIL = "fail"
RULE_STATUS_WARN = "warn"
RULE_STATUS_ERROR = "error"
RULE_STATUS_SKIP = "skip"

RULE_TYPE_VALIDATION = "Validation"
RULE_TYPE_MUTATION = "Mutation"
RULE_TYPE_GENERATION = "Generation"
RULE_TYPE_IMAGE_VERIFY = "ImageVerify"


@dataclass
class RuleResponse:
    name: str
    rule_type: str
    message: str
    status: str
    properties: Dict[str, str] = field(default_factory=dict)
    exceptions: List[str] = field(default_factory=list)
    patched_target: Optional[Dict[str, Any]] = None

    @classmethod
    def rule_pass(cls, name, rule_type, message="", **kw):
        return cls(name, rule_type, message, RULE_STATUS_PASS, **kw)

    @classmethod
    def rule_fail(cls, name, rule_type, message="", **kw):
        return cls(name, rule_type, message, RULE_STATUS_FAIL, **kw)

    @classmethod
    def rule_skip(cls, name, rule_type, message="", **kw):
        return cls(name, rule_type, message, RULE_STATUS_SKIP, **kw)

    @classmethod
    def rule_error(cls, name, rule_type, message="", **kw):
        return cls(name, rule_type, message, RULE_STATUS_ERROR, **kw)

    def is_pass(self) -> bool:
        return self.status == RULE_STATUS_PASS

    def is_fail(self) -> bool:
        return self.status == RULE_STATUS_FAIL


@dataclass
class PolicyResponse:
    rules: List[RuleResponse] = field(default_factory=list)
    stats_processing_time_ns: int = 0

    def add(self, *responses: RuleResponse) -> None:
        self.rules.extend(responses)

    def rules_applied_count(self) -> int:
        return sum(1 for r in self.rules if r.status in (RULE_STATUS_PASS, RULE_STATUS_FAIL))

    def rules_error_count(self) -> int:
        return sum(1 for r in self.rules if r.status == RULE_STATUS_ERROR)


@dataclass
class EngineResponse:
    policy: Any  # ClusterPolicy
    resource: Dict[str, Any]
    policy_response: PolicyResponse = field(default_factory=PolicyResponse)
    patched_resource: Optional[Dict[str, Any]] = None
    namespace_labels: Dict[str, str] = field(default_factory=dict)
    timestamp: float = field(default_factory=time.time)
    # populated by Engine.verify_and_patch_images (engine.go:137)
    image_verification_metadata: Optional[Any] = None

    def is_successful(self) -> bool:
        return not any(
            r.status in (RULE_STATUS_FAIL, RULE_STATUS_ERROR) for r in self.policy_response.rules
        )

    def get_failed_rules(self) -> List[str]:
        return [
            r.name
            for r in self.policy_response.rules
            if r.status in (RULE_STATUS_FAIL, RULE_STATUS_ERROR)
        ]

    def get_validation_failure_action(self) -> str:
        return self.policy.spec.validation_failure_action if self.policy else "Audit"
