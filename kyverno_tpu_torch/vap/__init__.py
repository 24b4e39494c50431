# Copied verbatim from kyverno_tpu/vap/__init__.py.
"""CEL validation + ValidatingAdmissionPolicy evaluation.

Two consumers share this module (mirroring the reference, where both
go through k8s.io/apiserver's cel/validatingadmissionpolicy stack):

- the engine's ``validate.cel`` handler
  (pkg/engine/handlers/validation/validate_cel.go:34) — kyverno rules
  carrying expressions/auditAnnotations/variables + celPreconditions;
- in-process evaluation of ValidatingAdmissionPolicy objects for CLI
  apply and background scans
  (pkg/validatingadmissionpolicy/validate.go:66).
"""

from .validator import CelValidator, ValidationResult
from .generate import (
    VapGenerateController,
    build_vap,
    build_vap_binding,
    can_generate_vap,
)
from .policy import match_constraints_match, validate_vap

__all__ = ["CelValidator", "ValidationResult", "validate_vap",
           "match_constraints_match", "can_generate_vap", "build_vap",
           "build_vap_binding", "VapGenerateController"]
