# Copied verbatim from kyverno_tpu/vap/validator.py.
"""The CEL validation core shared by validate.cel rules and VAP.

Follows k8s.io/apiserver validating-admission-policy semantics:
matchConditions must ALL hold (an error defers to failure policy),
composited ``variables.*`` evaluate lazily with memoization, each
validation's expression must return true, failure messages come from
messageExpression (must yield a non-empty single-line string) else
message else a generated default, and auditAnnotations produce
string-or-null values."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..cel import CelError, CelSyntaxError, compile as cel_compile


class _LazyVars(dict):
    """variables.<name> — composited variables, evaluated on first
    reference against the same environment (spec.variables may
    reference earlier variables)."""

    def __init__(self, defs: List[Dict[str, str]], env: Dict[str, Any]):
        super().__init__()
        self._defs = {d.get("name", ""): d.get("expression", "") for d in defs}
        self._env = env
        self._evaluating: set = set()

    def __contains__(self, key) -> bool:
        return key in self._defs or dict.__contains__(self, key)

    def __getitem__(self, key):
        if not dict.__contains__(self, key):
            if key not in self._defs:
                raise CelError(f"undeclared variable 'variables.{key}'")
            if key in self._evaluating:
                # k8s rejects self/forward references at compile time;
                # surface cycles as a CEL error, not RecursionError
                raise CelError(f"cyclic reference in variables.{key}")
            self._evaluating.add(key)
            try:
                value = cel_compile(self._defs[key]).evaluate(self._env)
            finally:
                self._evaluating.discard(key)
            dict.__setitem__(self, key, value)
        return dict.__getitem__(self, key)


@dataclass
class ValidationResult:
    status: str          # pass | fail | error | skip (match conditions)
    message: str = ""
    reason: str = ""
    audit_annotations: Dict[str, str] = field(default_factory=dict)
    index: int = -1      # validation index (-1 for rule-level outcomes)


class CelValidator:
    def __init__(
        self,
        validations: List[Dict[str, Any]],
        match_conditions: Optional[List[Dict[str, str]]] = None,
        variables: Optional[List[Dict[str, str]]] = None,
        audit_annotations: Optional[List[Dict[str, str]]] = None,
        default_message: str = "",
    ):
        self.validations = validations or []
        self.match_conditions = match_conditions or []
        self.variables = variables or []
        self.audit_annotations = audit_annotations or []
        self.default_message = default_message
        # compile eagerly: malformed expressions are compile-time
        # failures, reported once (celutils.NewCompiler)
        self.compile_error: Optional[str] = None
        try:
            for v in self.validations:
                cel_compile(v.get("expression", ""))
                if v.get("messageExpression"):
                    cel_compile(v["messageExpression"])
            for mc in self.match_conditions:
                cel_compile(mc.get("expression", ""))
            for var in self.variables:
                cel_compile(var.get("expression", ""))
            for aa in self.audit_annotations:
                cel_compile(aa.get("valueExpression", ""))
        except (CelSyntaxError, CelError) as e:
            self.compile_error = str(e)

    def _env(self, object, old_object, request, params, namespace_object):
        env: Dict[str, Any] = {
            "object": object,
            "oldObject": old_object if old_object else None,
            "request": request or {},
            "params": params,
            "namespaceObject": namespace_object,
        }
        env["variables"] = _LazyVars(self.variables, env)
        return env

    def matches(self, object=None, old_object=None, request=None,
                params=None, namespace_object=None):
        """Evaluate matchConditions; (matched, error_message)."""
        if self.compile_error:
            return False, self.compile_error
        env = self._env(object, old_object, request, params, namespace_object)
        for mc in self.match_conditions:
            try:
                out = cel_compile(mc.get("expression", "")).evaluate(env)
            except CelError as e:
                return False, f"matchCondition '{mc.get('name', '')}': {e}"
            if out is not True:
                return False, ""
        return True, ""

    def validate(self, object=None, old_object=None, request=None,
                 params=None, namespace_object=None) -> List[ValidationResult]:
        if self.compile_error:
            return [ValidationResult("error", self.compile_error)]
        matched, err = self.matches(object, old_object, request, params,
                                    namespace_object)
        if err:
            return [ValidationResult("error", err)]
        if not matched:
            return [ValidationResult("skip", "match conditions not met")]
        env = self._env(object, old_object, request, params, namespace_object)
        results: List[ValidationResult] = []
        for i, v in enumerate(self.validations):
            expr = v.get("expression", "")
            try:
                out = cel_compile(expr).evaluate(env)
            except CelError as e:
                results.append(ValidationResult(
                    "error", f"expression '{expr}' resulted in error: {e}",
                    index=i))
                continue
            if out is True:
                results.append(ValidationResult("pass", index=i))
                continue
            if out is not False:
                results.append(ValidationResult(
                    "error",
                    f"expression '{expr}' must return bool, got {out!r}",
                    index=i))
                continue
            results.append(ValidationResult(
                "fail", self._failure_message(v, env),
                reason=v.get("reason", "Invalid"), index=i))
        if results and all(r.status == "pass" for r in results):
            aa = self._audit_annotations(env)
            if aa:
                results[0].audit_annotations = aa
        else:
            for r in results:
                if r.status == "fail":
                    r.audit_annotations = self._audit_annotations(env)
                    break
        return results

    def _failure_message(self, v: Dict[str, Any], env) -> str:
        # messageExpression > message > generated default
        # (k8s: messageExpression errors/empty/newline fall back)
        me = v.get("messageExpression")
        if me:
            try:
                out = cel_compile(me).evaluate(env)
                if isinstance(out, str) and out.strip() and "\n" not in out:
                    return out
            except CelError:
                pass
        if v.get("message"):
            return str(v["message"])
        if self.default_message:
            return self.default_message
        expr = v.get("expression", "")
        if len(expr) > 100:
            expr = expr[:100] + "..."
        return f"failed expression: {expr}"

    def _audit_annotations(self, env) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for aa in self.audit_annotations:
            key = aa.get("key", "")
            try:
                val = cel_compile(aa.get("valueExpression", "")).evaluate(env)
            except CelError:
                continue
            if isinstance(val, str):
                out[key] = val
            # null => annotation omitted (k8s semantics)
        return out
