# Copied verbatim from kyverno_tpu/engine/engine.py.
"""The engine facade — per-policy orchestration.

Re-implementation of pkg/engine/engine.go + the validation and
mutation handlers (pkg/engine/handlers/validation/validate_resource.go,
pkg/engine/handlers/mutation/*, pkg/engine/mutation.go):

per rule: match/exclude gate → context-entry loading (deferred) →
preconditions → handler, with JSON-context checkpoint/restore around
each rule (engine.go:258-266) so rule-scoped variables don't leak.

This scalar engine is the oracle; ``kyverno_tpu.tpu`` compiles the
same policies into batched device programs and is parity-tested
against it.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

from ..api.policy import ClusterPolicy, Rule

from . import mutate as mutatepkg
from . import validate as validatepkg
from .conditions import evaluate_conditions
from .context import Context, ContextEntryError, InvalidVariableError
from .contextloaders import ContextLoaderError, DataSources, load_context_entries
from .match import matches_resource_description
from .policycontext import PolicyContext
from .response import (
    RULE_TYPE_IMAGE_VERIFY,
    RULE_TYPE_MUTATION,
    RULE_TYPE_VALIDATION,
    EngineResponse,
    PolicyResponse,
    RuleResponse,
)
from .variables import (
    SubstitutionError,
    precondition_resolver,
    substitute_all,
    substitute_all_in_preconditions,
)


class Engine:
    """engineapi.Engine equivalent (pkg/engine/api/engine.go:17)."""

    def __init__(self, data_sources: Optional[DataSources] = None,
                 exceptions: Optional[list] = None, background: bool = False):
        self.data_sources = data_sources or DataSources()
        self.exceptions = exceptions or []
        # background scans ignore exceptions with spec.background=false
        # (policy_exception_types.go:41-44)
        self.background = background

    # -- public API

    def validate(self, pctx: PolicyContext) -> EngineResponse:
        response = EngineResponse(
            policy=pctx.policy,
            resource=pctx.new_resource,
            namespace_labels=pctx.namespace_labels,
        )
        for rule in pctx.policy.get_rules():
            if rule.has_validate():
                rr = self._invoke_rule(pctx, rule, self._validate_rule)
            elif rule.has_verify_images():
                # verifyImages rules with digest/required checks also
                # run in the validate stage without registry access
                # (validation.go HasVerifyImageChecks branch →
                # handlers/validation/validate_image.go)
                from ..images import has_verify_image_checks

                if not has_verify_image_checks(rule.verify_images):
                    continue
                rr = self._invoke_rule(pctx, rule, self._validate_image_checks)
            else:
                continue
            if rr is not None:
                response.policy_response.add(*rr)
        return response

    def mutate(self, pctx: PolicyContext) -> EngineResponse:
        patched = copy.deepcopy(pctx.new_resource)
        response = EngineResponse(
            policy=pctx.policy,
            resource=pctx.new_resource,
            namespace_labels=pctx.namespace_labels,
        )
        for rule in pctx.policy.get_rules():
            if not rule.has_mutate():
                continue
            pctx.new_resource = patched
            pctx.json_context.add_resource(patched)
            rr = self._invoke_rule(pctx, rule, self._mutate_rule)
            if rr is not None:
                response.policy_response.add(*rr)
                for r in rr:
                    if r.patched_target is not None:
                        patched = r.patched_target
        response.patched_resource = patched
        return response

    def apply_background_checks(self, pctx: PolicyContext) -> EngineResponse:
        """Background scans evaluate validate rules with empty
        admission info (engine.go ApplyBackgroundChecks)."""
        return self.validate(pctx)

    def verify_and_patch_images(
        self,
        pctx: PolicyContext,
        registry_client=None,
        iv_cache=None,
    ) -> EngineResponse:
        """engine.go:137 VerifyAndPatchImages: run verifyImages rules,
        apply digest patches + the verify-images annotation patch to the
        resource. The ImageVerificationMetadata rides on the response as
        ``image_verification_metadata``."""
        from ..images import (
            BadImageError,
            ImageVerificationMetadata,
            Verifier,
            extract_images,
        )
        from ..images.verify import image_references, matches_references
        from .mutate import apply_json6902

        response = EngineResponse(
            policy=pctx.policy,
            resource=pctx.new_resource,
            namespace_labels=pctx.namespace_labels,
        )
        patched = copy.deepcopy(pctx.new_resource)
        ivm = ImageVerificationMetadata()
        for rule in pctx.policy.get_rules():
            if not rule.has_verify_images():
                continue

            def handler(p, r, _ivm=ivm, _registry=registry_client, _cache=iv_cache):
                nonlocal patched
                try:
                    extracted = extract_images(
                        patched, r.image_extractors)
                except BadImageError as e:
                    return [RuleResponse.rule_error(
                        r.name, RULE_TYPE_IMAGE_VERIFY, str(e))]
                images = [info for group in extracted.values()
                          for info in group.values()]
                out: List[RuleResponse] = []
                verifier = Verifier(
                    policy=p.policy, rule_name=r.name,
                    registry_client=_registry, cache=_cache, ivm=_ivm,
                    context=p.json_context, old_resource=p.old_resource)
                for iv in r.verify_images or []:
                    refs = image_references(iv)
                    matched = [i for i in images
                               if matches_references(refs, str(i))]
                    patches, rrs = verifier.verify(iv, matched, patched)
                    if patches:
                        patched = apply_json6902(patched, patches)
                    out.extend(rrs)
                return out

            rr = self._invoke_rule(pctx, rule, handler)
            if rr is not None:
                response.policy_response.add(*rr)
        ann_patch = ivm.annotation_patch(patched)
        if ann_patch is not None and response.policy_response.rules_applied_count() > 0:
            patched = apply_json6902(patched, [ann_patch])
        response.patched_resource = patched
        response.image_verification_metadata = ivm
        return response

    # -- rule plumbing

    @staticmethod
    def _rule_type(rule: Rule) -> str:
        if rule.has_validate():
            return RULE_TYPE_VALIDATION
        if rule.has_verify_images():
            return RULE_TYPE_IMAGE_VERIFY
        return RULE_TYPE_MUTATION

    def _invoke_rule(self, pctx: PolicyContext, rule: Rule, handler) -> Optional[List[RuleResponse]]:
        # match/exclude gate (engine.go:190)
        reasons = matches_resource_description(
            pctx.resource_for_match(),
            rule,
            pctx.admission_info,
            pctx.namespace_labels,
            pctx.policy.namespace,
            gvk=pctx.gvk,
            subresource=pctx.subresource,
            operation=pctx.operation,
        )
        if reasons:
            return None
        # exception gate (engine.go:287, exceptions.go)
        matched_exceptions = self._matching_exceptions(pctx, rule, self.background)
        if matched_exceptions:
            names = ", ".join(matched_exceptions)
            rtype = self._rule_type(rule)
            return [
                RuleResponse.rule_skip(
                    rule.name, rtype, f"rule is skipped due to policy exception {names}",
                    exceptions=matched_exceptions,
                )
            ]
        # checkpoint/restore isolation (engine.go:258-266)
        ctx = pctx.json_context
        ctx.checkpoint()
        try:
            rtype = self._rule_type(rule)
            try:
                load_context_entries(ctx, rule.context, self.data_sources)
            except ContextLoaderError as e:
                return [RuleResponse.rule_error(rule.name, rtype, f"failed to load context: {e}")]
            # preconditions (engine.go:278)
            try:
                if not evaluate_conditions(ctx, rule.preconditions):
                    return [RuleResponse.rule_skip(rule.name, rtype, "preconditions not met")]
            except (SubstitutionError, InvalidVariableError) as e:
                return [RuleResponse.rule_error(rule.name, rtype, f"preconditions error: {e}")]
            return handler(pctx, rule)
        except ContextEntryError as e:
            rtype = self._rule_type(rule)
            return [RuleResponse.rule_error(rule.name, rtype, str(e))]
        finally:
            ctx.restore()

    def _typed_exceptions(self):
        """Exceptions parsed once (they arrive as dicts from YAML/CR
        watches); cached on the engine instance. Keyed by list identity
        AND element identities: the list id catches a swapped list whose
        freed elements were reallocated at the old addresses, the
        element ids catch in-place replacement (`exceptions[i] = new`)
        by a watch handler sharing the list with this engine."""
        key = (id(self.exceptions), tuple(id(e) for e in self.exceptions))
        cached = getattr(self, "_typed_exc_cache", None)
        if cached is None or cached[0] != key:
            from ..api.exception import PolicyException

            typed = [e if isinstance(e, PolicyException)
                     else PolicyException.from_dict(e)
                     for e in self.exceptions]
            self._typed_exc_cache = (key, typed)
        return self._typed_exc_cache[1]

    def _exception_applies(self, exc, pctx: PolicyContext, rule: Rule,
                           background: bool) -> bool:
        """engine/utils/exceptions.go:13 MatchesException: the exception
        must name the rule (wildcards allowed), its match block must
        select the resource, and its conditions tree must hold against
        the JSON context. Exceptions with spec.background=false are
        ignored during background scans."""
        if background and not exc.background:
            return False
        if not exc.contains(pctx.policy.name, rule.name):
            return False
        if exc.match:
            pseudo = Rule.from_dict({"name": "exception", "match": exc.match})
            if matches_resource_description(
                pctx.resource_for_match(),
                pseudo,
                pctx.admission_info,
                pctx.namespace_labels,
                operation=pctx.operation,
            ):
                return False
        if exc.conditions is not None:
            try:
                if not evaluate_conditions(pctx.json_context, exc.conditions):
                    return False
            except Exception:
                # condition errors disqualify the exception
                # (exceptions.go:36-41 returns nil on error)
                return False
        return True

    def _matching_exceptions(self, pctx: PolicyContext, rule: Rule,
                             background: bool = False) -> List[str]:
        out = []
        for exc in self._typed_exceptions():
            if not self._exception_applies(exc, pctx, rule, background):
                continue
            # podSecurity exceptions against podSecurity rules apply
            # control-level exclusions instead of skipping the rule
            # (validate_pss.go HasPodSecurity branch)
            if (exc.has_pod_security() and rule.validation is not None
                    and rule.validation.pod_security is not None):
                continue
            out.append(exc.name or "exception")
        return out

    def _pod_security_exclusions(self, pctx: PolicyContext, rule: Rule) -> List[Dict[str, Any]]:
        """podSecurity controls from matching exceptions, merged into
        the rule's own excludes (validate_pss.go exception handling).
        The exception must fully apply (match + conditions +
        background), same gate as a rule-skipping exception."""
        out: List[Dict[str, Any]] = []
        for exc in self._typed_exceptions():
            if not exc.has_pod_security():
                continue
            if self._exception_applies(exc, pctx, rule, self.background):
                out.extend(exc.pod_security)
        return out

    # -- validation handler (validate_resource.go)

    def _validate_rule(self, pctx: PolicyContext, rule: Rule) -> List[RuleResponse]:
        v = rule.validation
        ctx = pctx.json_context
        name = rule.name

        if v.deny is not None:
            return [self._validate_deny(ctx, name, rule)]
        if v.pattern is not None or v.any_pattern is not None:
            return [self._validate_patterns(ctx, name, rule, pctx.new_resource)]
        if v.foreach is not None:
            return [self._validate_foreach(pctx, name, rule)]
        if v.pod_security is not None:
            from ..pss import validate_pod_security

            return [validate_pod_security(
                name, v, pctx.new_resource,
                extra_exclusions=self._pod_security_exclusions(pctx, rule))]
        if v.cel is not None:
            return [self._validate_cel(pctx, name, rule)]
        if v.manifests is not None:
            return [self._validate_manifests(pctx, name, rule)]
        return [RuleResponse.rule_error(name, RULE_TYPE_VALIDATION, "invalid validation rule")]

    def _validate_manifests(self, pctx: PolicyContext, name: str, rule: Rule) -> RuleResponse:
        """validate.manifests handler (validate_manifest.go:53 Process):
        signed-YAML verification; DELETE requests are skipped like the
        reference's nil handler (NewValidateManifestHandler:45)."""
        from .manifests import ManifestVerificationError, verify_manifest

        if pctx.operation == "DELETE" and not pctx.new_resource:
            return RuleResponse.rule_skip(
                name, RULE_TYPE_VALIDATION, "manifest verification skipped on delete")
        try:
            verified, reason = verify_manifest(
                pctx.new_resource, rule.validation.manifests or {})
        except ManifestVerificationError as e:
            return RuleResponse.rule_error(
                name, RULE_TYPE_VALIDATION,
                f"error occurred during manifest verification: {e}")
        if not verified:
            return RuleResponse.rule_fail(name, RULE_TYPE_VALIDATION, reason)
        return RuleResponse.rule_pass(name, RULE_TYPE_VALIDATION, reason)

    def _validate_image_checks(self, pctx: PolicyContext, rule: Rule) -> List[RuleResponse]:
        """validate-side verifyImages checks (validate_image.go:41):
        digest presence + verified-annotation lookups, no registry."""
        from ..images import BadImageError, extract_images, validate_image_rule

        if pctx.operation == "DELETE" and not pctx.new_resource:
            return []
        try:
            extracted = extract_images(pctx.new_resource, rule.image_extractors)
        except BadImageError as e:
            return [RuleResponse.rule_error(
                rule.name, RULE_TYPE_VALIDATION, str(e))]
        images = [info for group in extracted.values()
                  for info in group.values()]
        if not images:
            return []  # no images => handler not created (nil, nil)
        return validate_image_rule(rule.verify_images or [], rule.name,
                                   images, pctx.new_resource)

    def _validate_cel(self, pctx: PolicyContext, name: str, rule: Rule) -> RuleResponse:
        """validate.cel handler (validate_cel.go:40 Process): CEL
        expressions + composited variables + audit annotations, gated
        by celPreconditions (matchConditions)."""
        from ..vap import CelValidator

        if pctx.operation == "DELETE" and not pctx.new_resource:
            return RuleResponse.rule_skip(
                name, RULE_TYPE_VALIDATION, "skipped CEL validation on deleted resource")
        cel_spec = rule.validation.cel or {}
        validator = CelValidator(
            validations=cel_spec.get("expressions") or [],
            match_conditions=rule.cel_preconditions or [],
            variables=cel_spec.get("variables") or [],
            audit_annotations=cel_spec.get("auditAnnotations") or [],
            default_message=rule.validation.message or "",
        )
        meta = pctx.new_resource.get("metadata") or {}
        request = {
            "operation": pctx.operation,
            "name": meta.get("name", ""),
            "namespace": meta.get("namespace", ""),
            "kind": {"kind": pctx.new_resource.get("kind", "")},
            "userInfo": {
                "username": pctx.admission_info.username,
                "uid": pctx.admission_info.uid,
                "groups": list(pctx.admission_info.groups),
            },
        }
        ns_object = None
        ns_name = meta.get("namespace", "")
        if ns_name and pctx.namespace_labels:
            ns_object = {"metadata": {"name": ns_name,
                                      "labels": dict(pctx.namespace_labels)}}
        results = validator.validate(
            object=pctx.new_resource,
            old_object=pctx.old_resource or None,
            request=request,
            namespace_object=ns_object,
        )
        errors = [r for r in results if r.status == "error"]
        if errors:
            return RuleResponse.rule_error(
                name, RULE_TYPE_VALIDATION, "; ".join(r.message for r in errors))
        fails = [r for r in results if r.status == "fail"]
        if fails:
            return RuleResponse.rule_fail(
                name, RULE_TYPE_VALIDATION, "; ".join(r.message for r in fails))
        if results and all(r.status == "skip" for r in results):
            return RuleResponse.rule_skip(
                name, RULE_TYPE_VALIDATION, results[0].message)
        return RuleResponse.rule_pass(name, RULE_TYPE_VALIDATION, "")

    def _message(self, ctx: Context, rule: Rule, default: str = "") -> str:
        msg = rule.validation.message if rule.validation else ""
        if not msg:
            return default
        try:
            return str(substitute_all(ctx, msg, precondition_resolver))
        except SubstitutionError:
            return msg

    def _validate_deny(self, ctx: Context, name: str, rule: Rule) -> RuleResponse:
        deny = rule.validation.deny or {}
        try:
            denied = evaluate_conditions(ctx, deny.get("conditions"))
        except (SubstitutionError, InvalidVariableError) as e:
            return RuleResponse.rule_error(name, RULE_TYPE_VALIDATION, f"deny conditions error: {e}")
        if denied:
            return RuleResponse.rule_fail(
                name, RULE_TYPE_VALIDATION, self._message(ctx, rule, "access denied")
            )
        return RuleResponse.rule_pass(name, RULE_TYPE_VALIDATION, "")

    def _validate_patterns(
        self, ctx: Context, name: str, rule: Rule, resource: Dict[str, Any]
    ) -> RuleResponse:
        v = rule.validation
        if v.pattern is not None:
            try:
                pattern = substitute_all(ctx, v.pattern)
            except SubstitutionError as e:
                return RuleResponse.rule_error(name, RULE_TYPE_VALIDATION, str(e))
            err = validatepkg.match_pattern(resource, pattern)
            if err is None:
                return RuleResponse.rule_pass(name, RULE_TYPE_VALIDATION, "")
            if err.skip:
                return RuleResponse.rule_skip(name, RULE_TYPE_VALIDATION, "rule not applicable")
            msg = self._message(ctx, rule, "validation failed")
            if err.path:
                msg = f"{msg} at path {err.path}" if msg else f"validation error at path {err.path}"
            return RuleResponse.rule_fail(name, RULE_TYPE_VALIDATION, msg)
        # anyPattern (validate_resource.go:382-440)
        skips = 0
        fails = []
        for i, pat in enumerate(v.any_pattern or []):
            try:
                pattern = substitute_all(ctx, pat)
            except SubstitutionError as e:
                return RuleResponse.rule_error(name, RULE_TYPE_VALIDATION, str(e))
            err = validatepkg.match_pattern(resource, pattern)
            if err is None:
                return RuleResponse.rule_pass(name, RULE_TYPE_VALIDATION, "")
            if err.skip:
                skips += 1
            else:
                fails.append(f"pattern {i}: {err.path or err.message}")
        if skips and not fails:
            return RuleResponse.rule_skip(name, RULE_TYPE_VALIDATION, "rule not applicable")
        msg = self._message(ctx, rule, "no pattern matched")
        return RuleResponse.rule_fail(name, RULE_TYPE_VALIDATION, f"{msg} ({'; '.join(fails)})")

    def _validate_foreach(self, pctx: PolicyContext, name: str, rule: Rule) -> RuleResponse:
        # validate_resource.go:187-202: per-element apply counts sum
        # across foreach entries; zero applied elements => skip
        applied = 0
        for fe in rule.validation.foreach or []:
            result, count = self._run_foreach(pctx, name, rule, fe, nesting=0)
            if result is not None:
                return result
            applied += count
        if applied == 0:
            return RuleResponse.rule_skip(name, RULE_TYPE_VALIDATION, "foreach not applied")
        return RuleResponse.rule_pass(name, RULE_TYPE_VALIDATION, "")

    def _run_foreach(
        self, pctx: PolicyContext, name: str, rule: Rule, fe: Dict[str, Any], nesting: int
    ):
        """One foreach entry (validateForEach + validateElements,
        validate_resource.go:186-252). Returns (fail/error response or
        None, applied element count). List-evaluation failures skip the
        entry entirely (:190-193 `continue`); per-element ERRORS are
        dropped unless the element is the LAST one (:239-246)."""
        ctx = pctx.json_context
        list_expr = fe.get("list", "")
        try:
            elements = ctx.query(substitute_all(ctx, list_expr, precondition_resolver))
        except (InvalidVariableError, SubstitutionError):
            return None, 0  # EvaluateList error => entry skipped
        if elements is None:
            return None, 0  # nothing to iterate
        if isinstance(elements, dict):
            elements = [{"key": k, "value": v} for k, v in elements.items()]
        if not isinstance(elements, list):
            return None, 0
        applied = 0
        # elementScope is tri-state (utils/foreach.go:41-56): default =
        # scoped iff the element is a map; an explicit true on a
        # non-map element is a rule ERROR; explicit false disables.
        element_scope = fe.get("elementScope")
        last = len(elements) - 1
        for i, element in enumerate(elements):
            if element is None:
                continue  # validate_resource.go:212 skips nil elements
            if element_scope is True and not isinstance(element, dict):
                # AddElementToContext failure: immediate rule error
                # (validateElements:218-221)
                return (
                    RuleResponse.rule_error(
                        name, RULE_TYPE_VALIDATION,
                        "cannot use elementScope=true foreach rules for "
                        f"elements that are not maps, got {type(element).__name__}"),
                    applied,
                )
            ctx.checkpoint()
            try:
                rr = self._foreach_element(pctx, name, rule, fe, element, i, nesting)
            finally:
                ctx.restore()
            if rr is None or rr.status == "skip":
                continue
            if rr.status == "error":
                if i < last:
                    continue  # non-final element errors are dropped
                rr.message = f"validation failure: {rr.message}"
                return rr, applied
            if rr.is_fail():
                return rr, applied
            applied += 1
        return None, applied

    def _foreach_element(
        self, pctx: PolicyContext, name: str, rule: Rule, fe: Dict[str, Any],
        element: Any, i: int, nesting: int
    ) -> Optional[RuleResponse]:
        """One element through the nested validator (newForEachValidator
        -> validator.validate): context -> preconditions -> deny/pattern/
        nested-foreach. None = not applied (a nested foreach with zero
        applications)."""
        ctx = pctx.json_context
        try:
            load_context_entries(ctx, fe.get("context") or [], self.data_sources)
        except ContextLoaderError as e:
            return RuleResponse.rule_error(name, RULE_TYPE_VALIDATION, str(e))
        ctx.add_element(element, i, nesting)
        try:
            if not evaluate_conditions(ctx, fe.get("preconditions")):
                return RuleResponse.rule_skip(
                    name, RULE_TYPE_VALIDATION, "preconditions not met")
        except (SubstitutionError, InvalidVariableError) as e:
            return RuleResponse.rule_error(name, RULE_TYPE_VALIDATION, str(e))
        element_scope = fe.get("elementScope")
        scoped = (isinstance(element, dict) if element_scope is None
                  else element_scope)
        target = element if scoped and isinstance(element, dict) else pctx.new_resource
        if fe.get("deny") is not None:
            try:
                denied = evaluate_conditions(ctx, fe["deny"].get("conditions"))
            except (SubstitutionError, InvalidVariableError) as e:
                return RuleResponse.rule_error(name, RULE_TYPE_VALIDATION, str(e))
            if denied:
                return RuleResponse.rule_fail(
                    name, RULE_TYPE_VALIDATION,
                    self._message(ctx, rule, f"denied at element {i}"))
            return RuleResponse.rule_pass(name, RULE_TYPE_VALIDATION, "")
        if fe.get("pattern") is not None or fe.get("anyPattern") is not None:
            pseudo = Rule.from_dict(
                {
                    "name": name,
                    "validate": {
                        "message": rule.validation.message,
                        "pattern": fe.get("pattern"),
                        "anyPattern": fe.get("anyPattern"),
                    },
                }
            )
            rr = self._validate_patterns(ctx, name, pseudo, target)
            if rr.is_fail() or rr.status == "error":
                rr.message = f"{rr.message} (element {i})"
            return rr
        if fe.get("foreach") is not None:
            applied = 0
            for nested in fe["foreach"]:
                result, count = self._run_foreach(pctx, name, rule, nested, nesting + 1)
                if result is not None:
                    return result
                applied += count
            if applied == 0:
                return None
            return RuleResponse.rule_pass(name, RULE_TYPE_VALIDATION, "")
        return None

    # -- mutation handler (mutate_resource.go, mutation.go)

    def _mutate_rule(self, pctx: PolicyContext, rule: Rule) -> List[RuleResponse]:
        m = rule.mutation or {}
        ctx = pctx.json_context
        name = rule.name
        patched = copy.deepcopy(pctx.new_resource)
        try:
            if m.get("patchStrategicMerge") is not None:
                overlay = substitute_all(ctx, m["patchStrategicMerge"])
                patched = mutatepkg.strategic_merge(patched, overlay)
            elif m.get("patchesJson6902") is not None:
                patches = mutatepkg.load_json6902(m["patchesJson6902"])
                patches = substitute_all(ctx, patches)
                patched = mutatepkg.apply_json6902(patched, patches)
            elif m.get("foreach") is not None:
                for fe in m["foreach"]:
                    patched = self._mutate_foreach(pctx, rule, fe, patched)
                    if patched is None:
                        return [
                            RuleResponse.rule_error(name, RULE_TYPE_MUTATION, "foreach mutate failed")
                        ]
            else:
                return [RuleResponse.rule_skip(name, RULE_TYPE_MUTATION, "no patch specified")]
        except (SubstitutionError, mutatepkg.PatchError) as e:
            return [RuleResponse.rule_error(name, RULE_TYPE_MUTATION, str(e))]
        if patched == pctx.new_resource:
            return [RuleResponse.rule_skip(name, RULE_TYPE_MUTATION, "no changes")]
        return [
            RuleResponse.rule_pass(name, RULE_TYPE_MUTATION, "mutated", patched_target=patched)
        ]

    def _mutate_foreach(
        self, pctx: PolicyContext, rule: Rule, fe: Dict[str, Any], patched: Dict[str, Any]
    ) -> Optional[Dict[str, Any]]:
        ctx = pctx.json_context
        try:
            elements = ctx.query(substitute_all(ctx, fe.get("list", ""), precondition_resolver))
        except (InvalidVariableError, SubstitutionError):
            return None
        if not isinstance(elements, list):
            return patched
        for i, element in enumerate(elements):
            if element is None:
                continue  # mutation/common.go:83 skips nil elements
            ctx.checkpoint()
            try:
                ctx.add_element(element, i)
                try:
                    if not evaluate_conditions(ctx, fe.get("preconditions")):
                        continue
                except (SubstitutionError, InvalidVariableError):
                    return None
                ctx.add_resource(patched)
                if fe.get("patchStrategicMerge") is not None:
                    overlay = substitute_all(ctx, fe["patchStrategicMerge"])
                    patched = mutatepkg.strategic_merge(patched, overlay)
                elif fe.get("patchesJson6902") is not None:
                    patches = mutatepkg.load_json6902(fe["patchesJson6902"])
                    patches = substitute_all(ctx, patches)
                    patched = mutatepkg.apply_json6902(patched, patches)
            except (SubstitutionError, mutatepkg.PatchError):
                return None
            finally:
                ctx.restore()
        return patched
