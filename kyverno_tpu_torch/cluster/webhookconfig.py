# Copied verbatim from kyverno_tpu/cluster/webhookconfig.py.
"""Webhook-configuration generation from the live policy set.

Mirrors pkg/controllers/webhook/controller.go: the served webhook
surface is derived from the policies in the cache — one webhook per
failurePolicy class (Ignore -> /validate/ignore fails open, Fail ->
/validate/fail fails closed, controller.go:851-881), plus fine-grained
per-policy webhooks for policies annotated with a custom webhook
configuration; rules merge each policy's matched kinds into
(group, version) -> resource sets with wildcard support
(utils.go:23 webhook struct, :76 buildRulesWithOperations). Reconcile
runs on policy-cache revision changes; the produced configuration
dicts are *Validating/MutatingWebhookConfiguration*-shaped and are
handed to a pluggable sink (in-memory for tests, a k8s client in a
cluster)."""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..api.policy import ClusterPolicy
from ..vap.policy import kind_to_resource
from .policycache import PolicyCache

DEFAULT_TIMEOUT = 10  # seconds — webhook/controller.go:52

# group resolution for the built-in kinds (no discovery offline)
_KIND_GROUPS = {
    "Deployment": "apps", "DaemonSet": "apps", "StatefulSet": "apps",
    "ReplicaSet": "apps", "Job": "batch", "CronJob": "batch",
    "Ingress": "networking.k8s.io", "NetworkPolicy": "networking.k8s.io",
    "Role": "rbac.authorization.k8s.io",
    "RoleBinding": "rbac.authorization.k8s.io",
    "ClusterRole": "rbac.authorization.k8s.io",
    "ClusterRoleBinding": "rbac.authorization.k8s.io",
    "HorizontalPodAutoscaler": "autoscaling",
    "PodDisruptionBudget": "policy",
    "CustomResourceDefinition": "apiextensions.k8s.io",
}

# the single source of truth for builtin cluster-scoped kinds, shared
# by webhook scope resolution, policy validation's discovery stand-in
# and report placement
_CLUSTER_KINDS = {"Namespace", "Node", "PersistentVolume", "ClusterRole",
                  "ClusterRoleBinding", "CustomResourceDefinition",
                  "StorageClass", "PriorityClass",
                  "CertificateSigningRequest", "IngressClass",
                  "RuntimeClass", "VolumeAttachment", "APIService",
                  "MutatingWebhookConfiguration",
                  "ValidatingWebhookConfiguration"}

FINE_GRAINED_ANNOTATION = "kyverno.io/custom-webhook-configuration"
MANAGED_BY_LABEL = "webhook.kyverno.io/managed-by"


# the subresources the apiserver serves for pods (discovery expands
# 'Pod/*' to these, cf. pod-all-subresources conformance scenario)
_POD_SUBRESOURCES = ("attach", "binding", "ephemeralcontainers", "eviction",
                     "exec", "log", "portforward", "proxy", "status")


def _parse_kind(kind: str, policy_scope: str = "*") -> Tuple[str, str, List[str], str]:
    """Kind selector -> (group, version, [resource-plurals], scope),
    reusing the engine's ParseKindSelector port (utils/kube.py) so
    'Pod/exec', 'apps/v1/Deployment', 'v1/Pod' and dotted subresource
    forms all resolve consistently. Mirrors mergeWebhook
    (controller.go:966-1018): known kinds resolve their served version
    and scope the way discovery would (Namespaced for namespaced
    resources, all-scopes otherwise); wildcard kinds take the policy's
    scope; 'Kind/*' expands to the kind's served subresources."""
    from ..utils.kube import parse_kind_selector
    from ..vap.policy import _PLURALS

    g, v, k, sub = parse_kind_selector(kind)
    if k == "*":
        resources = [f"*/{sub}"] if sub else ["*"]
    else:
        plural = kind_to_resource(k)
        if sub == "*":
            subs = _POD_SUBRESOURCES if k == "Pod" else ("*",)
            resources = [f"{plural}/{s}" for s in subs]
        elif sub:
            resources = [f"{plural}/{sub}"]
        else:
            resources = [plural]
    if g == "*" and k != "*":
        # bare kinds resolve their group from the builtin table (core
        # group otherwise); explicit groups pass through
        g = _KIND_GROUPS.get(k, "")
    if v == "*" and k in _PLURALS:
        v = "v1"  # the served version every builtin kind resolves to
    if k == "*":
        scope = policy_scope  # controller.go:991 policy scope
    elif g == "*":
        scope = "*"
    elif k in _CLUSTER_KINDS:
        scope = "*"  # discovery: non-namespaced -> AllScopes
    else:
        scope = "Namespaced"
    return g, v, resources, scope


_ALL_OPS = ("CREATE", "UPDATE", "DELETE", "CONNECT")
_MUTATE_DEFAULT_OPS = ("CREATE", "UPDATE")


def _rule_operations(rule, default_ops: Sequence[str]) -> Set[str]:
    """computeOperationsFor*WebhookConf (utils.go:214,259): operations
    declared anywhere in the rule's match blocks; the class default when
    none are declared; exclude-block operations knocked out."""
    ops: Dict[str, bool] = {}
    found = False
    blocks = [rule.match.resources] + [
        rf.resources for rf in (rule.match.any or []) + (rule.match.all or [])]
    for block in blocks:
        for o in (block.operations or []):
            ops[o] = True
            found = True
    if not found:
        for o in default_ops:
            ops[o] = True
    ex_blocks = [rule.exclude.resources] + [
        rf.resources
        for rf in (rule.exclude.any or []) + (rule.exclude.all or [])]
    for block in ex_blocks:
        for o in (block.operations or []):
            ops[o] = False
    return {o for o, on in ops.items() if on}


def _policy_kind_ops(policy: ClusterPolicy, kinds_filter,
                     default_ops: Sequence[str]) -> Dict[str, Set[str]]:
    """kind selector -> union of required operations across the
    policy's rules (addOpnFor*WebhookConf, controller.go:810-836)."""
    out: Dict[str, Set[str]] = {}
    for rule in policy.get_rules():
        if not kinds_filter(rule):
            continue
        ops = _rule_operations(rule, default_ops)
        kinds: Set[str] = set(rule.match.resources.kinds or [])
        for rf in (rule.match.any or []) + (rule.match.all or []):
            kinds.update(rf.resources.kinds or [])
        if rule.has_generate():
            # generate targets are watched too (mergeWebhook,
            # controller.go:970-976)
            gen = rule.generation or {}
            if gen.get("kind"):
                kinds.add(gen["kind"])
            for cl in (gen.get("cloneList") or {}).get("kinds") or []:
                kinds.add(cl)
        for k in kinds:
            out.setdefault(k, set()).update(ops)
    return out


class Webhook:
    """utils.go:23 — rule aggregation per failurePolicy class, with
    per-kind operation requirements (mapResourceToOpnType)."""

    def __init__(self, failure_policy: str, timeout: int = DEFAULT_TIMEOUT,
                 policy_name: str = ""):
        self.failure_policy = failure_policy  # "Ignore" | "Fail"
        self.timeout = timeout
        self.policy_name = policy_name        # fine-grained webhooks
        self.rules: Dict[Tuple[str, str, str], Set[str]] = {}
        self.resource_ops: Dict[str, Set[str]] = {}

    def merge_kind(self, kind: str, ops: Optional[Set[str]] = None,
                   policy_scope: str = "*") -> None:
        g, v, resources, scope = _parse_kind(kind, policy_scope)
        for resource in resources:
            rscope = scope
            # a wildcard resource already served at all-scopes absorbs
            # the namespaced entry (utils.go:157 set)
            if (resource == "*" or g == "*") and rscope == "Namespaced" \
                    and (g, v, "*") in self.rules:
                rscope = "*"
            self.rules.setdefault((g, v, rscope), set()).add(resource)
            if ops:
                self.resource_ops.setdefault(resource, set()).update(ops)

    def is_empty(self) -> bool:
        return not self.rules

    def _ops_for(self, resource: str, default: Sequence[str]) -> List[str]:
        """findKeyContainingSubstring (utils.go:53): operations keyed by
        the merged rule's first resource, substring-matched."""
        want = None
        for key, ops in self.resource_ops.items():
            if key in resource or resource in key:
                want = set(ops) if want is None else want | set(ops)
        if want is None:
            want = set(default)
        return [o for o in _ALL_OPS if o in want]

    def build_rules(self, operations: Sequence[str]) -> List[Dict[str, Any]]:
        out = []
        for (g, v, scope), resources in self.rules.items():
            resources = set(resources)
            # pods imply pods/ephemeralcontainers (utils.go:81-84)
            if g in ("", "*") and v in ("v1", "*") and (
                    "pods" in resources or "*" in resources):
                resources.add("pods/ephemeralcontainers")
            first = sorted(resources)[0]
            out.append({
                "apiGroups": [g], "apiVersions": [v],
                "resources": sorted(resources), "scope": scope,
                "operations": self._ops_for(first, operations),
            })
        out.sort(key=lambda r: (r["apiGroups"], r["apiVersions"],
                                r["resources"], r["scope"]))
        return out


class WebhookConfigGenerator:
    """Builds the desired webhook configurations from a PolicyCache and
    keeps a sink reconciled as the cache revision moves."""

    def __init__(
        self,
        cache: PolicyCache,
        server: str = "",
        timeout: int = DEFAULT_TIMEOUT,
        sink: Optional[Callable[[str, Dict[str, Any]], None]] = None,
        force_failure_policy_ignore: bool = False,
    ):
        self.cache = cache
        # empty server => in-cluster service reference (controller.go:320
        # clientConfig); a host name switches to URL mode
        self.server = server
        self.timeout = timeout
        self.sink = sink
        self.force_failure_policy_ignore = force_failure_policy_ignore
        self._lock = threading.Lock()
        self._last_rev = -1
        self.configs: Dict[str, Dict[str, Any]] = {}

    def _client_config(self, path: str, ca_bundle: str) -> Dict[str, Any]:
        if self.server:
            return {"url": f"https://{self.server}{path}",
                    "caBundle": ca_bundle}
        return {"service": {"namespace": "kyverno", "name": "kyverno-svc",
                            "path": path, "port": 443},
                "caBundle": ca_bundle}

    # -- builders (controller.go:838 buildResourceValidatingWebhookConfiguration)

    def _build(self, kind_name: str, kinds_filter, path_base: str,
               ca_bundle: str) -> Dict[str, Any]:
        _, policies = self.cache.snapshot()
        # cluster policies merge before namespaced ones (getAllPolicies
        # lists ClusterPolicies first), so a namespaced wildcard folds
        # into an existing all-scopes rule instead of forking the scope
        policies = sorted(policies,
                          key=lambda p: p.raw.get("kind") == "Policy")
        default_ops = _MUTATE_DEFAULT_OPS if "mutate" in path_base else _ALL_OPS
        ignore = Webhook("Ignore", self.timeout)
        fail = Webhook("Fail", self.timeout)
        fine_grained: List[Webhook] = []
        for p in policies:
            kind_ops = _policy_kind_ops(p, kinds_filter, default_ops)
            if not kind_ops:
                continue
            fp = "Ignore" if (p.spec.failure_policy or "Fail") == "Ignore" else "Fail"
            if self.force_failure_policy_ignore:
                # toggle.ForceFailurePolicyIgnore: every webhook class
                # collapses to fail-open (spec.GetFailurePolicy)
                fp = "Ignore"
            # a namespaced Policy serves namespaced scope even before
            # the apiserver stamps its namespace (controller.go:992)
            pscope = "Namespaced" if p.raw.get("kind") == "Policy" else "*"
            if p.annotations.get(FINE_GRAINED_ANNOTATION) == "true":
                key = f"{p.namespace}/{p.name}" if p.namespace else p.name
                wh = Webhook(fp, self.timeout, policy_name=key)
                for k, ops in kind_ops.items():
                    wh.merge_kind(k, ops, pscope)
                fine_grained.append(wh)
                continue
            target = ignore if fp == "Ignore" else fail
            for k, ops in kind_ops.items():
                target.merge_kind(k, ops, pscope)

        base_name = ("mutate.kyverno.svc" if "mutate" in path_base
                     else "validate.kyverno.svc")
        webhooks = []
        for wh in [ignore, fail] + fine_grained:
            if wh.is_empty():
                continue
            # webhookNameAndPath (utils.go:395)
            suffix = wh.failure_policy.lower()
            path = f"{path_base}/{suffix}"
            name = f"{base_name}-{suffix}"
            if wh.policy_name:
                # fine-grained per-policy endpoint, served by the
                # admission server's policy-scoped routing
                # (config.FineGrainedWebhookPath, server.go:299-300);
                # namespaced policies keep their ns segment so two
                # same-named policies can't collide
                path += f"/finegrained/{wh.policy_name}"
                name += f"-finegrained-{wh.policy_name.replace('/', '-')}"
            webhooks.append({
                "name": name,
                "clientConfig": self._client_config(path, ca_bundle),
                "rules": wh.build_rules(default_ops),
                "failurePolicy": wh.failure_policy,
                "matchPolicy": "Equivalent",
                "timeoutSeconds": min(wh.timeout, 30),
                "sideEffects": "NoneOnDryRun",
                "admissionReviewVersions": ["v1"],
            })
        return {
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": ("ValidatingWebhookConfiguration" if "validate" in path_base
                     else "MutatingWebhookConfiguration"),
            # managed-by label is the cleanup selector: shutdown and the
            # init janitor delete collections by it (server.go:252,
            # kyverno.LabelWebhookManagedBy)
            "metadata": {"name": f"kyverno-{kind_name}-webhook-cfg",
                         "labels": {MANAGED_BY_LABEL: "kyverno"}},
            "webhooks": webhooks,
        }

    def build_validating(self, ca_bundle: str = "") -> Dict[str, Any]:
        # mergeWebhook classification (controller.go:979-982): validate,
        # generate, verify-image CHECKS and mutate-EXISTING rules are
        # served by the validating webhook
        return self._build(
            "resource-validating",
            lambda r: (r.has_validate() or r.has_generate()
                       or bool((r.mutation or {}).get("targets"))),
            "/validate", ca_bundle)

    def build_mutating(self, ca_bundle: str = "") -> Dict[str, Any]:
        # standard (non-targets) mutate + verifyImages mutation
        return self._build(
            "resource-mutating",
            lambda r: ((r.has_mutate() and not (r.mutation or {}).get("targets"))
                       or r.has_verify_images()),
            "/mutate", ca_bundle)

    def static_configs(self, ca_bundle: str = "") -> List[Dict[str, Any]]:
        """The policy-set-independent configurations the controller
        always maintains (server.go:117-132 routes; expected-webhooks
        conformance scenario): policy CR validate/mutate webhooks and
        the verify (lease watchdog) mutating webhook."""
        def cfg(kind: str, name: str, wh_name: str, path: str,
                rules: List[Dict[str, Any]]) -> Dict[str, Any]:
            return {
                "apiVersion": "admissionregistration.k8s.io/v1",
                "kind": kind,
                "metadata": {"name": name,
                             "labels": {MANAGED_BY_LABEL: "kyverno"}},
                "webhooks": [{
                    "name": wh_name,
                    "clientConfig": self._client_config(path, ca_bundle),
                    "rules": rules,
                    "failurePolicy": "Ignore",
                    "matchPolicy": "Equivalent",
                    "timeoutSeconds": min(self.timeout, 30),
                    "sideEffects": "NoneOnDryRun",
                    "admissionReviewVersions": ["v1"],
                }],
            }

        policy_rules = [{
            "apiGroups": ["kyverno.io"], "apiVersions": ["v1", "v2beta1"],
            "resources": ["clusterpolicies", "policies"], "scope": "*",
            "operations": ["CREATE", "UPDATE"],
        }]
        verify_rules = [{
            "apiGroups": ["coordination.k8s.io"], "apiVersions": ["v1"],
            "resources": ["leases"], "scope": "Namespaced",
            "operations": ["UPDATE"],
        }]
        return [
            cfg("ValidatingWebhookConfiguration",
                "kyverno-policy-validating-webhook-cfg",
                "validate-policy.kyverno.svc", "/policyvalidate", policy_rules),
            cfg("MutatingWebhookConfiguration",
                "kyverno-policy-mutating-webhook-cfg",
                "mutate-policy.kyverno.svc", "/policymutate", policy_rules),
            cfg("MutatingWebhookConfiguration",
                "kyverno-verify-mutating-webhook-cfg",
                "monitor-webhooks.kyverno.svc", "/verify", verify_rules),
        ]

    def all_configs(self) -> List[Dict[str, Any]]:
        """Every configuration currently served (dynamic + static)."""
        out = [c for k, c in self.configs.items()
               if k in ("validating", "mutating")]
        out.extend(self.static_configs())
        return out

    # -- reconcile loop body

    def reconcile(self, ca_bundle: str = "") -> bool:
        """Rebuild when the policy-cache revision moved. Returns True
        when the served surface changed."""
        rev = self.cache.revision
        with self._lock:
            if rev == self._last_rev:
                return False
            validating = self.build_validating(ca_bundle)
            mutating = self.build_mutating(ca_bundle)
            changed = (validating != self.configs.get("validating")
                       or mutating != self.configs.get("mutating"))
            self.configs = {"validating": validating, "mutating": mutating}
            self._last_rev = rev
        if changed and self.sink is not None:
            self.sink("validating", validating)
            self.sink("mutating", mutating)
        return changed

    def serves(self, kind: str, phase: str = "validating") -> bool:
        """Would the current configuration send this kind to us?"""
        cfg = self.configs.get(phase) or {}
        _, _, resources, _ = _parse_kind(kind)
        for wh in cfg.get("webhooks", []):
            for rule in wh.get("rules", []):
                for resource in resources:
                    if "*" in rule["resources"] or resource in rule["resources"] \
                            or f"{resource}/ephemeralcontainers" in rule["resources"]:
                        return True
        return False
