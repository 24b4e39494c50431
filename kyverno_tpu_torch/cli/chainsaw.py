# Copied verbatim from kyverno_tpu/cli/chainsaw.py.
"""Chainsaw e2e scenario runner (test/conformance/chainsaw replay).

The reference ships 440 chainsaw end-to-end scenarios: declarative
Test documents whose steps apply/delete/assert cluster state while the
kyverno controllers react. This runner replays the no-script subset
against the in-memory control plane — PolicyCache semantics + scalar
engine for admission, ClusterSnapshot as the apiserver stand-in,
UpdateRequest/Generate executors for generate rules, CleanupController
for cleanup policies — so the conformance corpus exercises the same
component wiring a cluster would.

Step operations (chainsaw.kyverno.io/v1alpha1):
- ``apply``: admit each doc (mutate -> validate, Enforce blocks);
  policies/exceptions/cleanup policies install into their controllers;
  an ``expect`` block with ``($error != null): true`` inverts.
- ``delete``: DELETE-operation admission gate, then removal plus
  generate-downstream cleanup.
- ``assert`` / ``error``: kyverno-json subset-match of each doc
  against live state (must match / must not match).
- ``script``/``sleep``: unsupported — the scenario reports SKIP.

Admitted policies carry a synthesized Ready condition so the corpus'
policy-assert.yaml (status.conditions Ready=True) matches.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, Optional, Tuple

import yaml

from ..api.policy import ClusterPolicy
from ..background.generate import GenerateController
from ..background.updaterequest import UpdateRequest, UpdateRequestQueue
from ..cluster.cleanup import CleanupController, TtlController
from ..cluster.snapshot import ClusterSnapshot
from ..engine.engine import Engine as ScalarEngine
from ..engine.jsonassert import AssertionError_, assert_tree
from ..policy.autogen import expand_policy
from ..policy.validation import validate_policy
from ..tpu.engine import build_scan_context


def _ctx(policy, resource, ns_labels, op):
    from ..engine.match import RequestInfo

    return build_scan_context(policy, resource, ns_labels, op,
                              RequestInfo(username=_ADMIN["username"],
                                          groups=list(_ADMIN["groups"])))

POLICY_KINDS = ("ClusterPolicy", "Policy")

# chainsaw talks to the cluster as its admin kubeconfig user; subject-
# scoped exceptions/rules must not silently match an anonymous request
_ADMIN = {"username": "kubernetes-admin",
          "groups": ["system:masters", "system:authenticated"]}
EXCEPTION_KINDS = ("PolicyException",)
CLEANUP_KINDS = ("ClusterCleanupPolicy", "CleanupPolicy")

READY_STATUS = {"conditions": [
    {"reason": "Succeeded", "status": "True", "type": "Ready"}]}


def _synthesize_status(res: Dict[str, Any]) -> Dict[str, Any]:
    """Stand in for the kube controllers chainsaw relies on: workload
    kinds report their spec'd replica count; pods report Running."""
    import datetime as dt

    kind = res.get("kind", "")
    out = dict(res)
    # the apiserver stamps creationTimestamp; TTL expiry depends on it
    meta = dict(out.get("metadata") or {})
    if "creationTimestamp" not in meta:
        meta["creationTimestamp"] = dt.datetime.now(
            dt.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
        out["metadata"] = meta
    if kind == "CustomResourceDefinition":
        # exported CRDs carry a zeroed status; the apiserver fills
        # acceptedNames/storedVersions on create regardless
        names = (res.get("spec") or {}).get("names") or {}
        out["status"] = {
            "acceptedNames": {k: v for k, v in names.items()
                              if k in ("kind", "listKind", "plural",
                                       "singular", "shortNames",
                                       "categories")},
            "storedVersions": [v.get("name")
                               for v in (res.get("spec") or {}).get(
                                   "versions") or [] if v.get("storage")],
        }
        return out
    if "status" in res:
        return out
    if kind in ("Deployment", "StatefulSet", "ReplicaSet"):
        n = (res.get("spec") or {}).get("replicas", 1)
        out["status"] = {"replicas": n, "readyReplicas": n,
                         "availableReplicas": n, "updatedReplicas": n}
    elif kind == "Pod":
        out["status"] = {"phase": "Running",
                         "conditions": [{"type": "Ready", "status": "True"}]}
    return out


class StepError(Exception):
    pass


class Skip(Exception):
    pass


def _snapshot_find(snapshot: ClusterSnapshot, kind: str, namespace: str,
                   name: str) -> Optional[Dict[str, Any]]:
    """Single lookup-by-identity over the snapshot (shared by the
    runner, the configMap source and the apiCall resolver)."""
    for _, res, _ in snapshot.items():
        meta = res.get("metadata") or {}
        if (res.get("kind") == kind and meta.get("name") == name
                and (meta.get("namespace") or "") == (namespace or "")):
            return res
    return None


class _SnapshotApiCall:
    """Minimal apiserver GET resolver over the snapshot: serves
    /api/v1/namespaces/<ns>[/<plural>[/<name>]] and
    /apis/<group>/<version>/... style urlPaths for apiCall context
    entries (the runner's in-memory dclient)."""

    _PLURALS = {"pods": "Pod", "configmaps": "ConfigMap",
                "secrets": "Secret", "services": "Service",
                "deployments": "Deployment", "namespaces": "Namespace"}

    def __init__(self, snapshot: ClusterSnapshot):
        self._snapshot = snapshot

    def __call__(self, entry: Dict[str, Any]):
        path = (entry.get("urlPath") or "").strip("/")
        parts = path.split("/") if path else []
        if parts[:2] == ["api", "v1"]:
            parts = parts[2:]
        elif parts and parts[0] == "apis" and len(parts) >= 3:
            parts = parts[3:]
        if parts and parts[0] == "namespaces":
            if len(parts) == 2:  # a namespace object itself
                return self._get("Namespace", "", parts[1])
            ns = parts[1]
            kind = self._PLURALS.get(parts[2] if len(parts) > 2 else "", "")
            if len(parts) == 3:
                return {"items": self._list(kind, ns)}
            if len(parts) == 4:
                return self._get(kind, ns, parts[3])
        elif parts:
            kind = self._PLURALS.get(parts[0], "")
            if len(parts) == 1:
                return {"items": self._list(kind, None)}
            if len(parts) == 2:
                return self._get(kind, "", parts[1])
        raise ValueError(f"unsupported apiCall urlPath {entry.get('urlPath')!r}")

    def _list(self, kind, ns):
        return [r for _, r, _ in self._snapshot.items()
                if r.get("kind") == kind
                and (ns is None
                     or (r.get("metadata") or {}).get("namespace", "") == ns)]

    def _get(self, kind, ns, name):
        res = _snapshot_find(self._snapshot, kind, ns, name)
        if res is None:
            raise ValueError(f"{kind} {ns}/{name} not found")
        return res


class _SnapshotConfigMaps:
    """Live 'namespace/name' -> ConfigMap view over the snapshot (the
    cluster-backed configMap context source)."""

    def __init__(self, snapshot: ClusterSnapshot):
        self._snapshot = snapshot

    def get(self, key: str):
        ns, _, name = key.partition("/")
        return _snapshot_find(self._snapshot, "ConfigMap", ns, name)


class ScenarioRunner:
    def __init__(self, scenario_dir: str):
        self.dir = scenario_dir
        self.snapshot = ClusterSnapshot()
        # every real cluster has these; scenarios rely on them as
        # match triggers and namespace targets
        for ns in ("default", "kube-system"):
            self.snapshot.upsert({"apiVersion": "v1", "kind": "Namespace",
                                  "metadata": {"name": ns}})
        # the kyverno install's static RBAC surface (rbac scenarios
        # assert the aggregated admin roles exist)
        from ..cluster.rbac_manifests import aggregated_admin_roles

        for role in aggregated_admin_roles():
            self.snapshot.upsert(role)
        # offline registry with the corpus' well-known test images:
        # digests resolve, but no signature verifies under the policies'
        # pinned keys — signature checks fail CRYPTOGRAPHICALLY (the
        # 'signed' tag cannot pass offline: we don't hold kyverno's
        # signing key)
        from ..images import StaticRegistry
        from ..images.crypto import generate_keypair

        self.registry = StaticRegistry()
        base = "ghcr.io/kyverno/test-verify-image"
        self.registry.add_image(f"{base}:unsigned", "sha256:" + "11" * 32)
        self.registry.add_image(
            f"{base}:signed-by-someone-else", "sha256:" + "33" * 32)
        someone_else, _ = generate_keypair()
        self.registry.sign(f"{base}:signed-by-someone-else", key=someone_else)
        # ':signed' is NOT mirrored: its signature lives under
        # kyverno's real signing key, so lookups error (non-blocking)
        # rather than fabricate verdicts.
        # The zulu keyless corpus image IS mirrored: its public
        # signature + SLSA provenance + vuln-scan attestations are
        # re-issued under the registry's offline Fulcio-stand-in CA
        # with the same identities, so keyless verification runs the
        # full cert-chain + SAN/issuer + DSSE crypto path
        zulu = "ghcr.io/chipzoller/zulu:v0.0.14"
        zulu_digest = ("sha256:476b21f1a75dc90fac3579ee757f4607"
                       "bb5546f476195cf645c54badf558c0db")
        gh_issuer = "https://token.actions.githubusercontent.com"
        slsa_builder = ("https://github.com/slsa-framework/"
                        "slsa-github-generator/.github/workflows/"
                        "generator_container_slsa3.yml@refs/heads/main")
        self.registry.add_image(zulu, zulu_digest)
        self.registry.sign(
            zulu, subject=("https://github.com/chipzoller/zulu/.github/"
                           "workflows/slsa-generic-keyless.yaml"
                           "@refs/tags/v0.0.14"), issuer=gh_issuer)
        self.registry.attest(
            zulu, "https://slsa.dev/provenance/v0.2",
            {"builder": {"id": slsa_builder}},
            subject=slsa_builder, issuer=gh_issuer)
        self.registry.attest(
            zulu, "cosign.sigstore.dev/attestation/vuln/v1",
            {"scanner": {"uri": "pkg:github/aquasecurity/trivy@0.34.0"}},
            subject=("https://github.com/chipzoller/zulu/.github/"
                     "workflows/vulnerability-scan.yaml@refs/heads/main"),
            issuer=gh_issuer)
        self.policies: Dict[str, ClusterPolicy] = {}
        self.policy_docs: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.exceptions: List[Dict[str, Any]] = []
        from ..engine.contextloaders import DataSources

        self.cleanup = CleanupController(
            self.snapshot,
            data_sources=DataSources(
                configmaps=_SnapshotConfigMaps(self.snapshot),
                api_call=_SnapshotApiCall(self.snapshot)))
        self.ttl = TtlController(self.snapshot)
        self.urq = UpdateRequestQueue()
        # the background SA's write grants mirror the chart's aggregated
        # clusterroles; custom API groups need an explicit grant, so
        # generation into e.g. crossplane groups fails as in a cluster
        self.generate = GenerateController(
            self.snapshot, self.policies,
            allowed_groups={"", "apps", "batch", "networking.k8s.io",
                            "rbac.authorization.k8s.io", "kyverno.io",
                            "wgpolicyk8s.io", "policy", "autoscaling",
                            "coordination.k8s.io"})
        from ..background.mutate_existing import MutateExistingController

        self.mutate_existing = MutateExistingController(self.snapshot,
                                                        self.policies)
        from ..vap import VapGenerateController

        self.vap_generator = VapGenerateController(self.snapshot)
        # the webhook-configuration controller runs against the policy
        # set exactly as in a cluster: installs/deletes reconcile the
        # generated Validating/MutatingWebhookConfigurations, which the
        # webhooks/* conformance scenarios assert on. The runner keys
        # policies by kind+name (a Policy and a ClusterPolicy with the
        # same name are distinct objects), so it feeds the generator a
        # snapshot view of its own store rather than a PolicyCache
        from ..cluster.webhookconfig import WebhookConfigGenerator

        runner = self

        class _PolicyView:
            revision = 0

            @staticmethod
            def snapshot():
                return _PolicyView.revision, list(runner.policies.values())

        self._policy_view = _PolicyView
        # the conformance CI runs the force-failure-policy-ignore
        # category under a config profile with that toggle enabled
        # (.github/workflows/conformance.yaml config matrix)
        self.webhook_gen = WebhookConfigGenerator(
            _PolicyView,
            force_failure_policy_ignore=(
                "force-failure-policy-ignore" in scenario_dir))
        self.webhook_gen.reconcile()  # static surface exists at startup
        self._parsed_policies: Dict[str, ClusterPolicy] = {}
        self._virtual_now = None  # monotone controller clock (op_assert)
        self.events: List[Dict[str, Any]] = []  # emitted K8s Events
        self._admitted_uids: set = set()  # resources that went through admission
        self.log: List[str] = []

    # -- events (pkg/event: policy-involving admission/generate events;
    # the background scanner's events materialize at assert time)

    def _emit_event(self, policy_kind: str, policy_name: str, reason: str,
                    etype: str, component: str, action: str = "",
                    message: str = "", namespace: str = "default") -> None:
        ev = {
            "apiVersion": "v1", "kind": "Event",
            "metadata": {"namespace": namespace or "default"},
            "involvedObject": {"apiVersion": "kyverno.io/v1",
                               "kind": policy_kind, "name": policy_name},
            "type": etype, "reason": reason,
            "reportingComponent": component,
            "source": {"component": component},
        }
        if action:
            ev["action"] = action
        if message:
            ev["message"] = message
        self.events.append(ev)

    def _scan_events(self) -> List[Dict[str, Any]]:
        """Background-scan violations as Events involving the violating
        resource (reportingComponent kyverno-scan)."""
        eng = self._engine()
        ns_labels = self.snapshot.namespace_labels()
        out: List[Dict[str, Any]] = []
        for _, res, _ in self.snapshot.items():
            meta = res.get("metadata") or {}
            for ukey, policy in self.policies.items():
                if not policy.spec.background:
                    continue
                if not any(r.has_validate() for r in policy.get_rules()):
                    continue
                key = meta.get("name", "") if res.get("kind") == "Namespace" \
                    else meta.get("namespace", "")
                pctx = build_scan_context(policy, res, ns_labels.get(key, {}))
                resp = eng.validate(pctx)
                if any(rr.status in ("fail", "error")
                       for rr in resp.policy_response.rules):
                    out.append({
                        "apiVersion": "v1", "kind": "Event",
                        "metadata": {"namespace": meta.get("namespace")
                                     or "default"},
                        "involvedObject": {
                            "apiVersion": res.get("apiVersion", "v1"),
                            "kind": res.get("kind", ""),
                            "name": meta.get("name", "")},
                        "type": "Warning", "reason": "PolicyViolation",
                        "reportingComponent": "kyverno-scan",
                        "source": {"component": "kyverno-scan"},
                    })
        return out

    # -- engine (rebuilt when exceptions change)

    def _engine(self) -> ScalarEngine:
        from ..engine.contextloaders import DataSources

        return ScalarEngine(
            data_sources=DataSources(
                configmaps=_SnapshotConfigMaps(self.snapshot),
                api_call=_SnapshotApiCall(self.snapshot)),
            exceptions=list(self.exceptions))

    # -- admission

    def _webhook_match_conditions_ok(self, policy, resource, op) -> bool:
        """spec.webhookConfiguration.matchConditions: CEL over the
        AdmissionRequest gates whether the webhook is invoked at all
        (the apiserver evaluates these before calling kyverno)."""
        mcs = (policy.spec.raw.get("webhookConfiguration") or {}) \
            .get("matchConditions")
        if not mcs:
            return True
        from ..vap.validator import CelValidator

        v = CelValidator(validations=[], match_conditions=mcs)
        request = {"operation": op,
                   "userInfo": {"username": _ADMIN["username"],
                                "groups": list(_ADMIN["groups"])}}
        matched, _err = v.matches(object=resource, request=request)
        return matched

    def _admit(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        """mutate -> validate; raises StepError when an Enforce policy
        denies. Returns the (possibly mutated) resource."""
        eng = self._engine()
        ns_labels = self.snapshot.namespace_labels()
        meta = doc.get("metadata") or {}
        ns = meta.get("namespace", "")
        key = meta.get("name", "") if doc.get("kind") == "Namespace" else ns
        exists = self._find(doc.get("kind", ""), ns, meta.get("name", ""))
        op = "UPDATE" if exists is not None else "CREATE"
        current = doc
        res_ns = ns if ns else "default"
        for ukey, policy in self.policies.items():
            if not policy.spec.admission:
                continue  # background-only policy (spec.admission=false)
            if not self._webhook_match_conditions_ok(policy, current, op):
                continue
            if any(r.has_mutate() for r in policy.get_rules()):
                pctx = _ctx(policy, current, ns_labels.get(key, {}), op)
                m = eng.mutate(pctx)
                if m.patched_resource is not None and \
                        m.patched_resource != current:
                    current = m.patched_resource
                    self._emit_event(
                        ukey.split("/")[0], policy.name, "PolicyApplied",
                        "Normal", "kyverno-admission",
                        action="Resource Mutated", namespace=res_ns)
        for ukey, policy in self.policies.items():
            # verify-image rules run on the mutate webhook after
            # mutation (resource/handlers.go:139-177); Enforce failures
            # block, digest patches land on the admitted resource
            if not policy.spec.admission:
                continue
            if not any(r.has_verify_images() for r in policy.get_rules()):
                continue
            if not self._webhook_match_conditions_ok(policy, current, op):
                continue
            pctx = _ctx(policy, current, ns_labels.get(key, {}), op)
            resp = eng.verify_and_patch_images(
                pctx, registry_client=self.registry)
            if resp.patched_resource is not None:
                current = resp.patched_resource
            enforce = (policy.spec.validation_failure_action
                       or "Audit").lower().startswith("enforce")
            # block on cryptographic verification FAILURE; a registry
            # ERROR here means the image isn't mirrored in the offline
            # fixture registry (it would resolve against the live
            # registry the reference talks to), so it doesn't block
            failed = [rr.name for rr in resp.policy_response.rules
                      if rr.status == "fail"]
            if enforce and failed:
                raise StepError(
                    f"admission denied by {policy.name}: image "
                    f"verification failed: {', '.join(failed)}")
        for ukey, policy in self.policies.items():
            if not policy.spec.admission:
                continue
            if not any(r.has_validate() for r in policy.get_rules()):
                continue
            if not self._webhook_match_conditions_ok(policy, current, op):
                continue
            enforce = (policy.spec.validation_failure_action
                       or "Audit").lower().startswith("enforce")
            pctx = _ctx(policy, current, ns_labels.get(key, {}), op)
            resp = eng.validate(pctx)
            statuses = [rr.status for rr in resp.policy_response.rules]
            pk = ukey.split("/")[0]
            # events go out whether or not the request is blocked (the
            # reference emits them from an async queue before the
            # admission response is returned)
            if any(s in ("fail", "error") for s in statuses):
                self._emit_event(pk, policy.name, "PolicyViolation",
                                 "Warning", "kyverno-admission",
                                 namespace=res_ns)
            elif "pass" in statuses:
                self._emit_event(pk, policy.name, "PolicyApplied",
                                 "Normal", "kyverno-admission",
                                 namespace=res_ns)
            for rr in resp.policy_response.rules:
                if rr.status in ("fail", "error") and enforce:
                    raise StepError(
                        f"admission denied by {policy.name}/{rr.name}: "
                        f"{rr.message}")
        return current

    def _gate_delete(self, doc: Dict[str, Any]) -> None:
        eng = self._engine()
        ns_labels = self.snapshot.namespace_labels()
        meta = doc.get("metadata") or {}
        key = meta.get("name", "") if doc.get("kind") == "Namespace" \
            else meta.get("namespace", "")
        for policy in self.policies.values():
            if not policy.spec.admission:
                continue
            if not any(r.has_validate() for r in policy.get_rules()):
                continue
            enforce = (policy.spec.validation_failure_action
                       or "Audit").lower().startswith("enforce")
            pctx = _ctx(policy, doc, ns_labels.get(key, {}), "DELETE")
            resp = eng.validate(pctx)
            for rr in resp.policy_response.rules:
                if rr.status in ("fail", "error") and enforce:
                    raise StepError(
                        f"delete denied by {policy.name}/{rr.name}")

    # -- state helpers

    def _find(self, kind: str, namespace: str, name: str) -> Optional[Dict[str, Any]]:
        return _snapshot_find(self.snapshot, kind, namespace, name)

    def _run_generate(self, trigger: Dict[str, Any], op: str,
                      only_policy: Optional[str] = None,
                      mutate_existing: bool = True,
                      generate: bool = True) -> None:
        for name, policy in self.policies.items():
            if only_policy is not None and name != only_policy:
                continue
            if generate and any(r.has_generate() for r in policy.get_rules()):
                self.urq.add(UpdateRequest(policy=name, rule_type="generate",
                                           trigger=trigger, operation=op))
            if op != "DELETE" and mutate_existing:
                from ..engine.match import matches_resource_description

                # matches_resource_description returns mismatch REASONS
                # (empty list = the rule matches the trigger)
                if any(not matches_resource_description(trigger, r, operation=op)
                       for r in policy.get_rules()
                       if (r.mutation or {}).get("targets")):
                    self.urq.add(UpdateRequest(
                        policy=name, rule_type="mutate", trigger=trigger,
                        operation=op))
        processed = list(self.urq.pending())
        gen_refs: Dict[int, List[Dict[str, Any]]] = {}

        def _handle(ur):
            if ur.rule_type == "generate":
                gen_refs[id(ur)] = self.generate.process_ur(ur)
            else:
                self.mutate_existing.process_ur(ur)

        self.urq.process(_handle)
        from ..background.updaterequest import UR_COMPLETED, UR_FAILED

        for ur in processed:
            if ur.rule_type != "generate":
                continue
            pk, _, pname = ur.policy.partition("/")
            refs = gen_refs.get(id(ur), [])
            if ur.status == UR_COMPLETED and refs:
                # one policy-involving event + one per generated target
                # (pkg/background/generate events)
                self._emit_event(pk, pname, "PolicyApplied", "Normal",
                                 "kyverno-generate",
                                 action="Resource Generated",
                                 message="resource generated")
                for ref in refs:
                    self.events.append({
                        "apiVersion": "v1", "kind": "Event",
                        "metadata": {"namespace": ref.get("namespace")
                                     or "default"},
                        "involvedObject": {
                            "apiVersion": ref.get("apiVersion", "v1"),
                            "kind": ref.get("kind", ""),
                            "name": ref.get("name", ""),
                            **({"namespace": ref["namespace"]}
                               if ref.get("namespace") else {})},
                        "type": "Normal", "reason": "PolicyApplied",
                        "action": "None",
                        "reportingComponent": "kyverno-generate",
                        "source": {"component": "kyverno-generate"},
                    })
            elif ur.status == UR_FAILED or ur.message:
                # terminal failure, or an attempt that will be retried —
                # the reference emits a PolicyError event per failure
                self._emit_event(pk, pname, "PolicyError", "Warning",
                                 "kyverno-generate", message=ur.message)

    # -- ops

    def op_apply(self, path: str, expect_error: bool) -> None:
        for doc in self._load(path):
            kind = doc.get("kind", "")
            try:
                if kind in POLICY_KINDS:
                    self._install_policy(doc)
                elif kind in EXCEPTION_KINDS:
                    self._install_exception(doc)
                elif kind in CLEANUP_KINDS:
                    self._install_cleanup(doc)
                else:
                    meta0 = doc.get("metadata") or {}
                    prev = self._find(kind, meta0.get("namespace", ""),
                                      meta0.get("name", ""))
                    admitted = self._admit(doc)
                    stamped = _synthesize_status(admitted)
                    # apiserver bumps metadata.generation per spec
                    # update; controllers echo it as observedGeneration
                    gen = 1 if prev is None else (
                        ((prev.get("metadata") or {}).get("generation") or 1)
                        + 1)
                    stamped.setdefault("metadata", {})["generation"] = gen
                    st = stamped.get("status")
                    if isinstance(st, dict) and "replicas" in st:
                        st.setdefault("observedGeneration", gen)
                    self.snapshot.upsert(stamped)
                    from ..cluster.snapshot import resource_uid
                    self._admitted_uids.add(resource_uid(stamped))
                    self._run_generate(admitted, "CREATE")
            except StepError:
                if expect_error:
                    self.log.append(f"apply {os.path.basename(path)}: "
                                    f"denied as expected")
                    continue
                raise
            if expect_error:
                raise StepError(
                    f"apply {os.path.basename(path)}: expected denial, "
                    f"but {kind} was admitted")

    def _install_cleanup(self, doc: Dict[str, Any]) -> None:
        from ..cluster.cleanup import validate_cleanup_policy

        errors = validate_cleanup_policy(doc)
        if errors:
            raise StepError(f"cleanup policy rejected: {errors[0]}")
        self.cleanup.set_policy(doc)
        meta = doc.get("metadata") or {}
        self.policy_docs[(doc.get("kind", ""), meta.get("name", ""))] = dict(doc)

    def _install_exception(self, doc: Dict[str, Any]) -> None:
        from ..api.exception import PolicyException

        errors = PolicyException.from_dict(doc).validate()
        if errors:
            raise StepError(f"exception rejected: {errors[0]}")
        self.exceptions.append(doc)
        # an exception arriving AFTER a policy retracts its VAP pair
        # (controller.go: exceptions suppress generation)
        self._reconcile_vaps()

    def _reconcile_vaps(self) -> None:
        self.vap_generator.exceptions = list(self.exceptions)
        for parsed in self._parsed_policies.values():
            self.vap_generator.reconcile(parsed)
            stored = self.policy_docs.get(("ClusterPolicy", parsed.name))
            if stored is not None:
                generated, _ = self.vap_generator.status.get(
                    parsed.name, (False, ""))
                stored["status"]["validatingadmissionpolicy"] = {
                    "generated": generated}

    def _kind_resolver(self, selector: str):
        """Discovery stand-in for policy validation (validate.go:1404
        validKinds): builtin kinds resolve from the served-kind table;
        CRDs and custom resources resolve from the live snapshot;
        anything else is unknown."""
        from ..cluster.webhookconfig import _CLUSTER_KINDS
        from ..utils.kube import parse_kind_selector
        from ..vap.policy import _PLURALS

        _, v, k, sub = parse_kind_selector(selector)
        # served builtins beyond the plural table (scope per discovery)
        if k in _CLUSTER_KINDS and k not in _PLURALS:
            return "Cluster"
        if k in {"Lease", "Event", "PodTemplate", "EndpointSlice"}:
            return "Namespaced"
        if k in _PLURALS:
            served = ("v1", "v2") if k == "HorizontalPodAutoscaler" else ("v1",)
            if v not in ("*",) + served:
                return None  # e.g. 'v2/Pod' — no such served version
            if sub not in ("", "*"):
                from ..cluster.webhookconfig import _POD_SUBRESOURCES
                known = _POD_SUBRESOURCES if k == "Pod" else ("status", "scale")
                if sub not in known:
                    return None  # e.g. 'Pod/foo' — no such subresource
            return "Cluster" if k in _CLUSTER_KINDS else "Namespaced"
        for _, res, _ in self.snapshot.items():
            if res.get("kind") == "CustomResourceDefinition":
                names = ((res.get("spec") or {}).get("names") or {})
                if names.get("kind") == k:
                    scope = (res.get("spec") or {}).get("scope") or "Namespaced"
                    return "Cluster" if scope == "Cluster" else "Namespaced"
            if res.get("kind") == k:
                return "Namespaced"
        return None

    def _install_policy(self, doc: Dict[str, Any]) -> None:
        parsed = ClusterPolicy.from_dict(doc)
        errors, _ = validate_policy(parsed, kind_resolver=self._kind_resolver)
        if errors:
            raise StepError(f"policy rejected: {errors[0]}")
        policy = expand_policy(parsed)
        ukey = f"{doc.get('kind', 'ClusterPolicy')}/{policy.name}"
        self.policies[ukey] = policy
        self._policy_view.revision += 1
        self.webhook_gen.reconcile()
        stored = dict(doc)
        stored["status"] = dict(READY_STATUS)
        # the controller surfaces computed autogen rules in status
        # (api/kyverno/v1 PolicyStatus.Autogen; autogen/* scenarios
        # assert the exact generated rule list)
        gen_rules = [r.raw for r in policy.get_rules()
                     if r.name.startswith("autogen-")]
        stored["status"]["autogen"] = {"rules": gen_rules} if gen_rules else {}
        meta = doc.get("metadata") or {}
        # Kyverno->VAP generation reconciles on ClusterPolicy events
        # only (the reference controller watches ClusterPolicies); the
        # policy status records the outcome
        # (controller.go updateClusterPolicyStatus)
        if doc.get("kind") == "ClusterPolicy":
            self._parsed_policies[policy.name] = parsed
            self.vap_generator.exceptions = list(self.exceptions)
            self.vap_generator.reconcile(parsed)
            generated, _msg = self.vap_generator.status.get(policy.name,
                                                            (False, ""))
            stored["status"]["validatingadmissionpolicy"] = {
                "generated": generated}
        self.policy_docs[(doc.get("kind", ""), meta.get("name", ""))] = stored
        # replay existing triggers for THIS policy only: generate rules
        # touch pre-existing triggers only with spec.generateExisting
        # (spec_types.go GenerateExisting); mutate-existing replays at
        # install only when spec.mutateExistingOnPolicyUpdate is set
        mutate_on_update = bool((doc.get("spec") or {})
                                .get("mutateExistingOnPolicyUpdate"))
        if policy.spec.generate_existing or mutate_on_update:
            for _, res, _ in self.snapshot.items():
                self._run_generate(res, "UPDATE", only_policy=ukey,
                                   mutate_existing=mutate_on_update,
                                   generate=policy.spec.generate_existing)

    def op_delete(self, ref: Dict[str, Any]) -> None:
        kind = ref.get("kind", "")
        meta = ref.get("metadata") or ref
        name = meta.get("name", "")
        namespace = meta.get("namespace", "")
        if kind in POLICY_KINDS:
            self.policies.pop(f"{kind}/{name}", None)
            self.policy_docs.pop((kind, name), None)
            self._policy_view.revision += 1
            self.webhook_gen.reconcile()
            if kind == "ClusterPolicy":
                self._parsed_policies.pop(name, None)
                self.vap_generator.on_policy_deleted(name)
            return
        if kind in CLEANUP_KINDS:
            self.cleanup.unset_policy(name)
            self.policy_docs.pop((kind, name), None)
            return
        if kind in EXCEPTION_KINDS:
            self.exceptions = [
                e for e in self.exceptions
                if (e.get("metadata") or {}).get("name") != name]
            # a removed exception un-suppresses VAP generation
            # (controller.go deleteException -> reconcile)
            self._reconcile_vaps()
            return
        obj = self._find(kind, namespace, name)
        if obj is None:
            return  # chainsaw delete tolerates absent objects
        self._gate_delete(obj)
        self.snapshot.delete(obj)
        self._run_generate(obj, "DELETE")

    def op_assert(self, path: str, want_match: bool) -> None:
        if not want_match:
            # chainsaw `error` asserts eventual ABSENCE within its
            # timeout; the ttl/cleanup controllers get to act first.
            # The virtual clock advances MONOTONICALLY past each
            # policy's next cron slot, so consecutive error-asserts
            # each get a fresh controller pass
            import datetime as dt

            base = self._virtual_now or dt.datetime.now(dt.timezone.utc)
            self._virtual_now = base + dt.timedelta(hours=2)
            self.ttl.run_once(now=self._virtual_now)
            self.cleanup.run_due(now=self._virtual_now)
        for doc in self._load(path):
            ok = self._doc_matches(doc)
            if want_match and not ok:
                raise StepError(f"assert {os.path.basename(path)}: no object "
                                f"matches {doc.get('kind')}/"
                                f"{(doc.get('metadata') or {}).get('name')}")
            if not want_match and ok:
                raise StepError(f"error {os.path.basename(path)}: object "
                                f"unexpectedly matches")

    def _doc_matches(self, doc: Dict[str, Any]) -> bool:
        kind = doc.get("kind", "")
        meta = doc.get("metadata") or {}
        name = meta.get("name", "")
        tree = {k: v for k, v in doc.items() if k != "apiVersion"}
        if kind in POLICY_KINDS + EXCEPTION_KINDS + CLEANUP_KINDS:
            if kind in EXCEPTION_KINDS:
                target = next((e for e in self.exceptions
                               if (e.get("metadata") or {}).get("name") == name),
                              None)
            else:
                target = self.policy_docs.get((kind, name)) \
                    or self.policy_docs.get(("ClusterPolicy", name)) \
                    or self.policy_docs.get(("Policy", name))
            if target is None:
                return False
            return self._subset(tree, target)
        if kind in ("ValidatingWebhookConfiguration",
                    "MutatingWebhookConfiguration"):
            if any(cfg.get("kind") == kind and self._subset(tree, cfg)
                   for cfg in self.webhook_gen.all_configs()):
                return True
            return any(self._subset(tree, v)
                       for v in getattr(self.vap_generator, "vaps", {}).values()
                       if isinstance(v, dict) and v.get("kind") == kind)
        if kind == "Event":
            # cheap recorded events first; the full background-scan
            # materialization only runs when they miss
            if any(self._subset(tree, ev) for ev in self.events):
                return True
            return any(self._subset(tree, ev) for ev in self._scan_events())
        if kind in ("PolicyReport", "ClusterPolicyReport"):
            return any(self._subset(tree, rep)
                       for rep in self._materialize_reports(kind))
        if name:
            target = self._find(kind, meta.get("namespace", ""), name)
            return target is not None and self._subset(tree, target)
        # no name: any live object of the kind may satisfy the tree
        return any(self._subset(tree, res) for _, res, _ in self.snapshot.items()
                   if res.get("kind") == kind)

    @staticmethod
    def _subset(tree: Dict[str, Any], target: Dict[str, Any]) -> bool:
        try:
            return not assert_tree(tree, target)
        except AssertionError_:
            return False

    def _materialize_reports(self, kind: str) -> List[Dict[str, Any]]:
        """Background-scan the snapshot and shape per-resource
        PolicyReports the way the reports controller writes them
        (ownerReference + scope + result rows with category/severity/
        properties + summary, pkg/utils/report builders)."""
        from ..cluster.snapshot import resource_uid

        from ..cluster.webhookconfig import _CLUSTER_KINDS

        eng = self._engine()
        ns_labels = self.snapshot.namespace_labels()
        cluster_kinds = _CLUSTER_KINDS | {"ClusterPolicy"}
        reports: List[Dict[str, Any]] = []
        for uid, res, _ in self.snapshot.items():
            meta = res.get("metadata") or {}
            ns = meta.get("namespace", "")
            # report placement follows the RESOURCE's scope, not whether
            # the fixture happened to carry a namespace (chainsaw stamps
            # its test namespace on namespaced resources)
            is_cluster = res.get("kind") in cluster_kinds
            if (kind == "PolicyReport") == is_cluster:
                continue
            if not is_cluster and not ns:
                ns = "default"
            rows: List[Dict[str, Any]] = []
            for policy in self.policies.values():
                # background policies are scanned; admission-only
                # policies still surface their admission results in
                # reports (report/admission controller path)
                if not policy.spec.background and not (
                        policy.spec.admission and uid in self._admitted_uids):
                    continue
                mcs = (policy.spec.raw.get("webhookConfiguration") or {}
                       ).get("matchConditions")
                if mcs:
                    # the scan path re-evaluates matchConditions with
                    # its own service-account request context, not the
                    # original requester's — object-scoped conditions
                    # still gate, user-scoped ones see the scanner SA
                    from ..vap.validator import CelValidator

                    v = CelValidator(validations=[], match_conditions=mcs)
                    matched, _err = v.matches(
                        object=res,
                        request={"operation": "UPDATE", "userInfo": {
                            "username": ("system:serviceaccount:kyverno:"
                                         "kyverno-reports-controller"),
                            "groups": ["system:serviceaccounts",
                                       "system:authenticated"]}})
                    if not matched:
                        continue
                has_validate = any(r.has_validate()
                                   for r in policy.get_rules())
                has_vi = any(r.has_verify_images()
                             for r in policy.get_rules())
                if not has_validate and not has_vi:
                    continue
                key = meta.get("name", "") if res.get("kind") == "Namespace" else ns
                pctx = build_scan_context(policy, res, ns_labels.get(key, {}))
                responses = []
                if has_validate:
                    responses.append(eng.validate(pctx))
                if has_vi:
                    pctx_vi = build_scan_context(policy, res,
                                                 ns_labels.get(key, {}))
                    responses.append(eng.verify_and_patch_images(
                        pctx_vi, registry_client=self.registry))
                for resp in responses:
                    for rr in resp.policy_response.rules:
                        row = {"policy": policy.name, "rule": rr.name,
                               "result": rr.status,
                               "message": rr.message
                               or (f"validation rule '{rr.name}' passed."
                                   if rr.status == "pass" else ""),
                               "scored": True, "source": "kyverno"}
                        anns = policy.annotations
                        if anns.get("policies.kyverno.io/category"):
                            row["category"] = anns["policies.kyverno.io/category"]
                        if anns.get("policies.kyverno.io/severity"):
                            row["severity"] = anns["policies.kyverno.io/severity"]
                        props = dict(rr.properties or {})
                        if rr.exceptions:
                            props["exception"] = ", ".join(rr.exceptions)
                        if props:
                            row["properties"] = props
                        rows.append(row)
            if not rows:
                continue
            summary = {s: sum(1 for r in rows if r["result"] == s)
                       for s in ("pass", "fail", "warn", "error", "skip")}
            reports.append({
                "apiVersion": "wgpolicyk8s.io/v1alpha2", "kind": kind,
                "metadata": {"namespace": ns,
                             "labels": {"app.kubernetes.io/managed-by": "kyverno"},
                             "ownerReferences": [{
                                 "apiVersion": res.get("apiVersion", ""),
                                 "kind": res.get("kind", ""),
                                 "name": meta.get("name", "")}]},
                "scope": {"apiVersion": res.get("apiVersion", ""),
                          "kind": res.get("kind", ""),
                          "name": meta.get("name", ""),
                          **({"namespace": ns} if ns else {})},
                "results": rows,
                "summary": summary,
            })
        return reports

    # -- scenario loop

    def _load(self, path: str) -> List[Dict[str, Any]]:
        with open(os.path.join(self.dir, path)) as f:
            return [d for d in yaml.safe_load_all(f) if isinstance(d, dict)]

    def run(self) -> List[str]:
        """Raises StepError on failure, Skip for unsupported steps;
        returns the step log on success."""
        with open(os.path.join(self.dir, "chainsaw-test.yaml")) as f:
            test = yaml.safe_load(f)
        steps = ((test.get("spec") or {}).get("steps")) or []
        for si, step in enumerate(steps):
            ops = list(step.get("try") or [])
            for op in ops:
                if "script" in op or "sleep" in op or "command" in op:
                    raise Skip(f"step {si}: script/sleep unsupported")
                if "apply" in op:
                    a = op["apply"]
                    expect_error = any(
                        (c.get("check") or {}).get("($error != null)") is True
                        for c in (a.get("expect") or []))
                    self.op_apply(a["file"], expect_error)
                    self.log.append(f"applied {a['file']}")
                elif "create" in op:
                    a = op["create"]
                    self.op_apply(a["file"], any(
                        (c.get("check") or {}).get("($error != null)") is True
                        for c in (a.get("expect") or [])))
                    self.log.append(f"created {a['file']}")
                elif "assert" in op:
                    self.op_assert(op["assert"]["file"], want_match=True)
                    self.log.append(f"asserted {op['assert']['file']}")
                elif "error" in op:
                    self.op_assert(op["error"]["file"], want_match=False)
                    self.log.append(f"errored {op['error']['file']}")
                elif "delete" in op:
                    d = op["delete"]
                    refs = []
                    if "ref" in d:
                        refs = [d["ref"]]
                    elif "file" in d:
                        refs = self._load(d["file"])
                    for ref in refs:
                        self.op_delete(ref)
                    self.log.append(f"deleted step {si}")
                else:
                    raise Skip(f"step {si}: unsupported op {sorted(op)}")
        return self.log


def run_scenario(scenario_dir: str) -> Tuple[str, str]:
    """(status, detail): pass | fail | skip."""
    try:
        ScenarioRunner(scenario_dir).run()
        return "pass", ""
    except Skip as e:
        return "skip", str(e)
    except StepError as e:
        return "fail", str(e)
    except Exception as e:  # noqa: BLE001 — a crash is a failing scenario
        return "fail", f"{type(e).__name__}: {e}"


def run_tree(root: str) -> List[Tuple[str, str, str]]:
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        if "chainsaw-test.yaml" in files:
            status, detail = run_scenario(dirpath)
            out.append((os.path.relpath(dirpath, root), status, detail))
    return out


def add_parser(sub) -> None:
    p = sub.add_parser("chainsaw", help="replay chainsaw e2e scenarios")
    p.add_argument("paths", nargs="+", help="scenario directories (trees)")
    p.set_defaults(func=run_cmd)


def run_cmd(args: argparse.Namespace) -> int:
    failed = 0
    for root in args.paths:
        for rel, status, detail in run_tree(root):
            print(f"{status.upper():5} {rel}" + (f"  ({detail})" if detail else ""))
            failed += status == "fail"
    return 1 if failed else 0
