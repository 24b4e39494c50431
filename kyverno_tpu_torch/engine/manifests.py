# Copied verbatim from kyverno_tpu/engine/manifests.py.
"""validate.manifests — sigstore-signed YAML manifest verification.

Re-implementation of the reference manifests handler
(pkg/engine/handlers/validation/validate_manifest.go) with REAL
signature crypto, runnable offline:

- The signed manifest travels in the resource's annotations
  (``<domain>/message`` = base64(gzip(tar.gz)) where the tar holds the
  original YAML; ``<domain>/signature[,_N]`` = base64 DER ECDSA
  signatures over the inner tar.gz bytes). Domain defaults to
  ``cosign.sigstore.dev`` (validate_manifest.go:33).
- Each attestor-set entry's static PEM key verifies one of the
  signature annotations (verifyManifestAttestorSet:198, count
  semantics shared with image verification).
- The admitted resource must then match the signed manifest up to
  ignoreFields: the policy's own, plus the engine defaults
  (pkg/engine/resources/default-config.yaml) and the
  k8s-manifest-sigstore defaults (mutation-check / dryrun-equivalent
  masking done as a masked structural diff).

Keyless/certificate attestors need external infrastructure (Fulcio,
Rekor) and surface as rule errors here.
"""

from __future__ import annotations

import base64
import binascii
import fnmatch
import gzip
import io
import re
import tarfile
from typing import Any, Dict, List, Optional, Tuple

import yaml

DEFAULT_ANNOTATION_DOMAIN = "cosign.sigstore.dev"

# pkg/engine/resources/default-config.yaml (kind -> ignored dot-paths);
# kind '*' applies to everything. The k8s-manifest-sigstore library's
# own default config contributes the same classes of noise fields; the
# signature annotations themselves are masked separately by domain.
DEFAULT_IGNORE_FIELDS: List[Dict[str, Any]] = [
    {"fields": [
        "metadata.namespace",
        "spec.containers.*.imagePullPolicy",
        "spec.containers.*.terminationMessagePath",
        "spec.containers.*.terminationMessagePolicy",
        "spec.dnsPolicy",
        "spec.restartPolicy",
        "spec.schedulerName",
        "spec.terminationGracePeriodSeconds",
        "metadata.labels.app.kubernetes.io/instance",
        "metadata.managedFields.*",
        "metadata.resourceVersion",
        "metadata.selfLink",
        "metadata.annotations.control-plane.alpha.kubernetes.io/leader",
        "metadata.annotations.kubectl.kubernetes.io/last-applied-configuration",
        "metadata.finalizers*",
        "metadata.annotations.namespace",
        "metadata.annotations.deprecated.daemonset.template.generation",
        "metadata.creationTimestamp",
        "metadata.uid",
        "metadata.generation",
        "status",
        "metadata.annotations.deployment.kubernetes.io/revision",
    ], "objects": [{"kind": "*"}]},
    {"fields": [
        "spec.volumes.*.name",
        "spec.volumes.*.projected.*",
        "spec.volumes.*.configMap.defaultMode",
        "spec.containers.*.volumeMounts.*",
        "spec.tolerations.*",
        "spec.enableServiceLinks",
        "spec.preemptionPolicy",
        "spec.priority",
        "spec.serviceAccount",
    ], "objects": [{"kind": "Pod"}]},
    {"fields": [
        "spec.progressDeadlineSeconds",
        "spec.revisionHistoryLimit",
        "spec.strategy.*",
        "spec.template.metadata.creationTimestamp",
        "spec.containers.*.ports.*.protocol",
        "spec.containers.*.resources",
        "spec.securityContext",
    ], "objects": [{"kind": "Deployment"}]},
    {"fields": [
        "spec.conversion.strategy",
        "spec.names.listKind",
    ], "objects": [{"kind": "CustomResourceDefinition"}]},
    {"fields": [
        "spec.ports.*.nodePort",
        "spec.clusterIP",
        "spec.clusterIPs.0",
        "spec.sessionAffinity",
        "spec.type",
        "spec.ipFamilies.*",
        "spec.ipFamilyPolicy",
        "spec.internalTrafficPolicy",
    ], "objects": [{"kind": "Service"}]},
    {"fields": [
        "metadata.annotations.pod-policies.kyverno.io/autogen-controllers",
        "spec.failurePolicy",
        "spec.background",
        "spec.validationFailureAction",
    ], "objects": [{"kind": "ClusterPolicy"}, {"kind": "Policy"}]},
    {"fields": [
        "secrets.*.name",
        "imagePullSecrets.*.name",
    ], "objects": [{"kind": "ServiceAccount"}]},
]


class ManifestVerificationError(Exception):
    """Surfaces as a rule ERROR (validate_manifest.go:82)."""


def verify_manifest(resource: Dict[str, Any],
                    manifests_spec: Dict[str, Any]) -> Tuple[bool, str]:
    """verifyManifest (validate_manifest.go:91): returns
    (verified, reason); raises ManifestVerificationError for rule
    errors (malformed attestors, unsupported attestor types)."""
    domain = manifests_spec.get("annotationDomain") or DEFAULT_ANNOTATION_DOMAIN
    ignore_fields = list(DEFAULT_IGNORE_FIELDS)
    for binding in manifests_spec.get("ignoreFields") or []:
        ignore_fields.append({
            "fields": list(binding.get("fields") or []),
            "objects": list(binding.get("objects") or [{"kind": "*"}]),
        })
    verified_msgs: List[str] = []
    for i, attestor_set in enumerate(manifests_spec.get("attestors") or []):
        path = f".attestors[{i}]"
        ok, reason = _verify_attestor_set(
            resource, attestor_set, domain, ignore_fields, path)
        if not ok:
            return False, reason
        verified_msgs.append(reason)
    return True, "verified manifest signatures; " + ",".join(verified_msgs)


def _verify_attestor_set(resource: Dict[str, Any],
                         attestor_set: Dict[str, Any],
                         domain: str,
                         ignore_fields: List[Dict[str, Any]],
                         path: str) -> Tuple[bool, str]:
    """verifyManifestAttestorSet (validate_manifest.go:198): expand
    static keys, count semantics, nested attestors."""
    from ..images.verify import expand_static_keys

    attestor_set = expand_static_keys(attestor_set)
    entries = attestor_set.get("entries") or []
    count = attestor_set.get("count")
    required = count if isinstance(count, int) and count > 0 else len(entries)
    verified_count = 0
    errors: List[str] = []
    verified_msgs: List[str] = []
    failed_msgs: List[str] = []
    for i, entry in enumerate(entries):
        entry_path = f"{path}.entries[{i}]"
        try:
            if entry.get("attestor") is not None:
                ok, reason = _verify_attestor_set(
                    resource, entry["attestor"], domain, ignore_fields,
                    entry_path + ".attestor")
            else:
                ok, reason = _verify_entry(
                    resource, entry, domain, ignore_fields, entry_path)
        except ManifestVerificationError as e:
            errors.append(str(e))
            continue
        if ok:
            verified_count += 1
            verified_msgs.append(reason)
        else:
            failed_msgs.append(reason)
        if verified_count >= required:
            return True, (f"manifest verification succeeded; verifiedCount "
                          f"{verified_count}; requiredCount {required}; "
                          f"message {','.join(verified_msgs)}")
    if errors:
        raise ManifestVerificationError("; ".join(errors))
    return False, (f"manifest verification failed; verifiedCount "
                   f"{verified_count}; requiredCount {required}; "
                   f"message {','.join(failed_msgs)}")


def _verify_entry(resource: Dict[str, Any],
                  entry: Dict[str, Any],
                  domain: str,
                  ignore_fields: List[Dict[str, Any]],
                  entry_path: str) -> Tuple[bool, str]:
    """k8sVerifyResource for one attestor entry (static key only)."""
    if entry.get("annotations"):
        res_ann = (resource.get("metadata") or {}).get("annotations") or {}
        for k, v in entry["annotations"].items():
            if res_ann.get(k) != v:
                raise ManifestVerificationError(
                    f"annotation {k} does not match at {entry_path}")
    keys = entry.get("keys") or {}
    if not keys:
        kind = next((k for k in ("certificates", "keyless") if entry.get(k)),
                    "unknown")
        raise ManifestVerificationError(
            f"attestor type {kind!r} at {entry_path} requires external "
            "sigstore infrastructure and is not supported offline")
    pem = keys.get("publicKeys") or ""
    if not pem.strip():
        raise ManifestVerificationError(f"no public key at {entry_path}")
    payload, manifest_docs = extract_signed_manifest(resource, domain)
    if payload is None:
        return False, (f"{entry_path}: signature verification failed; "
                       "no signed message found in annotations")
    signatures = extract_signatures(resource, domain)
    if not signatures:
        return False, (f"{entry_path}: no signature found in annotations")
    algorithm = keys.get("signatureAlgorithm") or "sha256"
    sig_ok = any(
        _ecdsa_verify(pem, sig, payload, algorithm) for sig in signatures)
    if not sig_ok:
        return False, f"{entry_path}: failed to verify signature"
    # mutation check: the admitted resource must match the signed
    # manifest up to ignoreFields
    manifest = _select_manifest(manifest_docs, resource)
    if manifest is None:
        return False, f"{entry_path}: no manifest found in signed message"
    diff = masked_diff(manifest, resource, ignore_fields, domain)
    if diff:
        return False, (f"{entry_path}: failed to verify signature. "
                       f"diff found; {', '.join(diff)}")
    return True, "signed by a valid signer"


# -- signed payload plumbing

def extract_signed_manifest(resource: Dict[str, Any], domain: str
                            ) -> Tuple[Optional[bytes], List[Dict[str, Any]]]:
    """Returns (signed payload bytes, manifest docs). The message
    annotation is base64(gzip(tar.gz)); the SIGNATURE covers the inner
    tar.gz bytes, and the tar members hold the original YAML."""
    annotations = (resource.get("metadata") or {}).get("annotations") or {}
    msg = annotations.get(f"{domain}/message")
    if not msg:
        return None, []
    try:
        raw = base64.b64decode(msg)
        payload = gzip.decompress(raw)
    except (binascii.Error, OSError, ValueError) as e:
        raise ManifestVerificationError(f"malformed signed message: {e}")
    docs: List[Dict[str, Any]] = []
    try:
        with tarfile.open(fileobj=io.BytesIO(payload), mode="r:*") as tar:
            for member in tar.getmembers():
                f = tar.extractfile(member)
                if f is None:
                    continue
                for d in yaml.safe_load_all(f.read().decode("utf-8", "replace")):
                    if isinstance(d, dict):
                        docs.append(d)
    except (tarfile.TarError, yaml.YAMLError, OSError):
        # not a tarball: the payload may be the raw YAML itself
        try:
            for d in yaml.safe_load_all(payload.decode("utf-8", "replace")):
                if isinstance(d, dict):
                    docs.append(d)
        except (yaml.YAMLError, UnicodeDecodeError):
            pass
    return payload, docs


def extract_signatures(resource: Dict[str, Any], domain: str) -> List[bytes]:
    """<domain>/signature plus numbered <domain>/signature_N keys."""
    annotations = (resource.get("metadata") or {}).get("annotations") or {}
    out = []
    for key, value in sorted(annotations.items()):
        if key == f"{domain}/signature" or re.fullmatch(
                re.escape(domain) + r"/signature_\d+", key):
            try:
                out.append(base64.b64decode(value))
            except (binascii.Error, ValueError):
                continue
    return out


def _ecdsa_verify(pem: str, signature: bytes, payload: bytes,
                  algorithm: str) -> bool:
    try:
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.hazmat.primitives.serialization import (
            load_pem_public_key,
        )
    except ImportError as e:  # pragma: no cover - baked into the image
        raise ManifestVerificationError(f"crypto backend unavailable: {e}")
    hash_algs = {"sha224": hashes.SHA224, "sha256": hashes.SHA256,
                 "sha384": hashes.SHA384, "sha512": hashes.SHA512}
    alg = hash_algs.get(algorithm or "sha256")
    if alg is None:
        raise ManifestVerificationError(
            f"invalid signature algorithm {algorithm!r}")
    try:
        key = load_pem_public_key(pem.encode())
    except (ValueError, TypeError) as e:
        raise ManifestVerificationError(f"failed to load public key: {e}")
    try:
        key.verify(signature, payload, ec.ECDSA(alg()))
        return True
    except InvalidSignature:
        return False
    except (ValueError, TypeError):
        return False


def _select_manifest(docs: List[Dict[str, Any]],
                     resource: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Pick the signed doc matching the admitted resource's identity
    (k8smanifest FindManifestYAML: apiVersion/kind/name)."""
    if not docs:
        return None
    meta = resource.get("metadata") or {}
    for d in docs:
        dmeta = d.get("metadata") or {}
        if (d.get("kind") == resource.get("kind")
                and d.get("apiVersion") == resource.get("apiVersion")
                and dmeta.get("name") == meta.get("name")):
            return d
    return docs[0]


# -- masked structural diff

def _flatten(node: Any, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(node, dict):
        if not node and prefix:
            out[prefix] = {}
        for k, v in node.items():
            _flatten(v, f"{prefix}.{k}" if prefix else str(k), out)
    elif isinstance(node, list):
        if not node and prefix:
            out[prefix] = []
        for i, v in enumerate(node):
            _flatten(v, f"{prefix}.{i}" if prefix else str(i), out)
    else:
        out[prefix] = node


def _pattern_to_regex(pattern: str) -> re.Pattern:
    # dot-separated path pattern; '*' spans one segment, a trailing
    # '*' segment also covers the whole subtree; literal keys may
    # contain dots (label/annotation keys), handled by non-greedy
    # segment matching on the joined path string
    parts = []
    for seg in pattern.split("."):
        if seg == "*":
            parts.append(r"[^.]*")
        else:
            parts.append(re.escape(seg).replace(r"\*", r"[^.]*"))
    body = r"\.".join(parts)
    return re.compile(rf"^{body}(\..*)?$")


def _kind_applies(objects: List[Dict[str, Any]], resource: Dict[str, Any]) -> bool:
    meta = resource.get("metadata") or {}
    for obj in objects or [{"kind": "*"}]:
        ok = True
        for attr, actual in (("kind", resource.get("kind", "")),
                             ("name", meta.get("name", "")),
                             ("namespace", meta.get("namespace", ""))):
            want = obj.get(attr)
            if want and not fnmatch.fnmatchcase(str(actual), str(want)):
                ok = False
                break
        if ok:
            return True
    return False


def masked_diff(manifest: Dict[str, Any], resource: Dict[str, Any],
                ignore_fields: List[Dict[str, Any]], domain: str) -> List[str]:
    """Structural diff of manifest vs resource after masking ignored
    fields and the signature annotations (the dryrun-less mutation
    check of k8smanifest.VerifyResource)."""
    patterns: List[re.Pattern] = [
        re.compile(rf"^metadata\.annotations\.{re.escape(domain)}/.*$"),
    ]
    for binding in ignore_fields:
        if not _kind_applies(binding.get("objects") or [], resource):
            continue
        for field in binding.get("fields") or []:
            patterns.append(_pattern_to_regex(field))

    def masked(doc: Dict[str, Any]) -> Dict[str, Any]:
        flat: Dict[str, Any] = {}
        _flatten(doc, "", flat)
        return {k: v for k, v in flat.items()
                if not any(p.match(k) for p in patterns)}

    m, r = masked(manifest), masked(resource)
    diff = []
    for k in sorted(set(m) | set(r)):
        if k not in r:
            diff.append(f"-{k}")
        elif k not in m:
            diff.append(f"+{k}")
        elif m[k] != r[k]:
            diff.append(f"~{k}")
    return diff
