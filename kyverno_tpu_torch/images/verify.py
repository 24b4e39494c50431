# Copied verbatim from kyverno_tpu/images/verify.py.
"""Image verification rule flow.

Re-implements the reference's verification orchestration
(pkg/engine/internal/imageverifier.go) above the pluggable backend in
``registry.py``:

- per-image guard chain (imageverifier.go:236-295): verify-images
  annotation tamper check, unchanged-image fast path, prior-annotation
  fast path, TTL cache lookup;
- attestor-set evaluation with required counts, nested attestors and
  static-key PEM splitting (imageverifier.go:489 verifyAttestorSet,
  :143 ExpandStaticKeys);
- attestation statement checks grouped by predicate type with
  any/all condition evaluation against the statement's predicate
  (imageverifier.go:206 EvaluateConditions, :405 verifyAttestations);
- digest mutation patches (imageverifier.go:200 makeAddDigestPatch)
  and the kyverno.io/verify-images metadata annotation.

The validate-side checks (required / verifyDigest,
handlers/validation/validate_image.go) live in ``validate_image``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..engine.conditions import evaluate_conditions
from ..engine.context import Context
from ..engine.response import RULE_TYPE_IMAGE_VERIFY, RuleResponse
from ..utils.wildcard import match as wildcard_match
from .cache import ImageVerifyCache
from .infos import ImageInfo
from .registry import (
    RegistryError,
    Response,
    StaticRegistry,
    VerificationFailed,
    VerifyOptions,
)

VERIFY_ANNOTATION = "kyverno.io/verify-images"  # api/kyverno/constants.go:13

_PEM_END = "-----END PUBLIC KEY-----"


@dataclass
class ImageVerificationMetadata:
    """image -> pass|skip|fail; serialized into the verify-images
    annotation so subsequent admissions skip re-verification."""

    data: Dict[str, str] = field(default_factory=dict)

    def add(self, image: str, status: str) -> None:
        self.data[image] = status

    def is_verified(self, image: str) -> bool:
        return self.data.get(image) == "pass"

    def merge(self, other: "ImageVerificationMetadata") -> None:
        self.data.update(other.data)

    def annotation_patch(self, resource: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """RFC6902 patch updating the verify-images annotation."""
        if not self.data:
            return None
        annotations = (resource.get("metadata") or {}).get("annotations") or {}
        existing = {}
        if VERIFY_ANNOTATION in annotations:
            try:
                existing = json.loads(annotations[VERIFY_ANNOTATION])
            except (ValueError, TypeError):
                existing = {}
        merged = {**existing, **self.data}
        # compact separators: the reference marshals with encoding/json
        # (no spaces), and conformance fixtures assert the exact string
        value = json.dumps(merged, sort_keys=True, separators=(",", ":"))
        if "metadata" not in resource:
            return {"op": "add", "path": "/metadata",
                    "value": {"annotations": {VERIFY_ANNOTATION: value}}}
        if not annotations:
            return {"op": "add", "path": "/metadata/annotations",
                    "value": {VERIFY_ANNOTATION: value}}
        op = "replace" if VERIFY_ANNOTATION in annotations else "add"
        return {"op": op,
                "path": "/metadata/annotations/" + VERIFY_ANNOTATION.replace("~", "~0").replace("/", "~1"),
                "value": value}

    @classmethod
    def parse_annotation(cls, data: str) -> "ImageVerificationMetadata":
        out = cls()
        parsed = json.loads(data)
        if not isinstance(parsed, dict):
            raise ValueError("verify-images annotation is not a map")
        for k, v in parsed.items():
            # historical form used booleans (engineapi.ParseImageMetadata)
            if isinstance(v, bool):
                out.data[k] = "pass" if v else "fail"
            else:
                out.data[k] = str(v)
        return out


def image_references(image_verify: Dict[str, Any]) -> List[str]:
    """The rule's reference patterns; the deprecated singular ``image``
    field folds in (image_verification_types.go:48)."""
    refs = image_verify.get("imageReferences") or []
    if not refs and image_verify.get("image"):
        refs = [image_verify["image"]]
    return refs


def matches_references(refs: List[str], image: str) -> bool:
    """imageverifier.go:99 matchReferences."""
    return any(wildcard_match(r, image) for r in refs)


def _required_count(attestor_set: Dict[str, Any]) -> int:
    entries = attestor_set.get("entries") or []
    count = attestor_set.get("count")
    if isinstance(count, int) and 0 < count <= len(entries):
        return count
    return len(entries)


def expand_static_keys(attestor_set: Dict[str, Any]) -> Dict[str, Any]:
    """Multi-key PEM bundles split into one attestor per key
    (imageverifier.go:143)."""
    entries = []
    for e in attestor_set.get("entries") or []:
        keys = (e.get("keys") or {}).get("publicKeys", "")
        if keys:
            parts = [p for p in keys.split(_PEM_END)[:-1]]
            if len(parts) > 1:
                for p in parts:
                    entries.append({"keys": {**e.get("keys", {}), "publicKeys": p + _PEM_END}})
                continue
        entries.append(e)
    return {"count": attestor_set.get("count"), "entries": entries}


class Verifier:
    """One rule's verifyImages evaluation against one resource."""

    def __init__(
        self,
        policy,
        rule_name: str,
        registry_client: Optional[StaticRegistry] = None,
        cache: Optional[ImageVerifyCache] = None,
        ivm: Optional[ImageVerificationMetadata] = None,
        context: Optional[Context] = None,
        old_resource: Optional[Dict[str, Any]] = None,
    ):
        self.policy = policy
        self.rule_name = rule_name
        self.registry = registry_client or StaticRegistry()
        self.cache = cache
        self.ivm = ivm if ivm is not None else ImageVerificationMetadata()
        self.ctx = context
        self.old_resource = old_resource

    # -- public entry (imageverifier.go:230 Verify)

    def verify(
        self,
        image_verify: Dict[str, Any],
        matched_images: List[ImageInfo],
        resource: Dict[str, Any],
    ) -> Tuple[List[Dict[str, Any]], List[RuleResponse]]:
        patches: List[Dict[str, Any]] = []
        responses: List[RuleResponse] = []
        for info in matched_images:
            image = str(info)

            if self._annotation_changed(resource):
                responses.append(RuleResponse.rule_fail(
                    self.rule_name, RULE_TYPE_IMAGE_VERIFY,
                    f"{VERIFY_ANNOTATION} annotation cannot be changed"))
                continue

            if self._image_unchanged(info, resource):
                self.ivm.add(image, "pass")
                continue

            if self._previously_verified(resource, image):
                self.ivm.add(image, "pass")
                continue

            digest = ""
            orig_digest = info.digest  # Go passes ImageInfo by value:
            # digests resolved during verification do not suppress the
            # mutate-digest patch (imageverifier.go:230,300)
            rule_resp: Optional[RuleResponse] = None
            if self.cache is not None and self.cache.get(self.policy, self.rule_name, image):
                rule_resp = RuleResponse.rule_pass(
                    self.rule_name, RULE_TYPE_IMAGE_VERIFY, "verified from cache")
                digest = info.digest
            else:
                rule_resp, digest = self._verify_image(image_verify, info)
                if rule_resp is not None and rule_resp.is_pass() and self.cache is not None:
                    self.cache.set(self.policy, self.rule_name, image)

            if image_verify.get("mutateDigest", True):
                patch, new_digest, err = self._mutate_digest(digest, info, orig_digest)
                if err:
                    responses.append(RuleResponse.rule_error(
                        self.rule_name, RULE_TYPE_IMAGE_VERIFY,
                        f"failed to update digest: {err}"))
                elif patch is not None:
                    if rule_resp is None:
                        rule_resp = RuleResponse.rule_pass(
                            self.rule_name, RULE_TYPE_IMAGE_VERIFY, "mutated image digest")
                    patches.append(patch)
                    info.digest = new_digest
                    image = str(info)

            if rule_resp is not None:
                if image_verify.get("attestors") or image_verify.get("attestations"):
                    status = ("pass" if rule_resp.is_pass()
                              else "skip" if rule_resp.status == "skip" else "fail")
                    self.ivm.add(image, status)
                responses.append(rule_resp)
        return patches, responses

    # -- guards

    def _annotation_changed(self, resource: Dict[str, Any]) -> bool:
        """imageverifier.go:62 HasImageVerifiedAnnotationChanged: a
        request may not alter a previously recorded verification."""
        old = self.old_resource
        if not old or not resource:
            return False
        new_val = ((resource.get("metadata") or {}).get("annotations") or {}).get(VERIFY_ANNOTATION, "")
        old_val = ((old.get("metadata") or {}).get("annotations") or {}).get(VERIFY_ANNOTATION, "")
        if new_val == old_val:
            return False
        try:
            new_obj = ImageVerificationMetadata.parse_annotation(new_val)
            old_obj = ImageVerificationMetadata.parse_annotation(old_val)
        except (ValueError, TypeError):
            return True
        for img, status in old_obj.data.items():
            if img in new_obj.data and new_obj.data[img] != status:
                return True
        return False

    def _image_unchanged(self, info: ImageInfo, resource: Dict[str, Any]) -> bool:
        """UPDATE fast path: the image field did not change
        (imageverifier.go:251-257 via JSONContext.HasChanged)."""
        old = self.old_resource
        if not old:
            return False
        return (_resolve_pointer(old, info.pointer)
                == _resolve_pointer(resource, info.pointer) is not None)

    def _previously_verified(self, resource: Dict[str, Any], image: str) -> bool:
        """Prior-verification fast path. Deliberate hardening over the
        reference (imageverifier.go:122 isImageVerified trusts the NEW
        resource's annotation): we only honor entries that were already
        present on the OLD resource, so a request cannot mint its own
        "pass" on CREATE or smuggle new entries in on UPDATE."""
        old = self.old_resource
        if not old:
            return False
        new_ann = ((resource.get("metadata") or {}).get("annotations") or {}).get(VERIFY_ANNOTATION)
        old_ann = ((old.get("metadata") or {}).get("annotations") or {}).get(VERIFY_ANNOTATION)
        if not new_ann or not old_ann:
            return False
        try:
            new_ivm = ImageVerificationMetadata.parse_annotation(new_ann)
            old_ivm = ImageVerificationMetadata.parse_annotation(old_ann)
        except (ValueError, TypeError):
            return False
        return new_ivm.is_verified(image) and old_ivm.is_verified(image)

    # -- core (imageverifier.go:323 verifyImage)

    def _verify_image(self, image_verify: Dict[str, Any], info: ImageInfo
                      ) -> Tuple[Optional[RuleResponse], str]:
        attestors = image_verify.get("attestors") or []
        attestations = image_verify.get("attestations") or []
        if not attestors and not attestations:
            return None, ""
        image = str(info)
        if self.ctx is not None:
            self.ctx.add_image_infos({"image": info.to_dict()})
        # reference checks hoisted above the attestors branch so
        # attestation-only rules honor them too (the reference nests
        # these under `if len(attestors) > 0`, imageverifier.go:344 —
        # which silently ignores skipImageReferences for
        # attestation-only rules; deliberate fix here)
        refs = image_references(image_verify)
        if refs and not matches_references(refs, image):
            return RuleResponse.rule_skip(
                self.rule_name, RULE_TYPE_IMAGE_VERIFY,
                f"skipping image reference image {image}"), ""
        if matches_references(image_verify.get("skipImageReferences") or [], image):
            self.ivm.add(image, "skip")
            return RuleResponse.rule_skip(
                self.rule_name, RULE_TYPE_IMAGE_VERIFY,
                f"skipping image reference image {image}"), ""
        if attestors:
            resp, registry_resp = self._verify_attestors(attestors, image_verify, info)
            if not resp.is_pass():
                return resp, ""
            if not info.digest and registry_resp is not None:
                info.digest = registry_resp.digest
            if not attestations:
                return resp, registry_resp.digest if registry_resp else ""
        return self._verify_attestations(image_verify, info)

    def _verify_attestors(self, attestors, image_verify, info
                          ) -> Tuple[RuleResponse, Optional[Response]]:
        image = str(info)
        registry_resp: Optional[Response] = None
        for attestor_set in attestors:
            try:
                registry_resp = self._verify_attestor_set(attestor_set, image_verify, info)
            except RegistryError as e:
                return RuleResponse.rule_error(
                    self.rule_name, RULE_TYPE_IMAGE_VERIFY,
                    f"failed to verify image {image}: {e}"), None
            except VerificationFailed as e:
                return RuleResponse.rule_fail(
                    self.rule_name, RULE_TYPE_IMAGE_VERIFY,
                    f"failed to verify image {image}: {e}"), None
        if registry_resp is None:
            return RuleResponse.rule_error(
                self.rule_name, RULE_TYPE_IMAGE_VERIFY, "invalid response"), None
        return RuleResponse.rule_pass(
            self.rule_name, RULE_TYPE_IMAGE_VERIFY,
            f"verified image signatures for {image}"), registry_resp

    def _verify_attestor_set(self, attestor_set, image_verify, info) -> Response:
        attestor_set = expand_static_keys(attestor_set)
        required = _required_count(attestor_set)
        verified = 0
        errors: List[str] = []
        had_registry_error = False
        last: Optional[Response] = None
        for entry in attestor_set.get("entries") or []:
            try:
                if entry.get("attestor"):
                    last = self._verify_attestor_set(entry["attestor"], image_verify, info)
                else:
                    opts = self._build_opts(entry, image_verify, str(info))
                    last = self.registry.verify_signature(opts)
                verified += 1
                if verified >= required:
                    return last
            except RegistryError as e:
                # network-layer failures keep their class so the rule
                # surfaces as ERROR, not FAIL (imageverifier.go:397)
                had_registry_error = True
                errors.append(str(e))
            except VerificationFailed as e:
                errors.append(str(e))
        if verified >= required and last is not None:
            return last
        msg = (f"verification failed, verifiedCount: {verified}, "
               f"requiredCount: {required}, error: {'; '.join(errors) or 'none'}")
        if had_registry_error:
            raise RegistryError(msg)
        raise VerificationFailed(msg)

    def _verify_attestations(self, image_verify, info
                             ) -> Tuple[RuleResponse, str]:
        """imageverifier.go:405 verifyAttestations."""
        image = str(info)
        for i, attestation in enumerate(image_verify.get("attestations") or []):
            path = f".attestations[{i}]"
            att_type = attestation.get("type") or attestation.get("predicateType") or ""
            if not att_type:
                return RuleResponse.rule_fail(
                    self.rule_name, RULE_TYPE_IMAGE_VERIFY,
                    f"{path}: missing type"), ""
            attestor_sets = attestation.get("attestors") or [{"entries": [{}]}]
            for attestor_set in attestor_sets:
                required = _required_count(attestor_set)
                verified = 0
                errors: List[str] = []
                for entry in attestor_set.get("entries") or []:
                    opts = self._build_opts(entry, image_verify, image)
                    opts.predicate_type = att_type
                    try:
                        resp = self.registry.fetch_attestations(opts)
                    except (VerificationFailed, RegistryError) as e:
                        errors.append(str(e))
                        continue
                    if not info.digest:
                        info.digest = resp.digest
                        image = str(info)
                    err = self._check_statements(resp.statements, attestation, att_type)
                    if err is None:
                        verified += 1
                        if verified >= required:
                            break
                    else:
                        errors.append(err)
                if verified < required:
                    msg = "; ".join(errors) or "attestations verification failed"
                    return RuleResponse.rule_fail(
                        self.rule_name, RULE_TYPE_IMAGE_VERIFY,
                        f"image attestations verification failed, "
                        f"verifiedCount: {verified}, requiredCount: {required}, "
                        f"error: {msg}"), ""
        return RuleResponse.rule_pass(
            self.rule_name, RULE_TYPE_IMAGE_VERIFY,
            f"verified image attestations for {image}"), info.digest

    def _check_statements(self, statements, attestation, att_type) -> Optional[str]:
        matching = [s for s in statements if s.get("type") == att_type]
        if not matching:
            return f"predicate type {att_type} not found"
        conditions = attestation.get("conditions") or []
        if not conditions:
            return None
        for s in matching:
            predicate = s.get("predicate")
            if not isinstance(predicate, dict):
                return f"failed to extract predicate from statement: {s}"
            ctx = self.ctx if self.ctx is not None else Context()
            ctx.checkpoint()
            try:
                ctx.add_json(predicate)
                if not evaluate_conditions(ctx, conditions):
                    return "attestation checks failed"
            except Exception as e:  # substitution/condition errors
                return f"failed to evaluate attestation conditions: {e}"
            finally:
                ctx.restore()
        return None

    def _build_opts(self, entry: Dict[str, Any], image_verify: Dict[str, Any],
                    image: str) -> VerifyOptions:
        opts = VerifyOptions(
            image=image,
            type=image_verify.get("type") or "Cosign",
            repository=image_verify.get("repository") or "",
        )
        keys = entry.get("keys") or {}
        if keys:
            opts.key = keys.get("publicKeys", "")
        certs = entry.get("certificates") or {}
        if certs:
            opts.cert = certs.get("cert", "")
            opts.cert_chain = certs.get("certChain", "")
        keyless = entry.get("keyless") or {}
        if keyless:
            opts.subject = keyless.get("subject", "")
            opts.issuer = keyless.get("issuer", "")
            opts.roots = keyless.get("roots", "")
        if entry.get("annotations"):
            opts.annotations = dict(entry["annotations"])
        if entry.get("repository"):
            opts.repository = entry["repository"]
        return opts

    # -- digest mutation (imageverifier.go:300 handleMutateDigest)

    def _mutate_digest(self, digest: str, info: ImageInfo, orig_digest: str = ""
                       ) -> Tuple[Optional[Dict[str, Any]], str, Optional[str]]:
        if orig_digest:
            # image already pinned in the resource — nothing to patch
            return None, orig_digest, None
        if not digest:
            digest = info.digest  # resolved during verification
        if not digest:
            try:
                digest = self.registry.fetch_digest(str(info))
            except RegistryError as e:
                return None, "", str(e)
        if not digest:
            return None, "", f"digest not found for {info}"
        base = f"{info.registry}/{info.path}" if info.registry else info.path
        tagged = f"{base}:{info.tag}" if info.tag else base
        patch = {"op": "replace", "path": info.pointer,
                 "value": f"{tagged}@{digest}"}
        return patch, digest, None


def _resolve_pointer(doc: Any, pointer: str) -> Any:
    node = doc
    for seg in [s for s in pointer.split("/") if s != ""]:
        seg = seg.replace("~1", "/").replace("~0", "~")
        if isinstance(node, list):
            try:
                node = node[int(seg)]
            except (ValueError, IndexError):
                return None
        elif isinstance(node, dict):
            node = node.get(seg)
        else:
            return None
    return node


def validate_image_rule(rule_verify_images: List[Dict[str, Any]],
                        rule_name: str,
                        images: List[ImageInfo],
                        resource: Dict[str, Any]) -> List[RuleResponse]:
    """The validate-side verifyImages handler, one AGGREGATED response
    per rule (handlers/validation/validate_image.go:66-101): fail fast
    on the first failing image (missing digest under verifyDigest, or
    unverified under required); pass when any image passed or no image
    applied; skip when every applicable image was skipped. An image
    that does not match the rule's imageReferences aborts the whole
    rule with NO response (validate_image.go:74-77), which the CLI test
    harness reports as "excluded"."""
    annotations = (resource.get("metadata") or {}).get("annotations") or {}
    ivm = None
    if VERIFY_ANNOTATION in annotations:
        try:
            ivm = ImageVerificationMetadata.parse_annotation(
                annotations[VERIFY_ANNOTATION])
        except (ValueError, TypeError):
            ivm = None
    skipped: List[str] = []
    passed: List[str] = []
    for iv in rule_verify_images:
        refs = image_references(iv)
        verify_digest = iv.get("verifyDigest", True)
        required = iv.get("required", True)
        for info in images:
            image = str(info)
            if not matches_references(refs, image):
                return []
            if verify_digest and not info.digest:
                return [RuleResponse.rule_fail(
                    rule_name, RULE_TYPE_IMAGE_VERIFY,
                    f"missing digest for {image}")]
            # images not under `required` count as "not applied": they
            # land in neither list, so an all-unrequired rule passes
            # (validate_image.go:103 zero-value status)
            status = None
            if required:
                # IsImageVerified (engine/utils/image.go:68): absent or
                # unparsable annotation, or absent image entry => fail
                status = ivm.data.get(image, "fail") if ivm else "fail"
                if status == "fail":
                    return [RuleResponse.rule_fail(
                        rule_name, RULE_TYPE_IMAGE_VERIFY,
                        f"unverified image {image}")]
            if status == "skip":
                skipped.append(image)
            elif status == "pass":
                passed.append(image)
    from ..engine.response import RULE_TYPE_VALIDATION

    if passed or not (passed or skipped):
        msg = "image verified"
        if skipped:
            msg += ", skipped images: " + " ".join(skipped)
        return [RuleResponse.rule_pass(rule_name, RULE_TYPE_VALIDATION, msg)]
    return [RuleResponse.rule_skip(
        rule_name, RULE_TYPE_VALIDATION,
        "image skipped, skipped images: " + " ".join(skipped))]


def has_verify_image_checks(rule_verify_images: List[Dict[str, Any]]) -> bool:
    """rule_types.go:139 HasVerifyImageChecks: any entry with
    verifyDigest or required (both default true)."""
    return any(iv.get("verifyDigest", True) or iv.get("required", True)
               for iv in rule_verify_images or [])


def validate_image(rule_verify_images: List[Dict[str, Any]],
                   rule_name: str,
                   images: List[ImageInfo],
                   resource: Dict[str, Any]) -> List[RuleResponse]:
    """The validate-side checks (handlers/validation/validate_image.go):
    verifyDigest requires a digest on matched images; required expects
    the image recorded as verified in the annotation."""
    out: List[RuleResponse] = []
    annotations = (resource.get("metadata") or {}).get("annotations") or {}
    ivm = None
    if VERIFY_ANNOTATION in annotations:
        try:
            ivm = ImageVerificationMetadata.parse_annotation(annotations[VERIFY_ANNOTATION])
        except (ValueError, TypeError):
            ivm = None
    for iv in rule_verify_images:
        refs = image_references(iv)
        for info in images:
            image = str(info)
            if refs and not matches_references(refs, image):
                continue
            if iv.get("verifyDigest", True) and not info.digest:
                out.append(RuleResponse.rule_fail(
                    rule_name, RULE_TYPE_IMAGE_VERIFY,
                    f"missing digest for {image}"))
                continue
            if iv.get("required", True):
                if ivm is None or not ivm.is_verified(image):
                    out.append(RuleResponse.rule_fail(
                        rule_name, RULE_TYPE_IMAGE_VERIFY,
                        f"image {image} is not verified"))
                    continue
            out.append(RuleResponse.rule_pass(
                rule_name, RULE_TYPE_IMAGE_VERIFY, f"image {image} verified"))
    return out
