"""Image verification and ``validate.manifests`` in the port's scalar
engine (``kyverno_tpu_torch/images``, ``engine/manifests.py``) against
the JAX package's, on the CPU (tolerance: exact).

The port's ``engine/engine.py`` reaches ``images`` and ``manifests``
for every ``verifyImages`` and ``validate.manifests`` rule, through
``Engine.validate`` and ``Engine.verify_and_patch_images``: the admission
server's mutate path, ``apply``, and the scan's scalar completion. Each
case feeds the same policy, resource and registry fixture (keys made
here with ``cryptography``; the registry signs with the same private
key in both packages) to both, and compares every rule response (name,
type, status, message, properties, exceptions, patched target), the
patched resource (digest patches and the verify-images annotation) and
the image verification metadata."""

import base64
import copy
import gzip
import importlib
import io
import json
import tarfile
from types import SimpleNamespace

import numpy as np
import pytest
import yaml

pytest.importorskip("cryptography")
pytestmark = pytest.mark.requires_crypto

from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec

from torch_parity_util import fresh_port_state  # noqa: F401

PKGS = ("kyverno_tpu", "kyverno_tpu_torch")


def _mods(pkg):
    imp = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(
        policy=imp("api.policy"), engine=imp("engine.engine"),
        pctx=imp("engine.policycontext"), ctx=imp("engine.context"),
        images=imp("images"), manifests=imp("engine.manifests"))


def _keypair():
    key = ec.generate_private_key(ec.SECP256R1())
    pem = key.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo).decode()
    return key, pem


PRIV_A, KEY_A = _keypair()
PRIV_B, KEY_B = _keypair()
DIGEST = "sha256:" + "ab" * 32
IMAGE = "ghcr.io/org/app:v1"


def pod(image=IMAGE, annotations=None, name="p"):
    meta = {"name": name, "namespace": "default"}
    if annotations:
        meta["annotations"] = annotations
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
            "spec": {"containers": [{"name": "main", "image": image}]}}


def vi_policy_doc(iv, name="check-images", rule="verify", action=None):
    spec = {"rules": [{
        "name": rule,
        "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
        "verifyImages": [iv]}]}
    if action:
        spec["validationFailureAction"] = action
    return {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": name}, "spec": spec}


# the C6 repro: a digest-only verifyImages rule, no attestors
DIGEST_ONLY = {"imageReferences": ["*"], "verifyDigest": True,
               "mutateDigest": False, "required": False}


def _registry(m, kind):
    reg = m.images.StaticRegistry()
    if kind == "empty":
        return reg
    reg.add_image(IMAGE, DIGEST)
    if kind == "unsigned":
        return reg
    reg.sign(IMAGE, key=PRIV_A)
    if kind == "attested":
        reg.attest(IMAGE, "https://slsa.dev/provenance/v0.2",
                   {"builder": {"id": "https://github.com/actions"}},
                   key=PRIV_A)
    if kind == "keyless":
        reg.sign(IMAGE,
                 subject="https://github.com/org/repo/.github/workflows/"
                         "build.yml@refs/heads/main",
                 issuer="https://token.actions.githubusercontent.com")
    return reg


def _keys(*pems, count=None):
    att = {"entries": [{"keys": {"publicKeys": p}} for p in pems]}
    if count is not None:
        att["count"] = count
    return [att]


def _ann(data):
    return {"kyverno.io/verify-images": json.dumps(data)}


# (id, verifyImages entry, registry kind, resource, old resource)
VERIFY_CASES = [
    ("digest-only", DIGEST_ONLY, "signed", pod("nginx:1.2"), None),
    ("pass-and-digest-patch",
     {"imageReferences": ["ghcr.io/org/*"], "attestors": _keys(KEY_A)},
     "signed", pod(), None),
    ("wrong-key",
     {"imageReferences": ["ghcr.io/org/*"], "attestors": _keys(KEY_B)},
     "signed", pod(), None),
    ("one-of-two",
     {"imageReferences": ["ghcr.io/org/*"],
      "attestors": _keys(KEY_B, KEY_A, count=1)}, "signed", pod(), None),
    ("all-of-two",
     {"imageReferences": ["ghcr.io/org/*"],
      "attestors": _keys(KEY_B, KEY_A)}, "signed", pod(), None),
    ("pem-bundle",
     {"imageReferences": ["ghcr.io/org/*"],
      "attestors": _keys(KEY_B + KEY_A, count=1)}, "signed", pod(), None),
    ("keyless-nested",
     {"imageReferences": ["ghcr.io/org/*"],
      "attestors": [{"entries": [{"attestor": {"entries": [{"keyless": {
          "subject": "https://github.com/org/*",
          "issuer": "https://token.actions.githubusercontent.com"}}]}}]}]},
     "keyless", pod(), None),
    ("keyless-wrong-subject",
     {"imageReferences": ["ghcr.io/org/*"],
      "attestors": [{"entries": [{"keyless": {
          "subject": "https://gitlab.com/*"}}]}]}, "keyless", pod(), None),
    ("attestation-condition-pass",
     {"imageReferences": ["ghcr.io/org/*"], "attestations": [{
         "type": "https://slsa.dev/provenance/v0.2",
         "attestors": _keys(KEY_A),
         "conditions": [{"all": [{"key": "{{ builder.id }}",
                                  "operator": "Equals",
                                  "value": "https://github.com/actions"}]}]}]},
     "attested", pod(), None),
    ("attestation-condition-fail",
     {"imageReferences": ["ghcr.io/org/*"], "attestations": [{
         "type": "https://slsa.dev/provenance/v0.2",
         "attestors": _keys(KEY_A),
         "conditions": [{"all": [{"key": "{{ builder.id }}",
                                  "operator": "Equals",
                                  "value": "other"}]}]}]},
     "attested", pod(), None),
    ("attestation-type-missing",
     {"imageReferences": ["ghcr.io/org/*"], "attestations": [{
         "type": "https://other/type", "attestors": _keys(KEY_A)}]},
     "attested", pod(), None),
    ("skip-references",
     {"imageReferences": ["ghcr.io/org/*"], "mutateDigest": False,
      "skipImageReferences": ["ghcr.io/org/app*"],
      "attestors": _keys(KEY_A)}, "signed", pod(), None),
    ("unmatched-image",
     {"imageReferences": ["quay.io/*"], "attestors": _keys(KEY_A)},
     "signed", pod(), None),
    ("registry-error",
     {"imageReferences": ["ghcr.io/org/*"], "mutateDigest": False,
      "attestors": _keys(KEY_A)}, "empty", pod(), None),
    ("annotation-tamper",
     {"imageReferences": ["ghcr.io/org/*"], "attestors": _keys(KEY_A)},
     "signed", pod(annotations=_ann({"img": "pass"})),
     pod(annotations=_ann({"img": "fail"}))),
    ("carried-over-annotation",
     {"imageReferences": ["ghcr.io/org/*"], "mutateDigest": False,
      "attestors": _keys(KEY_B)},
     "signed", pod(annotations=_ann({IMAGE: "pass"})),
     pod(annotations=_ann({IMAGE: "pass"}))),
    ("forged-annotation-on-create",
     {"imageReferences": ["ghcr.io/org/*"], "mutateDigest": False,
      "attestors": _keys(KEY_A)},
     "unsigned", pod(annotations=_ann({IMAGE: "pass"})), None),
]


def _context(m, pol, res, old=None):
    ctx = m.ctx.Context()
    ctx.add_resource(res)
    return m.pctx.PolicyContext(policy=pol, new_resource=res,
                                old_resource=old or {}, json_context=ctx)


def _outcome(resp):
    rules = [(r.name, r.rule_type, r.status, r.message, dict(r.properties),
              list(r.exceptions), r.patched_target)
             for r in resp.policy_response.rules]
    ivm = resp.image_verification_metadata
    return {"rules": rules, "patched": resp.patched_resource,
            "ivm": None if ivm is None else dict(ivm.data),
            "successful": resp.is_successful()}


def _verify(pkg, iv, reg_kind, res, old, exceptions=None):
    m = _mods(pkg)
    pol = m.policy.ClusterPolicy.from_dict(vi_policy_doc(iv))
    eng = m.engine.Engine(exceptions=exceptions or [])
    pctx = _context(m, pol, copy.deepcopy(res), copy.deepcopy(old))
    resp = eng.verify_and_patch_images(
        pctx, registry_client=_registry(m, reg_kind),
        iv_cache=m.images.ImageVerifyCache())
    return _outcome(resp)


def _validate(pkg, iv, res, old=None):
    m = _mods(pkg)
    pol = m.policy.ClusterPolicy.from_dict(vi_policy_doc(iv))
    pctx = _context(m, pol, copy.deepcopy(res), copy.deepcopy(old))
    return _outcome(m.engine.Engine().validate(pctx))


@pytest.mark.parametrize("case", VERIFY_CASES, ids=[c[0] for c in VERIFY_CASES])
def test_verify_and_patch_images_equals_reference(case):
    _, iv, reg_kind, res, old = case
    want = _verify("kyverno_tpu", iv, reg_kind, res, old)
    got = _verify("kyverno_tpu_torch", iv, reg_kind, res, old)
    assert got == want


@pytest.mark.parametrize("case", VERIFY_CASES, ids=[c[0] for c in VERIFY_CASES])
def test_validate_image_checks_equal_reference(case):
    """The validate side of a verifyImages rule (verifyDigest /
    required) after the verify stage's patches, as the server and
    ``apply`` run it."""
    _, iv, reg_kind, res, old = case
    patched = _verify("kyverno_tpu", iv, reg_kind, res, old)["patched"] or res
    want = _validate("kyverno_tpu", iv, patched, old)
    got = _validate("kyverno_tpu_torch", iv, patched, old)
    assert got == want


def test_digest_only_rule_fails_validate_as_the_reference_does():
    """The C6 repro: the port's ``Engine.validate`` raised ImportError."""
    want = _validate("kyverno_tpu", DIGEST_ONLY, pod("nginx:1.2"))
    got = _validate("kyverno_tpu_torch", DIGEST_ONLY, pod("nginx:1.2"))
    assert got == want
    assert [r[2] for r in got["rules"]] == ["fail"]


def test_excepted_verify_rule_skips_as_image_verify():
    exc = [{"metadata": {"name": "exc"},
            "spec": {"exceptions": [{"policyName": "check-images",
                                     "ruleNames": ["verify"]}]}}]
    iv = {"imageReferences": ["ghcr.io/org/*"], "attestors": _keys(KEY_A)}
    want = _verify("kyverno_tpu", iv, "signed", pod(), None, exc)
    got = _verify("kyverno_tpu_torch", iv, "signed", pod(), None, exc)
    assert got == want
    assert [(r[1], r[2]) for r in got["rules"]] == [("ImageVerify", "skip")]


def test_image_verification_metadata_patch_equals_reference():
    out = []
    for pkg in PKGS:
        ivm = _mods(pkg).images.ImageVerificationMetadata()
        ivm.add("img:1", "pass")
        out.append((ivm.annotation_patch(pod()),
                    ivm.annotation_patch({"kind": "Thing"})))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# validate.manifests, built as tests/test_manifests.py builds its cases


def _sign_resource(resource, private_keys, domain):
    manifest_yaml = yaml.safe_dump(resource, sort_keys=False).encode()
    tar_buf = io.BytesIO()
    with tarfile.open(fileobj=tar_buf, mode="w:gz") as tar:
        info = tarfile.TarInfo("resource-sig-tmp.yaml")
        info.size = len(manifest_yaml)
        info.mtime = 0
        tar.addfile(info, io.BytesIO(manifest_yaml))
    payload = tar_buf.getvalue()
    signed = copy.deepcopy(resource)
    ann = signed.setdefault("metadata", {}).setdefault("annotations", {})
    ann[f"{domain}/message"] = base64.b64encode(
        gzip.compress(payload, mtime=0)).decode()
    for i, key in enumerate(private_keys):
        sig = key.sign(payload, ec.ECDSA(hashes.SHA256()))
        ann[f"{domain}/{'signature' if i == 0 else f'signature_{i}'}"] = \
            base64.b64encode(sig).decode()
    return signed


def _service(name="web"):
    return {"apiVersion": "v1", "kind": "Service", "metadata": {"name": name},
            "spec": {"ports": [{"port": 80, "targetPort": 8080}],
                     "selector": {"app": name}}}


def _manifest_policy(attestors, ignore=None):
    manifests = {"attestors": attestors}
    if ignore:
        manifests["ignoreFields"] = ignore
    return {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": "check-manifest"},
            "spec": {"rules": [{
                "name": "verify-manifest",
                "match": {"any": [{"resources": {"kinds": ["Service"]}}]},
                "validate": {"manifests": manifests}}]}}


def _entry(pem):
    return {"keys": {"publicKeys": pem, "signatureAlgorithm": "sha256"}}


def _manifest_cases():
    dom = "cosign.sigstore.dev"
    signed = _sign_resource(_service(), [PRIV_A], dom)
    tampered = copy.deepcopy(signed)
    tampered["spec"]["ports"][0]["port"] = 443
    bad_sig = copy.deepcopy(signed)
    ann = bad_sig["metadata"]["annotations"]
    sig = bytearray(base64.b64decode(ann[f"{dom}/signature"]))
    sig[-1] ^= 0xFF
    ann[f"{dom}/signature"] = base64.b64encode(bytes(sig)).decode()
    two = _sign_resource(_service(), [PRIV_A, PRIV_B], dom)
    one_missing = copy.deepcopy(two)
    del one_missing["metadata"]["annotations"][f"{dom}/signature_1"]
    moved = copy.deepcopy(signed)
    moved["metadata"]["namespace"] = "prod"
    moved["status"] = {"loadBalancer": {}}
    a1 = [{"entries": [_entry(KEY_A)]}]
    return [
        ("signed", a1, None, signed),
        ("tampered", a1, None, tampered),
        ("unsigned", a1, None, _service()),
        ("wrong-key", [{"entries": [_entry(KEY_B)]}], None, signed),
        ("tampered-signature", a1, None, bad_sig),
        ("two-of-two", [{"count": 2, "entries": [_entry(KEY_A),
                                                 _entry(KEY_B)]}], None, two),
        ("two-of-two-one-missing",
         [{"count": 2, "entries": [_entry(KEY_A), _entry(KEY_B)]}], None,
         one_missing),
        ("one-of-two", [{"count": 1, "entries": [_entry(KEY_A),
                                                 {"keys": {"publicKeys":
                                                           KEY_B}}]}],
         None, signed),
        ("keyless", [{"entries": [{"keyless": {
            "issuer": "https://accounts.example.com"}}]}], None, signed),
        ("ignore-fields", a1,
         [{"fields": ["spec.ports.*.port"], "objects": [{"kind": "Service"}]}],
         tampered),
        ("default-ignores", a1, None, moved),
        ("pem-bundle", [{"entries": [_entry(KEY_A + "\n" + KEY_B)]}], None,
         two),
    ]


MANIFEST_CASES = _manifest_cases()


def _manifest_outcome(pkg, attestors, ignore, resource):
    m = _mods(pkg)
    pol = m.policy.ClusterPolicy.from_dict(_manifest_policy(attestors, ignore))
    resp = m.engine.Engine().validate(
        m.pctx.PolicyContext.build(pol, copy.deepcopy(resource)))
    return _outcome(resp)


@pytest.mark.parametrize("case", MANIFEST_CASES,
                         ids=[c[0] for c in MANIFEST_CASES])
def test_validate_manifests_equals_reference(case):
    _, attestors, ignore, resource = case
    want = _manifest_outcome("kyverno_tpu", attestors, ignore, resource)
    got = _manifest_outcome("kyverno_tpu_torch", attestors, ignore, resource)
    assert got == want


def test_masked_diff_equals_reference():
    a = {"kind": "Service", "metadata": {"name": "x"}, "spec": {"p": 1}}
    b = {"kind": "Service", "metadata": {"name": "x", "annotations": {
        "cosign.sigstore.dev/signature": "zzz"}}, "spec": {"p": 2, "q": 3}}
    out = [_mods(pkg).manifests.masked_diff(a, b, [], "cosign.sigstore.dev")
           for pkg in PKGS]
    assert out[0] == out[1]


def test_scan_completes_manifest_and_image_rules_as_the_reference():
    """The device engines leave these rules to the scalar completion:
    ``TorchEngine(device="cpu").scan`` gives the reference's table."""
    from kyverno_tpu.api.policy import ClusterPolicy as JPolicy
    from kyverno_tpu.tpu.engine import TpuEngine
    from kyverno_tpu_torch.api.policy import ClusterPolicy as TPolicy
    from kyverno_tpu_torch.tpu.engine import TorchEngine

    docs = [_manifest_policy([{"entries": [_entry(KEY_A)]}]),
            vi_policy_doc(DIGEST_ONLY, name="digests", rule="r")]
    resources = [c[3] for c in MANIFEST_CASES[:5]] + [
        pod("nginx:1.2", name="a"), pod(f"ghcr.io/org/app@{DIGEST}", name="b")]
    want = TpuEngine([JPolicy.from_dict(d) for d in docs]).scan(
        copy.deepcopy(resources))
    got = TorchEngine([TPolicy.from_dict(d) for d in docs],
                      device="cpu").scan(copy.deepcopy(resources))
    assert got.rules == want.rules
    np.testing.assert_array_equal(np.asarray(got.verdicts),
                                  np.asarray(want.verdicts))
