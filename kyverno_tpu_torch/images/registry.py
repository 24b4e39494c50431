# Copied verbatim from kyverno_tpu/images/registry.py.
"""Signature/attestation verifier backends.

The reference fans out to cosign (pkg/cosign/cosign.go) and notary
(pkg/notary/notary.go) over the network; the verification *flow*
(attestor sets, required counts, predicate-type statement matching,
digest resolution) lives above the backend in imageverifier.go. This
module defines that backend seam plus an offline static backend:

- ``ImageVerifier`` protocol: ``verify_signature(opts)`` /
  ``fetch_attestations(opts)`` returning ``Response(digest,
  statements)`` — the same split as images.ImageVerifier in
  pkg/images/client.go;
- ``StaticRegistry``: an in-memory registry whose stored artifacts are
  REAL signing envelopes (ECDSA simple-signing payloads and DSSE
  attestations, see crypto.py) verified cryptographically — used by
  tests, the CLI's offline mode and air-gapped deployments. A
  networked cosign/notary backend plugs in behind the same protocol.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..utils.wildcard import match as wildcard_match
from . import crypto


@dataclass
class VerifyOptions:
    image: str = ""
    type: str = "Cosign"           # Cosign | Notary
    key: str = ""                  # PEM public key (static key attestor)
    cert: str = ""                 # certificate attestor
    cert_chain: str = ""
    subject: str = ""              # keyless attestor
    issuer: str = ""
    roots: str = ""
    repository: str = ""
    annotations: Dict[str, str] = field(default_factory=dict)
    predicate_type: str = ""       # for attestation fetches


@dataclass
class Response:
    digest: str = ""
    statements: List[Dict[str, Any]] = field(default_factory=list)


class RegistryError(Exception):
    """Network/registry-layer failure — maps to a rule ERROR, not FAIL
    (imageverifier.go:397 handleRegistryErrors)."""


class VerificationFailed(Exception):
    """Signature did not verify — maps to attestor failure."""


class StaticRegistry:
    """Offline registry holding REAL signing envelopes. Content:

    images: {image_ref: {
        "digest": "sha256:...",
        "signatures": [{"payload": b64 simple-signing JSON,
                        "signature": b64 ECDSA-P256/SHA256 sig,
                        "cert": signer cert PEM (keyless) or "",
                        "type": "Cosign"|"Notary"}],
        "attestations": [{"envelope": DSSE envelope dict,
                          "cert": signer cert PEM or ""}],
    }}
    Verification is cryptographic: signatures must verify under the
    attestor's key (or a certificate chaining to trusted roots) and the
    signed payload must bind this image's digest — nothing is decided
    by metadata comparison. Lookup matches the exact reference first,
    then the tag-stripped repository path.
    """

    def __init__(self, images: Optional[Dict[str, Dict[str, Any]]] = None):
        self.images = dict(images or {})
        self._ca = None  # lazy offline Fulcio-style CA for keyless signing

    # -- registration helpers (test/CLI fixture building)

    def add_image(self, ref: str, digest: str) -> None:
        self.images.setdefault(ref, {})["digest"] = digest

    def _keyless_ca(self):
        if self._ca is None:
            self._ca = crypto.make_ca()
        return self._ca

    @property
    def ca_roots(self) -> str:
        """Trusted roots PEM for the registry's keyless CA."""
        return self._keyless_ca()[1]

    def _repo(self, ref: str) -> str:
        base = ref.split("@", 1)[0]
        return base.rsplit(":", 1)[0] if ":" in base.rsplit("/", 1)[-1] \
            else base

    def sign(self, ref: str, key=None, subject: str = "", issuer: str = "",
             annotations: Optional[Dict[str, str]] = None,
             sig_type: str = "Cosign") -> None:
        """Produce a real signature over the simple-signing payload.
        ``key`` is an EC private key (keyed attestor); with
        ``subject``/``issuer`` instead, an ephemeral certificate is
        issued from the registry CA (keyless attestor)."""
        entry = self.images.setdefault(ref, {})
        payload = crypto.simple_signing_payload(
            self._repo(ref), entry.get("digest", ""), annotations)
        cert_pem = ""
        if key is None:
            ca_priv, ca_cert = self._keyless_ca()
            key, cert_pem = crypto.issue_signer_cert(
                ca_priv, ca_cert, subject or "nobody@example.com", issuer)
        sig = crypto.sign_blob(key, payload)
        entry.setdefault("signatures", []).append({
            "payload": base64.b64encode(payload).decode(),
            "signature": base64.b64encode(sig).decode(),
            "cert": cert_pem, "type": sig_type,
        })

    def attest(self, ref: str, predicate_type: str, predicate: Dict[str, Any],
               key=None, subject: str = "", issuer: str = "") -> None:
        """Produce a real DSSE/in-toto attestation envelope."""
        entry = self.images.setdefault(ref, {})
        statement = crypto.make_statement(
            entry.get("digest", ""), predicate_type, predicate,
            name=self._repo(ref))
        cert_pem = ""
        if key is None:
            ca_priv, ca_cert = self._keyless_ca()
            key, cert_pem = crypto.issue_signer_cert(
                ca_priv, ca_cert, subject or "nobody@example.com", issuer)
        entry.setdefault("attestations", []).append({
            "envelope": crypto.dsse_sign(key, statement), "cert": cert_pem,
        })

    # -- lookup

    def _entry(self, image: str) -> Dict[str, Any]:
        if image in self.images:
            return self.images[image]
        base = image.split("@", 1)[0]
        if base in self.images:
            return self.images[base]
        repo = base.rsplit(":", 1)[0] if ":" in base.rsplit("/", 1)[-1] else base
        if repo in self.images:
            return self.images[repo]
        raise RegistryError(f"image not found in registry: {image}")

    def _attestor_key(self, opts: VerifyOptions,
                      cert_pem: str) -> Optional[str]:
        """Resolve the public key PEM this attestor accepts for a given
        signature, applying certificate checks for keyless/cert
        attestors. Returns None when the attestor cannot accept the
        signature (wrong identity / untrusted chain)."""
        if opts.key:
            return opts.key
        if opts.cert:
            # certificate attestor: the signature must carry exactly
            # this certificate (and it must chain when a chain is given)
            if not cert_pem or cert_pem.strip() != opts.cert.strip():
                return None
            if opts.cert_chain:
                try:
                    crypto.verify_cert_identity(cert_pem, opts.cert_chain)
                except crypto.CryptoError:
                    return None
            return crypto.cert_public_pem(cert_pem)
        if opts.subject or opts.issuer:
            # keyless: chain to roots, then identity-match SAN/issuer
            if not cert_pem:
                return None
            roots = opts.roots or self.ca_roots
            try:
                subject, issuer = crypto.verify_cert_identity(cert_pem, roots)
            except crypto.CryptoError:
                return None
            if opts.subject and not wildcard_match(opts.subject, subject):
                return None
            if opts.issuer and issuer != opts.issuer:
                return None
            return crypto.cert_public_pem(cert_pem)
        # unconstrained attestor (attestations block without attestors):
        # signature crypto still runs — a certificate-bearing envelope
        # verifies against the trusted roots with no identity pinning;
        # a keyed envelope has nothing to verify against and is skipped
        if cert_pem:
            try:
                crypto.verify_cert_identity(cert_pem, opts.roots or self.ca_roots)
            except crypto.CryptoError:
                return None
            return crypto.cert_public_pem(cert_pem)
        return None

    # -- ImageVerifier protocol

    def fetch_digest(self, image: str) -> str:
        """Digest-only resolution (mutateDigest on unverified images,
        imageverifier.go:300 handleMutateDigest -> fetchImageDigest)."""
        return self._entry(image).get("digest", "")

    def verify_signature(self, opts: VerifyOptions) -> Response:
        """Cryptographically verify a simple-signing payload
        (cosign.go VerifySignature): the ECDSA signature must verify
        under the attestor's key, and the signed payload must bind this
        image's manifest digest and carry any required annotations."""
        entry = self._entry(opts.image)
        digest = entry.get("digest", "")
        last = "no signatures found"
        for sig in entry.get("signatures", []):
            if sig.get("type", "Cosign") != opts.type:
                continue
            pub = self._attestor_key(opts, sig.get("cert", ""))
            if pub is None:
                last = "no signature matched the attestor identity"
                continue
            payload = base64.b64decode(sig.get("payload", ""))
            raw = base64.b64decode(sig.get("signature", ""))
            try:
                if not crypto.verify_blob(pub, raw, payload):
                    last = "signature verification failed"
                    continue
                doc = crypto.parse_simple_signing(payload)
            except crypto.CryptoError as e:
                last = str(e)
                continue
            critical = doc.get("critical") or {}
            bound = (critical.get("image") or {}).get(
                "docker-manifest-digest", "")
            if bound != digest:
                last = (f"payload digest mismatch: signed {bound}, "
                        f"manifest has {digest}")
                continue
            optional = doc.get("optional") or {}
            if any(optional.get(k) != v
                   for k, v in (opts.annotations or {}).items()):
                last = "required annotations missing from signed payload"
                continue
            return Response(digest=digest)
        raise VerificationFailed(
            f"image {opts.image}: {last}")

    def fetch_attestations(self, opts: VerifyOptions) -> Response:
        """Verify DSSE envelopes and return the in-toto statements
        whose subject binds this image (cosign.go FetchAttestations)."""
        entry = self._entry(opts.image)
        digest = entry.get("digest", "")
        statements = []
        for att in entry.get("attestations", []):
            pub = self._attestor_key(opts, att.get("cert", ""))
            if pub is None:
                continue
            try:
                stmt = crypto.dsse_verify(pub, att.get("envelope") or {})
            except crypto.CryptoError:
                continue
            algo_hex = digest.partition(":")
            subjects = stmt.get("subject") or []
            if not any((s.get("digest") or {}).get(algo_hex[0] or "sha256")
                       == algo_hex[2] for s in subjects):
                continue  # statement signed for a different image
            statements.append({"type": stmt.get("predicateType", ""),
                               "predicate": stmt.get("predicate", {})})
        if not statements:
            raise VerificationFailed(
                f"no verifiable attestations for image {opts.image}")
        return Response(digest=digest, statements=statements)
