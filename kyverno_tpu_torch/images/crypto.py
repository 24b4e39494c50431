# Copied verbatim from kyverno_tpu/images/crypto.py.
"""Signing-envelope cryptography for image verification.

Real ECDSA P-256/SHA-256 over the two envelope formats the reference
verifies (pkg/cosign/cosign.go):

- **simple-signing payloads**: the cosign signature payload — a JSON
  document binding the image's docker-reference and manifest digest
  (``critical``) plus optional annotations — signed directly
  (cosign.go:matchSignatures / payload verification);
- **DSSE / in-toto attestation envelopes**: a base64 in-toto Statement
  signed over the DSSE v1 pre-authentication encoding
  (cosign.go:decodeStatements, in-toto attestation verify).

Keyless verification is modeled with an offline Fulcio-style CA:
ephemeral signer certificates carry the identity in a SAN and the OIDC
issuer in the Fulcio issuer extension (OID 1.3.6.1.4.1.57264.1.1);
verification checks the signature under the certificate key, validates
the chain to the trusted roots, and matches subject/issuer
(cosign.go keyless path). All primitives come from the ``cryptography``
library — no verdict is ever decided by metadata comparison.
"""

from __future__ import annotations

import base64
import datetime
import json
from typing import Any, Dict, List, Optional, Tuple

class CryptoError(Exception):
    pass


try:
    from cryptography import x509
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    # Fulcio OIDC issuer extension
    FULCIO_ISSUER_OID = x509.ObjectIdentifier("1.3.6.1.4.1.57264.1.1")
except ImportError:  # pragma: no cover - environment-dependent
    # the container may not ship `cryptography`; importing this module
    # must still succeed (the admission plane imports the images
    # subsystem unconditionally) — actual signature work raises
    # CryptoError at use time instead
    class InvalidSignature(Exception):  # type: ignore[no-redef]
        pass

    class _MissingCrypto:
        def __getattr__(self, name):
            raise CryptoError("the 'cryptography' library is not installed")

    x509 = hashes = serialization = ec = NameOID = _MissingCrypto()  # type: ignore
    FULCIO_ISSUER_OID = None


# ---------------------------------------------------------------------------
# keys


def generate_keypair() -> Tuple[ec.EllipticCurvePrivateKey, str]:
    """(private key, public key PEM) — the cosign key-pair equivalent."""
    priv = ec.generate_private_key(ec.SECP256R1())
    pem = priv.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo).decode()
    return priv, pem


def load_public_key(pem: str):
    try:
        return serialization.load_pem_public_key(pem.encode())
    except Exception as e:  # noqa: BLE001
        raise CryptoError(f"invalid public key: {e}")


def sign_blob(priv: ec.EllipticCurvePrivateKey, data: bytes) -> bytes:
    return priv.sign(data, ec.ECDSA(hashes.SHA256()))


def verify_blob(pub_pem: str, signature: bytes, data: bytes) -> bool:
    key = load_public_key(pub_pem)
    try:
        key.verify(signature, data, ec.ECDSA(hashes.SHA256()))
        return True
    except InvalidSignature:
        return False


# ---------------------------------------------------------------------------
# simple-signing payloads (cosign signature format)


def simple_signing_payload(reference: str, digest: str,
                           annotations: Optional[Dict[str, str]] = None) -> bytes:
    doc = {
        "critical": {
            "identity": {"docker-reference": reference},
            "image": {"docker-manifest-digest": digest},
            "type": "cosign container image signature",
        },
        "optional": dict(annotations or {}),
    }
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()


def parse_simple_signing(payload: bytes) -> Dict[str, Any]:
    try:
        doc = json.loads(payload)
        assert isinstance(doc, dict) and "critical" in doc
        return doc
    except Exception as e:  # noqa: BLE001
        raise CryptoError(f"malformed simple-signing payload: {e}")


# ---------------------------------------------------------------------------
# DSSE / in-toto


def pae(payload_type: str, payload: bytes) -> bytes:
    """DSSE v1 pre-authentication encoding."""
    return (b"DSSEv1 %d %s %d %s"
            % (len(payload_type), payload_type.encode(),
               len(payload), payload))


INTOTO_PAYLOAD_TYPE = "application/vnd.in-toto+json"


def make_statement(digest: str, predicate_type: str,
                   predicate: Dict[str, Any], name: str = "") -> Dict[str, Any]:
    algo, _, hexd = digest.partition(":")
    return {
        "_type": "https://in-toto.io/Statement/v0.1",
        "subject": [{"name": name, "digest": {algo or "sha256": hexd}}],
        "predicateType": predicate_type,
        "predicate": predicate,
    }


def dsse_sign(priv: ec.EllipticCurvePrivateKey,
              statement: Dict[str, Any]) -> Dict[str, Any]:
    payload = json.dumps(statement, sort_keys=True,
                         separators=(",", ":")).encode()
    sig = sign_blob(priv, pae(INTOTO_PAYLOAD_TYPE, payload))
    return {
        "payloadType": INTOTO_PAYLOAD_TYPE,
        "payload": base64.b64encode(payload).decode(),
        "signatures": [{"sig": base64.b64encode(sig).decode()}],
    }


def dsse_verify(pub_pem: str, envelope: Dict[str, Any]) -> Dict[str, Any]:
    """Verify a DSSE envelope; returns the decoded statement."""
    try:
        payload = base64.b64decode(envelope["payload"])
        sigs = [base64.b64decode(s["sig"])
                for s in envelope.get("signatures", [])]
        ptype = envelope.get("payloadType", "")
    except Exception as e:  # noqa: BLE001
        raise CryptoError(f"malformed DSSE envelope: {e}")
    data = pae(ptype, payload)
    if not any(verify_blob(pub_pem, s, data) for s in sigs):
        raise CryptoError("DSSE signature verification failed")
    try:
        return json.loads(payload)
    except Exception as e:  # noqa: BLE001
        raise CryptoError(f"DSSE payload is not a statement: {e}")


# ---------------------------------------------------------------------------
# offline Fulcio-style CA (keyless + certificate attestors)


def make_ca(common_name: str = "kyverno-tpu test CA") -> Tuple[
        ec.EllipticCurvePrivateKey, str]:
    priv = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(priv.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=365))
            .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                           critical=True)
            .sign(priv, hashes.SHA256()))
    return priv, cert.public_bytes(serialization.Encoding.PEM).decode()


def issue_signer_cert(ca_priv: ec.EllipticCurvePrivateKey, ca_cert_pem: str,
                      subject: str, issuer_url: str = "") -> Tuple[
        ec.EllipticCurvePrivateKey, str]:
    """Ephemeral signer certificate: identity in the SAN (URI or
    email), OIDC issuer in the Fulcio extension."""
    ca_cert = x509.load_pem_x509_certificate(ca_cert_pem.encode())
    priv = ec.generate_private_key(ec.SECP256R1())
    san: x509.GeneralName
    if "://" in subject:
        san = x509.UniformResourceIdentifier(subject)
    else:
        san = x509.RFC822Name(subject)
    now = datetime.datetime.now(datetime.timezone.utc)
    builder = (x509.CertificateBuilder()
               .subject_name(x509.Name([]))
               .issuer_name(ca_cert.subject)
               .public_key(priv.public_key())
               .serial_number(x509.random_serial_number())
               .not_valid_before(now - datetime.timedelta(minutes=5))
               .not_valid_after(now + datetime.timedelta(minutes=20))
               .add_extension(x509.SubjectAlternativeName([san]),
                              critical=False))
    if issuer_url:
        builder = builder.add_extension(
            x509.UnrecognizedExtension(FULCIO_ISSUER_OID, issuer_url.encode()),
            critical=False)
    cert = builder.sign(ca_priv, hashes.SHA256())
    return priv, cert.public_bytes(serialization.Encoding.PEM).decode()


def verify_cert_identity(cert_pem: str, roots_pem: str) -> Tuple[str, str]:
    """Validate the signer certificate against trusted roots and return
    (subject identity, OIDC issuer). Raises CryptoError on an untrusted
    or expired certificate."""
    try:
        cert = x509.load_pem_x509_certificate(cert_pem.encode())
    except Exception as e:  # noqa: BLE001
        raise CryptoError(f"invalid signer certificate: {e}")
    roots = []
    for block in roots_pem.split("-----END CERTIFICATE-----"):
        block = block.strip()
        if block:
            roots.append(x509.load_pem_x509_certificate(
                (block + "\n-----END CERTIFICATE-----\n").encode()))
    for root in roots:
        try:
            cert.verify_directly_issued_by(root)
            break
        except Exception:  # noqa: BLE001
            continue
    else:
        raise CryptoError("signer certificate does not chain to a trusted root")
    now = datetime.datetime.now(datetime.timezone.utc)
    if not (cert.not_valid_before_utc <= now <= cert.not_valid_after_utc):
        raise CryptoError("signer certificate expired or not yet valid")
    subject = ""
    try:
        san = cert.extensions.get_extension_for_class(
            x509.SubjectAlternativeName).value
        vals = san.get_values_for_type(x509.UniformResourceIdentifier) \
            + san.get_values_for_type(x509.RFC822Name)
        subject = vals[0] if vals else ""
    except x509.ExtensionNotFound:
        pass
    issuer = ""
    try:
        ext = cert.extensions.get_extension_for_oid(FULCIO_ISSUER_OID).value
        issuer = bytes(ext.value).decode()
    except x509.ExtensionNotFound:
        pass
    return subject, issuer


def cert_public_pem(cert_pem: str) -> str:
    cert = x509.load_pem_x509_certificate(cert_pem.encode())
    return cert.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo).decode()
