# Copied verbatim from kyverno_tpu/utils/tlsutil.py.
"""Self-signed CA + TLS serving-cert generation and rotation.

Mirrors pkg/tls: a self-signed CA valid ~1 year and a serving pair
valid ~6 months, renewed when within the renew-before window
(renewer.go:94 Renew, certRenewalInterval/caRenewalInterval). The
renewer hands fresh PEM files to a reload callback; the admission
server reloads its SSLContext in place so in-flight connections are
untouched and new handshakes pick up the new chain."""

from __future__ import annotations

import datetime
import ipaddress
import os
import threading
import time
from typing import Callable, List, Optional, Tuple

try:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID
except ImportError:  # pragma: no cover - environment-dependent
    # keep the module importable without `cryptography` (see
    # images/crypto.py); cert generation raises at use time
    class _MissingCrypto:
        def __getattr__(self, name):
            raise RuntimeError("the 'cryptography' library is not installed")

    x509 = hashes = serialization = rsa = NameOID = _MissingCrypto()  # type: ignore

CA_VALIDITY_S = 365 * 24 * 3600.0        # tls/certmanager: 1 year
CERT_VALIDITY_S = 183 * 24 * 3600.0      # ~6 months
RENEW_BEFORE_S = 15 * 24 * 3600.0        # renew-before 15d (renewer.go)


def _key() -> rsa.RSAPrivateKey:
    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def _pem_key(key) -> bytes:
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption())


def _pem_cert(cert) -> bytes:
    return cert.public_bytes(serialization.Encoding.PEM)


def generate_ca(common_name: str = "kyverno-tpu-ca",
                validity_s: float = CA_VALIDITY_S):
    """(ca_cert, ca_key) — self-signed root (tls/certificates.go)."""
    key = _key()
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name).issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(seconds=validity_s))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None), critical=True)
        .add_extension(x509.KeyUsage(
            digital_signature=True, key_cert_sign=True, crl_sign=True,
            content_commitment=False, key_encipherment=False,
            data_encipherment=False, key_agreement=False,
            encipher_only=False, decipher_only=False), critical=True)
        .sign(key, hashes.SHA256())
    )
    return cert, key


def generate_serving_cert(ca_cert, ca_key, dns_names: List[str],
                          validity_s: float = CERT_VALIDITY_S):
    """(cert, key) signed by the CA with SANs for the service DNS names
    (tls/certificates.go generateTLSPair)."""
    key = _key()
    now = datetime.datetime.now(datetime.timezone.utc)
    sans: List[x509.GeneralName] = []
    for n in dns_names:
        try:
            sans.append(x509.IPAddress(ipaddress.ip_address(n)))
        except ValueError:
            sans.append(x509.DNSName(n))
    cert = (
        x509.CertificateBuilder()
        .subject_name(x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, dns_names[0])]))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(seconds=validity_s))
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .add_extension(x509.ExtendedKeyUsage(
            [x509.oid.ExtendedKeyUsageOID.SERVER_AUTH]), critical=False)
        .sign(ca_key, hashes.SHA256())
    )
    return cert, key


def write_pem(path: str, *blocks: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for b in blocks:
            f.write(b)
    os.replace(tmp, path)


class CertRenewer:
    """pkg/tls/renewer.go: owns the CA + serving pair on disk, renews
    either when it enters the renew-before window, and invokes
    ``on_reload(certfile, keyfile, ca_pem)`` after every (re)issue."""

    def __init__(
        self,
        directory: str,
        dns_names: List[str],
        on_reload: Optional[Callable[[str, str, bytes], None]] = None,
        renew_before_s: float = RENEW_BEFORE_S,
        ca_validity_s: float = CA_VALIDITY_S,
        cert_validity_s: float = CERT_VALIDITY_S,
        clock=None,
    ):
        self.directory = directory
        self.dns_names = dns_names
        self.on_reload = on_reload
        self.renew_before_s = renew_before_s
        self.ca_validity_s = ca_validity_s
        self.cert_validity_s = cert_validity_s
        self._clock = clock or (lambda: datetime.datetime.now(datetime.timezone.utc))
        os.makedirs(directory, exist_ok=True)
        self.ca_cert = None
        self.ca_key = None
        self.cert = None
        self.renewals = 0
        self._lock = threading.Lock()

    @property
    def certfile(self) -> str:
        return os.path.join(self.directory, "tls.crt")

    @property
    def keyfile(self) -> str:
        return os.path.join(self.directory, "tls.key")

    @property
    def cafile(self) -> str:
        return os.path.join(self.directory, "ca.crt")

    def _expiring(self, cert) -> bool:
        if cert is None:
            return True
        remaining = (cert.not_valid_after_utc - self._clock()).total_seconds()
        return remaining <= self.renew_before_s

    def renew_if_needed(self) -> bool:
        """One renewer tick (renewer.go:94 Renew). Returns True when a
        new pair was issued."""
        with self._lock:
            issued = False
            if self._expiring(self.ca_cert):
                self.ca_cert, self.ca_key = generate_ca(validity_s=self.ca_validity_s)
                write_pem(self.cafile, _pem_cert(self.ca_cert))
                self.cert = None  # serving pair must re-issue under the new CA
                issued = True
            if self._expiring(self.cert):
                self.cert, key = generate_serving_cert(
                    self.ca_cert, self.ca_key, self.dns_names,
                    validity_s=self.cert_validity_s)
                write_pem(self.certfile, _pem_cert(self.cert), _pem_cert(self.ca_cert))
                write_pem(self.keyfile, _pem_key(key))
                self.renewals += 1
                issued = True
            if issued and self.on_reload is not None:
                self.on_reload(self.certfile, self.keyfile, _pem_cert(self.ca_cert))
            return issued

    def ca_pem(self) -> bytes:
        with self._lock:
            return _pem_cert(self.ca_cert) if self.ca_cert else b""

    def run(self, interval_s: float = 3600.0, stop: Optional[threading.Event] = None) -> None:
        while stop is None or not stop.is_set():
            self.renew_if_needed()
            time.sleep(interval_s)
