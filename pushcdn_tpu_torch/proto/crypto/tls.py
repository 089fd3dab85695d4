"""TLS certificate plumbing: a pinned local CA + per-process leaf certs.

Capability parity with cdn-proto/src/crypto/tls.rs:22-155 + build.rs:22-59:
the reference generates a local CA at *build* time and bakes it in; every
process derives a leaf cert (SAN ``espresso``) from that CA at startup, and
clients trust either the baked-in local CA or a hardcoded production CA.

TPU-native redesign: no build step — the local CA is a COMMITTED module
(``_local_ca.py``, regenerated by ``scripts/gen_local_ca.py``), the direct
analog of the reference baking LOCAL_CA_CERT/LOCAL_CA_KEY into every
binary: its private key is public by design and it is for local testing
only, exactly like the reference's committed local CA. Every process of
one checkout therefore shares a trust root with zero configuration.
Production deployments supply their own CA via --ca-cert-path/--ca-key-path
or PUSHCDN_CA_CERT_PATH/_KEY_PATH (parity: the reference's hardcoded
PROD_CA_CERT). Leaf certs are derived at process start with SAN
``pushcdn``; clients connecting with ``use_local_authority=True`` trust
the local CA and expect that SAN. TLS 1.3 is pinned on both sides
(matching the quinn/rustls configuration the reference uses).
"""

from __future__ import annotations

import datetime
import ipaddress
import os
import ssl
import tempfile
from dataclasses import dataclass
from typing import Optional, Tuple

try:  # images without the package fall back to the openssl CLI below
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID
    _HAVE_CRYPTOGRAPHY = True
except ImportError:
    _HAVE_CRYPTOGRAPHY = False

# The SAN every broker/marshal leaf cert carries (reference uses "espresso",
# tls.rs:52-93).
LOCAL_SAN = "pushcdn"

_CA_CACHE: Optional[Tuple[bytes, bytes]] = None  # (cert_pem, key_pem)
_PATH_CA_CACHE: dict = {}                        # (cert_path, key_path) -> pair
# Set whenever load_ca resolves an explicitly-configured CA (flags or env):
# the whole process's use_local_authority=True dials trust that CA from
# then on. One trust root per process — serve and dial must agree, or a
# broker configured via --ca-cert-path serves the operator CA while its
# mesh dials still trust the baked-in default and every handshake fails.
_DIAL_CA_OVERRIDE: Optional[bytes] = None        # ca_cert_pem


@dataclass
class Certificate:
    """A leaf certificate + key, PEM-encoded, ready for an SSL context."""

    cert_pem: bytes
    key_pem: bytes
    ca_cert_pem: bytes

    def server_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_3
        with tempfile.TemporaryDirectory() as d:
            cert_f, key_f = os.path.join(d, "c.pem"), os.path.join(d, "k.pem")
            with open(cert_f, "wb") as f:
                f.write(self.cert_pem)
            with open(key_f, "wb") as f:
                f.write(self.key_pem)
            ctx.load_cert_chain(cert_f, key_f)
        return ctx

    def client_context(self) -> ssl.SSLContext:
        """Context trusting this cert's CA, expecting SAN ``pushcdn``."""
        return _pinned_client_context(self.ca_cert_pem)


def _pinned_client_context(ca_cert_pem: bytes) -> ssl.SSLContext:
    """TLS 1.3 client context pinned to one CA, hostname-checked."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_3
    ctx.load_verify_locations(cadata=ca_cert_pem.decode())
    ctx.check_hostname = True
    return ctx


def tls_available() -> bool:
    """True when leaf certificates can be derived in this image — via the
    ``cryptography`` package or the ``openssl`` CLI. TLS-bearing
    transports (TcpTls, Quic) and their tests gate on this."""
    if _HAVE_CRYPTOGRAPHY:
        return True
    import shutil
    return shutil.which("openssl") is not None


def _generate_cert_openssl(ca_cert_pem: bytes,
                           ca_key_pem: bytes) -> "Certificate":
    """Dependency-gate fallback: derive the leaf via the ``openssl`` CLI
    when the ``cryptography`` package is not installed (this image bakes
    no wheel for it; installing is disallowed). Same output shape: P-256
    leaf, SAN ``pushcdn``/localhost/127.0.0.1, signed by the given CA."""
    import secrets
    import subprocess
    from pushcdn_tpu_torch.proto.error import ErrorKind, bail
    with tempfile.TemporaryDirectory() as d:
        def p(name):  # noqa: E306
            return os.path.join(d, name)
        with open(p("ca.pem"), "wb") as f:
            f.write(ca_cert_pem)
        with open(p("ca_key.pem"), "wb") as f:
            f.write(ca_key_pem)
        with open(p("ext.cnf"), "w") as f:
            f.write("subjectAltName=DNS:%s,DNS:localhost,IP:127.0.0.1\n"
                    % LOCAL_SAN)
        try:
            run = lambda *args: subprocess.run(  # noqa: E731
                args, check=True, capture_output=True, timeout=30)
            run("openssl", "genpkey", "-algorithm", "EC",
                "-pkeyopt", "ec_paramgen_curve:P-256", "-out", p("key.pem"))
            run("openssl", "req", "-new", "-key", p("key.pem"),
                "-subj", f"/CN={LOCAL_SAN}", "-out", p("leaf.csr"))
            run("openssl", "x509", "-req", "-in", p("leaf.csr"),
                "-CA", p("ca.pem"), "-CAkey", p("ca_key.pem"),
                "-set_serial", str(secrets.randbits(63)), "-days", "365",
                "-sha256", "-extfile", p("ext.cnf"), "-out", p("cert.pem"))
            with open(p("cert.pem"), "rb") as f:
                cert_pem = f.read()
            with open(p("key.pem"), "rb") as f:
                key_pem = f.read()
        except (subprocess.SubprocessError, OSError) as exc:
            bail(ErrorKind.CRYPTO,
                 "TLS unavailable: neither the cryptography package nor a "
                 "working openssl CLI is present to derive a leaf cert", exc)
        return Certificate(cert_pem=cert_pem, key_pem=key_pem,
                           ca_cert_pem=ca_cert_pem)


def _generate_ca() -> Tuple[bytes, bytes]:
    """Make a fresh CA (parity: scripts/gen-ca.bash + build.rs:22-59)."""
    if not _HAVE_CRYPTOGRAPHY:
        from pushcdn_tpu_torch.proto.error import ErrorKind, bail
        bail(ErrorKind.CRYPTO,
             "generating a fresh CA needs the cryptography package; this "
             "checkout is missing its baked-in _local_ca module")
    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([
        x509.NameAttribute(NameOID.COMMON_NAME, "pushcdn local CA"),
        x509.NameAttribute(NameOID.ORGANIZATION_NAME, "pushcdn-tpu"),
    ])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(days=1))
        .not_valid_after(now + datetime.timedelta(days=3650))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None), critical=True)
        .sign(key, hashes.SHA256())
    )
    return (
        cert.public_bytes(serialization.Encoding.PEM),
        key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        ),
    )


def load_ca(ca_cert_path: Optional[str] = None,
            ca_key_path: Optional[str] = None) -> Tuple[bytes, bytes]:
    """Load a CA (parity ``load_ca``, tls.rs:52-70: None → baked-in local
    CA). Resolution order: explicit paths → ``PUSHCDN_CA_CERT_PATH`` /
    ``PUSHCDN_CA_KEY_PATH`` env (so the *dial* side of cross-process
    deployments can trust the operator CA without a code path for it) →
    the baked-in local CA (``_local_ca.py``, the analog of the
    reference's build-time LOCAL_CA_CERT/LOCAL_CA_KEY constants — every
    process of one checkout shares it, which is what makes zero-config
    cross-process TLS/QUIC work)."""
    global _CA_CACHE
    if bool(ca_cert_path) != bool(ca_key_path):
        from pushcdn_tpu_torch.proto.error import ErrorKind, bail
        bail(ErrorKind.PARSE,
             "provide both ca_cert_path and ca_key_path, or neither")
    if not ca_cert_path:
        ca_cert_path = os.environ.get("PUSHCDN_CA_CERT_PATH") or None
        ca_key_path = os.environ.get("PUSHCDN_CA_KEY_PATH") or None
        if bool(ca_cert_path) != bool(ca_key_path):
            from pushcdn_tpu_torch.proto.error import ErrorKind, bail
            bail(ErrorKind.PARSE,
                 "set both PUSHCDN_CA_CERT_PATH and PUSHCDN_CA_KEY_PATH, "
                 "or neither")
    if ca_cert_path and ca_key_path:
        global _DIAL_CA_OVERRIDE
        cached = _PATH_CA_CACHE.get((ca_cert_path, ca_key_path))
        if cached is None:
            with open(ca_cert_path, "rb") as f:
                cert_pem = f.read()
            with open(ca_key_path, "rb") as f:
                key_pem = f.read()
            cached = _PATH_CA_CACHE[(ca_cert_path, ca_key_path)] = \
                (cert_pem, key_pem)
        # anchor the dial side too (see _DIAL_CA_OVERRIDE above)
        _DIAL_CA_OVERRIDE = cached[0]
        return cached
    if _CA_CACHE is None:
        try:
            from pushcdn_tpu_torch.proto.crypto import _local_ca
            _CA_CACHE = (_local_ca.CERT_PEM, _local_ca.KEY_PEM)
        except ImportError:  # regenerated tree without the baked module
            _CA_CACHE = _generate_ca()
    return _CA_CACHE


def generate_cert_from_ca(ca_cert_pem: bytes, ca_key_pem: bytes) -> Certificate:
    """Derive a per-process leaf cert with SAN ``pushcdn`` (parity
    ``generate_cert_from_ca``, tls.rs:52-93)."""
    if not _HAVE_CRYPTOGRAPHY:
        return _generate_cert_openssl(ca_cert_pem, ca_key_pem)
    ca_cert = x509.load_pem_x509_certificate(ca_cert_pem)
    ca_key = serialization.load_pem_private_key(ca_key_pem, password=None)
    key = ec.generate_private_key(ec.SECP256R1())
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, LOCAL_SAN)]))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(days=1))
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(
            x509.SubjectAlternativeName([
                x509.DNSName(LOCAL_SAN),
                x509.DNSName("localhost"),
                x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
            ]),
            critical=False,
        )
        .sign(ca_key, hashes.SHA256())
    )
    return Certificate(
        cert_pem=cert.public_bytes(serialization.Encoding.PEM),
        key_pem=key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        ),
        ca_cert_pem=ca_cert_pem,
    )


def local_certificate() -> Certificate:
    """One-call helper: local CA → leaf cert (what binaries use by default)."""
    ca_cert, ca_key = load_ca()
    return generate_cert_from_ca(ca_cert, ca_key)


def client_context_for(use_local_authority: bool,
                       host: str) -> Tuple[ssl.SSLContext, str]:
    """The dial-side (context, server_hostname) pair shared by every
    TLS-bearing transport (TcpTls, Quic): local authority → trust the
    load_ca() root (baked-in or operator-supplied via env) and expect SAN
    ``pushcdn``; otherwise the system trust store and the real hostname
    (parity generate_root_certificate_store, tls.rs:98-155). Client side
    loads only the CA certificate — no leaf keygen. Configuration
    failures (unreadable CA file, malformed PEM) bail as typed Errors so
    transports surface them without wrapping."""
    try:
        if use_local_authority:
            if _DIAL_CA_OVERRIDE is not None:
                return _pinned_client_context(_DIAL_CA_OVERRIDE), LOCAL_SAN
            ca_cert_pem, _ = load_ca()
            return _pinned_client_context(ca_cert_pem), LOCAL_SAN
        # system trust store: keep the platform's default version floor —
        # external endpoints (older LBs/terminators) may still be TLS 1.2;
        # the 1.3 pin applies to OUR pinned-CA paths, where both ends are
        # this stack (parity: rustls also serves 1.2 for non-QUIC TLS)
        return ssl.create_default_context(), host
    except Exception as exc:
        from pushcdn_tpu_torch.proto.error import Error, ErrorKind, bail
        if isinstance(exc, Error):
            raise  # e.g. the PARSE bail for a half-configured env pair
        bail(ErrorKind.FILE, "loading TLS trust root failed", exc)
