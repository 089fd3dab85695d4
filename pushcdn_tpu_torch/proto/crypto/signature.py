"""Signature schemes: namespaced sign/verify behind a pluggable seam.

Capability parity with cdn-proto/src/crypto/signature.rs:19-175:

- ``Namespace`` domain separation (``UserMarshalAuth`` / ``BrokerBrokerAuth``,
  signature.rs:19-32) — a signature over a timestamp for the marshal must
  not be replayable to a broker;
- ``SignatureScheme`` trait (sign/verify over namespaced messages);
- ``KeyPair`` with seeded deterministic generation (parity
  ``DeterministicRng``, crypto/rng.rs:15-42 — reproducible keys for tests);
- ``Ed25519Scheme`` behind the seam — the default (native-speed via the
  ``cryptography`` package's OpenSSL backend, else the pure-Python
  RFC 8032 fallback); small keys, microsecond verify. The BLS-over-BN254
  scheme of ``pushcdn_tpu.proto.crypto.signature`` (a C++ library) is not
  copied yet.
"""

from __future__ import annotations

import abc
import enum
import hashlib
from dataclasses import dataclass

try:  # the OpenSSL backend; images without it use the pure-Python fallback
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
    _HAVE_CRYPTOGRAPHY = True
except ImportError:  # gated dependency: never installed at import time
    _HAVE_CRYPTOGRAPHY = False
    from pushcdn_tpu_torch.proto.crypto import _ed25519_fallback

from pushcdn_tpu_torch.proto.error import ErrorKind, bail


class Namespace(enum.Enum):
    """Signing domains (parity signature.rs:19-32)."""

    USER_MARSHAL_AUTH = b"user-marshal-auth"
    BROKER_BROKER_AUTH = b"broker-broker-auth"


def _namespaced(namespace: Namespace, message: bytes) -> bytes:
    # length-prefix the namespace so (ns, msg) pairs can't collide
    ns = namespace.value
    return len(ns).to_bytes(2, "little") + ns + bytes(message)


@dataclass(frozen=True)
class KeyPair:
    """A serialized (public, private) pair for one scheme."""

    public_key: bytes
    private_key: bytes


class SignatureScheme(abc.ABC):
    """The pluggable scheme seam (parity ``SignatureScheme`` trait,
    signature.rs:36-63). All keys/signatures are opaque bytes at this
    boundary (parity ``Serializable``, signature.rs:66-78)."""

    name: str = "?"

    @classmethod
    @abc.abstractmethod
    def generate_keypair(cls, seed: int | None = None) -> KeyPair:
        """Generate a keypair; a ``seed`` gives deterministic keys for
        reproducible tests (DeterministicRng parity)."""

    @classmethod
    @abc.abstractmethod
    def sign(cls, private_key: bytes, namespace: Namespace,
             message: bytes) -> bytes: ...

    @classmethod
    @abc.abstractmethod
    def verify(cls, public_key: bytes, namespace: Namespace,
               message: bytes, signature: bytes) -> bool: ...


class Ed25519Scheme(SignatureScheme):
    """Default scheme: Ed25519 (32-byte keys, 64-byte signatures)."""

    name = "ed25519"

    @classmethod
    def generate_keypair(cls, seed: int | None = None) -> KeyPair:
        if seed is None:
            import os as _os
            raw = _os.urandom(32)
        else:
            # 32 deterministic bytes from the seed (DeterministicRng parity)
            raw = hashlib.blake2b(seed.to_bytes(8, "little", signed=False),
                                  digest_size=32).digest()
        if not _HAVE_CRYPTOGRAPHY:
            return KeyPair(public_key=_ed25519_fallback.publickey(raw),
                           private_key=raw)
        priv = Ed25519PrivateKey.from_private_bytes(raw)
        from cryptography.hazmat.primitives import serialization
        return KeyPair(
            public_key=priv.public_key().public_bytes(
                serialization.Encoding.Raw, serialization.PublicFormat.Raw),
            private_key=priv.private_bytes(
                serialization.Encoding.Raw, serialization.PrivateFormat.Raw,
                serialization.NoEncryption()),
        )

    @classmethod
    def sign(cls, private_key: bytes, namespace: Namespace,
             message: bytes) -> bytes:
        try:
            if not _HAVE_CRYPTOGRAPHY:
                return _ed25519_fallback.sign(bytes(private_key),
                                              _namespaced(namespace, message))
            priv = Ed25519PrivateKey.from_private_bytes(private_key)
            return priv.sign(_namespaced(namespace, message))
        except Exception as exc:
            bail(ErrorKind.CRYPTO, "signing failed", exc)

    @classmethod
    def verify(cls, public_key: bytes, namespace: Namespace,
               message: bytes, signature: bytes) -> bool:
        if not _HAVE_CRYPTOGRAPHY:
            try:
                return _ed25519_fallback.verify(
                    bytes(public_key), _namespaced(namespace, message),
                    bytes(signature))
            except Exception:
                return False
        try:
            pub = Ed25519PublicKey.from_public_bytes(public_key)
            pub.verify(bytes(signature), _namespaced(namespace, message))
            return True
        except (InvalidSignature, ValueError, TypeError):
            return False


DEFAULT_SCHEME = Ed25519Scheme
