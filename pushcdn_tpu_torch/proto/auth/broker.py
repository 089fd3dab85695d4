"""Broker-side authentication: user permit redemption + mutual
broker↔broker verification.

Capability parity with cdn-proto/src/connection/auth/broker.rs:36-301:

- ``verify_user`` (broker.rs:77-151): receive ``AuthenticateWithPermit``,
  redeem it against discovery (GETDEL semantics), ack, then receive the
  user's ``Subscribe`` topics.
- Broker↔broker auth (broker.rs:160-300): a mutual signed-timestamp
  exchange where both sides must hold the **same** broker keypair (the
  same-key check at broker.rs:286-288 — one deployment, one broker key).
  Direction fixes the order (the reference's ``authenticate_with_broker!``
  / ``verify_broker!`` macros): the *dialing* side authenticates first,
  the *accepting* side verifies first, so the two halves interleave without
  deadlock.

Wire note: ``AuthenticateWithKey.public_key`` is an opaque byte field; for
broker↔broker auth it carries ``u16 key_len || raw_public_key || identity_utf8``
so the peer learns which broker connected (the length prefix keeps the
split scheme-agnostic: Ed25519 keys are 32 B, BLS-BN254 keys 128 B), and
the signature covers ``timestamp || identity`` to bind the claimed
identity.
"""

from __future__ import annotations

import struct
import time
from typing import List, Tuple, Type

from pushcdn_tpu_torch.proto.crypto.signature import KeyPair, Namespace, SignatureScheme
from pushcdn_tpu_torch.proto.discovery.base import BrokerIdentifier, DiscoveryClient
from pushcdn_tpu_torch.proto.error import ErrorKind, bail
from pushcdn_tpu_torch.proto.message import (
    AuthenticateResponse,
    AuthenticateWithKey,
    AuthenticateWithPermit,
    Subscribe,
)
from pushcdn_tpu_torch.proto.transport.base import Connection

_TS = struct.Struct("<Q")
_KEY_LEN = struct.Struct("<H")  # scheme-agnostic key-length prefix

TIMESTAMP_TOLERANCE_S = 5


# ---------------------------------------------------------------------------
# users
# ---------------------------------------------------------------------------

async def verify_user(connection: Connection, discovery: DiscoveryClient,
                      identity: BrokerIdentifier
                      ) -> Tuple[bytes, List[int]]:
    """Redeem a user's permit; returns ``(public_key, topics)``
    (broker.rs:77-151)."""
    message = await connection.recv_message()
    if not isinstance(message, AuthenticateWithPermit):
        bail(ErrorKind.AUTHENTICATION, "expected AuthenticateWithPermit")

    public_key = await discovery.validate_permit(identity, message.permit)
    if public_key is None:
        try:
            await connection.send_message(
                AuthenticateResponse(permit=0, context="invalid permit"),
                flush=True)
        except Exception:
            pass
        bail(ErrorKind.AUTHENTICATION, "invalid permit")

    await connection.send_message(AuthenticateResponse(permit=1, context=""),
                                  flush=True)

    # The user follows the ack with its Subscribe set (broker.rs:119-150).
    sub = await connection.recv_message()
    if not isinstance(sub, Subscribe):
        bail(ErrorKind.AUTHENTICATION, "expected Subscribe after permit ack")
    return public_key, list(sub.topics)


# ---------------------------------------------------------------------------
# brokers
# ---------------------------------------------------------------------------

def _broker_signable(timestamp: int, identity: str) -> bytes:
    return _TS.pack(timestamp) + identity.encode("utf-8")


async def _send_auth(connection: Connection, scheme: Type[SignatureScheme],
                     keypair: KeyPair, identity: BrokerIdentifier) -> None:
    timestamp = int(time.time())
    ident = str(identity)
    signature = scheme.sign(keypair.private_key, Namespace.BROKER_BROKER_AUTH,
                            _broker_signable(timestamp, ident))
    await connection.send_message(AuthenticateWithKey(
        public_key=_KEY_LEN.pack(len(keypair.public_key))
        + keypair.public_key + ident.encode("utf-8"),
        timestamp=timestamp, signature=signature), flush=True)
    response = await connection.recv_message()
    if not isinstance(response, AuthenticateResponse) or response.permit != 1:
        bail(ErrorKind.AUTHENTICATION, "peer broker rejected our auth")


async def _recv_auth(connection: Connection, scheme: Type[SignatureScheme],
                     keypair: KeyPair) -> BrokerIdentifier:
    message = await connection.recv_message()
    if not isinstance(message, AuthenticateWithKey):
        bail(ErrorKind.AUTHENTICATION, "expected broker AuthenticateWithKey")
    packed = bytes(message.public_key)
    if len(packed) < _KEY_LEN.size:
        await _reject(connection, "malformed broker key field")
    (key_len,) = _KEY_LEN.unpack_from(packed)
    if len(packed) < _KEY_LEN.size + key_len:
        await _reject(connection, "malformed broker key field")
    raw_key = packed[_KEY_LEN.size:_KEY_LEN.size + key_len]
    ident = packed[_KEY_LEN.size + key_len:].decode("utf-8", "replace")
    # Same-key check: peer must hold OUR broker keypair (broker.rs:286-288).
    if raw_key != keypair.public_key:
        await _reject(connection, "broker key mismatch")
    if not scheme.verify(raw_key, Namespace.BROKER_BROKER_AUTH,
                         _broker_signable(message.timestamp, ident),
                         message.signature):
        await _reject(connection, "invalid broker signature")
    if abs(int(time.time()) - message.timestamp) > TIMESTAMP_TOLERANCE_S:
        await _reject(connection, "broker timestamp too old")
    await connection.send_message(AuthenticateResponse(permit=1, context=""),
                                  flush=True)
    return BrokerIdentifier.from_string(ident)


async def _reject(connection: Connection, reason: str):
    try:
        await connection.send_message(
            AuthenticateResponse(permit=0, context=reason), flush=True)
    except Exception:
        pass
    bail(ErrorKind.AUTHENTICATION, reason)


async def authenticate_as_dialer(connection: Connection,
                                 scheme: Type[SignatureScheme],
                                 keypair: KeyPair,
                                 identity: BrokerIdentifier
                                 ) -> BrokerIdentifier:
    """Outbound side: authenticate first, then verify the peer
    (the direction ordering of broker.rs:160-236)."""
    await _send_auth(connection, scheme, keypair, identity)
    return await _recv_auth(connection, scheme, keypair)


async def authenticate_as_listener(connection: Connection,
                                   scheme: Type[SignatureScheme],
                                   keypair: KeyPair,
                                   identity: BrokerIdentifier
                                   ) -> BrokerIdentifier:
    """Inbound side: verify the dialer first, then authenticate ourselves."""
    peer = await _recv_auth(connection, scheme, keypair)
    await _send_auth(connection, scheme, keypair, identity)
    return peer
