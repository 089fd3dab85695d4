"""Marshal-side user verification.

Capability parity with cdn-proto/src/connection/auth/marshal.rs:34-148:
verify the signed timestamp (±5 s replay window, marshal.rs:76-83), check
the whitelist, pick the least-loaded broker, issue a 30-second single-use
permit (marshal.rs:105-141), reply ``(permit, broker_public_endpoint)``.
Failures are reported to the user as ``AuthenticateResponse(permit=0,
context=reason)`` before bailing.
"""

from __future__ import annotations

import time
from typing import Tuple, Type

from pushcdn_tpu_torch.proto import trace as trace_mod
from pushcdn_tpu_torch.proto.auth.user import signable_timestamp
from pushcdn_tpu_torch.proto.crypto.signature import Namespace, SignatureScheme
from pushcdn_tpu_torch.proto.discovery.base import DiscoveryClient
from pushcdn_tpu_torch.proto.error import ErrorKind, bail
from pushcdn_tpu_torch.proto.message import (
    AuthenticateResponse,
    AuthenticateWithKey,
    deserialize_owned,
)
from pushcdn_tpu_torch.proto.transport.base import Connection

# parity constants (marshal.rs:76-83, :121-135)
TIMESTAMP_TOLERANCE_S = 5
PERMIT_EXPIRY_S = 30.0


async def _reject(connection: Connection, reason: str):
    try:
        await connection.send_message(
            AuthenticateResponse(permit=0, context=reason), flush=True)
    except Exception:
        pass
    bail(ErrorKind.AUTHENTICATION, reason)


async def verify_user(connection: Connection, discovery: DiscoveryClient,
                      scheme: Type[SignatureScheme],
                      verifier=None) -> Tuple[bytes, int]:
    """Run the marshal side of the handshake on one fresh connection.

    Returns ``(user_public_key, permit)`` after replying with the permit and
    the chosen broker's public endpoint. ``verifier`` (an optional
    crypto.batch.BatchVerifier) amortizes concurrent pairing checks under
    connection storms; semantics are identical to ``scheme.verify``.
    """
    # Frame-level trace strip: a client that sampled this connection set
    # the kind-tag trace flag on its auth frame (proto.trace); the span is
    # emitted after a SUCCESSFUL verification, so the auth hop measures
    # dial + handshake + verify from the client's dial-time origin.
    raw = await connection.recv_raw()
    try:
        frame, auth_trace = trace_mod.strip_frame(raw.data)
    finally:
        raw.release()
    message = deserialize_owned(frame)
    if not isinstance(message, AuthenticateWithKey):
        await _reject(connection, "expected AuthenticateWithKey")

    # signature over the timestamp, namespaced (marshal.rs:66-83)
    if verifier is not None:
        sig_ok = await verifier.verify(
            message.public_key, Namespace.USER_MARSHAL_AUTH,
            signable_timestamp(message.timestamp), message.signature)
    else:
        sig_ok = scheme.verify(message.public_key,
                               Namespace.USER_MARSHAL_AUTH,
                               signable_timestamp(message.timestamp),
                               message.signature)
    if not sig_ok:
        await _reject(connection, "invalid signature")
    if abs(int(time.time()) - message.timestamp) > TIMESTAMP_TOLERANCE_S:
        await _reject(connection, "timestamp too old")

    # whitelist (marshal.rs:91-105)
    if not await discovery.check_whitelist(message.public_key):
        await _reject(connection, "not in whitelist")

    # least-loaded broker (marshal.rs:109-118)
    try:
        broker = await discovery.get_with_least_connections()
    except Exception:
        await _reject(connection, "no brokers available")

    # 30 s single-use permit (marshal.rs:121-135)
    permit = await discovery.issue_permit(broker, PERMIT_EXPIRY_S,
                                          message.public_key)
    await connection.send_message(
        AuthenticateResponse(permit=permit,
                             context=broker.public_advertise_endpoint),
        flush=True)
    connection.flightrec.record("auth-ok")
    if auth_trace is not None:
        trace_mod.emit("auth", auth_trace, "marshal-verify")
    return message.public_key, permit
