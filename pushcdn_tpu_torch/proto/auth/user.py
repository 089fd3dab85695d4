"""User-side authentication.

Capability parity with cdn-proto/src/connection/auth/user.rs:28-162:

1. ``authenticate_with_marshal`` — sign the current unix timestamp under the
   ``USER_MARSHAL_AUTH`` namespace, send ``AuthenticateWithKey``, receive
   ``AuthenticateResponse`` carrying ``(permit, broker_endpoint)``
   (user.rs:50-86).
2. ``authenticate_with_broker`` — redeem the permit at that broker, await
   the ack, then send the ``Subscribe`` topic list so subscriptions survive
   reconnects (user.rs:108-161).
"""

from __future__ import annotations

import asyncio
import struct
import time
from typing import List, Tuple, Type

from pushcdn_tpu_torch.proto.crypto.signature import KeyPair, Namespace, SignatureScheme
from pushcdn_tpu_torch.proto.error import Error, ErrorKind, bail
from pushcdn_tpu_torch.proto.message import (
    AuthenticateResponse,
    AuthenticateWithKey,
    AuthenticateWithPermit,
    Subscribe,
)
from pushcdn_tpu_torch.proto.transport.base import Connection

_TS = struct.Struct("<Q")


def signable_timestamp(timestamp: int) -> bytes:
    return _TS.pack(timestamp)


def presign_timestamp(scheme: Type[SignatureScheme],
                      keypair: KeyPair) -> Tuple[int, bytes]:
    """Sign the current timestamp for marshal auth ahead of time — the
    caller can run this CPU work while the TCP dial is in flight and pass
    the result to :func:`authenticate_with_marshal`. The ±5 s replay
    window dwarfs any sane connect time, so signing before the socket
    exists is safe."""
    timestamp = int(time.time())
    return timestamp, scheme.sign(keypair.private_key,
                                  Namespace.USER_MARSHAL_AUTH,
                                  signable_timestamp(timestamp))


async def authenticate_with_marshal(
        connection: Connection, scheme: Type[SignatureScheme],
        keypair: KeyPair,
        presigned: Tuple[int, bytes] | None = None,
        trace=None) -> Tuple[int, str]:
    """Returns ``(permit, broker_public_endpoint)`` or raises
    ``Error(AUTHENTICATION)``. ``presigned`` is an optional
    :func:`presign_timestamp` result computed while the dial was in
    flight (the connect-latency overlap). ``trace`` is an optional
    lifecycle-trace context ``(trace_id, origin_ns)``: the auth frame is
    stamped with it (kind-tag flag bit + 16-byte block) so the marshal
    emits the ``auth`` span on the same trace id the client's first
    published message will carry."""
    from pushcdn_tpu_torch.proto import trace as trace_mod
    from pushcdn_tpu_torch.proto.message import serialize
    timestamp, signature = (presigned if presigned is not None
                            else presign_timestamp(scheme, keypair))
    frame = serialize(AuthenticateWithKey(
        public_key=keypair.public_key, timestamp=timestamp,
        signature=signature))
    if trace is not None:
        frame = trace_mod.stamp_frame(frame, trace)
    await connection.send_raw(frame, flush=True)

    response = await connection.recv_message()
    if not isinstance(response, AuthenticateResponse):
        bail(ErrorKind.AUTHENTICATION,
             f"marshal sent unexpected {type(response).__name__}")
    if response.permit <= 1:
        # permit 0 = failure with reason; 1 would be a bare ack which the
        # marshal never sends (message.rs:338-341 semantics)
        _bail_rejection("marshal", response.context)
    return response.permit, response.context


def _bail_rejection(who: str, context: str):
    """A ``permit=0`` rejection at connect time: load sheds surface as the
    TYPED ``Error(SHED)`` (carrying any ``retry-after=`` hint for the
    client's backoff loop) so they're distinguishable from a
    real auth failure — today both looked identical to the retry logic."""
    if context.startswith("shed"):
        bail(ErrorKind.SHED, f"{who} shed the connection: {context}")
    bail(ErrorKind.AUTHENTICATION,
         f"{who} rejected authentication: {context!r}")


async def authenticate_with_broker(
        connection: Connection, permit: int, topics: List[int]) -> None:
    """Redeem ``permit`` and replay our subscription set (user.rs:108-161).

    The wire sequence is the reference's (permit, ack, Subscribe) but the
    client PIPELINES: permit and Subscribe go out in one flush, then the
    ack is awaited. The broker reads them in order either way (it
    validates the permit before touching the Subscribe), an invalid
    permit still tears the connection down before the Subscribe is acted
    on, and the handshake drops one full round trip."""
    # both flushed: back-to-back flushed sends on an idle link take the
    # transport's inline fast path (no writer-task spawn for the whole
    # handshake), and the broker still reads them in order
    await connection.send_message(AuthenticateWithPermit(permit=permit),
                                  flush=True)
    try:
        await connection.send_message(Subscribe(topics), flush=True)
    except Error as send_err:
        # A rejected permit tears the connection down broker-side, so the
        # pipelined Subscribe's flush can fail before we ever read the
        # response — but the rejection (permit 0 + reason) is usually
        # already buffered ahead of the FIN. Surface THAT instead of a
        # generic write error; fall back to the send error when no
        # response is readable.
        try:
            async with asyncio.timeout(5.0):
                response = await connection.recv_message()
        except Exception:
            raise send_err
        if isinstance(response, AuthenticateResponse) and response.permit != 1:
            _bail_rejection("broker", response.context)
        raise send_err
    response = await connection.recv_message()
    if not isinstance(response, AuthenticateResponse):
        bail(ErrorKind.AUTHENTICATION,
             f"broker sent unexpected {type(response).__name__}")
    if response.permit != 1:
        _bail_rejection("broker", response.context)
