"""Wire format: the ``Message`` model (9 reference variants + ``Migrate``)
and its canonical binary codec.

Capability parity with the reference's Cap'n Proto envelope + hand-written
enum (cdn-proto/src/message.rs:83-105 for the variants, :107-457 for
serialize/deserialize; schema in cdn-proto/schema/messages.capnp). Redesigned
TPU-first instead of using capnp:

- **Flat little-endian layout with the payload last.** The payload of the two
  hot variants (``Direct``, ``Broadcast``) is the *unprefixed tail* of the
  frame, so (a) decoding is zero-copy (a ``memoryview`` into the recv
  buffer), and (b) a frame can be dropped into a fixed-width HBM byte-tensor
  slot where ``payload_offset``/``length`` are plain int32 columns — see
  ``pushcdn_tpu_torch.parallel.frames`` for the tensor packing.
- **One-byte kind tag** doubles as the on-device ``kind`` column.
- Sync payloads (``UserSync``/``TopicSync``) are opaque bytes whose interior
  is produced by the CRDT codec (parity with the reference nesting rkyv
  archives inside the capnp envelope, cdn-broker/src/tasks/broker/sync.rs:24-40).

Permit semantics (parity message.rs:338-341): in ``AuthenticateResponse``,
``permit == 0`` means failure (see ``context``), ``1`` means success/ack, and
``> 1`` is an actual redeemable permit.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple, Union

from pushcdn_tpu_torch.proto import MAX_MESSAGE_SIZE
from pushcdn_tpu_torch.proto.error import ErrorKind, bail

BytesLike = Union[bytes, bytearray, memoryview]

# Topic is a plain small int on the wire (parity: `type Topic = u8`,
# message.rs:26). Validation/pruning lives in pushcdn_tpu_torch.proto.topic.
Topic = int

# --- kind tags (the u8 discriminant; stable — also used on-device) ---------
KIND_AUTHENTICATE_WITH_KEY = 1
KIND_AUTHENTICATE_WITH_PERMIT = 2
KIND_AUTHENTICATE_RESPONSE = 3
KIND_DIRECT = 4
KIND_BROADCAST = 5
KIND_SUBSCRIBE = 6
KIND_UNSUBSCRIBE = 7
KIND_USER_SYNC = 8
KIND_TOPIC_SYNC = 9
KIND_MIGRATE = 10
KIND_SUBSCRIBE_FROM = 11
KIND_RETAINED = 12
KIND_LEDGER_SYNC = 13

# sequence sentinels for SubscribeFrom (durable topics, ISSUE 14): the
# top of the u64 range can never be a real retention sequence (rings
# count up from 1), so the last two values select replay modes instead
SEQ_LAST = 2**64 - 1     # replay only the last-value-cache entry
SEQ_LIVE = 2**64 - 2     # no replay: subscribe-only (wildcard patterns)

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_U16 = struct.Struct("<H")

# --- trace carrier (ISSUE 4) ----------------------------------------------
# The kind tag's high bit was reserved (kinds are 1-9): setting it means a
# fixed <u64 trace_id, u64 origin_ns> block follows the kind byte, then the
# frame continues exactly as before. Untraced frames are byte-identical to
# the pre-trace wire and pay zero decode work (hot dispatch tests exact
# kind values). Only Direct/Broadcast decode the flag here; the marshal
# auth frame carries it at the frame level (proto.trace.stamp/strip_frame).
TRACE_FLAG = 0x80
# the single source of truth for the block layout — proto.trace imports it
TRACE_BLOCK = struct.Struct("<QQ")
_TRACE_BLOCK = TRACE_BLOCK
_TRACED_HOT = frozenset((KIND_DIRECT | TRACE_FLAG, KIND_BROADCAST | TRACE_FLAG))

# --- view tag (ISSUE 11) ---------------------------------------------------
# Consensus-shaped workloads tag traced frames with the u32 view number so
# trace_report can aggregate per view. Same reserved-bit scheme as the
# trace flag itself: origin_ns is wall-clock nanoseconds, which stays below
# 2**63 until the year 2262, so its high bit was always zero on the wire.
# Setting it means a u32 view tag follows the 16-byte trace block. Frames
# without a view (and all untraced frames) are byte-identical to the PR 4
# wire — zero cost unless a view is actually carried.
TRACE_VIEW_FLAG = 1 << 63
TRACE_BLOCK_VIEW = struct.Struct("<QQI")


def pack_trace(trace) -> bytes:
    """Encode a trace context — ``(trace_id, origin_ns)`` or
    ``(trace_id, origin_ns, view)`` — into its wire block (16 or 20 B)."""
    if len(trace) > 2 and trace[2] is not None:
        return TRACE_BLOCK_VIEW.pack(trace[0], trace[1] | TRACE_VIEW_FLAG,
                                     trace[2] & 0xFFFFFFFF)
    return TRACE_BLOCK.pack(trace[0], trace[1])


def unpack_trace(view: BytesLike, off: int) -> Tuple[tuple, int]:
    """Decode the trace block at ``off``; returns ``(trace, end_offset)``
    where ``trace`` is a 2- or 3-tuple mirroring :func:`pack_trace`.
    Raises ``struct.error`` on truncation (callers wrap it in the usual
    ``Error(DESERIALIZE)``)."""
    tid, origin = TRACE_BLOCK.unpack_from(view, off)
    if origin & TRACE_VIEW_FLAG:
        (v,) = _U32.unpack_from(view, off + TRACE_BLOCK.size)
        return (tid, origin & ~TRACE_VIEW_FLAG, v), off + TRACE_BLOCK_VIEW.size
    return (tid, origin), off + TRACE_BLOCK.size


@dataclass(frozen=True, slots=True)
class AuthenticateWithKey:
    """User → marshal: prove key ownership by signing a unix timestamp.

    Parity: message.rs AuthenticateWithKey {public_key, timestamp, signature};
    flow in cdn-proto/src/connection/auth/user.rs:50-86.
    """

    public_key: bytes
    timestamp: int  # unix seconds, checked ±5 s by the marshal
    signature: bytes

    kind = KIND_AUTHENTICATE_WITH_KEY


@dataclass(frozen=True, slots=True)
class AuthenticateWithPermit:
    """User → broker: redeem the marshal-issued permit (message.rs)."""

    permit: int

    kind = KIND_AUTHENTICATE_WITH_PERMIT


@dataclass(frozen=True, slots=True)
class AuthenticateResponse:
    """Marshal/broker → user: permit semantics 0=fail, 1=ack, >1=permit.

    ``context`` is the broker endpoint on marshal success, or the failure
    reason (parity message.rs:338-341 and auth/marshal.rs:138-144).
    """

    permit: int
    context: str = ""

    kind = KIND_AUTHENTICATE_RESPONSE


class Direct:
    """Point-to-point message to ``recipient`` (a serialized public key).

    Hot-path variant: ``message`` is the unprefixed frame tail (zero-copy).
    Treat as immutable. Plain ``__slots__`` class, not a frozen dataclass:
    these two are constructed once per received message, and the frozen
    ``object.__setattr__`` ceremony was a top-3 line in the fan-out drain
    profile. Parity: message.rs Direct {recipient, message}.
    """

    __slots__ = ("recipient", "message")

    kind = KIND_DIRECT
    # lifecycle-trace context; None on the untraced hot path (class
    # attribute, so plain Directs pay nothing — see TracedDirect)
    trace = None

    def __init__(self, recipient: bytes, message: BytesLike):
        self.recipient = recipient
        self.message = message

    def __eq__(self, other):
        return (type(other) is Direct and self.recipient == other.recipient
                and self.message == other.message)

    def __hash__(self):
        return hash((KIND_DIRECT, self.recipient, self.message))

    def __repr__(self):
        return f"Direct(recipient={self.recipient!r}, <{len(self.message)} B>)"


class Broadcast:
    """Publish to every subscriber of ``topics``.

    Hot-path variant: ``message`` is the unprefixed frame tail (zero-copy).
    Treat as immutable (see :class:`Direct` on why not a dataclass).
    Parity: message.rs Broadcast {topics, message}.
    """

    __slots__ = ("topics", "message")

    kind = KIND_BROADCAST
    trace = None  # see Direct.trace

    def __init__(self, topics: Sequence[Topic], message: BytesLike):
        self.topics = topics if type(topics) is tuple else tuple(topics)
        self.message = message

    def __eq__(self, other):
        return (type(other) is Broadcast and self.topics == other.topics
                and self.message == other.message)

    def __hash__(self):
        return hash((KIND_BROADCAST, self.topics, self.message))

    def __repr__(self):
        return f"Broadcast(topics={self.topics!r}, <{len(self.message)} B>)"


class TracedDirect(Direct):
    """A :class:`Direct` carrying a lifecycle-trace context
    ``(trace_id, origin_ns)``. Same ``kind``; ``isinstance(m, Direct)``
    still matches, so routing treats it as a plain Direct — span-emission
    sites branch on ``m.trace is not None``."""

    __slots__ = ("trace",)

    def __init__(self, recipient: bytes, message: BytesLike, trace):
        self.recipient = recipient
        self.message = message
        self.trace = trace

    def __eq__(self, other):
        return (isinstance(other, Direct)
                and self.recipient == other.recipient
                and self.message == other.message)

    __hash__ = Direct.__hash__

    def __repr__(self):
        return (f"TracedDirect(recipient={self.recipient!r}, "
                f"<{len(self.message)} B>, trace={self.trace!r})")


class TracedBroadcast(Broadcast):
    """A :class:`Broadcast` carrying a lifecycle-trace context (see
    :class:`TracedDirect`)."""

    __slots__ = ("trace",)

    def __init__(self, topics: Sequence[Topic], message: BytesLike, trace):
        self.topics = topics if type(topics) is tuple else tuple(topics)
        self.message = message
        self.trace = trace

    def __eq__(self, other):
        return (isinstance(other, Broadcast) and self.topics == other.topics
                and self.message == other.message)

    __hash__ = Broadcast.__hash__

    def __repr__(self):
        return (f"TracedBroadcast(topics={self.topics!r}, "
                f"<{len(self.message)} B>, trace={self.trace!r})")


@dataclass(frozen=True, slots=True)
class Subscribe:
    """User → broker: add topic subscriptions (message.rs Subscribe)."""

    topics: Tuple[Topic, ...]

    kind = KIND_SUBSCRIBE

    def __init__(self, topics: Sequence[Topic]):
        object.__setattr__(self, "topics", tuple(topics))


@dataclass(frozen=True, slots=True)
class Unsubscribe:
    """User → broker: drop topic subscriptions (message.rs Unsubscribe)."""

    topics: Tuple[Topic, ...]

    kind = KIND_UNSUBSCRIBE

    def __init__(self, topics: Sequence[Topic]):
        object.__setattr__(self, "topics", tuple(topics))


@dataclass(frozen=True, slots=True)
class UserSync:
    """Broker ↔ broker: opaque CRDT delta of the user→broker DirectMap.

    Parity: message.rs UserSync(Vec<u8>); interior produced by
    pushcdn_tpu_torch.broker.versioned_map serialization.
    """

    payload: BytesLike

    kind = KIND_USER_SYNC


@dataclass(frozen=True, slots=True)
class TopicSync:
    """Broker ↔ broker: opaque CRDT delta of topic subscriptions."""

    payload: BytesLike

    kind = KIND_TOPIC_SYNC


@dataclass(frozen=True, slots=True)
class LedgerSync:
    """Broker ↔ broker: opaque JSON balance sheet of the sender's
    frame-fate conservation ledger (ISSUE 20) — monotone per-link
    sent/received counters exchanged over the existing sync task so
    each hop can compute its deficit against its upstream with no
    per-frame wire overhead. Interior produced by
    ``proto.ledger.Ledger.sheet``; a receiver that cannot parse it
    ignores it (last-writer-wins per peer, no CRDT merge needed —
    counters are monotone snapshots)."""

    payload: BytesLike

    kind = KIND_LEDGER_SYNC


@dataclass(frozen=True, slots=True)
class Migrate:
    """Broker → user: re-home to ``target`` (ISSUE 12 elastic membership).

    A draining broker sends this on the ordered egress path — after every
    message already queued for the user — with a permit it pre-issued for
    the target broker, so the client dials the new home directly without a
    per-connection marshal round-trip (the batched-handoff lesson from the
    DMA streaming / "RPC Considered Harmful" lineage). ``permit == 0``
    means no pre-issued permit: the client falls back to the marshal
    re-dance. Backward compatible: kind 10 was unused, and peers that
    don't know it reject it through the existing unexpected-kind policy.
    """

    target: str  # the new home's public advertise endpoint
    permit: int = 0

    kind = KIND_MIGRATE


@dataclass(frozen=True, slots=True)
class SubscribeFrom:
    """User → broker: subscribe to a durable ``topic`` AND replay its
    retention ring from sequence ``seq`` (ISSUE 14 durable topics).

    ``seq`` addresses the broker-local per-topic sequence stream stamped
    at ingress: entries with ``entry.seq >= seq`` are replayed as
    :class:`Retained` frames on the ordered egress path, then live
    delivery splices in with no gap and no duplicate (the broker
    registers the subscription and snapshots the ring in one synchronous
    step). Sentinels: :data:`SEQ_LAST` replays only the last-value-cache
    entry; :data:`SEQ_LIVE` skips replay entirely (used with
    ``pattern``). A non-empty ``pattern`` is a hierarchical wildcard
    (``consensus.view.*``) compiled broker-side onto the interest mask;
    ``topic`` is ignored then. Backward compatible: kind 11 was unused —
    old peers fall through cold-kind decode to the documented
    unexpected-kind disconnect, exactly like PR 12's ``Migrate``.
    """

    topic: int
    seq: int = 0
    pattern: str = ""

    kind = KIND_SUBSCRIBE_FROM


@dataclass(frozen=True, slots=True)
class Retained:
    """Broker → user: one replayed retention entry — ``payload`` is the
    original broadcast body, ``seq`` its broker-local position in
    ``topic``'s sequence stream. Payload-last layout, so decode is
    zero-copy like Direct/Broadcast."""

    topic: int
    seq: int
    payload: BytesLike

    kind = KIND_RETAINED


Message = Union[
    AuthenticateWithKey,
    AuthenticateWithPermit,
    AuthenticateResponse,
    Direct,
    Broadcast,
    Subscribe,
    Unsubscribe,
    UserSync,
    TopicSync,
    LedgerSync,
    Migrate,
    SubscribeFrom,
    Retained,
]

_ALL_KINDS = {
    KIND_AUTHENTICATE_WITH_KEY,
    KIND_AUTHENTICATE_WITH_PERMIT,
    KIND_AUTHENTICATE_RESPONSE,
    KIND_DIRECT,
    KIND_BROADCAST,
    KIND_SUBSCRIBE,
    KIND_UNSUBSCRIBE,
    KIND_USER_SYNC,
    KIND_TOPIC_SYNC,
    KIND_MIGRATE,
    KIND_SUBSCRIBE_FROM,
    KIND_RETAINED,
    KIND_LEDGER_SYNC,
}


def serialize(msg: Message) -> bytes:
    """Encode ``msg`` into one frame (without the outer u32 length prefix —
    that belongs to the transport's length-delimited framing, parity
    protocols/mod.rs:353-394).

    Raises ``Error(SERIALIZE)`` on out-of-range fields and
    ``Error(EXCEEDED_SIZE)`` if the frame would exceed ``MAX_MESSAGE_SIZE``.
    """
    kind = msg.kind
    try:
        if kind == KIND_DIRECT:
            recipient = msg.recipient
            trace = msg.trace
            if trace is None:
                frame = b"".join((b"\x04", _U32.pack(len(recipient)),
                                  recipient, msg.message))
            else:
                frame = b"".join((b"\x84", pack_trace(trace),
                                  _U32.pack(len(recipient)), recipient,
                                  msg.message))
        elif kind == KIND_BROADCAST:
            topics = msg.topics
            trace = msg.trace
            if trace is None:
                frame = b"".join((b"\x05", _U16.pack(len(topics)),
                                  bytes(topics), msg.message))
            else:
                frame = b"".join((b"\x85", pack_trace(trace),
                                  _U16.pack(len(topics)), bytes(topics),
                                  msg.message))
        elif kind in (KIND_SUBSCRIBE, KIND_UNSUBSCRIBE):
            topics = msg.topics
            out = bytearray(1 + 2 + len(topics))
            out[0] = kind
            _U16.pack_into(out, 1, len(topics))
            out[3:] = bytes(topics)
            frame = bytes(out)
        elif kind in (KIND_USER_SYNC, KIND_TOPIC_SYNC, KIND_LEDGER_SYNC):
            frame = bytes([kind]) + bytes(msg.payload)
        elif kind == KIND_AUTHENTICATE_WITH_KEY:
            pk, sig = msg.public_key, msg.signature
            frame = (
                bytes([kind])
                + _U32.pack(len(pk)) + pk
                + _U64.pack(msg.timestamp)
                + _U32.pack(len(sig)) + sig
            )
        elif kind == KIND_AUTHENTICATE_WITH_PERMIT:
            frame = bytes([kind]) + _U64.pack(msg.permit)
        elif kind == KIND_AUTHENTICATE_RESPONSE:
            ctx = msg.context.encode("utf-8")
            frame = bytes([kind]) + _U64.pack(msg.permit) + _U32.pack(len(ctx)) + ctx
        elif kind == KIND_MIGRATE:
            tgt = msg.target.encode("utf-8")
            frame = bytes([kind]) + _U64.pack(msg.permit) + _U32.pack(len(tgt)) + tgt
        elif kind == KIND_SUBSCRIBE_FROM:
            pat = msg.pattern.encode("utf-8")
            frame = (bytes([kind, msg.topic]) + _U64.pack(msg.seq) + pat)
        elif kind == KIND_RETAINED:
            frame = b"".join((bytes([kind, msg.topic]),
                              _U64.pack(msg.seq), msg.payload))
        else:  # pragma: no cover - unreachable with the Message union
            bail(ErrorKind.SERIALIZE, f"unknown message kind {kind}")
    except (struct.error, ValueError) as exc:
        # ValueError covers topic values outside u8 range (bytes(topics)).
        bail(ErrorKind.SERIALIZE, f"field out of range serializing kind {kind}", exc)
    if len(frame) > MAX_MESSAGE_SIZE:
        bail(ErrorKind.EXCEEDED_SIZE,
             f"serialized frame {len(frame)} B exceeds max {MAX_MESSAGE_SIZE} B")
    return frame


def deserialize(frame: BytesLike) -> Message:
    """Decode one frame. ``Direct``/``Broadcast``/sync payloads are returned
    as zero-copy ``memoryview``s into ``frame``.

    Raises ``Error(DESERIALIZE)`` on malformed input — the broker policy for
    that is to disconnect the peer (parity tasks/user/handler.rs:106-118).
    """
    view = memoryview(frame)
    n = len(view)
    if n < 1:
        bail(ErrorKind.DESERIALIZE, "empty frame")
    if n > MAX_MESSAGE_SIZE:
        bail(ErrorKind.EXCEEDED_SIZE, f"frame {n} B exceeds max {MAX_MESSAGE_SIZE} B")
    kind = view[0]
    try:
        if kind == KIND_DIRECT:
            (rlen,) = _U32.unpack_from(view, 1)
            if 5 + rlen > n:
                bail(ErrorKind.DESERIALIZE, "Direct recipient overruns frame")
            return Direct(recipient=bytes(view[5:5 + rlen]), message=view[5 + rlen:])
        if kind == KIND_BROADCAST:
            (ntopics,) = _U16.unpack_from(view, 1)
            if 3 + ntopics > n:
                bail(ErrorKind.DESERIALIZE, "Broadcast topics overrun frame")
            topics = tuple(view[3:3 + ntopics])
            return Broadcast(topics=topics, message=view[3 + ntopics:])
        if kind in (KIND_SUBSCRIBE, KIND_UNSUBSCRIBE):
            (ntopics,) = _U16.unpack_from(view, 1)
            if 3 + ntopics != n:
                bail(ErrorKind.DESERIALIZE, "Subscribe/Unsubscribe length mismatch")
            topics = tuple(view[3:3 + ntopics])
            return Subscribe(topics) if kind == KIND_SUBSCRIBE else Unsubscribe(topics)
        if kind == KIND_USER_SYNC:
            return UserSync(payload=view[1:])
        if kind == KIND_TOPIC_SYNC:
            return TopicSync(payload=view[1:])
        if kind == KIND_LEDGER_SYNC:
            return LedgerSync(payload=view[1:])
        if kind == KIND_AUTHENTICATE_WITH_KEY:
            off = 1
            (pklen,) = _U32.unpack_from(view, off)
            off += 4
            pk = bytes(view[off:off + pklen])
            if len(pk) != pklen:
                bail(ErrorKind.DESERIALIZE, "AuthenticateWithKey pubkey overruns frame")
            off += pklen
            (ts,) = _U64.unpack_from(view, off)
            off += 8
            (siglen,) = _U32.unpack_from(view, off)
            off += 4
            sig = bytes(view[off:off + siglen])
            if len(sig) != siglen or off + siglen != n:
                bail(ErrorKind.DESERIALIZE, "AuthenticateWithKey signature length mismatch")
            return AuthenticateWithKey(public_key=pk, timestamp=ts, signature=sig)
        if kind == KIND_AUTHENTICATE_WITH_PERMIT:
            if n != 9:
                bail(ErrorKind.DESERIALIZE, "AuthenticateWithPermit length mismatch")
            (permit,) = _U64.unpack_from(view, 1)
            return AuthenticateWithPermit(permit=permit)
        if kind == KIND_AUTHENTICATE_RESPONSE:
            (permit,) = _U64.unpack_from(view, 1)
            (ctxlen,) = _U32.unpack_from(view, 9)
            ctx = bytes(view[13:13 + ctxlen])
            if len(ctx) != ctxlen or 13 + ctxlen != n:
                bail(ErrorKind.DESERIALIZE, "AuthenticateResponse context length mismatch")
            try:
                context = ctx.decode("utf-8")
            except UnicodeDecodeError as exc:
                # a hostile peer's bytes must surface as the documented
                # Error(DESERIALIZE), never a loose UnicodeDecodeError
                bail(ErrorKind.DESERIALIZE,
                     "AuthenticateResponse context is not UTF-8", exc)
            return AuthenticateResponse(permit=permit, context=context)
        if kind == KIND_MIGRATE:
            (permit,) = _U64.unpack_from(view, 1)
            (tlen,) = _U32.unpack_from(view, 9)
            tgt = bytes(view[13:13 + tlen])
            if len(tgt) != tlen or 13 + tlen != n:
                bail(ErrorKind.DESERIALIZE, "Migrate target length mismatch")
            try:
                target = tgt.decode("utf-8")
            except UnicodeDecodeError as exc:
                bail(ErrorKind.DESERIALIZE, "Migrate target is not UTF-8", exc)
            return Migrate(target=target, permit=permit)
        if kind == KIND_SUBSCRIBE_FROM:
            if n < 10:
                bail(ErrorKind.DESERIALIZE, "SubscribeFrom truncated")
            (seq,) = _U64.unpack_from(view, 2)
            try:
                pattern = bytes(view[10:]).decode("utf-8")
            except UnicodeDecodeError as exc:
                bail(ErrorKind.DESERIALIZE,
                     "SubscribeFrom pattern is not UTF-8", exc)
            return SubscribeFrom(topic=view[1], seq=seq, pattern=pattern)
        if kind == KIND_RETAINED:
            if n < 10:
                bail(ErrorKind.DESERIALIZE, "Retained truncated")
            (seq,) = _U64.unpack_from(view, 2)
            return Retained(topic=view[1], seq=seq, payload=view[10:])
        if kind in _TRACED_HOT:
            # traced hot frame: 16- or 20-byte trace block (view-tagged)
            # after the kind byte, then the ordinary layout (rare by
            # construction: 1/1024 default sampling)
            if n < 1 + _TRACE_BLOCK.size:
                bail(ErrorKind.DESERIALIZE, "truncated trace block")
            trace, off = unpack_trace(view, 1)
            if kind & ~TRACE_FLAG == KIND_DIRECT:
                (rlen,) = _U32.unpack_from(view, off)
                p = off + 4 + rlen
                if p > n:
                    bail(ErrorKind.DESERIALIZE,
                         "Direct recipient overruns frame")
                return TracedDirect(bytes(view[off + 4:p]), view[p:], trace)
            (ntopics,) = _U16.unpack_from(view, off)
            p = off + 2 + ntopics
            if p > n:
                bail(ErrorKind.DESERIALIZE, "Broadcast topics overrun frame")
            return TracedBroadcast(tuple(view[off + 2:p]), view[p:], trace)
    except struct.error as exc:
        bail(ErrorKind.DESERIALIZE, f"truncated frame for kind {kind}", exc)
    bail(ErrorKind.DESERIALIZE, f"unknown message kind {kind}")


def materialize(msg: Message) -> Message:
    """Copy any zero-copy ``memoryview`` fields into owned ``bytes``.

    ``deserialize`` returns views into the receive buffer; the buffer's pool
    permit cannot be released while views outlive it. Convenience APIs
    (``Connection.recv_message``) materialize so the permit accounting stays
    exact; the broker hot path uses ``recv_raw`` + ``deserialize`` and
    releases the permit after fan-out instead.
    """
    kind = msg.kind
    if kind == KIND_DIRECT and isinstance(msg.message, memoryview):
        if msg.trace is not None:
            return TracedDirect(msg.recipient, bytes(msg.message), msg.trace)
        return Direct(recipient=msg.recipient, message=bytes(msg.message))
    if kind == KIND_BROADCAST and isinstance(msg.message, memoryview):
        if msg.trace is not None:
            return TracedBroadcast(msg.topics, bytes(msg.message), msg.trace)
        return Broadcast(topics=msg.topics, message=bytes(msg.message))
    if kind in (KIND_USER_SYNC, KIND_TOPIC_SYNC, KIND_LEDGER_SYNC) \
            and isinstance(msg.payload, memoryview):
        cls = (UserSync if kind == KIND_USER_SYNC
               else TopicSync if kind == KIND_TOPIC_SYNC else LedgerSync)
        return cls(payload=bytes(msg.payload))
    if kind == KIND_RETAINED and isinstance(msg.payload, memoryview):
        return Retained(topic=msg.topic, seq=msg.seq, payload=bytes(msg.payload))
    return msg


def deserialize_owned(frame: BytesLike) -> Message:
    """``materialize(deserialize(frame))`` fused for the hot variants: when
    ``frame`` is immutable ``bytes`` (the reader's complete-frame payloads
    are), slicing it copies directly — one object construction and one copy
    instead of view + materialize + recopy. Convenience receive APIs use
    this; semantics are identical to the two-step path."""
    t = type(frame)
    if t is bytes or t is memoryview:
        n = len(frame)
        if 1 <= n <= MAX_MESSAGE_SIZE:
            kind = frame[0]
            try:
                if kind == KIND_DIRECT:
                    (rlen,) = _U32.unpack_from(frame, 1)
                    if 5 + rlen <= n:
                        if t is memoryview:  # chunk views: copy out here
                            return Direct(
                                recipient=bytes(frame[5:5 + rlen]),
                                message=bytes(frame[5 + rlen:]))
                        return Direct(recipient=frame[5:5 + rlen],
                                      message=frame[5 + rlen:])
                    bail(ErrorKind.DESERIALIZE,
                         "Direct recipient overruns frame")
                if kind == KIND_BROADCAST:
                    (ntopics,) = _U16.unpack_from(frame, 1)
                    if 3 + ntopics <= n:
                        if t is memoryview:
                            return Broadcast(
                                topics=tuple(frame[3:3 + ntopics]),
                                message=bytes(frame[3 + ntopics:]))
                        return Broadcast(topics=tuple(frame[3:3 + ntopics]),
                                         message=frame[3 + ntopics:])
                    bail(ErrorKind.DESERIALIZE,
                         "Broadcast topics overrun frame")
            except struct.error as exc:
                # a 1-4 byte truncated frame must surface the same
                # Error(DESERIALIZE) the two-step path raises — callers'
                # malformed-frame disconnect policy catches Error only
                bail(ErrorKind.DESERIALIZE,
                     f"truncated frame for kind {kind}", exc)
    return materialize(deserialize(bytes(frame) if t is memoryview
                                   else frame))


_native_decode = None
_native_decode_tried = False


# Zero-copy decode threshold: payloads at or above this come back as
# memoryviews over the chunk buffer; smaller ones are owned copies. Two
# reasons, both measured: (a) below a few hundred bytes the memcpy is
# cheaper than constructing the slice view, so tiny payloads gain nothing
# from views; (b) a retained view pins its WHOLE read chunk (up to
# Connection._READ_CHUNK) after the pool permit returns — copying small
# payloads caps that invisible amplification at chunk_size/threshold per
# retained message instead of chunk_size/payload (an app retaining 10K
# tiny messages would otherwise pin gigabytes the pool can't see).
ZERO_COPY_MIN = 256


def decode_frames(buf: bytes, offs, lens, start: int = 0,
                  zero_copy: bool = False) -> list:
    """Decode a parse batch's frames straight off the shared chunk buffer
    (transport ``FrameChunk``) — the fan-out drain's hot loop. Inline
    little-endian field reads replace per-frame memoryview + Struct calls;
    payload/recipient slices of the ``bytes`` buffer are the single owned
    copy. Cold kinds and malformed frames take the general path (which
    raises the usual ``Error(DESERIALIZE)``).

    ``zero_copy=True`` skips even that one payload copy for payloads of
    at least ``ZERO_COPY_MIN`` bytes: Broadcast/Direct ``message`` fields
    come back as memoryviews over ``buf`` (the views' reference chain
    keeps the buffer alive after the chunk's pool permit is released —
    one retained message can pin at most one read chunk, and the
    threshold caps the pin-per-retained-byte amplification; see
    ``ZERO_COPY_MIN``). Smaller payloads are owned copies either way
    (cheaper than the view object). Direct ``recipient`` stays an owned
    copy: it is small and consumed as a dict key.

    The loop itself runs in C when the native library is available
    (native/pydecode.cpp — same construction, same fallback semantics,
    ~5x less per-message cost); this Python body is the fallback and the
    executable specification."""
    global _native_decode, _native_decode_tried
    if not _native_decode_tried:
        from pushcdn_tpu_torch import native as _native_mod
        _native_decode = _native_mod.pydecode()
        _native_decode_tried = True
    zc_min = ZERO_COPY_MIN if zero_copy else 0
    if _native_decode is not None:
        res = _native_decode(buf, offs, lens, start,
                             Broadcast, Direct, deserialize_owned,
                             zc_min)
        if res is not None:
            return res
    out = []
    append = out.append
    mv = memoryview(buf) if zero_copy else None
    for i in range(start, len(offs)):
        o = offs[i]
        n = lens[i]
        if n >= 3:
            kind = buf[o]
            if kind == KIND_BROADCAST:
                nt = buf[o + 1] | (buf[o + 2] << 8)
                p = o + 3 + nt
                if p <= o + n:
                    body = mv[p:o + n] if zero_copy \
                        and o + n - p >= zc_min else buf[p:o + n]
                    append(Broadcast(tuple(buf[o + 3:p]), body))
                    continue
            elif kind == KIND_DIRECT and n >= 5:
                rlen = (buf[o + 1] | (buf[o + 2] << 8)
                        | (buf[o + 3] << 16) | (buf[o + 4] << 24))
                p = o + 5 + rlen
                if p <= o + n:
                    body = mv[p:o + n] if zero_copy \
                        and o + n - p >= zc_min else buf[p:o + n]
                    append(Direct(bytes(buf[o + 5:p]), body))
                    continue
        append(deserialize_owned(bytes(buf[o:o + n])))
    return out


def with_trace(msg: Message, trace) -> Message:
    """The traced twin of a hot message (Direct/Broadcast); other kinds
    are returned unchanged (their frames carry traces at the frame level
    only — see proto.trace.stamp_frame)."""
    kind = msg.kind
    if kind == KIND_DIRECT:
        return TracedDirect(msg.recipient, msg.message, trace)
    if kind == KIND_BROADCAST:
        return TracedBroadcast(msg.topics, msg.message, trace)
    return msg


def peek_kind(frame: BytesLike) -> int:
    """Read the kind tag without decoding — lets hot loops dispatch before
    (or instead of) a full deserialize."""
    if len(frame) < 1:
        bail(ErrorKind.DESERIALIZE, "empty frame")
    return memoryview(frame)[0]
