"""Send helpers. **Failure ⇒ removal**: a failed send is the fault
detector — the peer is removed and its tasks aborted (parity
cdn-broker/src/tasks/broker/sender.rs:17-58, tasks/user/sender.rs:16-32;
SURVEY.md §5 "failure *is* an I/O error").

All senders take refcounted :class:`Bytes` frames and clone per recipient —
fan-out shares one payload buffer (Arc-clone parity, handler.rs hot path).

The port's copy of ``pushcdn_tpu.broker.tasks.senders``.
"""

from __future__ import annotations

import logging
import time
from typing import TYPE_CHECKING, Iterable, List, Optional

from pushcdn_tpu_torch import native as native_mod
from pushcdn_tpu_torch.proto import flowclass
from pushcdn_tpu_torch.proto import ledger as ledger_mod
from pushcdn_tpu_torch.proto import metrics as metrics_mod
from pushcdn_tpu_torch.proto.limiter import Bytes
from pushcdn_tpu_torch.proto.util import mnemonic

if TYPE_CHECKING:
    from pushcdn_tpu_torch.broker.broker import Broker

logger = logging.getLogger("pushcdn.broker")


def _pumped(connection) -> str:
    """Failure-log tag for peers the fused pump (transport/pump.py) had
    natively engaged: the removal an operator sees here is the Python
    rediscovery of an error the pump already counted
    (``cdn_pump_escalations{reason="peer_error"}``) — the tag makes the
    two log/metric trails correlate."""
    stream = getattr(connection, "_stream", None)
    if getattr(stream, "_pump_binding", None) is not None:
        return " [natively pumped peer]"
    return ""

# pre-encode shape bounds: the fast path covers fan-out batches of small
# frames (the hot regime); anything bigger rides the writer's own
# coalescer, which chunks large flushes per timeout window
_PRE_ENCODE_MAX_FRAME = 64 * 1024
_PRE_ENCODE_MAX_TOTAL = 1 << 20


# pre-encode shape bounds: the fast path covers fan-out batches of small
# frames (the hot regime); anything bigger rides the writer's own
# coalescer, which chunks large flushes per timeout window
_PRE_ENCODE_MAX_FRAME = 64 * 1024
_PRE_ENCODE_MAX_TOTAL = 1 << 20


def pre_encode_frames(raws) -> Optional[bytearray]:
    """Length-delimit a batch of small ``bytes`` frames into ONE owned
    buffer via the native batch encoder (one C call, one copy — the same
    copy count as the writer-side coalescer, moved off the writer task so
    the flush is verbatim and the frames' pool permits release at encode
    time). None when the native library is unavailable or the batch
    doesn't fit the fast-path shape (callers fall back to
    ``send_raw_many``)."""
    encoder = native_mod.shared_encoder()
    if encoder is None or len(raws) < 2:
        return None
    total = 0
    payloads = []
    for r in raws:
        data = r.data if isinstance(r, Bytes) else r
        if type(data) is not bytes or len(data) > _PRE_ENCODE_MAX_FRAME:
            return None
        total += len(data) + 4
        if total > _PRE_ENCODE_MAX_TOTAL:
            return None
        payloads.append(data)
    t0 = time.perf_counter()
    out = encoder.encode_detached(payloads)
    # batch-level native-seam accounting: one perf_counter pair per
    # fan-out batch (cdn_native_seconds{kernel="egress_encode"})
    metrics_mod.NATIVE_EGRESS_SECONDS.inc(time.perf_counter() - t0)
    return out


async def try_send_to_user(broker: "Broker", public_key: bytes,
                           raw: Bytes, cls: int = 2) -> bool:
    """Queue ``raw`` (one clone) to a local user; remove the user on
    failure. The clone is released by the writer task after the frame hits
    the stream, or by us on failure. ``cls`` is the flow class counted at
    the writer (default ``live`` — this is a data-frame path)."""
    connection = broker.connections.get_user_connection(public_key)
    if connection is None:
        return False
    clone = raw.clone()
    try:
        await connection.send_raw(clone, cls=cls)
        return True
    except Exception as exc:
        clone.release()
        logger.info("send to user %s failed (%r)%s; removing",
                    mnemonic(public_key), exc, _pumped(connection))
        broker.connections.remove_user(public_key, reason="send failed")
        broker.update_metrics()
        return False


def try_send_frames_to_user_nowait(broker: "Broker", public_key: bytes,
                                   raws: Iterable[Bytes]) -> int:
    """Queue a whole batch of frames to one user as ONE send queue entry
    (single connection lookup, single writer wakeup — the device-plane
    egress delivers per-user groups). Returns the number queued; a failure
    removes the user."""
    connection = broker.connections.get_user_connection(public_key)
    if connection is None:
        return 0
    raws = list(raws)
    if not raws:
        return 0
    # Pre-encoded fast path: the whole batch becomes one verbatim writer
    # flush, and the borrowed frames need no clones at all (the encode
    # copies; the caller keeps ownership of the originals).
    encoded = pre_encode_frames(raws)
    try:
        if encoded is not None:
            # nframes carries the batch's frame count into the writer's
            # class accounting (an encoded stream is otherwise opaque)
            connection.send_encoded_nowait(encoded, nframes=len(raws))
        else:
            # the connection owns the clones from here (released on
            # failure too)
            connection.send_raw_many_nowait([raw.clone() for raw in raws])
        return len(raws)
    except Exception as exc:
        logger.info("nowait send to user %s failed (%r)%s; removing",
                    mnemonic(public_key), exc, _pumped(connection))
        broker.connections.remove_user(public_key, reason="send failed")
        broker.update_metrics()
        return 0


def try_send_encoded_to_user_nowait(broker: "Broker", public_key: bytes,
                                    data, owner=None,
                                    nframes: int = 0) -> bool:
    """Queue a pre-framed egress stream (native.egress_encode output) to
    one user — zero per-frame work here or in the writer; a failure
    removes the user (failure-is-removal, as everywhere). ``owner`` keeps
    a pooled egress buffer alive until the flush completes. ``nframes``
    feeds the writer's class accounting (the stream itself is opaque)."""
    connection = broker.connections.get_user_connection(public_key)
    if connection is None:
        return False
    try:
        connection.send_encoded_nowait(data, owner, nframes=nframes)
        return True
    except Exception as exc:
        logger.info("encoded send to user %s failed (%r)%s; removing",
                    mnemonic(public_key), exc, _pumped(connection))
        broker.connections.remove_user(public_key, reason="send failed")
        broker.update_metrics()
        return False


def egress_streams(broker: "Broker", slots, streams) -> int:
    """Deliver one step's native egress (:class:`native.EgressStreams`):
    one pre-framed stream handoff per user with deliveries. Returns the
    number of messages queued."""
    routed = 0
    for slot in streams.users:
        key = slots.key_of(int(slot))
        if key is None:  # released mid-step: user is gone, drop
            continue
        if try_send_encoded_to_user_nowait(broker, key, streams.stream(slot),
                                           owner=streams,
                                           nframes=int(streams.msgs[slot])):
            routed += int(streams.msgs[slot])
    return routed


def egress_delivery_rows(broker: "Broker", slots, users, frame_idx,
                         frame_of) -> int:
    """Shared device-plane egress walk: deliver a (users, frame_idx)
    nonzero listing grouped per user (np.nonzero is row-major, so each
    user's frames are contiguous — one connection lookup per user).
    ``frame_of(f)`` materializes/caches the frame's Bytes; ``slots`` maps
    user slot → public key. Returns the number queued."""
    routed = 0
    start = 0
    n = len(users)
    while start < n:
        u = users[start]
        end = start
        while end < n and users[end] == u:
            end += 1
        key = slots.key_of(int(u))
        if key is not None:  # released mid-step: drop (user is gone)
            routed += try_send_frames_to_user_nowait(
                broker, key, [frame_of(int(f)) for f in frame_idx[start:end]])
        start = end
    return routed


async def try_send_to_broker(broker: "Broker", identifier: str,
                             raw: Bytes) -> bool:
    connection = broker.connections.get_broker_connection(identifier)
    if connection is None:
        return False
    clone = raw.clone()
    try:
        await connection.send_raw(clone)
        # control-plane mesh frames (topic/ledger sync) ride this path
        # rather than the routed egress batches — count them into the
        # per-link conservation table with the same wire-byte rule the
        # receiving end uses, or every mesh link reads recv > sent
        ledger_mod.note_link_sent(identifier, flowclass.frame_class(raw.data))
        return True
    except Exception as exc:
        clone.release()
        logger.info("send to broker %s failed (%r); removing", identifier, exc)
        broker.connections.remove_broker(identifier, reason="send failed")
        broker.update_metrics()
        return False


async def try_send_to_brokers(broker: "Broker", identifiers: Iterable[str],
                              raw: Bytes) -> int:
    """Fan a frame out to many peers (sender.rs try_send_to_brokers)."""
    sent = 0
    for ident in list(identifiers):
        if await try_send_to_broker(broker, ident, raw):
            sent += 1
    return sent
