"""Receive loops + the routing core (the #1 hot path).

Capability parity with cdn-broker/src/tasks/user/handler.rs:26-163 and
tasks/broker/handler.rs:31-272:

- ``user_receive_loop``: per-message recv-raw → deserialize (zero-copy) →
  hook → route ``Direct``/``Broadcast`` to users **and** brokers, or apply
  ``Subscribe``/``Unsubscribe`` locally; an invalid message disconnects the
  user (user/handler.rs:104-161).
- ``broker_receive_loop``: ``Direct`` → deliver to own user only
  (``to_user_only=True``); ``Broadcast`` → local users only (prevents
  re-forward loops); ``UserSync``/``TopicSync`` → CRDT merge
  (broker/handler.rs:121-193).
- ``handle_direct_message`` (broker/handler.rs:197-237): DirectMap lookup →
  self? send-to-user : send-to-broker (suppressed when ``to_user_only``).
- ``handle_broadcast_message`` (broker/handler.rs:240-272): interest query →
  fan-out. The serialized frame is forwarded **verbatim** (one deserialize
  per hop for dispatch; payload bytes shared via refcounted ``Bytes``).

Latency accounting: each frame's pool permit lives from socket-read to
last-fan-out-write; its lifetime feeds the LATENCY histogram
(limiter.AllocationPermit), mirroring the reference's latency proxy.

A copy of ``pushcdn_tpu.broker.tasks.handlers``. Each receive loop first
asks the cut-through plane (``cutthrough.acquire``: the native route plan,
no device plane, the default hook) and, when it is eligible, routes whole
``FrameChunk`` batches through it; otherwise, and for
``PUSHCDN_ROUTE_CUTTHROUGH=python``, it runs the scalar loop below, which
stays the correctness twin. On a broker of N worker shards
(``broker.sharding``) a peer on a sibling shard is reached through the
shared-memory handoff ring: ``EgressBatch.to_shard`` collects its clones
and the flush hands each sibling one ring record.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import TYPE_CHECKING, List, Optional, Sequence

from pushcdn_tpu_torch.broker.staging import StageResult
from pushcdn_tpu_torch.proto import flowclass
from pushcdn_tpu_torch.proto import ledger as ledger_mod
from pushcdn_tpu_torch.proto import metrics as metrics_mod
from pushcdn_tpu_torch.proto import trace as trace_mod
from pushcdn_tpu_torch.proto.def_ import HookResult
from pushcdn_tpu_torch.proto.error import Error
from pushcdn_tpu_torch.proto.limiter import Bytes
from pushcdn_tpu_torch.proto.message import (
    Broadcast,
    Direct,
    LedgerSync,
    Subscribe,
    SubscribeFrom,
    TopicSync,
    Unsubscribe,
    UserSync,
    deserialize,
)


def _ingress_class(message) -> int:
    """Frame-derived ledger class for ingress/link-recv accounting — the
    SAME rule senders use for the per-link tables (ISSUE 20): Broadcast →
    first-topic class, Direct → live, any other kind → control."""
    if isinstance(message, Broadcast):
        return flowclass.class_of_topics(message.topics)
    if isinstance(message, Direct):
        return flowclass.LIVE
    return flowclass.CONTROL
from pushcdn_tpu_torch.proto.util import mnemonic

if TYPE_CHECKING:
    from pushcdn_tpu_torch.broker.broker import Broker

logger = logging.getLogger("pushcdn.broker")


# ---------------------------------------------------------------------------
# routing core
# ---------------------------------------------------------------------------

class EgressBatch:
    """Per-wakeup egress accumulator: routing decisions append fan-out
    clones per peer; ``flush()`` hands each peer its whole batch with ONE
    ``send_raw_many`` (one queue entry, one writer wakeup). Per-peer frame
    order is the processing order, so per-(sender→receiver) ordering is
    identical to the per-frame path. Failure ⇒ removal semantics are the
    senders' (sender.rs:17-58).

    Lifecycle tracing: a routed TRACED message notes its context here
    (:meth:`note_trace`); ``flush()`` emits the ``egress`` span when the
    batch has been handed to every peer's writer queue. Deliberately NOT
    a wire-flush wait: forcing ``flush=True`` would let one backpressured
    peer head-of-line-block the sender's whole receive drain for up to
    the write timeout on every sampled message — the wire-side residence
    is observable via ``cdn_writer_queue_depth`` and the receiver's
    ``delivery`` span instead. ``appended`` counts fan-out clones routed
    into the batch, so span emission can tell a routed message from a
    dropped one (unknown recipient, no interest)."""

    __slots__ = ("broker", "users", "brokers", "shards", "appended",
                 "_traces")

    def __init__(self, broker: "Broker"):
        self.broker = broker
        self.users: dict = {}
        self.brokers: dict = {}
        # sharded data plane: {shard -> {(kind, ident) -> [clones]}} —
        # flushed as ONE handoff-ring record per shard
        self.shards: dict = {}
        self.appended = 0
        self._traces: Optional[list] = None

    def note_trace(self, tr) -> None:
        """Remember a traced message routed into this batch; its egress
        span is emitted when the batch flushes."""
        if self._traces is None:
            self._traces = []
        self._traces.append((tr, time.monotonic()))

    def to_user(self, public_key: bytes, raw: Bytes) -> None:
        lst = self.users.get(public_key)
        if lst is None:
            lst = self.users[public_key] = []
        lst.append(raw.clone())
        self.appended += 1

    def to_broker(self, identifier: str, raw: Bytes,
                  cls: int = flowclass.LIVE) -> None:
        lst = self.brokers.get(identifier)
        if lst is None:
            lst = self.brokers[identifier] = []
        lst.append(raw.clone())
        self.appended += 1
        # per-link conservation table (ISSUE 20): counted at the routing
        # decision, where the per-frame class is exact on both ends
        ledger_mod.note_link_sent(identifier, cls)

    def to_shard(self, shard: int, kind: int, ident, raw: Bytes,
                 cls: int = flowclass.LIVE) -> None:
        """Queue a fan-out clone for a peer living on a sibling shard
        (``kind`` is shardring.KIND_USER/KIND_BROKER)."""
        targets = self.shards.get(shard)
        if targets is None:
            targets = self.shards[shard] = {}
        lst = targets.get((kind, ident))
        if lst is None:
            lst = targets[(kind, ident)] = []
        lst.append(raw.clone())
        self.appended += 1
        if kind == 1:  # shardring.KIND_BROKER: a mesh link via shard 0
            ledger_mod.note_link_sent(ident, cls)

    def release_all(self) -> None:
        for frames in self.users.values():
            for f in frames:
                f.release()
        self.users.clear()
        for frames in self.brokers.values():
            for f in frames:
                f.release()
        self.brokers.clear()
        for targets in self.shards.values():
            for frames in targets.values():
                for f in frames:
                    f.release()
        self.shards.clear()

    def _flush_shards(self) -> None:
        """Hand each sibling shard its batch as one ring record: every
        distinct frame's bytes written once, each peer carrying its
        frame-index list (no re-serialization at the boundary). Synchronous
        — ring-full degrades to the runtime's counted relay fallback."""
        runtime = self.broker.shard_runtime
        for shard, targets in self.shards.items():
            frames: list = []
            index_of: dict = {}
            peers = []
            for (kind, ident), clones in targets.items():
                idx = []
                for c in clones:
                    key = id(c.data)
                    i = index_of.get(key)
                    if i is None:
                        i = index_of[key] = len(frames)
                        frames.append(c.data)
                    idx.append(i)
                peers.append((kind,
                              ident if isinstance(ident, bytes)
                              else ident.encode(), idx))
            runtime.handoff(shard, frames, peers)
            for clones in targets.values():
                for c in clones:
                    c.release()
        self.shards.clear()

    @staticmethod
    async def _send_batch(conn, frames: list) -> None:
        """Hand one peer its whole batch. Small-frame batches pre-encode
        into ONE PreEncoded writer entry via the native batch encoder
        (verbatim flush, permits released here, no per-frame writer
        work); other shapes ride ``send_raw_many`` (the writer's own
        coalescer). Ownership rule either way: the frames are consumed —
        released here on the encode path, by the connection on the raw
        path."""
        # class volume was already counted at the routing decision
        # (route_direct/route_broadcast, one count per fan-out pair), so
        # the writer entries carry nframes=0/nbytes=0 and only observe
        # queue delay — same suppression the cut-through plan path uses
        if len(frames) < 2:  # depth-1: nothing to coalesce, skip probing
            await conn.send_raw_many(frames, nframes=0, nbytes=0)
            return
        from pushcdn_tpu_torch.broker.tasks.senders import pre_encode_frames
        encoded = pre_encode_frames(frames)
        if encoded is not None:
            for f in frames:
                f.release()
            await conn.send_encoded(encoded, nbytes=0, count=len(frames))
        else:
            await conn.send_raw_many(frames, nframes=0, nbytes=0)

    async def flush(self) -> None:
        broker = self.broker
        traces, self._traces = self._traces, None
        try:
            if self.shards:
                # cross-shard handoff first: synchronous ring writes, so a
                # backpressured local peer below can't delay the sibling
                # (per-peer targets are disjoint — order across them is
                # not observable)
                self._flush_shards()
            # brokers first (reference fan-out order, handler.rs:240-272)
            while self.brokers:
                ident, frames = self.brokers.popitem()
                conn = broker.connections.get_broker_connection(ident)
                if conn is None:
                    for f in frames:
                        f.release()
                    continue
                metrics_mod.EGRESS_FRAMES_BROKER.inc(len(frames))
                try:
                    await self._send_batch(conn, frames)
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    logger.info("send to broker %s failed (%r); removing",
                                ident, exc)
                    broker.connections.remove_broker(ident,
                                                     reason="send failed")
                    broker.update_metrics()
            while self.users:
                key, frames = self.users.popitem()
                conn = broker.connections.get_user_connection(key)
                if conn is None:
                    for f in frames:
                        f.release()
                    continue
                metrics_mod.EGRESS_FRAMES_USER.inc(len(frames))
                try:
                    await self._send_batch(conn, frames)
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    logger.info("send to user %s failed (%r); removing",
                                mnemonic(key), exc)
                    broker.connections.remove_user(key, reason="send failed")
                    broker.update_metrics()
        except BaseException:
            # interrupted mid-flush (e.g. cancellation): the un-flushed
            # peers' clones must still return their pool permits
            self.release_all()
            raise
        if traces:
            # the whole batch is in the peers' writer queues: that handoff
            # IS the egress hop (wire residence is visible via
            # cdn_writer_queue_depth and the receiver's delivery span)
            now = time.monotonic()
            for tr, t0 in traces:
                trace_mod.emit("egress", tr,
                               f"writer-handoff {now - t0:.6f}s")


def _emit_staged_trace(message) -> None:
    """Span emission for a traced message the DEVICE plane accepted: the
    frame rides the staging ring and the device egress verbatim (flag +
    trace block intact — the receiver still emits ``delivery``), so the
    broker-side hops collapse to the stage handoff: ``plan`` = the stage
    decision, ``egress`` = handed to the device pump's egress (the pump
    itself is a batched jitted step with no per-message seam)."""
    tr = message.trace
    if tr is not None:
        trace_mod.emit("ingress", tr, "device")
        trace_mod.emit("plan", tr, "device-staged")
        trace_mod.emit("egress", tr, "device-staged")


def _emit_scalar_trace(message, egress: EgressBatch, before: int) -> None:
    """Span emission for a traced message routed by the scalar loops:
    ingress and plan collapse to adjacent instants (the scalar body is one
    synchronous block), the egress span completes at batch flush. One
    class-attribute load for the untraced 1023/1024. ``before`` is
    ``egress.appended`` captured before the route call — a message the
    route decision DROPPED (unknown recipient, no interest) gets its plan
    span tagged ``dropped`` and NO egress span, so a chain ending at
    ``plan`` means the broker itself dropped the message."""
    tr = message.trace
    if tr is not None:
        trace_mod.emit("ingress", tr, "scalar")
        if egress.appended > before:
            trace_mod.emit("plan", tr, "scalar")
            egress.note_trace(tr)
        else:
            trace_mod.emit("plan", tr, "dropped")


def route_direct(broker: "Broker", recipient: bytes, raw: Bytes,
                 to_user_only: bool, egress: EgressBatch) -> None:
    """One-hop direct routing decision (broker/handler.rs:197-237).

    Flow accounting mirrors the cut-through plan's semantics exactly: a
    delivered Direct counts ONE ``dir=in`` frame (class ``live``, like the
    plan's ``out_class``) and one ``dir=out`` count per fan-out pair,
    stamped at the routing decision before any connection lookup; a
    dropped Direct (unknown recipient) counts nothing (plan writes 255).
    """
    before = egress.appended
    _route_direct(broker, recipient, raw, to_user_only, egress)
    delta = egress.appended - before
    if delta:
        data = getattr(raw, "data", None)
        nb = (len(data) + 4) if data is not None else 4
        metrics_mod.CLASS_FRAMES_IN[flowclass.LIVE].inc()
        metrics_mod.CLASS_BYTES_IN[flowclass.LIVE].inc(nb)
        metrics_mod.CLASS_FRAMES_OUT[flowclass.LIVE].inc(delta)
        metrics_mod.CLASS_BYTES_OUT[flowclass.LIVE].inc(delta * nb)
    else:
        # unknown/stale recipient: the frame's terminal fate (ISSUE 20)
        ledger_mod.record_fate("dropped", "no_route", flowclass.LIVE)


def _route_direct(broker: "Broker", recipient: bytes, raw: Bytes,
                  to_user_only: bool, egress: EgressBatch) -> None:
    conns = broker.connections
    if conns.num_shards > 1:
        # sharded data plane: "our user" spans every worker shard of this
        # identity. A sibling's user rides the handoff ring (allowed even
        # for broker-origin frames — the sibling IS this broker); a mesh
        # owner reachable only via shard 0's links rides the ring too.
        # Precedence mirrors the unsharded path (and the cut-through
        # plan's dmap): the DirectMap owner wins, so a user the mesh
        # already re-homed elsewhere is forwarded even while the local
        # eviction delta is still in flight.
        from pushcdn_tpu_torch.broker import shardring
        owner = conns.get_broker_identifier_of_user(recipient)
        if owner is not None and owner != conns.identity:
            if to_user_only:
                # one-hop rule: never re-forward. But a forwarded direct
                # that raced a migration eviction here (the sender's
                # DirectMap replica hadn't caught up yet) can still reach
                # the user over the ``parting`` connection the client is
                # draining — chasing it beats a silent delivered-loss.
                if recipient in conns.parting:
                    egress.to_user(recipient, raw)
                return
            if owner in conns.brokers:
                egress.to_broker(owner, raw)
            else:
                link_shard = conns.remote_broker_shard.get(owner)
                if link_shard is not None:
                    egress.to_shard(link_shard, shardring.KIND_BROKER,
                                    owner, raw)
            return
        # owner is this box — or absent from this worker's replica
        # (sibling users are mirrored into the DirectMap on shard 0
        # only): deliver locally, else hand off to the owning shard
        if recipient in conns.users:
            egress.to_user(recipient, raw)
            return
        shard = conns.remote_user_shard.get(recipient)
        if shard is not None:
            egress.to_shard(shard, shardring.KIND_USER, recipient, raw)
            return
        if recipient in conns.parting:  # evicted mid-flight: chase
            egress.to_user(recipient, raw)
        return  # unknown/stale user: drop
    owner = conns.get_broker_identifier_of_user(recipient)
    if owner == conns.identity:
        egress.to_user(recipient, raw)
    elif owner is None:
        # unknown user: drop — unless the old connection is still
        # parting after an eviction (the row may be gone entirely when
        # the user disconnected elsewhere before this frame landed)
        if recipient in conns.parting:
            egress.to_user(recipient, raw)
    elif not to_user_only:
        # forward one hop to the owning broker; the remote end delivers
        # with to_user_only=True so it can never bounce back
        egress.to_broker(owner, raw)
    else:
        # one-hop rule: never re-forward. A forwarded direct that raced
        # the migration eviction (sender's DirectMap replica was behind)
        # still reaches the user over the ``parting`` connection the
        # client is draining — chasing it beats a silent delivered-loss.
        if recipient in conns.parting:
            egress.to_user(recipient, raw)


def route_broadcast(broker: "Broker", topics: Sequence[int], raw: Bytes,
                    to_users_only: bool, egress: EgressBatch,
                    users_via_device: bool = False,
                    exclude_brokers: frozenset = frozenset(),
                    interest_cache: Optional[dict] = None,
                    raw_topics: Optional[Sequence[int]] = None) -> None:
    """Interest-driven fan-out decision (broker/handler.rs:240-272).

    ``users_via_device=True`` means the local-user fan-out was staged onto
    the device plane; only the inter-broker forwarding runs on the host.
    ``exclude_brokers`` are peers already covered by the device mesh
    (group members) — interested OUT-of-group brokers still get the frame.
    ``interest_cache`` memoizes the interest query per (topics, scope)
    within one receive batch; entries carry ``Connections.interest_version``
    so a subscription/membership/sync mutation from ANY task — including
    one landing while this batch awaits egress or device backpressure —
    invalidates them, keeping parity with the reference's per-message
    interest query.

    Flow accounting mirrors the cut-through plan: one ``dir=in`` frame per
    Broadcast with a non-empty (pruned) topic list — consumed even with
    zero interested peers, like the plan's ``out_class`` — and one
    ``dir=out`` count per fan-out pair, under the class of the FIRST
    topic byte of the frame AS SENT (``raw_topics``; the plan kernel
    reads that byte before pruning, and the scalar twin must agree).
    """
    before = egress.appended
    cls = flowclass.class_of_topics(
        raw_topics if raw_topics is not None else topics)
    _route_broadcast(broker, topics, raw, to_users_only, egress,
                     users_via_device=users_via_device,
                     exclude_brokers=exclude_brokers,
                     interest_cache=interest_cache, cls=cls)
    if topics:
        data = getattr(raw, "data", None)
        nb = (len(data) + 4) if data is not None else 4
        metrics_mod.CLASS_FRAMES_IN[cls].inc()
        metrics_mod.CLASS_BYTES_IN[cls].inc(nb)
        delta = egress.appended - before
        if delta:
            metrics_mod.CLASS_FRAMES_OUT[cls].inc(delta)
            metrics_mod.CLASS_BYTES_OUT[cls].inc(delta * nb)
        elif not users_via_device:
            # zero interested recipients: a counted (benign) fate
            ledger_mod.record_fate("dropped", "no_interest", cls)


def _route_broadcast(broker: "Broker", topics: Sequence[int], raw: Bytes,
                     to_users_only: bool, egress: EgressBatch,
                     users_via_device: bool = False,
                     exclude_brokers: frozenset = frozenset(),
                     interest_cache: Optional[dict] = None,
                     cls: int = flowclass.LIVE) -> None:
    if interest_cache is None:
        users, brokers = broker.connections.get_interested_by_topic(
            list(topics), to_users_only)
    else:
        version = broker.connections.interest_version
        key = (tuple(topics), to_users_only)
        hit = interest_cache.get(key)
        if hit is None or hit[0] != version:
            hit = (version, broker.connections.get_interested_by_topic(
                list(topics), to_users_only))
            interest_cache[key] = hit
        users, brokers = hit[1]
    conns = broker.connections
    if conns.num_shards > 1:
        # sharded data plane: the interest tables span the whole box, so
        # a hit may live on a sibling shard (user) or be reachable only
        # through shard 0's mesh links (broker) — ride the handoff ring
        from pushcdn_tpu_torch.broker import shardring
        local_users = conns.users
        local_brokers = conns.brokers
        for ident in brokers:
            if ident in exclude_brokers:
                continue
            if ident in local_brokers:
                egress.to_broker(ident, raw, cls=cls)
            else:
                link_shard = conns.remote_broker_shard.get(ident)
                if link_shard is not None:
                    egress.to_shard(link_shard, shardring.KIND_BROKER,
                                    ident, raw, cls=cls)
        if not users_via_device:
            for user in users:
                if user in local_users:
                    egress.to_user(user, raw)
                else:
                    shard = conns.remote_user_shard.get(user)
                    if shard is not None:
                        egress.to_shard(shard, shardring.KIND_USER, user,
                                        raw)
                    elif user in conns.parting:
                        # interest rows outlive the eviction through the
                        # parting grace: the chase delivery (see
                        # Connections.remove_user)
                        egress.to_user(user, raw)
        return
    for ident in brokers:
        if ident not in exclude_brokers:
            egress.to_broker(ident, raw, cls=cls)
    if not users_via_device:
        for user in users:
            egress.to_user(user, raw)


async def handle_direct_message(broker: "Broker", recipient: bytes,
                                raw: Bytes, to_user_only: bool) -> None:
    """One-shot direct routing (kept for non-batched callers)."""
    egress = EgressBatch(broker)
    route_direct(broker, recipient, raw, to_user_only, egress)
    await egress.flush()


async def handle_broadcast_message(broker: "Broker", topics: Sequence[int],
                                   raw: Bytes, to_users_only: bool,
                                   users_via_device: bool = False,
                                   exclude_brokers: frozenset = frozenset()
                                   ) -> None:
    """One-shot broadcast fan-out (kept for non-batched callers)."""
    egress = EgressBatch(broker)
    route_broadcast(broker, topics, raw, to_users_only, egress,
                    users_via_device=users_via_device,
                    exclude_brokers=exclude_brokers)
    await egress.flush()


async def _stage_with_backpressure(device, message, raw: Bytes):
    """Stage onto the device plane; FULL results block THIS sender's
    receive loop and retry — the same "block the reader, not the router"
    semantics the byte-pool gives the host path. The wait is unbounded on
    purpose (so is the pool's): if the pump dies it flips ``disabled`` and
    try_stage starts returning INELIGIBLE, which exits the loop."""
    while True:
        result = device.try_stage(message, raw)
        if result != StageResult.FULL:
            return result
        await asyncio.sleep(0.002)


# ---------------------------------------------------------------------------
# user receive loop
# ---------------------------------------------------------------------------

async def user_receive_loop(broker: "Broker", public_key: bytes,
                            connection) -> None:
    """Pump one user's messages until the connection dies or the user is
    kicked (user/handler.rs:104-161). Messages are drained and routed in
    batches: one ``recv_raw_many`` wakeup routes every pending frame, and
    the fan-out goes out as per-peer ``send_raw_many`` batches."""
    from pushcdn_tpu_torch.broker.tasks import cutthrough  # lazy: import cycle
    hook = broker.run_def.user_def.hook
    topics = broker.run_def.topics
    alive = True
    try:
        while alive:
            # Cut-through plane: when eligible (native kernel compiled, no
            # device plane, default hook), whole FrameChunk batches route
            # via one plan call with zero per-frame Python — the scalar
            # body below is the correctness twin (and the path control
            # frames always take).
            cut = cutthrough.acquire(broker, hook)
            if cut is not None:
                items = await connection.recv_frames()
                alive = await cut.route_drain(public_key, items,
                                              is_user=True,
                                              conn=connection)
                continue
            raws = await connection.recv_raw_many()
            metrics_mod.ROUTE_SCALAR_FRAMES.inc(len(raws))
            egress = EgressBatch(broker)
            interest_cache: dict = {}
            # device-eligible (message, raw, pruned_topics) collected during
            # the scan and staged in ONE stage_batch call after it (one
            # native pack per size lane instead of a per-frame ring push)
            stage_items: list = []
            device = broker.device_plane
            try:
                for raw in raws:
                    try:
                        message = deserialize(raw.data)
                    except Error:
                        # malformed frame ⇒ disconnect
                        # (user/handler.rs:106-118)
                        logger.info(
                            "user %s sent malformed frame; disconnecting",
                            mnemonic(public_key))
                        connection.flightrec.record("malformed-frame",
                                                    abnormal=True)
                        ledger_mod.record_fate("dropped", "malformed",
                                               flowclass.CLASS_NONE)
                        alive = False
                        break
                    ledger_mod.note_ingress(_ingress_class(message))
                    result = hook(public_key, message)
                    if result == HookResult.SKIP:
                        continue
                    if result == HookResult.DISCONNECT:
                        alive = False
                        break

                    if isinstance(message, Direct):
                        # device path covers local-recipient delivery (and,
                        # for a mesh-group plane, any recipient in the
                        # group); host path covers the rest
                        if device is not None:
                            stage_items.append((message, raw, None))
                            continue
                        a0 = egress.appended
                        route_direct(broker, message.recipient, raw,
                                     to_user_only=False, egress=egress)
                        _emit_scalar_trace(message, egress, a0)
                    elif isinstance(message, Broadcast):
                        pruned, _bad = topics.prune(message.topics)
                        if pruned:
                            # durable topics (ISSUE 14): retention stamp in
                            # the same synchronous block as the route
                            # decision; a False return means the owning
                            # shard fans out through its ordered drainer
                            durable = broker.durable
                            if durable is not None and not durable.on_publish(
                                    pruned, message, raw,
                                    to_users_only=False):
                                continue
                            if device is not None:
                                stage_items.append((message, raw, pruned))
                                continue
                            a0 = egress.appended
                            route_broadcast(
                                broker, pruned, raw, to_users_only=False,
                                egress=egress,
                                interest_cache=interest_cache,
                                raw_topics=message.topics)
                            _emit_scalar_trace(message, egress, a0)
                    elif isinstance(message, Subscribe):
                        pruned, bad = topics.prune(message.topics)
                        if bad:
                            # unknown topic ⇒ disconnect (subscribe.rs test
                            # behavior: invalid-topic subscriptions kick)
                            alive = False
                            break
                        adm = broker.admission
                        if adm is not None and \
                                not adm.allow_subscribe(connection):
                            # over-rate: drop the mutation, notify typed
                            # through the ordered egress path (ISSUE 7)
                            adm.shed_subscribe(public_key, connection,
                                               egress)
                            continue
                        broker.connections.subscribe_user_to(public_key,
                                                             pruned)
                    elif isinstance(message, Unsubscribe):
                        adm = broker.admission
                        if adm is not None and \
                                not adm.allow_subscribe(connection):
                            adm.shed_subscribe(public_key, connection,
                                               egress)
                            continue
                        pruned, _bad = topics.prune(message.topics)
                        broker.connections.unsubscribe_user_from(public_key,
                                                                 pruned)
                    elif isinstance(message, SubscribeFrom):
                        # durable replay subscribe: registration + ring
                        # snapshot + replay enqueue in one synchronous
                        # block (the handover invariant)
                        adm = broker.admission
                        if adm is not None and \
                                not adm.allow_subscribe(connection):
                            adm.shed_subscribe(public_key, connection,
                                               egress)
                            continue
                        durable = broker.durable
                        if durable is None or not durable.handle_subscribe_from(
                                public_key, message, connection):
                            alive = False
                            break
                    else:
                        # users may not send auth or sync messages
                        # post-handshake
                        alive = False
                        break

                # phase 2: batch-stage the collected device-eligible
                # messages, then host-route whatever the device didn't take
                if stage_items:
                    results = device.stage_batch(
                        [(m, r) for m, r, _ in stage_items])
                    for (message, raw, pruned), res in zip(stage_items,
                                                           results):
                        if res == StageResult.FULL:
                            res = await _stage_with_backpressure(
                                device, message, raw)
                        staged = res == StageResult.STAGED
                        if staged:
                            _emit_staged_trace(message)
                        if isinstance(message, Direct):
                            if not staged:
                                a0 = egress.appended
                                route_direct(broker, message.recipient, raw,
                                             to_user_only=False,
                                             egress=egress)
                                _emit_scalar_trace(message, egress, a0)
                        else:
                            # host side: remaining fan-out — all of it when
                            # not staged; only out-of-group/interest
                            # forwarding when the device covers users
                            # (+ group peers over ICI)
                            a0 = egress.appended
                            route_broadcast(
                                broker, pruned, raw, to_users_only=False,
                                egress=egress, users_via_device=staged,
                                exclude_brokers=(
                                    frozenset(
                                        device.covered_broker_idents())
                                    if staged else frozenset()),
                                interest_cache=interest_cache,
                                raw_topics=message.topics)
                            if not staged:
                                _emit_scalar_trace(message, egress, a0)
            finally:
                try:
                    await egress.flush()
                finally:
                    for raw in raws:
                        raw.release()
    except (Error, asyncio.IncompleteReadError):
        pass  # connection died: fall through to removal
    except asyncio.CancelledError:
        raise
    finally:
        # Only deregister if WE are still the registered connection — a
        # same-broker double-connect evicts the old loop (cancelling it)
        # after the new connection has already taken the map slot, and the
        # old loop's cleanup must not remove the new entry.
        if broker.connections.get_user_connection(public_key) is connection:
            broker.connections.remove_user(public_key, reason="receive loop ended")
        broker.update_metrics()


# ---------------------------------------------------------------------------
# broker receive loop
# ---------------------------------------------------------------------------

async def broker_receive_loop(broker: "Broker", identifier: str,
                              connection) -> None:
    """Pump a peer broker's messages (broker/handler.rs:121-193), batched
    the same way as the user loop."""
    from pushcdn_tpu_torch.broker.tasks import cutthrough  # lazy: import cycle
    hook = broker.run_def.broker_def.hook
    topics = broker.run_def.topics
    alive = True
    try:
        while alive:
            # same cut-through seam as the user loop (broker-origin mode:
            # local-users-only broadcast, to_user_only direct)
            cut = cutthrough.acquire(broker, hook)
            if cut is not None:
                items = await connection.recv_frames()
                alive = await cut.route_drain(identifier, items,
                                              is_user=False,
                                              conn=connection)
                continue
            raws = await connection.recv_raw_many()
            metrics_mod.ROUTE_SCALAR_FRAMES.inc(len(raws))
            egress = EgressBatch(broker)
            interest_cache: dict = {}
            stage_items: list = []
            device = broker.device_plane
            # A covers_brokers (mesh-group) plane must NOT re-stage
            # host-forwarded traffic: the origin couldn't stage it, and
            # re-staging would all_gather it back to every shard —
            # duplicate delivery. Host-forwarded frames are delivered
            # locally only, exactly the reference's to_users_only rule.
            single_shard = (device is not None
                            and not device.covers_brokers)
            try:
                for raw in raws:
                    try:
                        message = deserialize(raw.data)
                    except Error:
                        logger.warning(
                            "broker %s sent malformed frame; dropping link",
                            identifier)
                        connection.flightrec.record("malformed-frame",
                                                    abnormal=True)
                        ledger_mod.record_fate("dropped", "malformed",
                                               flowclass.CLASS_NONE)
                        alive = False
                        break
                    ledger_mod.note_ingress(_ingress_class(message),
                                            peer=identifier)
                    result = hook(identifier, message)
                    if result == HookResult.SKIP:
                        continue
                    if result == HookResult.DISCONNECT:
                        alive = False
                        break

                    if isinstance(message, Direct):
                        # deliver to our own user only — never re-forward
                        # (broker/handler.rs:148-153); the single-shard
                        # device path's delivery-iff-owner rule keeps that
                        # invariant
                        if single_shard:
                            stage_items.append((message, raw, None))
                            continue
                        a0 = egress.appended
                        route_direct(broker, message.recipient, raw,
                                     to_user_only=True, egress=egress)
                        _emit_scalar_trace(message, egress, a0)
                    elif isinstance(message, Broadcast):
                        # users only — prevents broadcast loops
                        # (broker/handler.rs:156-161)
                        pruned, _bad = topics.prune(message.topics)
                        if pruned:
                            # mesh-forwarded durable broadcasts are retained
                            # here too, so a user rejoining at THIS broker
                            # replays mesh-wide history (seqs broker-local)
                            durable = broker.durable
                            if durable is not None and not durable.on_publish(
                                    pruned, message, raw,
                                    to_users_only=True):
                                continue
                            if single_shard:
                                stage_items.append((message, raw, pruned))
                                continue
                            a0 = egress.appended
                            route_broadcast(broker, pruned, raw,
                                            to_users_only=True,
                                            egress=egress,
                                            interest_cache=interest_cache,
                                            raw_topics=message.topics)
                            _emit_scalar_trace(message, egress, a0)
                    elif isinstance(message, UserSync):
                        broker.connections.apply_user_sync(message.payload)
                        broker.update_metrics()
                    elif isinstance(message, TopicSync):
                        broker.connections.apply_topic_sync(identifier,
                                                            message.payload)
                    elif isinstance(message, LedgerSync):
                        # peer's conservation balance sheet (ISSUE 20) —
                        # unparseable sheets are ignored, not link-fatal
                        # (monotone snapshots, last writer wins)
                        import json
                        try:
                            sheet = json.loads(bytes(message.payload))
                        except (ValueError, UnicodeDecodeError):
                            sheet = None
                        if sheet is not None:
                            ledger_mod.LEDGER.note_peer_sheet(identifier,
                                                              sheet)
                    else:
                        logger.warning(
                            "broker %s sent unexpected %s; dropping link",
                            identifier, type(message).__name__)
                        alive = False
                        break

                if stage_items:
                    results = device.stage_batch(
                        [(m, r) for m, r, _ in stage_items])
                    for (message, raw, pruned), res in zip(stage_items,
                                                           results):
                        if res == StageResult.FULL:
                            res = await _stage_with_backpressure(
                                device, message, raw)
                        if res == StageResult.STAGED:
                            _emit_staged_trace(message)
                            continue
                        a0 = egress.appended
                        if isinstance(message, Direct):
                            route_direct(broker, message.recipient, raw,
                                         to_user_only=True, egress=egress)
                        else:
                            route_broadcast(broker, pruned, raw,
                                            to_users_only=True,
                                            egress=egress,
                                            interest_cache=interest_cache,
                                            raw_topics=message.topics)
                        _emit_scalar_trace(message, egress, a0)
            finally:
                try:
                    await egress.flush()
                finally:
                    for raw in raws:
                        raw.release()
    except (Error, asyncio.IncompleteReadError):
        pass
    except asyncio.CancelledError:
        raise
    finally:
        # Same guard as the user loop: a replaced link's cancelled loop must
        # not deregister the replacement.
        if broker.connections.get_broker_connection(identifier) is connection:
            broker.connections.remove_broker(identifier, reason="receive loop ended")
        broker.update_metrics()
