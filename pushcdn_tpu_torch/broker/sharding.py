"""Sharded data plane: N worker OS processes (worker shards) presenting
as ONE broker.

Topology:

- the **parent** process supervises: it creates the shared-memory handoff
  rings (one per directed shard pair, ``shardring.py``), relays
  control-plane deltas between workers (the hub stamps a total order), and
  serves the aggregated observability endpoint (``/metrics`` with a
  ``shard`` label, ``/healthz``+``/readyz``+``/debug/topology`` merged
  across workers);
- **worker shard 0** owns the mesh: it binds the private endpoint, runs
  heartbeat/sync/whitelist, and fronts discovery for the whole box
  (reporting ``num_users_global``);
- **every worker** binds the public endpoint with ``SO_REUSEPORT`` (the
  kernel spreads accepted users across workers); where the platform lacks
  it, the parent binds once and passes accepted fds over a unix socketpair
  with ``sendmsg``/SCM_RIGHTS (:class:`FdHandoffListener`).

Data plane: each worker runs the existing cut-through drain against a
per-shard route snapshot whose peer space covers the WHOLE box (sibling
users + mesh links by owning shard). Fan-out to a peer on another worker
is handed off as pre-encoded wire chunks + per-peer index lists over the
shard rings — no re-serialization, no per-frame Python on the receiving
side ("RPC Considered Harmful" applied to our own interior boundary).
Ring-full degrades to a *counted* relay through the parent's control
socket (never blocks the drain); an epoch/ack handshake re-orders the
return to the ring so per-(origin→peer) frame order survives the
degraded window.

Control plane: subscribe/DirectMap mutations flow worker→parent→workers
as versioned deltas (``Connections.shard_notifier`` emits, the hub relays,
``ShardRuntime.apply_event`` applies); each application bumps
``interest_version`` so cut-through snapshots rebuild exactly like any
local mutation.

The port's copy of ``pushcdn_tpu.broker.sharding``. Every process it
starts is host-only and never imports torch. The durable-topic events
(``durable_pub``/``durable_retain``/``durable_sub``) go to the owner
shard's ``DurableTopics.apply_shard_event`` and stay out of the
interest-delta counters, as in the reference.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import pickle
import signal as signal_mod
import socket
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from pushcdn_tpu_torch.broker import shardring
from pushcdn_tpu_torch.proto import flowclass
from pushcdn_tpu_torch.proto import health as health_mod
from pushcdn_tpu_torch.proto import ledger as ledger_mod
from pushcdn_tpu_torch.proto import metrics as metrics_mod
from pushcdn_tpu_torch.proto.util import mnemonic

logger = logging.getLogger("pushcdn.broker.shard")

_FRAME_LEN = struct.Struct(">I")

DEFAULT_RING_BYTES = int(os.environ.get("PUSHCDN_SHARD_RING_BYTES",
                                        str(4 * 1024 * 1024)))

# per-worker cap on the parent hub's outbound control-socket buffer: the
# relay budget bounds per-producer relay bytes, but broadcast deltas
# (connect/subscribe storms) are unbudgeted, so a worker that stops
# draining its control socket must be cut loose before it grows the
# parent heap without bound
HUB_MAX_BUFFER = int(os.environ.get("PUSHCDN_SHARD_HUB_MAX_BUFFER",
                                    str(32 * 1024 * 1024)))


def shards_from_env(flag_value: Optional[int]) -> int:
    if flag_value is not None:
        return max(int(flag_value), 1)
    raw = os.environ.get("PUSHCDN_SHARDS", "").strip()
    if raw:
        try:
            return max(int(raw), 1)
        except ValueError:
            pass
    return 1


# ---------------------------------------------------------------------------
# control-plane buses
# ---------------------------------------------------------------------------

class LocalBus:
    """In-process bus (tests, benches): deltas apply synchronously to the
    sibling runtimes in publish order — the same total order the parent
    hub provides across processes."""

    def __init__(self):
        self.runtimes: Dict[int, "ShardRuntime"] = {}
        self.version = 0

    def register(self, runtime: "ShardRuntime") -> None:
        self.runtimes[runtime.shard_id] = runtime

    def publish(self, origin: int, event: tuple) -> None:
        self.version += 1
        if event[0] == "relay":
            target = self.runtimes.get(event[1])
            if target is not None:
                target.apply_event(origin, event)
            return
        if event[0] == "relay_ack":
            target = self.runtimes.get(event[1])
            if target is not None:
                target.apply_event(origin, event)
            return
        for shard, rt in self.runtimes.items():
            if shard != origin:
                rt.apply_event(origin, event)


class SocketBus:
    """Worker end of the parent control socket: length-prefixed pickled
    frames. ``publish`` enqueues synchronously (Connections mutators are
    sync); a writer task drains; a reader task applies parent relays."""

    def __init__(self, runtime: "ShardRuntime", sock: socket.socket):
        self.runtime = runtime
        self._sock = sock
        self._out: asyncio.Queue = asyncio.Queue()
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    def publish(self, origin: int, event: tuple) -> None:
        self._out.put_nowait(pickle.dumps(event,
                                          protocol=pickle.HIGHEST_PROTOCOL))

    async def run(self) -> None:
        """Reader+writer over the control socket; exits (and thus fails
        the broker fast) if the parent goes away."""
        self._sock.setblocking(False)
        reader, writer = await asyncio.open_connection(sock=self._sock)
        self._reader, self._writer = reader, writer

        async def _send_loop():
            while True:
                blob = await self._out.get()
                writer.write(_FRAME_LEN.pack(len(blob)) + blob)
                await writer.drain()

        send_task = asyncio.create_task(_send_loop(), name="shard-bus-send")
        try:
            while True:
                hdr = await reader.readexactly(4)
                (n,) = _FRAME_LEN.unpack(hdr)
                blob = await reader.readexactly(n)
                origin, event = pickle.loads(blob)
                self.runtime.apply_event(origin, event)
        finally:
            send_task.cancel()


# ---------------------------------------------------------------------------
# worker-side runtime
# ---------------------------------------------------------------------------

class ShardRuntime:
    """One worker's shard plumbing: ring writers/readers + notify fds +
    the control bus, attached to a live :class:`Broker`."""

    def __init__(self, broker, shard_id: int, num_shards: int,
                 rings_out: Dict[int, shardring.RingWriter],
                 rings_in: Dict[int, shardring.RingReader],
                 notify_rx: Optional[socket.socket]):
        self.broker = broker
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.rings_out = rings_out
        self.rings_in = rings_in
        self.notify_rx = notify_rx
        self.bus = None  # set via set_bus
        self._notify_event = asyncio.Event()
        self._reader_installed = False
        # ring-full degradation state per destination: once a push fails
        # we stay on the relay path until the ring is drained AND the last
        # relay epoch is acked — the handshake that keeps per-peer frame
        # order across the degraded window
        self._fallback: Dict[int, bool] = {}
        self._relay_epoch: Dict[int, int] = {}
        self._acked_epoch: Dict[int, int] = {}
        # unacked relayed bytes per destination, by epoch: the relay path
        # is NOT allowed to grow without bound when the consumer stays
        # slow — past the budget, records are SHED (counted), which keeps
        # "never block the drain" from becoming unbounded memory
        self._relay_unacked: Dict[int, Dict[int, int]] = {}
        # consumer side: one lock per ORIGIN serializes the ring drain
        # with relay delivery, so a relay task can never overtake ring
        # records (or another relay) from the same producer mid-dispatch
        self._origin_locks: Dict[int, asyncio.Lock] = {}
        # readers abandoned by the poison guard: out of rings_in (never
        # drained again) but still closed with the runtime
        self._poisoned_readers: List[shardring.RingReader] = []
        self.relay_fallbacks = 0
        self.relay_shed = 0
        self.deltas_applied = 0
        self._sync_kick_pending = False

    def _origin_lock(self, origin: int) -> asyncio.Lock:
        lock = self._origin_locks.get(origin)
        if lock is None:
            lock = self._origin_locks[origin] = asyncio.Lock()
        return lock

    # -- wiring --------------------------------------------------------------

    def set_bus(self, bus) -> None:
        self.bus = bus

    def attach(self) -> None:
        """Install on the broker + its Connections (call before traffic)."""
        conns = self.broker.connections
        conns.num_shards = self.num_shards
        conns.shard_id = self.shard_id
        conns.shard_notifier = self._emit
        self.broker.shard_runtime = self
        if self.notify_rx is not None:
            asyncio.get_running_loop().add_reader(
                self.notify_rx.fileno(), self._notify_event.set)
            self._reader_installed = True

    def close(self) -> None:
        if self._reader_installed and self.notify_rx is not None:
            try:
                asyncio.get_event_loop().remove_reader(
                    self.notify_rx.fileno())
            except Exception:
                pass
        conns = getattr(self.broker, "connections", None)
        if conns is not None and conns.shard_notifier is self._emit:
            conns.shard_notifier = None
        for w in self.rings_out.values():
            w.close()
        for r in self.rings_in.values():
            r.close()
        for r in self._poisoned_readers:
            r.close()

    def _emit(self, event: tuple) -> None:
        if self.bus is not None:
            self.bus.publish(self.shard_id, event)

    # -- control-plane delta application ------------------------------------

    def apply_event(self, origin: int, event: tuple) -> None:
        kind = event[0]
        conns = self.broker.connections
        # data-plane relay traffic and unknown events must NOT inflate
        # the interest-delta counters: during a ring-full window the
        # relay+ack chatter would otherwise read as a subscription storm
        if kind == "relay":
            asyncio.ensure_future(self._deliver_relay(origin, event[2],
                                                      event[3]))
            return
        if kind == "relay_ack":
            epoch = event[2]
            self._acked_epoch[origin] = max(
                self._acked_epoch.get(origin, 0), epoch)
            unacked = self._relay_unacked.get(origin)
            if unacked:
                for e in [e for e in unacked if e <= epoch]:
                    del unacked[e]
            return
        if kind in ("durable_pub", "durable_retain", "durable_sub"):
            # durable-topic data plane: owner-shard retention / replay
            # traffic — like relay, kept out of the interest-delta
            # counters
            durable = getattr(self.broker, "durable", None)
            if durable is not None:
                durable.apply_shard_event(event)
            return
        if kind not in ("user", "user_del", "usersync", "mesh_topics",
                        "mesh_broker_del"):
            logger.warning("unknown shard delta %r from shard %d",
                           kind, origin)
            return
        self.deltas_applied += 1
        metrics_mod.SHARD_DELTAS_APPLIED.inc()
        if kind == "user":
            conns.set_remote_user(event[1], origin, event[2])
            self._kick_mesh_sync()
        elif kind == "user_del":
            conns.remove_remote_user(event[1], origin)
            self._kick_mesh_sync()
        elif kind == "usersync":
            conns.apply_user_sync(event[1], from_sibling=True)
        elif kind == "mesh_topics":
            conns.set_remote_broker(event[1], origin, event[2])
        elif kind == "mesh_broker_del":
            conns.remove_remote_broker(event[1])

    def _kick_mesh_sync(self) -> None:
        """Shard 0 pushes partial syncs promptly when sibling membership
        changes (strong consistency across the mesh — the same semantics
        a local user connect gets from the listener). Kicks COALESCE: a
        delta storm (thousands of sibling connects applied in one bus
        drain) schedules one push task, not one per delta — the pending
        flag clears before the CRDT diff is computed, so a delta landing
        after that point just schedules the next push."""
        if self.shard_id != 0 or not self.broker.connections.brokers:
            return
        if self._sync_kick_pending:
            return
        self._sync_kick_pending = True
        from pushcdn_tpu_torch.broker.tasks import sync as sync_task

        async def _push():
            self._sync_kick_pending = False
            try:
                await sync_task.partial_user_sync(self.broker)
                await sync_task.partial_topic_sync(self.broker)
            except Exception:
                logger.debug("sibling-delta partial sync failed",
                             exc_info=True)
        asyncio.ensure_future(_push())

    # -- cross-shard egress ---------------------------------------------------

    def _enter_fallback(self, dst: int) -> None:
        if not self._fallback.get(dst):
            self._fallback[dst] = True
            logger.warning("shard ring %d->%d full; relaying via control "
                           "plane until drained", self.shard_id, dst)

    def _ring_usable(self, dst: int) -> bool:
        w = self.rings_out.get(dst)
        if w is not None and w.poisoned:
            return False  # consumer abandoned it: relay for good
        if not self._fallback.get(dst, False):
            return True
        if w is None:
            return False
        # leave the degraded mode only once the consumer fully drained the
        # ring AND acked the last relay epoch (order barrier)
        if w.head == w.tail and self._acked_epoch.get(dst, 0) \
                >= self._relay_epoch.get(dst, 0):
            self._fallback[dst] = False
            return True
        return False

    def handoff(self, dst: int, frames: List, peers: List[tuple],
                prefixed: bool = False) -> None:
        """Scalar-path handoff: ``frames[i]`` are frame buffers, peers
        carry frame-index lists (EgressBatch._flush_shards)."""
        if self._ring_usable(dst):
            w = self.rings_out.get(dst)
            if w is not None and w.try_push(frames, peers,
                                            prefixed=prefixed):
                metrics_mod.SHARD_HANDOFF_RING.inc()
                metrics_mod.SHARD_HANDOFF_FRAMES_RING.inc(len(frames))
                # the frames are the sibling shard's responsibility now
                # (informational fate — class unresolved at this layer)
                ledger_mod.record_fate("relayed", "shard_ring",
                                       flowclass.CLASS_NONE, len(frames))
                return
            self._enter_fallback(dst)
        entries = []
        for kind, ident, idx in peers:
            if prefixed:
                stream = b"".join(bytes(frames[i]) for i in idx)
            else:
                stream = b"".join(
                    _FRAME_LEN.pack(len(frames[i])) + bytes(frames[i])
                    for i in idx)
            entries.append((kind, bytes(ident), stream, len(idx)))
        self._relay(dst, entries, n_frames=len(frames))

    def handoff_chunk(self, buf, offs, lens,
                      per_shard: Dict[int, List[tuple]]) -> None:
        """Cut-through handoff: copy the union of each shard's referenced
        wire frames straight from the pooled chunk into the ring record
        (one pass, already length-delimited — offs/lens are the chunk's
        payload table, the wire slice includes the 4-byte prefix)."""
        for dst, peers in per_shard.items():
            idx_arrays = [np.asarray(idx) for _k, _i, idx in peers]
            # per-peer idx arrays arrive sorted-unique (grouped from a
            # stable argsort), so the single-peer union IS the array
            union = np.unique(np.concatenate(idx_arrays)) \
                if len(idx_arrays) > 1 else idx_arrays[0]
            mv = memoryview(buf)
            frames = [mv[int(offs[i]) - 4: int(offs[i]) + int(lens[i])]
                      for i in union.tolist()]
            remapped = [
                (kind, ident,
                 np.searchsorted(union, np.asarray(idx)).tolist())
                for kind, ident, idx in peers]
            self.handoff(dst, frames, remapped, prefixed=True)

    # unacked relay budget per destination: past this, doubly-degraded
    # traffic (ring full AND the relay pipeline backed up) is SHED with a
    # counter instead of growing the control-plane queues without bound
    _RELAY_MAX_BYTES = int(os.environ.get(
        "PUSHCDN_SHARD_RELAY_MAX_BYTES", str(8 * 1024 * 1024)))

    def _relay(self, dst: int, entries: List[tuple],
               n_frames: int = 0) -> None:
        size = sum(len(e[2]) for e in entries)
        unacked = self._relay_unacked.setdefault(dst, {})
        if sum(unacked.values()) + size > self._RELAY_MAX_BYTES:
            # overload shedding: the consumer is behind on BOTH channels;
            # dropping here (counted) is the bounded alternative to
            # stalling the drain or OOMing the control plane
            self.relay_shed += 1
            metrics_mod.SHARD_HANDOFF_SHED.inc()
            metrics_mod.SHARD_HANDOFF_FRAMES_SHED.inc(n_frames)
            ledger_mod.record_fate("dropped", "relay_shed",
                                   flowclass.CLASS_NONE, n_frames)
            return
        self.relay_fallbacks += 1
        metrics_mod.SHARD_HANDOFF_FALLBACK.inc()
        metrics_mod.SHARD_HANDOFF_FRAMES_FALLBACK.inc(n_frames)
        epoch = self._relay_epoch.get(dst, 0) + 1
        self._relay_epoch[dst] = epoch
        unacked[epoch] = size
        self._emit(("relay", dst, entries, epoch))

    async def _deliver_relay(self, origin: int, entries: List[tuple],
                             epoch: int) -> None:
        """Apply a sibling's ring-full relay: under the per-origin lock
        (serialized with the ring-drain task and with other relays from
        the same producer — an unserialized relay could overtake ring
        records mid-dispatch and invert per-peer frame order), drain our
        inbound ring from that origin FIRST (those records predate the
        relay — FIFO per producer), then enqueue the relayed streams,
        then ack the epoch so the producer may return to the ring."""
        async with self._origin_lock(origin):
            reader = self.rings_in.get(origin)
            if reader is not None:
                await self._drain_reader(origin, reader)
            for kind, ident, stream, n in entries:
                await self._egress_one(kind, ident, stream, owner=None,
                                       n_frames=n)
            self._emit(("relay_ack", origin, epoch))

    # -- ring drain ----------------------------------------------------------

    async def _egress_one(self, kind: int, ident: bytes, data, owner,
                          n_frames: int) -> None:
        broker = self.broker
        conns = broker.connections
        if kind == shardring.KIND_USER:
            conn = conns.get_user_connection(ident)
        else:
            conn = conns.get_broker_connection(ident.decode())
        if conn is None:
            # peer left since the origin planned: drop (parity)
            ledger_mod.record_fate("dropped", "no_route",
                                   flowclass.CLASS_NONE, n_frames)
            return
        (metrics_mod.EGRESS_FRAMES_USER if kind == shardring.KIND_USER
         else metrics_mod.EGRESS_FRAMES_BROKER).inc(n_frames)
        try:
            # class volume was counted at the ORIGIN shard's routing
            # decision (pair-level, before the handoff); nbytes=0 keeps
            # the sibling's writer from counting the stream twice
            await conn.send_encoded(data, owner, nbytes=0, count=n_frames)
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            if kind == shardring.KIND_USER:
                logger.info("shard egress to user %s failed (%r); removing",
                            mnemonic(ident), exc)
                conns.remove_user(ident, reason="send failed")
            else:
                logger.info("shard egress to broker %s failed (%r); "
                            "removing", ident.decode(), exc)
                conns.remove_broker(ident.decode(), reason="send failed")
            broker.update_metrics()

    async def _dispatch(self, rec: shardring.RingRecord) -> None:
        try:
            for kind, ident, idx in rec.peers:
                data = rec.stream_for(idx)
                owner = rec.lease() if isinstance(data, memoryview) \
                    else None
                await self._egress_one(kind, ident, data, owner,
                                       n_frames=len(idx))
        finally:
            rec.release()

    # consecutive no-progress retries on one uncommitted/corrupt record
    # before the ring is declared poisoned (a mid-write window is
    # microseconds; seconds of stall mean the producer died mid-push or
    # the slot is corrupt, and spinning would starve every other ring
    # and relay behind this origin's lock forever)
    _RING_POISON_RETRIES = 4000

    async def _drain_reader(self, src: int,
                            reader: shardring.RingReader) -> None:
        stalled = 0
        while True:
            recs = reader.drain(64)
            if not recs:
                if reader.backlog > 0:
                    # torn record mid-write: give the producer a beat
                    metrics_mod.SHARD_RING_TORN.inc()
                    stalled += 1
                    if stalled >= self._RING_POISON_RETRIES:
                        logger.error(
                            "ring %d->%d poisoned: record never committed "
                            "after %d retries; abandoning the ring (the "
                            "producer degrades to the counted relay path)",
                            src, self.shard_id, stalled)
                        metrics_mod.SHARD_RING_POISONED.inc()
                        # flag the header FIRST: the producer's next
                        # try_push fails over to the relay, so a stalled-
                        # then-resumed producer can't keep feeding (and
                        # counting path=ring deliveries into) a ring
                        # nobody will ever drain again
                        reader.poison()
                        if self.rings_in.pop(src, None) is not None:
                            self._poisoned_readers.append(reader)
                        return
                    await asyncio.sleep(0.0005)
                    continue
                return
            stalled = 0
            for rec in recs:
                await self._dispatch(rec)

    async def run_ring_drain(self) -> None:
        """The consumer task: woken by the notify socket, drains whole
        records from every inbound ring into the egress writers."""
        ev = self._notify_event
        rx = self.notify_rx
        while True:
            await ev.wait()
            ev.clear()
            if rx is not None:
                try:
                    while True:
                        if not rx.recv(4096):
                            break
                except (BlockingIOError, InterruptedError):
                    pass
            # list(): a poisoned ring may be dropped mid-iteration
            for src, reader in list(self.rings_in.items()):
                async with self._origin_lock(src):
                    await self._drain_reader(src, reader)

    def wake(self) -> None:
        """In-process producers (tests/benches on one loop) can nudge the
        consumer directly instead of through the notify socket."""
        self._notify_event.set()

    def stats(self) -> dict:
        return {
            "shard": self.shard_id,
            # the worker's OS pid: chaos drivers (scripts/local_cluster.py
            # --chaos) kill a specific shard worker through the merged
            # /debug/topology instead of guessing at child-process order
            "pid": os.getpid(),
            "num_shards": self.num_shards,
            "remote_users": len(self.broker.connections.remote_user_shard),
            "remote_brokers":
                len(self.broker.connections.remote_broker_shard),
            "deltas_applied": self.deltas_applied,
            "relay_fallbacks": self.relay_fallbacks,
            "relay_shed": self.relay_shed,
            "rings": shardring.stats_dict(self.rings_out, self.rings_in),
        }


# ---------------------------------------------------------------------------
# in-process harness (equivalence tests, benches)
# ---------------------------------------------------------------------------

def attach_inprocess_shards(brokers: list,
                            ring_bytes: int = 256 * 1024) -> list:
    """Wire already-constructed in-process brokers into a sharded group
    on ONE event loop: real shared-memory rings + notify sockets, a
    LocalBus for the control plane. Returns the runtimes; caller owns
    spawning ``run_ring_drain`` tasks and closing. The ring shm names are
    unlinked on close via the returned runtimes' ``_owned_rings``."""
    n = len(brokers)
    bus = LocalBus()
    names: Dict[Tuple[int, int], str] = {}
    for i in range(n):
        for j in range(n):
            if i != j:
                names[(i, j)] = shardring.create_ring(ring_bytes)
    notify = {i: shardring.notify_pair() for i in range(n)}
    runtimes = []
    for i, broker in enumerate(brokers):
        writers = {j: shardring.RingWriter(names[(i, j)], ring_bytes,
                                           notify_sock=notify[j][1])
                   for j in range(n) if j != i}
        readers = {j: shardring.RingReader(names[(j, i)], ring_bytes)
                   for j in range(n) if j != i}
        rt = ShardRuntime(broker, i, n, writers, readers, notify[i][0])
        rt.set_bus(bus)
        bus.register(rt)
        rt._owned_rings = list(names.values()) if i == 0 else []
        runtimes.append(rt)
    return runtimes


def detach_inprocess_shards(runtimes: list) -> None:
    for rt in runtimes:
        tx_socks = [w._notify for w in rt.rings_out.values()
                    if w._notify is not None]
        rt.close()
        if rt.notify_rx is not None:
            rt.notify_rx.close()
        for s in tx_socks:
            try:
                s.close()
            except OSError:
                pass
    for rt in runtimes:
        for name in getattr(rt, "_owned_rings", ()):
            shardring.unlink_ring(name)


# ---------------------------------------------------------------------------
# worker bootstrap from an IPC spec (inherited fds + shm names)
# ---------------------------------------------------------------------------

def runtime_from_spec(broker, spec: dict) -> ShardRuntime:
    shard = int(spec["shard"])
    num = int(spec["num_shards"])
    writers = {}
    for dst, (name, cap) in spec["rings_out"].items():
        tx_fd = spec["notify_tx"][str(dst)]
        tx = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM,
                           fileno=int(tx_fd))
        tx.setblocking(False)
        writers[int(dst)] = shardring.RingWriter(name, int(cap),
                                                 notify_sock=tx)
    readers = {int(src): shardring.RingReader(name, int(cap))
               for src, (name, cap) in spec["rings_in"].items()}
    rx = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM,
                       fileno=int(spec["notify_rx_fd"]))
    rx.setblocking(False)
    runtime = ShardRuntime(broker, shard, num, writers, readers, rx)
    control = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM,
                            fileno=int(spec["control_fd"]))
    runtime.set_bus(SocketBus(runtime, control))
    return runtime


# ---------------------------------------------------------------------------
# SO_REUSEPORT fallback: parent accepts, workers adopt fds (SCM_RIGHTS)
# ---------------------------------------------------------------------------

def reuseport_available() -> bool:
    return hasattr(socket, "SO_REUSEPORT") and \
        os.environ.get("PUSHCDN_SHARD_ACCEPT", "").strip() != "handoff"


class FdHandoffListener:
    """Worker-side ``Listener``: accepted sockets arrive as SCM_RIGHTS fds
    over a unix socketpair from the parent's acceptor."""

    def __init__(self, handoff_sock: socket.socket):
        self._sock = handoff_sock
        self._sock.setblocking(False)
        self._accept_q: asyncio.Queue = asyncio.Queue()
        self._closed = False
        loop = asyncio.get_running_loop()
        loop.add_reader(self._sock.fileno(), self._on_readable)

    def _on_readable(self) -> None:
        try:
            while True:
                msg, fds, _flags, _addr = socket.recv_fds(self._sock, 16, 8)
                if not msg and not fds:
                    break
                for fd in fds:
                    self._accept_q.put_nowait(fd)
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._accept_q.put_nowait(None)

    async def accept(self):
        from pushcdn_tpu_torch.proto.error import ErrorKind, bail
        from pushcdn_tpu_torch.proto.transport.tcp import _TcpUnfinalized
        while True:
            fd = await self._accept_q.get()
            if fd is None or self._closed:
                bail(ErrorKind.CONNECTION, "listener closed")
            sock = socket.socket(fileno=fd)
            sock.setblocking(False)
            try:
                reader, writer = await asyncio.open_connection(sock=sock)
            except OSError:
                sock.close()
                continue
            return _TcpUnfinalized(reader, writer)

    async def close(self) -> None:
        self._closed = True
        try:
            asyncio.get_event_loop().remove_reader(self._sock.fileno())
        except Exception:
            pass
        self._sock.close()
        self._accept_q.put_nowait(None)


class FdHandoffAcceptor:
    """Parent-side acceptor (only when SO_REUSEPORT is unavailable):
    binds the public endpoint once and deals accepted fds round-robin."""

    def __init__(self, endpoint: str, worker_socks: List[socket.socket]):
        from pushcdn_tpu_torch.proto.error import parse_endpoint
        host, port = parse_endpoint(endpoint)
        self._listen = socket.create_server((host, port), backlog=512,
                                            reuse_port=False)
        self._listen.setblocking(False)
        self._workers = worker_socks
        for s in worker_socks:
            # a full handoff buffer must RAISE so the round-robin can try
            # the next worker — a blocking send_fds would freeze the whole
            # parent loop behind one wedged worker
            s.setblocking(False)
        self._next = 0
        self.handoff_retries = 0
        self.handoff_drops = 0
        loop = asyncio.get_running_loop()
        loop.add_reader(self._listen.fileno(), self._on_accept)

    def _on_accept(self) -> None:
        try:
            while True:
                sock, _addr = self._listen.accept()
                try:
                    delivered = False
                    for _ in range(len(self._workers)):
                        target = self._workers[self._next
                                               % len(self._workers)]
                        self._next += 1
                        try:
                            socket.send_fds(target, [b"\x01"],
                                            [sock.fileno()])
                            delivered = True
                            break
                        except OSError:
                            # this worker's handoff buffer is full
                            # (accept burst) or its pair died: try the
                            # next worker in the rotation
                            self.handoff_retries += 1
                    if not delivered:
                        self.handoff_drops += 1
                        logger.warning(
                            "fd handoff: no worker took the accepted "
                            "connection; dropping it (%d dropped total)",
                            self.handoff_drops)
                finally:
                    sock.close()  # worker owns its dup'd fd now
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            pass

    def close(self) -> None:
        try:
            asyncio.get_event_loop().remove_reader(self._listen.fileno())
        except Exception:
            pass
        self._listen.close()


# ---------------------------------------------------------------------------
# parent supervisor
# ---------------------------------------------------------------------------

class _WorkerHandle:
    def __init__(self, shard: int, spec: dict, parent_control: socket.socket,
                 parent_fds: List[int], child_fds: List[int]):
        self.shard = shard
        self.spec = spec
        self.parent_control = parent_control
        self.parent_fds = parent_fds  # fds the parent keeps
        self.child_fds = child_fds    # fds passed to (and owned by) child
        self.proc = None
        self.metrics_port: Optional[int] = None


def build_worker_ipc(num_shards: int,
                     ring_bytes: int = DEFAULT_RING_BYTES
                     ) -> Tuple[List[_WorkerHandle], List[str]]:
    """Create rings + notify + control plumbing for ``num_shards``
    workers. Returns (handles, ring_names) — the parent unlinks the ring
    shm at teardown. Partial failure (fd exhaustion at high shard
    counts, shm creation errors) cleans up everything already created —
    leaked /dev/shm segments outlive the process."""
    names: Dict[Tuple[int, int], str] = {}
    notify: Dict[int, Tuple[socket.socket, socket.socket]] = {}
    handles: List[_WorkerHandle] = []
    try:
        return _build_worker_ipc(num_shards, ring_bytes, names, notify,
                                 handles)
    except BaseException:
        for nm in names.values():
            shardring.unlink_ring(nm)
        for rx, tx in notify.values():
            for s in (rx, tx):
                try:
                    s.close()
                except OSError:
                    pass
        for h in handles:
            for s in (h.parent_control, getattr(h, "_child_ctl", None)):
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
        raise


def _build_worker_ipc(num_shards: int, ring_bytes: int,
                      names: Dict[Tuple[int, int], str],
                      notify: Dict[int, Tuple[socket.socket,
                                              socket.socket]],
                      handles: List[_WorkerHandle]
                      ) -> Tuple[List[_WorkerHandle], List[str]]:
    for i in range(num_shards):
        for j in range(num_shards):
            if i != j:
                names[(i, j)] = shardring.create_ring(ring_bytes)
    for i in range(num_shards):
        notify[i] = shardring.notify_pair()
    for i in range(num_shards):
        parent_ctl, child_ctl = socket.socketpair(socket.AF_UNIX,
                                                  socket.SOCK_STREAM)
        # the child end must survive until create_subprocess_exec dups it
        child_fds = [child_ctl.fileno(), notify[i][0].fileno()]
        notify_tx = {}
        for j in range(num_shards):
            if j != i:
                notify_tx[str(j)] = notify[j][1].fileno()
                child_fds.append(notify[j][1].fileno())
        spec = {
            "shard": i,
            "num_shards": num_shards,
            "control_fd": child_ctl.fileno(),
            "notify_rx_fd": notify[i][0].fileno(),
            "notify_tx": notify_tx,
            "rings_out": {str(j): [names[(i, j)], ring_bytes]
                          for j in range(num_shards) if j != i},
            "rings_in": {str(j): [names[(j, i)], ring_bytes]
                         for j in range(num_shards) if j != i},
        }
        handle = _WorkerHandle(i, spec, parent_ctl,
                               parent_fds=[parent_ctl.fileno()],
                               child_fds=sorted(set(child_fds)))
        handle._child_ctl = child_ctl
        handles.append(handle)
    # keep python socket objects alive on the handles (prevent GC close)
    # until the children have inherited them; close_child_ends() after
    for i, h in enumerate(handles):
        h._keep = (notify[i][0], [notify[j][1] for j in range(num_shards)
                                  if j != i])
    return handles, list(names.values())


def close_child_ends(handles: List["_WorkerHandle"]) -> None:
    """After every worker spawned: the parent drops its copies of the
    child-side fds (workers own the inherited dups)."""
    for h in handles:
        for sock in (getattr(h, "_child_ctl", None),
                     getattr(h, "_accept_child", None)):
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        keep = getattr(h, "_keep", None)
        if keep is not None:
            rx, txs = keep
            try:
                rx.close()
            except OSError:
                pass
            for t in txs:
                try:
                    t.close()
                except OSError:
                    pass
        h._keep = None


async def _http_get(host: str, port: int, path: str,
                    timeout: float = 2.0) -> Tuple[int, bytes]:
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), timeout)
    try:
        writer.write(f"GET {path} HTTP/1.0\r\nHost: {host}\r\n\r\n"
                     .encode())
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(-1), timeout)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass
    head, _, body = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1]) if b" " in head else 502
    return status, body


def _inject_shard_label(text: str, shard: int) -> str:
    """Rewrite a worker's Prometheus exposition, adding shard="i" to every
    sample line (HELP/TYPE pass through; the aggregator dedupes those)."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        brace = line.find("{")
        space = line.find(" ")
        if brace != -1 and (space == -1 or brace < space):
            # label values may legally contain spaces (and escaped
            # quotes), so the sample-name boundary is the LAST '}' —
            # never the first space
            close = line.rfind("}")
            if close <= brace:
                out.append(line)  # malformed: pass through untouched
                continue
            fam = line[:brace]
            labels = line[brace + 1:close]
            rest = line[close + 1:].lstrip()
            sep = "," if labels else ""
            out.append(f'{fam}{{shard="{shard}"{sep}{labels}}} {rest}')
        else:
            name, _, rest = line.partition(" ")
            out.append(f'{name}{{shard="{shard}"}} {rest}')
    return "\n".join(out)


class ShardSupervisor:
    """The parent process: spawns/reaps workers, relays control deltas,
    serves the aggregated observability endpoint."""

    def __init__(self, num_shards: int, metrics_endpoint: Optional[str],
                 worker_argv, ring_bytes: int = DEFAULT_RING_BYTES,
                 acceptor_endpoint: Optional[str] = None):
        """``worker_argv(shard, spec_json, metrics_endpoint)`` builds one
        worker's command line. ``acceptor_endpoint`` non-None switches to
        the fd-handoff accept path (platforms without SO_REUSEPORT)."""
        self.num_shards = num_shards
        self.metrics_endpoint = metrics_endpoint
        self.worker_argv = worker_argv
        self.ring_bytes = ring_bytes
        self.acceptor_endpoint = acceptor_endpoint
        self.handles: List[_WorkerHandle] = []
        self.ring_names: List[str] = []
        # initialized here (not in start()) so stop() is safe to call on
        # a supervisor whose start() failed partway
        self._hub_writers: Dict[int, asyncio.StreamWriter] = {}
        self._hub_tasks: List[asyncio.Task] = []
        self._server = None
        self._acceptor = None
        self._version = 0
        self._draining = False
        self.hub_disconnects = 0
        # the disconnect bound must exceed the aggregate LEGAL relay
        # volume toward one destination — (num_shards-1) producers, each
        # allowed _RELAY_MAX_BYTES unacked — or a slow-but-still-draining
        # worker at high shard counts would be killed by design-legal
        # traffic; HUB_MAX_BUFFER is the headroom for the unbudgeted
        # broadcast deltas on top of that
        self._hub_buffer_cap = HUB_MAX_BUFFER + \
            max(0, num_shards - 1) * ShardRuntime._RELAY_MAX_BYTES

    # -- control hub ---------------------------------------------------------

    def _hub_send(self, writers: Dict[int, asyncio.StreamWriter],
                  dst: int, frame: bytes) -> None:
        """Forward one control frame with a bounded write buffer. The hub
        never awaits drain (one slow worker must not stall the whole
        control plane), so the bound is enforced by disconnect: a worker
        whose buffered control traffic exceeds the cap has stopped
        draining its socket — cut the link so it fails fast (its
        SocketBus reader exits the worker) and the reaper notices."""
        w = writers.get(dst)
        if w is None:
            return
        transport = w.transport
        if transport is not None and \
                transport.get_write_buffer_size() + len(frame) \
                > self._hub_buffer_cap:
            self.hub_disconnects += 1
            logger.error(
                "control hub buffer to shard %d exceeded %d B; dropping "
                "the link so the wedged worker fails fast",
                dst, self._hub_buffer_cap)
            writers.pop(dst, None)
            try:
                # abort, not close(): close() flushes buffered data
                # first, i.e. waits for the very drain that will never
                # happen — the peer must see the connection DIE now
                transport.abort()
            except Exception:
                pass
            return
        w.write(frame)

    async def _hub_loop(self, handle: _WorkerHandle,
                        writers: Dict[int, asyncio.StreamWriter]) -> None:
        handle.parent_control.setblocking(False)
        reader, writer = await asyncio.open_connection(
            sock=handle.parent_control)
        writers[handle.shard] = writer
        try:
            while True:
                hdr = await reader.readexactly(4)
                (n,) = _FRAME_LEN.unpack(hdr)
                blob = await reader.readexactly(n)
                event = pickle.loads(blob)
                self._version += 1
                out = pickle.dumps((handle.shard, event),
                                   protocol=pickle.HIGHEST_PROTOCOL)
                frame = _FRAME_LEN.pack(len(out)) + out
                if event[0] in ("relay", "relay_ack"):
                    self._hub_send(writers, int(event[1]), frame)
                    continue
                for shard in list(writers):
                    if shard != handle.shard:
                        self._hub_send(writers, shard, frame)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass  # worker exited; the reaper notices

    # -- aggregated observability -------------------------------------------

    async def _fetch_all(self, path: str) -> Dict[int, Tuple[int, bytes]]:
        async def one(h):
            try:
                return await _http_get("127.0.0.1", h.metrics_port, path)
            except Exception as exc:
                return 503, json.dumps(
                    {"status": "unhealthy",
                     "checks": {"reachable": {
                         "ok": False, "detail": f"worker shard "
                         f"{h.shard} unreachable: {exc!r}"}},
                     "draining": False, "ts": time.time()}).encode()
        results = await asyncio.gather(*(one(h) for h in self.handles))
        return {h.shard: r for h, r in zip(self.handles, results)}

    async def _render(self, path: str) -> Tuple[int, str, str]:
        """(status, content_type, body) for the parent endpoint."""
        if path.startswith("/metrics"):
            parts = []
            seen_meta = set()
            for shard, (status, body) in (await self._fetch_all(
                    "/metrics")).items():
                if status != 200:
                    parts.append(f"# shard {shard} unreachable\n")
                    continue
                labeled = _inject_shard_label(body.decode(errors="replace"),
                                              shard)
                lines = []
                for line in labeled.splitlines():
                    if line.startswith("#"):
                        if line in seen_meta:
                            continue
                        seen_meta.add(line)
                    lines.append(line)
                parts.append("\n".join(lines) + "\n")
            parts.append(f"# HELP cdn_shard_workers worker shard count\n"
                         f"# TYPE cdn_shard_workers gauge\n"
                         f"cdn_shard_workers {len(self.handles)}\n")
            parts.append(
                f"# HELP cdn_shard_hub_disconnects workers dropped for "
                f"control-hub write-buffer overflow\n"
                f"# TYPE cdn_shard_hub_disconnects counter\n"
                f"cdn_shard_hub_disconnects {self.hub_disconnects}\n")
            if self._acceptor is not None:
                parts.append(
                    f"# HELP cdn_shard_accept_drops accepted connections "
                    f"dropped because no worker took the fd handoff\n"
                    f"# TYPE cdn_shard_accept_drops counter\n"
                    f"cdn_shard_accept_drops "
                    f"{self._acceptor.handoff_drops}\n"
                    f"# HELP cdn_shard_accept_retries fd handoffs retried "
                    f"on another worker\n"
                    f"# TYPE cdn_shard_accept_retries counter\n"
                    f"cdn_shard_accept_retries "
                    f"{self._acceptor.handoff_retries}\n")
            return 200, "text/plain; version=0.0.4; charset=utf-8", \
                "".join(parts)
        if path.startswith("/healthz") or path.startswith("/readyz"):
            which = "/healthz" if path.startswith("/healthz") else "/readyz"
            per = await self._fetch_all(which)
            checks = {}
            ok = True
            for shard, (status, body) in sorted(per.items()):
                try:
                    doc = json.loads(body)
                    for name, c in doc.get("checks", {}).items():
                        checks[f"shard{shard}:{name}"] = c
                except ValueError:
                    checks[f"shard{shard}:parse"] = {
                        "ok": False, "detail": "unparseable worker body"}
                if status != 200:
                    ok = False
            alive = all(h.proc is not None and h.proc.returncode is None
                        for h in self.handles)
            checks["workers"] = {
                "ok": alive,
                "detail": f"{sum(1 for h in self.handles if h.proc and h.proc.returncode is None)}"
                          f"/{len(self.handles)} workers alive"}
            ok = ok and alive
            if which == "/readyz" and self._draining:
                checks["draining"] = {"ok": False, "detail": "drain latch"}
                ok = False
            body = json.dumps({
                "status": "ok" if ok else "unhealthy",
                "checks": checks,
                "draining": self._draining,
                "shards": self.num_shards,
                "ts": time.time(),
            }, separators=(",", ":")) + "\n"
            return (200 if ok else 503), "application/json", body
        if path.startswith("/debug/topology"):
            per = await self._fetch_all("/debug/topology")
            shards = {}
            for shard, (status, body) in sorted(per.items()):
                try:
                    shards[shard] = json.loads(body) if status == 200 \
                        else None
                except ValueError:
                    shards[shard] = None
            base = shards.get(0) or {}
            merged = dict(base)
            merged["num_users"] = sum(
                (t or {}).get("num_users", 0) for t in shards.values())
            users = []
            for shard, t in sorted(shards.items()):
                for u in (t or {}).get("users", []):
                    users.append({**u, "shard": shard})
            merged["users"] = users
            merged["shards"] = {
                str(s): ((t or {}).get("shard_runtime")
                         or {"unreachable": t is None})
                for s, t in sorted(shards.items())}
            merged["draining"] = self._draining or any(
                (t or {}).get("draining") for t in shards.values())
            return 200, "application/json", \
                json.dumps(merged, separators=(",", ":")) + "\n"
        return 404, "text/plain", "not found\n"

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            line = await asyncio.wait_for(reader.readline(), 5.0)
            parts = line.decode(errors="replace").split()
            if len(parts) < 2 or parts[0] != "GET":
                status, ctype, body = 405, "text/plain", "GET only\n"
            else:
                while True:  # drain headers
                    h = await asyncio.wait_for(reader.readline(), 5.0)
                    if h in (b"\r\n", b"\n", b""):
                        break
                status, ctype, body = await self._render(parts[1])
            payload = body.encode()
            writer.write(
                f"HTTP/1.0 {status} X\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n\r\n".encode()
                + payload)
            await writer.drain()
        except Exception:
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        from pushcdn_tpu_torch.proto.error import parse_endpoint
        self.handles, self.ring_names = build_worker_ipc(
            self.num_shards, self.ring_bytes)
        if self.acceptor_endpoint:
            # fd-handoff path: one extra socketpair per worker
            for h in self.handles:
                parent_sock, child_sock = socket.socketpair(
                    socket.AF_UNIX, socket.SOCK_STREAM)
                h.spec["accept_fd"] = child_sock.fileno()
                h.child_fds.append(child_sock.fileno())
                h._accept_parent = parent_sock
                h._accept_child = child_sock
            self._acceptor = FdHandoffAcceptor(
                self.acceptor_endpoint,
                [h._accept_parent for h in self.handles])
        mhost, mport = (None, None)
        if self.metrics_endpoint:
            mhost, mport = parse_endpoint(self.metrics_endpoint)
        for h in self.handles:
            worker_metrics = None
            if mport is not None:
                h.metrics_port = mport + 1 + h.shard
                worker_metrics = f"{mhost}:{h.metrics_port}"
            argv = self.worker_argv(h.shard, json.dumps(h.spec),
                                    worker_metrics)
            h.proc = await asyncio.create_subprocess_exec(
                *argv, pass_fds=tuple(h.child_fds),
                stdout=None, stderr=None)
            logger.info("shard worker %d up (pid %d)", h.shard, h.proc.pid)
        close_child_ends(self.handles)
        if self.metrics_endpoint:
            self._server = await asyncio.start_server(
                self._serve, mhost, mport)
        self._hub_tasks = [
            asyncio.create_task(self._hub_loop(h, self._hub_writers),
                                name=f"shard-hub-{h.shard}")
            for h in self.handles]

    def signal_workers(self, sig=signal_mod.SIGTERM) -> None:
        for h in self.handles:
            if h.proc is not None and h.proc.returncode is None:
                try:
                    h.proc.send_signal(sig)
                except ProcessLookupError:
                    pass

    def begin_drain(self) -> None:
        """Readiness flips false on the parent AND every shard first; the
        workers then serve out PUSHCDN_DRAIN_GRACE_S before their
        listeners close; the parent reaps them before its own endpoint
        goes away (bin/common.install_drain_signals drives this)."""
        self._draining = True
        health_mod.set_draining("shard supervisor drain")
        self.signal_workers(signal_mod.SIGTERM)

    async def wait_any_worker_exit(self) -> int:
        waits = [asyncio.create_task(h.proc.wait()) for h in self.handles]
        done, pending = await asyncio.wait(
            waits, return_when=asyncio.FIRST_COMPLETED)
        for p in pending:
            p.cancel()
        return done.pop().result()

    async def reap(self, timeout: float) -> None:
        try:
            await asyncio.wait_for(
                asyncio.gather(*(h.proc.wait() for h in self.handles
                                 if h.proc is not None)), timeout)
        except asyncio.TimeoutError:
            self.signal_workers(signal_mod.SIGKILL)
            await asyncio.gather(*(h.proc.wait() for h in self.handles
                                   if h.proc is not None),
                                 return_exceptions=True)

    async def stop(self) -> None:
        for t in self._hub_tasks:
            t.cancel()
        if self._hub_tasks:
            await asyncio.gather(*self._hub_tasks, return_exceptions=True)
        if self._acceptor is not None:
            self._acceptor.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for name in self.ring_names:
            shardring.unlink_ring(name)
