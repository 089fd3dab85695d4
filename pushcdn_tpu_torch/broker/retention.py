"""Durable topics: per-topic retention rings, replay subscribe, last-value
cache, and wildcard interest.

Without it the broker is fire-and-forget pub/sub: a consensus node that
rejoins mid-view gets silence until the next broadcast. This module closes
that gap end to end:

- **Retention rings** — a configured subset of topics (``PUSHCDN_RETAIN_*``)
  keeps the last N broadcasts per topic in a bounded ring (count / bytes /
  age). On the scalar ingress path a retained entry holds a zero-copy
  ``Bytes.clone()`` of the arriving frame — the same lease-recycled permit
  accounting the egress fan-out uses — so retention never copies and never
  fights the pool for new allocations. Every entry carries a per-topic
  **monotone sequence number** stamped at ingress (seqs start at 1; the wire
  itself is unchanged — only replayed ``Retained`` frames carry them).

- **Pool-deadlock immunity** — retention registers a *reclaimer* on the
  broker's :class:`~pushcdn_tpu_torch.proto.limiter.MemoryPool`: the moment an
  allocation would block, retained leases are materialized to owned heap
  bytes and their permits released, synchronously. Retention can therefore
  ALWAYS give back every permit it holds without blocking, so "block the
  reader, not the router" can never become "wedge the reader behind idle
  leases". The pooled share is additionally clamped to a quarter of pool
  capacity.

- **Replay subscribe + last-value cache** — ``SubscribeFrom{topic, seq}``
  registers the subscription and replays every retained frame with
  ``seq >= from_seq`` as ``Retained`` frames through the normal writer-queue
  path. ``seq == SEQ_LAST`` replays only the last-value-cache entry (one
  per topic, surviving ring eviction); ``seq == SEQ_LIVE`` subscribes
  without replay. The replay→live handover is **gap-free and dup-free** by
  construction: the subscription registration, the retained-ring snapshot,
  and the replay enqueue happen in ONE synchronous block on the broker's
  event loop, while every live route decision (interest query → egress
  append) and its matching retention stamp are likewise one synchronous
  block. So a broadcast either (a) routed before the SubscribeFrom — user
  not yet subscribed, frame retained, hence in the snapshot: replayed,
  exactly once; or (b) routed after — user subscribed (live delivery), and
  its seq exceeds everything in the snapshot: not replayed. Per-connection
  writer queues are FIFO, so the wire order is replay then live.
  (A SubscribeFrom from a user that is ALREADY subscribed may duplicate
  frames still in flight to it — the guarantee is scoped to the rejoin
  flow, where the subscription starts absent.)

- **Sharded brokers** — each durable topic's ring lives with its OWNER
  shard (``topic % num_shards``). A durable broadcast ingressing elsewhere
  is relayed to the owner verbatim (``durable_pub`` on the shard bus), and
  the owner makes the interest snapshot AND the retention stamp in one
  synchronous block, then routes through a single FIFO drainer task — so
  the per-user order of replay vs. live is pinned by the drainer queue. A
  ``SubscribeFrom`` at the user's shard relays ``durable_sub`` to the owner
  *before* the local subscribe delta, and the owner adds the interest row
  itself (additive — see ``Connections.add_remote_user_interest``) before
  snapshotting. Sequence numbers are broker-local (a rejoin to a DIFFERENT
  broker should use ``seq=0`` or ``SEQ_LAST``); durable frames whose topic
  sets span multiple owner shards are retained at every owner but fanned
  out only by the lowest topic's owner.

- **Wildcard interest** — hierarchical names (``consensus.view.3``) bind
  onto wire topics via :class:`~pushcdn_tpu_torch.proto.topic.TopicNamespace`;
  a pattern (``consensus.view.*``) riding ``SubscribeFrom.pattern``
  compiles to the covered topic set and subscribes through the plain
  ``Connections.subscribe_user_to`` path, so the interest bitmask, the
  native route-plan table, the RaggedInterest page index, and the sharded
  deltas all see ordinary per-topic updates — wildcard plan output is
  bit-identical to the equivalent explicit subscription. A *watch* keeps
  the union live: later ``bind``/``unbind`` calls incrementally subscribe/
  unsubscribe the pattern's users (same shape as RaggedInterest page
  maintenance).

Environment knobs::

    PUSHCDN_RETAIN_TOPICS   comma list / ranges of retained topics ("0,3,8-11")
    PUSHCDN_RETAIN_COUNT    per-topic ring entry bound        (default 1024)
    PUSHCDN_RETAIN_BYTES    per-topic ring byte bound         (default 4 MiB)
    PUSHCDN_RETAIN_AGE_S    per-entry age bound, 0 = none     (default 0)
    PUSHCDN_TOPIC_NAMES     namespace seed: "name=topic,name=topic"

The port's copy of ``pushcdn_tpu.broker.retention``. On a broker with
a device plane the stamps run on the event loop before a frame is
staged, so the rings hold exactly what the plane routes; nothing of
this module runs on the card.
"""

from __future__ import annotations

import asyncio
import logging
import os
import struct
import time
import weakref
from collections import deque
from typing import TYPE_CHECKING, Iterable, List, Optional

from pushcdn_tpu_torch.proto import flowclass
from pushcdn_tpu_torch.proto import ledger as ledger_mod
from pushcdn_tpu_torch.proto import metrics as metrics_mod
from pushcdn_tpu_torch.proto import trace as trace_mod
from pushcdn_tpu_torch.proto.error import Error
from pushcdn_tpu_torch.proto.limiter import Bytes
from pushcdn_tpu_torch.proto.message import (
    KIND_BROADCAST,
    KIND_RETAINED,
    SEQ_LAST,
    SEQ_LIVE,
    deserialize,
    deserialize_owned,
)
from pushcdn_tpu_torch.proto.topic import TopicNamespace
from pushcdn_tpu_torch.proto.util import mnemonic

if TYPE_CHECKING:
    from pushcdn_tpu_torch.broker.broker import Broker

logger = logging.getLogger("pushcdn.broker")

_LEN = struct.Struct(">I")
_U64 = struct.Struct("<Q")

# -- retention observability ----------------------------------------------
# Live stores refresh their ring/replay gauges from a /metrics pre-render
# hook (retain/evict hot paths only bump plain counters); eviction-reason
# children are cached so the evict loop pays one inc, no label lookup.
_LIVE_STORES: "weakref.WeakSet[DurableTopics]" = weakref.WeakSet()
_EVICT_REASON = {r: metrics_mod.RETENTION_EVICTIONS.labels(reason=r)
                 for r in ("bytes", "entries", "age")}
_REPLAY_LAG_TOP_K = 8
_replay_lag_live: set = set()


def _refresh_retention_metrics() -> None:
    rings: dict = {}
    ring_bytes: dict = {}
    lags: list = []
    for store in list(_LIVE_STORES):
        for t, ring in store._rings.items():
            key = str(t)
            rings[key] = rings.get(key, 0) + len(ring.entries)
            ring_bytes[key] = ring_bytes.get(key, 0) + ring.nbytes
        lags.extend(store._replay_lags())
    for key, n in rings.items():
        metrics_mod.RETENTION_RING_ENTRIES.labels(topic=key).set(n)
        metrics_mod.RETENTION_RING_BYTES.labels(topic=key).set(
            ring_bytes[key])
    lags.sort(key=lambda kv: (-kv[1], kv[0]))
    shown, other = set(), 0
    for name, lag in lags:
        if len(shown) < _REPLAY_LAG_TOP_K:
            metrics_mod.REPLAY_LAG.labels(subscriber=name).set(lag)
            shown.add(name)
        else:
            other += lag
    metrics_mod.REPLAY_LAG.labels(subscriber="other").set(other)
    for name in _replay_lag_live - shown:
        metrics_mod.REPLAY_LAG.labels(subscriber=name).set(0)
    _replay_lag_live.clear()
    _replay_lag_live.update(shown)


metrics_mod.PRE_RENDER_HOOKS.append(_refresh_retention_metrics)


def _parse_topic_set(spec: str) -> frozenset:
    """``"0,3,8-11"`` → {0, 3, 8, 9, 10, 11}."""
    out = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            out.update(range(int(lo), int(hi) + 1))
        else:
            out.add(int(part))
    return frozenset(out)


class _Entry:
    """One retained broadcast: the payload plus (optionally) a ``Bytes``
    clone of the arriving frame whose pool permit it keeps alive. While
    ``owner`` is held the payload may be a zero-copy view into the owner's
    buffer; :meth:`materialize` converts to owned heap bytes and releases
    the permit — synchronously, so the pool reclaimer can always drain."""

    __slots__ = ("seq", "payload", "owner", "nbytes", "t")

    def __init__(self, seq: int, payload, owner: Optional[Bytes],
                 nbytes: int, t: float):
        self.seq = seq
        self.payload = payload
        self.owner = owner
        self.nbytes = nbytes
        self.t = t

    def materialize(self) -> int:
        """Copy the payload out of the leased buffer and release the pool
        permit; returns the pooled byte count given back (0 if already
        owned)."""
        owner, self.owner = self.owner, None
        if owner is None:
            return 0
        self.payload = bytes(self.payload)
        owner.release()
        return self.nbytes

    def drop(self) -> int:
        """Release the lease without keeping the payload (ring eviction of
        a non-LVC entry); returns the pooled bytes given back."""
        owner, self.owner = self.owner, None
        if owner is None:
            return 0
        owner.release()
        return self.nbytes


class _Ring:
    __slots__ = ("topic", "entries", "next_seq", "nbytes", "last",
                 "last_detached")

    def __init__(self, topic: int):
        self.topic = topic
        self.entries: deque = deque()
        self.next_seq = 1          # seqs count up from 1 (0 = "everything")
        self.nbytes = 0
        self.last: Optional[_Entry] = None  # LVC slot, survives eviction
        self.last_detached = False  # True once `last` was ring-evicted


class DurableTopics:
    """Per-broker durable-topic subsystem (see module docstring). One
    instance per broker process; always constructed (wildcard subscribe
    works without retention), ``enabled`` iff any topic is retained."""

    def __init__(self, broker: "Broker",
                 topics: Iterable[int] = (),
                 max_count: int = 1024,
                 max_bytes: int = 4 * 1024 * 1024,
                 max_age_s: float = 0.0):
        self.broker = broker
        self.topics = frozenset(int(t) for t in topics)
        self.max_count = max(1, int(max_count))
        self.max_bytes = max(1, int(max_bytes))
        self.max_age_s = float(max_age_s)
        space = broker.run_def.topics if broker.run_def is not None else None
        self.namespace = TopicNamespace(space)
        self._rings = {t: _Ring(t) for t in self.topics}
        # pooled-lease accounting: entries still holding a Bytes clone, in
        # retain order (reclaim materializes oldest-first)
        self._pooled: deque = deque()
        self._pooled_bytes = 0
        limiter = getattr(broker, "limiter", None)
        self._pool = limiter.pool if limiter is not None else None
        # retention may pin at most a quarter of the pool with idle leases
        self._pool_budget = (self._pool.capacity // 4
                             if self._pool is not None else 0)
        self._reclaimer_installed = False
        if self._pool is not None and self.topics:
            self._pool.add_reclaimer(self._reclaim)
            self._reclaimer_installed = True
        # wildcard watches: user key -> {pattern -> namespace watch handle}
        self._watches: dict = {}
        # sharded ordered fan-out (owner side): one FIFO drainer pins the
        # per-user order of replay vs. live batches
        self._fanout_q: Optional[asyncio.Queue] = None
        self._drain_task: Optional[asyncio.Task] = None
        # counters (surfaced via /debug/topology)
        self.retained_frames = 0
        self.replayed_frames = 0
        self.evicted_entries = 0
        self.evictions_by_reason: dict = {}
        self.materialized_entries = 0
        self.pool_reclaims = 0
        self.relayed_pubs = 0
        # replay-lag tracking: subscriber mnemonic -> [weakref(conn)|None,
        # entries handed over at its most recent replay]. The pre-render
        # hook publishes these top-K and retires entries whose writer
        # queue drained (replay reached the kernel = caught up).
        self._replay_track: dict = {}
        _LIVE_STORES.add(self)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_env(cls, broker: "Broker") -> "DurableTopics":
        topics = _parse_topic_set(os.environ.get("PUSHCDN_RETAIN_TOPICS", ""))
        d = cls(
            broker, topics,
            max_count=int(os.environ.get("PUSHCDN_RETAIN_COUNT", "1024")),
            max_bytes=int(os.environ.get("PUSHCDN_RETAIN_BYTES",
                                         str(4 * 1024 * 1024))),
            max_age_s=float(os.environ.get("PUSHCDN_RETAIN_AGE_S", "0")))
        names = os.environ.get("PUSHCDN_TOPIC_NAMES", "")
        for pair in names.split(","):
            pair = pair.strip()
            if not pair or "=" not in pair:
                continue
            name, topic = pair.rsplit("=", 1)
            try:
                d.namespace.bind(name.strip(), int(topic))
            except ValueError as exc:
                logger.warning("PUSHCDN_TOPIC_NAMES entry %r ignored: %s",
                               pair, exc)
        # the bound names imply the flow-class taxonomy ("consensus.*",
        # "bulk.*", ...): publish the compiled topic -> class table for
        # the scalar senders; the cut-through plane mirrors it into the
        # native planner on its next (re)build
        flowclass.install_table(flowclass.compile_table(d.namespace))
        return d

    @property
    def enabled(self) -> bool:
        return bool(self.topics)

    def owner_shard(self, topic: int) -> int:
        return topic % max(1, self.broker.connections.num_shards)

    def close(self) -> None:
        if self._reclaimer_installed and self._pool is not None:
            self._pool.remove_reclaimer(self._reclaim)
            self._reclaimer_installed = False
        if self._drain_task is not None:
            self._drain_task.cancel()
            self._drain_task = None
        for handles in self._watches.values():
            for h in handles.values():
                self.namespace.unwatch(h)
        self._watches.clear()
        for ring in self._rings.values():
            while ring.entries:
                self._evict_one(ring)
            if ring.last is not None:
                ring.last.drop()
                ring.last = None
        self._pooled.clear()
        self._pooled_bytes = 0

    def stats(self) -> dict:
        return {
            "topics": sorted(self.topics),
            "bindings": len(self.namespace.bindings()),
            "retained_frames": self.retained_frames,
            "replayed_frames": self.replayed_frames,
            "evicted_entries": self.evicted_entries,
            "materialized_entries": self.materialized_entries,
            "pool_reclaims": self.pool_reclaims,
            "relayed_pubs": self.relayed_pubs,
            "pooled_bytes": self._pooled_bytes,
            "ring_entries": {t: len(r.entries)
                             for t, r in self._rings.items()},
            "ring_bytes": {t: r.nbytes for t, r in self._rings.items()},
            "next_seq": {t: r.next_seq for t, r in self._rings.items()},
            "evictions_by_reason": dict(self.evictions_by_reason),
            "replay_lag": dict(self._replay_lags()),
        }

    # -- retention rings -----------------------------------------------------

    def _evict_one(self, ring: _Ring, reason: Optional[str] = None) -> None:
        e = ring.entries.popleft()
        ring.nbytes -= e.nbytes
        self.evicted_entries += 1
        if reason is not None:  # None = teardown drain, not an eviction
            self.evictions_by_reason[reason] = \
                self.evictions_by_reason.get(reason, 0) + 1
            _EVICT_REASON[reason].inc()
            # the retained COPY's terminal fate (the original
            # frame's delivery fate was counted on its own path)
            ledger_mod.record_fate("dropped", "retention_evict",
                                   flowclass.BULK)
        if ring.last is e:
            # the LVC slot outlives the ring — but must not pin a pool
            # permit indefinitely: one bounded copy per topic
            self._pooled_bytes -= e.materialize()
            ring.last_detached = True
        else:
            self._pooled_bytes -= e.drop()

    def _age_evict(self, ring: _Ring, now: float) -> None:
        if self.max_age_s > 0:
            horizon = now - self.max_age_s
            while ring.entries and ring.entries[0].t < horizon:
                self._evict_one(ring, "age")

    def _retain(self, dtopics: List[int], payload,
                raw: Optional[Bytes]) -> None:
        """Stamp + store one broadcast under each durable topic it names.
        ``raw`` (the arriving frame's ``Bytes``) makes the entry a
        zero-copy lease; ``None`` stores owned bytes (chunk path, relayed
        frames)."""
        now = time.monotonic()
        nbytes = len(payload)
        for t in dtopics:
            ring = self._rings[t]
            seq = ring.next_seq
            ring.next_seq = seq + 1
            owner = raw.clone() if raw is not None else None
            entry = _Entry(seq, payload, owner, nbytes, now)
            if owner is not None:
                self._pooled.append(entry)
                self._pooled_bytes += nbytes
            ring.entries.append(entry)
            ring.nbytes += nbytes
            if ring.last_detached and ring.last is not None:
                ring.last.drop()  # displaced LVC copy (already owned bytes)
            ring.last = entry
            ring.last_detached = False
            self.retained_frames += 1
            self._age_evict(ring, now)
            while (len(ring.entries) > self.max_count
                   or ring.nbytes > self.max_bytes):
                self._evict_one(ring,
                                "entries"
                                if len(ring.entries) > self.max_count
                                else "bytes")
        # pooled clamp: retention's idle leases may not crowd the pool
        while self._pooled_bytes > self._pool_budget and self._pooled:
            self._materialize_oldest()

    def _materialize_oldest(self) -> bool:
        while self._pooled:
            e = self._pooled.popleft()
            if e.owner is None:
                continue  # already evicted/materialized elsewhere
            self._pooled_bytes -= e.materialize()
            self.materialized_entries += 1
            return True
        return False

    def _reclaim(self, deficit: int) -> None:
        """MemoryPool pressure hook (runs synchronously on the event loop
        while a reader is about to block): release every permit retention
        holds, oldest first, until the pool can satisfy the waiter. Pure
        copies + releases — can never block, so retained leases can never
        deadlock permit reclamation."""
        if not self._pooled:
            return
        self.pool_reclaims += 1
        pool = self._pool
        while self._pooled:
            if pool is not None and pool.available >= deficit >= 0:
                break
            if not self._materialize_oldest():
                break

    def snapshot(self, topic: int, from_seq: int) -> List[_Entry]:
        """The replay set for one topic at this instant. ``SEQ_LIVE`` →
        nothing; ``SEQ_LAST`` → the last-value-cache entry; otherwise every
        retained entry with ``seq >= from_seq``, oldest first."""
        ring = self._rings.get(topic)
        if ring is None or from_seq == SEQ_LIVE:
            return []
        self._age_evict(ring, time.monotonic())
        if from_seq == SEQ_LAST:
            return [ring.last] if ring.last is not None else []
        return [e for e in ring.entries if e.seq >= from_seq]

    @staticmethod
    def _prefixed_retained(topic: int, e: _Entry) -> bytes:
        """One ``Retained`` wire frame, u32-BE length-prefixed for the
        pre-encoded writer path."""
        frame = b"".join((bytes((KIND_RETAINED, topic)),
                          _U64.pack(e.seq), e.payload))
        return _LEN.pack(len(frame)) + frame

    # -- ingress (publish side) ----------------------------------------------

    def on_publish(self, pruned, message, raw: Bytes,
                   to_users_only: bool) -> bool:
        """Called at broadcast ingress (scalar loops + cut-through
        residuals) with the pruned topic list. Returns True when the
        caller should route the frame normally; False when the durable
        subsystem took over the fan-out (sharded mode: the owner shard
        stamps, retains, and routes through its ordered drainer — local
        routing must be skipped so frames are neither dropped nor
        duplicated)."""
        if not self.topics:
            return True
        dt = [t for t in pruned if t in self.topics]
        if not dt:
            return True
        conns = self.broker.connections
        if conns.num_shards <= 1:
            # unsharded: stamp + lease in the SAME synchronous block as the
            # caller's route decision — the handover invariant
            self._retain(dt, message.message, raw)
            return True
        # sharded: rings live with their owner shards. The lowest topic's
        # owner fans out; any other owner retains only (multi-owner durable
        # frames stay single-delivery).
        frame = bytes(raw.data)
        owners = {self.owner_shard(t) for t in dt}
        route_owner = self.owner_shard(min(dt))
        me = conns.shard_id
        for o in sorted(owners):
            if o == me:
                continue
            if o == route_owner:
                self._emit(("durable_pub", o, frame, to_users_only))
            else:
                self._emit(("durable_retain", o, frame))
            self.relayed_pubs += 1
        if me in owners:
            if me == route_owner:
                self._apply_durable_pub(frame, to_users_only)
            else:
                self._retain_owned_topics(frame)
        return False

    def retain_from_chunk(self, buf, offs, lens, pos: int,
                          consumed: int) -> None:
        """Cut-through seam (unsharded only — ``cutthrough.acquire`` routes
        sharded durable brokers scalar): after ``plan()`` returns and
        BEFORE the first egress await, stamp every consumed broadcast that
        names a durable topic. Payloads are copied out — a lease here
        would pin the whole pooled chunk for the ring's lifetime."""
        if not self.topics:
            return
        mv = memoryview(buf)
        space = self.broker.run_def.topics
        for i in range(pos, pos + consumed):
            o, ln = int(offs[i]), int(lens[i])
            if ln < 2 or (mv[o] & 0x7F) != KIND_BROADCAST:
                continue
            try:
                m = deserialize(mv[o:o + ln])
            except Error:
                continue  # plan stops on malformed frames; defensive
            pruned, _bad = space.prune(m.topics)
            dt = [t for t in pruned if t in self.topics]
            if dt:
                self._retain(dt, bytes(m.message), None)

    # -- subscribe side ------------------------------------------------------

    def handle_subscribe_from(self, public_key, msg, conn) -> bool:
        """Process one ``SubscribeFrom`` (user-origin, scalar loops + the
        cut-through residual twin). Registration, ring snapshot, and
        replay enqueue run in this one synchronous block — the handover
        invariant. Returns False when the sender must be disconnected
        (unknown explicit topic — ``Subscribe`` parity — or a replay
        enqueue failing against its own writer queue)."""
        conns = self.broker.connections
        space = self.broker.run_def.topics
        if msg.pattern:
            topics = [t for t in self.namespace.match(msg.pattern)
                      if t in space.valid]
            self._watch_pattern(public_key, msg.pattern)
        else:
            pruned, bad = space.prune([msg.topic])
            if bad:
                return False  # unknown topic ⇒ disconnect (Subscribe parity)
            topics = list(pruned)
        if not topics:
            return True  # nothing bound yet; a pattern watch keeps it live
        if conns.num_shards <= 1:
            conns.subscribe_user_to(public_key, topics)
            if msg.seq != SEQ_LIVE:
                for t in topics:
                    if t in self.topics:
                        if not self._replay_local(conn, public_key, t,
                                                  msg.seq):
                            return False
            return True
        # sharded: the owner adds the interest row itself (durable_sub
        # applies BEFORE the local subscribe's "user" delta — bus order),
        # snapshots, and replays through its ordered drainer
        me = conns.shard_id
        durable = ([t for t in topics if t in self.topics]
                   if msg.seq != SEQ_LIVE else [])
        for t in durable:
            if self.owner_shard(t) != me:
                self._emit(("durable_sub", t, msg.seq,
                            bytes(public_key), me))
        conns.subscribe_user_to(public_key, topics)
        for t in durable:
            if self.owner_shard(t) == me:
                self._apply_durable_sub(t, msg.seq, public_key, me)
        return True

    def _replay_local(self, conn, public_key, topic: int,
                      from_seq: int) -> bool:
        """Unsharded replay: ONE pre-encoded writer entry for the whole
        retained range, enqueued without awaiting so the snapshot and the
        enqueue stay in the same synchronous block."""
        entries = self.snapshot(topic, from_seq)
        if not entries:
            return True
        stream = b"".join(self._prefixed_retained(topic, e)
                          for e in entries)
        try:
            conn.send_encoded_nowait(stream, None, cls=flowclass.BULK,
                                     nframes=len(entries))
        except Exception as exc:
            logger.info("replay to user %s failed (%r); disconnecting",
                        mnemonic(public_key), exc)
            return False
        self.replayed_frames += len(entries)
        self._track_replay(public_key, conn, len(entries))
        return True

    def _track_replay(self, public_key, conn, entries: int) -> None:
        self._replay_track[mnemonic(public_key)] = \
            [weakref.ref(conn) if conn is not None else None, entries]

    def _replay_lags(self) -> list:
        """(subscriber, lag) pairs for the pre-render hook: a tracked
        replay counts as lagging while its connection's writer queue is
        still draining; once empty (or the conn died) the subscriber has
        caught up and the entry retires."""
        out = []
        for name, (ref, entries) in list(self._replay_track.items()):
            conn = ref() if ref is not None else None
            if conn is None:
                del self._replay_track[name]
                continue
            try:
                depth, _ = conn.queue_stats()
            except Exception:
                depth = 0
            if depth <= 0:
                del self._replay_track[name]
                continue
            out.append((name, entries))
        return out

    def _watch_pattern(self, public_key, pattern: str) -> None:
        """Keep a wildcard subscription live: future ``bind``/``unbind``
        calls matching the pattern subscribe/unsubscribe this user through
        the plain per-topic interest path (mask unions maintained
        incrementally — the route planes never see the pattern)."""
        key = bytes(public_key)
        per_user = self._watches.setdefault(key, {})
        if pattern in per_user:
            return

        def on_add(name, topic, _key=key):
            conns = self.broker.connections
            if conns.has_user(_key):
                if topic in self.broker.run_def.topics.valid:
                    conns.subscribe_user_to(_key, [topic])
            else:
                self.unwatch_user(_key)  # user gone: lazy cleanup

        def on_remove(name, topic, _key=key):
            conns = self.broker.connections
            if conns.has_user(_key):
                conns.unsubscribe_user_from(_key, [topic])
            else:
                self.unwatch_user(_key)

        per_user[pattern] = self.namespace.watch(pattern, on_add=on_add,
                                                 on_remove=on_remove)

    def unwatch_user(self, public_key) -> None:
        for h in self._watches.pop(bytes(public_key), {}).values():
            self.namespace.unwatch(h)

    # -- sharded owner plane -------------------------------------------------

    def _emit(self, event: tuple) -> None:
        runtime = self.broker.shard_runtime
        if runtime is not None:
            runtime._emit(event)

    def apply_shard_event(self, event: tuple) -> None:
        """Dispatch one durable event off the shard bus (data plane — the
        caller keeps these out of the interest-delta counters)."""
        kind = event[0]
        me = self.broker.connections.shard_id
        if kind == "durable_pub":
            _, owner, frame, to_users_only = event
            if owner == me:
                self._apply_durable_pub(frame, to_users_only)
        elif kind == "durable_retain":
            _, owner, frame = event
            if owner == me:
                self._retain_owned_topics(frame)
        elif kind == "durable_sub":
            _, topic, from_seq, key, user_shard = event
            if self.owner_shard(topic) == me:
                self._apply_durable_sub(topic, from_seq, key, user_shard)

    def _decode_pub(self, frame: bytes):
        try:
            msg = deserialize_owned(frame)
        except Error:
            return None, ()
        pruned, _bad = self.broker.run_def.topics.prune(msg.topics)
        me = self.broker.connections.shard_id
        dt = [t for t in pruned if t in self.topics
              and self.owner_shard(t) == me]
        return msg, (pruned, dt)

    def _retain_owned_topics(self, frame: bytes) -> None:
        msg, info = self._decode_pub(frame)
        if msg is not None and info[1]:
            self._retain(info[1], msg.message, None)

    def _apply_durable_pub(self, frame: bytes, to_users_only: bool) -> None:
        """Owner side of a durable broadcast: retention stamp + interest
        snapshot in ONE synchronous block, fan-out through the ordered
        drainer (queue FIFO pins per-user replay-vs-live order)."""
        msg, info = self._decode_pub(frame)
        if msg is None:
            return
        pruned, dt = info
        if dt:
            self._retain(dt, msg.message, None)
        users, brokers = self.broker.connections.get_interested_by_topic(
            list(pruned), to_users_only)
        tr = getattr(msg, "trace", None)
        if tr is not None:
            trace_mod.emit("ingress", tr, "durable-owner")
            if users or brokers:
                trace_mod.emit("plan", tr, "durable-owner")
                trace_mod.emit("egress", tr, "durable-drainer")
            else:
                trace_mod.emit("plan", tr, "dropped")
        if users or brokers:
            self._queue(("pub", frame, tuple(users), tuple(brokers)))

    def _apply_durable_sub(self, topic: int, from_seq: int, key,
                           user_shard: int) -> None:
        """Owner side of a replay subscribe: interest row + ring snapshot +
        replay enqueue, one synchronous block. The row is added additively
        here (ahead of the authoritative "user" delta already in flight on
        the bus) so no later durable pub can miss the user."""
        conns = self.broker.connections
        if not conns.has_user(key):
            conns.add_remote_user_interest(key, user_shard, [topic])
        entries = self.snapshot(topic, from_seq)
        if not entries:
            return
        frames = [self._prefixed_retained(topic, e) for e in entries]
        self.replayed_frames += len(frames)
        self._queue(("replay", bytes(key), user_shard, frames))

    def _queue(self, item: tuple) -> None:
        if self._fanout_q is None:
            self._fanout_q = asyncio.Queue()
        self._fanout_q.put_nowait(item)
        if self._drain_task is None or self._drain_task.done():
            self._drain_task = asyncio.ensure_future(self._drain_fanout())

    async def _drain_fanout(self) -> None:
        while True:
            item = await self._fanout_q.get()
            try:
                await self._drain_one(item)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("durable fan-out failed")

    async def _drain_one(self, item: tuple) -> None:
        from pushcdn_tpu_torch.broker import shardring
        from pushcdn_tpu_torch.broker.tasks.handlers import EgressBatch
        broker = self.broker
        conns = broker.connections
        if item[0] == "pub":
            _, frame, users, brokers = item
            raw = Bytes(frame)
            cls = flowclass.frame_class(frame)
            egress = EgressBatch(broker)
            for u in users:
                if u in conns.users or u in conns.parting:
                    egress.to_user(u, raw)
                else:
                    shard = conns.remote_user_shard.get(u)
                    if shard is not None:
                        egress.to_shard(shard, shardring.KIND_USER, u, raw)
            for b in brokers:
                if b in conns.brokers:
                    egress.to_broker(b, raw, cls=cls)
                else:
                    shard = conns.remote_broker_shard.get(b)
                    if shard is not None:
                        egress.to_shard(shard, shardring.KIND_BROKER, b,
                                        raw, cls=cls)
            await egress.flush()
        else:  # ("replay", key, user_shard, prefixed_frames)
            _, key, user_shard, frames = item
            if key in conns.users:
                conn = conns.get_user_connection(key)
                if conn is None:
                    return
                try:
                    await conn.send_encoded(b"".join(frames), None,
                                            cls=flowclass.BULK,
                                            nframes=len(frames))
                    self._track_replay(key, conn, len(frames))
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    logger.info("replay to user %s failed (%r); removing",
                                mnemonic(key), exc)
                    conns.remove_user(key, reason="send failed")
            elif broker.shard_runtime is not None:
                broker.shard_runtime.handoff(
                    user_shard, frames,
                    [(shardring.KIND_USER, key, list(range(len(frames))))],
                    prefixed=True)
