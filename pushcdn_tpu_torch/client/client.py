"""The elastic client: auto-reconnecting, subscription-replaying.

Capability parity with cdn-client/src/lib.rs:37-481:

- shared state: marshal endpoint, keypair, subscribed-topic set, and an
  optional live connection (lib.rs:37-69);
- **single-flight reconnect**: one reconnect at a time, guarded by a
  1-permit semaphore; concurrent callers wait for the winner
  (lib.rs:204-258), retrying every 2 s with a 10 s per-attempt timeout;
- on ANY send/recv error the connection is torn down and lazily re-dialed
  (``disconnect_on_error!``, lib.rs:149-165) — the client re-authenticates
  through the marshal, which re-load-balances it;
- subscriptions are replayed during the broker handshake (topics ride the
  ``Subscribe`` sent at auth, lib.rs:112-121), so a reconnect restores
  delivery without caller involvement;
- ``subscribe``/``unsubscribe`` compute deltas against the local topic set
  and update it only on successful send (lib.rs:295-481 API semantics).
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple, Type

from pushcdn_tpu_torch.proto import metrics as metrics_mod
from pushcdn_tpu_torch.proto import trace as trace_mod
from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME, KeyPair, SignatureScheme
from pushcdn_tpu_torch.proto.error import Error, ErrorKind, bail
from pushcdn_tpu_torch.proto.limiter import Limiter, NO_LIMIT
from pushcdn_tpu_torch.proto.auth import user as user_auth
from pushcdn_tpu_torch.proto.message import (
    SEQ_LAST,
    SEQ_LIVE,
    AuthenticateResponse,
    Broadcast,
    Direct,
    Message,
    Migrate,
    Subscribe,
    SubscribeFrom,
    Unsubscribe,
    deserialize_owned,
    serialize,
    with_trace,
)
from pushcdn_tpu_torch.proto.transport.base import Connection, Protocol

logger = logging.getLogger("pushcdn.client")

CONNECT_TIMEOUT_S = 10.0    # per-attempt timeout

# Reconnect backoff: exponential with FULL jitter —
# delay = uniform(0, min(cap, base * 2^attempt)) — so a broker death
# under 10K clients produces a spread-out reconnect storm instead of
# synchronized waves (the classic full-jitter result: contention decays
# instead of echoing). A typed Error(SHED) retry-after hint acts as a
# FLOOR on the draw: the server told us when it expects to be useful
# again, so retrying earlier is wasted work for both sides.
BACKOFF_BASE_S = float(os.environ.get("PUSHCDN_BACKOFF_BASE_S", "") or 0.25)
BACKOFF_CAP_S = float(os.environ.get("PUSHCDN_BACKOFF_CAP_S", "") or 30.0)

# Bounded final drain of the OLD connection during a migration: the old
# broker closes it once the target's UserSync eviction lands; this is
# only the backstop when that propagation stalls (mesh partition).
MIGRATE_DRAIN_TIMEOUT_S = float(
    os.environ.get("PUSHCDN_MIGRATE_DRAIN_S", "") or 2.0)


def backoff_delay(attempt: int, retry_after_s: Optional[float] = None,
                  base_s: Optional[float] = None,
                  cap_s: Optional[float] = None) -> float:
    """The full-jitter reconnect delay for ``attempt`` (0-based), with an
    optional typed retry-after floor. Module-level so the backoff policy
    is unit-testable without a socket in sight."""
    base = BACKOFF_BASE_S if base_s is None else base_s
    cap = BACKOFF_CAP_S if cap_s is None else cap_s
    delay = random.uniform(0.0, min(cap, base * (2 ** attempt)))
    if retry_after_s is not None and retry_after_s > 0:
        delay = max(delay, float(retry_after_s))
    return delay


class GapDetector:
    """Live delivery-gap detector: the subscriber's half of
    the frame-fate ledger. The application tells the client how to read
    a (stream, sequence) pair out of a delivery (``ClientConfig.
    seq_extractor``) and the client accounts every arrival AS IT LANDS:

    - a sequence jumping past the stream's high-water mark opens a hole
      per skipped value (``cdn_client_gap_events`` — counted live, not
      at wrap-up);
    - a late arrival filling a tracked hole HEALS it
      (``cdn_client_gap_healed`` — an at-least-once redelivery or
      reorder, which stays legal);
    - a re-delivery of an already-seen value is a duplicate and touches
      neither counter.

    Outstanding loss as this client sees it is ``events - healed``
    (equivalently :attr:`open_gaps`); harness wrap-up loss checks read
    that instead of diffing delivery logs after the fact. The first
    observation of a stream anchors its high-water mark — joining late
    is not a gap. Hole tracking is bounded (``MAX_OPEN`` per stream,
    oldest evicted first); an evicted hole can no longer heal, which
    over-counts residual loss only in runs already losing thousands of
    frames per stream."""

    MAX_OPEN = 4096

    __slots__ = ("_hi", "_holes", "events", "healed", "unique",
                 "duplicates")

    def __init__(self) -> None:
        self._hi: Dict[int, int] = {}       # stream -> highest seq + 1
        self._holes: Dict[int, set] = {}    # stream -> open (missed) seqs
        self.events = 0
        self.healed = 0
        self.unique = 0
        self.duplicates = 0

    def observe(self, stream: int, seq: int) -> None:
        hi = self._hi.get(stream)
        if hi is None:
            self._hi[stream] = seq + 1
            self.unique += 1
            return
        if seq >= hi:
            missed = seq - hi
            if missed:
                self.events += missed
                metrics_mod.CLIENT_GAP_EVENTS.inc(missed)
                holes = self._holes.setdefault(stream, set())
                holes.update(range(max(hi, seq - self.MAX_OPEN), seq))
                while len(holes) > self.MAX_OPEN:
                    holes.discard(min(holes))  # rare: cap the tracker
            self._hi[stream] = seq + 1
            self.unique += 1
            return
        holes = self._holes.get(stream)
        if holes is not None and seq in holes:
            holes.discard(seq)
            self.healed += 1
            self.unique += 1
            metrics_mod.CLIENT_GAP_HEALED.inc()
            return
        self.duplicates += 1

    @property
    def open_gaps(self) -> int:
        """Holes still unfilled — the live residual-loss figure."""
        return sum(len(h) for h in self._holes.values())


def decode_received(items) -> List[Message]:
    """Decode a ``Connection.recv_frames`` drain into Message objects —
    the client receive path's batch decoder, shared with the benches so
    the measured decode IS what ``receive_messages`` runs. FrameChunks
    batch-decode off the shared buffer with ZERO-COPY memoryview payloads
    for Broadcast/Direct (FrameChunk.decode_remaining); bare frames take
    the owned single-frame decoder. Every item is released here on
    success; on failure the caller owns cleanup (the client tears the
    connection down, which releases the rest)."""
    from pushcdn_tpu_torch.proto.transport.base import FrameChunk
    out: List[Message] = []
    i = 0
    try:
        for i, item in enumerate(items):
            if type(item) is FrameChunk:
                # whole-chunk batch decode off the shared buffer: zero
                # payload copies, one release for the lot (the returned
                # views keep the buffer alive)
                out.extend(item.decode_remaining())
            else:
                out.append(deserialize_owned(item.data))
                item.release()
    except BaseException:
        # the failing item's chunk path already released itself
        # (decode_remaining is try/finally; release is idempotent);
        # everything at and after the failure returns its permit here
        for item in items[i:]:
            item.release()
        raise
    return out


@dataclass
class ClientConfig:
    """Parity with the client Config (cdn-client/src/lib.rs)."""

    marshal_endpoint: str
    keypair: KeyPair
    protocol: Type[Protocol]
    scheme: Type[SignatureScheme] = DEFAULT_SCHEME
    subscribed_topics: Set[int] = field(default_factory=set)
    use_local_authority: bool = True
    limiter: Limiter = NO_LIMIT
    # live gap detection: maps a delivered message to its
    # (stream, sequence) pair, or None for messages that carry no
    # sequence. Setting it arms :class:`GapDetector` on the receive
    # path (``Client.gap_detector``).
    seq_extractor: Optional[Callable[[Message],
                                     Optional[Tuple[int, int]]]] = None


class Client:
    """Clonable-by-reference handle over an elastic connection."""

    def __init__(self, config: ClientConfig):
        self.config = config
        self._topics: Set[int] = set(config.subscribed_topics)
        self._connection: Optional[Connection] = None
        self._reconnect_sem = asyncio.Semaphore(1)  # single-flight guard
        # lifecycle tracing: deterministic 1-in-N publish sampler; the
        # first publish after a (re)connect reuses the connection's trace
        # id so the marshal-auth span chains to a message lifecycle
        self._sampler = trace_mod.Sampler()
        # a broker load-shed notice that arrived in the same batch as
        # real deliveries: the deliveries are returned first, the typed
        # Error(SHED) raises on the next receive call
        self._pending_shed: Optional[Error] = None
        # once the broker has shed ANY mutation on this connection, the
        # optimistic local topic mirror can no longer be trusted (the
        # notice doesn't say which mutation was dropped) — until the next
        # reconnect replays the full set, subscribe/unsubscribe send the
        # requested topics verbatim instead of the delta
        self._topics_dirty = False
        # elastic re-home: a Migrate frame seen mid-batch is
        # stashed here until the deliveries ahead of it are handed over;
        # the backlog holds old-connection stragglers collected during
        # the make-before-break switch, delivered before anything from
        # the new connection
        self._pending_migrate: Optional[Migrate] = None
        self._migration_backlog: deque = deque()
        # re-home observability: wall-clock ms per completed migration
        # (Migrate processed -> new home live), read by the swarm soak
        # harness for its re-home latency percentiles
        self.rehome_ms: List[float] = []
        # live gap detection (armed only when the config supplies a
        # sequence extractor — zero cost otherwise)
        self.gap_detector: Optional[GapDetector] = \
            GapDetector() if config.seq_extractor is not None else None

    def _shed_error(self, message: AuthenticateResponse) -> Error:
        """A post-handshake ``permit=0`` response is the broker's typed
        load-shed notice: the request (e.g. a subscribe) was
        REFUSED but the connection is still live — surface it as
        ``Error(SHED)`` without tearing the connection down (reconnecting
        into an overloaded broker would make the overload worse)."""
        self._topics_dirty = True
        return Error(ErrorKind.SHED,
                     message.context or "server shed the request")

    # -- connection management ---------------------------------------------

    async def _connect_once(self) -> Connection:
        """One full marshal→broker dance (ClientRef::connect, lib.rs:79-121)."""
        c = self.config
        # lifecycle tracing: the connection trace originates at dial time;
        # the marshal stamps the auth span on it, and the first publish
        # after connect reuses the id (a complete chain per connect under
        # any sampling rate)
        conn_trace = trace_mod.new_trace() if trace_mod.ENABLED else None
        # hop 1: marshal — the timestamp signature (pure CPU; ~0.13 ms for
        # a pairing scheme) is computed WHILE the dial waits on the
        # marshal's accept, so the two costs overlap instead of adding.
        # The sleep(0) is what makes the overlap real: ensure_future only
        # SCHEDULES the coroutine, and the sync sign would otherwise run
        # before the dial ever issues its connect syscall.
        dial = asyncio.ensure_future(c.protocol.connect(
            c.marshal_endpoint, c.use_local_authority, c.limiter))
        try:
            await asyncio.sleep(0)
            presigned = user_auth.presign_timestamp(c.scheme, c.keypair)
        except BaseException:
            dial.cancel()
            try:
                (await dial).close()  # dial may have already resolved
            except BaseException:
                pass
            raise
        marshal_conn = await dial
        # a SLOW dial (SYN retries, TLS stalls — legal within the connect
        # timeout) ages the presigned timestamp toward the marshal's ±5 s
        # replay window; re-sign rather than burn the window on transit
        if int(time.time()) - presigned[0] > 2:
            presigned = None  # authenticate_with_marshal signs fresh
        try:
            permit, broker_endpoint = await user_auth.authenticate_with_marshal(
                marshal_conn, c.scheme, c.keypair, presigned=presigned,
                trace=conn_trace)
        finally:
            marshal_conn.close()
        # hop 2: the assigned broker
        broker_conn = await c.protocol.connect(
            broker_endpoint, c.use_local_authority, c.limiter)
        try:
            await user_auth.authenticate_with_broker(
                broker_conn, permit, sorted(self._topics))
        except BaseException:
            broker_conn.close()
            raise
        if conn_trace is not None:
            # the first publish reuses the connection trace id; the AUTH
            # span is the MARSHAL's to emit (server-side stamp/strip) —
            # a client-side twin would double-populate the hop histogram
            # with a second latency population and let the chain check
            # pass even when the marshal path is broken
            self._sampler.pending = conn_trace[0]
        # the handshake replayed the FULL desired topic set, so the
        # broker mirror is authoritative again (post-shed staleness gone)
        self._topics_dirty = False
        logger.info("connected to broker at %s", broker_endpoint)
        return broker_conn

    async def ensure_initialized(self) -> None:
        """Block until a live connection exists (lib.rs:321)."""
        await self._get_connection()

    async def _get_connection(self) -> Connection:
        conn = self._connection
        if conn is not None and not conn.is_closed:
            return conn
        async with self._reconnect_sem:  # single-flight (lib.rs:204-258)
            conn = self._connection
            if conn is not None and not conn.is_closed:
                return conn
            attempt = 0
            while True:
                try:
                    async with asyncio.timeout(CONNECT_TIMEOUT_S):
                        self._connection = await self._connect_once()
                    return self._connection
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    # full-jitter exponential backoff; a typed SHED
                    # retry-after hint floors the draw. A
                    # rejected permit re-runs the whole marshal dance on
                    # the next attempt, so the marshal re-load-balances
                    # us for free.
                    delay = backoff_delay(
                        attempt, getattr(exc, "retry_after_s", None))
                    attempt += 1
                    logger.info("connect attempt %d failed (%r); "
                                "retrying in %.2fs", attempt, exc, delay)
                    await asyncio.sleep(delay)

    def _disconnect_on_error(self) -> None:
        """Tear the connection down so the next call re-dials
        (disconnect_on_error!, lib.rs:149-165)."""
        conn, self._connection = self._connection, None
        if conn is not None:
            conn.close()

    # -- elastic re-home ------------------------------------------

    async def _complete_migration(self, migrate: Migrate) -> None:
        """Make-before-break re-home. The OLD connection stays open while
        the new home is established: closing it first would release the
        old broker's DirectMap claim before the target claims the user —
        a zero-home window where a mid-migration direct is lost. Instead
        the target's ``add_user`` out-versions the claim, the UserSync
        eviction makes the old broker close its half, and we do a bounded
        final drain of the old connection into the backlog so stragglers
        are delivered (in order) before anything from the new home.
        Subscriptions replay inside the target handshake, riding the same
        full-set replay a reconnect uses."""
        c = self.config
        t0 = time.monotonic()
        old, self._connection = self._connection, None
        new_conn = None
        async with self._reconnect_sem:  # serialize vs lazy reconnects
            if migrate.permit >= 2 and migrate.target:
                # pre-issued permit: dial the new home DIRECTLY — the
                # draining broker already did the placement + permit work
                # in one batch, no per-connection marshal round-trip
                try:
                    async with asyncio.timeout(CONNECT_TIMEOUT_S):
                        new_conn = await c.protocol.connect(
                            migrate.target, c.use_local_authority, c.limiter)
                        await user_auth.authenticate_with_broker(
                            new_conn, migrate.permit, sorted(self._topics))
                    self._topics_dirty = False
                    logger.info("re-homed to broker at %s", migrate.target)
                except asyncio.CancelledError:
                    if new_conn is not None:
                        new_conn.close()
                    raise
                except Exception as exc:
                    logger.info("direct re-home to %s failed (%r); "
                                "falling back to the marshal",
                                migrate.target, exc)
                    if new_conn is not None:
                        new_conn.close()
                    new_conn = None
            if new_conn is None:
                # fallback: the full marshal re-dance (it re-load-balances
                # us); a failure here leaves the client disconnected and
                # the NEXT call enters the ordinary backoff loop
                try:
                    async with asyncio.timeout(CONNECT_TIMEOUT_S):
                        new_conn = await self._connect_once()
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    logger.info("marshal fallback after migrate failed: %r",
                                exc)
            # bounded final drain: collect every delivery still buffered
            # on (or in flight to) the old connection. Normally ends fast
            # — the old broker closes the connection once the UserSync
            # eviction lands; the timeout is the partition backstop.
            if old is not None and not old.is_closed:
                try:
                    async with asyncio.timeout(MIGRATE_DRAIN_TIMEOUT_S):
                        while True:
                            items = await old.recv_frames()
                            for m in decode_received(items):
                                if isinstance(m, (Broadcast, Direct)):
                                    self._migration_backlog.append(m)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    pass  # closed by the old broker, or timed out
            if old is not None:
                old.close()
            self._connection = new_conn
            if new_conn is not None:
                self.rehome_ms.append((time.monotonic() - t0) * 1000.0)

    # -- messaging API (lib.rs:295-481) -------------------------------------

    async def send_message(self, message: Message) -> None:
        conn = self._connection  # fast path: live connection, no coroutine
        if conn is None or conn.is_closed:
            conn = await self._get_connection()
        # sampled lifecycle tracing: every Nth hot message is stamped with
        # a trace context (one class-attr check + one counter inc on the
        # untraced 1023/1024; nothing at all when tracing is disabled)
        if trace_mod.ENABLED and message.kind in (Broadcast.kind, Direct.kind) \
                and message.trace is None:
            tr = self._sampler.next_trace()
            if tr is not None:
                message = with_trace(message, tr)
                trace_mod.emit("publish", tr, f"{len(message.message)} B")
        try:
            await conn.send_message(message)
        except Exception as exc:
            self._disconnect_on_error()
            bail(ErrorKind.CONNECTION, "send failed; connection reset", exc)

    async def send_broadcast_message(self, topics: List[int],
                                     payload: bytes) -> None:
        await self.send_message(Broadcast(topics=topics, message=payload))

    async def send_direct_message(self, recipient_public_key: bytes,
                                  payload: bytes) -> None:
        await self.send_message(Direct(recipient=recipient_public_key,
                                       message=payload))

    def _observe_gaps(self, messages) -> None:
        """Feed delivered messages through the live gap detector (no-op
        unless the config armed one)."""
        extract = self.config.seq_extractor
        det = self.gap_detector
        for m in messages:
            key = extract(m)
            if key is not None:
                det.observe(key[0], key[1])

    async def receive_message(self) -> Message:
        while True:
            if self._pending_shed is not None:
                err, self._pending_shed = self._pending_shed, None
                raise err
            if self._migration_backlog:
                m = self._migration_backlog.popleft()
                if self.gap_detector is not None:
                    self._observe_gaps((m,))
                return m
            if self._pending_migrate is not None:
                mig, self._pending_migrate = self._pending_migrate, None
                await self._complete_migration(mig)
                continue
            conn = self._connection  # fast path: live conn, no coroutine
            if conn is None or conn.is_closed:
                conn = await self._get_connection()
            try:
                message = await conn.recv_message()
            except Exception as exc:
                self._disconnect_on_error()
                bail(ErrorKind.CONNECTION,
                     "receive failed; connection reset", exc)
            if isinstance(message, Migrate):
                await self._complete_migration(message)
                continue
            if isinstance(message, AuthenticateResponse) and message.permit == 0:
                raise self._shed_error(message)
            if trace_mod.ENABLED:
                tr = getattr(message, "trace", None)
                if tr is not None:
                    trace_mod.emit("delivery", tr)
            if self.gap_detector is not None:
                self._observe_gaps((message,))
            return message

    async def receive_messages(self, max_messages: int = 1024
                               ) -> List[Message]:
        """Receive every message currently available (at least one; blocks
        only when none are pending) in ONE wakeup — the batch twin of
        :meth:`receive_message` for consumers that keep up with fan-out
        rates: per-message task wakeups are what bound a single-process
        drain loop, exactly like the transport's own batched reader
        (transport/base.py). Same elastic semantics: any error (transport
        OR a malformed frame) tears the connection down for lazy re-dial.

        ``max_messages`` is approximate: the transport hands over whole
        parse batches, so one call may return more than asked (never
        fewer than 1)."""
        while True:
            if self._pending_shed is not None:
                err, self._pending_shed = self._pending_shed, None
                raise err
            if self._migration_backlog:
                out = list(self._migration_backlog)
                self._migration_backlog.clear()
                if self.gap_detector is not None:
                    self._observe_gaps(out)
                return out
            if self._pending_migrate is not None:
                mig, self._pending_migrate = self._pending_migrate, None
                await self._complete_migration(mig)
                continue
            conn = self._connection
            if conn is None or conn.is_closed:
                conn = await self._get_connection()
            try:
                items = await conn.recv_frames(max_messages)
            except Exception as exc:
                self._disconnect_on_error()
                bail(ErrorKind.CONNECTION,
                     "receive failed; connection reset", exc)
            try:
                # batch decode with ZERO-COPY payloads (decode_received
                # docs): the old one-copy-per-message residue is gone —
                # Broadcast/Direct ``message`` fields are memoryviews
                # over the chunk
                out = decode_received(items)
            except Exception as exc:
                self._disconnect_on_error()
                bail(ErrorKind.CONNECTION,
                     "malformed frame in receive batch; connection reset", exc)
            # a Migrate mid-batch splits it: deliveries ahead of it are
            # returned now, the frame is stashed for the next call (the
            # re-home completes then), and anything decoded after it is
            # backlogged so nothing is lost or reordered
            for i, m in enumerate(out):
                if isinstance(m, Migrate):
                    self._pending_migrate = m
                    self._migration_backlog.extend(
                        x for x in out[i + 1:] if not isinstance(x, Migrate))
                    out = out[:i]
                    break
            # load-shed notices (permit=0 post-handshake) surface as typed
            # Error(SHED): immediately when nothing else arrived, otherwise
            # after the real deliveries are handed over (next receive call)
            # — a shed is never a silent drop and never loses deliveries
            shed = [m for m in out
                    if isinstance(m, AuthenticateResponse) and m.permit == 0]
            if shed:
                out = [m for m in out
                       if not (isinstance(m, AuthenticateResponse)
                               and m.permit == 0)]
                err = self._shed_error(shed[-1])
                if not out:
                    raise err
                self._pending_shed = err
            if not out:
                continue  # the batch was pure control traffic (a Migrate)
            if trace_mod.ENABLED:
                for m in out:
                    tr = getattr(m, "trace", None)
                    if tr is not None:
                        trace_mod.emit("delivery", tr)
            if self.gap_detector is not None:
                self._observe_gaps(out)
            return out

    # -- subscriptions -------------------------------------------------------

    async def subscribe(self, topics: List[int]) -> None:
        """Send only the delta; update local state on success (lib.rs
        subscribe semantics). After a load shed the local mirror may be
        stale (a shed mutation was never applied), so the delta filter is
        suspended and the requested topics go out verbatim — the broker's
        subscribe is an idempotent set-union, so convergence is safe."""
        if self._topics_dirty:
            new = list(dict.fromkeys(topics))
        else:
            new = [t for t in topics if t not in self._topics]
        if not new:
            return
        conn = await self._get_connection()
        try:
            await conn.send_message(Subscribe(new), flush=True)
        except Exception as exc:
            self._disconnect_on_error()
            bail(ErrorKind.CONNECTION, "subscribe failed", exc)
        self._topics.update(new)

    async def subscribe_from(self, topic: int, seq: int = 0) -> None:
        """Durable replay subscribe: subscribe to ``topic`` AND
        replay every retained broadcast with sequence ``>= seq`` as
        ``Retained`` frames ahead of the live stream (gap-free, dup-free —
        see broker/retention.py). ``seq=0`` replays everything the broker
        still retains; :data:`SEQ_LAST` fetches only the last-value-cache
        entry; :data:`SEQ_LIVE` degrades to a plain subscribe.

        Retained frames surface as typed ``Retained`` messages from the
        receive calls. Sequence numbers are broker-local: after a re-home
        to a different broker, resume with ``seq=0`` or ``SEQ_LAST`` (the
        reconnect handshake replays only a plain ``Subscribe``)."""
        conn = await self._get_connection()
        try:
            await conn.send_message(SubscribeFrom(topic=topic, seq=seq),
                                    flush=True)
        except Exception as exc:
            self._disconnect_on_error()
            bail(ErrorKind.CONNECTION, "subscribe_from failed", exc)
        self._topics.add(topic)

    async def last_value(self, topic: int) -> None:
        """Fetch ``topic``'s last-value-cache entry (and subscribe): sugar
        for ``subscribe_from(topic, SEQ_LAST)``. The LVC frame arrives as
        a ``Retained`` message on the next receive call (nothing arrives
        when the broker retains nothing for the topic)."""
        await self.subscribe_from(topic, SEQ_LAST)

    async def subscribe_pattern(self, pattern: str,
                                seq: int = SEQ_LIVE) -> None:
        """Hierarchical wildcard subscribe (``consensus.view.*``): the
        broker compiles the pattern against its topic namespace into plain
        per-topic subscriptions and keeps the union live as names bind and
        unbind. ``seq`` other than :data:`SEQ_LIVE` additionally replays
        retained frames for every covered durable topic. The local topic
        mirror is NOT updated (coverage is broker-side state), so a
        re-home requires re-sending the pattern."""
        conn = await self._get_connection()
        try:
            await conn.send_message(
                SubscribeFrom(topic=0, seq=seq, pattern=pattern),
                flush=True)
        except Exception as exc:
            self._disconnect_on_error()
            bail(ErrorKind.CONNECTION, "subscribe_pattern failed", exc)

    async def unsubscribe(self, topics: List[int]) -> None:
        if self._topics_dirty:
            gone = list(dict.fromkeys(topics))
        else:
            gone = [t for t in topics if t in self._topics]
        if not gone:
            return
        conn = await self._get_connection()
        try:
            await conn.send_message(Unsubscribe(gone), flush=True)
        except Exception as exc:
            self._disconnect_on_error()
            bail(ErrorKind.CONNECTION, "unsubscribe failed", exc)
        self._topics.difference_update(gone)

    @property
    def subscribed_topics(self) -> Set[int]:
        return set(self._topics)

    @property
    def public_key(self) -> bytes:
        return self.config.keypair.public_key

    # -- teardown ------------------------------------------------------------

    async def soft_close(self) -> None:
        conn = self._connection
        if conn is not None:
            await conn.soft_close()
            self._connection = None

    def close(self) -> None:
        self._disconnect_on_error()
