"""The transport-generic connection machinery.

Capability parity with cdn-proto/src/connection/protocols/mod.rs:

- ``Protocol`` — connect/bind with associated listener + unfinalized
  connection types (mod.rs:40-81).
- ``Connection`` — the uniform handle: two actor tasks (writer-drain and
  reader-pump) bridged to callers by queues (mod.rs:139-217), with
  ``send_message[_raw]`` / ``recv_message[_raw]`` / ``soft_close``
  (mod.rs:223-306).
- Length-delimited framing: u32 big-endian length prefix then payload, max
  ``MAX_MESSAGE_SIZE``, 5 s per-frame read/write timeouts
  (mod.rs:309-394; cdn-proto/src/lib.rs:25).
- Backpressure lands on the socket, not the router (mod.rs:328): frames
  larger than the read chunk acquire their limiter byte-permit before the
  payload is buffered; small frames parsed out of an already-read chunk
  acquire theirs before entering the receive queue, so the unpermitted
  overshoot is bounded by ``Connection._READ_CHUNK`` per connection and
  a blocked permit still stops further socket reads.
"""

from __future__ import annotations

import abc
import asyncio
import struct
import time
import weakref
from collections import deque
from typing import List, Optional

from pushcdn_tpu_torch import native
from pushcdn_tpu_torch.proto import MAX_MESSAGE_SIZE
from pushcdn_tpu_torch.proto.error import Error, ErrorKind, bail
from pushcdn_tpu_torch.proto.limiter import Bytes, Limiter, NO_LIMIT
from pushcdn_tpu_torch.proto.message import (
    Message,
    decode_frames,
    deserialize,
    deserialize_owned,
    materialize,
    serialize,
)
from pushcdn_tpu_torch.proto import flightrec
from pushcdn_tpu_torch.proto import ledger as ledger_mod
from pushcdn_tpu_torch.proto import metrics as metrics_mod

# Live connections (weak), for the metrics writer-queue-depth pre-render
# hook and /debug introspection.
LIVE_CONNECTIONS: "weakref.WeakSet[Connection]" = weakref.WeakSet()

# Parity: 5 s read/write timeouts (protocols/mod.rs:336, :368, :379) and a
# 5 s connect timeout (tcp.rs).
WRITE_TIMEOUT_S = 5.0
READ_TIMEOUT_S = 5.0
CONNECT_TIMEOUT_S = 5.0

_LEN = struct.Struct(">I")

_CLOSE = object()  # sentinel queued to ask the writer task to soft-close


class FrameChunk:
    """A run of complete frames parsed from ONE read chunk, sharing one
    detached buffer and one pool permit — the receive-side twin of the
    egress engine's per-user streams. The reader enqueues one of these per
    parse batch instead of per-frame :class:`Bytes`, so a 250-frame chunk
    costs one buffer copy and one queue put, not 250 of each.

    Consumption modes:
    - :meth:`take` materializes the next frame as a permit-sharing
      :class:`Bytes` (compat path for ``recv_raw``/``recv_raw_many``);
    - :meth:`views` hands out zero-copy memoryviews of every remaining
      frame for whole-chunk consumers (``Client.receive_messages``), who
      call :meth:`release` when done.

    Pool accounting is deliberately chunk-granular: ONE permit covers the
    whole batch, and a consumer retaining any single taken frame pins it
    until that frame is released too. The coarser unit trades worst-case
    precision (bounded by one read chunk per long-held frame) for not
    paying a permit per frame; under pool pressure the reader falls back
    to exact per-frame permits (see ``_reader_loop``).
    """

    __slots__ = ("buf", "offs", "lens", "_pos", "_master")

    def __init__(self, buf: bytes, offs, lens, permit):
        self.buf = buf
        self.offs = offs
        self.lens = lens
        self._pos = 0
        self._master = Bytes(buf, permit)

    @property
    def remaining(self) -> int:
        return len(self.offs) - self._pos

    def take(self) -> Bytes:
        """Materialize the next frame (shares the chunk's permit via the
        Bytes refcount: the permit frees when the chunk AND every taken
        frame are released)."""
        i = self._pos
        self._pos = i + 1
        o = self.offs[i]
        b = self._master.clone()
        b.data = self.buf[o:o + self.lens[i]]
        if self._pos == len(self.offs):
            self._master.release()  # fully handed out
        return b

    def views(self):
        """Zero-copy memoryviews of every remaining frame; the caller owns
        consumption and MUST call :meth:`release` afterwards."""
        mv = memoryview(self.buf)
        return [mv[self.offs[i]:self.offs[i] + self.lens[i]]
                for i in range(self._pos, len(self.offs))]

    def decode_remaining(self, zero_copy: bool = True) -> list:
        """Decode every remaining frame into Message objects (the batch
        decoder runs straight over the shared buffer) and release the
        chunk. The fan-out consumer's one-call drain.

        By default Broadcast/Direct payloads of at least
        ``message.ZERO_COPY_MIN`` bytes are ZERO-COPY memoryviews of the
        chunk buffer (``message.decode_frames`` zero_copy docs): the
        views keep the buffer alive after the release below, so the last
        per-message copy on the client receive path is gone for the
        payload sizes where it costs anything; smaller payloads stay
        owned copies (bounds how much chunk memory retained messages can
        pin after the pool permit returns). Pass ``zero_copy=False`` for
        owned bytes payloads throughout."""
        try:
            return decode_frames(self.buf, self.offs, self.lens, self._pos,
                                 zero_copy=zero_copy)
        finally:
            self.release()

    def lease(self):
        """A :class:`pushcdn_tpu_torch.proto.limiter.BytesLease` over the
        chunk's master reference: keeps the buffer + pool permit alive
        until the lease is dropped. The cut-through routing plane attaches
        one to each writer entry that flushes a zero-copy view of this
        chunk, so ``release()``-ing the chunk after planning cannot free
        the permit under a pending flush."""
        from pushcdn_tpu_torch.proto.limiter import BytesLease
        return BytesLease(self._master)

    def release(self) -> None:
        """Drop the untaken remainder (idempotent)."""
        if self._pos < len(self.offs):
            self._pos = len(self.offs)
            self._master.release()


class PreEncoded:
    """An already-length-delimited byte stream: the writer sends it
    verbatim, adding no framing. This is the egress batch handoff — the
    native engine (native.egress_encode) encodes a whole step's worth of
    frames for one user into one buffer, the routing loops pre-encode
    per-peer fan-out batches (FrameEncoder.encode_detached), and the
    connection flushes either with one write instead of re-framing per
    message. ``owner`` is an opaque keep-alive (e.g. the EgressStreams
    whose pooled buffer ``data`` views): it rides the queue entry until
    the flush completes, so buffer recycling can never race a pending
    write."""

    __slots__ = ("data", "owner")

    def __init__(self, data, owner=None):
        self.data = data  # bytes / memoryview over the step's egress buffer
        self.owner = owner


def _py_scan_frames(buf, max_frame_len: int):
    """Python fallback for native.FrameScanner.scan: walk a carry buffer
    for complete length-delimited frames. Returns (payload_offsets,
    payload_lengths, consumed, oversized_error)."""
    offs: list = []
    lens: list = []
    pos = 0
    blen = len(buf)
    error = False
    while blen - pos >= 4:
        (length,) = _LEN.unpack_from(buf, pos)
        if length > max_frame_len:
            error = True
            break
        if blen - pos - 4 < length:
            break
        offs.append(pos + 4)
        lens.append(length)
        pos += 4 + length
    return offs, lens, pos, error


class RawStream(abc.ABC):
    """Minimal async byte-stream pair every transport lowers to."""

    # streams that set this accept ``write(data, owner)`` /
    # ``writev(bufs, owner)`` and anchor the owner lease until the
    # kernel is done with the bytes (io_uring zero-copy deferral)
    wants_owner = False

    @abc.abstractmethod
    async def read_exactly(self, n: int) -> bytes: ...

    async def read_some(self, max_n: int) -> bytes:
        """Return at least 1 and at most ``max_n`` bytes; raise
        ``IncompleteReadError`` at EOF. Transports override this with a
        real bulk read — the reader loop uses it to parse many small
        frames per wakeup instead of two awaits per frame."""
        return await self.read_exactly(1)

    @abc.abstractmethod
    async def write(self, data) -> None:
        """Buffer ``data`` and flush (may await backpressure)."""

    async def writev(self, bufs) -> None:
        """Vectored write: flush ``bufs`` back-to-back as one unit.
        Transports with a gather-capable sink override this (asyncio's
        ``writelines`` hands the whole run to one transport write); the
        default is sequential — correctness-equivalent, one flush per
        buffer."""
        for b in bufs:
            await self.write(b)

    @abc.abstractmethod
    async def close(self) -> None:
        """Flush and close the write side gracefully."""

    @abc.abstractmethod
    def abort(self) -> None:
        """Tear down immediately."""


class AsyncioStream(RawStream):
    """RawStream over an asyncio (StreamReader, StreamWriter) pair.

    ``write_seconds``, when set (the owning :class:`Connection` hands it
    its ``cdn_stream_write_seconds`` child), takes the seconds of each
    flush's synchronous part: the copy and the transport's write, where
    asyncio's SSL transport encrypts. The drain's wait is not counted."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.write_seconds = None

    async def read_exactly(self, n: int) -> bytes:
        return await self.reader.readexactly(n)

    async def read_some(self, max_n: int) -> bytes:
        data = await self.reader.read(max_n)
        if not data:
            raise asyncio.IncompleteReadError(b"", 1)
        return data

    async def write(self, data) -> None:
        # memoryviews are materialized here (not passed through): newer
        # asyncio transports keep buffer references instead of copying,
        # and the egress pool recycles the underlying buffer as soon as
        # its lease drops — the transport must own a private copy
        t0 = time.perf_counter()
        self.writer.write(bytes(data) if isinstance(data, memoryview) else data)
        if self.write_seconds is not None:
            self.write_seconds.inc(time.perf_counter() - t0)
        await self.writer.drain()

    async def writev(self, bufs) -> None:
        # one gather handoff: writelines joins the run into a single
        # transport write (one kernel handoff instead of one per buffer)
        t0 = time.perf_counter()
        self.writer.writelines(
            [bytes(b) if isinstance(b, memoryview) else b for b in bufs])
        if self.write_seconds is not None:
            self.write_seconds.inc(time.perf_counter() - t0)
        await self.writer.drain()

    async def close(self) -> None:
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except Exception:
            pass

    def abort(self) -> None:
        try:
            self.writer.transport.abort()
        except Exception:
            try:
                self.writer.close()
            except Exception:
                pass


class Connection:
    """Uniform connection handle with actor-style reader/writer tasks.

    Shape parity with protocols/mod.rs:139-217: a writer task drains a send
    queue into the stream; a reader task pumps length-delimited frames into
    a receive queue (acquiring limiter permits first). Any I/O error poisons
    the connection: both queues wake with the error and subsequent calls
    raise ``Error(CONNECTION)`` — the caller's policy is removal/reconnect
    (fault detection *is* "send failed", tasks/broker/sender.rs:35-43).
    """

    def __init__(self, stream: RawStream, limiter: Limiter = NO_LIMIT,
                 label: str = "?"):
        self._stream = stream
        self._limiter = limiter
        self.label = label
        # owner-aware streams (io_uring) take the PreEncoded lease down
        # the flush path so zero-copy sends can defer its release until
        # the kernel's completion notification
        self._owner_write = bool(getattr(stream, "wants_owner", False))
        # per-transport byte accounting: the label's prefix is the
        # transport name ("tcp:host:port" → "tcp"); the labeled children
        # are cached here so the hot path pays one plain inc per flush
        transport = label.split(":", 1)[0] or "?"
        self._m_sent = metrics_mod.BYTES_SENT.labels(transport=transport)
        self._m_recv = metrics_mod.BYTES_RECV.labels(transport=transport)
        if isinstance(stream, AsyncioStream):
            stream.write_seconds = metrics_mod.STREAM_WRITE_SECONDS.labels(
                transport=transport)
        # flight recorder: the last ~64 structured events on this
        # connection, dumped to the diagnostics log on abnormal death and
        # readable at /debug/flightrec
        self.flightrec = flightrec.FlightRecorder(label)
        self.flightrec.record("connect")
        # frame-fate ledger attribution (ISSUE 20): broker links carry
        # their peer identifier so dequeues count as relayed{peer} in the
        # per-link conservation tables; teardown drains attribute their
        # dropped frames to this reason (send_failed / parting_expiry)
        # instead of the generic writer_teardown
        self.ledger_peer: Optional[str] = None
        self.ledger_drop_reason: Optional[str] = None
        LIVE_CONNECTIONS.add(self)
        qsize = limiter.queue_size()
        self._send_q: asyncio.Queue = asyncio.Queue(maxsize=qsize)
        self._recv_q: asyncio.Queue = asyncio.Queue(maxsize=qsize)
        # frames already popped off _recv_q but not yet handed to a caller
        # (the reader enqueues whole parse batches; receivers drain here)
        self._recv_pending: deque = deque()
        self._error: Optional[Error] = None
        self._closed = False
        # serializes stream writes between the writer task and the inline
        # flush fast path in send_raw (see there)
        self._write_mutex = asyncio.Lock()
        # the writer task spawns lazily on the first QUEUED send: a
        # handshake-only link whose few flushed sends all take the inline
        # fast path never pays the task spawn (or its batch encoder)
        self._writer_task: Optional[asyncio.Task] = None
        # True while the writer is in the load regime (last wakeup flushed
        # a multi-frame batch) — gates the adaptive coalesce window
        self._coalescing = False
        self._reader_task = asyncio.create_task(self._reader_loop())
        # Permit-leak backstop (ADVICE r5): a poisoned connection keeps
        # its receive side deliverable (data-before-FIN), so _poison must
        # NOT drain it — but an ABANDONED handle (handler crash, dropped
        # reference, never close()d) would then pin its queued frames'
        # pool permits forever. The finalizer drains whatever still sits
        # in the queues when the LAST reference to this connection drops;
        # anything a consumer already took out is the consumer's to
        # release, exactly as before.
        self._finalizer = weakref.finalize(
            self, Connection._drain_abandoned,
            self._send_q, self._recv_q, self._recv_pending)

    @staticmethod
    def _drain_abandoned(send_q: asyncio.Queue, recv_q: asyncio.Queue,
                         recv_pending: deque) -> None:
        """Release every queued frame's pool permit (GC-time backstop; the
        containers are empty when ``close()`` already ran)."""
        for q in (send_q, recv_q):
            while True:
                try:
                    item = q.get_nowait()
                except (asyncio.QueueEmpty, RuntimeError):
                    break
                if item is _CLOSE or isinstance(item, Error):
                    continue
                if isinstance(item, tuple):  # entry: (payload, done, stamp)
                    stamp = item[2] if len(item) > 2 else None
                    if stamp is not None and stamp[4]:
                        ledger_mod.record_fate("dropped", "writer_teardown",
                                               stamp[1], stamp[4])
                    item = item[0]
                    if type(item) is PreEncoded:
                        continue
                if isinstance(item, (Bytes, FrameChunk)):
                    item.release()
                elif isinstance(item, list):
                    for p in item:
                        if isinstance(p, Bytes):
                            p.release()
        while recv_pending:
            item = recv_pending.popleft()
            if isinstance(item, (Bytes, FrameChunk)):
                item.release()

    def _ensure_writer(self) -> None:
        if self._writer_task is None:
            self._writer_task = asyncio.create_task(self._writer_loop())
        # fused-pump fence (transport/pump.py): a frame just entered the
        # Python writer queue, so until it drains this peer's planned
        # frames must route through the queue too — fencing here is
        # SYNCHRONOUS with the enqueue, before the route task can plan
        b = getattr(self._stream, "_pump_binding", None)
        if b is not None:
            b.fence()

    def queue_stats(self) -> tuple:
        """``(entries, bytes)`` waiting in the send queue — the topology
        endpoint's per-peer backpressure view. Event-loop context only:
        peeks the queue's internal deque without mutating it (an entry
        dequeued concurrently just stops being counted)."""
        depth = self._send_q.qsize()
        total = 0
        try:
            for item in list(self._send_q._queue):
                if isinstance(item, tuple):
                    item = item[0]
                if isinstance(item, list):
                    for p in item:
                        data = p.data if isinstance(p, Bytes) else p
                        total += len(data)
                elif isinstance(item, (Bytes, PreEncoded)):
                    total += len(item.data)
                elif isinstance(item, (bytes, bytearray, memoryview)):
                    total += len(item)
        except Exception:
            pass
        return depth, total

    # -- actor loops --------------------------------------------------------

    # Batch small frames into one buffer per flush: per-frame event-loop +
    # syscall overhead dominates ≤1 KB frames otherwise (BASELINE.md soft
    # spot). Each flush unit stays under this size so the per-flush 5 s
    # timeout keeps the same granularity the old per-frame timeout had;
    # frames above the limit are written directly, no extra copy.
    _BATCH_COALESCE_LIMIT = 64 * 1024

    async def _flush(self, buf, owner=None) -> None:
        """One bounded write under its own timeout; BYTES_SENT counts only
        bytes that actually flushed."""
        async with asyncio.timeout(WRITE_TIMEOUT_S):
            if owner is not None and self._owner_write:
                await self._stream.write(buf, owner)
            else:
                await self._stream.write(buf)
        self._m_sent.inc(len(buf))

    async def _flush_v(self, bufs, owner=None) -> None:
        """Vectored twin of :meth:`_flush`: one timeout window, one gather
        handoff (``writev``) for a run of buffers."""
        async with asyncio.timeout(WRITE_TIMEOUT_S):
            if owner is not None and self._owner_write:
                await self._stream.writev(bufs, owner)
            else:
                await self._stream.writev(bufs)
        self._m_sent.inc(sum(len(b) for b in bufs))

    # an owner-aware stream (io_uring) turns a chunked PreEncoded flush
    # into linked-SQE chains: up to this many chunks per submission share
    # one timeout window and one kernel handoff
    _CHAIN_GROUP = 16

    async def _flush_chunked(self, data, owner=None) -> None:
        """Flush an already-framed stream (PreEncoded) in bounded chunks so
        slow links get one timeout window per chunk, not one for the lot."""
        n = len(data)
        chunk = 4 * self._BATCH_COALESCE_LIMIT
        if n <= chunk:
            await self._flush(data, owner)
            return
        view = memoryview(data)
        if self._owner_write:
            group = self._CHAIN_GROUP * chunk
            for base in range(0, n, group):
                top = min(n, base + group)
                await self._flush_v(
                    [view[off:off + chunk]
                     for off in range(base, top, chunk)], owner)
            return
        for off in range(0, n, chunk):
            await self._flush(view[off:off + chunk])

    async def _writer_loop(self) -> None:
        # the native batch encoder length-delimits a run of small frames in
        # one C call + one copy; created lazily on the first BATCH (its
        # reusable output buffer is a ~256 KiB allocation that depth-1 and
        # handshake traffic never needs). None ⇒ Python coalescer.
        encoder_cell = [False]  # False = not created yet; None = no native
        enc_cap = 3 * self._BATCH_COALESCE_LIMIT
        batch: list = []
        try:
            while True:
                item = await self._send_q.get()
                # every write section holds the mutex: send_raw's inline
                # flush fast path writes from the sender's task, and the
                # two paths must never interleave bytes on the stream.
                # The mutex is taken BEFORE the adaptive yield below: a
                # dequeued-but-unwritten entry with the mutex free would
                # let a concurrent inline flush write a NEWER frame first
                # (wire reorder); holding it keeps the inline path out
                # while producers (who only need the queue) still fill
                # the coalesce window during the yield.
                await self._write_mutex.acquire()
                try:
                    # Adaptive coalesce window: when the PREVIOUS wakeup
                    # coalesced (load regime) and this one would flush a
                    # lone frame, yield one loop tick first — ready
                    # producer tasks enqueue their frames and this flush
                    # carries a batch too. An idle link (previous flush
                    # was depth-1) writes immediately: the latency regime
                    # never waits.
                    if self._coalescing and self._send_q.empty():
                        try:
                            await asyncio.sleep(0)
                        except asyncio.CancelledError:
                            # cancelled in the yield: the dequeued entry
                            # is in neither the queue nor `batch` — its
                            # permits and flush future are ours to settle
                            if item is not _CLOSE:
                                self._account_dropped(item, None)
                                payload, done = item[0], item[1]
                                if type(payload) is list:
                                    for p in payload:
                                        if isinstance(p, Bytes):
                                            p.release()
                                elif isinstance(payload, Bytes):
                                    payload.release()
                                if done is not None and not done.done():
                                    done.cancel()
                            raise
                    closed = await self._writer_item(item, encoder_cell,
                                                     enc_cap, batch)
                finally:
                    self._write_mutex.release()
                # Drop the entry reference BEFORE parking on the queue: a
                # flushed entry's ``owner`` keep-alive (egress-buffer
                # lease, cut-through chunk permit lease) must release when
                # the flush completes, not when the NEXT send arrives on
                # an idle link.
                item = None
                if closed:
                    return
        except asyncio.CancelledError:
            # close() cancels the writer mid-flush: flush=True senders whose
            # entries were already dequeued are beyond _drain_queues' reach
            # and must not await forever (matches the drain's err=None
            # cancel semantics)
            for entry in batch:
                if entry is not _CLOSE and entry[1] is not None \
                        and not entry[1].done():
                    entry[1].cancel()
            raise
        except Exception as exc:
            err = Error(ErrorKind.CONNECTION, f"write failed: {exc!r}", exc)
            # flush=True senders whose entries we already dequeued must see
            # the failure (they are beyond _poison's queue drain)
            for entry in batch:
                if entry is not _CLOSE and entry[1] is not None \
                        and not entry[1].done():
                    entry[1].set_exception(err)
            self._poison(err)

    def _account_entry(self, entry, now: float) -> None:
        """Per-class flow accounting at dequeue: the entry's enqueue stamp
        is ``(t_enq, class, frames, bytes, real_frames)`` — observe the
        writer-queue delay for its class and fold the frame/byte counts
        into the egress class counters. ``frames``/``bytes`` may be 0
        when the caller pre-counted the volume at the routing decision;
        ``real_frames`` always carries the entry's actual frame count so
        the conservation ledger stays exact either way. Accounts entries
        dequeued FOR writing (a flush that subsequently fails is still
        counted here; ``BYTES_SENT`` remains the flushed-bytes ground
        truth, and the mesh audit's link deficit catches wire loss)."""
        stamp = entry[2]
        if stamp is None:
            return
        metrics_mod.WRITER_QUEUE_DELAY_CLS[stamp[1]].observe(now - stamp[0])
        if stamp[2]:
            metrics_mod.CLASS_FRAMES_OUT[stamp[1]].inc(stamp[2])
        if stamp[3]:
            metrics_mod.CLASS_BYTES_OUT[stamp[1]].inc(stamp[3])
        ledger_mod.on_dequeued(stamp[1], stamp[4], self.ledger_peer)

    def _account_dropped(self, item, err: Optional[Error]) -> None:
        """Fate accounting for one drained (never-written) send-queue
        entry."""
        stamp = item[2] if type(item) is tuple and len(item) > 2 else None
        if stamp is None or not stamp[4]:
            return
        reason = self.ledger_drop_reason or (
            "conn_poisoned" if err is not None else "writer_teardown")
        ledger_mod.record_fate("dropped", reason, stamp[1], stamp[4])

    async def _writer_item(self, item, encoder_cell, enc_cap,
                           batch: list) -> bool:
        """Process one dequeued writer entry (and any batchable run behind
        it). ``batch`` is the caller's scratch list, mutated IN PLACE —
        in-flight entries live there so the writer loop's cancel/error
        handlers can resolve their futures. Always called under
        ``_write_mutex`` (the inline flush path in ``send_raw`` takes the
        same mutex)."""
        if item is _CLOSE:
            await self._stream.close()
            return True
        # one clock read per wakeup covers every entry this drain accounts
        now = time.monotonic()
        self._account_entry(item, now)
        # Depth-1 fast path (the latency regime): one small single frame
        # and nothing else queued — write it directly, skipping batch
        # assembly, the get_nowait exception, flattening and encoder
        # probing. This is what a handshake or an idle-link echo pays per
        # message.
        if self._send_q.empty():
            payload, done = item[0], item[1]
            if type(payload) is PreEncoded:
                # a PreEncoded entry IS a fan-out batch (routing-loop /
                # device-plane egress): it counts as the load regime, so
                # the adaptive window arms for the next wakeup. The entry
                # rides `batch` during the flush so a timeout/cancel
                # mid-write settles its flush future via the loop's
                # handlers (same pattern as the small-frame path below).
                self._coalescing = True
                batch.append(item)
                await self._flush_chunked(payload.data, payload.owner)
                batch.clear()
                if done is not None and not done.done():
                    done.set_result(None)
                return False
            self._coalescing = False
            if type(payload) is not list:
                data = payload.data if isinstance(payload, Bytes) \
                    else payload
                n = len(data)
                if n <= self._BATCH_COALESCE_LIMIT:
                    batch.append(item)
                    try:
                        one = bytearray(_LEN.pack(n))
                        one += data
                        await self._flush(one)
                    finally:
                        if isinstance(payload, Bytes):
                            payload.release()
                    batch.clear()
                    if done is not None and not done.done():
                        done.set_result(None)
                    return False
        # Drain everything queued right now into one write batch.
        batch.append(item)
        while len(batch) < 512:
            try:
                nxt = self._send_q.get_nowait()
            except asyncio.QueueEmpty:
                break
            batch.append(nxt)
            if nxt is _CLOSE:
                break
            self._account_entry(nxt, now)

        if encoder_cell[0] is False:
            encoder_cell[0] = native.FrameEncoder.create(
                4 * self._BATCH_COALESCE_LIMIT)
        encoder = encoder_cell[0]
        dones = []
        close_after = False
        try:
            # flatten: an entry's payload is one frame or a whole
            # list of frames (send_raw_many batches)
            frames: list = []
            for entry in batch:
                if entry is _CLOSE:
                    close_after = True
                    break
                payload, done = entry[0], entry[1]
                if type(payload) is list:
                    for p in payload:
                        frames.append(
                            p.data if isinstance(p, Bytes) else p)
                else:
                    frames.append(payload.data
                                  if isinstance(payload, Bytes)
                                  else payload)
                if done is not None:
                    dones.append(done)
            # load-regime signal for the adaptive coalesce window: a
            # multi-entry drain OR one entry carrying a whole fan-out
            # batch (a send_raw_many list or a PreEncoded stream) both
            # mean traffic is flowing
            self._coalescing = (len(batch) > 1 or len(frames) > 1
                                or (len(frames) == 1
                                    and type(frames[0]) is PreEncoded))

            buf = bytearray()
            i, nf = 0, len(frames)
            while i < nf:
                data = frames[i]
                if type(data) is PreEncoded:
                    if buf:
                        await self._flush(buf)
                        buf = bytearray()
                    await self._flush_chunked(data.data, data.owner)
                    i += 1
                    continue
                n = len(data)
                if encoder is not None and type(data) is bytes \
                        and n <= self._BATCH_COALESCE_LIMIT:
                    # native run: consecutive small bytes frames
                    j, total = i, 0
                    while j < nf:
                        d = frames[j]
                        if type(d) is not bytes:
                            break
                        ln = len(d)
                        if ln > self._BATCH_COALESCE_LIMIT or \
                                total + ln + 4 > enc_cap:
                            break
                        total += ln + 4
                        j += 1
                    if j - i > 1:
                        if buf:
                            await self._flush(buf)
                            buf = bytearray()
                        enc = encoder.encode(frames[i:j])
                        if enc is not None:
                            try:
                                await self._flush(enc)
                            finally:
                                enc.release()
                            i = j
                            continue
                        # encode failed (shouldn't): python path
                if n <= self._BATCH_COALESCE_LIMIT:
                    buf += _LEN.pack(n)
                    buf += data
                    if len(buf) >= self._BATCH_COALESCE_LIMIT:
                        await self._flush(buf)
                        buf = bytearray()
                else:
                    # large frame: one vectored flush hands any coalesced
                    # small-frame run + the header + the first chunk to
                    # the stream together (no separate 4-byte write);
                    # remaining chunks flush one timeout window each so
                    # slow links get a window per chunk, not per payload
                    view = memoryview(data)
                    chunk = 4 * self._BATCH_COALESCE_LIMIT
                    head = [_LEN.pack(n), view[:chunk]]
                    if buf:
                        head.insert(0, buf)
                        buf = bytearray()
                    await self._flush_v(head)
                    for off in range(chunk, n, chunk):
                        await self._flush(view[off:off + chunk])
                i += 1
            if buf:
                await self._flush(buf)
        finally:
            for entry in batch:
                if entry is _CLOSE:
                    continue
                p = entry[0]
                if type(p) is list:
                    for x in p:
                        if isinstance(x, Bytes):
                            x.release()
                elif isinstance(p, Bytes):
                    p.release()
        batch.clear()
        for done in dones:
            if not done.done():
                done.set_result(None)
        if close_after:
            await self._stream.close()
            return True
        return False

    # One bulk read per wakeup, then parse every complete frame out of the
    # carry buffer — the old two-awaits-per-frame loop spent ~70% of small-
    # frame time in per-frame asyncio machinery (timeout contexts, wakeups).
    _READ_CHUNK = 256 * 1024

    async def _put_recv(self, item) -> None:
        """Queue parsed frames, releasing their permits if the put is
        interrupted (a cancelled put never inserts — without this, a reader
        cancelled while blocked on a full bounded queue leaks pool bytes)."""
        q = self._recv_q
        if q.maxsize <= 0:
            # unbounded (the common case): skip the awaited put's
            # coroutine round-trip (~1 us per wakeup on the hot drain).
            # Bounded queues keep the awaited path: blocked putters then
            # drain in FIFO among themselves and cannot be starved
            # indefinitely by a put_nowait loop (asyncio.Queue gives no
            # hard slot reservation — a racing new sender can still win
            # the freed slot in the wakeup window, same as always).
            q.put_nowait(item)
            return
        try:
            await self._recv_q.put(item)
        except BaseException:
            if type(item) is Bytes or type(item) is FrameChunk:
                item.release()
            else:
                for b in item:
                    b.release()
            raise

    async def _reader_loop(self) -> None:
        buf = bytearray()
        scanner = native.FrameScanner.create()
        pool = self._limiter.pool
        try:
            while True:
                # The per-frame 5 s read timeout (mod.rs:336) now applies to
                # "progress while a partial frame is pending": a blocked
                # empty buffer waits forever, a half-received frame doesn't.
                if buf:
                    async with asyncio.timeout(READ_TIMEOUT_S):
                        chunk = await self._stream.read_some(self._READ_CHUNK)
                else:
                    chunk = await self._stream.read_some(self._READ_CHUNK)

                # Whole-chunk zero-copy fast path: when the carry buffer is
                # empty and the read chunk ends exactly on a frame boundary
                # (the steady state against a batching writer — one egress
                # flush arrives as one chunk), the chunk object ITSELF
                # becomes the FrameChunk buffer: no carry append, no detach
                # copy. Frames' bytes are then copied exactly once end to
                # end (at decode), like the reference's Bytes-slicing reader.
                if not buf and len(chunk) >= 8 and type(chunk) is bytes:
                    (first_len,) = _LEN.unpack_from(chunk, 0)
                    if first_len <= MAX_MESSAGE_SIZE \
                            and len(chunk) >= 4 + first_len:
                        if scanner is not None and len(chunk) >= 4096:
                            offs, lens, consumed, oversized = scanner.scan(
                                chunk, MAX_MESSAGE_SIZE)
                        else:
                            offs, lens, consumed, oversized = _py_scan_frames(
                                chunk, MAX_MESSAGE_SIZE)
                        if consumed == len(chunk) and not oversized and not (
                                scanner is not None
                                and len(offs) == scanner.max_frames):
                            chunk_permit = None
                            if pool is not None \
                                    and consumed <= pool.capacity:
                                chunk_permit = pool.try_allocate(consumed)
                            if pool is None or chunk_permit is not None:
                                self._m_recv.inc(consumed)
                                await self._put_recv(FrameChunk(
                                    chunk, offs, lens, chunk_permit))
                                continue
                            # pool pressure: the carry path's partial-
                            # handoff machinery below handles it
                buf += chunk

                # Depth-1 fast path (the latency regime): the chunk completed
                # exactly one frame — hand the bare Bytes to the receive
                # queue, skipping the scanner, the batch list, and the
                # pending-deque indirection on the consumer side.
                blen = len(buf)
                if blen >= 4:
                    (length,) = _LEN.unpack_from(buf, 0)
                    if length <= MAX_MESSAGE_SIZE and blen == 4 + length:
                        payload = bytes(memoryview(buf)[4:])
                        permit = None
                        if pool is not None:
                            permit = pool.try_allocate(length)
                            if permit is None:
                                self.flightrec.record("limiter-wait", length)
                                permit = await pool.allocate(length)
                        del buf[:]
                        self._m_recv.inc(blen)
                        await self._put_recv(Bytes(payload, permit))
                        continue

                # Scan every complete frame out of the carry buffer (one C
                # call via native.scan_frames when available) and hand the
                # whole batch to the receive queue in ONE put — per-frame
                # asyncio machinery is what bounded small-frame throughput.
                while len(buf) >= 4:
                    # Peek the first header before scanning: a buffer that
                    # cannot hold one complete frame (the large-frame partial
                    # case) must not pay a scan — the tail streamer below
                    # takes it directly.
                    (first_len,) = _LEN.unpack_from(buf, 0)
                    if first_len > MAX_MESSAGE_SIZE:
                        raise Error(ErrorKind.EXCEEDED_SIZE,
                                    f"peer announced {first_len} B frame")
                    if len(buf) < 4 + first_len:
                        break
                    if scanner is not None and len(buf) >= 4096:
                        offs, lens, consumed, oversized = scanner.scan(
                            buf, MAX_MESSAGE_SIZE)
                    else:
                        # tiny buffers (one or two frames — the latency
                        # regime) scan faster in Python than via ctypes
                        offs, lens, consumed, oversized = _py_scan_frames(
                            buf, MAX_MESSAGE_SIZE)
                    # The peek guarantees at least one complete frame, so the
                    # scan always yields offsets.
                    chunk_permit = None
                    if pool is not None and consumed <= pool.capacity:
                        chunk_permit = pool.try_allocate(consumed)
                    if pool is None or chunk_permit is not None:
                        # Fast path: ONE detached buffer + ONE permit for
                        # the whole parse batch (per-frame Bytes/permits are
                        # what bounded small-frame receive throughput).
                        chunk = FrameChunk(bytes(memoryview(buf)[:consumed]),
                                           offs, lens, chunk_permit)
                        self._m_recv.inc(consumed)
                        del buf[:consumed]
                        await self._put_recv(chunk)
                    else:
                        # Pool pressure: fall back to per-frame permits with
                        # partial handoff — consumers releasing the frames
                        # we already queued are what refill the pool, and a
                        # blocked permit still stops further socket reads.
                        batch: List[Bytes] = []
                        try:
                            mv = memoryview(buf)
                            try:
                                for o, ln in zip(offs, lens):
                                    payload = bytes(mv[o:o + ln])
                                    permit = pool.try_allocate(ln)
                                    if permit is None:
                                        self.flightrec.record(
                                            "limiter-wait", ln)
                                        if batch:
                                            # hand ownership over BEFORE
                                            # the await: a cancelled
                                            # _put_recv releases the frames
                                            # itself, and the outer handler
                                            # must not see them again
                                            handoff, batch = batch, []
                                            await self._put_recv(handoff)
                                        permit = await pool.allocate(ln)
                                    batch.append(Bytes(payload, permit))
                            finally:
                                mv.release()
                        except BaseException:
                            for b in batch:
                                b.release()
                            raise
                        self._m_recv.inc(consumed)
                        if batch:
                            await self._put_recv(
                                batch[0] if len(batch) == 1 else batch)
                        del buf[:consumed]
                    if oversized:
                        # a LATER announced length beyond MAX_MESSAGE_SIZE ⇒
                        # peer violation (preceding good frames were
                        # delivered first)
                        (length,) = _LEN.unpack_from(buf, 0)
                        raise Error(ErrorKind.EXCEEDED_SIZE,
                                    f"peer announced {length} B frame")
                    if scanner is not None and len(offs) == scanner.max_frames:
                        continue  # scanner capacity hit: rescan remainder
                    break

                # Remainder is at most one incomplete frame (at offset 0):
                # acquire the pool permit BEFORE buffering the payload
                # (mod.rs:328 — backpressure lands on the socket), then
                # stream straight into one preallocated buffer, one
                # progress-timeout window per chunk.
                blen = len(buf)
                if blen >= 4:
                    (length,) = _LEN.unpack_from(buf, 0)
                    permit = None
                    if pool is not None:
                        permit = pool.try_allocate(length)
                        if permit is None:
                            self.flightrec.record("limiter-wait", length)
                            permit = await pool.allocate(length)
                    try:
                        out = bytearray(length)
                        pos = blen - 4
                        out[:pos] = memoryview(buf)[4:blen]
                        del buf[:]
                        mv = memoryview(out)
                        try:
                            while pos < length:
                                async with asyncio.timeout(READ_TIMEOUT_S):
                                    chunk = await self._stream.read_some(
                                        min(length - pos, 4 * self._READ_CHUNK))
                                mv[pos:pos + len(chunk)] = chunk
                                pos += len(chunk)
                        finally:
                            mv.release()
                    except BaseException:
                        if permit is not None:
                            permit.release()
                        raise
                    self._m_recv.inc(length + 4)
                    await self._put_recv(Bytes(out, permit))
        except asyncio.CancelledError:
            raise
        except asyncio.IncompleteReadError as exc:
            self._poison(Error(ErrorKind.CONNECTION, "peer closed", exc))
        except Error as err:
            self._poison(err)
        except Exception as exc:
            self._poison(Error(ErrorKind.CONNECTION, f"read failed: {exc!r}", exc))

    def _poison(self, err: Error) -> None:
        if self._error is None:
            self._error = err
        self._closed = True
        # flight recorder: a plain peer FIN is a normal lifecycle event; an
        # I/O failure, oversized frame, or mid-write cancel arms the
        # recorder so the trail hits the diagnostics log at teardown (and
        # right here for un-owned connections nobody will tear down)
        abnormal = err.message != "peer closed"
        self.flightrec.record("error", err.message, abnormal=abnormal)
        if abnormal:
            self.flightrec.maybe_dump(err.message)
        self._stream.abort()
        # Resolve blocked senders, but KEEP the receive side: frames that
        # arrived before the failure are still deliverable (TCP delivers
        # data queued ahead of a FIN; a reader that parses a chunk and hits
        # EOF in the same wakeup must not steal the parsed frames back).
        # The error marker queues BEHIND them; the owner's eventual
        # ``close()`` returns any never-consumed permits to the pool.
        self._drain_send_queue(err)
        # Ask a parked writer task to exit: a task blocked on the send
        # queue holds a reference to this connection forever, which would
        # keep the abandoned-handle finalizer (permit backstop) from ever
        # firing.
        if self._writer_task is not None and not self._writer_task.done():
            try:
                self._send_q.put_nowait(_CLOSE)
            except asyncio.QueueFull:
                self._writer_task.cancel()
        # Wake any blocked receiver. The queued marker is a traceback-free
        # clone: the original's traceback references the reader frame and
        # thus this connection, and the abandoned-handle finalizer holds
        # the queue — a full Error would cycle the connection through the
        # finalizer's own argument and keep GC from ever reclaiming an
        # abandoned handle (the exact leak the finalizer exists to stop).
        try:
            self._recv_q.put_nowait(Error(err.kind, err.message))
        except asyncio.QueueFull:
            pass

    def _drain_send_queue(self, err: Optional[Error]) -> None:
        while True:
            try:
                item = self._send_q.get_nowait()
            except asyncio.QueueEmpty:
                break
            if item is _CLOSE:
                continue
            self._account_dropped(item, err)
            payload, done = item[0], item[1]
            if type(payload) is list:
                for p in payload:
                    if isinstance(p, Bytes):
                        p.release()
            elif isinstance(payload, Bytes):
                payload.release()
            if done is not None and not done.done():
                if err is not None:
                    done.set_exception(err)
                else:
                    done.cancel()

    def _drain_queues(self, err: Optional[Error]) -> None:
        """Release every queued frame's pool permit (both directions). A
        closed connection must hand its bytes back to the global pool or
        fan-out clones leak permits until the broker stalls."""
        self._drain_send_queue(err)
        while self._recv_pending:
            item = self._recv_pending.popleft()
            if isinstance(item, (Bytes, FrameChunk)):
                item.release()
        while True:
            try:
                item = self._recv_q.get_nowait()
            except asyncio.QueueEmpty:
                break
            if isinstance(item, list):
                for p in item:
                    p.release()
            elif isinstance(item, (Bytes, FrameChunk)):
                item.release()

    def _check(self) -> None:
        if self._error is not None:
            raise self._error
        if self._closed:
            raise Error(ErrorKind.CONNECTION, "connection closed")

    # -- public API (parity mod.rs:223-306) ---------------------------------

    async def send_message(self, message: Message, flush: bool = False) -> None:
        await self.send_raw(serialize(message), flush=flush)

    async def send_raw(self, raw, flush: bool = False, cls: int = 0) -> None:
        """Queue a pre-serialized frame (``bytes`` or :class:`Bytes`).

        With ``flush=True``, wait until the frame hits the stream — used by
        handshakes; the hot path queues and returns (reference
        send_message_raw semantics).

        ``cls`` is the frame's flow class (flowclass taxonomy; 0/control
        default fits the protocol traffic this entry point mostly carries)
        — it rides the queue entry so the writer can account per-class
        queue delay and egress volume at dequeue.

        Inline fast path: a flushed small frame on an idle link is written
        directly from the caller's task (no writer-task wakeup, no done
        future) — one scheduling round instead of three per handshake
        message. Only taken when the send queue is empty AND the writer
        isn't mid-write (``_write_mutex``), so frames can never reorder or
        interleave; the mutex acquire is non-yielding in that state, which
        makes check-then-acquire atomic on the single loop.
        """
        self._check()
        if flush and self._send_q.empty() and not self._write_mutex.locked():
            data = raw.data if isinstance(raw, Bytes) else raw
            if type(data) is bytes and len(data) <= self._BATCH_COALESCE_LIMIT:
                await self._write_mutex.acquire()
                try:
                    one = bytearray(_LEN.pack(len(data)))
                    one += data
                    await self._flush(one)
                except asyncio.CancelledError:
                    # cancelled mid-write: part of the frame may already be
                    # on the stream (transports commit incrementally), so
                    # the link's framing can no longer be trusted — poison,
                    # exactly like the writer loop cancelled mid-flush
                    self._poison(Error(ErrorKind.CONNECTION,
                                       "send cancelled mid-write"))
                    raise
                except Exception as exc:
                    err = Error(ErrorKind.CONNECTION,
                                f"write failed: {exc!r}", exc)
                    self._poison(err)
                    raise err
                finally:
                    if isinstance(raw, Bytes):
                        raw.release()
                    self._write_mutex.release()
                # inline path: zero queue delay by construction, so only
                # the volume counters move
                metrics_mod.CLASS_FRAMES_OUT[cls & 3].inc()
                metrics_mod.CLASS_BYTES_OUT[cls & 3].inc(len(data) + 4)
                ledger_mod.on_transit(cls & 3, 1, self.ledger_peer)
                return
        done = asyncio.get_running_loop().create_future() if flush else None
        nb = (len(raw.data) if isinstance(raw, Bytes) else len(raw)) + 4
        stamp = (time.monotonic(), cls & 3, 1, nb, 1)
        q = self._send_q
        if q.maxsize <= 0:
            # unbounded (the default): skip the awaited put's coroutine
            # round-trip on the hot path. Bounded queues keep the awaited
            # path: blocked senders queue FIFO among themselves rather
            # than losing every freed slot to a put_nowait fast path
            # (asyncio.Queue has no hard slot reservation, so a racing
            # sender can still occasionally win the wakeup window).
            q.put_nowait((raw, done, stamp))
        else:
            await q.put((raw, done, stamp))
        ledger_mod.note_queued(cls & 3, 1)
        self._ensure_writer()
        if self._error is not None:  # poisoned while enqueueing
            raise self._error
        if done is not None:
            await done

    def send_raw_nowait(self, raw, cls: int = 2) -> None:
        """Queue a frame without awaiting; raises ``asyncio.QueueFull`` when
        the per-connection queue bound is hit (callers treat that as a
        failed send). Used by the device-plane egress so one backpressured
        peer can't stall the pump (hence the ``live`` class default)."""
        self._check()
        cls &= 3
        nb = (len(raw.data) if isinstance(raw, Bytes) else len(raw)) + 4
        try:
            self._send_q.put_nowait(
                (raw, None, (time.monotonic(), cls, 1, nb, 1)))
        except asyncio.QueueFull:
            self.flightrec.record("backpressure", "send queue full")
            raise
        ledger_mod.note_queued(cls, 1)
        self._ensure_writer()
        if self._error is not None:
            raise self._error

    async def send_raw_many(self, raws: list, flush: bool = False,
                            cls: int = 2, nframes=None, nbytes=None) -> None:
        """Queue a whole batch of pre-serialized frames as ONE queue entry
        (one writer wakeup for the lot) — the routing loops build per-peer
        batches and hand them over here.

        ``cls``/``nframes``/``nbytes`` stamp the entry for per-class
        accounting: ``None`` means count the batch here (len + byte walk);
        a caller that already accounted its frames per-class (mixed-class
        plan bincounts) passes ``nframes=0, nbytes=0`` so the writer only
        observes the queue delay.

        Ownership semantics are stricter than :meth:`send_raw`: every
        :class:`Bytes` in ``raws`` is ALWAYS released by this connection —
        by the writer after flushing, by the poison drain, or right here
        when the frames never made it into the queue — so callers must not
        release on failure (no double-release of fan-out clones)."""
        try:
            self._check()
            done = asyncio.get_running_loop().create_future() if flush else None
        except BaseException:
            for p in raws:
                if isinstance(p, Bytes):
                    p.release()
            raise
        if nframes is None:
            nframes = len(raws)
        if nbytes is None:
            nbytes = sum(len(p.data) if isinstance(p, Bytes) else len(p)
                         for p in raws) + 4 * len(raws)
        stamp = (time.monotonic(), cls & 3, nframes, nbytes, len(raws))
        try:
            q = self._send_q
            if q.maxsize <= 0:
                q.put_nowait((raws, done, stamp))  # unbounded: no coroutine hop
                ledger_mod.note_queued(cls & 3, len(raws))
                self._ensure_writer()
            else:
                await q.put((raws, done, stamp))  # bounded: behind waiters
                ledger_mod.note_queued(cls & 3, len(raws))
                self._ensure_writer()
        except BaseException:
            # cancelled while blocked on a bounded queue: never inserted
            for p in raws:
                if isinstance(p, Bytes):
                    p.release()
            raise
        if self._error is not None:
            # poisoned around the enqueue: the poison drain may have run
            # before our insert landed, so drain again (idempotent) to
            # guarantee the batch's permits return to the pool
            self._drain_queues(self._error)
            raise self._error
        if done is not None:
            await done

    def send_encoded_nowait(self, data, owner=None, cls: int = 2,
                            nframes: int = 0, nbytes=None,
                            count: Optional[int] = None) -> None:
        """Queue an ALREADY length-delimited byte stream (one or many
        frames, each u32-BE-prefixed) to be written verbatim — the
        device-plane egress path: the native engine frames a whole step's
        deliveries per user in C, so the writer's only job is the flush.
        ``data`` may be a memoryview over the step's shared egress buffer;
        pass the buffer's holder (e.g. the ``EgressStreams``) as ``owner``
        so a pooled buffer cannot be recycled under the pending write.

        The stream is opaque here (already framed), so callers that know
        the frame count pass ``nframes``; ``nbytes`` defaults to the
        stream's length (header bytes included — it IS the wire image).
        ``count`` is the REAL frame count for the conservation ledger
        when ``nframes`` deliberately stays 0 (class volume pre-counted
        at the routing decision); it defaults to ``nframes``."""
        self._check()
        if nbytes is None:
            nbytes = len(data)
        stamp = (time.monotonic(), cls & 3, nframes, nbytes,
                 nframes if count is None else count)
        try:
            self._send_q.put_nowait((PreEncoded(data, owner), None, stamp))
        except asyncio.QueueFull:
            self.flightrec.record("backpressure", "send queue full")
            raise
        ledger_mod.note_queued(cls & 3, stamp[4])
        self._ensure_writer()
        if self._error is not None:
            raise self._error

    async def send_encoded(self, data, owner=None, flush: bool = False,
                           cls: int = 2, nframes: int = 0,
                           nbytes=None, count: Optional[int] = None) -> None:
        """Awaited twin of :meth:`send_encoded_nowait`: queues behind a
        bounded send queue instead of raising ``QueueFull`` — the routing
        loops' pre-encoded egress handoff (one writer entry, one verbatim
        flush for a whole per-peer fan-out batch)."""
        self._check()
        done = asyncio.get_running_loop().create_future() if flush else None
        if nbytes is None:
            nbytes = len(data)
        real = nframes if count is None else count
        q = self._send_q
        entry = (PreEncoded(data, owner), done,
                 (time.monotonic(), cls & 3, nframes, nbytes, real))
        if q.maxsize <= 0:
            q.put_nowait(entry)  # unbounded: no coroutine hop
        else:
            await q.put(entry)
        ledger_mod.note_queued(cls & 3, real)
        self._ensure_writer()
        if self._error is not None:
            raise self._error
        if done is not None:
            await done

    def send_raw_many_nowait(self, raws: list, cls: int = 2,
                             nframes=None, nbytes=None) -> None:
        """Batch variant of :meth:`send_raw_nowait` (one entry, no await),
        with :meth:`send_raw_many`'s ownership rule: the frames are always
        released by the connection, never by the caller."""
        try:
            self._check()
            if nframes is None:
                nframes = len(raws)
            if nbytes is None:
                nbytes = sum(len(p.data) if isinstance(p, Bytes) else len(p)
                             for p in raws) + 4 * len(raws)
            self._send_q.put_nowait(
                (raws, None,
                 (time.monotonic(), cls & 3, nframes, nbytes, len(raws))))
            ledger_mod.note_queued(cls & 3, len(raws))
            self._ensure_writer()
        except BaseException:
            for p in raws:
                if isinstance(p, Bytes):
                    p.release()
            raise
        if self._error is not None:
            self._drain_queues(self._error)
            raise self._error

    async def recv_message(self) -> Message:
        """Receive + decode one message, copying payload views out of the
        receive buffer so the pool permit can be released immediately. Hot
        paths that fan raw frames out should use :meth:`recv_raw` and
        release after the last send instead."""
        raw = await self.recv_raw()
        try:
            return deserialize_owned(raw.data)
        finally:
            raw.release()

    async def recv_raw(self) -> Bytes:
        """Receive one frame as refcounted :class:`Bytes` (permit attached)."""
        pending = self._recv_pending
        while not pending:
            if self._error is not None and self._recv_q.empty():
                raise self._error
            item = await self._recv_q.get()
            if type(item) is Bytes:  # depth-1 fast path: bare frame
                return item
            if type(item) is FrameChunk:
                pending.append(item)
                break
            if isinstance(item, Error):
                # keep the poison visible to subsequent callers
                try:
                    self._recv_q.put_nowait(item)
                except asyncio.QueueFull:
                    pass
                raise item
            pending.extend(item)
        head = pending[0]
        if type(head) is FrameChunk:
            b = head.take()
            if head.remaining == 0:
                pending.popleft()
            return b
        return pending.popleft()

    async def _fill_pending(self, limit: int) -> None:
        """Block until at least one frame is pending, then opportunistically
        drain whatever else is already queued (up to ~``limit`` frames)."""
        pending = self._recv_pending
        while not pending:
            if self._error is not None and self._recv_q.empty():
                raise self._error
            item = await self._recv_q.get()
            if type(item) is Bytes or type(item) is FrameChunk:
                pending.append(item)
                break
            if isinstance(item, Error):
                try:
                    self._recv_q.put_nowait(item)
                except asyncio.QueueFull:
                    pass
                raise item
            pending.extend(item)
        count = sum(i.remaining if type(i) is FrameChunk else 1
                    for i in pending)
        while count < limit:
            try:
                item = self._recv_q.get_nowait()
            except asyncio.QueueEmpty:
                break
            if type(item) is Bytes:
                pending.append(item)
                count += 1
                continue
            if type(item) is FrameChunk:
                pending.append(item)
                count += item.remaining
                continue
            if isinstance(item, Error):
                # deliver the batch first; the error surfaces on the next call
                try:
                    self._recv_q.put_nowait(item)
                except asyncio.QueueFull:
                    pass
                break
            pending.extend(item)
            count += len(item)

    async def recv_raw_many(self, limit: int = 4096) -> List[Bytes]:
        """Receive every frame currently available (at least one; blocks
        only when none are pending). The routing loops drain with this so
        one task wakeup routes a whole parse batch."""
        await self._fill_pending(limit)
        pending = self._recv_pending
        out: List[Bytes] = []
        while pending and len(out) < limit:
            head = pending[0]
            if type(head) is FrameChunk:
                while head.remaining and len(out) < limit:
                    out.append(head.take())
                if head.remaining == 0:
                    pending.popleft()
            else:
                out.append(pending.popleft())
        return out

    async def recv_frames(self, limit: int = 4096) -> list:
        """Receive pending traffic as a list of :class:`Bytes` and
        :class:`FrameChunk` items — the zero-materialization drain for
        consumers that process whole batches (``Client.receive_messages``).
        ``limit`` is approximate: the last chunk is handed over whole.
        The caller owns every item: ``release()`` each when done."""
        await self._fill_pending(limit)
        pending = self._recv_pending
        out: list = []
        count = 0
        while pending and count < limit:
            head = pending.popleft()
            count += head.remaining if type(head) is FrameChunk else 1
            out.append(head)
        return out

    async def soft_close(self) -> None:
        """Flush queued frames, then close the write side (parity
        ``soft_close``, protocols/mod.rs — QUIC does a real finish/stopped
        dance; for byte streams this is flush+FIN)."""
        if self._error is not None:
            raise self._error
        self._closed = True
        self.flightrec.record("close", "soft")
        if self._writer_task is None:
            # nothing was ever queued: flush is trivially done — close the
            # write side directly (under the mutex so an in-flight inline
            # write completes first)
            try:
                async with asyncio.timeout(WRITE_TIMEOUT_S):
                    async with self._write_mutex:
                        await self._stream.close()
            except Exception:
                pass
            self._reader_task.cancel()
            return
        await self._send_q.put(_CLOSE)
        try:
            async with asyncio.timeout(WRITE_TIMEOUT_S):
                await asyncio.shield(self._writer_task)
        except (asyncio.TimeoutError, asyncio.CancelledError, Error):
            pass
        except Exception:
            pass
        self._reader_task.cancel()

    def close(self) -> None:
        """Tear down immediately (abort both tasks, return queued permits)."""
        self._closed = True
        self.flightrec.record("close", "abort")
        if self._writer_task is not None:
            self._writer_task.cancel()
        self._reader_task.cancel()
        self._stream.abort()
        self._drain_queues(self._error)

    @property
    def is_closed(self) -> bool:
        return self._closed or self._error is not None


class UnfinalizedConnection(abc.ABC):
    """An accepted-but-not-ready connection; ``finalize`` completes any
    handshake and spawns the actor tasks (parity mod.rs:64-81 — accept is
    kept cheap so one slow handshake can't stall the accept loop)."""

    @abc.abstractmethod
    async def finalize(self, limiter: Limiter = NO_LIMIT) -> Connection: ...


class Listener(abc.ABC):
    """Bound server socket: ``accept`` yields unfinalized connections."""

    @abc.abstractmethod
    async def accept(self) -> UnfinalizedConnection: ...

    @abc.abstractmethod
    async def close(self) -> None: ...


class Protocol(abc.ABC):
    """A transport implementation (parity ``Protocol`` trait, mod.rs:40-63)."""

    name: str = "?"

    @classmethod
    @abc.abstractmethod
    async def connect(cls, endpoint: str, use_local_authority: bool = True,
                      limiter: Limiter = NO_LIMIT) -> Connection: ...

    @classmethod
    @abc.abstractmethod
    async def bind(cls, endpoint: str, certificate=None,
                   reuse_port: bool = False) -> Listener:
        """``reuse_port=True`` requests SO_REUSEPORT so N worker shards
        can bind the same endpoint and let the kernel spread accepts
        (transports without a kernel socket — Memory — reject it)."""
