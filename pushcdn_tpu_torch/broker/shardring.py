"""Shared-memory handoff ring for the sharded data plane (worker shards).

One **SPSC** (single-producer / single-consumer) byte ring per *directed*
shard pair, backed by ``multiprocessing.shared_memory``. The producer is
the origin shard's drain (cut-through ``_send_plan`` or the scalar
``EgressBatch`` flush); the consumer is the destination shard's ring-drain
task. A record carries **already-encoded wire bytes** (u32-BE
length-delimited frames, exactly what arrived on the origin's socket)
plus a compact per-peer frame-index list — the "RPC Considered Harmful"
rule applied to our own interior boundary: the bytes the data plane
already holds in transmittable form cross the process boundary verbatim,
never re-serialized. The consumer slices per-peer streams out of the
record (zero-copy ``memoryview`` for contiguous index runs) and hands
them straight to the egress writers via ``PreEncoded``; a
:class:`SlotLease` rides each writer entry's ``owner`` seat so the ring
slot is reclaimed only after the LAST pending flush drops it (the
shard-pair analog of ``proto.limiter.BytesLease``).

Layout (offsets in bytes, all integers little-endian):

- header (64 B): ``u64 head`` (producer cursor, absolute, monotonic),
  ``u64 tail`` (consumer cursor), ``u64 dropped`` (producer-side
  ring-full fallbacks), ``u64 seq`` (next record sequence number),
  ``u64 poisoned`` (consumer abandoned the ring — a record never
  committed; the producer must stop pushing and use the relay);
- data region: records are contiguous (never wrap mid-record — a record
  that would cross the end is preceded by a PAD record covering the
  remainder).

Record: ``u32 total_len`` (header+body, 8-aligned), ``u32 commit``
(``COMMIT_FLAG | (seq & 0x7fffffff)``, written LAST — a reader seeing
anything else under an advanced ``head`` has caught a torn write and
backs off), then the body::

    u32 n_frames   u32 n_peers
    frame table:   n_frames x (u32 off, u32 len)      # off into payload
    peer table:    n_peers  x (u8 kind, u8 pad, u16 ident_len,
                               u32 n_idx, ident bytes, n_idx x u32)
    payload:       wire bytes (each frame u32-BE length-prefixed)

``try_push`` never blocks: a full ring returns False and bumps
``dropped`` — the caller's contract is a *counted* fallback to the
control-plane relay path, not a stalled drain.

The port's copy of ``pushcdn_tpu.broker.shardring`` (standard library
only): the layout is the same byte for byte, so a record one package
writes is one the other reads.
"""

from __future__ import annotations

import socket
import struct
from collections import deque
from multiprocessing import shared_memory
from typing import Dict, List, Optional, Sequence, Tuple

_HDR = struct.Struct("<QQQQ")          # head, tail, dropped, seq
_REC = struct.Struct("<II")            # total_len, commit
_BODY = struct.Struct("<II")           # n_frames, n_peers
_FRAME = struct.Struct("<II")          # off, len
_PEER = struct.Struct("<BBHI")         # kind, pad, ident_len, n_idx
HEADER_BYTES = 64

COMMIT_FLAG = 0x8000_0000
PAD_MAGIC = 0x7F7F_7F7F                # commit word of a PAD record

KIND_USER = 0
KIND_BROKER = 1

DEFAULT_CAPACITY = 4 * 1024 * 1024


class RingRecord:
    """One drained record: per-peer targets over a shared payload view.

    ``peers`` is ``[(kind, ident, idx_list)]``; :meth:`stream_for` builds
    the wire stream for one peer — a zero-copy memoryview of the shm
    payload when the peer's frame indices form a consecutive increasing
    run (frames are stored back-to-back in table order, so consecutive
    indices ARE contiguous bytes), else one gather copy in idx order.
    """

    __slots__ = ("peers", "payload", "frame_offs", "frame_lens", "_lease")

    def __init__(self, peers, payload, frame_offs, frame_lens, lease):
        self.peers = peers
        self.payload = payload          # memoryview into the shm slot
        self.frame_offs = frame_offs
        self.frame_lens = frame_lens
        self._lease = lease

    def stream_for(self, idx: Sequence[int]):
        first, last = idx[0], idx[-1]
        n = len(idx)
        # zero-copy only for a STRICTLY consecutive run (first, first+1,
        # ..., last): frames sit back-to-back in table order, so such a
        # run is one byte span. The O(1) span test alone is NOT enough —
        # a same-span permutation like [0, 2, 1, 3] (emitted when a peer
        # shares frames first indexed by an earlier peer in the batch)
        # must gather in idx order, or the slice would silently reorder
        # this peer's frames. n <= 2 needs no scan (span == n pins both
        # elements); longer runs confirm with one C-level range compare
        # instead of a per-frame Python loop.
        if last - first + 1 == n and (
                n <= 2 or list(idx) == list(range(first, last + 1))):
            return self.payload[self.frame_offs[first]:
                                self.frame_offs[last] + self.frame_lens[last]]
        return b"".join(
            bytes(self.payload[self.frame_offs[i]:
                               self.frame_offs[i] + self.frame_lens[i]])
            for i in idx)

    def lease(self) -> "LeaseRef":
        """One keep-alive reference for a pending flush (rides the writer
        entry's ``owner`` seat; releases on GC like ``BytesLease``)."""
        return LeaseRef(self._lease)

    def release(self) -> None:
        """The consumer's own reference: call once dispatch is done (the
        peers' pending flushes keep their own :meth:`lease` refs). Also
        drops the payload view so the shm segment can close even while
        this record object is still referenced (stream slices taken via
        :meth:`stream_for` are independent views and stay valid)."""
        self._lease.drop()
        try:
            self.payload.release()
        except BufferError:
            pass


class SlotLease:
    """Refcounted keep-alive for one consumed record's shm bytes: the
    consumer holds one reference while dispatching; every pending egress
    flush holds one more. When the LAST drops, the owning reader is told
    the slot is done and advances ``tail`` over the done prefix
    (reclamation is in-order — the ring is a FIFO)."""

    __slots__ = ("reader", "end_cursor", "refs", "done")

    def __init__(self, reader: "RingReader", end_cursor: int):
        self.reader = reader
        self.end_cursor = end_cursor
        self.refs = 1
        self.done = False

    def drop(self) -> None:
        self.refs -= 1
        if self.refs <= 0 and not self.done:
            self.done = True
            self.reader._reclaim()

    def __del__(self):
        # GC backstop (e.g. a RingRecord discarded before release())
        if not self.done:
            self.done = True
            try:
                self.reader._reclaim()
            except Exception:
                pass


class LeaseRef:
    """One holder's reference on a :class:`SlotLease` — dropped when this
    object is garbage-collected (it rides ``PreEncoded.owner``, whose
    entry the writer drops right after the flush completes)."""

    __slots__ = ("_lease",)

    def __init__(self, lease: SlotLease):
        lease.refs += 1
        self._lease = lease

    def __del__(self):
        lease, self._lease = self._lease, None
        if lease is not None:
            try:
                lease.drop()
            except Exception:
                pass


def _align8(n: int) -> int:
    return (n + 7) & ~7


class _RingBase:
    def __init__(self, shm: shared_memory.SharedMemory, capacity: int,
                 owns: bool):
        self.shm = shm
        self.capacity = capacity
        self._owns = owns
        self.buf = shm.buf

    # -- header accessors (aligned 8-byte fields; x86 keeps these single
    # stores, and the commit-word protocol catches any torn read anyway) --

    def _get(self, off: int) -> int:
        return int.from_bytes(self.buf[off:off + 8], "little")

    def _set(self, off: int, value: int) -> None:
        self.buf[off:off + 8] = value.to_bytes(8, "little")

    @property
    def head(self) -> int:
        return self._get(0)

    @property
    def tail(self) -> int:
        return self._get(8)

    @property
    def dropped(self) -> int:
        return self._get(16)

    @property
    def poisoned(self) -> bool:
        return self._get(32) != 0

    def poison(self) -> None:
        """Consumer-side: mark the ring abandoned so the producer's next
        ``try_push`` fails over to the relay instead of silently feeding
        a ring nobody drains (a stalled-then-resumed producer would
        otherwise count path=ring deliveries that vanish)."""
        self._set(32, 1)

    def close(self) -> None:
        self.buf = None
        try:
            self.shm.close()
        except Exception:
            pass
        if self._owns:
            try:
                self.shm.unlink()
            except Exception:
                pass


def ring_capacity(capacity: int) -> int:
    """Clamp a requested capacity to the ring's alignment contract (a
    multiple of 8 — record totals and pads are 8-aligned so a record
    header can never straddle the wrap point)."""
    return max(capacity & ~7, 4096)


def create_ring(capacity: int = DEFAULT_CAPACITY) -> str:
    """Allocate one ring's shared memory (parent does this once per
    directed shard pair); returns the shm name both ends attach by."""
    capacity = ring_capacity(capacity)
    shm = shared_memory.SharedMemory(create=True,
                                     size=HEADER_BYTES + capacity)
    shm.buf[:HEADER_BYTES] = bytes(HEADER_BYTES)
    # the creator handle is closed immediately; writer/reader re-attach
    # by name. unlink stays the supervisor's job (unlink_ring).
    shm.close()
    return shm.name


def unlink_ring(name: str) -> None:
    try:
        shm = shared_memory.SharedMemory(name=name)
        shm.close()
        shm.unlink()
    except Exception:
        pass


class RingWriter(_RingBase):
    """The producer end (exactly one per directed pair, owned by the
    origin shard's event loop — never call from two tasks concurrently
    without external ordering; the broker's single loop provides it)."""

    def __init__(self, name: str, capacity: int,
                 notify_sock: Optional[socket.socket] = None):
        shm = shared_memory.SharedMemory(name=name)
        super().__init__(shm, ring_capacity(capacity), owns=False)
        self._notify = notify_sock
        self.records_pushed = 0
        self.frames_pushed = 0
        self.bytes_pushed = 0

    def note_dropped(self) -> None:
        self._set(16, self.dropped + 1)

    def try_push(self, frames: List, peers: List[Tuple[int, bytes,
                                                       Sequence[int]]],
                 prefixed: bool = False) -> bool:
        """Write one record. ``frames`` are frame buffers — raw payloads
        (the writer adds the u32-BE wire prefix) or, with
        ``prefixed=True``, already wire-framed slices copied verbatim.
        ``peers[i] = (kind, ident_bytes, frame_index_list)``. Returns
        False (and counts the drop) when the ring lacks space — the
        caller falls back to the control-plane relay."""
        if self.poisoned:
            self.note_dropped()
            return False
        n_frames = len(frames)
        n_peers = len(peers)
        flens = [len(f) + (0 if prefixed else 4) for f in frames]
        payload_len = sum(flens)
        peer_bytes = sum(_PEER.size + len(p[1]) + 4 * len(p[2])
                         for p in peers)
        body = _BODY.size + _FRAME.size * n_frames + peer_bytes + payload_len
        total = _align8(_REC.size + body)
        head, tail = self.head, self.tail
        cap = self.capacity
        avail = cap - (head - tail)
        pos = head % cap
        to_end = cap - pos
        # capacity and every record length are multiples of 8, so a
        # needed pad is always >= _REC.size — the PAD header always fits
        pad = to_end if total > to_end else 0
        if total + pad > avail:
            self.note_dropped()
            return False
        buf = self.buf
        base = HEADER_BYTES
        if pad:
            _REC.pack_into(buf, base + pos, pad, PAD_MAGIC)
            head += pad
            pos = 0
        start = base + pos
        seq = self._get(24)
        off = start + _REC.size
        _BODY.pack_into(buf, off, n_frames, n_peers)
        off += _BODY.size
        # frame table
        fo = 0
        for ln in flens:
            _FRAME.pack_into(buf, off, fo, ln)
            fo += ln
            off += _FRAME.size
        # peer table
        for kind, ident, idx in peers:
            _PEER.pack_into(buf, off, kind, 0, len(ident), len(idx))
            off += _PEER.size
            buf[off:off + len(ident)] = ident
            off += len(ident)
            for i in idx:
                buf[off:off + 4] = int(i).to_bytes(4, "little")
                off += 4
        # payload
        if prefixed:
            for f in frames:
                ln = len(f)
                buf[off:off + ln] = f
                off += ln
        else:
            for f in frames:
                ln = len(f)
                buf[off:off + 4] = ln.to_bytes(4, "big")
                off += 4
                buf[off:off + ln] = f
                off += ln
        # commit word LAST, then publish head — a reader that sees the
        # advanced head before the commit store has landed detects the
        # torn state from the commit word and retries
        _REC.pack_into(buf, start, total, 0)
        buf[start + 4:start + 8] = (COMMIT_FLAG
                                    | (seq & 0x7FFF_FFFF)).to_bytes(
                                        4, "little")
        self._set(24, seq + 1)
        self._set(0, head + total)
        if self.poisoned:
            # the consumer abandoned the ring while we were mid-push:
            # the record just committed will never be drained (orphaned
            # but harmless) — report failure so the caller relays
            # instead of counting a path=ring delivery that vanishes
            self.note_dropped()
            return False
        self.records_pushed += 1
        self.frames_pushed += n_frames
        self.bytes_pushed += payload_len
        if self._notify is not None:
            # notify EVERY push, not just empty->nonempty transitions:
            # "empty" judged via tail races the consumer's lease-deferred
            # reclamation (tail lags while an egress flush pins the oldest
            # slot), and a push in that window would otherwise never wake
            # the consumer again. The consumer drains the socket wholesale
            # per wakeup; a full buffer (EAGAIN) means wakeups are already
            # pending, so dropping the byte is safe.
            try:
                self._notify.send(b"\x01")
            except (BlockingIOError, OSError):
                pass
        return True


class RingReader(_RingBase):
    """The consumer end. :meth:`drain` parses committed records into
    :class:`RingRecord` views; slots are reclaimed in order as their
    leases drop (:class:`SlotLease`)."""

    def __init__(self, name: str, capacity: int):
        shm = shared_memory.SharedMemory(name=name)
        super().__init__(shm, ring_capacity(capacity), owns=False)
        self._cursor = self.tail      # private read cursor (>= tail)
        self._pending: deque = deque()  # SlotLeases in ring order
        self.torn_reads = 0
        self.records_drained = 0

    def _reclaim(self) -> None:
        advanced = False
        while self._pending and self._pending[0].done:
            lease = self._pending.popleft()
            self._set(8, lease.end_cursor)
            advanced = True
        if advanced and not self._pending:
            # fully drained: tail == cursor
            pass

    def drain(self, max_records: int = 64) -> List[RingRecord]:
        """Parse up to ``max_records`` committed records. A torn record
        (head advanced but commit word not yet visible / corrupted) stops
        the drain — counted, retried on the next wakeup."""
        out: List[RingRecord] = []
        buf = self.buf
        base = HEADER_BYTES
        cap = self.capacity
        while len(out) < max_records:
            head = self.head
            cur = self._cursor
            if cur >= head:
                break
            pos = cur % cap
            total, commit = _REC.unpack_from(buf, base + pos)
            if commit == PAD_MAGIC:
                self._cursor = cur + total
                # pads reclaim immediately when they're the oldest
                lease = SlotLease(self, self._cursor)
                lease.done = True
                self._pending.append(lease)
                self._reclaim()
                continue
            if not (commit & COMMIT_FLAG) or total < _REC.size \
                    or total > cap or pos + total > cap:
                self.torn_reads += 1
                break
            start = base + pos + _REC.size
            try:
                n_frames, n_peers = _BODY.unpack_from(buf, start)
                off = start + _BODY.size
                frame_offs = [0] * n_frames
                frame_lens = [0] * n_frames
                for i in range(n_frames):
                    frame_offs[i], frame_lens[i] = _FRAME.unpack_from(
                        buf, off)
                    off += _FRAME.size
                peers = []
                for _ in range(n_peers):
                    kind, _pad, ident_len, n_idx = _PEER.unpack_from(
                        buf, off)
                    off += _PEER.size
                    ident = bytes(buf[off:off + ident_len])
                    off += ident_len
                    idx = [int.from_bytes(buf[off + 4 * k:off + 4 * k + 4],
                                          "little") for k in range(n_idx)]
                    off += 4 * n_idx
                    peers.append((kind, ident, idx))
                payload_start = off
                payload_end = base + pos + total
                if payload_start > payload_end or any(
                        o + ln > payload_end - payload_start
                        for o, ln in zip(frame_offs, frame_lens)) or any(
                        i >= n_frames for _, _, idx in peers for i in idx):
                    raise ValueError("corrupt record")
            except (struct.error, ValueError):
                self.torn_reads += 1
                break
            self._cursor = cur + total
            lease = SlotLease(self, self._cursor)
            self._pending.append(lease)
            out.append(RingRecord(
                peers, memoryview(buf)[payload_start:payload_end],
                frame_offs, frame_lens, lease))
            self.records_drained += 1
        return out

    @property
    def backlog(self) -> int:
        return self.head - self._cursor


def notify_pair() -> Tuple[socket.socket, socket.socket]:
    """(rx, tx) non-blocking datagram pair: producers send one byte per
    empty→nonempty transition; the consumer's event loop watches rx."""
    rx, tx = socket.socketpair(socket.AF_UNIX, socket.SOCK_DGRAM)
    rx.setblocking(False)
    tx.setblocking(False)
    return rx, tx


def stats_dict(writers: Dict[int, RingWriter],
               readers: Dict[int, RingReader]) -> dict:
    """Operator-facing ring summary for /debug/topology."""
    return {
        "out": {str(dst): {"records": w.records_pushed,
                           "frames": w.frames_pushed,
                           "bytes": w.bytes_pushed,
                           "dropped": w.dropped,
                           "backlog_bytes": w.head - w.tail}
                for dst, w in writers.items()},
        "in": {str(src): {"records": r.records_drained,
                          "torn_reads": r.torn_reads,
                          "backlog_bytes": r.backlog}
               for src, r in readers.items()},
    }
