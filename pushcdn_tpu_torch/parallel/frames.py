"""Message frames as fixed-shape byte arrays plus metadata columns.

A batch of variable-length messages is packed into a fixed
``[SLOTS, FRAME_BYTES]`` uint8 array plus aligned metadata columns, so
routing runs as vectorised device ops instead of per-message Python:

- ``kind``       int32[S]  — the wire kind tag (KIND_DIRECT/KIND_BROADCAST)
- ``length``     int32[S]  — payload length in bytes (0 ⇒ empty slot)
- ``topic_mask`` uint32[S] or uint32[S, W] — broadcast interest bits
- ``dest``       int32[S]  — direct-recipient *user slot* (-1 for broadcast)
- ``valid``      bool[S]   — slot occupancy

A ``FrameRing`` has a fixed number of slots; ``push`` fails when it is
full, and the host stages only as many messages per step as there are
free slots. User identity on the device is a dense *user slot* index
managed by ``UserSlots`` (public key ↔ slot). On a mesh of broker
shards, direct frames stage into ``DirectBuckets`` keyed by the owner
shard instead.

The rings stay on the host (numpy): only the metadata columns are
uploaded for a step, and frame bytes egress from the ring snapshot.
``FrameRing.push_batch`` packs a batch with one native call
(``native.pack_frames_into``), and with the plain Python ``_put`` loop
when the native library is absent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from pushcdn_tpu_torch.proto.error import ErrorKind, bail
from pushcdn_tpu_torch.proto.message import KIND_BROADCAST, KIND_DIRECT

DEFAULT_FRAME_BYTES = 1024
DEFAULT_SLOTS = 1024

# The reference's topic type is a u8 — 256 possible topics. A topic set
# is a multi-word u32 bitmask; 8 words cover the full space.
TOPIC_WORDS_FULL = 8


def split_mask(mask: int, words: int) -> np.ndarray:
    """Split an arbitrary-width Python-int topic mask into u32 words
    (little-endian: word w holds topics 32w..32w+31)."""
    out = np.zeros(words, np.uint32)
    w = 0
    while mask and w < words:
        out[w] = mask & 0xFFFFFFFF
        mask >>= 32
        w += 1
    return out


def mask_of_topics(topics, words: int) -> int:
    """Python-int bitmask of every topic representable in ``words`` u32
    words; out-of-range topics are ignored (callers pre-check)."""
    mask = 0
    limit = 32 * words
    for t in topics:
        t = int(t)
        if t < limit:
            mask |= 1 << t
    return mask


def mask_mirror_shape(n: int, words: int):
    """Shape of an ``n``-slot topic-mask mirror/column: 1-D for the
    compact 1-word representation, [n, words] otherwise."""
    return n if words == 1 else (n, words)


def mask_row_of(topics, words: int):
    """The mask-mirror row for a topic set: a u32 scalar when ``words`` is
    1 or a uint32[words] row otherwise — assignable to ``mirror[slot]``."""
    mask = mask_of_topics(topics, words)
    return mask & 0xFFFFFFFF if words == 1 else split_mask(mask, words)


class UserSlots:
    """Dense user-slot allocator: public key ↔ int slot (device identity)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._key_to_slot: Dict[bytes, int] = {}
        self._slot_to_key: List[Optional[bytes]] = [None] * capacity
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        # 1 + highest slot ever assigned: the device plane slices its
        # state and delivery tensors to this mark
        self.high_water = 0

    def assign(self, public_key: bytes) -> int:
        slot = self._key_to_slot.get(public_key)
        if slot is not None:
            return slot
        if not self._free:
            bail(ErrorKind.EXCEEDED_SIZE,
                 f"user-slot table full ({self.capacity})")
        slot = self._free.pop()
        self._key_to_slot[public_key] = slot
        self._slot_to_key[slot] = public_key
        if slot + 1 > self.high_water:
            self.high_water = slot + 1
        return slot

    def release(self, public_key: bytes) -> None:
        slot = self.unmap(public_key)
        if slot is not None:
            self.free_slot(slot)

    def unmap(self, public_key: bytes) -> Optional[int]:
        """Drop the key↔slot mapping WITHOUT recycling the slot index —
        callers that may still have in-flight frames addressed to the slot
        quarantine it and call :meth:`free_slot` later."""
        slot = self._key_to_slot.pop(public_key, None)
        if slot is not None:
            self._slot_to_key[slot] = None
        return slot

    def free_slot(self, slot: int) -> None:
        """Return a previously :meth:`unmap`-ed slot index to the free list."""
        if self._slot_to_key[slot] is None and slot not in self._free:
            self._free.append(slot)

    def slot_of(self, public_key: bytes) -> Optional[int]:
        return self._key_to_slot.get(public_key)

    def key_of(self, slot: int) -> Optional[bytes]:
        return self._slot_to_key[slot]

    def __len__(self) -> int:
        return len(self._key_to_slot)


@dataclass
class FrameBatch:
    """One step's worth of packed ingress frames (numpy, host-side)."""

    bytes_: np.ndarray      # uint8[S, F]
    kind: np.ndarray        # int32[S]
    length: np.ndarray      # int32[S]
    topic_mask: np.ndarray  # uint32[S] or uint32[S, W]
    dest: np.ndarray        # int32[S]
    valid: np.ndarray       # bool[S]

    @property
    def num_valid(self) -> int:
        return int(self.valid.sum())


class FrameRing:
    """Fixed-capacity staging ring the host packs messages into.

    ``push_*`` returns False when no slot is free (backpressure: the caller
    keeps the message queued on the host). ``take_batch`` snapshots and
    clears the ring for one router step.
    """

    def __init__(self, slots: int = DEFAULT_SLOTS,
                 frame_bytes: int = DEFAULT_FRAME_BYTES,
                 topic_words: int = 1):
        self.slots = slots
        self.frame_bytes = frame_bytes
        self.topic_words = topic_words
        self._bytes = np.zeros((slots, frame_bytes), dtype=np.uint8)
        self._kind = np.zeros(slots, dtype=np.int32)
        self._length = np.zeros(slots, dtype=np.int32)
        self._topic_mask = np.zeros(mask_mirror_shape(slots, topic_words),
                                    dtype=np.uint32)
        self._dest = np.full(slots, -1, dtype=np.int32)
        self._valid = np.zeros(slots, dtype=bool)
        self._mask_rows: dict = {}  # mask int -> uint32[W] word expansion
        self._next = 0
        self._used = 0
        self._empty: Optional[FrameBatch] = None

    @property
    def free_slots(self) -> int:
        return self.slots - self._used

    def _alloc(self) -> Optional[int]:
        # slots fill sequentially and are only freed wholesale by
        # take_batch, so the cursor always points at a free slot
        if self._used >= self.slots:
            return None
        i = self._next
        self._next += 1
        self._used += 1
        return i

    def _put(self, i: int, payload: bytes, kind: int, topic_mask: int,
             dest: int) -> None:
        n = len(payload)
        self._bytes[i, :n] = np.frombuffer(payload, dtype=np.uint8)
        if n < self.frame_bytes:
            self._bytes[i, n:] = 0
        self._kind[i] = kind
        self._length[i] = n
        if self.topic_words == 1:
            self._topic_mask[i] = topic_mask & 0xFFFFFFFF
        else:
            self._topic_mask[i] = split_mask(topic_mask, self.topic_words)
        self._dest[i] = dest
        self._valid[i] = True

    def _check_size(self, payload: bytes) -> None:
        if len(payload) > self.frame_bytes:
            bail(ErrorKind.EXCEEDED_SIZE,
                 f"payload {len(payload)} B exceeds frame slot "
                 f"{self.frame_bytes} B; use the host path")

    def push_broadcast(self, payload: bytes, topic_mask: int) -> bool:
        self._check_size(payload)
        i = self._alloc()
        if i is None:
            return False
        self._put(i, payload, KIND_BROADCAST, topic_mask, -1)
        return True

    def push_direct(self, payload: bytes, dest_slot: int) -> bool:
        self._check_size(payload)
        i = self._alloc()
        if i is None:
            return False
        self._put(i, payload, KIND_DIRECT, 0, dest_slot)
        return True

    def push_batch(self, payloads: Sequence[bytes], kinds: Sequence[int],
                   tmasks: Sequence[int], dests: Sequence[int]) -> int:
        """Pack many messages at the current cursor (after any singly
        pushed frames) with one native call, writing straight into the
        ring's arrays; the Python ``_put`` loop when the native library
        is absent. Returns the number packed; fewer than
        ``len(payloads)`` means exactly "ring full — re-queue the rest".
        Oversized payloads raise ``ValueError`` up front, so the return
        value is never ambiguous between full and unroutable."""
        if not (len(kinds) == len(tmasks) == len(dests) == len(payloads)):
            raise ValueError("payloads/kinds/tmasks/dests length mismatch")
        if payloads and max(map(len, payloads)) > self.frame_bytes:
            i = next(i for i, p in enumerate(payloads)
                     if len(p) > self.frame_bytes)
            raise ValueError(
                f"payload {i} is {len(payloads[i])} B > frame slot "
                f"{self.frame_bytes} B; pre-filter to the host path")
        from pushcdn_tpu_torch import native
        start = self._next
        kinds_a = np.asarray(kinds, np.int32)
        dests_a = np.asarray(dests, np.int32)
        if self.topic_words == 1:
            try:  # C speed for in-range masks (the ≤32-topic contract)
                tmasks_a = np.fromiter(tmasks, np.uint32,
                                       count=len(payloads))
            except (OverflowError, ValueError, TypeError):
                tmasks_a = np.asarray(
                    [m & 0xFFFFFFFF for m in tmasks], np.uint32)
        else:
            W = self.topic_words
            tmasks_a = np.zeros((len(payloads), W), np.uint32)
            # memoised word expansion: a step's masks come from the few
            # distinct topic sets in flight, so each distinct mask is
            # expanded once (little-endian u32 words, as split_mask)
            rows = self._mask_rows
            allbits = (1 << (32 * W)) - 1

            def expand(m):
                # truncate first, as split_mask does: out-of-range or
                # negative masks must not overflow to_bytes
                m = int(m) & allbits
                row = rows.get(m)
                if row is None:
                    if len(rows) >= 4096:  # bound pathological churn
                        rows.clear()
                    row = rows[m] = np.frombuffer(
                        m.to_bytes(4 * W, "little"), np.uint32).copy()
                return row

            if not isinstance(tmasks, list):
                tmasks = list(tmasks)
            first = tmasks[0] if len(tmasks) else 0
            if tmasks.count(first) == len(tmasks):
                # one topic set for the whole batch (one publisher): a
                # single vectorised fill instead of a row per frame
                tmasks_a[:] = expand(first)
            else:
                for i, m in enumerate(tmasks):
                    tmasks_a[i] = expand(m)
        valid_u8 = np.zeros(self.slots - start, np.uint8)
        n = native.pack_frames_into(
            list(payloads), kinds_a, tmasks_a, dests_a,
            self._bytes[start:], self._kind[start:], self._length[start:],
            self._topic_mask[start:], self._dest[start:], valid_u8)
        if n is not None:
            self._valid[start:start + n] = True
            self._used += n
            self._next += n
            return n
        # the library is absent: the Python loop, same result
        n = 0
        for payload, k, tm, d in zip(payloads, kinds_a, list(tmasks),
                                     dests_a):
            i = self._alloc()
            if i is None:
                break
            self._put(i, payload, int(k), int(tm), int(d))
            n += 1
        return n

    def take_batch(self) -> FrameBatch:
        """Snapshot the ring as one step's batch and clear it. An idle ring
        returns a cached all-zero batch (batches are read-only
        downstream), so idle lanes cost no copy per step."""
        if self._used == 0:
            if self._empty is None:
                self._empty = empty_batch(self.slots, self.frame_bytes,
                                          self.topic_words)
            return self._empty
        batch = FrameBatch(
            bytes_=self._bytes.copy(), kind=self._kind.copy(),
            length=self._length.copy(), topic_mask=self._topic_mask.copy(),
            dest=self._dest.copy(), valid=self._valid.copy(),
        )
        self._valid[:] = False
        self._length[:] = 0
        self._used = 0
        self._next = 0
        return batch


@dataclass
class DirectBatch:
    """One step of per-destination-shard direct frames (axis 0 indexes the
    DESTINATION shard). The mesh step exchanges these with one
    ``all_to_all``: each frame travels once, to its owner shard, instead
    of riding the broadcast gather to every shard."""

    bytes_: np.ndarray   # uint8[B, C, F]
    length: np.ndarray   # int32[B, C]
    dest: np.ndarray     # int32[B, C] — user slot at the destination shard
    valid: np.ndarray    # bool[B, C]


class DirectBuckets:
    """Host staging for direct frames, bucketed by owner shard. The host
    knows the owner at staging time (the group's slot table), so bucketing
    is an append. A full bucket is per-link backpressure: only senders
    targeting that shard stall."""

    def __init__(self, num_shards: int, capacity: int = 64,
                 frame_bytes: int = DEFAULT_FRAME_BYTES):
        self.num_shards = num_shards
        self.capacity = capacity
        self.frame_bytes = frame_bytes
        self._bytes = np.zeros((num_shards, capacity, frame_bytes), np.uint8)
        self._length = np.zeros((num_shards, capacity), np.int32)
        self._dest = np.full((num_shards, capacity), -1, np.int32)
        self._valid = np.zeros((num_shards, capacity), bool)
        self._used = np.zeros(num_shards, np.int64)
        self._empty: Optional[DirectBatch] = None

    @property
    def total_used(self) -> int:
        return int(self._used.sum())

    @property
    def max_used(self) -> int:
        """Largest per-destination fill — the latency-slice eligibility
        check (every bucket's frames must fit the prefix slice)."""
        return int(self._used.max())

    def push(self, dest_shard: int, payload: bytes, dest_slot: int) -> bool:
        if len(payload) > self.frame_bytes:
            bail(ErrorKind.EXCEEDED_SIZE,
                 f"payload {len(payload)} B exceeds frame slot "
                 f"{self.frame_bytes} B; use the host path")
        i = int(self._used[dest_shard])
        if i >= self.capacity:
            return False  # this link is backpressured
        n = len(payload)
        self._bytes[dest_shard, i, :n] = np.frombuffer(payload, np.uint8)
        if n < self.frame_bytes:
            self._bytes[dest_shard, i, n:] = 0
        self._length[dest_shard, i] = n
        self._dest[dest_shard, i] = dest_slot
        self._valid[dest_shard, i] = True
        self._used[dest_shard] = i + 1
        return True

    def take_batch(self) -> DirectBatch:
        """Snapshot every bucket and clear them; an idle set returns a
        cached all-zero batch (read-only downstream)."""
        if self.total_used == 0:
            if self._empty is None:
                self._empty = empty_direct_batch(
                    self.num_shards, self.capacity, self.frame_bytes)
            return self._empty
        batch = DirectBatch(
            bytes_=self._bytes.copy(), length=self._length.copy(),
            dest=self._dest.copy(), valid=self._valid.copy())
        self._valid[:] = False
        self._length[:] = 0
        self._dest[:] = -1
        self._used[:] = 0
        return batch


def empty_direct_batch(num_shards: int, capacity: int,
                       frame_bytes: int) -> DirectBatch:
    return DirectBatch(
        bytes_=np.zeros((num_shards, capacity, frame_bytes), np.uint8),
        length=np.zeros((num_shards, capacity), np.int32),
        dest=np.full((num_shards, capacity), -1, np.int32),
        valid=np.zeros((num_shards, capacity), bool),
    )


def slice_batch(b: FrameBatch, n: int) -> FrameBatch:
    """Prefix-slice a batch to its first ``n`` slots (views, no copies):
    rings fill sequentially from slot 0, so when ``used <= n`` the prefix
    holds every staged frame."""
    return FrameBatch(
        bytes_=b.bytes_[:n], kind=b.kind[:n], length=b.length[:n],
        topic_mask=b.topic_mask[:n], dest=b.dest[:n], valid=b.valid[:n])


def slice_direct_batch(d: DirectBatch, n: int) -> DirectBatch:
    """Prefix-slice every destination bucket to ``n`` slots (views)."""
    return DirectBatch(
        bytes_=d.bytes_[:, :n], length=d.length[:, :n],
        dest=d.dest[:, :n], valid=d.valid[:, :n])


def stage_best_fit(lanes, size: int, push) -> bool:
    """Stage into the smallest lane a ``size``-byte frame fits, spilling to
    wider lanes when the best fit is full. ``lanes`` must be sorted
    ascending by ``frame_bytes``; ``push(lane)`` returns False when that
    lane is full. Returns False only when every eligible lane is full."""
    for lane in lanes:
        if size <= lane.frame_bytes and push(lane):
            return True
    return False


def empty_batch(slots: int, frame_bytes: int,
                topic_words: int = 1) -> FrameBatch:
    return FrameBatch(
        bytes_=np.zeros((slots, frame_bytes), np.uint8),
        kind=np.zeros(slots, np.int32),
        length=np.zeros(slots, np.int32),
        topic_mask=np.zeros(mask_mirror_shape(slots, topic_words),
                            np.uint32),
        dest=np.full(slots, -1, np.int32),
        valid=np.zeros(slots, bool),
    )
