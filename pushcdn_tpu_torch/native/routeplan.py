"""ctypes binding for the batch route plan (``route_plan.cpp`` beside
this file).

The routine is the cut-through routing plane's core: one C call scans a
``FrameChunk``'s frame headers in place, matches Broadcast topic bitmasks
against an interest-table snapshot and Direct recipients against a
DirectMap hash snapshot, and returns a flat (peer, frame) fan-out pair
list. A second call gathers one peer's frames into a wire-ready
length-delimited buffer. Snapshot lifecycle (when to rebuild, how peers
map to connections) is the caller's job — see
``pushcdn_tpu_torch.broker.tasks.cutthrough``.

The port's own copy of ``pushcdn_tpu.native.routeplan``: the library
builds from this directory's source with ``g++`` at first use, like the
rest of ``native``. Same degradation contract: ``RoutePlanner.create``
returns None when the library can't compile or load, and callers fall
back to the scalar routing path. Uses numpy and ctypes only (a broker
without a device plane imports it without importing torch).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np

from pushcdn_tpu_torch.native import _build_lib

NAME = "route_plan"

_lock = threading.Lock()
_lib = None
_tried = False

MASK_WORDS = 4  # 4 x u64 = the full u8 topic space

# plan() stop reasons (mirrors route_plan.cpp)
STOP_END = 0       # whole range planned
STOP_RESIDUAL = 1  # next frame is control/malformed: scalar path owns it
STOP_CAPACITY = 2  # pair buffer full: call again from the returned index


def _compile():
    lib = _build_lib(NAME, ctypes.CDLL)
    if lib is None:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.pushcdn_route_table_create.restype = ctypes.c_void_p
    lib.pushcdn_route_table_create.argtypes = []
    lib.pushcdn_route_table_destroy.restype = None
    lib.pushcdn_route_table_destroy.argtypes = [ctypes.c_void_p]
    lib.pushcdn_route_table_build.restype = ctypes.c_int32
    lib.pushcdn_route_table_build.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        u64p, u64p, u8p, i64p, i32p, i32p, ctypes.c_int32]
    lib.pushcdn_route_table_apply.restype = ctypes.c_int32
    lib.pushcdn_route_table_apply.argtypes = [
        ctypes.c_void_p, i32p, u64p, ctypes.c_int32,
        u8p, i64p, i32p, i32p, ctypes.c_int32]
    lib.pushcdn_route_table_stats.restype = None
    lib.pushcdn_route_table_stats.argtypes = [ctypes.c_void_p, i64p]
    lib.pushcdn_route_table_set_classes.restype = ctypes.c_int32
    lib.pushcdn_route_table_set_classes.argtypes = [ctypes.c_void_p, u8p]
    lib.pushcdn_route_plan.restype = ctypes.c_int64
    lib.pushcdn_route_plan.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_int64, i64p, i64p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        i32p, i32p, ctypes.c_int64, i64p, i32p, u8p]
    lib.pushcdn_route_gather.restype = ctypes.c_int64
    lib.pushcdn_route_gather.argtypes = [
        u8p, ctypes.c_int64, i64p, i64p, i32p, ctypes.c_int64,
        u8p, ctypes.c_int64]
    return lib


def _get():
    global _lib, _tried
    if _lib is None and not _tried:
        with _lock:
            if _lib is None and not _tried:
                _lib = _compile()
                _tried = True
    return _lib


def available() -> bool:
    """Whether the route-plan library built and loaded (building it on the
    first call)."""
    return _get() is not None

def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def topic_mask(topics) -> np.ndarray:
    """Pack an iterable of u8 topics into the kernel's [4] u64 bitmask."""
    mask = np.zeros(MASK_WORDS, np.uint64)
    for t in topics:
        t = int(t)
        if 0 <= t <= 255:
            mask[t >> 6] |= np.uint64(1 << (t & 63))
    return mask


class RoutePlanner:
    """One routing-snapshot handle + reusable plan scratch buffers.

    Not thread-safe (the broker's event loop owns it); the snapshot is
    rebuilt by the caller whenever routing state changes — see
    ``cutthrough.RouteState``.
    """

    __slots__ = ("_lib", "_handle", "_pair_peer", "_pair_frame",
                 "_frame_cls", "n_users", "n_brokers")

    def __init__(self, lib, handle):
        self._lib = lib
        self._handle = handle
        self._pair_peer = np.zeros(4096, np.int32)
        self._pair_frame = np.zeros(4096, np.int32)
        self._frame_cls = np.zeros(1024, np.uint8)
        self.n_users = 0
        self.n_brokers = 0

    @classmethod
    def create(cls) -> Optional["RoutePlanner"]:
        lib = _get()
        if lib is None:
            return None
        handle = lib.pushcdn_route_table_create()
        if not handle:
            return None
        return cls(lib, handle)

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle and self._lib is not None:
            try:
                self._lib.pushcdn_route_table_destroy(handle)
            except Exception:
                pass

    def build(self, n_users: int, n_brokers: int, valid_mask: np.ndarray,
              peer_masks: np.ndarray, direct_keys: List[bytes],
              direct_owners: np.ndarray) -> bool:
        """Install a snapshot: ``peer_masks`` is u64[P, 4] interest
        bitmasks (users first, then brokers); ``direct_keys[i]`` routes to
        peer ``direct_owners[i]``. Returns False on allocation failure
        (the caller must fall back to scalar routing)."""
        self.n_users = int(n_users)
        self.n_brokers = int(n_brokers)
        n = len(direct_keys)
        lens = np.fromiter(map(len, direct_keys), np.int32, count=n) \
            if n else np.zeros(1, np.int32)
        offs = np.zeros(max(n, 1), np.int64)
        if n:
            np.cumsum(lens[:-1], dtype=np.int64, out=offs[1:n])
        blob = b"".join(direct_keys)
        blob_arr = np.frombuffer(blob, np.uint8) if blob \
            else np.zeros(1, np.uint8)
        owners = np.ascontiguousarray(direct_owners, np.int32) \
            if n else np.zeros(1, np.int32)
        peer_masks = np.ascontiguousarray(peer_masks, np.uint64)
        valid_mask = np.ascontiguousarray(valid_mask, np.uint64)
        rc = self._lib.pushcdn_route_table_build(
            self._handle,
            self.n_users, self.n_brokers,
            _ptr(valid_mask, ctypes.c_uint64),
            _ptr(peer_masks, ctypes.c_uint64),
            _ptr(blob_arr, ctypes.c_uint8), _ptr(offs, ctypes.c_int64),
            _ptr(lens, ctypes.c_int32), _ptr(owners, ctypes.c_int32), n)
        return rc == 0

    def apply(self, upd_peers, upd_masks, direct_keys: List[bytes],
              direct_owners) -> bool:
        """Apply one delta batch IN PLACE: ``upd_peers[i]`` gets
        the absolute interest mask ``upd_masks[i]`` (u64[4]; zeros free the
        slot), and ``direct_keys[i]`` is upserted to peer
        ``direct_owners[i]`` (or tombstoned when the owner is ``-1``).
        O(delta) — the stored masks are the diff base. Returns False on
        allocation failure / out-of-range slot (the caller must fall back
        to a full rebuild)."""
        n_upd = len(upd_peers)
        peers = np.ascontiguousarray(upd_peers, np.int32) if n_upd \
            else np.zeros(1, np.int32)
        masks = np.ascontiguousarray(upd_masks, np.uint64) if n_upd \
            else np.zeros(MASK_WORDS, np.uint64)
        n = len(direct_keys)
        lens = np.fromiter(map(len, direct_keys), np.int32, count=n) \
            if n else np.zeros(1, np.int32)
        offs = np.zeros(max(n, 1), np.int64)
        if n:
            np.cumsum(lens[:-1], dtype=np.int64, out=offs[1:n])
        blob = b"".join(direct_keys)
        blob_arr = np.frombuffer(blob, np.uint8) if blob \
            else np.zeros(1, np.uint8)
        owners = np.ascontiguousarray(direct_owners, np.int32) \
            if n else np.zeros(1, np.int32)
        rc = self._lib.pushcdn_route_table_apply(
            self._handle,
            _ptr(peers, ctypes.c_int32), _ptr(masks, ctypes.c_uint64),
            n_upd,
            _ptr(blob_arr, ctypes.c_uint8), _ptr(offs, ctypes.c_int64),
            _ptr(lens, ctypes.c_int32), _ptr(owners, ctypes.c_int32), n)
        return rc == 0

    def stats(self) -> dict:
        """Occupancy/garbage counters (the compaction-policy inputs)."""
        out = np.zeros(8, np.int64)
        self._lib.pushcdn_route_table_stats(self._handle,
                                            _ptr(out, ctypes.c_int64))
        return {"n_users": int(out[0]), "n_brokers": int(out[1]),
                "live_subs": int(out[2]), "list_entries": int(out[3]),
                "dmap_live": int(out[4]), "dmap_tombstones": int(out[5]),
                "keys_blob_bytes": int(out[6]),
                "keys_blob_garbage": int(out[7])}

    def set_classes(self, classes: np.ndarray) -> bool:
        """Install the topic -> flow-class map (u8[256], values 0..3 per
        ``proto.flowclass``). Survives ``build``/``apply``: the taxonomy
        is deployment config, not routing state."""
        table = np.ascontiguousarray(classes, np.uint8)
        if table.shape != (256,):
            return False
        return self._lib.pushcdn_route_table_set_classes(
            self._handle, _ptr(table, ctypes.c_uint8)) == 0

    def _ensure_pairs(self, need: int) -> None:
        if len(self._pair_peer) < need:
            cap = max(need, 2 * len(self._pair_peer))
            self._pair_peer = np.zeros(cap, np.int32)
            self._pair_frame = np.zeros(cap, np.int32)

    def _ensure_classes(self, need: int) -> None:
        if len(self._frame_cls) < need:
            cap = max(need, 2 * len(self._frame_cls))
            self._frame_cls = np.zeros(cap, np.uint8)

    def plan(self, buf: bytes, offs: np.ndarray, lens: np.ndarray,
             start: int, mode: int
             ) -> Tuple[int, int, np.ndarray, np.ndarray]:
        """Plan frames [start, len(offs)) of one chunk buffer.

        Returns (consumed, stop_reason, peer_idx, frame_idx) where the
        pair arrays are views into reusable scratch (valid until the next
        call). ``mode`` 0 = user-origin, 1 = broker-origin.

        Per-frame flow classes land in the ``frame_classes`` scratch
        (absolute frame index; 255 = consumed but delivered to no one),
        valid for the same window as the pair views."""
        count = len(offs) - start
        n_peers = self.n_users + self.n_brokers
        # capacity for the worst case (every frame fans to every peer)
        # is overkill; size for one guaranteed frame of progress plus a
        # typical batch, and let STOP_CAPACITY loop handle the rest
        self._ensure_pairs(max(n_peers + 1, 4096))
        self._ensure_classes(len(offs))
        arr = np.frombuffer(buf, np.uint8) if buf else np.zeros(1, np.uint8)
        n_pairs = ctypes.c_int64(0)
        stop = ctypes.c_int32(0)
        consumed = self._lib.pushcdn_route_plan(
            self._handle, _ptr(arr, ctypes.c_uint8), len(buf),
            _ptr(offs, ctypes.c_int64), _ptr(lens, ctypes.c_int64),
            start, count, mode,
            _ptr(self._pair_peer, ctypes.c_int32),
            _ptr(self._pair_frame, ctypes.c_int32),
            len(self._pair_peer), ctypes.byref(n_pairs), ctypes.byref(stop),
            _ptr(self._frame_cls, ctypes.c_uint8))
        if consumed < 0:
            return 0, STOP_RESIDUAL, self._pair_peer[:0], self._pair_frame[:0]
        k = n_pairs.value
        return (int(consumed), int(stop.value),
                self._pair_peer[:k], self._pair_frame[:k])

    @property
    def frame_classes(self) -> np.ndarray:
        """Per-frame flow classes from the last ``plan`` call, indexed by
        absolute frame index (only [start, start+consumed) meaningful)."""
        return self._frame_cls

    def gather(self, buf: bytes, offs: np.ndarray, lens: np.ndarray,
               frame_idx: np.ndarray) -> Optional[bytearray]:
        """Length-delimit one peer's fan-out frames into a fresh buffer
        (one C call, one copy — the cut-through egress handoff for
        non-contiguous index runs)."""
        total = int(lens[frame_idx].sum()) + 4 * len(frame_idx)
        out = bytearray(total)
        arr = np.frombuffer(buf, np.uint8) if buf else np.zeros(1, np.uint8)
        out_ptr = (ctypes.c_uint8 * total).from_buffer(out)
        idx = np.ascontiguousarray(frame_idx, np.int32)
        wrote = self._lib.pushcdn_route_gather(
            _ptr(arr, ctypes.c_uint8), len(buf),
            _ptr(offs, ctypes.c_int64), _ptr(lens, ctypes.c_int64),
            _ptr(idx, ctypes.c_int32), len(idx),
            ctypes.cast(out_ptr, ctypes.POINTER(ctypes.c_uint8)), total)
        del out_ptr
        if wrote != total:
            return None
        return out
