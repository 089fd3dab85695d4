"""ctypes binding for the fused data-plane pump (``pump.cpp`` beside this
file).

The pump library COMPOSES the two native layers below it: it is compiled
from a TU that includes ``io_uring.cpp`` and ``route_plan.cpp`` (``-I`` on
this directory, never on another package's sources), and at runtime it
operates on handles those libraries created — the transport engine's
``Ring._h`` (a ``pcu_ring*``) and the planner's ``RoutePlanner._handle``
(a ``RouteTable*``). That interop is sound because the structs carry all
state (no library globals), every .so is built from the same sources
with the same flags, and allocation goes through the shared libc. The
library's file name hashes all three sources
(``pushcdn_tpu_torch.native.INCLUDES``), so an edit to either included
source builds a new pump, never loads a stale one.

The port's own copy of ``pushcdn_tpu.native.pump``. Policy (which peers
engage, fencing, lease parking, submit scheduling) lives in
``proto/transport/pump.py``; this module is the thin typed surface plus
per-instance scratch so the hot calls allocate nothing.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from pushcdn_tpu_torch.native import SRC_DIR, _build_lib, _ptr

NAME = "pump"
FLAGS = ("-I", str(SRC_DIR))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_u64 = ctypes.c_ulonglong
_i64 = ctypes.c_longlong
_u64p = ctypes.POINTER(_u64)
_i64p = ctypes.POINTER(_i64)
_i32p = ctypes.POINTER(ctypes.c_int)
_u32p = ctypes.POINTER(ctypes.c_uint)
_longp = ctypes.POINTER(ctypes.c_long)

# route_chunk out_meta indices (mirrors the C comment block)
META_CONSUMED = 0
META_STOP = 1
META_N_RESID = 2
META_CHUNK_SLOT = 3
META_REFS = 4
META_SQES = 5
META_PAIRS = 6
META_USER_PAIRS = 7
META_BROKER_PAIRS = 8
META_RESID_UNMAPPED = 9
META_RESID_FENCED = 10
META_RESID_ERROR = 11
META_NO_CHUNK_SLOT = 12
META_RUNS = 13
META_PLAN_PAIRS = 14

# drain/inject event triple types
EV_PEER_IDLE = 1
EV_PEER_ERROR = 2
EV_PEER_QUIESCED = 3

STATS_KEYS = ("runs", "chains", "sqes", "cqes", "bytes", "frames",
              "errors", "short_repump", "engaged", "fenced",
              "chunk_slots_free", "queued_runs", "ev_lost")


def _compile() -> Optional[ctypes.CDLL]:
    lib = _build_lib(NAME, ctypes.CDLL, FLAGS)
    if lib is None:
        return None
    P = ctypes.c_void_p
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.pushcdn_pump_create.restype = P
    lib.pushcdn_pump_create.argtypes = [P, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_long]
    lib.pushcdn_pump_destroy.restype = None
    lib.pushcdn_pump_destroy.argtypes = [P]
    lib.pushcdn_pump_add_peer.restype = ctypes.c_int
    lib.pushcdn_pump_add_peer.argtypes = [P, ctypes.c_int]
    lib.pushcdn_pump_set_fence.restype = None
    lib.pushcdn_pump_set_fence.argtypes = [P, ctypes.c_int, ctypes.c_int]
    lib.pushcdn_pump_peer_pending.restype = ctypes.c_long
    lib.pushcdn_pump_peer_pending.argtypes = [P, ctypes.c_int]
    lib.pushcdn_pump_peer_stats.restype = None
    lib.pushcdn_pump_peer_stats.argtypes = [P, ctypes.c_int, _i64p]
    lib.pushcdn_pump_drop_peer.restype = ctypes.c_int
    lib.pushcdn_pump_drop_peer.argtypes = [P, ctypes.c_int]
    lib.pushcdn_pump_take_released.restype = ctypes.c_long
    lib.pushcdn_pump_take_released.argtypes = [P, _i32p, ctypes.c_long]
    lib.pushcdn_pump_set_slots.restype = ctypes.c_int
    lib.pushcdn_pump_set_slots.argtypes = [P, _i32p, ctypes.c_long]
    lib.pushcdn_pump_route_chunk.restype = _i64
    lib.pushcdn_pump_route_chunk.argtypes = [
        P, P, u8p, _i64, _i64p, _i64p, _i64, _i64, ctypes.c_int,
        _i32p, _i32p, _i64, _i64p, u8p]
    lib.pushcdn_pump_drain.restype = ctypes.c_int
    lib.pushcdn_pump_drain.argtypes = [P, _u64p, _i32p, _u32p,
                                       ctypes.c_int, _i64p, ctypes.c_long,
                                       _longp, _longp]
    lib.pushcdn_pump_inject_cqe.restype = ctypes.c_int
    lib.pushcdn_pump_inject_cqe.argtypes = [P, ctypes.c_int, ctypes.c_int,
                                            _i64p, ctypes.c_long, _longp]
    lib.pushcdn_pump_stats.restype = None
    lib.pushcdn_pump_stats.argtypes = [P, _u64p]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is None and not _tried:
        with _lock:
            if _lib is None and not _tried:
                _lib = _compile()
                _tried = True
    return _lib


def available() -> bool:
    return _get() is not None


_CQ_BATCH = 512
_EV_CAP = 3 * 256  # 256 peer-state triples per drain: far above need


class NativePump:
    """One pump instance bound to one engine ring. Event-loop-thread only
    (the same affinity as the ``Ring`` it drives).

    Lifecycle contract the caller (``proto/transport/pump.py``) must
    keep: drain :meth:`take_released` after EVERY call that can release
    chunk slots (:meth:`drain`, :meth:`inject_cqe`, :meth:`drop_peer`)
    and before the next :meth:`route_chunk` — a freed slot is eligible
    for reuse, so an undrained release would alias the next chunk's
    lease parking.
    """

    __slots__ = ("_lib", "_h", "_ring", "pair_cap", "chunk_slots",
                 "_resid_peer", "_resid_frame", "_meta", "_uds", "_ress",
                 "_flagss", "_events", "_released", "_stats", "_pstats",
                 "_n_events", "_n_prepped", "_frame_cls")

    def __init__(self, lib, handle, ring, pair_cap: int, chunk_slots: int):
        self._lib = lib
        self._h = handle
        self._ring = ring
        self.pair_cap = pair_cap
        self.chunk_slots = chunk_slots
        self._resid_peer = np.zeros(pair_cap, np.int32)
        self._resid_frame = np.zeros(pair_cap, np.int32)
        self._meta = np.zeros(16, np.int64)
        self._uds = (_u64 * _CQ_BATCH)()
        self._ress = (ctypes.c_int * _CQ_BATCH)()
        self._flagss = (ctypes.c_uint * _CQ_BATCH)()
        self._events = (_i64 * _EV_CAP)()
        self._released = (ctypes.c_int * chunk_slots)()
        self._stats = (_u64 * 16)()
        self._pstats = (_i64 * 6)()
        self._n_events = ctypes.c_long(0)
        self._n_prepped = ctypes.c_long(0)
        self._frame_cls = np.zeros(1024, np.uint8)

    @classmethod
    def create(cls, ring, max_peers: int = 4096, chunk_slots: int = 64,
               sq_reserve: int = 64,
               pair_cap: int = 65536) -> Optional["NativePump"]:
        """Bind a pump to ``ring`` (a ``native.uring.Ring``). Returns
        None when the library is unavailable or creation fails.
        ``sq_reserve`` SQ entries are kept back from pumped chains so
        the Python engine can always prep its own control traffic."""
        lib = _get()
        if lib is None or ring is None or getattr(ring, "closed", True):
            return None
        h = lib.pushcdn_pump_create(ring._h, max_peers, chunk_slots,
                                    sq_reserve, pair_cap)
        if not h:
            return None
        return cls(lib, h, ring, pair_cap, chunk_slots)

    def destroy(self) -> None:
        if self._h:
            self._lib.pushcdn_pump_destroy(self._h)
            self._h = None

    @property
    def closed(self) -> bool:
        return not self._h

    # -- peers --

    def add_peer(self, fd: int) -> int:
        return int(self._lib.pushcdn_pump_add_peer(self._h, fd))

    def set_fence(self, pid: int, fenced: bool) -> None:
        self._lib.pushcdn_pump_set_fence(self._h, pid, 1 if fenced else 0)

    def peer_pending(self, pid: int) -> int:
        return int(self._lib.pushcdn_pump_peer_pending(self._h, pid))

    def peer_stats(self, pid: int) -> dict:
        self._lib.pushcdn_pump_peer_stats(self._h, pid, self._pstats)
        s = self._pstats
        return {"q_len": int(s[0]), "inflight": int(s[1]),
                "fenced": bool(s[2]), "err": int(s[3]),
                "dead": bool(s[4]), "in_use": bool(s[5])}

    def drop_peer(self, pid: int) -> int:
        """1 = slot freed now, 0 = frees when inflight CQEs quiesce."""
        return int(self._lib.pushcdn_pump_drop_peer(self._h, pid))

    def take_released(self) -> list:
        out = []
        while True:
            n = int(self._lib.pushcdn_pump_take_released(
                self._h, self._released, self.chunk_slots))
            out.extend(self._released[i] for i in range(n))
            if n < self.chunk_slots:
                return out

    def set_slots(self, slots: np.ndarray) -> bool:
        slots = np.ascontiguousarray(slots, np.int32)
        rc = self._lib.pushcdn_pump_set_slots(
            self._h, _ptr(slots, ctypes.c_int), len(slots))
        return rc == 0

    # -- hot path --

    def route_chunk(self, table_handle, buf, offs: np.ndarray,
                    lens: np.ndarray, start: int, mode: int):
        """Plan + pump one chunk. Returns ``(consumed, stop,
        resid_peers, resid_frames, meta)`` where the resid arrays are
        int32 VIEWS over instance scratch (consume before the next
        call) and ``meta`` is the int64[16] out_meta view.

        Per-frame flow classes land in the ``frame_classes`` scratch
        (absolute frame index; 255 = consumed, delivered to no one)."""
        arr = np.frombuffer(buf, np.uint8)
        count = len(offs) - start
        if len(self._frame_cls) < len(offs):
            self._frame_cls = np.zeros(
                max(len(offs), 2 * len(self._frame_cls)), np.uint8)
        consumed = self._lib.pushcdn_pump_route_chunk(
            self._h, table_handle, _ptr(arr, ctypes.c_uint8), len(arr),
            _ptr(offs, _i64), _ptr(lens, _i64), start, count, mode,
            _ptr(self._resid_peer, ctypes.c_int),
            _ptr(self._resid_frame, ctypes.c_int),
            self.pair_cap, _ptr(self._meta, _i64),
            _ptr(self._frame_cls, ctypes.c_uint8))
        meta = self._meta
        n_resid = int(meta[META_N_RESID])
        return (int(consumed), int(meta[META_STOP]),
                self._resid_peer[:n_resid], self._resid_frame[:n_resid],
                meta)

    @property
    def frame_classes(self) -> np.ndarray:
        """Per-frame flow classes from the last ``route_chunk`` (absolute
        frame index; only [start, start+consumed) meaningful)."""
        return self._frame_cls

    def drain(self):
        """Drain the ring's CQ through the pump. Returns ``(cqes,
        events, n_prepped)``: ``cqes`` is the non-pump completions as
        (user_data, res, flags) tuples for the engine's dispatcher,
        ``events`` the flat (type, pid, arg) triples, and ``n_prepped``
        the SQEs the chain sweep staged (schedule a submit when > 0).
        Mirrors ``Ring.peek_cqes``'s CQ-overflow flush."""
        cqes, events = [], []
        n_prepped = 0
        while True:
            n = int(self._lib.pushcdn_pump_drain(
                self._h, self._uds, self._ress, self._flagss, _CQ_BATCH,
                self._events, _EV_CAP, ctypes.byref(self._n_events),
                ctypes.byref(self._n_prepped)))
            n_prepped += int(self._n_prepped.value)
            ne = int(self._n_events.value)
            for i in range(0, ne, 3):
                events.append((int(self._events[i]),
                               int(self._events[i + 1]),
                               int(self._events[i + 2])))
            uds, ress, flagss = self._uds, self._ress, self._flagss
            cqes.extend((uds[i], ress[i], flagss[i]) for i in range(n))
            if n < _CQ_BATCH and ne < _EV_CAP:
                break
        ring = self._ring
        if not cqes and ring is not None and not ring.closed \
                and ring._lib.pcu_cq_overflowed(ring._h):
            ring._lib.pcu_flush_overflow(ring._h)
            ring.enters += 1
            n = int(self._lib.pushcdn_pump_drain(
                self._h, self._uds, self._ress, self._flagss, _CQ_BATCH,
                self._events, _EV_CAP, ctypes.byref(self._n_events),
                ctypes.byref(self._n_prepped)))
            n_prepped += int(self._n_prepped.value)
            ne = int(self._n_events.value)
            for i in range(0, ne, 3):
                events.append((int(self._events[i]),
                               int(self._events[i + 1]),
                               int(self._events[i + 2])))
            uds, ress, flagss = self._uds, self._ress, self._flagss
            cqes.extend((uds[i], ress[i], flagss[i]) for i in range(n))
        return cqes, events, n_prepped

    def inject_cqe(self, pid: int, res: int) -> list:
        """Test hook: feed one synthetic completion for peer ``pid``
        through the pump's accounting; returns the event triples."""
        rc = int(self._lib.pushcdn_pump_inject_cqe(
            self._h, pid, res, self._events, _EV_CAP,
            ctypes.byref(self._n_events)))
        if rc != 0:
            raise ValueError(f"inject_cqe: bad peer id {pid}")
        ne = int(self._n_events.value)
        return [(int(self._events[i]), int(self._events[i + 1]),
                 int(self._events[i + 2])) for i in range(0, ne, 3)]

    def stats(self) -> dict:
        self._lib.pushcdn_pump_stats(self._h, self._stats)
        return {k: int(self._stats[i]) for i, k in enumerate(STATS_KEYS)}
