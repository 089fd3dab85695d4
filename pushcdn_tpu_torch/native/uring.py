"""ctypes binding for the raw io_uring shim (``io_uring.cpp`` beside this
file).

The port's own copy of ``pushcdn_tpu.native.uring``, built like the rest
of ``native``: compiled on first use with ``g++`` into
``.build/torch_native/`` (the file name carries a hash of the source and
flags), and every failure path degrades
to "uring unavailable" — callers (the transport engine, benches, CI
probes) ask :func:`probe` and fall back to asyncio honestly.

The :class:`Ring` wrapper owns one kernel ring (one per event loop /
shard worker) and exposes the exact prep/submit/drain surface the
engine needs. It deliberately does NOT manage buffer lifetimes or
ordering: that policy lives in ``proto/transport/uring.py`` next to the
writer-queue contract it must preserve.
"""

from __future__ import annotations

import ctypes
import errno as _errno
import os
import threading
from typing import Optional

from pushcdn_tpu_torch.native import _build_lib

NAME = "io_uring"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False

# probe() results (cached once per process)
_probe_lock = threading.Lock()
_probe_result: Optional[int] = None

PROBE_ZC = 2  # bitmask bit: kernel supports IORING_OP_SEND_ZC

_u64 = ctypes.c_ulonglong
_u64p = ctypes.POINTER(_u64)
_i32p = ctypes.POINTER(ctypes.c_int)
_u32p = ctypes.POINTER(ctypes.c_uint)


def _compile() -> Optional[ctypes.CDLL]:
    lib = _build_lib(NAME, ctypes.CDLL)
    if lib is None:
        return None
    P = ctypes.c_void_p
    lib.pcu_probe.restype = ctypes.c_long
    lib.pcu_probe.argtypes = []
    lib.pcu_create.restype = P
    lib.pcu_create.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
                               _i32p]
    lib.pcu_destroy.restype = None
    lib.pcu_destroy.argtypes = [P]
    lib.pcu_ring_fd.restype = ctypes.c_int
    lib.pcu_ring_fd.argtypes = [P]
    lib.pcu_sq_entries.restype = ctypes.c_uint
    lib.pcu_sq_entries.argtypes = [P]
    lib.pcu_register_eventfd.restype = ctypes.c_int
    lib.pcu_register_eventfd.argtypes = [P, ctypes.c_int, ctypes.c_int]
    lib.pcu_register_buf_table.restype = ctypes.c_int
    lib.pcu_register_buf_table.argtypes = [P, ctypes.c_uint]
    lib.pcu_update_buf.restype = ctypes.c_int
    lib.pcu_update_buf.argtypes = [P, ctypes.c_uint, ctypes.c_void_p,
                                   ctypes.c_ulong]
    lib.pcu_pbuf_setup.restype = ctypes.c_int
    lib.pcu_pbuf_setup.argtypes = [P, ctypes.c_uint, ctypes.c_uint, _u64p]
    lib.pcu_pbuf_recycle.restype = None
    lib.pcu_pbuf_recycle.argtypes = [P, ctypes.c_ushort]
    lib.pcu_pbuf_buflen.restype = ctypes.c_uint
    lib.pcu_pbuf_buflen.argtypes = [P]
    lib.pcu_sq_space.restype = ctypes.c_int
    lib.pcu_sq_space.argtypes = [P]
    lib.pcu_prep_send.restype = ctypes.c_int
    lib.pcu_prep_send.argtypes = [P, ctypes.c_int, _u64, ctypes.c_uint,
                                  _u64, ctypes.c_uint, ctypes.c_uint]
    lib.pcu_prep_send_zc.restype = ctypes.c_int
    lib.pcu_prep_send_zc.argtypes = [P, ctypes.c_int, _u64, ctypes.c_uint,
                                     _u64, ctypes.c_uint, ctypes.c_uint,
                                     ctypes.c_int]
    lib.pcu_prep_write_fixed.restype = ctypes.c_int
    lib.pcu_prep_write_fixed.argtypes = [P, ctypes.c_int, _u64,
                                         ctypes.c_uint, ctypes.c_int, _u64,
                                         ctypes.c_uint]
    lib.pcu_prep_recv_multishot.restype = ctypes.c_int
    lib.pcu_prep_recv_multishot.argtypes = [P, ctypes.c_int, _u64]
    lib.pcu_prep_recv.restype = ctypes.c_int
    lib.pcu_prep_recv.argtypes = [P, ctypes.c_int, _u64, ctypes.c_uint, _u64]
    lib.pcu_prep_accept_multishot.restype = ctypes.c_int
    lib.pcu_prep_accept_multishot.argtypes = [P, ctypes.c_int, _u64]
    lib.pcu_prep_cancel.restype = ctypes.c_int
    lib.pcu_prep_cancel.argtypes = [P, _u64, _u64]
    lib.pcu_prep_shutdown.restype = ctypes.c_int
    lib.pcu_prep_shutdown.argtypes = [P, ctypes.c_int, ctypes.c_int, _u64]
    lib.pcu_submit.restype = ctypes.c_long
    lib.pcu_submit.argtypes = [P, ctypes.c_uint]
    lib.pcu_cq_overflowed.restype = ctypes.c_int
    lib.pcu_cq_overflowed.argtypes = [P]
    lib.pcu_flush_overflow.restype = ctypes.c_long
    lib.pcu_flush_overflow.argtypes = [P]
    lib.pcu_peek_cqes.restype = ctypes.c_int
    lib.pcu_peek_cqes.argtypes = [P, _u64p, _i32p, _u32p, ctypes.c_int]
    lib.pcu_telem_enable.restype = ctypes.c_int
    lib.pcu_telem_enable.argtypes = [P]
    lib.pcu_telem_enabled.restype = ctypes.c_int
    lib.pcu_telem_enabled.argtypes = [P]
    lib.pcu_telem_words.restype = ctypes.c_long
    lib.pcu_telem_words.argtypes = []
    lib.pcu_telem_snapshot.restype = ctypes.c_long
    lib.pcu_telem_snapshot.argtypes = [P, _u64p, ctypes.c_long]
    lib.pcu_telem_test_observe.restype = ctypes.c_int
    lib.pcu_telem_test_observe.argtypes = [P, ctypes.c_int, ctypes.c_int,
                                           _u64, _u64]
    lib.pcu_telem_test_count.restype = ctypes.c_int
    lib.pcu_telem_test_count.argtypes = [P, ctypes.c_int, ctypes.c_int,
                                         _u64]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is None and not _lib_tried:
        with _lock:
            if _lib is None and not _lib_tried:
                _lib = _compile()
                _lib_tried = True
    return _lib


def probe() -> int:
    """Capability probe, cached per process.

    Returns a positive bitmask (bit0: io_uring usable, bit1
    (:data:`PROBE_ZC`): SEND_ZC supported) when the kernel grants a
    ring, ``-errno`` when denied (``-ENOSYS`` on old kernels,
    ``-EPERM`` under seccomp or ``io_uring_disabled``), and
    ``-ENOSYS`` when the native shim itself failed to build — the
    honest demotion paths for ``--io-impl auto``.
    """
    global _probe_result
    if _probe_result is None:
        with _probe_lock:
            if _probe_result is None:
                lib = _get()
                if lib is None:
                    _probe_result = -_errno.ENOSYS
                else:
                    _probe_result = int(lib.pcu_probe())
    return _probe_result


def probe_errname() -> str:
    """Human label for a failed probe ("ENOSYS", "EPERM", ...)."""
    rc = probe()
    if rc > 0:
        return "ok"
    return _errno.errorcode.get(-rc, f"errno {-rc}")


def loaded() -> bool:
    """Whether the shim built and loaded (building it on the first call),
    whatever the kernel then answers to the probe."""
    return _get() is not None


def available() -> bool:
    return probe() > 0


def zerocopy_supported() -> bool:
    return probe() > 0 and bool(probe() & PROBE_ZC)


# sqe_flags the engine uses (mirrors the shim's enums)
IOSQE_IO_LINK = 1 << 2
# cqe flags
CQE_F_BUFFER = 1 << 0
CQE_F_MORE = 1 << 1
CQE_F_NOTIF = 1 << 3
CQE_BUFFER_SHIFT = 16

# msg_flags
MSG_WAITALL = 0x100
MSG_NOSIGNAL = 0x4000

_CQ_BATCH = 512

# -- shm telemetry block layout (mirror of pcu_telem in io_uring.cpp) --
# The snapshot is a flat u64 payload (the seqlock word is stripped); the
# offsets below index into it. A pcu_hist is {count, sum_ns, bucket[64]}
# where bucket[k] counts durations in [2^(k-1), 2^k) ns (0 -> bucket 0).
TM_BUCKETS = 64
TM_STAGES = 4     # 0=plan 1=submit 2=wire 3=total
TM_CHAIN = 2      # 0=enter (io_uring_enter wall) 1=chain (submit->quiesce)
TM_CLASSES = 4    # 0=control 1=consensus 2=live 3=bulk
TM_PEERS = 64
TM_HIST_WORDS = 2 + TM_BUCKETS
TM_STAGE_OFF = 0
TM_CHAIN_OFF = TM_STAGE_OFF + TM_STAGES * TM_HIST_WORDS
TM_CLASS_DELAY_OFF = TM_CHAIN_OFF + TM_CHAIN * TM_HIST_WORDS
TM_CLASS_FRAMES_OFF = TM_CLASS_DELAY_OFF + TM_CLASSES * TM_HIST_WORDS
TM_CLASS_BYTES_OFF = TM_CLASS_FRAMES_OFF + TM_CLASSES
TM_PEER_FD_OFF = TM_CLASS_BYTES_OFF + TM_CLASSES
TM_PEER_FRAMES_OFF = TM_PEER_FD_OFF + TM_PEERS
TM_PEER_BYTES_OFF = TM_PEER_FRAMES_OFF + TM_PEERS
TM_PEER_USED_OFF = TM_PEER_BYTES_OFF + TM_PEERS
# frame-fate ledger: per-class pump-drop counters, appended
# at the end of pcu_telem so every prior snapshot offset stays stable
TM_DROP_FRAMES_OFF = TM_PEER_USED_OFF + 1
TM_WORDS = TM_DROP_FRAMES_OFF + TM_CLASSES

STAGE_NAMES = ("plan", "submit", "wire", "total")
CHAIN_NAMES = ("enter", "chain")
CLASS_NAMES = ("control", "consensus", "live", "bulk")


def _tm_hist(words, off):
    return {"count": int(words[off]), "sum_ns": int(words[off + 1]),
            "buckets": [int(words[off + 2 + k]) for k in range(TM_BUCKETS)]}


def parse_telemetry(words):
    """Decode a raw snapshot (sequence of TM_WORDS u64s) into dicts —
    shared by the /metrics pre-render hook and the tests so the layout
    is asserted in exactly one place."""
    if words is None or len(words) < TM_WORDS:
        return None
    out = {
        "stage": {STAGE_NAMES[i]:
                  _tm_hist(words, TM_STAGE_OFF + i * TM_HIST_WORDS)
                  for i in range(TM_STAGES)},
        "chain": {CHAIN_NAMES[i]:
                  _tm_hist(words, TM_CHAIN_OFF + i * TM_HIST_WORDS)
                  for i in range(TM_CHAIN)},
        "class_delay": {CLASS_NAMES[i]:
                        _tm_hist(words, TM_CLASS_DELAY_OFF
                                 + i * TM_HIST_WORDS)
                        for i in range(TM_CLASSES)},
        "class_frames": {CLASS_NAMES[i]:
                         int(words[TM_CLASS_FRAMES_OFF + i])
                         for i in range(TM_CLASSES)},
        "class_bytes": {CLASS_NAMES[i]: int(words[TM_CLASS_BYTES_OFF + i])
                        for i in range(TM_CLASSES)},
        "class_drop_frames": {CLASS_NAMES[i]:
                              int(words[TM_DROP_FRAMES_OFF + i])
                              for i in range(TM_CLASSES)},
    }
    used = min(int(words[TM_PEER_USED_OFF]), TM_PEERS)
    out["peers"] = [
        {"fd": int(words[TM_PEER_FD_OFF + i]),
         "frames": int(words[TM_PEER_FRAMES_OFF + i]),
         "bytes": int(words[TM_PEER_BYTES_OFF + i])}
        for i in range(used)
    ]
    return out


class RingError(OSError):
    pass


def _check(rc: int, what: str) -> int:
    if rc < 0:
        raise RingError(-rc, f"{what}: {os.strerror(-rc)}")
    return rc


class Ring:
    """One io_uring instance: SQ/CQ mmaps, a provided-buffer ring for
    multishot recv, and a sparse fixed-buffer table for registered
    pooled egress buffers. All methods are event-loop-thread only."""

    def __init__(self, entries: int = 1024, sqpoll: bool = False,
                 sq_thread_idle_ms: int = 50, pbuf_entries: int = 256,
                 pbuf_len: int = 64 * 1024, fixed_slots: int = 16):
        lib = _get()
        if lib is None:
            raise RingError(_errno.ENOSYS, "uring shim unavailable")
        self._lib = lib
        err = ctypes.c_int(0)
        self._h = lib.pcu_create(entries, 1 if sqpoll else 0,
                                 sq_thread_idle_ms, ctypes.byref(err))
        if not self._h:
            raise RingError(-err.value,
                            f"io_uring_setup: {os.strerror(-err.value)}")
        self.sqpoll = sqpoll
        self.sq_entries = int(lib.pcu_sq_entries(self._h))
        self.enters = 0  # counted io_uring_enter round-trips (bench row)
        self._cq_uds = (_u64 * _CQ_BATCH)()
        self._cq_ress = (ctypes.c_int * _CQ_BATCH)()
        self._cq_flags = (ctypes.c_uint * _CQ_BATCH)()
        base = _u64(0)
        _check(lib.pcu_pbuf_setup(self._h, pbuf_entries, pbuf_len,
                                  ctypes.byref(base)), "pbuf_setup")
        self.pbuf_base = int(base.value)
        self.pbuf_len = pbuf_len
        self.fixed_slots = 0
        if fixed_slots:
            # best-effort: fixed buffers are an optimization, not a
            # requirement (RLIMIT_MEMLOCK can deny the page pinning)
            if lib.pcu_register_buf_table(self._h, fixed_slots) == 0:
                self.fixed_slots = fixed_slots

    # -- lifecycle --

    def close(self) -> None:
        if self._h:
            self._lib.pcu_destroy(self._h)
            self._h = None

    def __del__(self):  # backstop; the engine closes explicitly
        try:
            self.close()
        except Exception:
            pass

    @property
    def closed(self) -> bool:
        return not self._h

    def fd(self) -> int:
        return int(self._lib.pcu_ring_fd(self._h))

    def register_eventfd(self, efd: int, async_only: bool = True) -> None:
        _check(self._lib.pcu_register_eventfd(
            self._h, efd, 1 if async_only else 0), "register_eventfd")

    def update_fixed(self, slot: int, addr: int, length: int) -> int:
        return int(self._lib.pcu_update_buf(self._h, slot, addr, length))

    # -- prep (each returns 0 or raises; -EBUSY triggers a submit+retry) --

    def _retry(self, rc: int, what: str) -> bool:
        if rc == -_errno.EBUSY:
            self.submit()
            return True
        _check(rc, what)
        return False

    def prep_send(self, fd: int, addr: int, length: int, ud: int,
                  sqe_flags: int = 0, msg_flags: int = MSG_NOSIGNAL) -> None:
        while self._retry(self._lib.pcu_prep_send(
                self._h, fd, addr, length, ud, sqe_flags, msg_flags),
                "prep_send"):
            pass

    def prep_send_zc(self, fd: int, addr: int, length: int, ud: int,
                     buf_index: int = -1, sqe_flags: int = 0,
                     msg_flags: int = MSG_NOSIGNAL) -> None:
        while self._retry(self._lib.pcu_prep_send_zc(
                self._h, fd, addr, length, ud, sqe_flags, msg_flags,
                buf_index), "prep_send_zc"):
            pass

    def prep_write_fixed(self, fd: int, addr: int, length: int,
                         buf_index: int, ud: int,
                         sqe_flags: int = 0) -> None:
        while self._retry(self._lib.pcu_prep_write_fixed(
                self._h, fd, addr, length, buf_index, ud, sqe_flags),
                "prep_write_fixed"):
            pass

    def prep_recv_multishot(self, fd: int, ud: int) -> None:
        while self._retry(self._lib.pcu_prep_recv_multishot(
                self._h, fd, ud), "prep_recv_multishot"):
            pass

    def prep_accept_multishot(self, fd: int, ud: int) -> None:
        while self._retry(self._lib.pcu_prep_accept_multishot(
                self._h, fd, ud), "prep_accept_multishot"):
            pass

    def prep_cancel(self, target_ud: int, ud: int) -> None:
        while self._retry(self._lib.pcu_prep_cancel(
                self._h, target_ud, ud), "prep_cancel"):
            pass

    def prep_shutdown(self, fd: int, how: int, ud: int) -> None:
        while self._retry(self._lib.pcu_prep_shutdown(
                self._h, fd, how, ud), "prep_shutdown"):
            pass

    # -- submit / drain --

    def submit(self, wait_nr: int = 0) -> int:
        rc = int(self._lib.pcu_submit(self._h, wait_nr))
        if rc == -_errno.EINTR:
            return 0
        rc = _check(rc, "io_uring_enter")
        # Informational tally (the bench's authoritative count is the
        # LD_PRELOAD interposer): no-op submits skip the syscall, and a
        # SQPOLL ring with an awake poller thread submits with zero.
        if (rc or wait_nr) and not self.sqpoll:
            self.enters += 1
        return rc

    def peek_cqes(self):
        """Drain pending CQEs → list of (user_data, res, flags)."""
        n = int(self._lib.pcu_peek_cqes(
            self._h, self._cq_uds, self._cq_ress, self._cq_flags,
            _CQ_BATCH))
        if n <= 0:
            if self._lib.pcu_cq_overflowed(self._h):
                self._lib.pcu_flush_overflow(self._h)
                self.enters += 1
                n = int(self._lib.pcu_peek_cqes(
                    self._h, self._cq_uds, self._cq_ress, self._cq_flags,
                    _CQ_BATCH))
                if n <= 0:
                    return []
            else:
                return []
        uds, ress, flags = self._cq_uds, self._cq_ress, self._cq_flags
        return [(uds[i], ress[i], flags[i]) for i in range(n)]

    # -- shm telemetry block --

    def enable_telemetry(self) -> bool:
        """Attach the shm telemetry block (idempotent). Best-effort:
        returns False when the mmap is denied — telemetry is an
        observability plane, never a reason to fail the ring."""
        if not self._h:
            return False
        return int(self._lib.pcu_telem_enable(self._h)) == 0

    @property
    def telemetry_enabled(self) -> bool:
        return bool(self._h) and \
            bool(self._lib.pcu_telem_enabled(self._h))

    def telemetry_snapshot(self):
        """Torn-read-safe snapshot of the telemetry payload as a list of
        TM_WORDS ints, or None when telemetry is off / unreadable."""
        if not self._h:
            return None
        words = int(self._lib.pcu_telem_words())
        buf = (_u64 * words)()
        n = int(self._lib.pcu_telem_snapshot(self._h, buf, words))
        if n <= 0:
            return None
        return list(buf[:n])

    def telemetry_test_observe(self, kind: int, idx: int, ns: int,
                               n: int = 1) -> int:
        """Test hook: drive one histogram observation from Python
        (kind 0=stage 1=chain 2=class_delay)."""
        if not self._h:
            return -1
        return int(self._lib.pcu_telem_test_observe(
            self._h, kind, idx, ns, n))

    def telemetry_test_count(self, which: int, idx: int, n: int = 1) -> int:
        """Test hook: bump a flat per-class counter (which 0=class_frames
        1=fate_drop_frames) so the ledger fold is testable pump-free."""
        if not self._h:
            return -1
        return int(self._lib.pcu_telem_test_count(self._h, which, idx, n))

    def pbuf_read(self, bid: int, nbytes: int) -> bytes:
        """Copy a provided buffer's payload out (the one copy the recv
        path pays, matching the asyncio reader's chunk copy count)."""
        return ctypes.string_at(self.pbuf_base + bid * self.pbuf_len,
                                nbytes)

    def pbuf_recycle(self, bid: int) -> None:
        self._lib.pcu_pbuf_recycle(self._h, bid)
