"""io_uring data plane: engine, stream, listener, and impl selection.

The asyncio event loop stays the control plane (auth, mesh, discovery,
metrics, timers); this module replaces only the per-connection BYTE
path of the TCP transport with one io_uring per event loop (one per
shard worker, since each worker runs one loop):

- ``UringEngine`` — the per-loop singleton. Owns the ring, an eventfd
  bridged into the loop via ``add_reader`` (the completion drainer), a
  deferred-submit "kick" (every prep issued during one loop tick is
  published with ONE ``io_uring_enter`` — or zero with SQPOLL opt-in),
  the pending-operation table that anchors buffer/owner lifetimes, and
  the fixed-buffer slot map for registered pooled egress buffers.
- ``UringStream`` — a :class:`RawStream` over a connected TCP socket.
  Sends go through a per-stream ordered TX queue flushed as ONE
  linked-SQE chain per flight (IOSQE_IO_LINK preserves byte order in
  the kernel; a whole ``EgressBatch`` flush is one submission), so
  ``write()`` returns immediately like asyncio's transport write and
  only awaits under watermark backpressure. Receives are multishot
  provided-buffer recv with watermark pause/resume. Opt-in
  ``MSG_ZEROCOPY`` defers the buffer/owner-lease release to the
  kernel's F_NOTIF completion — not the send CQE.
- ``UringListener`` — multishot accept feeding the normal
  ``UnfinalizedConnection`` handshake path.

Ordering: io_uring does NOT order independent SQEs on one fd. Byte
order survives because each stream keeps AT MOST ONE send chain in
flight (links execute sequentially; the next chain is prepped only
after the previous one fully completes) and ``Connection._write_mutex``
already serializes the producers. Backpressure: the recv side stops
re-arming past a high watermark (the TCP window then closes, exactly
like asyncio's pause_reading), and the send side parks writers on a
drain waiter past the TX high watermark — which is what the
permit/queue accounting upstream already measures.

Impl selection: ``resolve_io_impl()`` reads ``PUSHCDN_IO_IMPL`` (or
legacy ``PUSHCDN_IO_URING``) / the ``--io-impl`` flag: ``asyncio``
(default), ``uring`` (raise if the kernel refuses), or ``auto``
(demote to asyncio with ONE warning when the probe fails — ENOSYS on
old kernels, EPERM under seccomp). TLS stays on asyncio regardless,
with an honest one-time log line.

The port's copy of ``pushcdn_tpu.proto.transport.uring``, with one
difference: the egress pool's registrar may run off the loop (the device
plane encodes a step's delivery streams in its worker thread, and a pool
that grows there calls every registrar), so a registration asked for
from another thread is handed to the loop with ``call_soon_threadsafe``.
Only the loop's thread touches the ring's fixed-buffer table.
"""

from __future__ import annotations

import asyncio
import ctypes
import errno
import logging
import os
import socket
import threading
import weakref
from collections import deque
from typing import Optional

import numpy as np

from pushcdn_tpu_torch.native import uring as nuring
from pushcdn_tpu_torch.proto import metrics as metrics_mod
from pushcdn_tpu_torch.proto.transport.base import (
    Connection,
    Listener,
    RawStream,
    UnfinalizedConnection,
)
from pushcdn_tpu_torch.proto.limiter import Limiter, NO_LIMIT

log = logging.getLogger("pushcdn.uring")

# -- io impl selection -------------------------------------------------------

IO_IMPLS = ("auto", "uring", "asyncio")
_resolved: Optional[str] = None
_warned_demote = False
_warned_tls = False


def configured_io_impl() -> str:
    """The REQUESTED impl: ``PUSHCDN_IO_IMPL`` (auto|uring|asyncio; the
    ``--io-impl`` flag writes this env so shard workers and spawned
    helpers inherit it), legacy ``PUSHCDN_IO_URING`` (1/0/auto), else
    ``asyncio`` — the engine is opt-in this round; flip the default
    after a soak."""
    v = os.environ.get("PUSHCDN_IO_IMPL", "").strip().lower()
    if v in IO_IMPLS:
        return v
    u = os.environ.get("PUSHCDN_IO_URING", "").strip().lower()
    if u in ("1", "true", "yes", "uring"):
        return "uring"
    if u in ("auto",):
        return "auto"
    return "asyncio"


def set_io_impl(impl: str) -> None:
    """Select the io impl for this process AND its children (the env is
    what ``--shards`` worker processes inherit)."""
    global _resolved
    if impl not in IO_IMPLS:
        raise ValueError(f"io impl must be one of {IO_IMPLS}, got {impl!r}")
    os.environ["PUSHCDN_IO_IMPL"] = impl
    _resolved = None  # re-resolve lazily


def resolve_io_impl() -> str:
    """Resolve auto/uring/asyncio → the impl actually in use ("uring" or
    "asyncio"), probing the kernel once. ``auto`` demotes with one
    warning; explicit ``uring`` raises instead of mislabeling."""
    global _resolved, _warned_demote
    if _resolved is not None:
        return _resolved
    req = configured_io_impl()
    if req == "asyncio":
        _resolved = "asyncio"
    elif nuring.available():
        _resolved = "uring"
    elif req == "uring":
        raise nuring.RingError(
            -min(nuring.probe(), -1),
            f"--io-impl uring requested but io_uring is unavailable "
            f"({nuring.probe_errname()})")
    else:  # auto → honest demotion
        if not _warned_demote:
            _warned_demote = True
            log.warning(
                "io_uring unavailable (%s): --io-impl auto demoted to "
                "asyncio", nuring.probe_errname())
        _resolved = "asyncio"
    try:
        metrics_mod.IO_IMPL.labels(impl=_resolved).set(1)
    except Exception:
        pass
    return _resolved


def warn_tls_fallback_once() -> None:
    """tcp+tls keeps the asyncio path (no kTLS offload here — Python's
    ssl module owns the record layer, so the kernel never sees
    plaintext to send): say so once instead of silently ignoring the
    knob."""
    global _warned_tls
    if not _warned_tls and resolve_io_impl() == "uring":
        _warned_tls = True
        log.warning("io-impl uring: tcp+tls stays on asyncio "
                    "(ssl owns the record layer; no kTLS)")


# -- buffer address helpers --------------------------------------------------

def _addr_of(data):
    """(addr, nbytes, keepalive) without copying. ``bytes`` resolves via
    c_char_p (no buffer export); bytearray/memoryview go through a
    numpy view (the keepalive tuple pins both the exporter and the
    view). The engine holds ``keepalive`` until the terminal CQE, so
    the kernel never reads freed or recycled memory."""
    if type(data) is bytes:
        return (ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value,
                len(data), data)
    arr = np.frombuffer(data, np.uint8)
    return int(arr.ctypes.data), arr.nbytes, (data, arr)


def _base_of(data):
    """The ultimate exporting object of a (possibly chained) memoryview
    — the identity the fixed-buffer slot map is keyed on."""
    base = data
    while isinstance(base, memoryview):
        base = base.obj
    return base


# -- engine ------------------------------------------------------------------

_SQ_ENTRIES = int(os.environ.get("PUSHCDN_URING_SQ", "1024"))
# 128 x 128 KiB (16 MiB/ring) measured best on the loopback A/B: big
# enough that one CQE carries a whole coalesced flight, small enough
# that the kernel's copy-to-provided-buffer stays cache-friendly
_PBUF_ENTRIES = int(os.environ.get("PUSHCDN_URING_PBUFS", "128"))
_PBUF_LEN = int(os.environ.get("PUSHCDN_URING_PBUF_LEN", str(128 * 1024)))
_FIXED_SLOTS = 16
_RX_HIGH = 256 * 1024  # multishot recv pause watermark (per stream)
_RX_LOW = 64 * 1024
_TX_HIGH = 256 * 1024  # send-queue backpressure watermark (per stream)
_TX_LOW = 64 * 1024
_CHAIN_MAX = 64        # max sends linked into one flight

_ECANCELED = getattr(errno, "ECANCELED", 125)


class _Send:
    """A pending send SQE: anchors the buffer (and ZC owner lease) until
    the kernel is finished with the memory — the terminal CQE, or for
    MSG_ZEROCOPY the F_NOTIF completion that may trail it."""
    __slots__ = ("stream", "keep", "owner", "zc")

    def __init__(self, stream, keep, owner, zc):
        self.stream = stream
        self.keep = keep
        self.owner = owner
        self.zc = zc


def _env_zc_min() -> int:
    try:
        return int(os.environ.get("PUSHCDN_URING_ZC_MIN", "0"))
    except ValueError:
        return 0


# -- native telemetry aggregation -------------------------------------------
# Each engine's ring owns one shm telemetry block written from C
# (native/io_uring.cpp beside this package). /metrics aggregates: live engines are
# snapshotted at render, closed engines fold their final snapshot into
# this module-level carry so the rendered histograms stay monotonic
# across engine teardown (loop-per-test suites recreate engines freely).
# Default-on; PUSHCDN_NATIVE_TELEMETRY=0 is the bench A/B "off" leg.

def _native_telemetry_enabled() -> bool:
    return os.environ.get("PUSHCDN_NATIVE_TELEMETRY", "1") != "0"


_TELEM_CARRY: Optional[dict] = None


def _tm_empty() -> dict:
    return nuring.parse_telemetry([0] * nuring.TM_WORDS)


def _tm_merge(dst: dict, src: Optional[dict]) -> dict:
    """Accumulate one parsed telemetry snapshot into ``dst`` (all-counter
    payload, so element-wise sums are exact; peer rows concatenate —
    distinct engines never share an fd at the same instant)."""
    if src is None:
        return dst
    for key in ("stage", "chain", "class_delay"):
        for name, h in src[key].items():
            d = dst[key][name]
            d["count"] += h["count"]
            d["sum_ns"] += h["sum_ns"]
            db = d["buckets"]
            for k, c in enumerate(h["buckets"]):
                db[k] += c
    for key in ("class_frames", "class_bytes", "class_drop_frames"):
        for name, v in src.get(key, {}).items():
            dst[key][name] = dst[key].get(name, 0) + v
    dst["peers"].extend(src.get("peers", ()))
    return dst


def telemetry_totals() -> Optional[dict]:
    """Aggregate native telemetry: live engines' snapshots plus the
    closed-engine carry (``parse_telemetry`` shape). None when nothing
    has ever been recorded — the pre-render hook then skips the push."""
    totals: Optional[dict] = None
    if _TELEM_CARRY is not None:
        totals = _tm_merge(_tm_empty(), _TELEM_CARRY)
    for _, eng in UringEngine._engines.values():
        if eng.closed:
            continue
        try:
            snap = eng.ring.telemetry_snapshot()
        except Exception:
            continue
        parsed = nuring.parse_telemetry(snap) if snap is not None else None
        if parsed is not None:
            totals = _tm_merge(totals if totals is not None else _tm_empty(),
                               parsed)
    return totals


def _telemetry_pre_render() -> None:
    metrics_mod.update_native_telemetry(telemetry_totals())


metrics_mod.PRE_RENDER_HOOKS.append(_telemetry_pre_render)


class UringEngine:
    """Per-event-loop io_uring engine. Use :meth:`current`."""

    _engines: dict = {}  # id(loop) -> (weakref(loop), engine)

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        # the loop's thread: the only one that registers fixed buffers
        self._thread = threading.get_ident()
        self.ring = nuring.Ring(
            entries=_SQ_ENTRIES,
            sqpoll=os.environ.get("PUSHCDN_URING_SQPOLL", "") == "1",
            pbuf_entries=_PBUF_ENTRIES, pbuf_len=_PBUF_LEN,
            fixed_slots=_FIXED_SLOTS)
        self._efd = os.eventfd(0, os.EFD_NONBLOCK | os.EFD_CLOEXEC)
        try:
            # NOT async-only: a blocked send finishing in io-wq posts its
            # CQE via task-work (task context), which EVENTFD_ASYNC never
            # signals — a backpressured writer whose peer finally drained
            # would strand until unrelated traffic forced a drain. Inline
            # completions double-signal instead; the post-submit drain
            # makes those wakes cheap no-ops.
            self.ring.register_eventfd(self._efd, async_only=False)
            loop.add_reader(self._efd, self._on_event)
        except BaseException:
            os.close(self._efd)
            self.ring.close()
            raise
        # native telemetry block: stamped from C on the pump/engine hot
        # paths, snapshotted by the /metrics pre-render hook. Best-effort
        # (an mmap failure just leaves telemetry off).
        if _native_telemetry_enabled():
            try:
                self.ring.enable_telemetry()
            except Exception:
                pass
        self._pending: dict = {}
        self._next_ud = 0
        self._kick_scheduled = False
        self._need_submit = False
        self.closed = False
        # fused data-plane pump (transport/pump.py): ONE per engine,
        # claimed by the first RouteState on this loop
        self.pump_state = None
        # fixed-buffer registration: id(buffer) -> slot, with strong refs
        # so a registered buffer's pages can never be freed while the
        # kernel holds the pin
        self._fixed: dict = {}
        self._fixed_keep: list = []
        self.zc_min = _env_zc_min()
        self.zc_ok = self.zc_min > 0 and nuring.zerocopy_supported()
        self.fixed_ok = self.ring.fixed_slots > 0
        # counters for the bench's attribution row and /debug
        self.sqes = 0
        self.cqes = 0
        self.wakes = 0
        self.zc_sends = 0
        self.zc_notifs = 0
        # register every pooled egress buffer that already exists, and
        # hook future pool growth (registration is once per buffer, not
        # per send)
        try:
            from pushcdn_tpu_torch import native as _native
            for buf in _native.egress_pool_buffers():
                self.register_fixed_buffer(buf)
            _native.add_egress_registrar(self._registrar_ref())
        except Exception:
            pass

    # -- lifecycle --

    @classmethod
    def current(cls) -> "UringEngine":
        """The engine for the running loop (created on first use).
        Sweeps engines whose loops have died — fd hygiene for
        loop-per-test suites."""
        loop = asyncio.get_running_loop()
        key = id(loop)
        for k, (ref, eng) in list(cls._engines.items()):
            lp = ref()
            if lp is None or (lp is not loop and lp.is_closed()):
                eng.close()
                cls._engines.pop(k, None)
        ent = cls._engines.get(key)
        if ent is not None:
            eng = ent[1]
            if not eng.closed:
                return eng
            cls._engines.pop(key, None)
        eng = cls(loop)
        cls._engines[key] = (weakref.ref(loop), eng)
        return eng

    @classmethod
    def shutdown(cls, loop=None) -> None:
        """Close the engine bound to ``loop`` (default: every engine).
        Tests and bins call this for deterministic fd/lease cleanup."""
        if loop is not None:
            ent = cls._engines.pop(id(loop), None)
            if ent:
                ent[1].close()
            return
        for _, (ref, eng) in list(cls._engines.items()):
            eng.close()
        cls._engines.clear()

    def _registrar_ref(self):
        selfref = weakref.ref(self)

        def _register(buf):
            eng = selfref()
            if eng is None or eng.closed:
                return
            if threading.get_ident() == eng._thread:
                eng.register_fixed_buffer(buf)
                return
            # off the loop (a device plane's encode thread grew the egress
            # pool): the ring and the slot table belong to the loop, so
            # register there. Sends before that just skip the fixed slot.
            try:
                eng._loop.call_soon_threadsafe(eng.register_fixed_buffer,
                                               buf)
            except RuntimeError:  # the loop closed: nothing to register
                pass
        return _register

    def close(self) -> None:
        """Tear the engine down: fail every pending op, release every
        buffer/owner keep-alive (zero leaked leases), close the ring —
        the kernel cancels in-flight SQEs when the ring fd drops."""
        if self.closed:
            return
        self.closed = True
        try:
            self._loop.remove_reader(self._efd)
        except Exception:
            pass
        ps = self.pump_state
        if ps is not None:
            # the pump preps SQEs on this ring's mapped memory — it
            # must die before the ring fd drops
            try:
                ps.engine_dead()
            except Exception:
                pass
        dead: list = []
        for ud, e in list(self._pending.items()):
            if isinstance(e, _Send):
                e.keep = e.owner = None
                if e.stream is not None:
                    dead.append(e.stream)
            elif isinstance(e, (UringStream, UringListener)):
                dead.append(e)
        self._pending.clear()
        seen: set = set()
        for obj in dead:
            if id(obj) not in seen:
                seen.add(id(obj))
                obj._engine_dead()
        self._fixed.clear()
        self._fixed_keep.clear()
        try:
            os.close(self._efd)
        except OSError:
            pass
        # fold the final telemetry snapshot into the module carry BEFORE
        # the ring drops (pcu_destroy munmaps the block) so the rendered
        # aggregates stay monotonic across engine teardown
        global _TELEM_CARRY
        try:
            snap = self.ring.telemetry_snapshot()
            if snap is not None:
                _TELEM_CARRY = _tm_merge(
                    _TELEM_CARRY if _TELEM_CARRY is not None
                    else _tm_empty(),
                    nuring.parse_telemetry(snap))
        except Exception:
            pass
        self.ring.close()

    def stats(self) -> dict:
        return {"enters": self.ring.enters, "sqes": self.sqes,
                "cqes": self.cqes, "wakes": self.wakes,
                "zc_sends": self.zc_sends, "zc_notifs": self.zc_notifs,
                "pending": len(self._pending),
                "fixed_slots": len(self._fixed)}

    # -- fixed buffers --

    def register_fixed_buffer(self, buf) -> Optional[int]:
        """Register a pooled egress buffer into a fixed slot (page pin
        done ONCE; sends then use WRITE_FIXED / SEND_ZC+FIXED_BUF).
        Bounded by the sparse table size; silently skipped beyond it.
        The engine keeps a strong ref: a registered buffer that later
        leaves the pool stays pinned rather than dangling."""
        if not self.fixed_ok or self.closed:
            return None
        key = id(buf)
        slot = self._fixed.get(key)
        if slot is not None:
            return slot
        if len(self._fixed) >= self.ring.fixed_slots:
            return None
        try:
            arr = np.frombuffer(buf, np.uint8)
        except (TypeError, ValueError, BufferError):
            return None
        slot = len(self._fixed)
        if self.ring.update_fixed(slot, int(arr.ctypes.data),
                                  arr.nbytes) != 0:
            self.fixed_ok = False  # RLIMIT_MEMLOCK etc: stop trying
            return None
        self._fixed[key] = slot
        self._fixed_keep.append((buf, arr))
        return slot

    def fixed_slot_for(self, data) -> int:
        if not self._fixed:
            return -1
        return self._fixed.get(id(_base_of(data)), -1)

    # -- submit plumbing --

    def _ud(self) -> int:
        self._next_ud += 1
        return self._next_ud

    def _schedule_kick(self) -> None:
        if not self._kick_scheduled and not self.closed:
            self._kick_scheduled = True
            self._loop.call_soon(self._kick)

    def _kick(self) -> None:
        """Publish every SQE prepped this loop tick with one enter, then
        drain completions. Completion handlers prep follow-up SQEs (the
        next TX chain, multishot rearms) — the loop re-submits those in
        the SAME tick so loopback/buffered chains progress without
        waiting for another event-loop pass. Bounded as a guard; real
        chains converge in a few rounds."""
        self._kick_scheduled = False
        if self.closed:
            return
        for _ in range(64):
            self._need_submit = False
            try:
                self.ring.submit()
            except nuring.RingError as exc:
                log.error("io_uring submit failed: %s", exc)
                self.close()
                return
            self._drain()
            if self.closed or not self._need_submit:
                return
        self._schedule_kick()

    def _on_event(self) -> None:
        try:
            os.read(self._efd, 8)
        except (BlockingIOError, OSError):
            pass
        self.wakes += 1
        if self.closed:
            return
        self._drain()
        if self._need_submit and not self.closed:
            self._kick()

    def _drain(self) -> None:
        ps = self.pump_state
        if ps is not None and not ps.closed:
            # pump-aware drain: native code walks the CQ, consumes
            # pump-tagged CQEs (chain advance + starved-chain prep) and
            # hands everything else back for the dispatch below
            ps.drain()
            return
        ring = self.ring
        while True:
            cqes = ring.peek_cqes()
            if not cqes:
                break
            self.cqes += len(cqes)
            for ud, res, flags in cqes:
                self._complete(ud, res, flags)
                if self.closed:
                    return

    def _complete(self, ud: int, res: int, flags: int) -> None:
        e = self._pending.get(ud)
        if e is None:
            # completion for a dead owner: recycle any selected buffer
            if flags & nuring.CQE_F_BUFFER:
                self.ring.pbuf_recycle(
                    (flags >> nuring.CQE_BUFFER_SHIFT) & 0xFFFF)
            return
        if isinstance(e, _Send):
            if flags & nuring.CQE_F_NOTIF:
                # kernel done with the ZC pages: NOW the lease drops
                del self._pending[ud]
                e.keep = e.owner = None
                self.zc_notifs += 1
                return
            if e.zc and (flags & nuring.CQE_F_MORE):
                stream, e.stream = e.stream, None  # entry stays for NOTIF
            else:
                del self._pending[ud]
                stream = e.stream
                e.keep = e.owner = None
            if stream is not None:
                stream._on_send_cqe(res)
        elif isinstance(e, UringStream):
            terminal = not (flags & nuring.CQE_F_MORE)
            data = None
            if flags & nuring.CQE_F_BUFFER:
                bid = (flags >> nuring.CQE_BUFFER_SHIFT) & 0xFFFF
                if res > 0:
                    data = self.ring.pbuf_read(bid, res)
                self.ring.pbuf_recycle(bid)
            if terminal:
                del self._pending[ud]
            e._on_recv_cqe(ud, res, data, terminal)
        elif isinstance(e, UringListener):
            terminal = not (flags & nuring.CQE_F_MORE)
            if terminal:
                del self._pending[ud]
            e._on_accept_cqe(ud, res, terminal)
        else:  # cancel / shutdown markers
            del self._pending[ud]

    # -- op submission (streams/listeners call these) --

    def prep_stream_send(self, stream, fd: int, addr: int, length: int,
                         keep, owner, zc: bool, buf_index: int,
                         link: bool) -> None:
        """One send SQE for a stream TX entry; ``link`` chains it to the
        NEXT prepped SQE (in-kernel ordering for a multi-buffer flight)."""
        ud = self._ud()
        self._pending[ud] = _Send(stream, keep, owner, zc)
        sqe_flags = nuring.IOSQE_IO_LINK if link else 0
        msg_flags = nuring.MSG_NOSIGNAL | nuring.MSG_WAITALL
        if zc:
            self.ring.prep_send_zc(fd, addr, length, ud, buf_index,
                                   sqe_flags, msg_flags)
            self.zc_sends += 1
        elif buf_index >= 0:
            self.ring.prep_write_fixed(fd, addr, length, buf_index, ud,
                                       sqe_flags)
        else:
            self.ring.prep_send(fd, addr, length, ud, sqe_flags, msg_flags)
        self.sqes += 1
        self._need_submit = True
        self._schedule_kick()

    def arm_recv(self, stream: "UringStream") -> int:
        ud = self._ud()
        self._pending[ud] = stream
        self.ring.prep_recv_multishot(stream._fd, ud)
        self.sqes += 1
        self._need_submit = True
        self._schedule_kick()
        return ud

    def arm_accept(self, listener: "UringListener") -> int:
        ud = self._ud()
        self._pending[ud] = listener
        self.ring.prep_accept_multishot(listener._fd, ud)
        self.sqes += 1
        self._need_submit = True
        self._schedule_kick()
        return ud

    def cancel_op(self, target_ud: int) -> None:
        if self.closed:
            return
        cud = self._ud()
        self._pending[cud] = "cancel"
        self.ring.prep_cancel(target_ud, cud)
        self.sqes += 1
        self._need_submit = True
        self._schedule_kick()


# -- stream ------------------------------------------------------------------

# TX queue entry indices (a list, mutated in place). ADDR/KEEP/BIDX are
# resolved lazily at pump time: a coalesce bytearray may still be
# EXTENDED while queued (realloc moves it), so pinning the address early
# would dangle.
(_T_DATA, _T_LEN, _T_SENT, _T_OWNER, _T_ZC, _T_COAL,
 _T_KEEP, _T_ADDR, _T_BIDX) = range(9)

_COAL_ENTRY_MAX = 64 * 1024   # plain sends up to this coalesce...
_COAL_BUF_MAX = 256 * 1024    # ...into shared buffers up to this


class UringStream(RawStream):
    """RawStream over a connected socket, driven by the loop's
    UringEngine. ``wants_owner`` tells the Connection flush paths to
    hand the PreEncoded owner lease down, enabling ZC deferral."""

    wants_owner = True

    def __init__(self, sock: socket.socket, engine: UringEngine):
        self._sock = sock
        self._fd = sock.fileno()
        self._engine = engine
        # receive side
        self._rx: deque = deque()
        self._rx_head = 0
        self._rx_bytes = 0
        self._rx_err: Optional[BaseException] = None
        self._eof = False
        self._paused = False
        self._waiter: Optional[asyncio.Future] = None
        self._recv_ud: Optional[int] = None
        self._recv_terminal: Optional[asyncio.Future] = None
        # send side: ordered queue; the first _tx_flight entries are in
        # the kernel as one linked chain
        self._tx: deque = deque()
        self._tx_bytes = 0
        self._tx_flight = 0
        self._tx_err: Optional[BaseException] = None
        self._tx_waiter: Optional[asyncio.Future] = None
        self._tx_idle: Optional[asyncio.Future] = None
        self._closed = False
        # fused pump (transport/pump.py): set when this stream is
        # pump-engaged (binding) or engagement is pending (state)
        self._pump_state = None
        self._pump_binding = None
        self._arm()

    # -- receive plumbing (engine callbacks) --

    def _arm(self) -> None:
        if self._closed or self._eof or self._rx_err is not None \
                or self._recv_ud is not None:
            return
        self._recv_ud = self._engine.arm_recv(self)

    def _on_recv_cqe(self, ud: int, res: int, data, terminal: bool) -> None:
        # data CQEs between a pause-cancel and its terminal completion are
        # REAL in-order bytes and must be kept — only a closed stream
        # drops them (its fd is on the way out, matching asyncio's
        # close-tears-down-both-sides semantics)
        if res > 0 and data and not self._closed:
            self._rx.append(data)
            self._rx_bytes += len(data)
            self._wake()
            if self._rx_bytes >= _RX_HIGH and not self._paused \
                    and self._recv_ud is not None:
                # backpressure: stop pulling bytes; the kernel socket
                # buffer fills and the peer's TCP window closes
                self._paused = True
                self._engine.cancel_op(self._recv_ud)
        elif res == 0:
            self._eof = True
            self._wake()
        elif res < 0 and res not in (-_ECANCELED, -errno.ENOBUFS):
            self._rx_err = ConnectionResetError(-res, os.strerror(-res))
            self._wake()
        if terminal:
            if ud == self._recv_ud:
                self._recv_ud = None
            if self._recv_terminal is not None \
                    and not self._recv_terminal.done():
                self._recv_terminal.set_result(None)
            if not self._paused:
                self._arm()  # ENOBUFS / !F_MORE rearm (bufs recycled)

    def _wake(self) -> None:
        w = self._waiter
        if w is not None and not w.done():
            w.set_result(None)
        self._waiter = None

    def _engine_dead(self) -> None:
        self._pump_binding = None
        self._pump_state = None
        self._recv_ud = None
        if self._rx_err is None and not self._eof:
            self._rx_err = ConnectionResetError(
                errno.EBADF, "uring engine closed")
        if self._tx_err is None:
            self._tx_fail(ConnectionResetError(
                errno.EBADF, "uring engine closed"))
        self._wake()

    def _maybe_resume(self) -> None:
        if self._paused and self._rx_bytes <= _RX_LOW and not self._closed \
                and not self._eof and self._rx_err is None:
            self._paused = False
            # two armed multishots on one fd would interleave and corrupt
            # byte order: rearm only once the cancelled op has fully
            # terminated (otherwise the terminal handler rearms, since
            # _paused is now False)
            if self._recv_ud is None:
                self._arm()

    # -- send plumbing --

    def _queue_tx(self, data, owner) -> None:
        eng = self._engine
        n = len(data)
        zc = (eng.zc_ok and n >= eng.zc_min
              and (type(data) is bytes or owner is not None))
        tx = self._tx
        # Entries that MUST copy: mutable or revocable memory with no
        # owner lease. The writer releases encoder scratch memoryviews
        # (and reuses the underlying buffer) the moment write() returns,
        # and pipelining means the kernel reads LATER — only immutable
        # ``bytes`` (refcount-pinned by the keepalive) and owner-leased
        # views may ride zero-copy. The asyncio stream materializes the
        # same views to bytes, so the copy is parity, not a regression.
        if not zc and (n <= _COAL_ENTRY_MAX
                       or (owner is None and type(data) is not bytes)):
            # coalesce small sends into one buffer, exactly like
            # asyncio's transport write buffer: back-to-back pipelined
            # writes leave as ONE send, so the receiver sees one large
            # completion instead of a CQE per write. The copy also means
            # a small owner-backed entry needs no deferred lease — the
            # caller's refcount releases the pool buffer immediately
            # (asyncio's write path materializes the same way). Only a
            # queued-but-not-in-flight tail may grow (in-flight memory
            # is pinned by the kernel), and only before its address was
            # resolved (a numpy export blocks bytearray resize).
            if len(tx) > self._tx_flight:
                tail = tx[-1]
                if tail[_T_COAL] and tail[_T_KEEP] is None \
                        and tail[_T_LEN] + n <= _COAL_BUF_MAX:
                    tail[_T_DATA] += data
                    tail[_T_LEN] += n
                    self._tx_bytes += n
                    return
            tx.append([bytearray(data), n, 0, None, False, True,
                       None, 0, -1])
        else:
            tx.append([data, n, 0, owner, zc, False, None, 0, -1])
        self._tx_bytes += n

    def _pump(self) -> None:
        """Prep the whole TX queue (up to _CHAIN_MAX entries) as one
        linked chain. Called only when nothing is in flight. Addresses
        resolve here — entries are frozen once in flight."""
        if self._tx_flight or not self._tx or self._tx_err is not None \
                or self._engine.closed:
            return
        eng = self._engine
        n = min(len(self._tx), _CHAIN_MAX)
        for i in range(n):
            e = self._tx[i]
            if e[_T_KEEP] is None:
                addr, _nb, keep = _addr_of(e[_T_DATA])
                e[_T_ADDR] = addr
                e[_T_KEEP] = keep
                e[_T_BIDX] = (eng.fixed_slot_for(e[_T_DATA])
                              if (e[_T_ZC] or eng.fixed_ok) else -1)
            eng.prep_stream_send(
                self, self._fd, e[_T_ADDR] + e[_T_SENT],
                e[_T_LEN] - e[_T_SENT], e[_T_KEEP], e[_T_OWNER],
                e[_T_ZC], e[_T_BIDX] if e[_T_SENT] == 0 else -1,
                link=(i != n - 1))
        self._tx_flight = n

    def _on_send_cqe(self, res: int) -> None:
        """One send CQE of the in-flight chain (in link order)."""
        if self._tx_flight <= 0:
            return  # aborted stream: queue already dropped
        self._tx_flight -= 1
        chain_done = self._tx_flight == 0
        if self._tx_err is None and self._tx:
            e = self._tx[0]
            if res == 0 and e[_T_LEN] > e[_T_SENT]:
                # 0-byte completion on a nonempty send: the peer is gone
                # (re-pumping would spin hot)
                self._tx_fail(ConnectionResetError(
                    errno.EPIPE, "zero-length send completion"))
            elif res >= 0:
                e[_T_SENT] += res
                if e[_T_SENT] >= e[_T_LEN]:
                    self._tx.popleft()
                    self._tx_bytes -= e[_T_LEN]
                elif not chain_done:
                    # a SHORT-but-successful mid-chain send means later
                    # links already wrote past the gap — framing is
                    # unrecoverable, poison (detectable, never silent)
                    self._tx_fail(ConnectionResetError(
                        errno.EIO,
                        f"short linked send ({res}/{e[_T_LEN]})"))
                # else: lone/last entry short (WAITALL backstop):
                # stays at queue head, next pump resubmits the residue
            elif res in (-errno.EINVAL, -errno.EOPNOTSUPP) \
                    and (e[_T_ZC] or e[_T_BIDX] >= 0):
                # kernel refused the fancy path: demote globally and
                # let the next pump retry this entry plain (honest
                # fallback, no mislabel)
                eng = self._engine
                if e[_T_ZC]:
                    eng.zc_ok = False
                if e[_T_BIDX] >= 0:
                    eng.fixed_ok = False
                e[_T_ZC] = False
                e[_T_BIDX] = -1
            elif res == -_ECANCELED:
                pass  # chain tail after a failed link: entry stays queued
            else:
                self._tx_fail(ConnectionResetError(
                    -res, os.strerror(-res)))
        if not chain_done:
            return
        # whole flight accounted: wake writers / pump the next chain
        if self._tx_err is None:
            if self._tx_bytes <= _TX_LOW:
                self._wake_tx(None)
            if self._tx:
                self._pump()
            else:
                if self._tx_idle is not None and not self._tx_idle.done():
                    self._tx_idle.set_result(None)
                ps = self._pump_state
                if ps is not None:
                    # TX-idle transition: the pump's engage/unfence hook
                    ps.on_stream_idle(self)

    def _tx_fail(self, err: BaseException) -> None:
        self._tx_err = err
        self._tx.clear()  # entry keep/owner refs drop (leases release)
        self._tx_bytes = 0
        self._wake_tx(err)
        if self._tx_idle is not None and not self._tx_idle.done():
            self._tx_idle.set_result(None)

    def _wake_tx(self, err: Optional[BaseException]) -> None:
        w = self._tx_waiter
        if w is not None and not w.done():
            if err is None:
                w.set_result(None)
            else:
                w.set_exception(err)
        self._tx_waiter = None

    async def _tx_drain(self) -> None:
        """Park until the TX queue falls below the low watermark — the
        io_uring twin of asyncio's ``drain()``. The connection's write
        timeout wraps this, so a stalled peer still poisons."""
        while self._tx_bytes > _TX_HIGH and self._tx_err is None \
                and not self._closed:
            if self._tx_waiter is None:
                self._tx_waiter = \
                    asyncio.get_running_loop().create_future()
            await asyncio.shield(self._tx_waiter)
        if self._tx_err is not None:
            raise self._tx_err

    # -- RawStream API --

    async def read_some(self, max_n: int) -> bytes:
        while True:
            if self._rx:
                head = self._rx[0]
                avail = len(head) - self._rx_head
                if avail > max_n:
                    chunk = head[self._rx_head:self._rx_head + max_n]
                    self._rx_head += max_n
                    self._rx_bytes -= max_n
                    self._maybe_resume()
                    return chunk
                self._rx.popleft()
                chunk = head[self._rx_head:] if self._rx_head else head
                self._rx_head = 0
                got = len(chunk)
                if not self._rx or got == max_n:
                    self._rx_bytes -= got
                    self._maybe_resume()
                    return chunk
                # gather queued completions into ONE return, like asyncio
                # returning its whole accumulated transport buffer: the
                # parser upstream then sees big contiguous spans instead
                # of one span per CQE
                parts = [chunk]
                while self._rx and got < max_n:
                    nxt = self._rx[0]
                    if got + len(nxt) <= max_n:
                        self._rx.popleft()
                        parts.append(nxt)
                        got += len(nxt)
                    else:
                        take = max_n - got
                        parts.append(nxt[:take])
                        self._rx_head = take
                        got = max_n
                self._rx_bytes -= got
                self._maybe_resume()
                return b"".join(parts)
            if self._rx_err is not None:
                raise self._rx_err
            if self._eof:
                raise asyncio.IncompleteReadError(b"", 1)
            if self._closed:
                raise ConnectionResetError(errno.EBADF, "stream closed")
            if self._waiter is None:
                self._waiter = \
                    asyncio.get_running_loop().create_future()
            await asyncio.shield(self._waiter)

    async def read_exactly(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            out += await self.read_some(n - len(out))
        return bytes(out)

    async def write(self, data, owner=None) -> None:
        if self._tx_err is not None:
            raise self._tx_err
        if self._closed:
            raise ConnectionResetError(errno.EBADF, "stream closed")
        if len(data) == 0:
            return
        b = self._pump_binding
        if b is not None:
            # fence + wait out queued native runs: a Python write must
            # never interleave with a pumped chain on the same fd
            await b.write_gate()
            if self._tx_err is not None:
                raise self._tx_err
            if self._closed:
                raise ConnectionResetError(errno.EBADF, "stream closed")
        self._queue_tx(data, owner)
        if not self._tx_flight:
            self._pump()
        if self._tx_bytes > _TX_HIGH:
            await self._tx_drain()

    async def writev(self, bufs, owner=None) -> None:
        if self._tx_err is not None:
            raise self._tx_err
        if self._closed:
            raise ConnectionResetError(errno.EBADF, "stream closed")
        b = self._pump_binding
        if b is not None:
            await b.write_gate()
            if self._tx_err is not None:
                raise self._tx_err
            if self._closed:
                raise ConnectionResetError(errno.EBADF, "stream closed")
        queued = False
        for b in bufs:
            if len(b):
                self._queue_tx(b, owner)
                queued = True
        if queued and not self._tx_flight:
            self._pump()
        if self._tx_bytes > _TX_HIGH:
            await self._tx_drain()

    async def close(self) -> None:
        if self._closed:
            return
        eng = self._engine
        b = self._pump_binding
        if b is not None:
            # let queued native runs reach the wire before the FIN
            await b.quiesce_and_drop()
            if self._closed:
                return
        # flush: wait for the TX queue to drain (bounded) before FIN —
        # asyncio's close() flushes its transport buffer the same way
        if (self._tx or self._tx_flight) and self._tx_err is None \
                and not eng.closed:
            self._tx_idle = eng._loop.create_future()
            if not self._tx_flight:
                self._pump()
            try:
                await asyncio.wait_for(asyncio.shield(self._tx_idle), 5.0)
            except (asyncio.TimeoutError, Exception):
                pass
        self._closed = True
        # a parked multishot recv holds a kernel file reference — the
        # socket would never actually close (no FIN) under it. Cancel,
        # wait for the terminal CQE, then close the fd.
        if self._recv_ud is not None and not eng.closed:
            self._recv_terminal = eng._loop.create_future()
            eng.cancel_op(self._recv_ud)
            try:
                await asyncio.wait_for(
                    asyncio.shield(self._recv_terminal), 1.0)
            except (asyncio.TimeoutError, Exception):
                pass
        self._wake()
        try:
            self._sock.close()
        except OSError:
            pass

    def abort(self) -> None:
        if self._closed:
            return
        self._closed = True
        b = self._pump_binding
        if b is not None:
            b.drop_now()
        # drop everything queued but not yet in flight (their lease refs
        # release); in-flight entries stay anchored by the engine's
        # pending table until their terminal CQEs
        self._tx.clear()
        self._tx_bytes = 0
        if self._tx_err is None:
            self._tx_err = ConnectionResetError(
                errno.ECONNRESET, "stream aborted")
        self._wake_tx(self._tx_err)
        # shutdown() tears the connection down regardless of the file
        # refs in-flight SQEs hold; the armed recv then completes (EOF /
        # reset), and the terminal CQE path below closes the fd.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        eng = self._engine
        if self._recv_ud is not None and not eng.closed:
            sock = self._sock
            self._recv_terminal = eng._loop.create_future()
            self._recv_terminal.add_done_callback(
                lambda _f: _close_quiet(sock))
            eng.cancel_op(self._recv_ud)
        else:
            _close_quiet(self._sock)
        if self._rx_err is None and not self._eof:
            self._rx_err = ConnectionResetError(
                errno.ECONNRESET, "stream aborted")
        self._wake()


def _close_quiet(sock) -> None:
    try:
        sock.close()
    except OSError:
        pass


# -- listener / protocol glue ------------------------------------------------

class _UringUnfinalized(UnfinalizedConnection):
    def __init__(self, sock: socket.socket, engine: UringEngine,
                 label: str):
        self._sock = sock
        self._engine = engine
        self._label = label

    async def finalize(self, limiter: Limiter = NO_LIMIT) -> Connection:
        return Connection(UringStream(self._sock, self._engine), limiter,
                          label=self._label)


class UringListener(Listener):
    """Multishot-accept listener: ONE armed SQE accepts every incoming
    connection; the CQE drainer enqueues accepted fds here."""

    def __init__(self, sock: socket.socket, engine: UringEngine):
        self._sock = sock
        self._fd = sock.fileno()
        self._engine = engine
        self._accepted: deque = deque()
        self._waiter: Optional[asyncio.Future] = None
        self._closed = False
        self._accept_ud: Optional[int] = engine.arm_accept(self)
        self.bound_port = sock.getsockname()[1]

    def _on_accept_cqe(self, ud: int, res: int, terminal: bool) -> None:
        if terminal:
            self._accept_ud = None
        if res >= 0:
            if self._closed:
                try:
                    os.close(res)
                except OSError:
                    pass
            else:
                self._accepted.append(res)
                self._wake()
        elif res not in (-_ECANCELED, -errno.ECONNABORTED,
                         -errno.EMFILE, -errno.ENFILE):
            self._accepted.append(ConnectionAbortedError(
                -res, os.strerror(-res)))
            self._wake()
        if terminal and not self._closed:
            self._accept_ud = self._engine.arm_accept(self)

    def _wake(self) -> None:
        w = self._waiter
        if w is not None and not w.done():
            w.set_result(None)
        self._waiter = None

    def _engine_dead(self) -> None:
        self._accept_ud = None
        if not self._closed:
            self._accepted.append(ConnectionAbortedError(
                errno.EBADF, "uring engine closed"))
            self._wake()

    async def accept(self) -> UnfinalizedConnection:
        while not self._accepted:
            if self._closed:
                raise ConnectionAbortedError(errno.EBADF, "listener closed")
            if self._waiter is None:
                self._waiter = \
                    asyncio.get_running_loop().create_future()
            await asyncio.shield(self._waiter)
        item = self._accepted.popleft()
        if isinstance(item, BaseException):
            raise item
        sock = socket.socket(fileno=item)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            os.set_inheritable(item, False)
        except OSError:
            pass
        try:
            peer = "%s:%s" % sock.getpeername()[:2]
        except OSError:
            peer = "?"
        return _UringUnfinalized(sock, self._engine, f"tcp:{peer}")

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        eng = self._engine
        if self._accept_ud is not None and not eng.closed:
            eng.cancel_op(self._accept_ud)
        while self._accepted:
            fd = self._accepted.popleft()
            if isinstance(fd, int):
                try:
                    os.close(fd)
                except OSError:
                    pass
        self._wake()
        try:
            self._sock.close()
        except OSError:
            pass


async def uring_connect(host: str, port: int, limiter: Limiter,
                        label: str) -> Connection:
    loop = asyncio.get_running_loop()
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.setblocking(False)
        await loop.sock_connect(sock, (host, port))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except BaseException:
        sock.close()
        raise
    return Connection(UringStream(sock, UringEngine.current()), limiter,
                      label=label)


def uring_bind(host: str, port: int, reuse_port: bool = False):
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuse_port:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        sock.setblocking(False)
        sock.bind((host, port))
        sock.listen(512)
    except BaseException:
        sock.close()
        raise
    return UringListener(sock, UringEngine.current())
