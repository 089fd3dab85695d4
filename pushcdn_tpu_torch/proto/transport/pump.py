"""Fused data-plane pump: the Python policy plane over the port's
``native/pump.cpp``.

The port's copy of ``pushcdn_tpu.proto.transport.pump``. The native side
(``pushcdn_tpu_torch/native/pump.py`` binding) does the
per-frame work with zero Python: scan a recv chunk's frame headers in
place, plan fan-out against the live RouteTable snapshot, build per-peer
zero-copy runs over the pooled chunk buffer, and prep linked send SQEs
on the shard's io_uring.  Everything that is a *decision* stays here:

- **Engagement** — which connections get a native peer slot.  Only
  local-shard connections whose stream is a ``UringStream`` on this
  loop's engine are eligible, and a peer is engaged only at a moment of
  full Python-side idleness (empty TX deque, no in-flight chain, empty
  writer queue, writer mutex free) so the C queue can never reorder
  against bytes Python already accepted.
- **Fencing** — per-peer ordering against Python-enqueued frames.
  ``Connection._ensure_writer`` (called at every queued-send enqueue)
  and ``UringStream.write``/``writev`` fence the peer synchronously;
  while fenced the planner diverts that peer's frames to the residual
  path, which funnels through the same writer queue.  The fence lifts
  only when both sides are drained (C pending == 0 and the Python
  predicate above), swept on stream-idle transitions and at every
  plan call.
- **Lease reconciliation** — the chunk's pool permit.  When the native
  side keeps byte ranges referenced by queued/in-flight runs it takes a
  chunk slot; we park ``chunk.lease()`` under that slot and release it
  when the slot comes back on the released-slot channel (drained after
  every releasing native call, *before* any new ``route_chunk`` so a
  recycled slot can never alias a still-parked lease).
- **Escalation** — every frame the pump does not send natively is
  counted by reason (``cdn_pump_escalations``) and handed back as a
  (peer, frame) residual pair for the existing cut-through
  ``_send_plan`` path; control/traced/malformed frames stop the batch
  exactly like the plain planner.
- **Failure** — a peer whose chain errors is *disengaged only*; the
  frame flows through the Python path next, which discovers the broken
  socket itself and makes the identical disconnect decision
  ("send failed") the non-pumped path would have made.

Composition: the pump engages only when BOTH
native layers probe live — the route-plan kernel and the io_uring
engine — plus the pump library itself builds.  ``resolve_pump`` emits
one honest demotion warning naming exactly which layer failed; every
per-frame fallback after that is counted, never silent.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Optional

import numpy as np

from pushcdn_tpu_torch.native import pump as npump
from pushcdn_tpu_torch.native import routeplan
from pushcdn_tpu_torch.native import uring as nuring
from pushcdn_tpu_torch.proto import metrics as metrics_mod

logger = logging.getLogger(__name__)

# ``PUSHCDN_PUMP``: ``auto`` (default) engages the fused pump when the
# composition probe passes; ``off`` disables it unconditionally.  There
# is deliberately no "force" value — the pump composes *on top of*
# ``--route-impl native`` + ``--io-impl uring``, and forcing it past a
# dead layer could only mislabel a bench.
PUMP_IMPL = {"0": "off", "off": "off", "false": "off", "no": "off",
             "disabled": "off"}.get(
    os.environ.get("PUSHCDN_PUMP", "auto").strip().lower(), "auto")

_warned_demote = False
_MAX_PEERS = 4096
_CHUNK_SLOTS = 64
_QUIESCE_TIMEOUT = 5.0


def configured_pump() -> str:
    return PUMP_IMPL


def set_pump_impl(value: str) -> None:
    """Test hook mirroring ``set_io_impl``."""
    global PUMP_IMPL, _warned_demote
    PUMP_IMPL = "off" if value in ("0", "off", "false", "no",
                                   "disabled") else "auto"
    _warned_demote = False


def resolve_pump(quiet: bool = False):
    """Composition probe: ``(ok, why)``.

    ``ok`` only when the route-plan kernel, the io_uring impl, and the
    pump library are ALL live.  On the first failed probe (unless
    ``quiet``) logs one demotion warning naming the dead layer: demote
    loudly once, count silently after.
    """
    global _warned_demote
    if PUMP_IMPL == "off":
        return False, "disabled (PUSHCDN_PUMP=off)"
    from pushcdn_tpu_torch.proto.transport import uring as umod
    failed = []
    if not routeplan.available():
        failed.append("route-plan kernel unavailable")
    if umod.resolve_io_impl() != "uring":
        if nuring.available():
            failed.append("io impl resolved to asyncio")
        else:
            failed.append("io_uring unavailable (%s)"
                          % nuring.probe_errname())
    if not failed and not npump.available():
        failed.append("pump library failed to build")
    if failed:
        why = "; ".join(failed)
        if not quiet and not _warned_demote:
            _warned_demote = True
            logger.warning("fused data-plane pump demoted to per-chunk "
                           "Python routing: %s", why)
        return False, why
    return True, "ok"


class PumpBinding:
    """One engaged peer: (Connection, UringStream) ↔ native peer slot."""

    __slots__ = ("state", "conn", "stream", "pid", "is_user", "key",
                 "fenced", "gate", "closed")

    def __init__(self, state: "PumpState", conn, stream, pid: int,
                 is_user: bool, key):
        self.state = state
        self.conn = conn
        self.stream = stream
        self.pid = pid
        self.is_user = is_user
        self.key = key
        self.fenced = False
        self.gate: Optional[asyncio.Future] = None
        self.closed = False

    def fence(self) -> None:
        """Synchronous — called from ``Connection._ensure_writer`` at
        enqueue time, before the event loop can run the route task, so
        the planner diverts this peer's frames to the writer queue."""
        if self.closed or self.fenced:
            return
        self.fenced = True
        st = self.state
        if not st.np_.closed:
            st.np_.set_fence(self.pid, True)
        st.fenced.add(self)

    def pending(self) -> int:
        st = self.state
        if self.closed or st.np_.closed:
            return 0
        return st.np_.peer_pending(self.pid)

    async def _await_drained(self) -> None:
        """Park until the native side has nothing queued or in flight
        for this peer (or the binding/engine dies)."""
        st = self.state
        while (not self.closed and not st.closed and not st.np_.closed
               and st.np_.peer_pending(self.pid) > 0):
            g = self.gate
            if g is None or g.done():
                g = self.gate = st.engine._loop.create_future()
                st.gated.add(self)
            await asyncio.shield(g)

    async def write_gate(self) -> None:
        """Stream-level fence: before a Python write may queue bytes on
        this fd, divert future planned frames to the writer path and
        wait out any native runs already queued — no interleave."""
        if self.closed:
            return
        self.fence()
        if self.pending() > 0:
            await self._await_drained()

    async def quiesce_and_drop(self) -> None:
        """Graceful close: let queued native runs reach the wire before
        the stream flushes/FINs, then free the peer slot."""
        try:
            await asyncio.wait_for(self._await_drained(), _QUIESCE_TIMEOUT)
        except (asyncio.TimeoutError, OSError):
            pass
        self.state.unbind(self, drop=True)

    def drop_now(self) -> None:
        """Abort path: synchronous; in-flight CQEs for this peer drain
        their buffer refs natively, the slot frees at quiesce."""
        self.state.unbind(self, drop=True)


class PumpState:
    """Per-engine pump: native handle + engagement/fence/lease policy.

    ONE per ``UringEngine`` (i.e. per event loop), claimed by the first
    RouteState that asks; a second broker sharing the loop keeps plain
    cut-through (honest limitation — peer slots key on fd, and two
    brokers' route tables can't share one slot map).
    """

    __slots__ = ("engine", "broker", "np_", "owner", "bindings", "by_pid",
                 "pending_engage", "leases", "fenced", "gated",
                 "slots_version", "slots_dirty", "closed",
                 "escalations", "pump_calls", "pump_frames",
                 "python_chunks", "_esc_cache")

    def __init__(self, engine, broker, native: "npump.NativePump"):
        self.engine = engine
        self.broker = broker
        self.np_ = native
        self.owner = None
        self.bindings: dict = {}        # stream -> PumpBinding
        self.by_pid: dict = {}          # pid -> PumpBinding
        self.pending_engage: dict = {}  # stream -> (conn, is_user, key)
        self.leases: dict = {}          # chunk_slot -> (BytesLease, buf)
        self.fenced: set = set()
        self.gated: set = set()
        self.slots_version = -2         # rs.version never starts at -2
        self.slots_dirty = True
        self.closed = False
        self.escalations: dict = {}     # reason -> count (summary mirror)
        self.pump_calls = 0             # route_chunk calls with >=1 pumped pair
        self.pump_frames = 0
        self.python_chunks = 0          # calls where everything escalated
        self._esc_cache: dict = {}

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def create(cls, engine, broker, owner) -> Optional["PumpState"]:
        existing = getattr(engine, "pump_state", None)
        if existing is not None and not existing.closed:
            return existing if existing.owner is owner else None
        native = npump.NativePump.create(
            engine.ring, max_peers=_MAX_PEERS, chunk_slots=_CHUNK_SLOTS)
        if native is None:
            return None
        ps = cls(engine, broker, native)
        ps.owner = owner
        engine.pump_state = ps
        return ps

    def engine_dead(self) -> None:
        """Engine teardown: destroy the native pump BEFORE the ring
        closes (the pump preps SQEs on the ring's memory), drop every
        parked lease, and wake any gated writers."""
        if self.closed:
            return
        self.closed = True
        for b in list(self.bindings.values()):
            b.closed = True
            g = b.gate
            if g is not None and not g.done():
                g.set_result(None)
            if b.stream._pump_binding is b:
                b.stream._pump_binding = None
                b.stream._pump_state = None
        self.bindings.clear()
        self.by_pid.clear()
        self.fenced.clear()
        self.gated.clear()
        for stream in self.pending_engage:
            stream._pump_state = None
        self.pending_engage.clear()
        self.leases.clear()
        self.np_.destroy()
        if getattr(self.engine, "pump_state", None) is self:
            self.engine.pump_state = None

    # -- escalation accounting ----------------------------------------------

    def _esc(self, reason: str, n: int = 1) -> None:
        if n <= 0:
            return
        c = self._esc_cache.get(reason)
        if c is None:
            c = metrics_mod.PUMP_ESCALATIONS.labels(reason=reason)
            self._esc_cache[reason] = c
        c.inc(n)
        self.escalations[reason] = self.escalations.get(reason, 0) + n

    # -- engagement ----------------------------------------------------------

    @staticmethod
    def _python_idle(stream, conn) -> bool:
        """No byte Python has accepted may still be waiting: TX deque
        empty, no chain in flight, writer queue empty, mutex free."""
        return (not stream._tx and stream._tx_flight == 0
                and stream._tx_err is None and not stream._closed
                and conn._send_q.empty()
                and not conn._write_mutex.locked())

    def request_engage(self, stream, conn, is_user: bool, key) -> None:
        if (self.closed or stream in self.bindings
                or stream in self.pending_engage):
            return
        self.pending_engage[stream] = (conn, is_user, key)
        stream._pump_state = self
        if self._python_idle(stream, conn):
            self._try_engage(stream)

    def _try_engage(self, stream) -> None:
        info = self.pending_engage.get(stream)
        if info is None or self.closed or self.np_.closed:
            return
        conn, is_user, key = info
        if not self._python_idle(stream, conn):
            return  # retried at the next stream-idle transition
        del self.pending_engage[stream]
        pid = self.np_.add_peer(stream._fd)
        if pid < 0:
            self._esc("capacity")
            stream._pump_state = None
            return
        b = PumpBinding(self, conn, stream, pid, is_user, key)
        self.bindings[stream] = b
        self.by_pid[pid] = b
        stream._pump_binding = b
        self.slots_dirty = True

    def on_stream_idle(self, stream) -> None:
        """Hook from ``UringStream._on_send_cqe`` at TX-idle: the only
        moment engagement/unfencing is both safe and cheap to check."""
        if self.closed:
            return
        if stream in self.pending_engage:
            self._try_engage(stream)
            return
        b = stream._pump_binding
        if b is not None and b.fenced and not b.closed:
            self._maybe_unfence(b)

    def _maybe_unfence(self, b: PumpBinding) -> None:
        if (self._python_idle(b.stream, b.conn)
                and not self.np_.closed
                and self.np_.peer_pending(b.pid) == 0):
            b.fenced = False
            self.np_.set_fence(b.pid, False)
            self.fenced.discard(b)

    def _sweep_unfence(self) -> None:
        for b in list(self.fenced):
            if b.closed:
                self.fenced.discard(b)
            else:
                self._maybe_unfence(b)

    def unbind(self, b: PumpBinding, drop: bool) -> None:
        if b.closed:
            return
        b.closed = True
        self.bindings.pop(b.stream, None)
        self.by_pid.pop(b.pid, None)
        self.fenced.discard(b)
        self.gated.discard(b)
        if b.stream._pump_binding is b:
            b.stream._pump_binding = None
            b.stream._pump_state = None
        self.slots_dirty = True
        g = b.gate
        if g is not None and not g.done():
            g.set_result(None)
        if drop and not self.np_.closed:
            self.np_.drop_peer(b.pid)
            self._release_slots(self.np_.take_released())

    def _peer_errored(self, b: PumpBinding, err: int) -> None:
        """Deferred (call_soon) from the drain loop.  Disengage ONLY —
        the Python send path rediscovers the broken socket and makes
        the byte-identical disconnect decision the non-pumped path
        would have made."""
        if self.closed or b.closed:
            return
        self._esc("peer_error_event")
        self.unbind(b, drop=True)

    # -- slot map ------------------------------------------------------------

    def _resync(self, rs) -> None:
        """Rebuild the native slot→peer map against the CURRENT
        snapshot: O(engaged peers), revalidating each binding's
        identity against live Connections state (a slot recycled to a
        different user must never inherit the old user's fd)."""
        conns = self.broker.connections
        local = conns.shard_id
        m = np.full(rs.user_cap + rs.broker_cap, -1, np.int32)
        for b in self.bindings.values():
            if b.closed:
                continue
            if b.is_user:
                slot = rs.user_slot.get(b.key)
                if (slot is None or rs.user_shard[slot] != local
                        or conns.get_user_connection(b.key) is not b.conn):
                    continue
            else:
                bslot = rs.broker_slot.get(b.key)
                if (bslot is None or rs.broker_shard[bslot] is not None
                        or conns.get_broker_connection(b.key) is not b.conn):
                    continue
                slot = rs.user_cap + bslot
            m[slot] = b.pid
        self.np_.set_slots(m)
        self.slots_version = rs.version
        self.slots_dirty = False

    def _request_engagements(self, rs, resid_peers) -> None:
        """Residual-unmapped peers are the engagement demand signal:
        resolve each against live Connections and register eligible
        ones (engaged at their next idle transition)."""
        conns = self.broker.connections
        local = conns.shard_id
        engine = self.engine
        for peer in np.unique(resid_peers).tolist():
            if peer < rs.user_cap:
                key = rs.slot_user[peer]
                if key is None or rs.user_shard[peer] != local:
                    continue
                conn = conns.get_user_connection(key)
                is_user = True
            else:
                bslot = peer - rs.user_cap
                ident = rs.slot_broker[bslot]
                if ident is None or rs.broker_shard[bslot] is not None:
                    continue
                conn = conns.get_broker_connection(ident)
                key = ident
                is_user = False
            if conn is None:
                continue
            stream = conn._stream
            if (getattr(stream, "_engine", None) is not engine
                    or stream._closed):
                continue  # asyncio transport / foreign loop: never pumped
            self.request_engage(stream, conn, is_user, key)

    # -- leases --------------------------------------------------------------

    def _release_slots(self, slots) -> None:
        for s in slots:
            self.leases.pop(s, None)  # dropping the lease releases it

    # -- the hot path --------------------------------------------------------

    def plan_and_pump(self, rs, chunk, buf, offs, lens, pos: int,
                      mode: int):
        """Plan + natively send one batch.  Returns ``(consumed, stop,
        resid_peers, resid_frames, pumped_pairs)`` — residual pairs go
        through the caller's existing ``_send_plan``; ``pumped_pairs``
        splits the frame attribution between path=pump and
        path=cutthrough."""
        np_ = self.np_
        # released-slot channel FIRST: a recycled chunk slot must not
        # alias a lease still parked from its previous life
        self._release_slots(np_.take_released())
        if self.fenced:
            self._sweep_unfence()
        if self.slots_dirty or self.slots_version != rs.version:
            self._resync(rs)
        consumed, stop, resid_peers, resid_frames, meta = np_.route_chunk(
            rs.planner._handle, buf, offs, lens, pos, mode)
        slot = int(meta[npump.META_CHUNK_SLOT])
        if slot >= 0:
            # native runs reference the chunk buffer: park the pool
            # lease until the slot's refcount drains to zero
            self.leases[slot] = (chunk.lease(), buf)
        if meta[npump.META_SQES] > 0:
            eng = self.engine
            eng._need_submit = True
            eng._schedule_kick()
        pumped = int(meta[npump.META_PAIRS])
        if pumped:
            self.pump_calls += 1
            self.pump_frames += pumped
            u = int(meta[npump.META_USER_PAIRS])
            if u:
                metrics_mod.EGRESS_FRAMES_USER.inc(u)
            if pumped - u:
                metrics_mod.EGRESS_FRAMES_BROKER.inc(pumped - u)
        elif consumed:
            self.python_chunks += 1
        self._esc("unengaged", int(meta[npump.META_RESID_UNMAPPED]))
        self._esc("fenced", int(meta[npump.META_RESID_FENCED]))
        self._esc("peer_error", int(meta[npump.META_RESID_ERROR]))
        self._esc("chunk_slots", int(meta[npump.META_NO_CHUNK_SLOT]))
        if stop == routeplan.STOP_RESIDUAL:
            self._esc("control")
        if len(resid_peers) and meta[npump.META_RESID_UNMAPPED]:
            self._request_engagements(rs, resid_peers)
        return consumed, stop, resid_peers, resid_frames, pumped

    # -- completion plane ----------------------------------------------------

    def _poll_gates(self) -> None:
        np_ = self.np_
        for b in list(self.gated):
            if b.closed or np_.closed or np_.peer_pending(b.pid) == 0:
                g = b.gate
                if g is not None and not g.done():
                    g.set_result(None)
                self.gated.discard(b)

    def drain(self) -> None:
        """The engine's CQ drain when a pump is live: native code walks
        the CQ, consumes pump-tagged CQEs (advancing chains, prepping
        starved ones), and hands everything else back for the normal
        Python dispatch."""
        eng = self.engine
        np_ = self.np_
        while True:
            if np_.closed or self.closed:
                return
            cqes, events, n_prepped = np_.drain()
            if n_prepped:
                eng._need_submit = True
            self._release_slots(np_.take_released())
            if events:
                loop = eng._loop
                for etype, pid, arg in events:
                    if etype == npump.EV_PEER_ERROR:
                        b = self.by_pid.get(pid)
                        if b is not None and not b.closed:
                            loop.call_soon(self._peer_errored, b, arg)
            if self.gated:
                # gates resolve by polling, not by trusting the event
                # channel (it is bounded and may have dropped an IDLE)
                self._poll_gates()
            if cqes:
                eng.cqes += len(cqes)
                complete = eng._complete
                for ud, res, flags in cqes:
                    complete(ud, res, flags)
                    if eng.closed or self.closed:
                        return
            if not cqes and not events:
                return

    # -- observability -------------------------------------------------------

    def summary(self) -> dict:
        native = None if self.np_.closed else self.np_.stats()
        return {
            "engaged_peers": len(self.bindings),
            "fenced_peers": len(self.fenced),
            "pending_engage": len(self.pending_engage),
            "parked_leases": len(self.leases),
            "slots_version": self.slots_version,
            "pump_calls": self.pump_calls,
            "pump_frames": self.pump_frames,
            "all_residual_chunks": self.python_chunks,
            "escalations": dict(self.escalations),
            "native": native,
        }
