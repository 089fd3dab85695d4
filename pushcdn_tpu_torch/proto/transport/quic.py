"""QUIC-class UDP transport.

Capability parity with cdn-proto/src/connection/protocols/quic.rs:37-277
(quinn): a connection-oriented, reliable, ordered byte stream over UDP with

- a connect handshake (SYN/SYNACK with client-chosen connection id — the
  analog of quinn's connection establishment),
- exactly one bidirectional stream per connection, bootstrapped by a single
  byte written by the client and consumed by the server during finalize
  (parity quic.rs:148-149, :224-266 — quinn streams don't exist on the
  acceptor until bytes arrive, so the reference sends one byte; we mirror
  the wire behavior),
- 5 s keep-alive pings and an idle timeout (parity quic.rs keep_alive),
- a real soft-close: FIN is retransmitted until FINACK'd, waiting up to 3 s
  (parity quic.rs finish + stopped with a 3 s window),
- loss recovery: cumulative ACKs + timer-driven retransmission of the
  earliest unacked segment, and a byte-denominated send window so a slow
  receiver backpressures the sender,
- congestion control (the analog of quinn's CC stack, quic.rs:37-146):
  NewReno — slow start / congestion avoidance over an RFC 6298 RTT
  estimator, 3-dup-ACK fast retransmit + fast recovery with partial-ACK
  retransmission, RTO collapse to 2 segments, and token-bucket pacing at
  ~1.25x cwnd/srtt so a window never lands on the path as one burst,
- path-MTU probing (the analog of QUIC DPLPMTUD, RFC 9000 §14.3): each
  direction probes with padded datagrams and adopts the largest size the
  peer acknowledges — on loopback/jumbo paths segments grow from 1200 B
  to up to ~64 KB, cutting per-datagram syscall cost ~50×,
- delayed ACKs: in-order data is acknowledged on a short timer or every
  ACK_EVERY_BYTES, out-of-order data immediately (so fast-retransmit
  still sees duplicate ACKs promptly).

This is not RFC 9000 (the environment ships no QUIC stack and installing
one is disallowed); it is a minimal reliable-datagram transport with the
same operational envelope, behind the same `Protocol` seam, so a real QUIC
stack can replace the packet layer without touching callers.

**Encryption:** the stream is TLS 1.3-secured, the same layering real QUIC
uses (RFC 9001 runs the TLS handshake over QUIC's reliable crypto
streams): the ARQ provides reliable ordered delivery and
``TlsStream`` (ssl.MemoryBIO) runs the TLS state machine over it, keyed
by the same local/production CA plumbing as the TcpTls edge — parity with
the reference's quinn+rustls configuration (quic.rs:37-146; cert config
:52-86). The bootstrap byte and all framed messages ride inside TLS;
only SYN/ACK/PROBE/PING control datagrams and TLS records are visible on
the wire.

Packet layout (all integers big-endian):
    [1B type][8B conn_id][type-specific]
    SYN/SYNACK/PING/RST: nothing further
    DATA:   [8B stream offset][payload <= negotiated MTU]
    ACK:    [8B cumulative ack offset][4B ack_delay us]
    FIN:    [8B final stream offset]
    FINACK: nothing further
    PROBE:  [4B datagram length][zero padding to that length]
    PROBEACK: [4B datagram length]

The port's copy of ``pushcdn_tpu.proto.transport.quic``: the same wire
format byte for byte, so a client of either package talks to a listener
of the other.
"""

from __future__ import annotations

import asyncio
import errno
import logging
import os
import ssl
import struct
import time
from collections import deque
from itertools import islice
from typing import Dict, Optional, Tuple

from pushcdn_tpu_torch.proto.crypto.tls import (
    Certificate,
    client_context_for,
    local_certificate,
)
from pushcdn_tpu_torch.proto.error import ErrorKind, bail, parse_endpoint
from pushcdn_tpu_torch.proto.limiter import Limiter, NO_LIMIT
from pushcdn_tpu_torch.proto.transport.base import (
    CONNECT_TIMEOUT_S,
    Connection,
    Listener,
    Protocol,
    RawStream,
    UnfinalizedConnection,
)
from pushcdn_tpu_torch.proto.transport.tls_stream import TlsStream

logger = logging.getLogger("pushcdn.transport")

(_SYN, _SYNACK, _DATA, _ACK, _FIN, _FINACK, _PING, _RST,
 _PROBE, _PROBEACK) = range(1, 11)


def _socket_for_first_usable(infos, action):
    """Iterate ALL ``getaddrinfo`` results (dual-stack hostnames resolve
    to v6 first on many hosts; a v6-less host must fall through to the v4
    record — the behavior ``create_datagram_endpoint`` used to give this
    transport). ``action(sock, addr)`` attempts connect/bind; the first
    family that completes wins. Raises the LAST OSError when none do."""
    import socket as _socket
    last_exc: Optional[Exception] = None
    for family, stype, _pr, _cn, addr in infos:
        try:
            sock = _socket.socket(family, stype)
        except OSError as exc:
            last_exc = exc
            continue
        try:
            sock.setblocking(False)
            _tune_socket(sock)
            action(sock, addr)
            return sock
        except (OSError, TypeError, ValueError) as exc:
            # OSError: unroutable/unsupported family on this host;
            # Type/ValueError: family/address-shape mismatch from a
            # degenerate resolver row — either way, try the next record
            last_exc = exc
            sock.close()
    if isinstance(last_exc, OSError):
        raise last_exc
    # callers translate OSError into the typed Error(CONNECTION); a
    # degenerate row's TypeError/ValueError must not escape as-is
    raise OSError(f"no usable getaddrinfo result ({last_exc!r})")


def _tune_socket(sock) -> None:
    import socket as _socket
    for opt in (_socket.SO_RCVBUF, _socket.SO_SNDBUF):
        try:
            sock.setsockopt(_socket.SOL_SOCKET, opt, SOCK_BUF)
        except OSError:
            pass
    # Path-MTU discovery needs the don't-fragment bit (RFC 8899 §4.1):
    # without it the kernel IP-fragments oversized probes, they arrive
    # reassembled, and probing "confirms" a size the path can't carry as
    # single packets. With DF set, an oversized send fails locally
    # (EMSGSIZE, surfaced to on_msgsize_error) or is dropped by the path —
    # either way the probe is simply never acknowledged.
    try:
        sock.setsockopt(_socket.IPPROTO_IP, _socket.IP_MTU_DISCOVER,
                        _socket.IP_PMTUDISC_DO)
    except (OSError, AttributeError):
        pass  # non-Linux: probing still converges, just without DF

_HDR = struct.Struct(">BQ")      # type, conn_id
_OFF = struct.Struct(">Q")       # stream offset / ack offset
_PLEN = struct.Struct(">I")      # probe datagram length
_ACK_DELAY = struct.Struct(">I")  # ACK-held time, microseconds (QUIC's
                                  # ack_delay: subtracted from RTT samples
                                  # so delayed ACKs don't inflate srtt and
                                  # spuriously activate pacing/RTO growth)

MTU_PAYLOAD = 1200               # conservative floor; fits any sane path MTU
_DATA_OVERHEAD = _HDR.size + _OFF.size
# probe total-datagram sizes, ascending; the largest PROBEACK'd one wins
PROBE_DATAGRAM_SIZES = (4096, 16384, 65000)
PROBE_ATTEMPTS = 3
PROBE_INTERVAL_S = 0.15
# EMSGSIZE within this window of a probe send is the probe itself bouncing
# off a smaller link (expected; the probed MTU was validated by PROBEACK) —
# outside it, it's the path shrinking under DATA and the MTU must clamp
PROBE_GRACE_S = 1.0
SEND_WINDOW_MAX = 2 * 1024 * 1024  # flow-control cap on unacked bytes
                                 # (kept under SOCK_BUF so one window
                                 # can never overflow the peer's kernel
                                 # buffer outright)
CWND_INITIAL_SEGS = 16           # initial congestion window (segments)
MIN_RTO_S = 0.2                  # RTO floor (srtt + 4*rttvar clamped here).
                                 # Generous on purpose: a same-process
                                 # receiver stalls its event loop tens of ms
                                 # on big memcpys/TLS records, and a floor
                                 # below that fires spurious RTOs that
                                 # collapse cwnd repeatedly (RFC 6298 uses
                                 # a 1 s floor; fast loss recovery is the
                                 # dup-ACK path's job, not the timer's)
PACE_SRTT_FLOOR_S = 0.005        # below this RTT pacing is a no-op (loopback)
ACK_DELAY_S = 0.02               # delayed-ACK timer (in-order data)
ACK_EVERY_BYTES = 64 * 1024      # ...or after this many unacked rx bytes
ACK_EVERY_DATAGRAMS = 2          # ...or every 2nd data datagram (QUIC's
                                 # max_ack_delay companion rule: keeps the
                                 # sender ACK-clocked during slow start
                                 # when datagrams are still MTU-small)
SOCK_BUF = 4 * 1024 * 1024       # kernel socket buffers (burst absorption)
DUP_ACK_FAST_RETX = 3            # NewReno-style fast retransmit threshold
RTO_BURST = 64                   # segments re-sent per RTO expiry
RTO_INITIAL_S = 0.2
RTO_MAX_S = 2.0
MAX_RETX = 12                    # ~20 s of backoff retries before declaring the peer dead
KEEPALIVE_S = 5.0                # parity: quinn keep_alive_interval 5 s
IDLE_TIMEOUT_S = 30.0
SOFT_CLOSE_WAIT_S = 3.0          # parity: quic.rs waits 3 s for `stopped`
_BOOTSTRAP = b"\x51"             # the single stream-opening byte


class _UdpStream(RawStream):
    """One reliable ordered stream over a datagram sender callable.

    ``send_packet(data)`` must transmit one UDP datagram to the peer.
    Incoming packets are fed by the owning endpoint via :meth:`on_packet`.
    """

    def __init__(self, conn_id: int, send_packet, on_closed=None):
        self._id = conn_id
        self._send_packet = send_packet
        self._on_closed = on_closed

        # send side
        self._next_off = 0                       # next byte offset to assign
        self._acked = 0                          # cumulative acked offset
        self._unacked: "Dict[int, list]" = {}    # off -> [payload, last_sent, retx]
        self._send_order: deque = deque()        # offsets in send order
        self._window_waiters: list = []
        self._fin_sent_off: Optional[int] = None
        self._finack = asyncio.Event()
        self._dup_acks = 0
        self._mtu = MTU_PAYLOAD                  # grows via path-MTU probing
        self._last_probe_sent = 0.0

        # congestion control: NewReno cwnd over the byte stream (the
        # reference inherits quinn's CC stack, quic.rs:37-146 — without
        # one, a static window floods lossy paths and collapses). Slow
        # start doubles per RTT until ssthresh; 3 dup-ACKs => halve +
        # fast recovery (dup-ACK inflation, partial-ACK retransmit); RTO
        # => back to 2 segments. RTO itself comes from an RFC 6298-style
        # srtt/rttvar estimator (Karn's rule: never sample retransmitted
        # segments), and writes are paced at ~1.25x cwnd/srtt so a whole
        # window never lands on the path as one burst.
        self._cwnd = float(CWND_INITIAL_SEGS * MTU_PAYLOAD)
        self._ssthresh = float("inf")
        self._in_recovery = False
        self._recover = 0                        # NewReno recovery point
        self._srtt: Optional[float] = None
        self._rttvar = 0.0
        self._min_rtt: Optional[float] = None  # true-path floor: immune to
                                               # scheduling-contention spikes
        self._pace_tokens = self._cwnd
        self._pace_last = time.monotonic()
        self._last_retx_t = 0.0   # RTT-sample epoch (Karn, strengthened)

        # receive side
        self._expected = 0
        self._ooo: Dict[int, bytes] = {}
        self._rbuf = bytearray()
        self._rbuf_wake = asyncio.Event()
        self._peer_fin: Optional[int] = None
        self._eof = False
        self._last_acked_rx = 0                  # _expected at last ACK sent
        self._ack_handle = None                  # pending delayed-ACK timer
        self._ack_pending_since = None           # arrival time of oldest
                                                 # in-order byte not yet ACKed
        self._rx_since_ack = 0                   # data datagrams since last ACK

        # batched-receive ACK coalescing (see begin/end_rx_batch): the
        # endpoint's drain loop brackets a whole socket backlog, and the
        # per-datagram ACK decisions collapse into one per wakeup
        self._rx_batched = False
        self._batch_ooo = 0
        self._batch_reack = False
        self._batch_progress = False

        self._error: Optional[Exception] = None
        self._closed = False
        self._last_recv = time.monotonic()
        self._rto = RTO_INITIAL_S
        self._timer = asyncio.create_task(self._timer_loop())
        self._prober = asyncio.create_task(self._probe_mtu())

    # -- packet ingress ------------------------------------------------------

    def on_packet(self, ptype: int, body: bytes) -> None:
        self._last_recv = time.monotonic()
        # UDP is the attack surface: a short/garbled datagram must be
        # DROPPED, never allowed to raise struct.error out of the
        # protocol callback (PROBE/PROBEACK bodies are already
        # length-guarded below; RST/FINACK/PING carry no body)
        if ptype in (_DATA, _ACK, _FIN) and len(body) < _OFF.size:
            return
        if ptype == _DATA:
            off = _OFF.unpack_from(body)[0]
            payload = body[_OFF.size:]
            if off < self._expected:
                # duplicate of delivered data: re-ACK immediately so a
                # retransmitting sender converges (once per batched drain)
                if self._rx_batched:
                    self._batch_reack = True
                else:
                    self._flush_ack()
            elif off == self._expected:
                # QUIC semantics: ack_delay is measured from the arrival
                # of the NEWEST data the ACK covers (the sender keys its
                # RTT sample to the newest acked segment), so overwrite on
                # every in-order arrival rather than set-once
                self._ack_pending_since = self._last_recv
                self._rbuf += payload
                self._expected += len(payload)
                while self._expected in self._ooo:
                    seg = self._ooo.pop(self._expected)
                    self._rbuf += seg
                    self._expected += len(seg)
                self._rbuf_wake.set()
                # in-order: delay the ACK — flushed by the QUIC-standard
                # every-2nd-datagram rule (keeps slow start ACK-clocked
                # while datagrams are small), the byte threshold (bounds
                # ACK latency once MTU probing makes datagrams huge), or
                # the timer. Inside a batched drain the decision defers
                # to end_rx_batch: one coalesced ACK per socket wakeup.
                self._rx_since_ack += 1
                if self._rx_batched:
                    self._batch_progress = True
                elif (self._rx_since_ack >= ACK_EVERY_DATAGRAMS
                        or self._expected - self._last_acked_rx
                        >= ACK_EVERY_BYTES):
                    self._flush_ack()
                else:
                    self._schedule_ack()
            else:
                self._ooo.setdefault(off, payload)
                # out-of-order: ACK immediately; the duplicate cumulative
                # ACKs drive the sender's fast retransmit (batched drains
                # coalesce but preserve the dup count, capped — see
                # end_rx_batch)
                if self._rx_batched:
                    self._batch_ooo += 1
                else:
                    self._flush_ack()
            self._check_eof()
        elif ptype == _PROBE:
            # the datagram made it across the path — confirm its size, but
            # only if the claimed length matches what actually arrived
            if len(body) >= _PLEN.size:
                (plen,) = _PLEN.unpack_from(body)
                if plen == _HDR.size + len(body):
                    self._tx(_PROBEACK, _PLEN.pack(plen))
        elif ptype == _PROBEACK:
            # accept only sizes we genuinely probe with — an arbitrary
            # peer-supplied length could push _mtu past what sendto allows
            if len(body) >= _PLEN.size:
                (plen,) = _PLEN.unpack_from(body)
                if plen in PROBE_DATAGRAM_SIZES:
                    new_mtu = max(self._mtu, plen - _DATA_OVERHEAD)
                    if new_mtu > self._mtu and self._ssthresh == float("inf"):
                        # cwnd is segment-denominated CC state expressed in
                        # bytes; a probed-up path just redefined "segment".
                        # Before any loss evidence (ssthresh untouched),
                        # re-express the window in the new units — else a
                        # 64 KB-MTU path ramps from a 1200 B-era window
                        # through queue-bloated RTTs, and short flows
                        # measure the ramp instead of the path. CAPPED at
                        # 4x the current window per probe step: one
                        # PROBEACK is one delivery proof at the new size,
                        # not license to dump CWND_INITIAL_SEGS jumbo
                        # segments on a shallow-buffered path in a single
                        # burst — the ascending probe ladder re-expresses
                        # in <=4x steps and still reaches the full window
                        # on paths that confirm every size. Pacing still
                        # smooths the larger window onto the wire.
                        self._cwnd = max(self._cwnd, min(
                            float(CWND_INITIAL_SEGS * new_mtu),
                            4.0 * self._cwnd))
                    self._mtu = new_mtu
        elif ptype == _ACK:
            ack = _OFF.unpack_from(body)[0]
            ack_delay_s = 0.0
            if len(body) >= _OFF.size + _ACK_DELAY.size:
                # clamp to what a well-behaved peer can legitimately hold
                # (timer + scheduling slack — QUIC's max_ack_delay clamp):
                # an inflated field must not pin min_rtt/srtt to the floor
                ack_delay_s = min(
                    _ACK_DELAY.unpack_from(body, _OFF.size)[0] / 1e6,
                    2.0 * ACK_DELAY_S)
            now = time.monotonic()
            if ack > self._acked:
                newly = ack - self._acked
                self._acked = ack
                self._dup_acks = 0
                rtt_sample = None
                while self._send_order:
                    off = self._send_order[0]
                    seg = self._unacked.get(off)
                    if seg is None or off + len(seg[0]) > ack:
                        break
                    # Karn, strengthened: never-retransmitted AND sent
                    # after the last loss event — a segment that sat in
                    # the queue behind a repair measures sojourn, not RTT
                    if seg[2] == 0 and seg[1] > self._last_retx_t:
                        rtt_sample = now - seg[1]
                    self._send_order.popleft()
                    self._unacked.pop(off, None)
                if rtt_sample is not None:
                    # QUIC semantics: the peer held this ACK (delayed-ACK
                    # timer / byte threshold); that hold time is not path
                    # RTT. min_rtt takes the RAW sample (RFC 9002 §5.2):
                    # it gates pacing, and an unauthenticated
                    # peer-reported delay must not be able to deflate it.
                    # The adjusted sample floors at min_rtt (§5.3), so a
                    # maxed-out delay stamp can't drag srtt below the
                    # path's observed floor either.
                    floor = self._min_rtt if self._min_rtt is not None \
                        else 5e-5
                    floor = min(floor, rtt_sample)
                    self._rtt_update(
                        max(rtt_sample - ack_delay_s, floor, 5e-5),
                        raw_sample=rtt_sample)
                if self._in_recovery:
                    if ack >= self._recover:
                        # full recovery: deflate to ssthresh
                        self._in_recovery = False
                        self._cwnd = max(self._ssthresh, 2.0 * self._mtu)
                    elif self._send_order:
                        # partial ACK: the next hole is also lost —
                        # retransmit it now and DEFLATE by the data the
                        # ACK took out of flight, plus one segment
                        # (RFC 6582 §3.2: without this, every partial
                        # ACK releases a fresh burst into the congested
                        # path on top of the retransmit)
                        self._cwnd = max(self._cwnd - newly + self._mtu,
                                         2.0 * self._mtu)
                        off = self._send_order[0]
                        seg = self._unacked.get(off)
                        if seg is not None:
                            seg[1] = now
                            seg[2] += 1
                            self._last_retx_t = now
                            self._tx(_DATA, _OFF.pack(off) + seg[0])
                elif self._cwnd < self._ssthresh:
                    self._cwnd += newly                       # slow start
                else:                                         # avoidance
                    self._cwnd += self._mtu * newly / self._cwnd
                if not self._in_recovery and self._send_order:
                    # ACK-clocked repair: an RTO-stale front hole is
                    # resent NOW instead of waiting for the next 50 ms
                    # timer tick — this is what drains a multi-hole
                    # window at ACK speed after a burst loss
                    off = self._send_order[0]
                    seg = self._unacked.get(off)
                    if seg is not None and now - seg[1] >= self._rto:
                        seg[1] = now
                        seg[2] += 1
                        self._last_retx_t = now
                        self._tx(_DATA, _OFF.pack(off) + seg[0])
                self._wake_window()
            elif ack == self._acked and self._send_order:
                # duplicate ACK: the peer is holding out-of-order data past a
                # hole — fast-retransmit the earliest unacked segment and
                # enter fast recovery (halve the window once per loss event)
                self._dup_acks += 1
                if self._in_recovery:
                    self._cwnd += self._mtu   # dup-ACK inflation
                    self._wake_window()
                elif self._dup_acks >= DUP_ACK_FAST_RETX:
                    self._dup_acks = 0
                    self._in_recovery = True
                    self._recover = self._next_off
                    self._ssthresh = max(self._inflight() / 2.0,
                                         2.0 * self._mtu)
                    self._cwnd = self._ssthresh + 3.0 * self._mtu
                    off = self._send_order[0]
                    seg = self._unacked.get(off)
                    if seg is not None:
                        seg[1] = now
                        seg[2] += 1
                        self._last_retx_t = now
                        self._tx(_DATA, _OFF.pack(off) + seg[0])
        elif ptype == _FIN:
            self._peer_fin = _OFF.unpack_from(body)[0]
            self._flush_ack()
            self._tx(_FINACK, b"")
            self._check_eof()
        elif ptype == _FINACK:
            self._finack.set()
        elif ptype == _PING:
            pass  # any packet refreshes last_recv
        elif ptype == _RST:
            self._poison(ConnectionResetError("peer reset the connection"))

    def _check_eof(self) -> None:
        if self._peer_fin is not None and self._expected >= self._peer_fin:
            self._eof = True
            self._rbuf_wake.set()

    # -- delayed ACKs --------------------------------------------------------

    def _ack_delay_us(self) -> int:
        """Time this ACK's newest-covered data sat waiting, microseconds."""
        since, self._ack_pending_since = self._ack_pending_since, None
        if since is None:
            return 0
        held = time.monotonic() - since
        return min(0xFFFFFFFF, max(0, int(held * 1e6)))

    def _flush_ack(self) -> None:
        if self._ack_handle is not None:
            self._ack_handle.cancel()
            self._ack_handle = None
        self._last_acked_rx = self._expected
        self._rx_since_ack = 0
        self._tx(_ACK, _OFF.pack(self._expected)
                 + _ACK_DELAY.pack(self._ack_delay_us()))

    def begin_rx_batch(self) -> None:
        """Enter batched-receive mode for one endpoint drain: per-datagram
        ACK decisions defer to :meth:`end_rx_batch` so a whole socket
        backlog generates ONE coalesced ACK instead of one per datagram
        (the unbatched per-packet rules still apply outside a drain —
        tests and exotic endpoints feed ``on_packet`` directly)."""
        self._rx_batched = True
        self._batch_ooo = 0
        self._batch_reack = False
        self._batch_progress = False

    def end_rx_batch(self) -> None:
        """Emit the batch's coalesced ACK decision."""
        self._rx_batched = False
        if self._closed:
            return
        if self._batch_ooo:
            # A hole is outstanding past delivered data: send the
            # cumulative ACK, duplicated up to the fast-retransmit
            # threshold so the sender's dup-ACK clocking sees the same
            # evidence the per-datagram path produced (each OOO datagram
            # used to emit one) without re-ACKing a 64-datagram burst
            # 64 times. When the same drain ALSO advanced _expected, the
            # cumulative ACK reads as progress at the sender — not a
            # duplicate — so it doesn't count toward the threshold and
            # the full dup count follows it; otherwise the cumulative
            # ACK itself is the first duplicate.
            dups = min(self._batch_ooo, DUP_ACK_FAST_RETX)
            if not self._batch_progress:
                dups -= 1
            self._flush_ack()
            for _ in range(dups):
                self._tx(_ACK, _OFF.pack(self._expected)
                         + _ACK_DELAY.pack(0))
        elif self._batch_progress:
            if (self._rx_since_ack >= ACK_EVERY_DATAGRAMS
                    or self._expected - self._last_acked_rx
                    >= ACK_EVERY_BYTES):
                self._flush_ack()
            else:
                self._schedule_ack()
        elif self._batch_reack:
            self._flush_ack()

    def _schedule_ack(self) -> None:
        if self._ack_handle is None:
            self._ack_handle = asyncio.get_running_loop().call_later(
                ACK_DELAY_S, self._delayed_ack_fire)

    def _delayed_ack_fire(self) -> None:
        self._ack_handle = None
        if not self._closed:
            self._flush_ack()

    # -- packet egress -------------------------------------------------------

    def _tx(self, ptype: int, body: bytes) -> None:
        try:
            self._send_packet(_HDR.pack(ptype, self._id) + body)
        except Exception:
            pass  # datagram sends are best-effort; the timer retransmits

    def _wake_window(self) -> None:
        waiters, self._window_waiters = self._window_waiters, []
        for fut in waiters:
            if not fut.done():
                fut.set_result(None)

    def _inflight(self) -> int:
        return self._next_off - self._acked

    # -- congestion control --------------------------------------------------

    def _rtt_update(self, sample: float,
                    raw_sample: Optional[float] = None) -> None:
        """RFC 6298 srtt/rttvar; RTO = srtt + 4*rttvar, clamped. min_rtt
        ratchets on the RAW (ack_delay-unadjusted) sample per RFC 9002
        §5.2 — it gates pacing, so peer-reported delay must not move it."""
        raw = sample if raw_sample is None else raw_sample
        if self._min_rtt is None or raw < self._min_rtt:
            self._min_rtt = raw
        if self._srtt is None:
            self._srtt = sample
            self._rttvar = sample / 2.0
        else:
            self._rttvar = 0.75 * self._rttvar + \
                0.25 * abs(self._srtt - sample)
            self._srtt = 0.875 * self._srtt + 0.125 * sample
        self._rto = min(max(MIN_RTO_S, self._srtt + 4.0 * self._rttvar),
                        RTO_MAX_S)

    def _window(self) -> float:
        """Effective send window: congestion-bound, flow-capped."""
        return min(SEND_WINDOW_MAX, max(self._cwnd, 2.0 * self._mtu))

    async def _pace(self, nbytes: int) -> None:
        """Token-bucket pacing at ~1.25x cwnd/srtt (burst cap = one cwnd).
        The on/off gate uses MIN RTT, not srtt: srtt absorbs receiver
        scheduling stalls (single-process peers share one event loop), and
        a contaminated estimate must not switch pacing on over a path
        whose true RTT is loopback-fast — each pace sleep costs ~1 ms of
        timer granularity per segment."""
        srtt = self._srtt
        if srtt is None or srtt <= PACE_SRTT_FLOOR_S:
            return
        if self._min_rtt is not None and self._min_rtt <= PACE_SRTT_FLOOR_S:
            return
        rate = 1.25 * max(self._cwnd, 2.0 * self._mtu) / srtt
        # burst cap must cover at least one segment: a probed-up MTU can
        # exceed a freshly-started cwnd, and a cwnd-only cap would make
        # the bucket unfillable (pace deadlock)
        cap = max(self._cwnd, 2.0 * self._mtu, float(nbytes))
        now = time.monotonic()
        self._pace_tokens = min(
            cap, self._pace_tokens + (now - self._pace_last) * rate)
        self._pace_last = now
        while self._pace_tokens < nbytes and self._error is None \
                and not self._closed:
            await asyncio.sleep(min(0.01, (nbytes - self._pace_tokens) / rate))
            now = time.monotonic()
            self._pace_tokens = min(
                cap, self._pace_tokens + (now - self._pace_last) * rate)
            self._pace_last = now
        self._pace_tokens -= nbytes

    # -- path-MTU probing ----------------------------------------------------

    async def _probe_mtu(self) -> None:
        """DPLPMTUD-lite: pad datagrams to candidate sizes; the peer
        PROBEACKs whatever actually arrives. Lost probes (path too small)
        simply never raise ``_mtu``. Runs once per connection."""
        try:
            for attempt in range(PROBE_ATTEMPTS):
                if attempt:  # first burst goes out immediately (RFC 8899
                    await asyncio.sleep(PROBE_INTERVAL_S)  # probes on
                if self._closed or self._error is not None:  # confirmation)
                    return
                top = PROBE_DATAGRAM_SIZES[-1]
                if self._mtu >= top - _DATA_OVERHEAD:
                    return
                for size in PROBE_DATAGRAM_SIZES:
                    if size - _DATA_OVERHEAD <= self._mtu:
                        continue
                    pad = size - _HDR.size - _PLEN.size
                    self._last_probe_sent = time.monotonic()
                    self._tx(_PROBE, _PLEN.pack(size) + b"\x00" * pad)
        except asyncio.CancelledError:
            pass

    def on_msgsize_error(self) -> None:
        """A DF-bit datagram bounced (local EMSGSIZE or ICMP frag-needed).

        Within the probe grace window this is an oversized PROBE being
        rejected — expected, ignore (any _mtu growth was validated by a
        PROBEACK that actually crossed the path). Otherwise the path
        shrank under DATA: clamp to the floor AND re-segment unacked data,
        because retransmissions resend stored segments verbatim and an
        oversized one would bounce forever until MAX_RETX poisoned the
        stream."""
        if time.monotonic() - self._last_probe_sent < PROBE_GRACE_S:
            return
        if not any(len(s[0]) > MTU_PAYLOAD for s in self._unacked.values()):
            # nothing of OURS bigger than the floor is in flight, so this
            # bounce can't be our DATA (a bounced segment stays unacked) —
            # it's another stream's probe on a shared server socket, or a
            # stale ICMP. Don't punish this stream for it.
            return
        self._mtu = MTU_PAYLOAD
        resplit: Dict[int, list] = {}
        order = []
        for off in sorted(self._unacked):
            seg, _last_sent, retx = self._unacked[off]
            for j in range(0, max(len(seg), 1), MTU_PAYLOAD):
                # last_sent=0 ⇒ the RTO path re-sends the refitted
                # segments promptly
                resplit[off + j] = [seg[j:j + MTU_PAYLOAD], 0.0, retx]
                order.append(off + j)
        self._unacked = resplit
        self._send_order = deque(order)
        # the clamp may be a misattribution (shared socket) or the path
        # may recover: restart the one-shot prober so a still-jumbo path
        # re-grows within ~half a second instead of being floored forever
        if self._prober.done():
            self._prober = asyncio.create_task(self._probe_mtu())

    # -- timers --------------------------------------------------------------

    async def _timer_loop(self) -> None:
        last_ping = time.monotonic()
        try:
            while not self._closed and self._error is None:
                await asyncio.sleep(0.05)
                now = time.monotonic()
                # RTO expiry on the earliest unacked segment: the whole
                # window may be lost — re-send a burst from the front
                if self._send_order:
                    off = self._send_order[0]
                    seg = self._unacked.get(off)
                    if seg is not None and now - seg[1] >= self._rto:
                        seg[2] += 1
                        if seg[2] > MAX_RETX:
                            self._poison(TimeoutError(
                                f"segment @{off} unacked after {MAX_RETX} "
                                "retransmits"))
                            return
                        self._rto = min(self._rto * 2, RTO_MAX_S)
                        # congestion response to a timeout: whole-window
                        # loss — collapse to 2 segments, re-enter slow
                        # start toward half the flight size
                        self._ssthresh = max(self._inflight() / 2.0,
                                             2.0 * self._mtu)
                        self._cwnd = 2.0 * self._mtu
                        self._in_recovery = False
                        # resend at most one (new) cwnd worth from the
                        # front — the burst cap a static count can't give
                        budget = max(int(self._cwnd), 2 * MTU_PAYLOAD)
                        self._last_retx_t = now
                        for o in islice(self._send_order, RTO_BURST):
                            s = self._unacked.get(o)
                            if s is not None:
                                if budget <= 0:
                                    break
                                budget -= len(s[0])
                                s[1] = now
                                self._tx(_DATA, _OFF.pack(o) + s[0])
                # FIN retransmission until FINACK
                if self._fin_sent_off is not None and not self._finack.is_set():
                    self._tx(_FIN, _OFF.pack(self._fin_sent_off))
                if now - last_ping >= KEEPALIVE_S:
                    last_ping = now
                    self._tx(_PING, b"")
                if now - self._last_recv > IDLE_TIMEOUT_S:
                    self._poison(TimeoutError("idle timeout"))
                    return
        except asyncio.CancelledError:
            pass

    def _poison(self, exc: Exception) -> None:
        if self._error is None:
            self._error = exc
        self._rbuf_wake.set()
        self._wake_window()
        if self._on_closed is not None:
            try:
                self._on_closed(self._id)
            except Exception:
                pass

    # -- RawStream interface -------------------------------------------------

    async def read_exactly(self, n: int) -> bytes:
        while len(self._rbuf) < n:
            if self._error is not None:
                raise self._error
            if self._eof:
                raise asyncio.IncompleteReadError(bytes(self._rbuf), n)
            self._rbuf_wake.clear()
            await self._rbuf_wake.wait()
        out = bytes(self._rbuf[:n])
        del self._rbuf[:n]
        return out

    async def read_some(self, max_n: int) -> bytes:
        while not self._rbuf:
            if self._error is not None:
                raise self._error
            if self._eof:
                raise asyncio.IncompleteReadError(b"", 1)
            self._rbuf_wake.clear()
            await self._rbuf_wake.wait()
        take = min(max_n, len(self._rbuf))
        out = bytes(self._rbuf[:take])
        del self._rbuf[:take]
        return out

    async def write(self, data) -> None:
        if self._error is not None:
            raise self._error
        if self._fin_sent_off is not None:
            raise ConnectionError("write after close")
        view = memoryview(bytes(data) if isinstance(data, (bytearray, memoryview)) else data)
        i = 0
        n = len(view)
        burst = 0
        while i < n:
            if burst >= 128 * 1024:
                # yield between bursts: lets a same-event-loop peer (and
                # our own ACK processing) run; without it one write could
                # emit a full window before any datagram is consumed
                burst = 0
                await asyncio.sleep(0)
            while self._inflight() >= self._window():
                if self._error is not None:
                    raise self._error
                fut = asyncio.get_running_loop().create_future()
                self._window_waiters.append(fut)
                await fut
            # read the MTU only after the window wait: it tracks the probed
            # path (grows mid-write) and may have been CLAMPED while we
            # were blocked — cutting with a stale larger value would emit a
            # segment that bounces off the shrunken path forever
            mtu = self._mtu
            seg = bytes(view[i:i + mtu])
            await self._pace(len(seg))
            if self._error is not None:
                raise self._error
            i += len(seg)
            burst += len(seg)
            off = self._next_off
            self._next_off += len(seg)
            self._unacked[off] = [seg, time.monotonic(), 0]
            self._send_order.append(off)
            self._tx(_DATA, _OFF.pack(off) + seg)

    async def close(self) -> None:
        """Graceful finish: wait for all data to be acked, send FIN, wait
        for FINACK — bounded by SOFT_CLOSE_WAIT_S (parity quic.rs 3 s)."""
        if self._error is not None or self._closed:
            self.abort()
            return
        deadline = time.monotonic() + SOFT_CLOSE_WAIT_S
        while self._send_order and time.monotonic() < deadline \
                and self._error is None:
            await asyncio.sleep(0.02)
        self._fin_sent_off = self._next_off
        self._tx(_FIN, _OFF.pack(self._fin_sent_off))
        try:
            # keep a minimum FINACK window even when draining consumed the
            # deadline: the timer loop retransmits the FIN during this wait,
            # so a single lost FIN datagram doesn't leave the peer hanging
            # until its idle timeout
            remaining = max(0.3, deadline - time.monotonic())
            async with asyncio.timeout(remaining):
                await self._finack.wait()
        except asyncio.TimeoutError:
            pass
        self.abort(send_rst=False)

    def abort(self, send_rst: bool = True) -> None:
        if not self._closed:
            self._closed = True
            if send_rst and self._error is None:
                self._tx(_RST, b"")
        self._timer.cancel()
        self._prober.cancel()
        if self._ack_handle is not None:
            self._ack_handle.cancel()
            self._ack_handle = None
        if self._error is None:
            self._error = ConnectionError("connection closed")
        self._rbuf_wake.set()
        self._wake_window()
        if self._on_closed is not None:
            try:
                self._on_closed(self._id)
            except Exception:
                pass


# One endpoint wakeup drains this many datagrams before yielding back to
# the event loop (level-triggered readiness re-fires if more remain). The
# old one-callback-per-datagram shape paid a full event-loop round trip +
# recvfrom per packet; a drained batch shares one wakeup, and every
# touched stream emits ONE coalesced ACK at the end.
_RX_BATCH = 128
_RX_BUF_BYTES = 65536 + 128  # one max datagram + header slack


class _FallbackDatagramProtocol(asyncio.DatagramProtocol):
    """Per-datagram dispatch shim for event loops without ``add_reader``:
    feeds the owning endpoint's ``_dispatch`` exactly like the batched
    drain does, one datagram per batch bracket (the coalesced-ACK
    machinery still runs, it just never sees more than one datagram per
    'drain'). Errors route to the endpoint's ``_on_sock_error`` — the old
    ``error_received`` semantics."""

    def __init__(self, endpoint: "_UdpEndpoint"):
        self._endpoint = endpoint

    def datagram_received(self, data: bytes, addr) -> None:
        ep = self._endpoint
        if ep._closed or len(data) < _HDR.size:
            return
        ptype, conn_id = _HDR.unpack_from(data)
        touched: dict = {}
        try:
            ep._dispatch(ptype, conn_id, data[_HDR.size:], addr, touched)
        finally:
            for stream in touched.values():
                stream.end_rx_batch()

    def error_received(self, exc: OSError) -> None:
        self._endpoint._on_sock_error(exc)


class _UdpEndpoint:
    """Manual non-blocking UDP socket with a batched receive drain.

    Replaces the asyncio ``DatagramProtocol`` plumbing: readiness fires
    ``_on_readable`` once per backlog, which drains up to ``_RX_BATCH``
    datagrams with ``recvfrom_into`` into one reusable buffer, dispatches
    each, and then lets every touched stream collapse its ACK decisions
    into a single coalesced ACK (begin/end_rx_batch). Sends are direct
    (synchronous) ``sendto``/``send`` — EMSGSIZE attributes to the exact
    stream that sent, kernel-full drops are best-effort (the ARQ
    retransmits), matching the old error_received semantics without the
    transport indirection."""

    def __init__(self, sock, loop):
        self.sock = sock
        self._loop = loop
        self._fd = sock.fileno()
        self._closed = False
        self._rx_buf = bytearray(_RX_BUF_BYTES)
        self._rx_view = memoryview(self._rx_buf)
        # datagram-endpoint fallback transport for loops without a
        # readiness API (Windows ProactorEventLoop raises
        # NotImplementedError from add_reader); created by the async
        # ``ensure_transport`` since __init__ can't await
        self._transport = None
        try:
            loop.add_reader(self._fd, self._on_readable)
            self._reader_attached = True
        except NotImplementedError:
            self._reader_attached = False

    async def ensure_transport(self) -> None:
        """Attach the ``create_datagram_endpoint`` fallback when the loop
        rejected ``add_reader``. One warning line: the batched-recv drain
        (and its ACK coalescing) degrades to per-datagram dispatch."""
        if self._reader_attached or self._transport is not None:
            return
        logger.warning(
            "event loop %s has no add_reader (proactor?); QUIC endpoint "
            "falling back to the datagram-endpoint path (per-datagram "
            "dispatch, no batched receive drain)",
            type(self._loop).__name__)
        self._transport, _ = await self._loop.create_datagram_endpoint(
            lambda: _FallbackDatagramProtocol(self), sock=self.sock)

    # subclasses: dispatch one datagram (header already length-checked)
    def _dispatch(self, ptype: int, conn_id: int, body: bytes, addr,
                  touched: dict) -> None:
        raise NotImplementedError

    def _on_sock_error(self, exc: OSError) -> None:
        raise NotImplementedError

    def _on_readable(self) -> None:
        sock = self.sock
        buf = self._rx_buf
        view = self._rx_view
        touched: dict = {}
        try:
            for _ in range(_RX_BATCH):
                try:
                    nbytes, addr = sock.recvfrom_into(buf)
                except (BlockingIOError, InterruptedError):
                    break
                except OSError as exc:
                    self._on_sock_error(exc)
                    break
                if nbytes < _HDR.size:
                    continue  # short datagram: attack surface, drop
                ptype, conn_id = _HDR.unpack_from(buf)
                self._dispatch(ptype, conn_id,
                               bytes(view[_HDR.size:nbytes]), addr, touched)
        finally:
            # every touched stream settles its coalesced ACK AFTER the
            # whole drain (and before any timer gets to run)
            for stream in touched.values():
                stream.end_rx_batch()

    @staticmethod
    def _enter_batch(stream: "_UdpStream", touched: dict) -> None:
        key = id(stream)
        if key not in touched:
            touched[key] = stream
            stream.begin_rx_batch()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._reader_attached:
            try:
                self._loop.remove_reader(self._fd)
            except Exception:
                pass
        if self._transport is not None:
            try:
                self._transport.close()  # closes the socket it owns
            except Exception:
                pass
        try:
            self.sock.close()
        except OSError:
            pass


class _ClientEndpoint(_UdpEndpoint):
    """One UDP socket per outbound connection (connected to the server)."""

    def __init__(self, sock, loop):
        super().__init__(sock, loop)
        self.stream: Optional[_UdpStream] = None
        self.synack = loop.create_future()

    def send(self, pkt: bytes) -> None:
        if self._transport is not None:  # datagram-endpoint fallback
            try:
                self._transport.sendto(pkt)  # connected socket: no addr
            except Exception:
                pass  # errors surface via error_received
            return
        try:
            self.sock.send(pkt)
        except (BlockingIOError, InterruptedError):
            pass  # kernel buffer full: best-effort drop, ARQ retransmits
        except OSError as exc:
            if exc.errno == errno.EMSGSIZE:
                # DF-bit datagram exceeded the path (RFC 8899); the stream
                # decides probe-bounce vs genuine path-MTU decrease. Never
                # poison for it — that would kill every connection on real
                # non-loopback paths ~150 ms after connect when probing
                # starts.
                if self.stream is not None:
                    self.stream.on_msgsize_error()
            elif self.stream is not None:
                # any other send error on the connected socket (refused,
                # net/host unreachable, EPERM...) poisons immediately —
                # the old DatagramTransport error_received semantics; a
                # dead route must fail the link now, not at IDLE_TIMEOUT
                self.stream._poison(exc)

    def _dispatch(self, ptype, conn_id, body, addr, touched) -> None:
        if ptype == _SYNACK:
            if not self.synack.done():
                self.synack.set_result(conn_id)
            return
        stream = self.stream
        if stream is not None and conn_id == stream._id:
            self._enter_batch(stream, touched)
            stream.on_packet(ptype, body)

    def _on_sock_error(self, exc: OSError) -> None:
        # a connected UDP socket surfaces ICMP errors on recv
        if exc.errno == errno.EMSGSIZE:
            if self.stream is not None:
                self.stream.on_msgsize_error()
            return
        if self.stream is not None:
            self.stream._poison(exc)


class _ServerEndpoint(_UdpEndpoint):
    """The listener's single UDP socket, demuxing by connection id."""

    def __init__(self, sock, loop, listener: "QuicListener"):
        super().__init__(sock, loop)
        self.listener = listener
        self.streams: Dict[int, _UdpStream] = {}
        self.addrs: Dict[int, Tuple] = {}

    def _sendto(self, pkt: bytes, addr, conn_id: int) -> None:
        if self._transport is not None:  # datagram-endpoint fallback
            try:
                self._transport.sendto(pkt, addr)
            except Exception:
                pass  # errors surface via error_received (broadcast EMSGSIZE)
            return
        try:
            self.sock.sendto(pkt, addr)
        except (BlockingIOError, InterruptedError):
            pass  # best-effort; ARQ retransmits
        except OSError as exc:
            if exc.errno == errno.EMSGSIZE:
                # synchronous sendto attributes the bounce to the exact
                # stream that sent (the old async error_received had to
                # broadcast it to every stream on the shared socket)
                stream = self.streams.get(conn_id)
                if stream is not None:
                    stream.on_msgsize_error()
            # other errors: drop; per-stream timers decide

    def _sender_for(self, conn_id: int):
        def send(pkt: bytes) -> None:
            addr = self.addrs.get(conn_id)
            if addr is not None and not self._closed:
                self._sendto(pkt, addr, conn_id)
        return send

    def _dispatch(self, ptype, conn_id, body, addr, touched) -> None:
        if ptype == _SYN:
            known = conn_id in self.streams
            if not known and not self.listener._closed:
                send = self._sender_for(conn_id)
                stream = _UdpStream(conn_id, send, on_closed=self._drop)
                self.streams[conn_id] = stream
                self.addrs[conn_id] = addr
                self.listener._accept_q.put_nowait(
                    _QuicUnfinalized(stream, self.listener._ssl_context))
            # (re-)ack the SYN — the client retries until it sees this
            if conn_id in self.streams or known:
                self.addrs[conn_id] = addr
                self._sendto(_HDR.pack(_SYNACK, conn_id), addr, conn_id)
            return
        stream = self.streams.get(conn_id)
        if stream is not None:
            self.addrs[conn_id] = addr  # follow NAT rebinding
            self._enter_batch(stream, touched)
            stream.on_packet(ptype, body)

    def _drop(self, conn_id: int) -> None:
        self.streams.pop(conn_id, None)
        self.addrs.pop(conn_id, None)

    def _on_sock_error(self, exc: OSError) -> None:
        # recv-side ICMP on the shared socket names no peer: EMSGSIZE goes
        # to every stream (each ignores it while its own prober is
        # active); anything else is dropped — per-stream timers decide
        if exc.errno == errno.EMSGSIZE:
            for stream in list(self.streams.values()):
                stream.on_msgsize_error()


class _QuicUnfinalized(UnfinalizedConnection):
    def __init__(self, stream: _UdpStream, ssl_context: ssl.SSLContext):
        self._stream = stream
        self._ssl_context = ssl_context

    async def finalize(self, limiter: Limiter = NO_LIMIT) -> Connection:
        # TLS handshake over the ARQ stream, then consume the client's
        # stream-bootstrap byte — encrypted, like quinn's stream open rides
        # the secured connection (parity quic.rs:224-266)
        try:
            async with asyncio.timeout(CONNECT_TIMEOUT_S):
                tls = await TlsStream.wrap_server(self._stream,
                                                  self._ssl_context)
                boot = await tls.read_exactly(1)
        except (ssl.SSLError, asyncio.IncompleteReadError,
                asyncio.TimeoutError, ConnectionError) as exc:
            self._stream.abort()
            bail(ErrorKind.CONNECTION, "QUIC TLS handshake failed", exc)
        if boot != _BOOTSTRAP:
            self._stream.abort()
            bail(ErrorKind.CONNECTION, "bad QUIC stream bootstrap byte")
        return Connection(tls, limiter, label="quic")


class QuicListener(Listener):
    def __init__(self):
        self._accept_q: asyncio.Queue = asyncio.Queue()
        self._endpoint: Optional[_ServerEndpoint] = None
        self._ssl_context: Optional[ssl.SSLContext] = None
        self._closed = False
        self.bound_port: int = 0

    async def accept(self) -> UnfinalizedConnection:
        if self._closed:
            bail(ErrorKind.CONNECTION, "listener closed")
        item = await self._accept_q.get()
        if item is None:
            bail(ErrorKind.CONNECTION, "listener closed")
        return item

    async def close(self) -> None:
        self._closed = True
        if self._endpoint is not None:
            for stream in list(self._endpoint.streams.values()):
                stream.abort()
            self._endpoint.close()
        self._accept_q.put_nowait(None)


class Quic(Protocol):
    name = "quic"

    @classmethod
    async def connect(cls, endpoint: str, use_local_authority: bool = True,
                      limiter: Limiter = NO_LIMIT) -> Connection:
        host, port = parse_endpoint(endpoint)
        # resolve the trust root BEFORE any socket/stream exists: a broken
        # CA configuration bails (typed, fatal) without leaking timer tasks
        ctx, server_hostname = client_context_for(use_local_authority, host)
        loop = asyncio.get_running_loop()
        import socket as _socket
        try:
            infos = await loop.getaddrinfo(host, port,
                                           type=_socket.SOCK_DGRAM)
            # non-blocking UDP connect is immediate; try every resolved
            # family in order (v6-first hostname on a v6-less host must
            # fall through to its A record)
            sock = _socket_for_first_usable(
                infos, lambda s, addr: s.connect(addr))
        except OSError as exc:
            bail(ErrorKind.CONNECTION, f"quic connect to {endpoint} failed", exc)
        proto = _ClientEndpoint(sock, loop)
        try:
            await proto.ensure_transport()
        except Exception as exc:
            proto.close()
            bail(ErrorKind.CONNECTION,
                 f"quic endpoint setup for {endpoint} failed", exc)

        conn_id = int.from_bytes(os.urandom(8), "big")
        syn = _HDR.pack(_SYN, conn_id)
        try:
            deadline = time.monotonic() + CONNECT_TIMEOUT_S
            while True:
                proto.send(syn)
                try:
                    async with asyncio.timeout(
                            min(0.2, max(0.01, deadline - time.monotonic()))):
                        got = await asyncio.shield(proto.synack)
                        if got == conn_id:
                            break
                        bail(ErrorKind.CONNECTION, "SYNACK for wrong connection")
                except asyncio.TimeoutError:
                    if time.monotonic() >= deadline:
                        bail(ErrorKind.CONNECTION,
                             f"quic connect to {endpoint} timed out")
        except BaseException:
            proto.close()
            raise

        stream = _UdpStream(conn_id, proto.send,
                            on_closed=lambda _id: proto.close())
        proto.stream = stream
        try:
            async with asyncio.timeout(CONNECT_TIMEOUT_S):
                # TLS 1.3 over the ARQ stream (parity quinn+rustls), then
                # open "the one bidirectional stream" with the bootstrap
                # byte — inside TLS
                tls = await TlsStream.wrap_client(stream, ctx,
                                                  server_hostname)
                await tls.write(_BOOTSTRAP)
        except (ssl.SSLError, asyncio.IncompleteReadError,
                asyncio.TimeoutError, ConnectionError) as exc:
            stream.abort()
            bail(ErrorKind.CONNECTION,
                 f"quic TLS handshake with {endpoint} failed", exc)
        return Connection(tls, limiter, label=f"quic:{endpoint}")

    @classmethod
    async def bind(cls, endpoint: str,
                   certificate: Optional[Certificate] = None,
                   reuse_port: bool = False) -> Listener:
        if reuse_port:
            bail(ErrorKind.CONNECTION,
                 "quic sharding via SO_REUSEPORT is not supported yet "
                 "(connection IDs would need kernel steering); run "
                 "--shards with a TCP user transport")
        host, port = parse_endpoint(endpoint)
        if certificate is None:
            certificate = local_certificate()
        loop = asyncio.get_running_loop()
        listener = QuicListener()
        listener._ssl_context = certificate.server_context()
        import socket as _socket
        try:
            infos = await loop.getaddrinfo(host, port,
                                           type=_socket.SOCK_DGRAM,
                                           flags=_socket.AI_PASSIVE)
            sock = _socket_for_first_usable(
                infos, lambda s, addr: s.bind(addr))
        except OSError as exc:
            bail(ErrorKind.CONNECTION, f"quic bind to {endpoint} failed", exc)
        listener._endpoint = _ServerEndpoint(sock, loop, listener)
        try:
            await listener._endpoint.ensure_transport()
        except Exception as exc:
            listener._endpoint.close()
            bail(ErrorKind.CONNECTION,
                 f"quic endpoint setup for {endpoint} failed", exc)
        listener.bound_port = sock.getsockname()[1]
        return listener
