"""The port's QUIC transport, held against the JAX package's.

The twins of ``tests/test_quic_endpoint.py`` (resolver iteration, the
datagram-endpoint fallback), of the QUIC cases of ``tests/test_transport.py``
(the shared conformance, large-frame and coalescing cases with the
``quic`` parameter, and every ``test_quic_*`` case: re-segmentation,
loss recovery, pacing, the congestion controller, TLS on the wire and
under loss, batched ACKs, ACK delay) and of ``tests/test_fuzz_parsers.py``'s
QUIC packet fuzz, run on ``pushcdn_tpu_torch.proto.transport.quic``.

The wire format is the same in both packages, so the cross-package cases
connect a port client to a JAX listener and a JAX client to a port
listener, and exchange the same seeded framed messages both ways: each
side must receive every frame byte for byte, in order.
"""

import asyncio
import importlib
import logging
import random
import socket as _socket

import pytest

from pushcdn_tpu_torch.proto.error import Error
from pushcdn_tpu_torch.proto.message import Broadcast, Direct, deserialize
from pushcdn_tpu_torch.proto.transport import Quic


async def _echo_once(listener, endpoint):
    """connect → accept → one round trip → close. Returns nothing; raises
    on any failure."""
    connect_task = asyncio.create_task(Quic.connect(endpoint))
    unfinalized = await asyncio.wait_for(listener.accept(), 10)
    server_conn = await unfinalized.finalize()
    client_conn = await asyncio.wait_for(connect_task, 10)
    try:
        await client_conn.send_message(Direct(b"srv", b"ping"))
        got = await asyncio.wait_for(server_conn.recv_message(), 10)
        assert isinstance(got, Direct) and bytes(got.message) == b"ping"
        await server_conn.send_message(Direct(b"cli", b"pong"))
        got2 = await asyncio.wait_for(client_conn.recv_message(), 10)
        assert bytes(got2.message) == b"pong"
    finally:
        client_conn.close()
        server_conn.close()


async def test_connect_iterates_mixed_family_resolver():
    """First resolver record is a dead family; connect must fall through
    to the second instead of failing outright."""
    listener = await Quic.bind("127.0.0.1:0")
    try:
        port = listener.bound_port
        loop = asyncio.get_running_loop()
        real_getaddrinfo = loop.getaddrinfo
        calls = []

        async def stub(host, p, **kw):
            infos = await real_getaddrinfo(host, p, **kw)
            calls.append((host, p))
            # a "v6" record on a v6-less host: AF_INET6-shaped row whose
            # socket/connect cannot complete here (family 9999 does not
            # exist, so socket() raises like a kernel without v6 support)
            dead = (9999, _socket.SOCK_DGRAM, 0, "", ("::1", p, 0, 0))
            return [dead] + list(infos)

        loop.getaddrinfo = stub
        try:
            await _echo_once(listener, f"127.0.0.1:{port}")
        finally:
            loop.getaddrinfo = real_getaddrinfo
        assert calls, "resolver stub was never consulted"
    finally:
        await listener.close()


async def test_connect_all_families_dead_raises_typed_error():
    loop = asyncio.get_running_loop()
    real_getaddrinfo = loop.getaddrinfo

    async def stub(host, p, **kw):
        # dead family (socket() raises OSError), then a family/address
        # shape mismatch (connect raises TypeError): BOTH must surface as
        # the typed Error(CONNECTION), never a raw TypeError
        return [(9999, _socket.SOCK_DGRAM, 0, "", ("::1", p, 0, 0)),
                (_socket.AF_INET, _socket.SOCK_DGRAM, 0, "",
                 ("::1", p, 0, 0))]

    loop.getaddrinfo = stub
    try:
        with pytest.raises(Error):
            await Quic.connect("127.0.0.1:1")
    finally:
        loop.getaddrinfo = real_getaddrinfo


async def test_bind_iterates_mixed_family_resolver():
    """First resolver record binds to an address this host doesn't own
    (the v6-record-on-v6-less-host shape); bind must fall through."""
    loop = asyncio.get_running_loop()
    real_getaddrinfo = loop.getaddrinfo

    async def stub(host, p, **kw):
        infos = await real_getaddrinfo(host, p, **kw)
        # TEST-NET-3 address: EADDRNOTAVAIL on any sane host
        dead = (_socket.AF_INET, _socket.SOCK_DGRAM, 0, "",
                ("203.0.113.7", p))
        return [dead] + list(infos)

    loop.getaddrinfo = stub
    try:
        listener = await Quic.bind("127.0.0.1:0")
    finally:
        loop.getaddrinfo = real_getaddrinfo
    try:
        assert listener.bound_port
        await _echo_once(listener, f"127.0.0.1:{listener.bound_port}")
    finally:
        await listener.close()


async def test_proactor_style_loop_falls_back_to_datagram_endpoint(caplog):
    """A loop whose add_reader raises NotImplementedError (the Windows
    ProactorEventLoop behavior) must still carry QUIC traffic via the
    datagram-endpoint fallback, with a one-line warning."""
    loop = asyncio.get_running_loop()

    def no_add_reader(*_a, **_kw):
        raise NotImplementedError("proactor-style loop")

    loop.add_reader = no_add_reader  # instance attr shadows the method
    try:
        with caplog.at_level(logging.WARNING, logger="pushcdn.transport"):
            listener = await Quic.bind("127.0.0.1:0")
            try:
                assert listener._endpoint._transport is not None
                await _echo_once(listener, f"127.0.0.1:{listener.bound_port}")
            finally:
                await listener.close()
        assert any("falling back to the datagram-endpoint" in r.message
                   for r in caplog.records)
    finally:
        del loop.add_reader


def _endpoint_of(listener, requested):
    port = getattr(listener, "bound_port", None)
    if port:
        return f"127.0.0.1:{port}"
    return requested


async def test_connection_conformance():
    proto, endpoint = Quic, "127.0.0.1:0"
    listener = await proto.bind(endpoint)
    try:
        ep = _endpoint_of(listener, endpoint)
        connect_task = asyncio.create_task(proto.connect(ep))
        unfinalized = await asyncio.wait_for(listener.accept(), 10)
        server_conn = await unfinalized.finalize()
        client_conn = await asyncio.wait_for(connect_task, 10)

        # client -> server
        msg = Direct(recipient=b"server-key", message=b"ping" * 100)
        await client_conn.send_message(msg)
        got = await asyncio.wait_for(server_conn.recv_message(), 10)
        assert isinstance(got, Direct)
        assert bytes(got.message) == b"ping" * 100

        # server -> client
        await server_conn.send_message(Broadcast(topics=[3], message=b"pong"))
        got2 = await asyncio.wait_for(client_conn.recv_message(), 10)
        assert isinstance(got2, Broadcast)
        assert got2.topics == (3,)
        assert bytes(got2.message) == b"pong"

        # soft close: peer sees clean EOF as a connection error on recv
        await client_conn.soft_close()
        with pytest.raises(Error):
            await asyncio.wait_for(server_conn.recv_message(), 10)
        server_conn.close()
    finally:
        await listener.close()


async def test_large_frame():
    proto, endpoint = Quic, "127.0.0.1:0"
    listener = await proto.bind(endpoint)
    try:
        ep = _endpoint_of(listener, endpoint)
        connect_task = asyncio.create_task(proto.connect(ep))
        server_conn = await (await asyncio.wait_for(listener.accept(), 10)).finalize()
        client_conn = await asyncio.wait_for(connect_task, 10)
        payload = bytes(range(256)) * 4096  # 1 MiB
        await client_conn.send_message(Direct(recipient=b"k", message=payload))
        got = await asyncio.wait_for(server_conn.recv_message(), 30)
        assert bytes(got.message) == payload
        client_conn.close()
        server_conn.close()
    finally:
        await listener.close()


async def test_quic_msgsize_clamp_and_resegment():
    """A post-negotiation path-MTU decrease (EMSGSIZE outside the probe
    grace window) clamps the MTU to the floor AND re-segments unacked
    data so retransmissions fit; during the grace window (probe bounce)
    it is a no-op."""
    import time as _time
    from pushcdn_tpu_torch.proto.transport.quic import (
        MTU_PAYLOAD, _UdpStream)

    sent = []
    stream = _UdpStream(1, sent.append)
    try:
        # pretend probing negotiated a jumbo path and the window has grown
        # (nothing ACKs in this fixture; without the bump the congestion
        # window would block the 40 KB write)
        stream._mtu = 16000
        stream._cwnd = 1e6
        await stream.write(b"x" * 40000)
        big_segs = dict(stream._unacked)
        assert any(len(s[0]) > MTU_PAYLOAD for s in big_segs.values())

        # 1) within the grace window: ignored (probe bounce)
        stream._last_probe_sent = _time.monotonic()
        stream.on_msgsize_error()
        assert stream._mtu == 16000
        assert stream._unacked == big_segs

        # 2) outside the window: clamp + re-segment
        stream._last_probe_sent = 0.0
        stream.on_msgsize_error()
        assert stream._mtu == MTU_PAYLOAD
        assert all(len(s[0]) <= MTU_PAYLOAD
                   for s in stream._unacked.values())
        # byte coverage is identical after the re-split
        covered = sorted((off, off + len(s[0]))
                         for off, s in stream._unacked.items())
        assert covered[0][0] == 0
        for (a0, a1), (b0, _) in zip(covered, covered[1:]):
            assert a1 == b0, "gap or overlap after resegmentation"
        assert covered[-1][1] == 40000
        assert list(stream._send_order) == [c[0] for c in covered]
        # idempotent at the floor
        stream.on_msgsize_error()
        assert stream._mtu == MTU_PAYLOAD
    finally:
        stream.abort()


async def test_quic_recovers_from_datagram_loss():
    """The QUIC-class ARQ must deliver in-order bytes through a lossy
    path: two streams wired back-to-back through a channel that drops
    every 5th datagram in each direction."""
    from pushcdn_tpu_torch.proto.transport.quic import _UdpStream

    drop = {"a": 0, "b": 0}
    a = b = None

    # header is 9 bytes: type(1) + conn_id(8); on_packet takes (type, body)
    def wire(key, get_peer):
        def send(pkt: bytes) -> None:
            drop[key] += 1
            if drop[key] % 5 == 0:
                return
            peer = get_peer()
            if peer is not None:
                asyncio.get_running_loop().call_soon(
                    peer.on_packet, pkt[0], pkt[9:])
        return send

    a = _UdpStream(1, wire("a", lambda: b))
    b = _UdpStream(1, wire("b", lambda: a))
    # pin the floor MTU: probing this lossless-looking fake wire up to
    # 64 KB would fit the whole payload in one segment and leave nothing
    # for the loss-recovery dynamics this test exists to observe
    a._prober.cancel()
    b._prober.cancel()
    try:
        payload = bytes(range(256)) * 200  # 51200 B
        await a.write(payload)
        got = bytearray()
        peak_cwnd = 0.0
        async with asyncio.timeout(30):
            while len(got) < len(payload):
                got += await b.read_some(65536)
                if a._ssthresh != float("inf"):
                    # only sample AFTER the first loss cut — the initial
                    # window already exceeds the floor, so pre-loss
                    # samples would make the regrowth assert vacuous
                    peak_cwnd = max(peak_cwnd, a._cwnd)
        assert bytes(got) == payload
        # recovery must not leave the window collapsed: through 20% loss
        # the congestion controller has both cut (ssthresh finite — losses
        # were seen) and RAMPED back up past its post-loss floor of 2
        # segments at some point during the transfer. (The END-state cwnd
        # is deliberately not asserted: with a deterministic every-5th
        # dropper a tail loss legally leaves cwnd at the floor — that IS
        # NewReno — and which datagram the tail loss lands on is pure
        # drop-counter phase.)
        assert a._ssthresh != float("inf")
        assert peak_cwnd > 2.0 * a._mtu
        # and the reverse direction too
        await b.write(b"pong" * 1000)
        back = bytearray()
        async with asyncio.timeout(30):
            while len(back) < 4000:
                back += await a.read_some(65536)
        assert bytes(back) == b"pong" * 1000
    finally:
        a.abort()
        b.abort()


async def test_quic_pacer_handles_segment_larger_than_cwnd():
    """Pace-deadlock regression: after MTU probing settles (~64 KB
    segments) a fresh connection's cwnd (16 x 1200 B) is SMALLER than one
    segment; the pacing bucket must still be fillable or the first jumbo
    write hangs forever."""
    from pushcdn_tpu_torch.proto.transport.quic import _OFF, _UdpStream

    sent: list[bytes] = []
    a = _UdpStream(9, sent.append)
    try:
        a._mtu = 65000          # probed-up path
        a._srtt = 0.05          # pacing active (above the loopback floor)
        a._rttvar = 0.0

        async def acker():
            seen = 0
            while a._next_off < 4 * 65000:
                if a._next_off > seen:
                    seen = a._next_off
                    a.on_packet(4, _OFF.pack(seen))   # ACK everything sent
                await asyncio.sleep(0.005)
            a.on_packet(4, _OFF.pack(a._next_off))

        t = asyncio.create_task(acker())
        async with asyncio.timeout(10):
            await a.write(b"z" * (4 * 65000))
        await t
        assert a._acked == 4 * 65000
    finally:
        a.abort()


async def test_quic_congestion_controller_state_machine():
    """NewReno unit check against a hand-driven ACK sequence: slow-start
    growth, 3-dup-ACK halving + fast retransmit, partial-ACK retransmit
    during recovery, full-ACK deflation, and RTO collapse to 2 segments."""
    from pushcdn_tpu_torch.proto.transport.quic import (
        _OFF, _UdpStream, MTU_PAYLOAD, CWND_INITIAL_SEGS)

    sent: list[bytes] = []
    s = _UdpStream(7, sent.append)
    try:
        mtu = s._mtu
        assert s._cwnd == CWND_INITIAL_SEGS * MTU_PAYLOAD
        await s.write(b"x" * (8 * mtu))       # 8 segments in flight
        base = len(sent)
        cw0 = s._cwnd

        # slow start: ACK of 2 segments grows cwnd by the acked bytes
        s.on_packet(4, _OFF.pack(2 * mtu))    # 4 == _ACK
        assert s._cwnd == cw0 + 2 * mtu
        assert s._srtt is not None            # RTT estimator seeded

        # 3 duplicate ACKs: fast retransmit of the earliest hole + halve
        for _ in range(3):
            s.on_packet(4, _OFF.pack(2 * mtu))
        assert s._in_recovery
        assert s._ssthresh == max(s._inflight() / 2.0, 2.0 * mtu)
        assert len(sent) == base + 1          # exactly one fast retransmit
        retx_off = _OFF.unpack_from(sent[-1], 9)[0]
        assert retx_off == 2 * mtu

        # partial ACK (below the recovery point): retransmit next hole
        s.on_packet(4, _OFF.pack(3 * mtu))
        assert s._in_recovery
        assert len(sent) == base + 2
        assert _OFF.unpack_from(sent[-1], 9)[0] == 3 * mtu

        # full ACK: exit recovery, deflate to ssthresh
        s.on_packet(4, _OFF.pack(8 * mtu))
        assert not s._in_recovery
        assert s._cwnd == max(s._ssthresh, 2.0 * mtu)

        # RTO expiry: collapse to 2 segments, ssthresh = half the flight
        s._cwnd = 8.0 * mtu                   # room for the whole write
        await s.write(b"y" * (4 * mtu))
        s._rto = 0.0                          # force immediate expiry
        await asyncio.sleep(0.1)              # timer loop fires
        assert s._cwnd == 2.0 * mtu
        assert s._ssthresh >= 2.0 * mtu
    finally:
        s.abort()


async def test_quic_wire_carries_no_plaintext():
    """The QUIC-class transport is TLS 1.3-secured (parity quinn+rustls,
    quic.rs:37-146): capture every datagram either side transmits and
    assert the application payload never appears in cleartext."""
    import os as _os
    from pushcdn_tpu_torch.proto.transport import quic as quic_mod

    captured: list[bytes] = []
    orig_tx = quic_mod._UdpStream._tx

    def capturing_tx(self, ptype, body):
        captured.append(bytes(body))
        orig_tx(self, ptype, body)

    quic_mod._UdpStream._tx = capturing_tx
    try:
        listener = await Quic.bind("127.0.0.1:0")
        ep = f"127.0.0.1:{listener.bound_port}"
        connect_task = asyncio.create_task(Quic.connect(ep))
        server = await (await asyncio.wait_for(listener.accept(), 10)) \
            .finalize()
        client = await connect_task
        marker = _os.urandom(64)  # incompressible, unmistakable
        payload = marker * 128    # 8 KB spanning many segments
        await client.send_message(Direct(recipient=b"r", message=payload))
        echoed = await asyncio.wait_for(server.recv_message(), 10)
        assert bytes(echoed.message) == payload
        await server.send_message(Direct(recipient=b"r", message=payload))
        echoed = await asyncio.wait_for(client.recv_message(), 10)
        assert bytes(echoed.message) == payload
        client.close()
        server.close()
        await listener.close()
    finally:
        quic_mod._UdpStream._tx = orig_tx
    assert captured, "capture hook never fired"
    blob = b"\x00".join(captured)
    assert marker not in blob, "plaintext payload leaked onto the wire"


async def test_quic_tls_handshake_survives_datagram_loss():
    """TLS rides the ARQ: the handshake and encrypted traffic must complete
    over a wire dropping every 4th datagram in each direction."""
    from pushcdn_tpu_torch.proto.crypto.tls import LOCAL_SAN, local_certificate
    from pushcdn_tpu_torch.proto.transport.quic import _UdpStream
    from pushcdn_tpu_torch.proto.transport.tls_stream import TlsStream

    drop = {"a": 0, "b": 0}
    a = b = None

    def wire(key, get_peer):
        def send(pkt: bytes) -> None:
            drop[key] += 1
            if drop[key] % 4 == 0:
                return
            peer = get_peer()
            if peer is not None:
                asyncio.get_running_loop().call_soon(
                    peer.on_packet, pkt[0], pkt[9:])
        return send

    a = _UdpStream(7, wire("a", lambda: b))
    b = _UdpStream(7, wire("b", lambda: a))
    try:
        cert = local_certificate()
        async with asyncio.timeout(30):
            server_task = asyncio.create_task(
                TlsStream.wrap_server(b, cert.server_context()))
            tls_a = await TlsStream.wrap_client(
                a, cert.client_context(), LOCAL_SAN)
            tls_b = await server_task
            await tls_a.write(b"secret-over-lossy-wire" * 100)
            got = bytearray()
            while len(got) < 2200:
                got += await tls_b.read_some(65536)
        assert bytes(got) == b"secret-over-lossy-wire" * 100
    finally:
        a.abort()
        b.abort()


async def test_coalesced_writes_preserve_frame_boundaries():
    proto, endpoint = Quic, "127.0.0.1:0"
    """The writer coalesces whole queued runs into single flushes (and the
    adaptive window makes that the steady state under load): a mixed burst
    of sizes — sub-byte, odd, exactly at and beyond the coalesce limit —
    queued in one breath must arrive intact, in order, on every
    transport."""
    from pushcdn_tpu_torch.proto.transport.base import Connection

    listener = await proto.bind(endpoint)
    try:
        ep = _endpoint_of(listener, endpoint)
        connect_task = asyncio.create_task(proto.connect(ep))
        server = await (await asyncio.wait_for(listener.accept(), 10)) \
            .finalize()
        client = await asyncio.wait_for(connect_task, 10)

        limit = Connection._BATCH_COALESCE_LIMIT
        sizes = [1, 7, 100, 1024, 4096, limit - 4, limit, limit + 1,
                 3 * limit, 5, 64, limit - 1, 2, 9000, 1]
        frames = [bytes([i % 251]) * s for i, s in enumerate(sizes)]
        # no awaits between sends: everything lands in the send queue in
        # one breath, so the writer drains it as coalesced batches
        for f in frames:
            await client.send_raw(f)
        got = []
        async with asyncio.timeout(30):
            while len(got) < len(frames):
                got.extend(b.data if isinstance(b.data, bytes)
                           else bytes(b.data)
                           for b in await server.recv_raw_many())
        assert [len(g) for g in got] == sizes
        assert got == frames
        client.close()
        server.close()
    finally:
        await listener.close()


async def test_quic_batched_receive_coalesces_acks():
    """A burst of in-order datagrams processed in ONE endpoint drain
    (begin/end_rx_batch) must produce exactly one coalesced ACK covering
    the lot — not one per datagram — while a drain containing a hole
    still emits the (capped) duplicate ACKs fast retransmit needs."""
    from pushcdn_tpu_torch.proto.transport.quic import (
        _DATA, _OFF, _UdpStream, DUP_ACK_FAST_RETX)

    sent: list[bytes] = []
    s = _UdpStream(5, sent.append)
    try:
        seg = b"d" * 1000
        # --- in-order burst in one drain: exactly one ACK out ---
        base_acks = sum(1 for p in sent if p[0] == 4)
        s.begin_rx_batch()
        for i in range(16):
            s.on_packet(_DATA, _OFF.pack(i * 1000) + seg)
        assert sum(1 for p in sent if p[0] == 4) == base_acks  # deferred
        s.end_rx_batch()
        acks = [p for p in sent if p[0] == 4]
        assert len(acks) == base_acks + 1
        assert _OFF.unpack_from(acks[-1], 9)[0] == 16 * 1000

        # --- a drain with a hole: dup ACKs preserved, capped ---
        pre = len([p for p in sent if p[0] == 4])
        s.begin_rx_batch()
        for i in range(20, 30):  # offsets past the hole at 16000
            s.on_packet(_DATA, _OFF.pack(i * 1000) + seg)
        s.end_rx_batch()
        dup_acks = [p for p in sent if p[0] == 4][pre:]
        assert 1 <= len(dup_acks) <= DUP_ACK_FAST_RETX
        assert all(_OFF.unpack_from(p, 9)[0] == 16 * 1000
                   for p in dup_acks)

        # --- duplicates of delivered data: one re-ACK per drain ---
        pre = len([p for p in sent if p[0] == 4])
        s.begin_rx_batch()
        for i in range(4):
            s.on_packet(_DATA, _OFF.pack(i * 1000) + seg)
        s.end_rx_batch()
        assert len([p for p in sent if p[0] == 4]) == pre + 1
    finally:
        s.abort()


async def test_quic_batched_lossy_path_recovers():
    """Loss recovery through BATCHED drains: the wire delivers packets in
    endpoint-style batches (begin/end_rx_batch around each group) and
    drops every 5th datagram; in-order delivery and both directions must
    still complete — the coalesced-ACK rules preserve the ARQ's recovery
    dynamics."""
    from pushcdn_tpu_torch.proto.transport.quic import _UdpStream

    drop = {"a": 0, "b": 0}
    a = b = None
    pending: dict = {"a": [], "b": []}

    def wire(key, get_peer):
        def send(pkt: bytes) -> None:
            drop[key] += 1
            if drop[key] % 5 == 0:
                return
            pending[key].append(pkt)
            if len(pending[key]) == 1:
                asyncio.get_running_loop().call_soon(deliver, key, get_peer)
        return send

    def deliver(key, get_peer):
        peer = get_peer()
        batch, pending[key] = pending[key], []
        if peer is None or not batch:
            return
        peer.begin_rx_batch()
        try:
            for pkt in batch:
                peer.on_packet(pkt[0], pkt[9:])
        finally:
            peer.end_rx_batch()

    a = _UdpStream(1, wire("a", lambda: b))
    b = _UdpStream(1, wire("b", lambda: a))
    a._prober.cancel()
    b._prober.cancel()
    try:
        payload = bytes(range(256)) * 200  # 51200 B
        await a.write(payload)
        got = bytearray()
        async with asyncio.timeout(30):
            while len(got) < len(payload):
                got += await b.read_some(65536)
        assert bytes(got) == payload
        await b.write(b"pong" * 1000)
        back = bytearray()
        async with asyncio.timeout(30):
            while len(back) < 4000:
                back += await a.read_some(65536)
        assert bytes(back) == b"pong" * 1000
    finally:
        a.abort()
        b.abort()


async def test_quic_ack_delay_keeps_rtt_honest():
    """ACKs carry the time the receiver held them (QUIC's ack_delay): a
    timer-delayed ACK must not inflate the sender's RTT estimator, and a
    hostile/corrupt delay field is clamped so it can't zero it either."""
    from pushcdn_tpu_torch.proto.transport.quic import (
        _ACK_DELAY, _DATA, _OFF, _UdpStream, ACK_DELAY_S,
    )

    sent = []
    a = _UdpStream(1, sent.append)
    b = None

    def to_b(pkt: bytes) -> None:
        if b is not None:
            b.on_packet(pkt[0], pkt[9:])

    try:
        # --- wire format: receiver stamps held time on timer-fired ACKs ---
        acks = []
        b = _UdpStream(1, acks.append)
        b.on_packet(_DATA, _OFF.pack(0) + b"x" * 100)
        # held ~30 ms, then the delayed-ACK timer fires
        await asyncio.sleep(0.03)
        async with asyncio.timeout(5):
            while not any(p[0] == 4 for p in acks):  # _ACK type byte = 4
                await asyncio.sleep(0.005)
        ack_pkts = [p for p in acks if p[0] == 4]
        assert ack_pkts, acks
        body = ack_pkts[-1][9:]
        assert len(body) >= _OFF.size + _ACK_DELAY.size
        delay_us = _ACK_DELAY.unpack_from(body, _OFF.size)[0]
        # the stamp reflects the ~20-30 ms hold, not zero
        assert delay_us >= 10_000, delay_us

        # --- sender side: the held time is subtracted from the sample ---
        a._unacked[0] = [b"y" * 100, __import__("time").monotonic() - 0.040, 0]
        a._send_order.append(0)
        a._next_off = 100
        a.on_packet(4, _OFF.pack(100) + _ACK_DELAY.pack(35_000))
        # raw sample ~40 ms minus reported 35 ms -> ~5 ms, far below raw
        assert a._srtt is not None and a._srtt < 0.02, a._srtt

        # --- clamp: a hostile delay can't pin the estimator to the floor ---
        c = _UdpStream(1, lambda pkt: None)
        c._unacked[0] = [b"z" * 100, __import__("time").monotonic() - 0.500, 0]
        c._send_order.append(0)
        c._next_off = 100
        c.on_packet(4, _OFF.pack(100) + _ACK_DELAY.pack(0xFFFFFFFF))
        # raw ~500 ms minus the CLAMPED delay (2*ACK_DELAY_S) stays large
        assert c._srtt is not None and c._srtt >= 0.5 - 2.5 * ACK_DELAY_S
        c.abort()
    finally:
        a.abort()
        if b is not None:
            b.abort()


async def test_quic_on_packet_survives_random_datagrams():
    """The QUIC-class packet handler is the UDP attack surface: random
    type/body datagrams must never raise out of on_packet or wedge the
    stream's timers."""
    from pushcdn_tpu_torch.proto.transport.quic import _UdpStream

    rng = random.Random(7)
    stream = _UdpStream(1, lambda pkt: None)
    try:
        for _ in range(3000):
            ptype = rng.randrange(0, 16)          # includes unknown types
            body = bytes(rng.getrandbits(8)
                         for _ in range(rng.randrange(0, 64)))
            stream.on_packet(ptype, body)
        # nothing escaped on_packet; random garbage may legitimately have
        # included an RST datagram (type byte in range), which poisons the
        # stream by DESIGN — any other error class would be a parser leak
        assert stream._error is None or \
            isinstance(stream._error, ConnectionResetError)
    finally:
        stream.abort()



# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _quic_of(root: str):
    return importlib.import_module(f"{root}.proto.transport.quic").Quic


def _seeded_frames(seed: int):
    """Serialized broadcasts and directs of seeded sizes, from a few bytes
    to past one datagram and past the coalesce limit."""
    from pushcdn_tpu_torch.proto.message import serialize
    rng = random.Random(seed)
    frames = []
    for i in range(40):
        size = rng.choice((1, 37, 1200, 5000, 70_000, 300_000))
        body = rng.randbytes(size)
        if i % 3:
            frames.append(serialize(Broadcast([rng.randrange(8)], body)))
        else:
            frames.append(serialize(Direct(f"user-{i}".encode(), body)))
    return frames


async def _exchange(client_root: str, server_root: str, seed: int):
    """A ``client_root`` client and a ``server_root`` listener exchange the
    seeded frames both ways; returns what each side received."""
    listener = await _quic_of(server_root).bind("127.0.0.1:0")
    try:
        connect = asyncio.create_task(_quic_of(client_root).connect(
            f"127.0.0.1:{listener.bound_port}"))
        server = await (await asyncio.wait_for(listener.accept(), 10)) \
            .finalize()
        client = await asyncio.wait_for(connect, 10)
        frames = _seeded_frames(seed)

        async def recv_all(conn):
            got = []
            async with asyncio.timeout(60):
                while len(got) < len(frames):
                    for raw in await conn.recv_raw_many():
                        got.append(bytes(raw.data))
                        raw.release()
            return got

        try:
            at_server = asyncio.create_task(recv_all(server))
            at_client = asyncio.create_task(recv_all(client))
            await client.send_raw_many(frames, flush=True)
            await server.send_raw_many(list(reversed(frames)), flush=True)
            return frames, await at_server, await at_client
        finally:
            client.close()
            server.close()
    finally:
        await listener.close()


@pytest.mark.parametrize("client_root,server_root", [
    ("pushcdn_tpu_torch", "pushcdn_tpu"),
    ("pushcdn_tpu", "pushcdn_tpu_torch"),
    ("pushcdn_tpu_torch", "pushcdn_tpu_torch"),
], ids=["port-to-jax", "jax-to-port", "port-to-port"])
async def test_cross_package_exchange_is_byte_for_byte(client_root,
                                                       server_root):
    frames, at_server, at_client = await _exchange(client_root,
                                                   server_root, seed=13)
    assert at_server == frames
    assert at_client == list(reversed(frames))
    for raw in at_server[:6]:
        deserialize(raw)  # a message of the shared wire format


async def test_cross_package_soft_close_reads_as_eof():
    """A port client's soft close reaches a JAX listener's connection as a
    clean end of stream (a connection error on receive), as between two
    port endpoints."""
    jax_error = importlib.import_module("pushcdn_tpu.proto.error").Error
    listener = await _quic_of("pushcdn_tpu").bind("127.0.0.1:0")
    try:
        connect = asyncio.create_task(
            Quic.connect(f"127.0.0.1:{listener.bound_port}"))
        server = await (await asyncio.wait_for(listener.accept(), 10)) \
            .finalize()
        client = await asyncio.wait_for(connect, 10)
        await client.send_message(Direct(b"k", b"last"))
        got = await asyncio.wait_for(server.recv_message(), 10)
        assert bytes(got.message) == b"last"
        await client.soft_close()
        with pytest.raises(jax_error):
            await asyncio.wait_for(server.recv_message(), 10)
        server.close()
    finally:
        await listener.close()
