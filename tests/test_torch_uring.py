"""The port's io_uring engine and fused native pump, held against the
JAX package's and against the port's own asyncio path.

The twins of ``tests/test_uring.py``'s cases, run on the port's modules
(``pushcdn_tpu_torch.native.uring`` / ``.pump`` and
``pushcdn_tpu_torch.proto.transport.uring`` / ``.pump``), in its tiers:

1. **Capability probe**: the probe must report io_uring usable; only a
   genuine kernel denial (ENOSYS/EPERM) may skip.
2. **Selection and fallback**: ``auto`` demotes to asyncio with one
   warning where the kernel denies; an explicit ``uring`` raises.
3. **Seeded equivalence**: the same message mix through a real broker
   over loopback TCP gives byte-identical per-peer delivery sequences for
   every (io impl x route impl x pump) leg of the port, and the port's
   io_uring legs equal the JAX package's over its own engine, on one
   broker and on a 2-worker shard group, with the byte pools balanced.
4. **Fault tier** on the raw stream layer, 5. the **fused pump's**
   faults, 6. the **native telemetry** block.

Then what is new to the port: a CPU dense plane broker whose users are on
io_uring delivers what the same plane delivers over asyncio and what the
JAX package's plane broker delivers over its io_uring engine, with
bursts wide enough that the egress pool grows inside a step (its
buffers are registered with the engine as fixed buffers); and that
registration, asked for from the plane's encode thread, runs on the loop.
"""

import asyncio
import errno
import gc
import importlib
import logging
import os
import random
import socket
from types import SimpleNamespace

import pytest
from _torch_libs import jax_pump_available, jax_uring_loaded

from pushcdn_tpu_torch.broker.tasks import cutthrough
from pushcdn_tpu_torch.broker.test_harness import TestDefinition
from pushcdn_tpu_torch.native import pump as npump
from pushcdn_tpu_torch.native import routeplan
from pushcdn_tpu_torch.native import uring as nuring
from pushcdn_tpu_torch.proto.limiter import NO_LIMIT, Limiter
from pushcdn_tpu_torch.proto.message import Broadcast, Direct
from pushcdn_tpu_torch.proto.transport import pump as pump_mod
from pushcdn_tpu_torch.proto.transport import uring as umod

_URING_OK = nuring.available()
_PUMP_OK = _URING_OK and routeplan.available() and npump.available()
# the JAX package's engine and pump, for the cross-package legs
_JAX_URING_OK = _URING_OK and jax_uring_loaded()
_JAX_PUMP_OK = _PUMP_OK and jax_pump_available()


def _pkg(root: str) -> SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    return SimpleNamespace(
        name=root, umod=mod("proto.transport.uring"),
        pump_mod=mod("proto.transport.pump"),
        cutthrough=mod("broker.tasks.cutthrough"),
        harness=mod("broker.test_harness"), msg=mod("proto.message"),
        shardharness=mod("testing.shardharness"))


def _as(p, msgs):
    """The scenario's messages as package ``p``'s message objects (the
    wire bytes are the same in both packages)."""
    return [p.msg.deserialize(PORT.msg.serialize(m)) for m in msgs]


PORT, JAX = _pkg("pushcdn_tpu_torch"), _pkg("pushcdn_tpu")

requires_uring = pytest.mark.skipif(
    not _URING_OK,
    reason=f"io_uring unavailable ({nuring.probe_errname()})")
requires_zc = pytest.mark.skipif(
    not (_URING_OK and nuring.zerocopy_supported()),
    reason="MSG_ZEROCOPY sends unsupported by this kernel's io_uring")
requires_pump = pytest.mark.skipif(
    not _PUMP_OK,
    reason="fused pump needs io_uring + the native route-plan kernel")


@pytest.fixture(autouse=True)
def _io_impl_state():
    """Save/restore the process-global io-impl selection (env + resolved
    cache + warn-once latches) and the route-impl toggle, and shut every
    engine down after each test — fd/lease hygiene across the suite."""
    saved_env = {k: os.environ.get(k)
                 for k in ("PUSHCDN_IO_IMPL", "PUSHCDN_IO_URING",
                           "PUSHCDN_URING_ZC_MIN", "PUSHCDN_PUMP")}
    saved = {p.name: ((p.umod._resolved, p.umod._warned_demote,
                       p.umod._warned_tls, p.cutthrough.ROUTE_IMPL),
                      (p.pump_mod.PUMP_IMPL, p.pump_mod._warned_demote))
             for p in (PORT, JAX)}
    yield
    for p in (PORT, JAX):
        p.umod.UringEngine.shutdown()
    for k, v in saved_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    for p in (PORT, JAX):
        (p.umod._resolved, p.umod._warned_demote, p.umod._warned_tls,
         p.cutthrough.ROUTE_IMPL), (p.pump_mod.PUMP_IMPL,
                                    p.pump_mod._warned_demote) = \
            saved[p.name]


# ---------------------------------------------------------------------------
# tier 1: capability probe (the CI assertion for this container)
# ---------------------------------------------------------------------------

def test_probe_reports_capability_on_this_container():
    cap = nuring.probe()
    if cap < 0:
        # only a genuine kernel denial may skip; anything else (a binding
        # bug, a build failure) must FAIL so the suite can't silently run
        # asyncio-only while claiming coverage
        assert -cap in (errno.ENOSYS, errno.EPERM), (
            f"io_uring probe failed with unexpected "
            f"{nuring.probe_errname()} ({cap})")
        pytest.skip(f"kernel denies io_uring ({nuring.probe_errname()})")
    assert cap & 1, f"probe bitmask {cap} lacks the usable bit"
    assert nuring.available()


# ---------------------------------------------------------------------------
# tier 2: selection and graceful fallback
# ---------------------------------------------------------------------------

def test_configured_io_impl_env_parsing(monkeypatch):
    monkeypatch.delenv("PUSHCDN_IO_IMPL", raising=False)
    monkeypatch.delenv("PUSHCDN_IO_URING", raising=False)
    assert umod.configured_io_impl() == "asyncio"  # opt-in this round
    monkeypatch.setenv("PUSHCDN_IO_IMPL", "uring")
    assert umod.configured_io_impl() == "uring"
    monkeypatch.setenv("PUSHCDN_IO_IMPL", "bogus")
    assert umod.configured_io_impl() == "asyncio"
    monkeypatch.delenv("PUSHCDN_IO_IMPL")
    monkeypatch.setenv("PUSHCDN_IO_URING", "1")  # legacy spelling
    assert umod.configured_io_impl() == "uring"
    monkeypatch.setenv("PUSHCDN_IO_URING", "auto")
    assert umod.configured_io_impl() == "auto"
    with pytest.raises(ValueError):
        umod.set_io_impl("epoll")


def _deny_kernel(monkeypatch):
    monkeypatch.setattr(nuring, "available", lambda: False)
    monkeypatch.setattr(nuring, "probe", lambda: -errno.ENOSYS)
    monkeypatch.setattr(nuring, "probe_errname", lambda: "ENOSYS")
    monkeypatch.setattr(umod, "_resolved", None)
    monkeypatch.setattr(umod, "_warned_demote", False)


def test_auto_demotes_to_asyncio_with_one_warning(monkeypatch, caplog):
    _deny_kernel(monkeypatch)
    monkeypatch.setenv("PUSHCDN_IO_IMPL", "auto")
    with caplog.at_level(logging.WARNING, logger="pushcdn.uring"):
        assert umod.resolve_io_impl() == "asyncio"
        monkeypatch.setattr(umod, "_resolved", None)  # force re-resolve
        assert umod.resolve_io_impl() == "asyncio"
    warnings = [r for r in caplog.records if "demoted to" in r.message]
    assert len(warnings) == 1, "demotion must warn exactly once"
    assert "ENOSYS" in warnings[0].getMessage()


def test_explicit_uring_raises_when_kernel_denies(monkeypatch):
    _deny_kernel(monkeypatch)
    monkeypatch.setenv("PUSHCDN_IO_IMPL", "uring")
    with pytest.raises(nuring.RingError) as ei:
        umod.resolve_io_impl()
    assert "ENOSYS" in str(ei.value)


@requires_uring
def test_resolve_selects_uring_when_requested(monkeypatch):
    monkeypatch.setattr(umod, "_resolved", None)
    monkeypatch.setenv("PUSHCDN_IO_IMPL", "uring")
    assert umod.resolve_io_impl() == "uring"


# ---------------------------------------------------------------------------
# tier 3: seeded delivery equivalence through a real broker
# ---------------------------------------------------------------------------

# user-0 is the sender; the topic layout gives every message class a
# target: topic-2 fans out, topic-3 is single-owner, directs hit 1 and 2
_USER_TOPICS = ((1, 2), (2,), (1, 3))
_SCENARIO_SEED = 0xC0FFEE


def _scenario_messages():
    """Deterministic mix spanning every TX path: tiny coalesced sends,
    mid-size frames, >64 KiB entries that skip coalescing, and ~200 KiB
    frames that exercise the chunked owner flush."""
    import random
    rng = random.Random(_SCENARIO_SEED)
    sizes = (5, 700, 9_000, 70_000, 200_000)
    msgs = []
    for i in range(20):
        payload = rng.randbytes(sizes[i % len(sizes)])
        if i % 2:
            msgs.append(Broadcast(topics=[rng.choice((1, 2, 3))],
                                  message=payload))
        else:
            msgs.append(Direct(recipient=f"user-{rng.choice((1, 2))}".encode(),
                               message=payload))
    return msgs


async def _drain_sequence(entity, quiet=0.4):
    """Everything the entity receives, in order, as (len, digest) pairs
    (full-byte identity without holding megabytes per config)."""
    import hashlib
    seq = []
    while True:
        try:
            raw = await asyncio.wait_for(entity.remote.recv_raw(), quiet)
        except (asyncio.TimeoutError, Exception):
            return seq
        data = bytes(raw.data) if hasattr(raw, "data") else bytes(raw)
        seq.append((len(data), hashlib.sha256(data).hexdigest()))
        if hasattr(raw, "release"):
            raw.release()


def _assert_pool_balanced(limiter, what):
    gc.collect()
    pool = getattr(limiter, "pool", None)
    if pool is not None:
        assert pool.available == pool.capacity, (
            f"{what}: {pool.capacity - pool.available} pooled bytes "
            f"leaked (permit imbalance)")


def _pump_summary(broker):
    state = getattr(broker, "_route_state", None)
    ps = getattr(state, "_pump_state", None)
    if ps is None or ps.closed:
        return None
    return ps.summary()


async def _run_one_shard(io_impl, route_impl, msgs, pump="off", p=PORT):
    """One leg through package ``p``'s broker (the port by default); the
    other package's engine selection is left alone, since both read
    ``PUSHCDN_IO_IMPL`` only when they resolve."""
    p.umod.set_io_impl(io_impl)
    p.cutthrough.ROUTE_IMPL = route_impl
    p.pump_mod.set_pump_impl(pump)
    msgs = _as(p, msgs)
    run = await p.harness.TestDefinition(connected_users=_USER_TOPICS,
                                         tcp_users=True).run()
    try:
        if io_impl == "uring":
            assert p.umod.resolve_io_impl() == "uring"
            assert isinstance(run.tcp_listener, p.umod.UringListener)
        for i, m in enumerate(msgs):
            await run.send_message_as(run.user(0), m)
            if i == 0:
                # one idle gap: pump engagement completes at the first
                # TX-idle transition, so the remaining mix exercises the
                # engaged path (a no-op for the non-pump legs)
                await asyncio.sleep(0.15)
        seqs = await asyncio.gather(
            *[_drain_sequence(u) for u in run.connected_users])
        summary = _pump_summary(run.broker)
    finally:
        await run.shutdown()
        p.umod.UringEngine.shutdown()
    _assert_pool_balanced(run.broker.limiter,
                          f"1-shard {p.name} {io_impl}/{route_impl}/"
                          f"pump={pump}")
    return ({u.public_key: s
             for u, s in zip(run.connected_users, seqs)}, summary)


async def _run_two_shards(io_impl, route_impl, msgs, pump="off", p=PORT):
    p.umod.set_io_impl(io_impl)
    p.cutthrough.ROUTE_IMPL = route_impl
    p.pump_mod.set_pump_impl(pump)
    msgs = _as(p, msgs)
    # sender on worker 0, receivers split across workers: topic-2 fanout
    # and the directs both cross the shard ring
    run = await p.shardharness.run_sharded(
        [(0, _USER_TOPICS[0]), (1, _USER_TOPICS[1]), (1, _USER_TOPICS[2])],
        num_shards=2, tcp_users=True)
    try:
        for i, m in enumerate(msgs):
            await run.user(0).remote.send_message(m, flush=True)
            if i == 0:
                await asyncio.sleep(0.15)
        seqs = await asyncio.gather(
            *[_drain_sequence(u) for u, _ in run.connected_users])
        summaries = [s for s in map(_pump_summary, run.brokers)
                     if s is not None]
    finally:
        await run.shutdown()
        p.umod.UringEngine.shutdown()
    for broker in run.brokers:
        _assert_pool_balanced(broker.limiter,
                              f"2-shard {p.name} {io_impl}/{route_impl}/"
                              f"pump={pump}")
    return ({u.public_key: s
             for (u, _), s in zip(run.connected_users, seqs)}, summaries)


def _io_impls():
    return ("asyncio", "uring") if _URING_OK else ("asyncio",)


def _equivalence_configs():
    """(package, io impl, route impl, pump) legs: the port's io x route
    grid with the pump off, plus — when the composition can engage here
    — the port's fused pump leg on top of uring+native, then the JAX
    package's uring legs (native, and its pump) for the cross-package
    comparison."""
    configs = [(PORT, io_impl, route_impl, "off")
               for io_impl in _io_impls()
               for route_impl in ("python", "native")]
    if _PUMP_OK:
        configs.append((PORT, "uring", "native", "auto"))
    if _JAX_URING_OK:
        configs.append((JAX, "uring", "native", "off"))
    if _JAX_PUMP_OK:
        configs.append((JAX, "uring", "native", "auto"))
    return configs


async def test_delivery_equivalence_one_shard():
    """Byte-identical per-peer delivery SEQUENCES across io x route x
    pump impls through one real broker over loopback TCP."""
    msgs = _scenario_messages()
    baseline = None
    for p, io_impl, route_impl, pump in _equivalence_configs():
        got, summary = await _run_one_shard(io_impl, route_impl, msgs,
                                            pump=pump, p=p)
        if baseline is None:
            baseline = got
            # the scenario must actually deliver: every receiver saw
            # traffic (a silent broker would vacuously "match")
            assert all(len(s) > 0 for s in got.values()), got
        assert got == baseline, (
            f"delivery diverged under {p.name} "
            f"{io_impl}/{route_impl}/pump={pump}")
        if pump == "auto":
            # non-vacuous: the pump leg must have actually pumped
            assert summary is not None and summary["pump_frames"] > 0, (
                f"pump leg never sent a frame natively: {summary}")
    if not _URING_OK:
        pytest.skip("asyncio-only equivalence (io_uring unavailable)")


async def test_delivery_equivalence_two_shards():
    """The same contract across a 2-worker shard group: the cross-shard
    handoff ring must be invisible to the io-impl and pump A/Bs. Both
    shards share one loop engine, so exactly one RouteState owns the
    pump — the other's frames take the residual path, which the
    equivalence assertion covers for free."""
    msgs = _scenario_messages()
    baseline = None
    for p, io_impl, route_impl, pump in _equivalence_configs():
        got, summaries = await _run_two_shards(io_impl, route_impl, msgs,
                                               pump=pump, p=p)
        if baseline is None:
            baseline = got
            assert all(len(s) > 0 for s in got.values()), got
        assert got == baseline, (
            f"sharded delivery diverged under {p.name} "
            f"{io_impl}/{route_impl}/pump={pump}")
        if pump == "auto":
            assert sum(s["pump_frames"] for s in summaries) > 0, (
                f"no shard pumped natively: {summaries}")
    if not _URING_OK:
        pytest.skip("asyncio-only equivalence (io_uring unavailable)")


# ---------------------------------------------------------------------------
# tier 4: fault injection on the raw stream layer
# ---------------------------------------------------------------------------

async def _stream_pair(bufsize=None, raw_peer=False):
    """A connected UringStream pair over a socketpair (deterministic
    loopback, no listener). ``bufsize`` shrinks the kernel socket
    buffers so the TX queue watermark is reachable with modest writes.
    ``raw_peer`` leaves side B a plain socket — a genuinely STALLED
    peer (a peer UringStream's multishot recv would keep absorbing a
    CQE burst into its RX deque before the pause-cancel lands)."""
    eng = umod.UringEngine.current()
    a, b = socket.socketpair()
    for s in (a, b):
        s.setblocking(False)
        if bufsize:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, bufsize)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, bufsize)
    sb = b if raw_peer else umod.UringStream(b, eng)
    return umod.UringStream(a, eng), sb, eng


async def _sock_read_exactly(sock, n):
    loop = asyncio.get_running_loop()
    parts = []
    got = 0
    while got < n:
        chunk = await loop.sock_recv(sock, min(256 * 1024, n - got))
        if not chunk:
            raise AssertionError(f"EOF after {got}/{n} bytes")
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


@requires_uring
async def test_stream_roundtrip_all_tx_paths():
    """Coalesced, non-coalesced, vectored, and chunk-boundary writes all
    arrive byte-exact and in order."""
    sa, sb, _eng = await _stream_pair()
    try:
        chunks = [b"a" * 5, b"b" * 700, b"c" * 70_000,
                  bytearray(b"d" * 300), memoryview(b"e" * 9000),
                  b"f" * 200_000]
        total = b"".join(bytes(c) for c in chunks)
        for c in chunks[:3]:
            await sa.write(c)
        await sa.writev(chunks[3:])
        got = await sb.read_exactly(len(total))
        assert got == total
    finally:
        await sa.close()
        await sb.close()


@requires_uring
async def test_peer_stall_parks_writer_at_watermark_then_resumes():
    """A stalled peer must park write() once the TX queue crosses
    _TX_HIGH (backpressure, not unbounded buffering), and a draining
    peer must release it — with every byte intact."""
    sa, peer, _eng = await _stream_pair(bufsize=16 * 1024, raw_peer=True)
    try:
        payload = os.urandom(2 * 1024 * 1024)
        writer = asyncio.ensure_future(sa.write(payload))
        await asyncio.sleep(0.2)
        assert not writer.done(), "writer should park against the stall"
        assert sa._tx_bytes > umod._TX_HIGH
        got = await _sock_read_exactly(peer, len(payload))
        await asyncio.wait_for(writer, 10)
        assert got == payload
    finally:
        await sa.close()
        peer.close()


@requires_uring
async def test_peer_reset_mid_transfer_fails_writer():
    """Aborting the peer while a chain is in flight surfaces a
    connection error on the parked writer instead of hanging."""
    sa, peer, _eng = await _stream_pair(bufsize=16 * 1024, raw_peer=True)
    try:
        writer = asyncio.ensure_future(sa.write(os.urandom(4 * 1024 * 1024)))
        await asyncio.sleep(0.1)
        assert not writer.done()
        peer.close()  # unread data pending -> in-flight sends fail
        with pytest.raises(OSError):
            await asyncio.wait_for(writer, 10)
        with pytest.raises(OSError):
            await sa.write(b"after-reset")
    finally:
        sa.abort()
        sa._sock.close()


@requires_uring
async def test_short_send_residue_repumped():
    """A short-but-successful LONE send completion re-pumps the residue
    (the WAITALL backstop) — simulated by acking fewer bytes than the
    queued entry, then letting the real kernel send the remainder."""
    sa, sb, _eng = await _stream_pair()
    try:
        sa._tx_flight = 1           # pretend a 1-entry chain is in flight
        sa._queue_tx(b"A" * 100, None)
        sa._on_send_cqe(60)         # kernel "sent" 60 of 100
        got = await sb.read_exactly(40)
        assert got == b"A" * 40     # exactly the residue, nothing else
    finally:
        await sa.close()
        await sb.close()


@requires_uring
async def test_short_send_mid_chain_poisons_stream():
    """A short completion with more of the chain still in flight means
    the wire now holds a torn frame — the stream must poison (EIO), not
    resume framing at a garbage offset."""
    sa, sb, _eng = await _stream_pair()
    try:
        sa._tx_flight = 2           # two linked entries "in the kernel"
        sa._queue_tx(b"B" * 100, None)
        sa._queue_tx(b"C" * 200_000, None)
        sa._on_send_cqe(60)         # first link short, second still live
        with pytest.raises(OSError) as ei:
            await sa.write(b"after-poison")
        assert ei.value.errno == errno.EIO
    finally:
        sa.abort()
        await sb.close()


@requires_uring
async def test_engine_teardown_with_inflight_sqes():
    """Engine shutdown with queued + in-flight sends: pending ops are
    failed (EBADF), both stream directions error cleanly, and the
    pending table holds no leaked entries."""
    sa, peer, eng = await _stream_pair(bufsize=16 * 1024, raw_peer=True)
    rx_a, rx_b, _ = await _stream_pair()  # an idle armed-recv pair
    writer = asyncio.ensure_future(sa.write(os.urandom(2 * 1024 * 1024)))
    await asyncio.sleep(0.1)
    assert not writer.done()
    umod.UringEngine.shutdown(asyncio.get_running_loop())
    with pytest.raises(OSError):
        await asyncio.wait_for(writer, 10)
    assert eng.closed
    assert not eng._pending, "teardown leaked pending ops"
    with pytest.raises(OSError):
        await rx_b.read_some(1)  # armed recv died with the engine
    with pytest.raises(OSError):
        await sa.write(b"x")
    for s in (sa._sock, rx_a._sock, rx_b._sock):
        s.close()
    peer.close()


@requires_zc
async def test_zc_lease_released_exactly_once_after_notif():
    """MSG_ZEROCOPY defers the owner-lease drop to the kernel's NOTIF
    completion: the lease survives the send CQE, releases exactly once,
    and the pending table ends with zero anchored sends."""
    os.environ["PUSHCDN_URING_ZC_MIN"] = "1024"  # before engine creation
    umod.set_io_impl("uring")
    from pushcdn_tpu_torch.proto.transport.tcp import Tcp  # ZC needs real TCP

    class FakeLease:
        released = 0

        def __del__(self):
            FakeLease.released += 1

    listener = await Tcp.bind("127.0.0.1:0")
    conn = None
    server = None
    try:
        accept_t = asyncio.create_task(listener.accept())
        conn = await Tcp.connect(f"127.0.0.1:{listener.bound_port}")
        server = await (await accept_t).finalize()
        eng = umod.UringEngine.current()
        assert eng.zc_ok, "ZC not armed despite supported kernel"

        import struct
        payload = b"Q" * 50_000
        pre = struct.pack(">I", len(payload)) + payload
        lease = FakeLease()
        await conn.send_encoded(pre, owner=lease, flush=True)
        del lease
        raw = await asyncio.wait_for(server.recv_raw(), 10)
        got = bytes(raw.data) if hasattr(raw, "data") else bytes(raw)
        if hasattr(raw, "release"):
            raw.release()
        assert got == payload

        # NOTIF may trail the send CQE — drain until the kernel reports
        # it is done with the pages
        for _ in range(200):
            if eng.zc_sends > 0 and eng.zc_notifs >= eng.zc_sends:
                break
            await asyncio.sleep(0.01)
        assert eng.zc_sends > 0, "ZC path not exercised"
        assert eng.zc_notifs == eng.zc_sends
        gc.collect()
        assert FakeLease.released == 1, (
            f"lease released {FakeLease.released} times")
        assert not any(isinstance(e, umod._Send)
                       for e in eng._pending.values()), (
            "send entries leaked in the pending table")
    finally:
        if conn is not None:
            conn.close()
        if server is not None:
            server.close()
        await listener.close()


@requires_uring
async def test_pool_permit_balance_over_uring_links():
    """A bounded byte pool drains back to full capacity after traffic
    over uring links in both directions — no permit leaks from the
    provided-buffer recv path or the owner-anchored send path."""
    umod.set_io_impl("uring")
    from pushcdn_tpu_torch.proto.transport.tcp import Tcp
    cap = 1 << 20
    limiter = Limiter(global_pool_bytes=cap, per_connection_queue=64)
    listener = await Tcp.bind("127.0.0.1:0")
    conn = None
    server = None
    try:
        accept_t = asyncio.create_task(listener.accept())
        conn = await Tcp.connect(f"127.0.0.1:{listener.bound_port}",
                                 limiter=limiter)
        server = await (await accept_t).finalize(limiter)
        for size in (100, 9_000, 70_000, 200_000):
            await conn.send_raw(b"x" * size, flush=True)
            raw = await asyncio.wait_for(server.recv_raw(), 10)
            assert len(raw.data) == size
            raw.release()
            await server.send_raw(b"y" * size, flush=True)
            raw = await asyncio.wait_for(conn.recv_raw(), 10)
            assert len(raw.data) == size
            raw.release()
    finally:
        if conn is not None:
            conn.close()
        if server is not None:
            server.close()
        await listener.close()
    await asyncio.sleep(0.05)  # let close-path releases land
    _assert_pool_balanced(limiter, "uring link pool")


@requires_uring
async def test_listener_survives_reset_client():
    """The multishot accept keeps serving after a client RSTs right at
    the handshake: the dead connection errors in isolation and the next
    connect still lands and carries traffic."""
    import struct
    umod.set_io_impl("uring")
    listener = umod.uring_bind("127.0.0.1", 0)
    opened = []
    try:
        port = listener.bound_port
        loop = asyncio.get_running_loop()
        # a connect that goes away with an RST immediately
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))
        s.setblocking(False)
        await loop.sock_connect(s, ("127.0.0.1", port))
        s.close()
        await asyncio.sleep(0.05)
        # a real connect must still be accepted and usable
        conn_t = asyncio.create_task(
            umod.uring_connect("127.0.0.1", port, NO_LIMIT, "t"))
        client = await asyncio.wait_for(conn_t, 10)
        opened.append(client)
        await client.send_raw(b"alive", flush=True)
        # the dead connect may occupy the first accept slot; the live
        # one must show up within the next few
        for _ in range(3):
            unf = await asyncio.wait_for(listener.accept(), 10)
            server = await unf.finalize()
            opened.append(server)
            try:
                raw = await asyncio.wait_for(server.recv_raw(), 1)
            except Exception:
                continue  # the RST'd connection — isolated, not fatal
            assert bytes(raw.data) == b"alive"
            raw.release()
            break
        else:
            raise AssertionError("live connect never accepted")
    finally:
        for c in opened:
            c.close()
        await listener.close()


# ---------------------------------------------------------------------------
# tier 5: fused data-plane pump faults
# ---------------------------------------------------------------------------
#
# Binding-level tests drive NativePump directly over a socketpair with
# injected CQEs (deterministic chain accounting, no kernel timing);
# product-level tests run a real broker over loopback TCP with the pump
# engaged and break things mid-fan-out.

def _pump_rig(topics=((1,), (2,))):
    """RoutePlanner + raw Ring + NativePump with one engaged peer per
    entry in ``topics`` (user slots 0..n-1), plus the peer sockets."""
    import struct

    import numpy as np

    planner = routeplan.RoutePlanner.create()
    assert planner is not None
    user_cap, broker_cap = max(4, len(topics)), 2
    peer_masks = np.zeros((user_cap + broker_cap, routeplan.MASK_WORDS),
                          np.uint64)
    valid_topics = sorted({t for ts in topics for t in ts})
    for slot, ts in enumerate(topics):
        peer_masks[slot] = routeplan.topic_mask(list(ts))
    assert planner.build(user_cap, broker_cap,
                         routeplan.topic_mask(valid_topics), peer_masks,
                         [], np.zeros(0, np.int32))
    ring = nuring.Ring(256)
    pump = npump.NativePump.create(ring, max_peers=8, chunk_slots=4)
    assert pump is not None
    socks = []
    slot_map = np.full(user_cap + broker_cap, -1, np.int32)
    for slot in range(len(topics)):
        a, b = socket.socketpair()
        a.setblocking(False)
        b.setblocking(False)
        pid = pump.add_peer(a.fileno())
        assert pid >= 0
        slot_map[slot] = pid
        socks.append((a, b, pid))
    pump.set_slots(slot_map)

    def chunk(frame_topics):
        from pushcdn_tpu_torch.proto.message import Broadcast, serialize
        frames = [serialize(Broadcast((t,), b"payload-%d" % i))
                  for i, t in enumerate(frame_topics)]
        buf = b"".join(struct.pack(">I", len(f)) + f for f in frames)
        offs, lens, o = [], [], 0
        for f in frames:
            offs.append(o + 4)
            lens.append(len(f))
            o += 4 + len(f)
        import numpy as _np
        return buf, _np.asarray(offs, _np.int64), _np.asarray(lens, _np.int64)

    return planner, ring, pump, socks, chunk


def _rig_teardown(ring, pump, socks):
    pump.destroy()
    ring.close()
    for pair in socks:
        for s in pair[:2]:
            try:
                s.close()
            except OSError:
                pass


@requires_pump
def test_pump_short_lone_tail_repumps_residue():
    """A short-but-successful CQE on the LAST link of a chain re-pumps
    the residue from the advanced offset (the MSG_WAITALL backstop) —
    the run stays queued, a fresh SQE is prepped at the next drain, and
    the chunk slot releases only when every byte is accounted."""
    planner, ring, pump, socks, chunk = _pump_rig(topics=((1,),))
    try:
        buf, offs, lens = chunk([1, 1, 1])
        consumed, stop, rp, rf, meta = pump.route_chunk(
            planner._handle, buf, offs, lens, 0, 1)
        assert consumed == 3 and len(rp) == 0
        assert meta[npump.META_SQES] == 1  # one contiguous run
        run_len = int(offs[2] + lens[2] - (offs[0] - 4))
        # never submit: the injected CQEs are the only completions
        _c, ev, _n = pump.inject_cqe(socks[0][2], run_len - 7), [], 0
        st = pump.stats()
        assert st["short_repump"] == 1
        assert not pump.take_released(), "slot freed before bytes done"
        cqes, events, n_prepped = pump.drain()
        assert n_prepped == 1, "residue chain not re-prepped"
        pump.inject_cqe(socks[0][2], 7)
        released = pump.take_released()
        assert released == [int(meta[npump.META_CHUNK_SLOT])]
        assert pump.stats()["errors"] == 0
        assert pump.peer_stats(socks[0][2])["err"] == 0
    finally:
        _rig_teardown(ring, pump, socks)


@requires_pump
def test_pump_short_mid_chain_poisons_peer():
    """A short completion with more links of the chain still in flight
    means the wire holds a torn frame: the peer must poison (EV_PEER_ERROR
    with EIO), queued runs drop, the chunk slot still releases, and later
    chunks escalate that peer's frames as peer_error residuals."""
    import errno as _errno
    planner, ring, pump, socks, chunk = _pump_rig(topics=((1,), (2,)))
    try:
        # frames: topic1, topic2, topic1 -> peer0 gets TWO runs (a
        # 2-link chain), peer1 one run
        buf, offs, lens = chunk([1, 2, 1])
        consumed, stop, rp, rf, meta = pump.route_chunk(
            planner._handle, buf, offs, lens, 0, 1)
        assert consumed == 3 and len(rp) == 0
        p0 = socks[0][2]
        assert pump.peer_stats(p0)["inflight"] == 2
        first_run = int(lens[0]) + 4
        events = pump.inject_cqe(p0, first_run - 3)  # short, chain live
        assert [e[0] for e in events] == [npump.EV_PEER_ERROR]
        assert events[0][1] == p0
        assert abs(events[0][2]) == _errno.EIO
        assert pump.stats()["errors"] == 1
        # the still-in-flight second link drains as a trailing CQE
        events = pump.inject_cqe(p0, -_errno.ECANCELED)
        assert npump.EV_PEER_QUIESCED in [e[0] for e in events]
        # peer1's clean run completes; only then is the chunk slot free
        p1 = socks[1][2]
        pump.inject_cqe(p1, int(lens[1]) + 4)
        assert pump.take_released() == [int(meta[npump.META_CHUNK_SLOT])]
        # frames for the poisoned peer now escalate as residuals
        consumed, stop, rp, rf, meta = pump.route_chunk(
            planner._handle, buf, offs, lens, 0, 1)
        assert meta[npump.META_RESID_ERROR] == 2
        assert sorted(set(rp.tolist())) == [0]
        assert pump.peer_stats(p0)["err"] != 0
    finally:
        _rig_teardown(ring, pump, socks)


async def _pump_broker(receivers, topics=(0,)):
    """A real broker over loopback TCP with the pump engaged: returns
    (run, sender, pump_state) after a warmup wave has landed so every
    receiver is natively engaged."""
    from pushcdn_tpu_torch.proto.message import serialize

    umod.set_io_impl("uring")
    cutthrough.ROUTE_IMPL = "native"
    pump_mod.set_pump_impl("auto")
    run = await TestDefinition(
        connected_users=[[]] + [list(topics)] * receivers,
        tcp_users=True).run()
    sender = run.user(0).remote
    warm = serialize(Broadcast(list(topics), b"warm"))
    for _ in range(3):
        await sender.send_raw_many([warm] * 8)
        await asyncio.sleep(0.15)
    state = run.broker._route_state
    assert state is not None
    ps = state._pump_state
    assert ps is not None and not ps.closed, "pump never engaged"
    assert len(ps.bindings) >= receivers, ps.summary()
    return run, sender, ps


async def _drain_payloads(user, quiet=0.4):
    """Every frame the user receives until the link goes quiet, decoded
    payload-first so tests can assert ordering by content."""
    from pushcdn_tpu_torch.proto.transport.base import FrameChunk
    out = []
    while True:
        try:
            raw = await asyncio.wait_for(user.remote.recv_raw(), quiet)
        except (asyncio.TimeoutError, Exception):
            return out
        if type(raw) is FrameChunk:
            for i in range(raw.remaining):
                o, ln = raw.offs[i], raw.lens[i]
                out.append(bytes(memoryview(raw.buf)[o:o + ln]))
        else:
            out.append(bytes(raw.data) if hasattr(raw, "data")
                       else bytes(raw))
        if hasattr(raw, "release"):
            raw.release()


@requires_pump
async def test_pump_peer_reset_during_pumped_fanout():
    """One receiver RSTs mid-fan-out while its pumped chain is in
    flight: the broker must survive, disengage (never force-disconnect —
    the Python path owns that decision), keep delivering to the healthy
    receivers, and leave the pools balanced."""
    import struct
    from pushcdn_tpu_torch.proto.message import serialize

    run, sender, ps = await _pump_broker(receivers=3)
    try:
        victim = run.connected_users[1]
        vsock = victim.remote._stream._sock
        # stop reading + RST on close: in-flight pumped sends error
        vsock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                         struct.pack("ii", 1, 0))
        frame = serialize(Broadcast([0], os.urandom(9_000)))
        await sender.send_raw_many([frame] * 32)
        vsock.close()
        await sender.send_raw_many([frame] * 32)
        await asyncio.sleep(0.3)
        # the healthy receivers got every post-warmup frame
        for u in (run.connected_users[2], run.connected_users[3]):
            got = [p for p in await _drain_payloads(u) if len(p) > 5_000]
            assert len(got) == 64, f"healthy receiver lost frames: {len(got)}"
        assert not ps.closed, "whole pump died with one peer"
        summary = ps.summary()
        assert summary["pump_frames"] > 0
    finally:
        await run.shutdown()
    _assert_pool_balanced(run.broker.limiter, "pump peer-reset")


@requires_pump
async def test_pump_fence_race_with_concurrent_python_enqueue():
    """A frame entering a pumped peer's Python writer queue fences the
    peer synchronously: frames planned while the queue is non-empty
    divert to the residual path (counted, ordered behind the queue), and
    the fence lifts once both sides drain — after which the pump engages
    again."""
    from pushcdn_tpu_torch.proto.message import serialize

    run, sender, ps = await _pump_broker(receivers=2)
    try:
        key = run.connected_users[1].public_key
        conn = run.broker.connections.get_user_connection(key)
        assert conn is not None
        marker = serialize(Broadcast([0], b"MARKER" * 10))
        wave = [serialize(Broadcast([0], b"wave-%03d" % i))
                for i in range(24)]
        fenced_before = ps.escalations.get("fenced", 0)
        # hold the writer mutex so the queued marker CANNOT drain: the
        # fence provably overlaps the wave's plan call
        async with conn._write_mutex:
            await conn.send_raw(marker)     # enqueue -> synchronous fence
            assert any(b.fenced for b in ps.bindings.values())
            await sender.send_raw_many(wave)
            await asyncio.sleep(0.25)        # wave planned while fenced
        assert ps.escalations.get("fenced", 0) > fenced_before, (
            "wave never hit the fence escalation path")
        await asyncio.sleep(0.2)
        got = await _drain_payloads(run.connected_users[1])
        wave_tags = [p[p.find(b"wave-"):p.find(b"wave-") + 8]
                     for p in got if b"wave-" in p]
        assert wave_tags == sorted(wave_tags), "fenced frames reordered"
        assert len(wave_tags) == 24
        assert any(b"MARKER" in p for p in got)
        # fence lifted and the pump re-engages for the next wave
        assert not any(b.fenced for b in ps.bindings.values())
        pumped_before = ps.pump_frames
        await sender.send_raw_many(wave)
        await asyncio.sleep(0.3)
        assert ps.pump_frames > pumped_before, "peer never unfenced"
    finally:
        await run.shutdown()
    _assert_pool_balanced(run.broker.limiter, "pump fence race")


@requires_pump
async def test_pump_lease_balance_after_teardown_in_flight():
    """Shutdown with pumped runs still referencing chunk slots: the
    parked leases must release on teardown — zero pooled bytes leaked."""
    from pushcdn_tpu_torch.proto.message import serialize

    run, sender, ps = await _pump_broker(receivers=2)
    try:
        frame = serialize(Broadcast([0], os.urandom(4_000)))
        await sender.send_raw_many([frame] * 48)
        # no drain, no sleep: chunk slots are still referenced when the
        # shutdown path starts tearing the engine down
    finally:
        await run.shutdown()
        umod.UringEngine.shutdown(asyncio.get_running_loop())
    assert ps.closed and not ps.leases, "parked leases survived teardown"
    _assert_pool_balanced(run.broker.limiter, "pump teardown in flight")


def test_pump_demotion_warning_names_failed_layer(monkeypatch, caplog):
    """``resolve_pump`` must name the dead layer in ONE warning — an
    operator reading the log learns WHICH leg of the composition failed,
    and repeat probes stay silent (count, don't spam)."""
    monkeypatch.setattr(pump_mod, "_warned_demote", False)
    pump_mod.set_pump_impl("auto")

    # io impl resolved to asyncio (kernel fine, selection says no)
    umod.set_io_impl("asyncio")
    with caplog.at_level(logging.WARNING, logger=pump_mod.logger.name):
        ok, why = pump_mod.resolve_pump()
        ok2, _ = pump_mod.resolve_pump()  # second probe: silent
    assert not ok and not ok2
    assert "asyncio" in why or "io_uring unavailable" in why
    warnings = [r for r in caplog.records if "pump demoted" in r.message]
    assert len(warnings) == 1, "demotion must warn exactly once"
    assert why in warnings[0].message

    # dead route-plan kernel: the warning names THAT layer
    caplog.clear()
    pump_mod.set_pump_impl("auto")  # resets the warn-once latch
    monkeypatch.setattr(pump_mod.routeplan, "available", lambda: False)
    with caplog.at_level(logging.WARNING, logger=pump_mod.logger.name):
        ok, why = pump_mod.resolve_pump()
    assert not ok and "route-plan kernel unavailable" in why

    # explicit off is a decision, not a demotion: no warning at all
    caplog.clear()
    pump_mod.set_pump_impl("off")
    with caplog.at_level(logging.WARNING, logger=pump_mod.logger.name):
        ok, why = pump_mod.resolve_pump()
    assert not ok and "disabled" in why
    assert not [r for r in caplog.records if "demoted" in r.message]


# ---------------------------------------------------------------------------
# tier 6: native-path telemetry
# ---------------------------------------------------------------------------
#
# The shm telemetry block is written from C on the pump's hot path and
# read by /metrics through a seqlock snapshot. These tests pin the three
# contracts the exposition rests on: log2 bucketing (exact boundaries),
# torn-read safety under a concurrent writer, and counter monotonicity
# across pump disengage and engine teardown (the carry fold).


@requires_uring
def test_telemetry_log2_bucket_boundaries():
    """Bucket k holds durations in [2^(k-1), 2^k) ns — i.e. the bucket
    index of ``ns`` is ``ns.bit_length()`` capped at 63, with 0 in
    bucket 0. Exact count/sum bookkeeping, weighted observes, and
    out-of-range histogram indices rejected."""
    from collections import Counter as _Counter

    ring = nuring.Ring(64)
    try:
        assert ring.enable_telemetry()
        assert ring.telemetry_enabled
        assert ring.enable_telemetry()  # idempotent
        cases = [0, 1, 2, 3, 4, 7, 8, 1023, 1024, 1025,
                 2**32 - 1, 2**32, 2**62, 2**63 + 11]
        for ns in cases:
            assert ring.telemetry_test_observe(0, 0, ns) == 0
        # weighted observe: one duration covering n frames adds n to
        # count, n*ns to sum, n to the single bucket
        assert ring.telemetry_test_observe(0, 0, 1024, n=5) == 0
        # invalid indices/kinds must be rejected, not clamped
        assert ring.telemetry_test_observe(0, nuring.TM_STAGES, 1) < 0
        assert ring.telemetry_test_observe(1, nuring.TM_CHAIN, 1) < 0
        assert ring.telemetry_test_observe(2, nuring.TM_CLASSES, 1) < 0
        assert ring.telemetry_test_observe(3, 0, 1) < 0

        snap = nuring.parse_telemetry(ring.telemetry_snapshot())
        h = snap["stage"]["plan"]
        assert h["count"] == len(cases) + 5
        assert h["sum_ns"] == sum(cases) + 5 * 1024
        expect = _Counter(min(ns.bit_length(), 63) for ns in cases)
        expect[(1024).bit_length()] += 5
        for k in range(nuring.TM_BUCKETS):
            assert h["buckets"][k] == expect.get(k, 0), f"bucket {k}"
        # nothing leaked into the neighbouring histograms
        assert snap["stage"]["submit"]["count"] == 0
        assert snap["chain"]["enter"]["count"] == 0
    finally:
        ring.close()


@requires_uring
def test_telemetry_snapshot_consistent_under_concurrent_writer():
    """Seqlock torn-read safety: a writer thread hammers weighted
    observations (seeded n) into one histogram while the reader
    snapshots. Every snapshot must be internally consistent — with a
    fixed duration, sum_ns == ns * count and all samples in one bucket;
    a torn copy would break one of those identities — and counts must
    be monotone across snapshots."""
    import random
    import threading
    import time as _time

    ring = nuring.Ring(64)
    try:
        assert ring.enable_telemetry()
        rng = random.Random(1119)
        ns = 1 << 20  # bucket 21
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                ring.telemetry_test_observe(2, 3, ns, n=rng.randrange(1, 8))

        writer = threading.Thread(target=hammer)
        writer.start()
        try:
            prev, good = 0, 0
            deadline = _time.monotonic() + 10.0
            while good < 150 and _time.monotonic() < deadline:
                words = ring.telemetry_snapshot()
                if words is None:
                    continue  # writer never went quiet in the spin window
                h = nuring.parse_telemetry(words)["class_delay"]["bulk"]
                assert h["sum_ns"] == ns * h["count"], "torn sum"
                assert sum(h["buckets"]) == h["count"], "torn buckets"
                assert h["buckets"][21] == h["count"], "sample strayed"
                assert h["count"] >= prev, "count went backwards"
                prev = h["count"]
                good += 1
        finally:
            stop.set()
            writer.join()
        assert good >= 150, f"reader starved: {good} consistent snapshots"
        assert prev > 0, "writer never landed an observation"
    finally:
        ring.close()


@requires_pump
def test_pump_stage_telemetry_and_class_accounting_injected():
    """Binding-level stage/class accounting over injected CQEs (no
    kernel timing): one pumped chunk must stamp all four stages, fold
    the frames into the planner's class (BULK via set_classes), account
    the peer row by fd, and SURVIVE pump disengage — the telemetry
    block belongs to the ring, not the pump."""
    from pushcdn_tpu_torch.proto import flowclass

    planner, ring, pump, socks, chunk = _pump_rig(topics=((1,),))
    try:
        assert ring.enable_telemetry()
        # topic 1 -> bulk; everything else keeps the live default
        assert planner.set_classes(
            flowclass.compile_table(overrides={1: flowclass.BULK}))
        buf, offs, lens = chunk([1, 1, 1])
        consumed, stop_r, rp, rf, meta = pump.route_chunk(
            planner._handle, buf, offs, lens, 0, 1)
        assert consumed == 3 and len(rp) == 0
        assert list(pump.frame_classes[:3]) == [flowclass.BULK] * 3
        run_len = int(offs[2] + lens[2] - (offs[0] - 4))
        pump.inject_cqe(socks[0][2], run_len)
        assert pump.take_released(), "run did not complete"

        snap = nuring.parse_telemetry(ring.telemetry_snapshot())
        for stage in nuring.STAGE_NAMES:
            assert snap["stage"][stage]["count"] >= 1, stage
        assert snap["class_delay"]["bulk"]["count"] == 3
        assert snap["class_frames"]["bulk"] == 3
        assert snap["class_bytes"]["bulk"] == run_len
        assert snap["class_frames"]["live"] == 0
        rows = {p["fd"]: p for p in snap["peers"]}
        fd = socks[0][0].fileno()
        assert rows[fd]["frames"] == 3 and rows[fd]["bytes"] == run_len

        # disengage: destroying the pump must not reset the counters
        pump.destroy()
        after = nuring.parse_telemetry(ring.telemetry_snapshot())
        assert after["class_frames"]["bulk"] == 3
        for stage in nuring.STAGE_NAMES:
            assert after["stage"][stage]["count"] \
                == snap["stage"][stage]["count"], stage
    finally:
        if not pump.closed:
            pump.destroy()
        ring.close()
        for pair in socks:
            for s in pair[:2]:
                try:
                    s.close()
                except OSError:
                    pass


@requires_uring
async def test_telemetry_totals_monotone_across_engine_teardown():
    """Engine teardown folds the ring's final snapshot into the
    module-level carry BEFORE the ring closes, so ``telemetry_totals``
    (and with it every rendered series) stays monotone across engine
    recreate — the lease-balance discipline, applied to counters."""
    from pushcdn_tpu_torch.proto import metrics as metrics_mod

    saved_carry = umod._TELEM_CARRY
    umod._TELEM_CARRY = None
    try:
        eng = umod.UringEngine.current()
        assert eng.ring.enable_telemetry()
        assert eng.ring.telemetry_test_observe(0, 3, 1 << 21, n=5) == 0
        t1 = umod.telemetry_totals()
        assert t1 is not None and t1["stage"]["total"]["count"] == 5

        umod.UringEngine.shutdown()  # close() folds into the carry
        t2 = umod.telemetry_totals()
        assert t2["stage"]["total"]["count"] == 5, "teardown lost samples"

        # a fresh engine keeps the series monotone on top of the carry
        eng2 = umod.UringEngine.current()
        assert eng2.ring.enable_telemetry()
        assert eng2.ring.telemetry_test_observe(0, 3, 1 << 21, n=2) == 0
        t3 = umod.telemetry_totals()
        assert t3["stage"]["total"]["count"] == 7
        assert t3["stage"]["total"]["sum_ns"] == 7 * (1 << 21)

        # and the /metrics exposition publishes the aggregated family
        metrics_mod.update_native_telemetry(t3)
        body = metrics_mod.PUMP_STAGE_SECONDS.render()
        assert 'cdn_pump_stage_seconds_count{stage="total"} 7' in body
    finally:
        umod._TELEM_CARRY = saved_carry


# ---------------------------------------------------------------------------
# tier 7: a device plane whose users are on io_uring
# ---------------------------------------------------------------------------
#
# The dense plane encodes a step's per-user delivery streams into the
# native egress pool in its worker thread; a pool that grows there calls
# every registrar, the io_uring engine's among them. The engine hands
# such a registration to its loop (the ring's fixed-buffer table belongs
# to the loop's thread).

PLANE_USERS = 32
# (publisher, frames, payload bytes) per wave: the last wave's step
# encodes ~4 MiB of streams, past the pool's first 1 MiB buffers
PLANE_WAVES = ((1, 8, 200), (2, 24, 600), (3, 120, 1000), (4, 120, 1000))


def _plane_user_topics(u: int):
    return [0] if u % 4 else [0, 1]


async def _plane_broker_run(root: str, io_impl: str, tag: str):
    """A broker of package ``root`` with a dense plane on the CPU, its
    users injected over loopback TCP on ``io_impl``; each wave of
    broadcasts (and a direct per frame group) is published by one user
    and drained by every user before the next. Returns every user's
    frames in arrival order, the plane's counters and the threads that
    registered fixed buffers with the port's engine."""
    import tempfile
    import threading

    p = PORT if root == PORT.name else JAX

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    plane_mod, broker_mod = mod("broker.device_plane"), mod("broker.broker")
    sig, def_, topic = (mod("proto.crypto.signature"), mod("proto.def_"),
                        mod("proto.topic"))
    p.umod.set_io_impl(io_impl)
    extra = {"device": "cpu"} if root == PORT.name else {}
    db = os.path.join(tempfile.mkdtemp(prefix="pushcdn-uring-plane-"),
                      "d.sqlite")
    broker = await broker_mod.Broker.new(broker_mod.BrokerConfig(
        run_def=def_.testing_run_def(topics=topic.TopicSpace.range(8)),
        keypair=sig.DEFAULT_SCHEME.generate_keypair(seed=5),
        discovery_endpoint=db,
        public_advertise_endpoint=f"uring-plane-{tag}-pub",
        public_bind_endpoint=f"uring-plane-{tag}-pub",
        private_advertise_endpoint=f"uring-plane-{tag}-priv",
        private_bind_endpoint=f"uring-plane-{tag}-priv",
        heartbeat_interval_s=3600, sync_interval_s=3600,
        whitelist_interval_s=3600,
        device_plane=plane_mod.DevicePlaneConfig(
            num_user_slots=64, ring_slots=128, frame_bytes=1280,
            extra_lanes=((4096, 8),), topic_words=1, bypass_max_items=0,
            delivery_impl="dense"),
        **extra))
    await broker.start()
    registered = []
    loop_thread = threading.get_ident()
    if root == PORT.name:
        real = umod.UringEngine.register_fixed_buffer

        def spy(self, buf):
            registered.append(threading.get_ident())
            return real(self, buf)
    run = p.harness.TestRun(broker=broker)
    rng = random.Random(23)
    msg = p.msg
    try:
        await run.inject_users_tcp(
            [_plane_user_topics(u) for u in range(PLANE_USERS)])
        if io_impl == "uring":
            assert isinstance(run.tcp_listener, p.umod.UringListener)
        users = run.connected_users
        got = {u.public_key: [] for u in users}

        async def drain(u):
            while True:
                raws = await u.remote.recv_raw_many()
                got[u.public_key] += [bytes(r.data) for r in raws]
                for r in raws:
                    r.release()

        drains = [asyncio.create_task(drain(u)) for u in users]
        want = 0
        if root == PORT.name:
            umod.UringEngine.register_fixed_buffer = spy
        try:
            for w, (pub, n, size) in enumerate(PLANE_WAVES):
                frames = []
                for i in range(n):
                    body = f"{w}/{i}/".encode() + rng.randbytes(size)
                    if i % 8 == 7:
                        to = users[rng.randrange(PLANE_USERS)].public_key
                        frames.append(msg.serialize(msg.Direct(to, body)))
                        want += 1
                    else:
                        t = rng.randrange(2)
                        frames.append(msg.serialize(msg.Broadcast([t],
                                                                  body)))
                        want += sum(t in _plane_user_topics(u)
                                    for u in range(PLANE_USERS))
                await run.user(pub).remote.send_raw_many(frames,
                                                         flush=True)
                async with asyncio.timeout(30):
                    while sum(map(len, got.values())) < want:
                        await asyncio.sleep(0.005)
        finally:
            if root == PORT.name:
                umod.UringEngine.register_fixed_buffer = real
            for t in drains:
                t.cancel()
            await asyncio.gather(*drains, return_exceptions=True)
        plane = broker.device_plane
        # the step counters are the port's own (the JAX plane counts steps)
        return (got, getattr(plane, "busy_steps", plane.steps),
                getattr(plane, "native_egress_steps", None),
                plane.messages_routed, registered, loop_thread)
    finally:
        await run.shutdown()
        p.umod.UringEngine.shutdown()


@requires_uring
async def test_dense_plane_over_uring_matches_asyncio_and_jax():
    """The port's CPU dense plane with its users on io_uring delivers
    what the same plane delivers over asyncio and what the JAX package's
    plane broker delivers over its io_uring engine, byte for byte and in
    order; every step's streams go out through the native encoder, and
    the egress pool's buffers, grown in the plane's encode thread, are
    registered with the engine on the loop's thread."""
    got, busy, native_steps, routed, registered, loop_thread = \
        await _plane_broker_run(PORT.name, "uring", "port-uring")
    assert busy > 0 and native_steps == busy
    assert routed == sum(map(len, got.values()))
    assert registered, "the egress pool never reached the engine"
    assert set(registered) == {loop_thread}, (
        "a fixed buffer was registered off the loop's thread")
    a_got, a_busy, a_native, a_routed, a_reg, _ = await _plane_broker_run(
        PORT.name, "asyncio", "port-aio")
    assert a_native == a_busy > 0 and not a_reg
    assert a_got == got and a_routed == routed
    if not _JAX_URING_OK:
        pytest.skip("the JAX package's io_uring shim did not load")
    j_got, j_busy, _j_native, j_routed, _, _ = await _plane_broker_run(
        JAX.name, "uring", "jax-uring")
    assert j_busy > 0 and j_routed == routed
    assert j_got == got


@requires_uring
async def test_registrar_off_the_loop_registers_on_the_loop(monkeypatch):
    """The egress pool grown from a worker thread (as the plane's encode
    grows it) reaches the engine's registrar there; the registration
    itself runs on the loop's thread, and the buffer then has a fixed
    slot where the ring has a fixed-buffer table."""
    import threading

    from pushcdn_tpu_torch import native as tnative

    eng = umod.UringEngine.current()
    seen = []
    real = umod.UringEngine.register_fixed_buffer

    def spy(self, buf):
        seen.append(threading.get_ident())
        return real(self, buf)

    monkeypatch.setattr(umod.UringEngine, "register_fixed_buffer", spy)
    # larger than any pooled buffer: the pool allocates and calls every
    # registrar from the worker thread
    buf, lease = await asyncio.to_thread(tnative._egress_take, 9 << 20)
    for _ in range(10):
        await asyncio.sleep(0)
    assert seen == [threading.get_ident()], (
        "the registration ran off the loop's thread")
    if eng.fixed_ok:
        assert eng.fixed_slot_for(buf) >= 0
    del lease
