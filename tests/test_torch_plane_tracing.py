"""The port's measurement inside the device plane and the transport, on
the CPU: the pump's phase stamps and ``cdn_plane_pump_seconds``, the step
records and ``GET /debug/plane_steps``, the staging counters, the TLS
write seconds, the exit line's step parts and the ``egress`` hop of a
staged traced frame.
"""

import asyncio
import json
import logging
import os
import tempfile
import time

import pytest

from pushcdn_tpu_torch.broker import metrics as plane_metrics
from pushcdn_tpu_torch.broker.device_plane import (
    PUMP_PHASES,
    DevicePlane,
    DevicePlaneConfig,
    StageResult,
)
from pushcdn_tpu_torch.proto import metrics as metrics_mod
from pushcdn_tpu_torch.proto import trace as trace_mod
from pushcdn_tpu_torch.proto.message import (
    KIND_BROADCAST,
    KIND_DIRECT,
    Broadcast,
    serialize,
)
from pushcdn_tpu_torch.proto.transport.base import AsyncioStream, Connection


def _pump_seconds() -> dict:
    return {p: c.value for p, c in zip(
        PUMP_PHASES, plane_metrics.PLANE_PUMP_PHASE_SECONDS)}


def _stage_counts() -> dict:
    return {r: plane_metrics.PLANE_STAGE_FRAMES.labels(result=r).value
            for r in ("staged", "bypass", "ineligible", "full")}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _config(**over) -> DevicePlaneConfig:
    kw = dict(num_user_slots=8, ring_slots=8, frame_bytes=64,
              extra_lanes=(), topic_words=1, batch_window_s=0.001,
              bypass_max_items=0)
    kw.update(over)
    return DevicePlaneConfig(**kw)


def _frame(i: int) -> tuple:
    """A broadcast on topic 0, which no user of a bare plane holds: the
    step runs and delivers nothing, so the pump needs no broker."""
    return (KIND_BROADCAST, serialize(Broadcast([0], b"f%d" % i)), [0])


async def _trickle(plane: DevicePlane, stop: asyncio.Event,
                   go: asyncio.Event) -> None:
    """Stage a frame every 2 ms until ``stop``, holding while ``go`` is
    clear."""
    i = 0
    while not stop.is_set():
        await go.wait()
        plane.stage_frames([_frame(i)])
        i += 1
        await asyncio.sleep(0.002)


async def _settled(plane: DevicePlane, go=None) -> tuple:
    """The pump's counters, the stamp they run up to and the wall clock,
    read while the pump awaits its kick with nothing staged and after a
    render has credited the open idle phase, so that no iteration is
    half counted. A trickle that ``go`` drives holds meanwhile."""
    go = go or asyncio.Event()
    go.clear()
    try:
        async with asyncio.timeout(10):
            while not (plane._pump_waiting and plane._staged_ns is None):
                await asyncio.sleep(0.001)
        metrics_mod.render_all()
        return _pump_seconds(), plane._idle_credited_ns, time.monotonic()
    finally:
        go.set()


async def test_pump_phases_tile_the_pump_wall_time():
    """Every iteration's stamps are ordered and start where the last one
    ended, and the phases' counters rise by the pump's own time between
    two readings taken while frames keep arriving, which is the wall
    time between them (within 2%)."""
    plane = DevicePlane(_config(), device="cpu")
    await plane.start()
    stop, go = asyncio.Event(), asyncio.Event()
    go.set()
    feeder = asyncio.create_task(_trickle(plane, stop, go))
    try:
        await asyncio.sleep(0.3)   # the pump's first steps, off the window
        before, n0, t0 = await _settled(plane, go)
        await asyncio.sleep(1.5)
        after, n1, t1 = await _settled(plane, go)
    finally:
        stop.set()
        go.set()
        await feeder
        await plane.stop()
    spent = sum(_delta(after, before).values())
    assert spent == pytest.approx((n1 - n0) / 1e9, abs=1e-6)
    assert spent == pytest.approx(t1 - t0, rel=0.02)
    records = list(plane.recent_steps)
    assert len(records) > 20
    for r in records:
        assert len(r.stamps) == len(PUMP_PHASES) + 1
        assert list(r.stamps) == sorted(r.stamps), r
    for prev, cur in zip(records, records[1:]):
        assert cur.stamps[0] == prev.stamps[-1]
        assert cur.step == prev.step + 1
    assert all(r.frames >= 1 and r.deliveries == 0 for r in records)


async def test_a_scrape_during_a_long_idle_reads_it():
    """While the pump waits with nothing staged, a ``/metrics`` render
    credits the open idle phase; the snapshot that ends the idle adds
    the rest before the step runs, so a scrape during the step reads the
    whole idle, and the counters still sum to the wall time."""
    plane = DevicePlane(_config(), device="cpu")
    await plane.start()
    run_step = plane._run_step

    def slow_step(*args, **kw):
        time.sleep(0.2)
        return run_step(*args, **kw)

    plane._run_step = slow_step
    try:
        assert plane.credit_idle in metrics_mod.PRE_RENDER_HOOKS
        before, n0, t0 = await _settled(plane)
        await asyncio.sleep(0.4)
        mid, n_mid, t_mid = await _settled(plane)
        assert _delta(mid, before)["idle"] == pytest.approx(
            (n_mid - n0) / 1e9, abs=1e-6)
        assert (n_mid - n0) / 1e9 == pytest.approx(t_mid - t0, rel=0.02)
        plane.stage_frames([_frame(0), _frame(1)])
        n_staged = plane._staged_ns
        async with asyncio.timeout(10):
            while not plane._step_inflight:
                await asyncio.sleep(0.005)
        assert _delta(_pump_seconds(), before)["idle"] == pytest.approx(
            (n_staged - n0) / 1e9, abs=1e-6)
        async with asyncio.timeout(10):
            while not plane.recent_steps:
                await asyncio.sleep(0.005)
        after = _pump_seconds()
        (record,) = plane.recent_steps
    finally:
        await plane.stop()
    assert plane.credit_idle not in metrics_mod.PRE_RENDER_HOOKS
    # the record keeps the whole idle phase; the counters took it in two
    assert record.phase_s("idle") > 0.4
    spent = sum(_delta(after, before).values())
    assert spent == pytest.approx((record.stamps[-1] - n0) / 1e9, abs=1e-6)


async def test_handoff_and_resume_are_not_device_time():
    """A late worker thread and a late loop show as ``handoff`` and
    ``resume``, in the records and the counters, and not as ``device``."""
    plane = DevicePlane(_config(), device="cpu")
    await plane.start()
    run_step = plane._run_step
    lag = 0.5

    def late_worker(*args, **kw):
        time.sleep(lag)            # before the step: the thread's start
        out = run_step(*args, **kw)
        time.sleep(lag)            # after it: the loop's resumption
        return out

    plane._run_step = late_worker
    before = _pump_seconds()
    try:
        plane.stage_frames([_frame(0), _frame(1)])
        async with asyncio.timeout(10):
            while not plane.recent_steps:
                await asyncio.sleep(0.01)
    finally:
        await plane.stop()
    (record,) = plane.recent_steps
    assert record.handoff_s >= lag and record.resume_s >= lag
    assert record.device_s < lag
    got = _delta(_pump_seconds(), before)
    assert got["handoff"] >= lag and got["resume"] >= lag
    assert got["device"] == pytest.approx(record.device_s)


def test_stage_counters_count_each_outcome():
    """``cdn_plane_stage_frames`` counts each answer of a staging call:
    the idle bypass apart from every other host-path answer, and every
    refused attempt as ``full``."""
    plane = DevicePlane(_config(ring_slots=4, bypass_max_items=2),
                        device="cpu")
    plane.on_user_added(b"u", [0])
    before = _stage_counts()
    # an idle plane sends a batch within the bypass to the host path
    assert plane.stage_frames([_frame(0), _frame(1)]) == \
        [StageResult.INELIGIBLE] * 2
    assert _delta(_stage_counts(), before) == dict(
        staged=0, bypass=2, ineligible=0, full=0)
    # a larger batch: two staged, an unknown recipient and a frame too
    # wide for the lane go to the host path
    before = _stage_counts()
    got = plane.stage_frames([
        _frame(2), (KIND_DIRECT, b"x", b"nobody"),
        (KIND_BROADCAST, b"y" * 65, [0]), _frame(3)])
    assert got.count(StageResult.STAGED) == 2
    assert _delta(_stage_counts(), before) == dict(
        staged=2, bypass=0, ineligible=2, full=0)
    # the ring's last two slots fill; the rest are refused, and each
    # retry of a refused frame counts again
    before = _stage_counts()
    got = plane.stage_frames([_frame(i) for i in range(4, 8)])
    assert got == [StageResult.STAGED] * 2 + [StageResult.FULL] * 2
    assert plane.try_stage(Broadcast([0], b"retry"),
                           _Raw(serialize(Broadcast([0], b"retry")))) \
        == StageResult.FULL
    assert _delta(_stage_counts(), before) == dict(
        staged=2, bypass=0, ineligible=0, full=3)
    # a disabled plane answers every frame ineligible
    plane.disabled = True
    before = _stage_counts()
    plane.stage_frames([_frame(9)] * 3)
    assert _delta(_stage_counts(), before) == dict(
        staged=0, bypass=0, ineligible=3, full=0)


class _Raw:
    """The ``Bytes`` face ``try_stage`` reads: the frame's ``data``."""

    def __init__(self, data: bytes):
        self.data = data


class _SlowWriter:
    """A StreamWriter whose write takes ``write_s`` and whose drain
    ``drain_s``, both blocking the interpreter."""

    def __init__(self, write_s: float, drain_s: float):
        self.write_s, self.drain_s = write_s, drain_s
        self.out = []

    def write(self, data):
        time.sleep(self.write_s)
        self.out.append(bytes(data))

    def writelines(self, bufs):
        time.sleep(self.write_s)
        self.out.extend(bytes(b) for b in bufs)

    async def drain(self):
        time.sleep(self.drain_s)


async def test_stream_write_seconds_rise_on_writes_and_not_drains():
    stream = AsyncioStream(None, _SlowWriter(0.02, 0.6))
    child = metrics_mod.STREAM_WRITE_SECONDS.labels(transport="test-slow")
    stream.write_seconds = child
    before = child.value
    await stream.write(memoryview(b"abc"))
    await stream.writev([b"d", memoryview(b"ef")])
    spent = child.value - before
    # the two writes block 0.04 s; a drain counted would add 0.6 s
    assert 0.04 <= spent < 0.6
    assert stream.writer.out == [b"abc", b"d", b"ef"]


@pytest.mark.parametrize("label,transport", [
    ("tcp+tls:127.0.0.1:1", "tcp+tls"), ("tcp", "tcp")])
async def test_connection_hands_its_transport_child_to_its_stream(
        label, transport):
    """Over a loopback socket, a connection's flushes add to the
    ``cdn_stream_write_seconds`` series of its own transport, as its
    bytes do to ``cdn_bytes_sent``."""
    accepted = asyncio.get_running_loop().create_future()
    server = await asyncio.start_server(
        lambda r, w: accepted.set_result((r, w)), "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    peer_r, peer_w = await accepted
    stream = AsyncioStream(reader, writer)
    conn = Connection(stream, label=label)
    child = metrics_mod.STREAM_WRITE_SECONDS.labels(transport=transport)
    try:
        assert stream.write_seconds is child
        before = child.value
        frame = serialize(Broadcast([0], b"x" * 4096))
        await conn.send_raw(frame, flush=True)
        got = await asyncio.wait_for(peer_r.readexactly(4 + len(frame)), 5)
        assert got[4:] == frame
        assert child.value > before
    finally:
        conn.close()
        peer_w.close()
        server.close()
        await server.wait_closed()


async def _broker(plane_cfg, metrics: bool = True):
    """A started port broker on the Memory transport, wrapped in its
    TestRun, with its metrics server on a free loopback port."""
    from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
    from pushcdn_tpu_torch.broker.test_harness import TestRun
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.def_ import testing_run_def
    from pushcdn_tpu_torch.proto.topic import TopicSpace

    uid = f"{os.getpid()}-{time.monotonic_ns()}"
    db = os.path.join(tempfile.mkdtemp(prefix="pushcdn-torch-test-"),
                      "discovery.sqlite")
    broker = await Broker.new(BrokerConfig(
        run_def=testing_run_def(topics=TopicSpace.range(8)),
        keypair=DEFAULT_SCHEME.generate_keypair(seed=7),
        discovery_endpoint=db,
        public_advertise_endpoint=f"trace-pub-{uid}",
        public_bind_endpoint=f"trace-pub-{uid}",
        private_advertise_endpoint=f"trace-priv-{uid}",
        private_bind_endpoint=f"trace-priv-{uid}",
        heartbeat_interval_s=3600, sync_interval_s=3600,
        whitelist_interval_s=3600, device_plane=plane_cfg,
        metrics_bind_endpoint="127.0.0.1:0" if metrics else None,
        device="cpu"))
    await broker.start()
    return TestRun(broker=broker)


async def _get(port: int, path: str) -> tuple:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read(-1)
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), body.decode()


async def _routed(run, users, frames) -> None:
    """Send ``frames`` from user 0 and wait until each of ``users`` holds
    every one of them."""
    await run.user(0).remote.send_raw_many(frames, flush=True)
    for u in users:
        got = 0
        async with asyncio.timeout(10):
            while got < len(frames):
                for raw in await run.user(u).remote.recv_raw_many():
                    got += 1
                    raw.release()


async def test_plane_steps_endpoint_serves_ordered_records():
    run = await _broker(_config(batch_window_s=0.002))
    try:
        port = run.broker._metrics_server.sockets[0].getsockname()[1]
        await run.inject_users([[0], [0]])
        for burst in range(4):
            await _routed(run, [1], [serialize(Broadcast(
                [0], b"b%d-%d" % (burst, i))) for i in range(6)])
        status, body = await _get(port, "/debug/plane_steps?limit=3")
        assert status == 200
        doc = json.loads(body)
        assert doc["clock"] == "CLOCK_MONOTONIC"
        assert doc["phases"] == list(PUMP_PHASES)
        steps = doc["steps"]
        assert 1 <= len(steps) <= 3
        assert steps[-1]["step"] == run.broker.device_plane.steps
        for s in steps:
            assert s["stamps_ns"] == sorted(s["stamps_ns"])
            assert len(s["stamps_ns"]) == len(PUMP_PHASES) + 1
            # the wall clock less the monotonic one: well past zero
            assert s["wall_minus_mono_ns"] > 0
        for prev, cur in zip(steps, steps[1:]):
            assert cur["step"] > prev["step"]
            assert cur["stamps_ns"][0] >= prev["stamps_ns"][-1]
        status, body = await _get(port, "/debug/plane_steps")
        assert status == 200 and len(json.loads(body)["steps"]) == len(
            run.broker.device_plane.recent_steps)
        status, _ = await _get(port, "/debug/plane_steps?limit=x")
        assert status == 400
    finally:
        await run.shutdown()


async def test_plane_steps_endpoint_needs_a_plane():
    run = await _broker(None)
    try:
        port = run.broker._metrics_server.sockets[0].getsockname()[1]
        status, _ = await _get(port, "/debug/plane_steps")
        assert status == 404
    finally:
        await run.shutdown()


async def test_staged_traced_frame_emits_egress_at_its_step():
    """A traced frame the plane stages emits ``ingress`` and ``plan`` at
    staging and ``egress`` at the egress of the step that routed it,
    naming the step, whose record holds the span's time (the wall clock
    mapped onto the stamps by the record's offset)."""
    run = await _broker(_config(), metrics=False)
    try:
        await run.inject_users([[0], [0]])
        tr = trace_mod.new_trace()
        traced = trace_mod.stamp_frame(serialize(Broadcast([0], b"tp")), tr)
        trace_mod.recent.clear()
        await _routed(run, [1], [traced])
        spans = {h: (t, detail) for h, tid, _, t, detail in trace_mod.recent
                 if tid == tr[0]}
        assert {"ingress", "plan", "egress"} <= set(spans)
        t_ns, detail = spans["egress"]
        assert detail.startswith("device step=")
        step = int(detail.split("=", 1)[1])
        (record,) = [r for r in run.broker.device_plane.recent_steps
                     if r.step == step]
        mono = t_ns - record.wall_minus_mono_ns
        slack = 1_000_000   # the two clocks read apart by well under 1 ms
        egress_from = record.stamps[PUMP_PHASES.index("egress")]
        assert egress_from - slack <= mono <= record.stamps[-1] + slack
        assert spans["plan"][0] - record.wall_minus_mono_ns \
            < record.stamps[PUMP_PHASES.index("snapshot")] + slack
    finally:
        await run.shutdown()


def test_exit_line_carries_the_step_parts(caplog):
    """The broker binary's exit line gives each step part's median, the
    worker thread's ``handoff`` and the loop's ``resume`` among them."""
    from pushcdn_tpu_torch.bin.broker import log_plane
    plane = DevicePlane(_config(), device="cpu")
    plane.stage_frames([_frame(0)])
    plane.step()
    with caplog.at_level(logging.INFO):
        log_plane("device plane exit", plane)
    (line,) = [r.getMessage() for r in caplog.records
               if r.getMessage().startswith("device plane exit {")]
    fields = json.loads(line[len("device plane exit "):])
    assert set(fields["step_ms_median"]) == {
        "snapshot", "device", "pairs", "egress", "handoff", "resume"}
    assert fields["plane_frames"] == 1
