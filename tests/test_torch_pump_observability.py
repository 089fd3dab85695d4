"""What an operator sees of the port's fused native pump, held against the
JAX package's.

The twins of the pump cases of ``tests/test_health.py``
(``/debug/topology`` carries the pump summary), ``tests/test_metrics.py``
(``cdn_route_batch_frames{path="pump"}`` and the fenced escalation on
``/metrics``) and ``tests/test_ledger.py`` (the pumped path's C counters
fold into the frame-fate ledger in one delta; the native fate-drop
counters round-trip). Each scenario runs on both packages, and the port's
record must have what the JAX package's has.
"""

import asyncio
import importlib
import json
import os
from types import SimpleNamespace

import pytest

ROOTS = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}


def _pkg(name: str) -> SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{ROOTS[name]}.{path}")

    return SimpleNamespace(
        name=name, cutthrough=mod("broker.tasks.cutthrough"),
        harness=mod("broker.test_harness"), npump=mod("native.pump"),
        nuring=mod("native.uring"), msg=mod("proto.message"),
        metrics=mod("proto.metrics"), ledger=mod("proto.ledger"),
        pump_mod=mod("proto.transport.pump"),
        umod=mod("proto.transport.uring"))


JAX, PORT = _pkg("jax"), _pkg("port")


def _pump_ok(p) -> bool:
    from _torch_libs import jax_pump_available
    if p is JAX and not jax_pump_available():
        return False
    return (p.nuring.available() and p.npump.available()
            and p.cutthrough.routeplan.available())


async def _get(port: int, path: str) -> tuple:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read(-1)
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), body.decode()


async def _pumped_broker_scrape(p) -> tuple:
    """Package ``p``'s broker over loopback TCP with the pump engaged:
    three waves with idle gaps engage it, then a frame queued in Python
    fences one peer while a pumped wave is planned. Returns the
    ``/debug/topology`` document and the ``/metrics`` body."""
    if not _pump_ok(p):
        pytest.skip(f"fused pump unavailable for {p.name} on this host")
    umod, cut, pump_mod = p.umod, p.cutthrough, p.pump_mod
    saved_env = {k: os.environ.get(k)
                 for k in ("PUSHCDN_PUMP", "PUSHCDN_IO_IMPL")}
    saved = (umod._resolved, umod._warned_demote, cut.ROUTE_IMPL,
             pump_mod.PUMP_IMPL, pump_mod._warned_demote)
    umod.set_io_impl("uring")
    cut.ROUTE_IMPL = "native"
    pump_mod.set_pump_impl("auto")
    m = p.msg
    try:
        run = await p.harness.TestDefinition(
            connected_users=[[], [0], [0]], tcp_users=True,
            metrics_bind_endpoint="127.0.0.1:0").run()
        try:
            port = run.broker._metrics_server.sockets[0].getsockname()[1]
            sender = run.user(0).remote
            frame = m.serialize(m.Broadcast([0], b"pump-observed"))
            for _ in range(3):  # waves with idle gaps: the pump engages
                await sender.send_raw_many([frame] * 16)
                await asyncio.sleep(0.15)
            status, topo = await _get(port, "/debug/topology")
            assert status == 200
            key = run.connected_users[1].public_key
            conn = run.broker.connections.get_user_connection(key)
            async with conn._write_mutex:
                await conn.send_raw(m.serialize(m.Broadcast([0], b"mark")))
                await sender.send_raw_many([frame] * 16)
                await asyncio.sleep(0.2)
            status, body = await _get(port, "/metrics")
            assert status == 200
        finally:
            await run.shutdown()
            umod.UringEngine.shutdown()
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        (umod._resolved, umod._warned_demote, cut.ROUTE_IMPL,
         pump_mod.PUMP_IMPL, pump_mod._warned_demote) = saved
    return json.loads(topo), body


@pytest.mark.parametrize("p", [PORT, JAX], ids=["port", "jax"])
async def test_topology_reports_pump_state(p):
    """With the pump engaged, ``/debug/topology``'s cut-through block
    carries the pump summary: engaged peers, natively pumped frames and
    the escalation taxonomy, with the same keys in both packages."""
    topo, _ = await _pumped_broker_scrape(p)
    pump = topo["cutthrough"]["pump"]
    assert pump is not None, "pump engaged but absent from topology"
    assert pump["engaged_peers"] >= 2, pump
    assert pump["pump_frames"] > 0, pump
    assert isinstance(pump["escalations"], dict)
    assert "native" in pump and "parked_leases" in pump
    if p is PORT and _pump_ok(JAX):
        jtopo, _ = await _pumped_broker_scrape(JAX)
        assert set(pump) == set(jtopo["cutthrough"]["pump"])


def _series(body: str, prefix: str) -> float:
    lines = [ln for ln in body.splitlines() if ln.startswith(prefix)]
    assert lines, f"{prefix} missing from the exposition"
    return float(lines[0].split()[-1])


@pytest.mark.parametrize("p", [PORT, JAX], ids=["port", "jax"])
async def test_pump_metrics_exposed_after_pumped_traffic(p):
    """After a pumped run the exposition carries
    ``cdn_route_batch_frames{path="pump"}`` and
    ``cdn_pump_escalations{reason="fenced"}`` for the frames a Python
    queue fenced."""
    _, body = await _pumped_broker_scrape(p)
    assert _series(body, 'cdn_route_batch_frames{path="pump"}') > 0
    assert _series(body, 'cdn_pump_escalations{reason="fenced"}') > 0
    assert "# TYPE cdn_pump_escalations counter" in body


def _assert_balanced(p, note: str):
    """The writer-plane identity (derived against a walk of the live
    queues), and two idle ticks that flag nothing."""
    L = p.ledger.LEDGER
    derived = L.derived_in_queue()
    assert sum(derived) == L.walk_live_queues(), note
    assert all(d >= 0 for d in derived), f"{note}: negative {derived}"
    for _ in range(3):
        L.check_conservation()
    assert L.violations == 0, f"{note}: clean run flagged a violation"


def _fold(p, class_frames: dict, drop_frames: dict) -> None:
    p.metrics.update_native_telemetry({
        "stage": {}, "chain": {}, "class_delay": {},
        "class_frames": class_frames, "class_bytes": {},
        "class_drop_frames": drop_frames,
    })


def _fold_record(p) -> list:
    """The pumped-path fold on package ``p``'s ledger, reset first:
    totals, the same totals again (a no-op), then growth."""
    p.ledger.reset_for_tests()
    L = p.ledger.LEDGER
    saved = dict(p.metrics._native_class_last)
    p.metrics._native_class_last.clear()
    record = []
    try:
        for frames, drops in (({"live": 10, "bulk": 4}, {"bulk": 2}),
                              ({"live": 10, "bulk": 4}, {"bulk": 2}),
                              ({"live": 12, "bulk": 4}, {"bulk": 3})):
            _fold(p, frames, drops)
            _assert_balanced(p, f"{p.name} pump fold")
            record.append((list(L.queued),
                           list(L.fates[("delivered", "pumped")]),
                           list(L.fates[("dropped", "pump_peer_poison")])))
    finally:
        p.metrics._native_class_last.clear()
        p.metrics._native_class_last.update(saved)
        p.ledger.reset_for_tests()
    return record


def test_pump_fold_credits_queued_and_fate_in_same_delta():
    record = _fold_record(PORT)
    queued, delivered, dropped = record[0]
    assert queued[2] == 10 and queued[3] == 6
    assert delivered[2] == 10 and delivered[3] == 4
    assert dropped[3] == 2
    assert record[1] == record[0], "re-folding the same totals moved"
    assert record[2][0][2] == 12 and record[2][2][3] == 3
    assert record == _fold_record(JAX)


@pytest.mark.parametrize("p", [PORT, JAX], ids=["port", "jax"])
def test_native_fate_drop_counters_roundtrip(p):
    """The C-side test hook bumps the fate_drop_frames block, and
    parse_telemetry surfaces it per class."""
    if not p.nuring.available():
        pytest.skip("native io_uring unavailable")
    ring = p.nuring.Ring(8)
    try:
        if not ring.enable_telemetry():
            pytest.skip("telemetry shm unavailable")
        assert ring.telemetry_test_count(0, 2, 9) == 0   # class_frames
        assert ring.telemetry_test_count(1, 2, 4) == 0   # fate_drop_frames
        assert ring.telemetry_test_count(1, 3, 1) == 0
        snap = p.nuring.parse_telemetry(ring.telemetry_snapshot())
        assert snap["class_frames"]["live"] == 9
        assert snap["class_drop_frames"]["live"] == 4
        assert snap["class_drop_frames"]["bulk"] == 1
        assert ring.telemetry_test_count(2, 0, 1) < 0
        assert ring.telemetry_test_count(0, 99, 1) < 0
    finally:
        ring.close()
