"""The broker link's spans and counters in the port.

``cdn_link_receive_seconds`` takes one stamp pair per batch that
``broker_receive_loop`` reads off a peer (deserialize, hook, route,
stage), ``cdn_link_frames{dir,kind}`` counts the Direct and Broadcast
frames received from and forwarded to peers, and the link's TCP writes
count under ``cdn_stream_write_seconds{transport="tcp"}``: over two plane
brokers on the CPU linked over loopback TCP (``tests/_torch_replay.py``),
by hand and under a replay of HotShot views. Then the benchmark's readers
of the link and of the consensus round, on runs made up here.
"""

import asyncio
import functools
from types import SimpleNamespace

import numpy as np
import pytest

from pushcdn_tpu_torch.broker import metrics as broker_metrics
from pushcdn_tpu_torch.proto import metrics as metrics_mod
from pushcdn_tpu_torch.proto.message import Broadcast, Direct
from pushcdn_tpu_torch.proto.transport.memory import Memory
from pushcdn_tpu_torch.client import Client, ClientConfig

from _torch_replay import LINK_CHILDREN, LinkedCluster, replay

SEED = 31415926


@functools.lru_cache(maxsize=None)
def outcome():
    return asyncio.run(replay(24, SEED))


def test_link_receive_seconds_rises_once_per_received_batch():
    out = outcome()
    assert out.link_batches > 0
    assert len(out.stamps) == out.link_batches
    # each stamp: its seconds, then the batch's directs and broadcasts
    assert all(s[0] > 0 for s in out.stamps)
    assert sum(s[1] for s in out.stamps) == out.link[("in", "direct")]
    assert sum(s[2] for s in out.stamps) == out.link[("in", "broadcast")]


def test_every_frame_forwarded_over_the_link_is_received():
    out = outcome()
    for kind in ("direct", "broadcast"):
        assert out.link[("out", kind)] == out.link[("in", kind)] > 0


def test_the_links_tcp_writes_count_under_their_transport():
    assert outcome().link_write_s > 0


async def test_each_kind_counts_once_in_each_direction():
    """A user on broker 0 sends a direct to a user on broker 1, a
    broadcast on a topic that user holds and one on a topic no user of
    broker 1 holds: one direct and one broadcast cross."""
    cluster = await LinkedCluster().start()
    clients = []
    try:
        for b, topics in ((0, [1]), (1, [0])):
            await cluster.place_on(b)
            c = Client(ClientConfig(
                marshal_endpoint=cluster.marshal_endpoint,
                keypair=cluster.scheme.generate_keypair(seed=90 + b),
                protocol=Memory, scheme=cluster.scheme,
                subscribed_topics=set(topics)))
            await c.ensure_initialized()
            clients.append(c)
        a, b = clients
        peer = cluster.brokers[0].connections
        from pushcdn_tpu_torch.broker.tasks.sync import (partial_topic_sync,
                                                          partial_user_sync)
        from pushcdn_tpu_torch.testing.cluster import wait_until

        async def synced():
            for br in cluster.brokers:
                await partial_user_sync(br)
                await partial_topic_sync(br)
            return (peer.get_broker_identifier_of_user(b.public_key)
                    == cluster.brokers[1].connections.identity
                    and peer.get_interested_by_topic([0], False)[1])
        for _ in range(100):
            if await synced():
                break
            await asyncio.sleep(0.05)
        # the link's stream carries its transport's write child
        link = peer.get_broker_connection(next(iter(peer.brokers)))
        assert link._stream.write_seconds is \
            metrics_mod.STREAM_WRITE_SECONDS.labels(transport="tcp")
        before = {k: c.value for k, c in LINK_CHILDREN.items()}
        await a.send_message(Direct(b.public_key, b"d"))
        await a.send_message(Broadcast([0], b"b"))
        await a.send_message(Broadcast([1], b"x"))
        got = []
        while len(got) < 2:
            got += [bytes(m.message) for m in
                    await asyncio.wait_for(b.receive_messages(), 10)]
        assert sorted(got) == [b"b", b"d"]
        await wait_until(lambda: LINK_CHILDREN[("in", "broadcast")].value
                         > before[("in", "broadcast")], 5)
        assert {k: c.value - before[k] for k, c in LINK_CHILDREN.items()} \
            == {k: 1 for k in LINK_CHILDREN}
    finally:
        for c in clients:
            c.close()
        await cluster.stop()


def test_metrics_render_the_link_families():
    text = metrics_mod.render_all()
    assert "# TYPE cdn_link_receive_seconds counter" in text
    for d in ("in", "out"):
        for k in ("direct", "broadcast"):
            assert f'cdn_link_frames{{dir="{d}",kind="{k}"}}' in text
    assert broker_metrics.LINK_IN_DIRECT is broker_metrics.LINK_FRAMES.labels(
        dir="in", kind="direct")


# ---------------------------------------------------------------------------
# the benchmark's readers of the link and of the consensus round
# ---------------------------------------------------------------------------


def _scrapes(**per_broker):
    """``{broker: (before, after)}`` from ``{broker: (name, labels, rise)}``
    lists: every series reads 1 before and 1 + rise after."""
    return {b: ([(n, lab, 1.0) for n, lab, _ in rows],
                [(n, lab, 1.0 + r) for n, lab, r in rows])
            for b, rows in per_broker.items()}


def _run(scrapes, **kw):
    return SimpleNamespace(scrapes=scrapes, window_s=kw.pop("window_s", 10.0),
                           **kw)


@pytest.mark.parametrize("rises,want", [
    ((2.0, 0.5), 20.0), ((0.0, 3.0), 30.0), ((0.0, 0.0), None)])
def test_link_receive_busy_reads_the_busier_broker(rises, want):
    from cdnbench.layers import link_receive_busy_pct
    run = _run(_scrapes(**{f"broker{i}": [("cdn_link_receive_seconds", {}, r)]
                           for i, r in enumerate(rises)}))
    assert link_receive_busy_pct.read(run) == want


def test_link_write_busy_reads_tcp_alone():
    from cdnbench.layers import link_write_busy_pct
    name = "cdn_stream_write_seconds"
    run = _run(_scrapes(
        broker0=[(name, {"transport": "tcp"}, 1.0),
                 (name, {"transport": "tcp+tls"}, 7.0)],
        broker1=[(name, {"transport": "tcp"}, 1.5)]))
    assert link_write_busy_pct.read(run) == 15.0
    run = _run(_scrapes(broker0=[(name, {"transport": "tcp+tls"}, 7.0)]))
    assert link_write_busy_pct.read(run) is None


def test_view_quorum_p50_reads_views_due_in_the_window():
    from cdnbench.layers import view_quorum_p50_ms
    t0 = 10 ** 12
    # 4 views a second: views 0..3 due at 0, 250, 500, 750 ms; view -2
    # is warm-up and view 90 past the window's 10 s
    views = np.array([-2, 0, 1, 2, 3, 90])
    late_ms = np.array([900, 30, 50, 10, 20, 900])
    due = np.rint(views * 1e9 / 4).astype(np.int64)
    run = _run({}, t0=t0, rate=None, wl={"views_per_s": 4},
               extra={"quorum_view": views,
                      "quorum_ns": t0 + due + late_ms * 10 ** 6})
    assert view_quorum_p50_ms.read(run) == pytest.approx(20.0)
    run.rate = 8.0   # a sweep's rate: the same views, due twice as often
    run.extra["quorum_ns"] = t0 + np.rint(views * 1e9 / 8).astype(
        np.int64) + late_ms * 10 ** 6
    assert view_quorum_p50_ms.read(run) == pytest.approx(20.0)
    assert view_quorum_p50_ms.read(_run({}, t0=t0, rate=None, wl={},
                                        extra={})) is None
