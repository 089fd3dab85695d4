"""The port's chaos tier and composition invariants: the twins of
``tests/test_chaos.py`` and ``tests/test_composition_invariants.py`` on
the port's ``Cluster``, worker-shard harness and consensus workload.

Broker churn, a connection storm and a 9 MB firehose run against a live
in-process cluster while a survivor publisher streams sequenced
broadcasts; every survivor subscriber must hold the complete, in-order
sequence. Admission shedding tripped mid-view must not stall consensus
view completion, and a shard worker dying mid-stream must not cost a
surviving sibling-shard subscriber one message or one reorder; both on
the native cut-through plane and its scalar twin.
"""

import asyncio
import os

import numpy as np
import pytest

from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
from pushcdn_tpu_torch.broker.tasks import cutthrough
from pushcdn_tpu_torch.broker.tasks.heartbeat import heartbeat_once
from pushcdn_tpu_torch.proto import trace as trace_mod
from pushcdn_tpu_torch.proto.error import Error, ErrorKind
from pushcdn_tpu_torch.proto.message import Broadcast, deserialize, serialize
from pushcdn_tpu_torch.proto.topic import TopicSpace
from pushcdn_tpu_torch.proto.transport.base import FrameChunk
from pushcdn_tpu_torch.proto.transport.memory import Memory
from pushcdn_tpu_torch.testing import Cluster, wait_mesh_interest, wait_until
from pushcdn_tpu_torch.testing.consensus import ConsensusConfig, run_consensus

CHAOS_SECONDS = 8.0
SEQ_MSGS = 300          # survivor stream: steady sequenced broadcasts
FIREHOSE_BYTES = 9 * 1024 * 1024  # parity: bad-sender's 9 MB default


async def _churn_bad_broker(cluster: Cluster, stop: asyncio.Event,
                            stats: dict) -> None:
    """bad-broker.rs parity: join the mesh, live briefly, die without
    goodbye, rejoin — forever (until the window closes)."""
    i = 0
    while not stop.is_set():
        pub = f"chaos{cluster.uid}-bad-pub-{i}"
        priv = f"chaos{cluster.uid}-bad-priv-{i}"
        bad = await Broker.new(BrokerConfig(
            run_def=cluster.run_def, keypair=cluster.broker_keypair,
            discovery_endpoint=cluster.db,
            public_advertise_endpoint=pub, public_bind_endpoint=pub,
            private_advertise_endpoint=priv, private_bind_endpoint=priv,
            heartbeat_interval_s=3600, sync_interval_s=3600,
            whitelist_interval_s=3600))
        await bad.start()
        await heartbeat_once(bad)          # dial into the mesh
        for b in cluster.brokers:
            await heartbeat_once(b)        # survivors learn of it
        await asyncio.sleep(0.4)           # live briefly under load
        await bad.stop()                   # die (no goodbye protocol)
        stats["churn_cycles"] = i = i + 1
        await asyncio.sleep(0.1)


async def _connection_storm(cluster: Cluster, stop: asyncio.Event,
                            stats: dict) -> None:
    """bad-connector parity: authenticate through the marshal, hold the
    session a moment, vanish; repeat as fast as the marshal allows."""
    seed = 0
    while not stop.is_set():
        seed += 1
        c = cluster.client(seed=80_000 + seed, topics=[3])
        try:
            async with asyncio.timeout(5):
                await c.ensure_initialized()
            stats["storm_ok"] = stats.get("storm_ok", 0) + 1
        except Exception:
            # a storm connect landing on the dying broker IS the chaos
            stats["storm_fail"] = stats.get("storm_fail", 0) + 1
        finally:
            c.close()
        await asyncio.sleep(0)


async def _firehose(sender, sink, stop: asyncio.Event,
                    stats: dict) -> None:
    """bad-sender parity: 9 MB broadcasts, back to back, on their own
    topic so the survivor stream shares pipes but not subscriptions.
    Both clients were connected to SURVIVOR brokers before churn began;
    transient resets (chaos is chaos) reconnect and continue."""
    blob = os.urandom(FIREHOSE_BYTES)
    while not stop.is_set():
        try:
            await sender.send_broadcast_message([5], blob)
            got = await asyncio.wait_for(sink.receive_message(), 10)
            assert len(bytes(got.message)) == FIREHOSE_BYTES
            stats["firehose_msgs"] = stats.get("firehose_msgs", 0) + 1
        except (Exception, asyncio.TimeoutError):
            stats["firehose_resets"] = stats.get("firehose_resets", 0) + 1
            await asyncio.sleep(0.2)


async def test_chaos_survivors_lose_nothing():
    cluster = await Cluster(num_brokers=3,
                            topics=TopicSpace.range(8)).start()
    try:
        # survivors: 6 subscribed clients, 2 per broker, all on topic 0
        survivors = []
        for i in range(6):
            await cluster.place_on(i % 3)
            c = cluster.client(seed=70_000 + i, topics=[0])
            await c.ensure_initialized()
            survivors.append(c)
        await wait_until(
            lambda: sum(b.connections.num_users
                        for b in cluster.brokers) == 6)
        await wait_mesh_interest(cluster, topic=0, links=2)

        # firehose clients connect BEFORE churn begins so they live on
        # survivor brokers (a load-0 churn broker wins placement ties)
        fh_sender = cluster.client(seed=90_001, topics=[])
        await cluster.place_on(2)
        fh_sink = cluster.client(seed=90_002, topics=[5])
        await fh_sender.ensure_initialized()
        await fh_sink.ensure_initialized()
        # every broker must be able to route topic 5 (local user or an
        # interested mesh link) before the first giant frame flies
        await wait_until(
            lambda: all(any(b.connections
                            .get_interested_by_topic([5], False)[j]
                            for j in (0, 1))
                        for b in cluster.brokers), timeout=30)

        publisher = survivors[0]
        received = [[] for _ in survivors]

        async def drain(idx: int) -> None:
            while len(received[idx]) < SEQ_MSGS:
                for m in await survivors[idx].receive_messages():
                    assert isinstance(m, Broadcast)
                    received[idx].append(
                        int.from_bytes(bytes(m.message)[:4], "big"))

        stop = asyncio.Event()
        stats: dict = {}
        chaos = [
            asyncio.create_task(_churn_bad_broker(cluster, stop, stats)),
            asyncio.create_task(_connection_storm(cluster, stop, stats)),
            asyncio.create_task(_firehose(fh_sender, fh_sink, stop,
                                          stats)),
        ]
        drains = [asyncio.create_task(drain(i))
                  for i in range(len(survivors))]

        try:
            # the survivor stream: sequenced broadcasts over the window
            interval = CHAOS_SECONDS / SEQ_MSGS
            payload_tail = os.urandom(512)
            for seq in range(SEQ_MSGS):
                await publisher.send_broadcast_message(
                    [0], seq.to_bytes(4, "big") + payload_tail)
                await asyncio.sleep(interval)

            async with asyncio.timeout(60):
                await asyncio.gather(*drains)
        finally:
            # a failing drain must not leave churn running into teardown
            stop.set()
            for t in drains:
                t.cancel()
        chaos_results = await asyncio.gather(*chaos, return_exceptions=True)
        for r in chaos_results:
            assert not isinstance(r, BaseException) \
                or isinstance(r, asyncio.CancelledError), r

        # ---- the zero-loss assertion ---------------------------------
        for idx, seqs in enumerate(received):
            assert seqs == list(range(SEQ_MSGS)), (
                f"survivor {idx} lost/reordered messages: "
                f"got {len(seqs)}, first miss at "
                f"{next((i for i, s in enumerate(seqs) if s != i), '?')}")

        # chaos actually happened
        assert stats.get("churn_cycles", 0) >= 2, stats
        assert stats.get("storm_ok", 0) >= 10, stats
        assert stats.get("firehose_msgs", 0) >= 3, stats

        # ---- convergence: the dead broker aged out of the mesh -------
        for b in cluster.brokers:
            await heartbeat_once(b)
        await wait_until(
            lambda: all(b.connections.num_brokers == 2
                        for b in cluster.brokers), timeout=30)
        for c in survivors:
            c.close()
        fh_sender.close()
        fh_sink.close()
    finally:
        await cluster.stop()


# ---------------------------------------------------------------------------
# composition invariants
# ---------------------------------------------------------------------------


def _route_impl(impl):
    if impl == "native" and not cutthrough.routeplan.available():
        pytest.skip("native route-plan kernel unavailable")


async def _drain_all(conn, settle_s: float = 0.05):
    got = []
    while True:
        try:
            items = await asyncio.wait_for(conn.recv_frames(), settle_s)
        except (asyncio.TimeoutError, Exception):
            return got
        for item in items:
            if type(item) is FrameChunk:
                got.extend(bytes(mv) for mv in item.views())
            else:
                got.append(bytes(item.data))
            item.release()


# ---------------------------------------------------------------------------
# invariant 1: shed mutations mid-view never stall view completion
# ---------------------------------------------------------------------------


async def _subscribe_spammer(cluster, stop: asyncio.Event) -> int:
    """Burst subscribe mutations past the token bucket until admission
    sheds; count the typed Error(SHED) notices."""
    c = cluster.client(seed=71_000, topics=[6])
    sheds = 0
    try:
        await asyncio.wait_for(c.ensure_initialized(), 10.0)
        t = 0
        while not stop.is_set():
            try:
                for _ in range(4):
                    t += 1
                    await c.subscribe([t % 40 + 10])
                while True:
                    await asyncio.wait_for(c.receive_messages(), 0.005)
            except asyncio.TimeoutError:
                pass
            except Error as exc:
                if exc.kind == ErrorKind.SHED:
                    sheds += 1
            except Exception:
                pass
            await asyncio.sleep(0)
    finally:
        c.close()
    return sheds


@pytest.mark.parametrize("impl", ["native", "python"])
async def test_shed_mid_view_never_stalls_consensus(impl, monkeypatch):
    _route_impl(impl)
    # tiny budget so the spammer trips shedding within the first view
    monkeypatch.setenv("PUSHCDN_SUBSCRIBE_RATE", "1")
    monkeypatch.setenv("PUSHCDN_SUBSCRIBE_BURST", "2")
    prev_log = trace_mod.set_log_path(None)
    prev_impl = cutthrough.ROUTE_IMPL
    cutthrough.ROUTE_IMPL = impl
    try:
        # wide topic space: the spammer's mutation topics must be VALID —
        # an invalid topic is a handshake rejection, not a shed
        cluster = await Cluster(num_brokers=1,
                                topics=TopicSpace.range(64)).start()
        try:
            stop = asyncio.Event()
            spam = asyncio.create_task(_subscribe_spammer(cluster, stop))
            run = await run_consensus(cluster, ConsensusConfig(
                num_nodes=4, num_views=3, view_timeout_s=15.0, seed=21))
            stop.set()
            sheds = await asyncio.wait_for(spam, 15.0)
        finally:
            await cluster.stop()
        assert sheds > 0, \
            "the admission layer never shed — the scenario proved nothing"
        assert run.timeouts == 0, \
            f"shed traffic stalled consensus: {run.timeouts} view timeouts"
        assert run.completed == 3
        # the shed offender's connection was degraded, not killed: every
        # quorum vote still arrived
        assert all(v.votes >= 3 for v in run.views)
    finally:
        cutthrough.ROUTE_IMPL = prev_impl
        trace_mod.set_log_path(prev_log)


# ---------------------------------------------------------------------------
# invariant 2: a shard worker death never reorders a survivor's stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["native", "python"])
async def test_shard_worker_death_no_survivor_reorder(impl):
    _route_impl(impl)
    from pushcdn_tpu_torch.testing.shardharness import run_sharded
    prev_impl = cutthrough.ROUTE_IMPL
    prev_win = Memory.set_duplex_window(512 * 1024)
    cutthrough.ROUTE_IMPL = impl
    try:
        # user-0: survivor subscriber on shard 0; user-1: subscriber on
        # shard 1 (dies with its worker); user-2: publisher on shard 0
        run = await run_sharded([(0, [0]), (1, [0]), (0, [])],
                                num_shards=2)
        try:
            rng = np.random.default_rng(1311)

            def frame(seq: int) -> bytes:
                tail = bytes(rng.integers(
                    0, 256, int(rng.integers(8, 64)), dtype=np.uint8))
                return serialize(Broadcast(
                    [0], seq.to_bytes(4, "big") + tail))

            sender = run.user(2).remote
            await sender.send_raw_many([frame(s) for s in range(20)],
                                       flush=True)
            await run.settle(40)
            # mid-stream worker death: shard 1 stops draining its rings
            # and its users are gone — the in-process analog of the
            # SIGKILL the runner's --chaos --shards deals out
            await run.brokers[1].stop()
            await sender.send_raw_many([frame(s) for s in range(20, 40)],
                                       flush=True)
            await run.settle(40)

            got = await _drain_all(run.user(0).remote)
            seqs = []
            for raw in got:
                m = deserialize(raw)
                assert isinstance(m, Broadcast)
                seqs.append(int.from_bytes(bytes(m.message)[:4], "big"))
            assert seqs == list(range(40)), (
                f"survivor lost/reordered: got {len(seqs)}, first miss at "
                f"{next((i for i, s in enumerate(seqs) if s != i), '?')}")
            # the publisher rode out its sibling's death
            assert run.brokers[0].connections.has_user(b"user-2")
            # degradation is COUNTED, never silent: the frames destined
            # for the dead shard show up in shard 0's fallback counters
            # once its ring backs up (ring capacity may absorb them all
            # in a short run, so assert the counters exist, not a floor)
            stats = run.runtimes[0].stats()
            assert "relay_fallbacks" in stats and "relay_shed" in stats
        finally:
            await run.shutdown()
    finally:
        cutthrough.ROUTE_IMPL = prev_impl
        Memory.set_duplex_window(prev_win)
