"""The port's whole system held against the JAX package's: a marshal,
brokers and elastic clients in one process over the Memory transport and
one SQLite discovery file.

Every scenario of ``tests/test_integration.py`` but the BLS one (which
``tests/test_torch_bls.py`` holds), and the cluster leg of
``tests/test_device_plane.py`` that ``tests/test_torch_broker.py`` does
not already run through its harness (the ragged plane end to end), runs
on the JAX package's ``Cluster`` and then on the port's
``Cluster(device="cpu")`` with the same seeds. Each run checks what the
JAX test checks and returns what every client received; the two records
must be equal, byte for byte.
"""

import asyncio
import importlib
from types import SimpleNamespace

import pytest
from _torch_libs import jax_routeplan_available

PACKAGES = ("jax", "port")
SCENARIO_TIMEOUT_S = 50     # per package; the suite caps a test at 120 s


def _pkg(name: str) -> SimpleNamespace:
    root = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}[name]

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    testing = mod("testing.cluster")
    extra = {"device": "cpu"} if name == "port" else {}

    def cluster(**kw):
        return testing.Cluster(**kw, **extra)

    return SimpleNamespace(
        name=name, root=root, cluster=cluster, wait_until=testing.wait_until,
        client=mod("client"), user_auth=mod("proto.auth.user"),
        sig=mod("proto.crypto.signature"),
        embedded=mod("proto.discovery.embedded"), error=mod("proto.error"),
        msg=mod("proto.message"), memory=mod("proto.transport.memory"),
        plane=mod("broker.device_plane"), topic=mod("proto.topic"),
        sync=mod("broker.tasks.sync"),
        cutthrough=mod("broker.tasks.cutthrough"))


def _kind(p, m) -> str:
    return ("broadcast" if isinstance(m, p.msg.Broadcast) else
            "direct" if isinstance(m, p.msg.Direct) else type(m).__name__)


async def _recv(p, client, timeout: float = 10):
    m = await asyncio.wait_for(client.receive_message(), timeout)
    return [_kind(p, m), bytes(m.message)]


def _plane(p, **kw):
    return p.plane.DevicePlaneConfig(**kw)


# ---------------------------------------------------------------------------
# the scenarios of tests/test_integration.py
# ---------------------------------------------------------------------------


async def end_to_end_echo(p):
    cluster = await p.cluster(num_brokers=1).start()
    try:
        alice = cluster.client(seed=1, topics=[0])
        await alice.ensure_initialized()
        await alice.send_direct_message(alice.public_key, b"echo?")
        got = await _recv(p, alice, 5)
        assert got == ["direct", b"echo?"]
        alice.close()
        return got
    finally:
        await cluster.stop()


async def broadcast_between_clients(p):
    cluster = await p.cluster(num_brokers=1).start()
    try:
        alice = cluster.client(seed=1, topics=[0])
        bob = cluster.client(seed=2, topics=[0])
        await alice.ensure_initialized()
        await bob.ensure_initialized()
        await alice.send_broadcast_message([0], b"hello everyone")
        got = [await _recv(p, bob, 5), await _recv(p, alice, 5)]
        assert got == [["broadcast", b"hello everyone"]] * 2
        alice.close()
        bob.close()
        return got
    finally:
        await cluster.stop()


async def double_connect_same_broker_kicks_old(p):
    cluster = await p.cluster(num_brokers=1).start()
    try:
        broker = cluster.brokers[0]
        c1 = cluster.client(seed=7, topics=[0])
        await c1.ensure_initialized()
        await p.wait_until(lambda: broker.connections.num_users == 1)
        c2 = cluster.client(seed=7, topics=[0])   # the same identity
        await c2.ensure_initialized()
        await asyncio.sleep(0.1)
        record = [broker.connections.num_users,
                  broker.connections.has_user(c2.public_key)]
        assert record == [1, True]
        await c2.send_direct_message(c2.public_key, b"still here")
        record.append(await _recv(p, c2, 5))
        assert record[-1] == ["direct", b"still here"]
        c1.close()
        c2.close()
        return record
    finally:
        await cluster.stop()


async def _two_homes(p, cluster, seeds, topics):
    """The first client on broker 1, the second on broker 0, by steering
    the marshal's placement."""
    clients = []
    for home, seed in zip((1, 0), seeds):
        await cluster.steer_load(1 - home, 100)
        await cluster.steer_load(home, 0)
        c = cluster.client(seed=seed, topics=topics)
        await c.ensure_initialized()
        await p.wait_until(
            lambda h=home: cluster.brokers[h].connections.num_users == 1)
        clients.append(c)
    return clients


async def double_connect_across_brokers_kicks_old(p):
    cluster = await p.cluster(num_brokers=2).start()
    try:
        c1, c2 = await _two_homes(p, cluster, (9, 9), [0])
        await asyncio.sleep(0.2)
        await p.sync.partial_user_sync(cluster.brokers[0])
        await asyncio.sleep(0.2)
        record = [b.connections.num_users for b in cluster.brokers]
        assert record == [1, 0]   # broker 1's stale session was evicted
        c1.close()
        c2.close()
        return record
    finally:
        await cluster.stop()


async def cross_broker_direct_message(p):
    cluster = await p.cluster(num_brokers=2).start()
    try:
        alice, bob = await _two_homes(p, cluster, (11, 12), [0])
        await asyncio.sleep(0.2)          # user-sync claims propagate
        await alice.send_direct_message(bob.public_key, b"across the mesh")
        got = await _recv(p, bob, 5)
        assert got == ["direct", b"across the mesh"]
        alice.close()
        bob.close()
        return got
    finally:
        await cluster.stop()


async def cross_broker_broadcast(p):
    cluster = await p.cluster(num_brokers=2).start()
    try:
        alice, bob = await _two_homes(p, cluster, (21, 22), [1])
        await asyncio.sleep(0.2)          # topic interest propagates
        await bob.send_broadcast_message([1], b"DA proposal")
        got = await _recv(p, alice, 5)
        assert got == ["broadcast", b"DA proposal"]
        alice.close()
        bob.close()
        return got
    finally:
        await cluster.stop()


async def subscribe_delivery_and_invalid_topic_kick(p):
    cluster = await p.cluster(num_brokers=1).start()
    try:
        alice = cluster.client(seed=31, topics=[0])
        bob = cluster.client(seed=32, topics=[])
        await alice.ensure_initialized()
        await bob.ensure_initialized()
        await alice.send_broadcast_message([0], b"one")
        record = [await _recv(p, alice, 5)]
        await bob.subscribe([0])
        await asyncio.sleep(0.1)
        await alice.send_broadcast_message([0], b"two")
        record.append(await _recv(p, bob, 5))   # "one" predates it
        assert record == [["broadcast", b"one"], ["broadcast", b"two"]]
        # 42 is outside the test topic space: the broker kicks bob
        await bob._connection.send_message(p.msg.Subscribe([42]), flush=True)
        await asyncio.sleep(0.2)
        record.append(cluster.brokers[0].connections.num_users)
        assert record[-1] == 1
        alice.close()
        bob.close()
        return record
    finally:
        await cluster.stop()


async def whitelist_rejection(p):
    cluster = await p.cluster(num_brokers=1).start()
    try:
        scheme = p.sig.DEFAULT_SCHEME
        allowed = scheme.generate_keypair(seed=41)
        denied = scheme.generate_keypair(seed=42)
        admin = await p.embedded.Embedded.new(cluster.db)
        await admin.set_whitelist([allowed.public_key])
        await admin.close()
        ok = p.client.Client(p.client.ClientConfig(
            marshal_endpoint=cluster.marshal_endpoint, keypair=allowed,
            protocol=p.memory.Memory))
        await asyncio.wait_for(ok.ensure_initialized(), 5)
        ok.close()
        conn = await p.memory.Memory.connect(cluster.marshal_endpoint)
        with pytest.raises(p.error.Error) as ei:
            await asyncio.wait_for(p.user_auth.authenticate_with_marshal(
                conn, scheme, denied), 5)
        conn.close()
        assert "whitelist" in str(ei.value)
        return [ei.value.kind.name, str(ei.value)]
    finally:
        await cluster.stop()


async def client_reconnects_after_broker_drop(p):
    cluster = await p.cluster(num_brokers=1).start()
    try:
        alice = cluster.client(seed=51, topics=[0])
        await alice.ensure_initialized()
        broker = cluster.brokers[0]
        broker.connections.remove_user(alice.public_key, "test kill")
        await asyncio.sleep(0.05)
        try:   # the first send may fail once, then the client re-dials
            await alice.send_direct_message(alice.public_key, b"probe")
        except p.error.Error:
            pass
        await asyncio.wait_for(alice.ensure_initialized(), 10)
        await alice.send_direct_message(alice.public_key, b"healed")
        while True:   # the probe may or may not have survived the reset
            got = await _recv(p, alice, 5)
            if got[1] == b"healed":
                break
        topics = sorted(broker.connections.user_topics.get_values_of_key(
            alice.public_key))
        assert topics == [0]   # replayed during the re-authentication
        alice.close()
        return [got, topics]
    finally:
        await cluster.stop()


async def device_plane_routes_broker_traffic(p):
    cluster = await p.cluster(num_brokers=1, device_plane=_plane(
        p, num_user_slots=64, ring_slots=64, frame_bytes=1024,
        batch_window_s=0.005, bypass_max_items=0)).start()
    try:
        alice = cluster.client(seed=61, topics=[0])
        bob = cluster.client(seed=62, topics=[0])
        await alice.ensure_initialized()
        await bob.ensure_initialized()
        device = cluster.brokers[0].device_plane
        await alice.send_broadcast_message([0], b"via the device plane")
        record = [await _recv(p, bob), await _recv(p, alice)]
        await alice.send_direct_message(bob.public_key, b"direct on device")
        record.append(await _recv(p, bob))
        await p.wait_until(lambda: device.messages_routed >= 3)
        assert device.steps >= 1
        # too big for the 1 KB base lane: the 16 KB lane on the device
        routed = device.messages_routed
        await alice.send_direct_message(bob.public_key, b"z" * 4096)
        record.append(await _recv(p, bob))
        await p.wait_until(lambda: device.messages_routed == routed + 1)
        # too big for every lane: the host path
        routed = device.messages_routed
        await alice.send_direct_message(bob.public_key, b"z" * 30_000)
        record.append(await _recv(p, bob))
        assert device.messages_routed == routed
        record.append(device.messages_routed)
        assert record[:-1] == [
            ["broadcast", b"via the device plane"]] * 2 + [
            ["direct", b"direct on device"], ["direct", b"z" * 4096],
            ["direct", b"z" * 30_000]]
        alice.close()
        bob.close()
        return record
    finally:
        await cluster.stop()


async def device_plane_routes_high_topics(p):
    cluster = await p.cluster(
        num_brokers=1, device_plane=_plane(
            p, num_user_slots=64, ring_slots=64, frame_bytes=1024,
            batch_window_s=0.005, bypass_max_items=0),
        topics=p.topic.TopicSpace.range(256)).start()
    try:
        alice = cluster.client(seed=71, topics=[200])
        bob = cluster.client(seed=72, topics=[200, 255])
        await alice.ensure_initialized()
        await bob.ensure_initialized()
        device = cluster.brokers[0].device_plane
        await alice.send_broadcast_message([200], b"high topic")
        record = [await _recv(p, bob), await _recv(p, alice)]
        await p.wait_until(lambda: device.messages_routed >= 2)
        routed = device.messages_routed
        await alice.send_broadcast_message([255], b"edge of the space")
        record.append(await _recv(p, bob))   # only bob, on the device
        await p.wait_until(lambda: device.messages_routed == routed + 1)
        assert record == [["broadcast", b"high topic"]] * 2 + [
            ["broadcast", b"edge of the space"]]
        alice.close()
        bob.close()
        return record + [device.messages_routed]
    finally:
        await cluster.stop()


async def device_plane_compact_topic_words(p):
    cluster = await p.cluster(
        num_brokers=1, device_plane=_plane(
            p, num_user_slots=32, ring_slots=32, frame_bytes=1024,
            topic_words=1, batch_window_s=0.005, bypass_max_items=0),
        topics=p.topic.TopicSpace.range(256)).start()
    try:
        alice = cluster.client(seed=81, topics=[3, 40])
        await alice.ensure_initialized()
        device = cluster.brokers[0].device_plane
        assert device._masks.ndim == 1
        await alice.send_broadcast_message([3], b"compact lane")
        record = [await _recv(p, alice)]
        await p.wait_until(lambda: device.messages_routed >= 1)
        routed = device.messages_routed
        await alice.send_broadcast_message([40], b"host path")
        record.append(await _recv(p, alice))
        assert device.messages_routed == routed   # beyond the 1-word space
        assert record == [["broadcast", b"compact lane"],
                          ["broadcast", b"host path"]]
        alice.close()
        return record + [device.messages_routed]
    finally:
        await cluster.stop()


# ---------------------------------------------------------------------------
# the cluster leg of tests/test_device_plane.py the harness does not run
# ---------------------------------------------------------------------------


async def ragged_delivery_impl_end_to_end(p):
    cluster = await p.cluster(num_brokers=1, device_plane=_plane(
        p, num_user_slots=32, ring_slots=64, frame_bytes=1024,
        batch_window_s=0.002, bypass_max_items=0,
        delivery_impl="ragged")).start()
    try:
        device = cluster.brokers[0].device_plane
        assert device.delivery_impl == "ragged"
        stable = cluster.client(seed=520, topics=[0, 1])
        await stable.ensure_initialized()
        received = []

        async def drain():
            while True:
                received.append(bytes((await stable.receive_message()).message))

        drain_task = asyncio.create_task(drain())
        sender = cluster.client(seed=521, topics=[])
        await sender.ensure_initialized()
        for i in range(4):
            await sender.send_broadcast_message([0], b"m%d" % i)
        await sender.send_broadcast_message([1], b"t1")
        await sender.send_broadcast_message([0, 1], b"union")  # one copy
        await sender.send_direct_message(stable.public_key, b"direct")
        await p.wait_until(lambda: len(received) >= 7, timeout=10)
        await asyncio.sleep(0.05)   # a duplicate would land right behind
        drain_task.cancel()
        record = sorted(received)
        assert record == sorted([b"m0", b"m1", b"m2", b"m3", b"t1",
                                 b"union", b"direct"])
        assert device.ragged_steps >= 1 and not device.disabled
        stable.close()
        sender.close()
        return record
    finally:
        await cluster.stop()


SCENARIOS = [end_to_end_echo, broadcast_between_clients,
             double_connect_same_broker_kicks_old,
             double_connect_across_brokers_kicks_old,
             cross_broker_direct_message, cross_broker_broadcast,
             subscribe_delivery_and_invalid_topic_kick, whitelist_rejection,
             client_reconnects_after_broker_drop,
             device_plane_routes_broker_traffic,
             device_plane_routes_high_topics,
             device_plane_compact_topic_words,
             ragged_delivery_impl_end_to_end]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
async def test_cluster_delivers_what_the_jax_cluster_delivers(scenario):
    records = {}
    for name in PACKAGES:
        async with asyncio.timeout(SCENARIO_TIMEOUT_S):
            records[name] = await scenario(_pkg(name))
    assert records["port"] == records["jax"]


@pytest.mark.parametrize("call", ["subscribe_from", "last_value",
                                  "subscribe_pattern"])
async def test_replay_subscribes_without_retained_topics_match_jax(call):
    """With retention off (no ``PUSHCDN_RETAIN_TOPICS``) both brokers
    serve ``SubscribeFrom`` alike: an explicit topic is a plain subscribe
    that keeps the user and delivers the topic's next broadcast, a
    pattern binds nothing, and an unknown topic kicks as ``Subscribe``
    does. ``tests/test_torch_retention.py`` holds the replay itself."""
    args = {"subscribe_from": (0, 0), "last_value": (0,),
            "subscribe_pattern": ("consensus.*",)}[call]
    out = {}
    for name in PACKAGES:
        p = _pkg(name)
        async with asyncio.timeout(SCENARIO_TIMEOUT_S):
            cluster = await p.cluster(num_brokers=1).start()
            try:
                alice = cluster.client(seed=91, topics=[])
                bob = cluster.client(seed=92, topics=[])
                await alice.ensure_initialized()
                await bob.ensure_initialized()
                conn = alice._connection
                await getattr(alice, call)(*args)
                await asyncio.sleep(0.2)
                broker = cluster.brokers[0]
                state = (conn.is_closed, broker.connections.num_users,
                         sorted(broker.connections.user_topics
                                .get_values_of_key(alice.public_key)))
                await bob.send_broadcast_message([0], b"after")
                await bob.send_direct_message(alice.public_key, b"marker")
                got = await _recv(p, alice, 5)
                if got == ["broadcast", b"after"]:
                    got = await _recv(p, alice, 5)
                    state += (b"after",)
                assert got == ["direct", b"marker"]
                # 42 is outside the test topic space: the broker kicks
                await conn.send_message(p.msg.SubscribeFrom(topic=42, seq=0),
                                        flush=True)
                await asyncio.sleep(0.2)
                out[name] = state + (conn.is_closed,)
                alice.close()
                bob.close()
            finally:
                await cluster.stop()
    if call == "subscribe_pattern":
        want = (False, 2, [], True)
    else:
        want = (False, 2, [0], b"after", True)
    assert out["jax"] == want
    assert out["port"] == want


TOPIC_NAMES = "consensus.vote=1,consensus.qc=2,bulk.blob=3"


async def test_subscribe_pattern_with_bound_names_matches_jax(monkeypatch):
    """With ``PUSHCDN_TOPIC_NAMES`` bound, ``subscribe_pattern`` subscribes
    the bound topics the pattern covers on both packages, interest crosses
    the broker link, and the bound names set the flow classes the ledger
    counts by: the same per-class fates and the same per-link counts, on
    the scalar twin (route ``python``) and on the reference's default
    (``auto``: the cut-through plane on these plane-less brokers)."""
    monkeypatch.setenv("PUSHCDN_TOPIC_NAMES", TOPIC_NAMES)
    assert jax_routeplan_available()
    for route in ("python", "auto"):
        for name in PACKAGES:
            monkeypatch.setattr(_pkg(name).cutthrough, "ROUTE_IMPL", route)
        out = {}
        for name in PACKAGES:
            out[name] = await _bound_names_run(_pkg(name))
        assert out["jax"]["topics"] == [1, 2], route
        # the bound names' classes: the two consensus.* broadcasts crossed
        # the link as consensus
        consensus, bulk = 1, 3
        assert sorted(row[consensus]
                      for row in out["jax"]["link_sent"]) == [0, 2], route
        fates = out["jax"]["fates"]
        if route == "python":
            # the scalar twin records the unheard bulk.blob one as a bulk
            # drop
            assert fates["dropped/no_interest"][bulk] == 1
        else:
            # the plan classes the two deliveries at alice's broker by
            # their topic's bound name (the scalar twin counts them live)
            assert fates["delivered/egress"][consensus] == 2, fates
        cut = {name: out[name].pop("cutthrough") for name in PACKAGES}
        if route == "auto":
            assert cut["jax"] > 0 and cut["port"] > 0, cut
        else:
            assert cut == {"jax": 0, "port": 0}, cut
        assert out["port"] == out["jax"], route


async def _bound_names_run(p) -> dict:
    ledger = importlib.import_module(f"{p.root}.proto.ledger")
    metrics = importlib.import_module(f"{p.root}.proto.metrics")
    async with asyncio.timeout(SCENARIO_TIMEOUT_S):
        cluster = await p.cluster(
            num_brokers=2, topics=p.topic.TopicSpace.range(8)).start()
        try:
            alice, bob = await _two_homes(p, cluster, (93, 94), [])
            home = cluster.brokers[1]     # alice's broker
            await asyncio.sleep(0.2)
            ledger.reset_for_tests()
            cut0 = metrics.ROUTE_CUTTHROUGH_FRAMES.value
            await alice.subscribe_pattern("consensus.*")
            await p.wait_until(lambda: home.connections.user_topics
                               .get_values_of_key(alice.public_key))
            topics = sorted(home.connections.user_topics
                            .get_values_of_key(alice.public_key))
            await p.sync.partial_topic_sync(home)
            await p.wait_until(lambda: len(cluster.brokers[0].connections
                                           .get_interested_by_topic(
                                               [2], False)[1]) == 1)
            for t in (1, 3, 2):
                await bob.send_broadcast_message([t], b"topic %d" % t)
            await bob.send_direct_message(alice.public_key, b"marker")
            got = [await _recv(p, alice) for _ in range(3)]
            assert got == [["broadcast", b"topic 1"],
                           ["broadcast", b"topic 2"],
                           ["direct", b"marker"]]
            await asyncio.sleep(0.2)
            led = ledger.LEDGER
            out = dict(
                topics=topics, got=got,
                fates={"/".join(k): v for k, v in led.fates.items()},
                ingress=led.ingress,
                link_sent=sorted(led.link_sent.values()),
                link_recv=sorted(led.link_recv.values()),
                cutthrough=metrics.ROUTE_CUTTHROUGH_FRAMES.value - cut0)
            alice.close()
            bob.close()
            return out
        finally:
            await cluster.stop()
