"""The port's elastic re-homing held against the JAX package's.

The cases of ``tests/test_migration.py`` run on both packages with the
same seeds: the ``Migrate`` codec (and each package decoding the other's
frames), a subscriber re-homed while a topic streams to it, and directs
sent while the migration is in flight, on the cut-through plane and on
its scalar twin. Each run returns what it saw (the de-duplicated stream,
the re-home summary, where the user lives, the flight-recorder trail),
and the port's record must equal JAX's. The reference's sharded cases
(the DirectMap claim racing directs and the ``parting`` chase) are held
in ``tests/test_torch_sharding.py::test_migration_race_sharded``; here
the worker harness of one and of two shards re-homes its users itself,
and the ``Migrate`` frames, the summaries and the directs that chase the
users afterwards must agree. Then ``GET /drain``'s route with and
without a live peer, and a re-home under the device plane (the port's on
the CPU).
"""

import asyncio
import importlib
from types import SimpleNamespace

import pytest
from _torch_libs import jax_routeplan_available

from pushcdn_tpu_torch.native import routeplan as port_routeplan

ROOTS = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}
IMPLS = ("native", "python")
NATIVE_OK = jax_routeplan_available() and port_routeplan.available()
TOPIC = 1


def _pkg(name: str) -> SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{ROOTS[name]}.{path}")

    cluster = mod("testing.cluster")
    extra = {"device": "cpu"} if name == "port" else {}
    return SimpleNamespace(
        name=name, rehome=mod("broker.rehome"),
        cutthrough=mod("broker.tasks.cutthrough"),
        vmap=mod("broker.versioned_map"), trace=mod("proto.trace"),
        error=mod("proto.error"), msg=mod("proto.message"),
        topic=mod("proto.topic"), base=mod("proto.transport.base"),
        embedded=mod("proto.discovery.embedded"),
        discovery=mod("proto.discovery.base"),
        plane=mod("broker.device_plane"),
        shardharness=mod("testing.shardharness"),
        cluster=lambda **kw: cluster.Cluster(**kw, **extra),
        wait_until=cluster.wait_until)


PACKAGES = {name: _pkg(name) for name in ROOTS}
PORT = PACKAGES["port"]


def _need(impl: str) -> None:
    if impl == "native" and not NATIVE_OK:
        pytest.skip("native route-plan library unavailable (no working g++)")


async def _both(record, *args, timeout: float = 50) -> dict:
    out = {}
    for name, p in PACKAGES.items():
        async with asyncio.timeout(timeout):
            out[name] = await record(p, *args)
    assert out["port"] == out["jax"], out
    return out["port"]


def _set_impl(monkeypatch, impl: str) -> None:
    for p in PACKAGES.values():
        monkeypatch.setattr(p.cutthrough, "ROUTE_IMPL", impl)


# ---------------------------------------------------------------------------
# tests/test_migration.py: wire format
# ---------------------------------------------------------------------------

def _migrates(p):
    m = p.msg
    return (m.Migrate(target="it0-b1-pub", permit=12345),
            m.Migrate(target="x" * 300, permit=2 ** 63),
            m.Migrate(target="no-permit"),  # permit=0: marshal fallback
            m.Migrate(target=""))


def test_migrate_codec_roundtrip():
    """Each package round-trips ``Migrate``, writes the same bytes and
    reads the other's."""
    jax, port = PACKAGES["jax"], PORT
    for a, b in zip(_migrates(jax), _migrates(port)):
        raw = port.msg.serialize(b)
        assert raw == jax.msg.serialize(a)
        assert port.msg.deserialize(raw) == b
        got = jax.msg.deserialize(raw)
        assert (got.target, got.permit) == (b.target, b.permit)


def test_migrate_codec_rejects_truncated():
    for p in PACKAGES.values():
        frame = p.msg.serialize(p.msg.Migrate(target="endpoint", permit=7))
        for cut in (1, len(frame) // 2, len(frame) - 1):
            with pytest.raises(p.error.Error):
                p.msg.deserialize(frame[:cut])


# ---------------------------------------------------------------------------
# tests/test_migration.py: live-cluster migration
# ---------------------------------------------------------------------------

def _seq(payload) -> int:
    return int.from_bytes(bytes(payload)[:4], "big")


async def _collect_seqs(p, client, total: int, out: list):
    """Every broadcast/direct's seq in arrival order (duplicates kept)
    until each seq in [0, total) has been seen."""
    m = p.msg
    seen = set()
    while len(seen) < total:
        for x in await asyncio.wait_for(client.receive_messages(), 20.0):
            if isinstance(x, (m.Broadcast, m.Direct)):
                s = _seq(x.message)
                out.append(s)
                seen.add(s)


def _dedup(seqs):
    seen, ordered = set(), []
    for s in seqs:
        if s not in seen:
            seen.add(s)
            ordered.append(s)
    return ordered


async def _two_broker_pair(p, cluster, sub_topics):
    """Subscriber homed on broker 0, publisher on broker 1."""
    await cluster.place_on(0)
    sub = cluster.client(seed=82_000, topics=sub_topics)
    await asyncio.wait_for(sub.ensure_initialized(), 10.0)
    pk = sub.config.keypair.public_key
    await p.wait_until(lambda: cluster.brokers[0].connections.has_user(pk))
    await cluster.place_on(1)
    pub = cluster.client(seed=82_001)
    await asyncio.wait_for(pub.ensure_initialized(), 10.0)
    await p.wait_until(
        lambda: cluster.brokers[1].connections.num_users == 1)
    return sub, pub, pk


async def _migrate_mid_stream(p, kind: str, total: int,
                              plane=None) -> dict:
    """Re-home the subscriber off broker 0 while ``total`` broadcasts
    (``kind`` "broadcast") or directs stream to it from broker 1."""
    prev_log = p.trace.set_log_path(None)
    kw = {} if plane is None else {"device_plane": plane(p)}
    cluster = await p.cluster(num_brokers=2,
                              topics=p.topic.TopicSpace.range(8),
                              **kw).start()
    try:
        sub, pub, pk = await _two_broker_pair(p, cluster, [TOPIC])
        b0, b1 = cluster.brokers
        if kind == "broadcast":
            # the publisher's home must know the old home wants TOPIC
            await p.wait_until(lambda: len(
                b1.connections.get_interested_by_topic([TOPIC], False)[1])
                == 1)
        else:
            # the sender's home must hold the recipient's DirectMap row
            await p.wait_until(lambda: b1.connections.direct_map.get(pk)
                               == b0.connections.identity)
        old_rec = b0.connections.users[pk].connection.flightrec
        got: list = []
        collector = asyncio.create_task(_collect_seqs(p, sub, total, got))
        try:
            async def publish():
                for s in range(total):
                    payload = s.to_bytes(4, "big") + b"payload"
                    if kind == "broadcast":
                        await pub.send_broadcast_message([TOPIC], payload)
                    else:
                        await pub.send_direct_message(pk, payload)
                    await asyncio.sleep(0.002)

            publisher = asyncio.create_task(publish())
            # drain mid-stream: the subscriber is re-homed while live
            await asyncio.sleep(0.1)
            summary = await p.rehome.rehome_users(b0)
            await asyncio.wait_for(publisher, 30.0)
            await asyncio.wait_for(collector, 30.0)
        finally:
            collector.cancel()
        await p.wait_until(lambda: b1.connections.has_user(pk))
        await p.wait_until(lambda: not b0.connections.has_user(pk))
        new_rec = b1.connections.users[pk].connection.flightrec
        out = dict(
            summary=summary,
            stream=_dedup(got) if kind == "broadcast" else sorted(got),
            migrate_out=any(e == "migrate-out"
                            for _, e, _ in old_rec._events),
            migrate_in=any(e == "migrate-in"
                           for _, e, _ in new_rec._events),
            homes=[b0.connections.num_users, b1.connections.num_users])
        sub.close()
        pub.close()
        return out
    finally:
        await cluster.stop()
        p.trace.set_log_path(prev_log)


def _want(total: int) -> dict:
    return dict(summary={"users": 1, "signaled": 1, "orphaned": 0,
                         "remaining": 1, "no_target": False},
                stream=list(range(total)), migrate_out=True,
                migrate_in=True, homes=[0, 2])


@pytest.mark.parametrize("impl", IMPLS)
async def test_no_loss_no_reorder_across_migration(impl, monkeypatch):
    """The de-duplicated arrival order is the whole published sequence
    on both packages: nothing lost, nothing reordered; the user ends at
    the new home only, with the trail on both sides."""
    _need(impl)
    _set_impl(monkeypatch, impl)
    assert await _both(_migrate_mid_stream, "broadcast", 150) == _want(150)


@pytest.mark.parametrize("impl", IMPLS)
async def test_direct_mid_migration_exactly_one_home(impl, monkeypatch):
    """Directs sent mid-migration chase the user through the DirectMap
    row: every one arrives exactly once, on both packages."""
    _need(impl)
    _set_impl(monkeypatch, impl)
    assert await _both(_migrate_mid_stream, "direct", 120) == _want(120)


def _small_plane(p):
    return p.plane.DevicePlaneConfig(
        num_user_slots=64, ring_slots=64, frame_bytes=1024, topic_words=1,
        batch_window_s=0.002, bypass_max_items=0, delivery_impl="dense")


async def _plane_migration(p) -> dict:
    """Re-home a subscriber between two brokers that carry a dense
    device plane, then stream to it at its new home."""
    cluster = await p.cluster(num_brokers=2,
                              topics=p.topic.TopicSpace.range(8),
                              device_plane=_small_plane(p)).start()
    try:
        sub, pub, pk = await _two_broker_pair(p, cluster, [TOPIC])
        b0, b1 = cluster.brokers
        # the client acts on Migrate while it receives
        got: list = []
        collector = asyncio.create_task(_collect_seqs(p, sub, 60, got))
        summary = await p.rehome.rehome_users(b0)
        await p.wait_until(lambda: b1.connections.has_user(pk)
                           and not b0.connections.has_user(pk))
        await p.wait_until(lambda: not b0.connections.parting)
        routed0 = b1.device_plane.messages_routed
        for s in range(60):
            await pub.send_broadcast_message(
                [TOPIC], s.to_bytes(4, "big") + b"payload")
        await asyncio.wait_for(collector, 30.0)
        out = dict(summary=summary, stream=got,
                   routed=b1.device_plane.messages_routed - routed0 >= 60,
                   homes=[b0.connections.num_users, b1.connections.num_users])
        sub.close()
        pub.close()
        return out
    finally:
        await cluster.stop()


async def test_migration_under_the_device_plane(monkeypatch):
    """Both brokers carry a dense device plane (the port's on the CPU):
    once the user has moved, its new home's plane delivers every
    broadcast to it, in order, and the old home holds no trace of it.
    (Frames routed by the old home's plane while the user is parting can
    be lost on both packages: the plane does not chase ``parting``.)"""
    for name in ROOTS:
        monkeypatch.setattr(importlib.import_module(
            f"{ROOTS[name]}.broker.connections"), "PARTING_GRACE_S", 0.2)
    out = await _both(_plane_migration, timeout=100)
    assert out == dict(summary=_want(0)["summary"], stream=list(range(60)),
                       routed=True, homes=[0, 2])


# ---------------------------------------------------------------------------
# the worker harness re-homes its own users (one and two shards)
# ---------------------------------------------------------------------------

async def _drain_messages(p, conn, settle_s: float = 0.05) -> list:
    got = []
    while True:
        try:
            items = await asyncio.wait_for(conn.recv_frames(), settle_s)
        except (asyncio.TimeoutError, Exception):
            return got
        for item in items:
            if type(item) is p.base.FrameChunk:
                got.extend(p.msg.deserialize(bytes(mv))
                           for mv in item.views())
            else:
                got.append(p.msg.deserialize(bytes(item.data)))
            item.release()


async def _sharded_rehome(p, num_shards: int) -> dict:
    """Users on every worker shard, one mesh peer that is also the live
    broker in each worker's discovery file. Every worker re-homes its own
    users; then the peer claims them (as the new home's ``add_user``
    would) and directs sent afterwards chase them to the peer."""
    m = p.msg
    run = await p.shardharness.run_sharded(
        [(i % num_shards, [0]) for i in range(5)], num_shards=num_shards,
        connected_brokers=[([0], [])])
    peer_pub, peer_priv = "rehome-peer-pub", "rehome-peer-priv"
    ident = p.discovery.BrokerIdentifier(peer_pub, peer_priv)
    handles = []
    try:
        for b in run.brokers:
            h = await p.embedded.Embedded.new(b.config.discovery_endpoint,
                                              identity=ident)
            await h.perform_heartbeat(0, 60.0)
            handles.append(h)
        summaries = [await p.rehome.rehome_users(b) for b in run.brokers]
        await run.settle(40)
        migrates = []
        for i in range(5):
            got = await _drain_messages(p, run.user(i).remote)
            migrates.append([(x.target, x.permit > 0) for x in got
                             if isinstance(x, m.Migrate)])
        # the claim: the peer out-versions the DirectMap rows of users
        # 0-3 (user 4 stays, and sends the directs)
        peer = run.peer(0)
        claim = p.vmap.VersionedMap(local_identity=peer.identifier)
        for i in range(4):
            key = f"user-{i}".encode()
            claim.insert(key, peer.identifier)
            claim.insert(key, peer.identifier)  # version 2 > local 1
        run.brokers[0].connections.apply_user_sync(
            p.vmap.VersionedMap.serialize_entries(claim.full()))
        await run.settle(40)
        await _drain_messages(p, peer.remote)
        directs = [m.serialize(m.Direct(
            recipient=f"user-{i}".encode(),
            message=i.to_bytes(4, "big") + b"after"))
            for i in range(4)]
        await run.user(4).remote.send_raw_many(directs, flush=True)
        await run.settle(40)
        chased = sorted((bytes(x.recipient), _seq(x.message))
                        for x in await _drain_messages(p, peer.remote)
                        if isinstance(x, m.Direct))
        return dict(summaries=summaries, migrates=migrates, chased=chased,
                    users=[b.connections.num_users for b in run.brokers])
    finally:
        for h in handles:
            await h.close()
        await run.shutdown()


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("impl", IMPLS)
async def test_sharded_workers_rehome_their_own_users(impl, num_shards,
                                                      monkeypatch):
    _need(impl)
    _set_impl(monkeypatch, impl)
    out = await _both(_sharded_rehome, num_shards)
    per = [sum(1 for i in range(5) if i % num_shards == s)
           for s in range(num_shards)]
    assert [s["signaled"] for s in out["summaries"]] == per
    assert all(s["orphaned"] == 0 and not s["no_target"]
               for s in out["summaries"])
    # every user got exactly one Migrate, to the live peer, with a permit
    assert out["migrates"] == [[("rehome-peer-pub", True)]] * 5
    # users 0-3 were claimed away; user 4 (on shard 0) stays
    assert out["users"] == [1] + [0] * (num_shards - 1)
    assert out["chased"] == [(f"user-{i}".encode(), i) for i in range(4)]


# ---------------------------------------------------------------------------
# GET /drain
# ---------------------------------------------------------------------------

async def _drain_route(p) -> list:
    cluster = await p.cluster(num_brokers=2).start()
    try:
        await cluster.place_on(0)
        c = cluster.client(seed=82_100, topics=[0])
        await asyncio.wait_for(c.ensure_initialized(), 10.0)
        pk = c.config.keypair.public_key
        b0, b1 = cluster.brokers
        await p.wait_until(lambda: b0.connections.has_user(pk))
        # the client acts on Migrate while it receives
        receiver = asyncio.create_task(c.receive_messages())
        first = await b0._drain_route({})
        await p.wait_until(lambda: b1.connections.has_user(pk))
        # the last broker standing has no peer to re-home to: the users
        # stay, and the summary says so
        await b0.stop()
        cluster.brokers = [b1]
        alone = await b1._drain_route({})
        out = [first, alone, b1.connections.has_user(pk), b1.draining]
        receiver.cancel()
        c.close()
        return out
    finally:
        await cluster.stop()


async def test_drain_route_rehomes_then_reports_no_target():
    first, alone, stays, draining = await _both(_drain_route)
    assert first == {"users": 1, "signaled": 1, "orphaned": 0,
                     "remaining": 1, "no_target": False,
                     "was_draining": False}
    assert alone == {"users": 1, "signaled": 0, "orphaned": 1,
                     "remaining": 1, "no_target": True,
                     "was_draining": False}
    assert stays and draining
