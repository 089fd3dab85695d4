"""The port's mesh group wired into brokers, held against the JAX
package's on the CPU.

Every scenario of ``tests/test_mesh_group.py`` runs on the JAX package's
``MeshCluster`` (its virtual CPU mesh) and then on the port's
(``MeshCluster(device="cpu")``: every shard on the CPU) with the same
seeds. Each run checks what the JAX test checks and returns what the
clients received with the group's state (steps taken, deliveries
routed, host links, kicks); the two records must be equal. Then the
cases of ``tests/test_mesh_discovery.py`` against both packages'
``MeshDiscovery``, the port's identifiers on a folded mesh, and the
card's fail-fast rule for a group of brokers.
"""

import asyncio
import importlib
import os
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

PACKAGES = ("jax", "port")
SCENARIO_TIMEOUT_S = 50     # per package; the suite caps a test at 120 s


def _pkg(name: str) -> SimpleNamespace:
    root = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}[name]

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    mc = mod("testing.mesh_cluster")
    mesh_mod = mod("parallel.mesh")
    port = name == "port"

    def cluster(**kw):
        return mc.MeshCluster(**kw, **({"device": "cpu"} if port else {}))

    def mesh(n=None):
        if not port:
            return mesh_mod.make_broker_mesh(n)
        return mesh_mod.make_broker_mesh(n, devices=["cpu"] * (n or 8))

    def collectives(group):
        return (group.collectives_last_step if port
                else group.collectives_last_trace)

    return SimpleNamespace(
        name=name, cluster=cluster, mesh=mesh, collectives=collectives,
        # the JAX group's default exchange is fused; the port's picks per
        # array when every shard shares a device, so ask for fused
        fused={"fused_collective": True} if port else {},
        mg=mod("broker.mesh_group"), mesh_mod=mesh_mod,
        msg=mod("proto.message"), memory=mod("proto.transport.memory"),
        wait_until=mod("testing.cluster").wait_until)


async def _recv(p, client, timeout: float = 10):
    m = await asyncio.wait_for(client.receive_message(), timeout)
    kind = ("broadcast" if isinstance(m, p.msg.Broadcast) else
            "direct" if isinstance(m, p.msg.Direct) else type(m).__name__)
    return [kind, bytes(m.message)]


async def _nothing_more(client, wait: float = 0.3) -> bool:
    """True when nothing arrives within ``wait`` (exactly-once checks)."""
    pending = asyncio.create_task(client.receive_message())
    await asyncio.sleep(wait)
    quiet = not pending.done()
    pending.cancel()
    return quiet


def _links(cluster) -> list:
    return [b.connections.num_brokers for b in cluster.brokers]


def _group_state(cluster) -> list:
    g = cluster.group
    return [g.steps >= 1, g.messages_routed, g.disabled, g.overflow_seen]


# ---------------------------------------------------------------------------
# the scenarios of tests/test_mesh_group.py
# ---------------------------------------------------------------------------


async def cross_shard_broadcast_over_mesh_only(p):
    cluster = await p.cluster(num_shards=4).start(form_host_mesh=False)
    try:
        clients = [await cluster.place_client(seed=100 + shard, shard=shard,
                                              topics=[0])
                   for shard in range(4)]
        links = _links(cluster)
        assert links == [0] * 4
        await clients[0].send_broadcast_message([0], b"over the mesh")
        got = [await _recv(p, c) for c in clients]
        assert got == [["broadcast", b"over the mesh"]] * 4
        await p.wait_until(lambda: cluster.group.messages_routed >= 4)
        for c in clients:
            c.close()
        return [got, links, _group_state(cluster)]
    finally:
        await cluster.stop()


async def cross_shard_direct_over_mesh_only(p):
    cluster = await p.cluster(num_shards=4).start(form_host_mesh=False)
    try:
        alice = await cluster.place_client(seed=200, shard=0, topics=[0])
        bob = await cluster.place_client(seed=201, shard=3, topics=[0])
        links = _links(cluster)
        assert links == [0] * 4
        await alice.send_direct_message(bob.public_key, b"shard 0 -> shard 3")
        got = await _recv(p, bob)
        assert got == ["direct", b"shard 0 -> shard 3"]
        once = await _nothing_more(bob)
        assert once
        alice.close()
        bob.close()
        return [got, once, links, _group_state(cluster)]
    finally:
        await cluster.stop()


async def cross_shard_traffic_with_gathered_bytes(p):
    cluster = await p.cluster(
        num_shards=4, gather_frame_bytes=True).start(form_host_mesh=False)
    try:
        alice = await cluster.place_client(seed=210, shard=0, topics=[0])
        bob = await cluster.place_client(seed=211, shard=3, topics=[0])
        carol = await cluster.place_client(seed=212, shard=1, topics=[0])
        await alice.send_direct_message(bob.public_key, b"gathered 0 -> 3")
        got = [await _recv(p, bob)]
        assert got == [["direct", b"gathered 0 -> 3"]]
        await carol.send_broadcast_message([0], b"gathered bcast")
        got += [await _recv(p, c) for c in (alice, bob, carol)]
        assert got[1:] == [["broadcast", b"gathered bcast"]] * 3
        await p.wait_until(lambda: cluster.group.messages_routed >= 4)
        for c in (alice, bob, carol):
            c.close()
        return [got, _group_state(cluster)]
    finally:
        await cluster.stop()


async def in_group_double_connect_kick(p):
    cluster = await p.cluster(num_shards=2).start(form_host_mesh=False)
    try:
        c1 = await cluster.place_client(seed=300, shard=0, topics=[0])
        c2 = await cluster.place_client(seed=300, shard=1, topics=[0])
        await p.wait_until(
            lambda: not cluster.brokers[0].connections.has_user(c1.public_key))
        record = [b.connections.num_users for b in cluster.brokers]
        assert record == [0, 1]
        assert cluster.brokers[1].connections.has_user(c2.public_key)
        # the surviving session still receives device-routed traffic
        await c2.send_direct_message(c2.public_key, b"still routed")
        record.append(await _recv(p, c2))
        assert record[-1] == ["direct", b"still routed"]
        slot = cluster.group.slots.slot_of(c2.public_key)
        record.append(int(cluster.group._owner[slot]))
        c1.close()
        c2.close()
        return record + [_group_state(cluster)]
    finally:
        await cluster.stop()


async def host_fallback_on_step_failure(p):
    cluster = await p.cluster(num_shards=2).start(form_host_mesh=True)
    try:
        alice = await cluster.place_client(seed=400, shard=0, topics=[1])
        bob = await cluster.place_client(seed=401, shard=1, topics=[1])
        links = _links(cluster)
        assert links == [1, 1]   # host links exist as backup

        def boom(*_a, **_k):
            raise RuntimeError("injected step failure")
        cluster.group.step_fn = boom

        await alice.send_broadcast_message([1], b"survives the failure")
        got = [await _recv(p, bob)]
        assert got == [["broadcast", b"survives the failure"]]
        await p.wait_until(lambda: cluster.group.disabled)
        # subsequent traffic flows purely on the host plane
        await alice.send_broadcast_message([1], b"host plane now")
        got.append(await _recv(p, bob))
        assert got[-1] == ["broadcast", b"host plane now"]
        alice.close()
        bob.close()
        return [got, links, _group_state(cluster)]
    finally:
        await cluster.stop()


async def staged_broadcast_still_forwards_to_out_of_group_broker(p):
    cluster = await p.cluster(num_shards=2).start(form_host_mesh=False)
    try:
        alice = await cluster.place_client(seed=500, shard=0, topics=[0])
        # an out-of-group broker on a host link to shard 0, interested in
        # topic 0 (harness-style injection)
        ext_ident = "external-pub:1/external-priv:1"
        local, remote = await p.memory.gen_testing_connection_pair()
        cluster.brokers[0].connections.add_broker(ext_ident, local)
        cluster.brokers[0].connections.subscribe_broker_to(ext_ident, [0])

        await alice.send_broadcast_message([0], b"reach outside too")
        # the device plane delivers alice's copy...
        got = [await _recv(p, alice)]
        assert got == [["broadcast", b"reach outside too"]]
        # ...AND the external broker got a host-forwarded copy
        raw = await asyncio.wait_for(remote.recv_raw(), 10)
        ext_msg = p.msg.deserialize(raw.data)
        assert isinstance(ext_msg, p.msg.Broadcast)
        got.append(bytes(ext_msg.message))
        assert got[-1] == b"reach outside too"
        raw.release()
        remote.close()
        alice.close()
        await p.wait_until(lambda: cluster.group.messages_routed >= 1)
        return [got, _group_state(cluster)]
    finally:
        await cluster.stop()


async def overflow_traffic_triggers_host_links_in_mesh_only_mode(p):
    cluster = await p.cluster(num_shards=2).start(form_host_mesh=False)
    try:
        alice = await cluster.place_client(seed=600, shard=0, topics=[1])
        bob = await cluster.place_client(seed=601, shard=1, topics=[1])
        links = [_links(cluster)]
        assert links[0] == [0, 0]

        big = b"x" * 4096  # frame_bytes=1024: ineligible for the mesh step
        await alice.send_broadcast_message([1], big)
        await p.wait_until(lambda: cluster.group.overflow_seen)
        # the kicked heartbeat forms host links promptly
        await p.wait_until(
            lambda: all(b.connections.num_brokers >= 1
                        for b in cluster.brokers))
        links.append(_links(cluster))
        # with links up, oversized traffic crosses shards on the host plane
        await alice.send_broadcast_message([1], big + b"2")
        got = [await _recv(p, bob)]
        assert got == [["broadcast", big + b"2"]]
        # and eligible traffic still rides the device mesh, exactly once
        await alice.send_broadcast_message([1], b"small still on mesh")
        got.append(await _recv(p, bob))
        assert got[-1] == ["broadcast", b"small still on mesh"]
        once = await _nothing_more(bob)
        assert once   # no duplicate via host + mesh
        alice.close()
        bob.close()
        return [got, once, links, _group_state(cluster)]
    finally:
        await cluster.stop()


async def size_bucketed_lanes_carry_large_frames_on_mesh(p):
    cluster = await p.cluster(
        num_shards=2, extra_lanes=((16384, 8, 4),),
    ).start(form_host_mesh=False)
    try:
        alice = await cluster.place_client(seed=700, shard=0, topics=[1])
        bob = await cluster.place_client(seed=701, shard=1, topics=[1])
        links = _links(cluster)
        assert links == [0, 0]   # mesh-only

        big = b"L" * 8000   # > the 1 KB base lane, fits the 16 KB lane
        await alice.send_broadcast_message([1], big)
        got = [await _recv(p, bob)]
        assert got == [["broadcast", big]]
        assert not cluster.group.overflow_seen  # the lane carried it
        # direct frames use the lane buckets the same way
        await alice.send_direct_message(bob.public_key, b"D" * 4000)
        got.append(await _recv(p, bob))
        assert got[-1] == ["direct", b"D" * 4000]
        await alice.send_broadcast_message([1], b"small lane")
        got.append(await _recv(p, bob))
        assert got[-1] == ["broadcast", b"small lane"]
        once = await _nothing_more(bob)
        assert once   # exactly-once across lanes
        alice.close()
        bob.close()
        return [got, once, links, _group_state(cluster)]
    finally:
        await cluster.stop()


async def shard_departure_survivors_keep_routing(p):
    cluster = await p.cluster(num_shards=3).start(form_host_mesh=False)
    try:
        alice = await cluster.place_client(seed=800, shard=0, topics=[0])
        bob = await cluster.place_client(seed=801, shard=1, topics=[0])
        carol = await cluster.place_client(seed=802, shard=2, topics=[0])
        await alice.send_broadcast_message([0], b"all three")
        got = [await _recv(p, c) for c in (alice, bob, carol)]
        assert got == [["broadcast", b"all three"]] * 3

        # shard 2 departs (its client goes with it)
        carol.close()
        await cluster.brokers[2].stop()
        live = [bool(x) for x in cluster.group._liveness]
        assert live == [True, True, False]
        assert not cluster.group.disabled

        await alice.send_broadcast_message([0], b"survivors")
        got += [await _recv(p, c) for c in (alice, bob)]
        assert got[3:] == [["broadcast", b"survivors"]] * 2
        await alice.send_direct_message(bob.public_key, b"still one hop")
        got.append(await _recv(p, bob))
        assert got[-1] == ["direct", b"still one hop"]
        links = _links(cluster)[:2]
        assert links == [0, 0]   # still mesh-only
        alice.close()
        bob.close()
        return [got, live, links, _group_state(cluster)]
    finally:
        await cluster.stop()


async def dead_shard_sweep_releases_slots(p):
    group = p.mg.MeshBrokerGroup(p.mesh(2), p.mg.MeshGroupConfig(
        num_user_slots=8, ring_slots=4, frame_bytes=512, extra_lanes=()))
    group._liveness[:] = True
    group.claim_user(0, b"alice-key", [0])
    group.claim_user(1, b"bob-key", [0])
    record = [len(group.slots)]
    assert record == [2]
    # shard 1 "crashes": declared dead without per-user removals
    await group.on_shard_stopped(1)
    record += [group.slots.slot_of(b"bob-key"),        # mapping swept
               group.slots.slot_of(b"alice-key"),      # survivor intact
               bool(group._liveness[1]),
               len(group._quarantine)]   # quarantined until the next step
    assert record[1] is None and record[2] is not None
    assert record[3:] == [False, 1]
    return record


async def mid_session_subscribe_over_mesh(p):
    cluster = await p.cluster(num_shards=2).start(form_host_mesh=False)
    try:
        pub = await cluster.place_client(seed=950, shard=0, topics=[0])
        sub = await cluster.place_client(seed=951, shard=1, topics=[])
        g = cluster.group

        def sub_mask_set() -> bool:
            return bool(g._masks[g.slots.slot_of(sub.public_key)].any())

        # not subscribed yet: only the publisher's topic 0 would deliver
        await pub.send_broadcast_message([1], b"before subscribe")
        pending = asyncio.create_task(sub.receive_message())
        await asyncio.sleep(0.3)
        assert not pending.done(), "unsubscribed client received a broadcast"

        await sub.subscribe([1])
        await p.wait_until(sub_mask_set)
        await pub.send_broadcast_message([1], b"after subscribe")
        got = bytes((await asyncio.wait_for(pending, 10)).message)
        assert got == b"after subscribe"

        await sub.unsubscribe([1])
        await p.wait_until(lambda: not sub_mask_set())
        await pub.send_broadcast_message([1], b"after unsubscribe")
        quiet = await _nothing_more(sub)
        assert quiet, "unsubscribed client still receives"
        pub.close()
        sub.close()
        return [got, quiet, _group_state(cluster)]
    finally:
        await cluster.stop()


async def mesh_chaos_shard_death_under_load(p):
    cluster = await p.cluster(num_shards=4, ring_slots=32).start(
        form_host_mesh=False)
    try:
        pub = await cluster.place_client(seed=980, shard=0, topics=[0])
        doomed = await cluster.place_client(seed=981, shard=2, topics=[0])
        survivors = [pub,
                     await cluster.place_client(seed=982, shard=1,
                                                topics=[0]),
                     await cluster.place_client(seed=983, shard=3,
                                                topics=[0])]
        received = [[] for _ in survivors]

        async def drain(idx):
            while True:
                for m in await survivors[idx].receive_messages():
                    received[idx].append(bytes(m.message))

        drains = [asyncio.create_task(drain(i))
                  for i in range(len(survivors))]
        stop_stream = asyncio.Event()
        sent = []

        async def stream():
            seq = 0
            while not stop_stream.is_set():
                payload = b"chaos-%06d" % seq
                await pub.send_broadcast_message([0], payload)
                sent.append(payload)
                seq += 1
                await asyncio.sleep(0.01)

        try:
            streamer = asyncio.create_task(stream())
            await asyncio.sleep(0.3)             # traffic flowing
            doomed.close()                       # client gone...
            await cluster.brokers[2].stop()      # ...and its shard dies
            await asyncio.sleep(0.5)             # group sweeps and settles
            # every message sent AFTER the death must reach all survivors
            post_death_from = len(sent)
            await asyncio.sleep(1.0)
            stop_stream.set()
            await streamer
            post = sent[post_death_from:]
            assert post, "stream never progressed after the shard death"

            def converged():
                for t in drains:  # surface a dead drain's real exception
                    if t.done():
                        t.result()
                return all(set(post) <= set(r) for r in received)

            await p.wait_until(converged, timeout=20)
        finally:
            stop_stream.set()
            for t in drains:
                t.cancel()
        assert not cluster.group.disabled
        gone = cluster.group.slots.slot_of(doomed.public_key) is None
        assert gone
        for c in survivors:
            c.close()
        return [bool(post), gone, cluster.group.disabled]
    finally:
        await cluster.stop()


async def mesh_tick_is_one_collective(p):
    cluster = await p.cluster(num_shards=4, **p.fused).start(
        form_host_mesh=False)
    try:
        a = await cluster.place_client(seed=900, shard=0, topics=[0])
        b = await cluster.place_client(seed=901, shard=2, topics=[0])
        await a.send_broadcast_message([0], b"tick")
        got = await _recv(p, b)
        assert got == ["broadcast", b"tick"]
        collectives = p.collectives(cluster.group)
        assert collectives == 1, collectives
        a.close()
        b.close()
        return [got, collectives]
    finally:
        await cluster.stop()


SCENARIOS = [cross_shard_broadcast_over_mesh_only,
             cross_shard_direct_over_mesh_only,
             cross_shard_traffic_with_gathered_bytes,
             in_group_double_connect_kick,
             host_fallback_on_step_failure,
             staged_broadcast_still_forwards_to_out_of_group_broker,
             overflow_traffic_triggers_host_links_in_mesh_only_mode,
             size_bucketed_lanes_carry_large_frames_on_mesh,
             shard_departure_survivors_keep_routing,
             dead_shard_sweep_releases_slots,
             mid_session_subscribe_over_mesh,
             mesh_chaos_shard_death_under_load,
             mesh_tick_is_one_collective]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
async def test_mesh_broker_group_matches_the_jax_group(scenario):
    records = {}
    for name in PACKAGES:
        async with asyncio.timeout(SCENARIO_TIMEOUT_S):
            records[name] = await scenario(_pkg(name))
    assert records["port"] == records["jax"]


# ---------------------------------------------------------------------------
# MeshDiscovery: the cases of tests/test_mesh_discovery.py
# ---------------------------------------------------------------------------


def _db():
    return os.path.join(tempfile.mkdtemp(prefix="pushcdn-mesh-"), "d.sqlite")


async def membership_from_topology(p):
    mesh = p.mesh()
    me = p.mesh_mod.broker_identifier_for_device(mesh, 0)
    disc = await p.mesh_mod.MeshDiscovery.new(_db(), identity=me, mesh=mesh)
    others = await disc.get_other_brokers()
    await disc.close()
    assert me not in others
    return [str(me), [str(o) for o in others]]


async def least_connections_uses_host_load_and_liveness(p):
    mesh = p.mesh()
    ident = p.mesh_mod.broker_identifier_for_device
    disc = await p.mesh_mod.MeshDiscovery.new(
        _db(), identity=ident(mesh, 0), mesh=mesh)
    # shard 0 reports load 5; everyone else 0: pick shard 1 (the lowest
    # index among the zero-load shards)
    await disc.perform_heartbeat(5, 60.0)
    picks = [await disc.get_with_least_connections()]
    assert picks[0] == ident(mesh, 1)
    # dead shards leave membership and placement
    for i in range(1, len(disc.live)):
        disc.mark_dead(i)
    picks.append(await disc.get_with_least_connections())
    assert picks[1] == ident(mesh, 0)
    others = await disc.get_other_brokers()
    assert others == []
    await disc.close()
    return [str(x) for x in picks] + [others]


async def permits_and_whitelist_delegate(p):
    mesh = p.mesh()
    b0 = p.mesh_mod.broker_identifier_for_device(mesh, 0)
    disc = await p.mesh_mod.MeshDiscovery.new(_db(), identity=b0, mesh=mesh)
    permit = await disc.issue_permit(b0, 30.0, b"user-key")
    record = [permit > 1, await disc.validate_permit(b0, permit),
              await disc.validate_permit(b0, permit)]   # single-use
    await disc.set_whitelist([b"a"])
    record += [await disc.check_whitelist(b"a"),
               await disc.check_whitelist(b"b")]
    await disc.close()
    assert record == [True, b"user-key", None, True, False]
    return record


async def identifier_order_matches_mesh_order(p):
    """CRDT tie-breaks must agree between host (string order) and device
    (index order)."""
    mesh = p.mesh()
    idents = [str(p.mesh_mod.broker_identifier_for_device(mesh, i))
              for i in range(8)]
    assert idents == sorted(idents)
    return idents


DISCOVERY_CASES = [membership_from_topology,
                   least_connections_uses_host_load_and_liveness,
                   permits_and_whitelist_delegate,
                   identifier_order_matches_mesh_order]


@pytest.mark.parametrize("case", DISCOVERY_CASES, ids=lambda f: f.__name__)
async def test_mesh_discovery_matches_the_jax_discovery(case):
    assert await case(_pkg("port")) == await case(_pkg("jax"))


def test_identifiers_on_folded_and_distinct_devices():
    """Shards folded onto one device are named by mesh position (the JAX
    names of devices 0..n-1), shards on devices of their own by the
    device's index, as the JAX package names them; either way the order
    is the mesh order."""
    from pushcdn_tpu_torch.parallel.mesh import (
        BrokerMesh,
        broker_identifier_for_device,
        make_broker_mesh,
    )

    def names(mesh):
        return [str(broker_identifier_for_device(mesh, i))
                for i in range(mesh.size)]

    folded = names(make_broker_mesh(4, devices=["cpu"] * 4))
    assert folded == [f"mesh{i:04d}:pub/device:{i}" for i in range(4)]
    assert folded == sorted(folded) and len(set(folded)) == 4
    assert names(BrokerMesh((torch.device("cuda", 0),) * 4)) == folded
    distinct = names(BrokerMesh((torch.device("cuda", 1),
                                 torch.device("cuda", 0))))
    assert distinct == ["mesh0000:pub/device:1", "mesh0001:pub/device:0"]
    assert distinct == sorted(distinct)


# ---------------------------------------------------------------------------
# on the card a group's brokers fail fast
# ---------------------------------------------------------------------------


def _boom(*_a, **_k):
    raise RuntimeError("injected kernel failure")


async def _new_members(p, n: int):
    """A port group on the CPU and ``n`` member brokers, not started."""
    cluster = p.cluster(num_shards=n)
    mg = p.mg
    group = mg.MeshBrokerGroup(p.mesh(n), mg.MeshGroupConfig(
        num_user_slots=16, ring_slots=8, frame_bytes=512, extra_lanes=()))
    from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
    brokers = []
    for i in range(n):
        ident = cluster._ident(i)
        b = await Broker.new(BrokerConfig(
            run_def=cluster.run_def, keypair=cluster.keypair,
            discovery_endpoint=cluster.db,
            public_advertise_endpoint=ident.public_advertise_endpoint,
            public_bind_endpoint=ident.public_advertise_endpoint,
            private_advertise_endpoint=ident.private_advertise_endpoint,
            private_bind_endpoint=ident.private_advertise_endpoint,
            heartbeat_interval_s=3600, sync_interval_s=3600,
            whitelist_interval_s=3600, form_mesh=False, device="cpu"))
        group.attach(b, i)
        brokers.append(b)
    return group, brokers


@pytest.mark.parametrize("on_card", [True, False])
async def test_group_warmup_failure_raises_in_every_member_on_the_card(
        on_card, monkeypatch):
    """A kernel that does not build or launch on the card stops every
    member broker's start; on the CPU the group disables itself and its
    brokers start as host brokers, as the JAX package's do."""
    p = _pkg("port")
    if on_card:
        monkeypatch.setattr(p.mg.MeshBrokerGroup, "fails_open", False)
    group, brokers = await _new_members(p, 2)
    group.step_fn = _boom
    try:
        for b in brokers:
            if on_card:
                with pytest.raises(RuntimeError, match="injected"):
                    await b.start()
                assert not b._tasks and b.device_plane.pump_task is None
            else:
                await b.start()
                assert group.disabled and group.pump_task is not None
                assert b.device_plane.pump_task is None
    finally:
        for b in brokers:
            await b.stop()
    assert group.pump_task is None


async def test_group_step_failure_on_the_card_reroutes_then_ends_every_member(
        monkeypatch):
    """On the card a group step that raises still re-routes its frames
    over the host links, then ends the pump; every member broker
    supervises a watch on it, so each one's ``run_until_failure`` goes
    down instead of serving on as a host broker."""
    p = _pkg("port")
    monkeypatch.setattr(p.mg.MeshBrokerGroup, "fails_open", False)
    cluster = await p.cluster(num_shards=2).start(form_host_mesh=True)
    try:
        watches = [b.device_plane.pump_task for b in cluster.brokers]
        assert all(w is not None and w in b._tasks
                   for w, b in zip(watches, cluster.brokers))
        alice = await cluster.place_client(seed=410, shard=0, topics=[1])
        bob = await cluster.place_client(seed=411, shard=1, topics=[1])
        cluster.group.step_fn = _boom
        await alice.send_broadcast_message([1], b"in the failed step")
        assert await _recv(p, bob) == ["broadcast", b"in the failed step"]
        assert await _recv(p, alice) == ["broadcast", b"in the failed step"]
        assert cluster.group.disabled
        for b, w in zip(cluster.brokers, watches):
            # what run_until_failure waits on
            done, _ = await asyncio.wait(b._tasks, timeout=5,
                                         return_when=asyncio.FIRST_COMPLETED)
            assert done == {w}
            with pytest.raises(RuntimeError, match="injected"):
                w.result()
        assert cluster.group.messages_routed == 0
        alice.close()
        bob.close()
    finally:
        await cluster.stop()


async def test_broker_group_starts_shards_dead_until_attached():
    """A shard with no broker attached is dead in the group's liveness
    (as in the JAX group), so it is never a delivery target; the
    socket-free MeshGroup keeps every shard live."""
    p = _pkg("port")
    group = p.mg.MeshBrokerGroup(p.mesh(3), p.mg.MeshGroupConfig(
        num_user_slots=8, ring_slots=4, frame_bytes=512, extra_lanes=()))
    assert not group._liveness.any()
    assert p.mg.MeshGroup(p.mesh(3), group.config)._liveness.all()
    jax_group = _pkg("jax").mg.MeshBrokerGroup(_pkg("jax").mesh(3))
    np.testing.assert_array_equal(group._liveness, jax_group._liveness)
