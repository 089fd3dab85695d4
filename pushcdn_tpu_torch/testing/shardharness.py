"""In-process sharded-broker harness (the worker-shard equivalence suite).

Builds N real ``Broker`` instances on ONE event loop wired as worker
shards of a single broker identity: real shared-memory handoff rings +
notify sockets (``broker.shardring``), a ``LocalBus`` control plane
(synchronous total-order delta relay — the in-process stand-in for the
parent hub), users injected per shard exactly like
``broker.test_harness.TestDefinition`` injects them into one broker.

The suite's contract: a 1-shard run and an N-shard run fed the same
seeded frame mix produce identical per-peer delivery SEQUENCES and leave
the byte pools balanced — the cross-shard handoff must be semantically
invisible.

The port's copy of ``pushcdn_tpu.testing.shardharness``; like every
worker of a ``--shards`` broker, it never imports torch.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import tempfile
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
from pushcdn_tpu_torch.broker.connections import SubscriptionStatus
from pushcdn_tpu_torch.broker.sharding import (
    attach_inprocess_shards,
    detach_inprocess_shards,
)
from pushcdn_tpu_torch.broker.tasks.handlers import (
    broker_receive_loop,
    user_receive_loop,
)
from pushcdn_tpu_torch.broker.test_harness import TestBroker, TestUser
from pushcdn_tpu_torch.broker.versioned_map import VersionedMap
from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
from pushcdn_tpu_torch.proto.def_ import testing_run_def
from pushcdn_tpu_torch.proto.transport.memory import gen_testing_connection_pair
from pushcdn_tpu_torch.proto.util import AbortOnDropHandle

_UNIQUE = itertools.count()


@dataclass
class ShardTestRun:
    __test__ = False
    brokers: List[Broker]
    runtimes: list
    # user index -> (TestUser, owning shard); indices follow the flattened
    # construction order so tests can mirror a 1-shard TestDefinition
    connected_users: List[Tuple[TestUser, int]] = field(default_factory=list)
    connected_brokers: List[TestBroker] = field(default_factory=list)
    tcp_listeners: list = field(default_factory=list)  # set by tcp_users

    def user(self, i: int) -> TestUser:
        return self.connected_users[i][0]

    def user_shard(self, i: int) -> int:
        return self.connected_users[i][1]

    def peer(self, j: int) -> TestBroker:
        return self.connected_brokers[j]

    async def settle(self, ticks: int = 20) -> None:
        """Let ring drains / relayed deltas / writer flushes run."""
        for _ in range(ticks):
            await asyncio.sleep(0)
        await asyncio.sleep(0.02)

    async def shutdown(self) -> None:
        for u, _shard in self.connected_users:
            u.remote.close()
        for b in self.connected_brokers:
            b.remote.close()
        for listener in self.tcp_listeners:
            await listener.close()
        for broker in self.brokers:
            await broker.stop()
        detach_inprocess_shards(self.runtimes)


async def run_sharded(
        user_shards: Sequence[Tuple[int, Sequence[int]]],
        num_shards: int = 2,
        connected_brokers: Sequence[Tuple[Sequence[int],
                                          Sequence[bytes]]] = (),
        ring_bytes: int = 256 * 1024,
        tcp_users: bool = False,
        topics=None,
        pool_bytes: int | None = None) -> ShardTestRun:
    """Build the sharded twin of a ``TestDefinition`` run.

    ``user_shards[i] = (shard, topics)`` places injected user i (key
    ``user-<i>``, same naming as the 1-shard harness) on that worker;
    mesh peer brokers always attach to shard 0 (the link owner).
    ``tcp_users`` routes the user links over real loopback TCP (one
    listener per shard) — the io-impl (asyncio vs io_uring) A/B seam,
    mirroring ``TestDefinition.tcp_users``."""
    uid = next(_UNIQUE)
    brokers: List[Broker] = []
    pool_kw = ({"global_memory_pool_size": pool_bytes}
               if pool_bytes is not None else {})
    for s in range(num_shards):
        db = os.path.join(tempfile.mkdtemp(prefix="pushcdn-shardtest-"),
                          "discovery.sqlite")
        config = BrokerConfig(
            run_def=testing_run_def(topics=topics),
            keypair=DEFAULT_SCHEME.generate_keypair(seed=uid),
            discovery_endpoint=db,
            # ONE identity across all shards; distinct bind endpoints so
            # the Memory registry accepts every worker's listeners
            public_advertise_endpoint=f"shardtest-pub-{uid}",
            public_bind_endpoint=f"shardtest-pub-{uid}-s{s}",
            private_advertise_endpoint=f"shardtest-priv-{uid}",
            private_bind_endpoint=f"shardtest-priv-{uid}-s{s}",
            heartbeat_interval_s=3600, sync_interval_s=3600,
            whitelist_interval_s=3600,
            shard_index=s, num_shards=num_shards,
            **pool_kw,
        )
        brokers.append(await Broker.new(config))
    runtimes = attach_inprocess_shards(brokers, ring_bytes=ring_bytes)
    for rt in runtimes:
        rt.attach()
    for broker in brokers:
        await broker.start()
    run = ShardTestRun(brokers=brokers, runtimes=runtimes)

    listeners = {}
    if tcp_users:
        from pushcdn_tpu_torch.proto.transport.tcp import Tcp
    for i, (shard, topics) in enumerate(user_shards):
        key = f"user-{i}".encode()
        broker = brokers[shard]
        if tcp_users:
            listener = listeners.get(shard)
            if listener is None:
                listener = await Tcp.bind("127.0.0.1:0")
                listeners[shard] = listener
                run.tcp_listeners.append(listener)
            accept_t = asyncio.create_task(listener.accept())
            remote = await Tcp.connect(f"127.0.0.1:{listener.bound_port}",
                                       limiter=broker.limiter)
            local = await (await accept_t).finalize(broker.limiter)
        else:
            local, remote = await gen_testing_connection_pair(broker.limiter)
        task = asyncio.create_task(user_receive_loop(broker, key, local))
        broker.connections.add_user(key, local, list(topics),
                                    AbortOnDropHandle(task))
        run.connected_users.append((TestUser(key, remote), shard))

    shard0 = brokers[0]
    for j, (topics, owned_users) in enumerate(connected_brokers):
        ident = f"testbrokerpub-{j}:0/testbrokerpriv-{j}:0"
        local, remote = await gen_testing_connection_pair(shard0.limiter)
        task = asyncio.create_task(
            broker_receive_loop(shard0, ident, local))
        shard0.connections.add_broker(ident, local,
                                      AbortOnDropHandle(task))
        if topics:
            m = VersionedMap(local_identity=ident)
            for t in topics:
                m.insert(int(t), int(SubscriptionStatus.SUBSCRIBED))
            shard0.connections.apply_topic_sync(
                ident, VersionedMap.serialize_entries(m.full()))
        if owned_users:
            m = VersionedMap(local_identity=ident)
            for u in owned_users:
                m.insert(bytes(u), ident)
            shard0.connections.apply_user_sync(
                VersionedMap.serialize_entries(m.full()))
        run.connected_brokers.append(TestBroker(ident, remote))
    await run.settle()
    return run
