"""Deterministic single-broker test harness.

Capability parity with cdn-broker/src/tests/mod.rs:45-412 (NOT test-gated —
the reference exposes it to benches too; our bench.py reuses it the same
way): build one *real* ``Broker`` over the **Memory** transport with an
**Embedded** (temp-file SQLite) discovery, then *inject* fake users and
fake peer brokers directly into ``Connections`` — spawning real receive
loops but skipping auth (inject_users mod.rs:258-300, inject_brokers
mod.rs:308-389). Peer broker state (their topics, the users they own) is
seeded with hand-built sync payloads exactly like the reference seeds rkyv
messages (mod.rs:356-382).

The injected entities' *remote* connection ends act as the test's hands:
``send_message_as`` publishes from an entity; ``assert_received`` /
``assert_silence`` check exact delivery sets and the absence of duplicates
with short timeouts (mod.rs:45-107).

A copy of ``pushcdn_tpu.broker.test_harness``. ``TestDefinition(
tcp_users=True)`` injects the users over loopback TCP instead of Memory
pairs. A broker built with a device plane (``BrokerConfig(device_plane=...,
device=...)``) is wrapped as ``TestRun(broker=broker)`` and injected into
the same way.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
from pushcdn_tpu_torch.broker.connections import SubscriptionStatus
from pushcdn_tpu_torch.broker.tasks.handlers import broker_receive_loop, user_receive_loop
from pushcdn_tpu_torch.broker.versioned_map import VersionedMap
from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
from pushcdn_tpu_torch.proto.def_ import testing_run_def
from pushcdn_tpu_torch.proto.message import Message, deserialize, serialize
from pushcdn_tpu_torch.proto.transport.base import Connection
from pushcdn_tpu_torch.proto.transport.memory import gen_testing_connection_pair
from pushcdn_tpu_torch.proto.util import AbortOnDropHandle

_UNIQUE = itertools.count()


@dataclass
class TestUser:
    __test__ = False  # not a pytest class despite the reference-parity name
    public_key: bytes
    remote: Connection  # the end the test drives


@dataclass
class TestBroker:
    __test__ = False
    identifier: str
    remote: Connection


@dataclass
class TestDefinition:
    __test__ = False
    """Declarative scenario (parity ``TestDefinition``, mod.rs):
    ``connected_users[i]`` = topic list of injected user i;
    ``connected_brokers[j]`` = (topics, owned-user-keys) of injected peer j.
    """

    connected_users: Sequence[Sequence[int]] = ()
    connected_brokers: Sequence[Tuple[Sequence[int], Sequence[bytes]]] = ()
    # e.g. "127.0.0.1:0" to exercise the observability endpoint
    # (/healthz, /readyz, /debug/topology) against an injected broker
    metrics_bind_endpoint: Optional[str] = None
    # route the injected user links over real loopback TCP instead of the
    # Memory pair: the whole forwarding path then crosses real sockets on
    # both ends while the broker internals stay identical
    tcp_users: bool = False
    # widen the topic space (wildcard/durable scenarios) or shrink the
    # byte pool (pool-pressure scenarios); None = harness defaults
    topics: Optional[object] = None
    pool_bytes: Optional[int] = None

    async def run(self) -> "TestRun":
        uid = next(_UNIQUE)
        db = os.path.join(tempfile.mkdtemp(prefix="pushcdn-test-"),
                          "discovery.sqlite")
        pool_kw = ({"global_memory_pool_size": self.pool_bytes}
                   if self.pool_bytes is not None else {})
        config = BrokerConfig(
            run_def=testing_run_def(topics=self.topics),
            keypair=DEFAULT_SCHEME.generate_keypair(seed=uid),
            discovery_endpoint=db,
            public_advertise_endpoint=f"test-pub-{uid}",
            public_bind_endpoint=f"test-pub-{uid}",
            private_advertise_endpoint=f"test-priv-{uid}",
            private_bind_endpoint=f"test-priv-{uid}",
            metrics_bind_endpoint=self.metrics_bind_endpoint,
            # keep periodic tasks out of the way for determinism
            heartbeat_interval_s=3600, sync_interval_s=3600,
            whitelist_interval_s=3600,
            **pool_kw,
        )
        broker = await Broker.new(config)
        await broker.start()
        run = TestRun(broker=broker)
        if self.tcp_users:
            await run.inject_users_tcp(self.connected_users)
        else:
            await run.inject_users(self.connected_users)
        await run.inject_brokers(self.connected_brokers)
        return run


@dataclass
class TestRun:
    __test__ = False
    broker: Broker
    connected_users: List[TestUser] = field(default_factory=list)
    connected_brokers: List[TestBroker] = field(default_factory=list)
    tcp_listener: Optional[object] = None  # set by inject_users_tcp

    async def inject_users(self, user_topics) -> None:
        """Parity inject_users (mod.rs:258-300): real receive loops, no auth."""
        for i, topics in enumerate(user_topics):
            key = f"user-{i}".encode()
            local, remote = await gen_testing_connection_pair(self.broker.limiter)
            task = asyncio.create_task(
                user_receive_loop(self.broker, key, local))
            self.broker.connections.add_user(key, local, list(topics),
                                             AbortOnDropHandle(task))
            self.connected_users.append(TestUser(key, remote))

    async def inject_users_tcp(self, user_topics) -> None:
        """``inject_users`` over real loopback TCP: the broker side accepts
        and finalizes with the broker limiter (what the public accept loop
        does after auth), then spawns the same ``user_receive_loop``."""
        from pushcdn_tpu_torch.proto.transport.tcp import Tcp
        listener = await Tcp.bind("127.0.0.1:0")
        self.tcp_listener = listener
        port = listener.bound_port
        for i, topics in enumerate(user_topics):
            key = f"user-{i}".encode()
            accept_t = asyncio.create_task(listener.accept())
            remote = await Tcp.connect(f"127.0.0.1:{port}",
                                       limiter=self.broker.limiter)
            local = await (await accept_t).finalize(self.broker.limiter)
            task = asyncio.create_task(
                user_receive_loop(self.broker, key, local))
            self.broker.connections.add_user(key, local, list(topics),
                                             AbortOnDropHandle(task))
            self.connected_users.append(TestUser(key, remote))

    async def inject_brokers(self, broker_defs) -> None:
        """Parity inject_brokers (mod.rs:308-389): register a fake peer and
        seed its state with hand-built sync payloads."""
        for j, (topics, owned_users) in enumerate(broker_defs):
            ident = f"testbrokerpub-{j}:0/testbrokerpriv-{j}:0"
            local, remote = await gen_testing_connection_pair(self.broker.limiter)
            task = asyncio.create_task(
                broker_receive_loop(self.broker, ident, local))
            self.broker.connections.add_broker(ident, local,
                                               AbortOnDropHandle(task))
            # seed topic interest (hand-built TopicSync, mod.rs:356-382)
            if topics:
                m = VersionedMap(local_identity=ident)
                for t in topics:
                    m.insert(int(t), int(SubscriptionStatus.SUBSCRIBED))
                self.broker.connections.apply_topic_sync(
                    ident, VersionedMap.serialize_entries(m.full()))
            # seed direct-map ownership (hand-built UserSync)
            if owned_users:
                m = VersionedMap(local_identity=ident)
                for u in owned_users:
                    m.insert(bytes(u), ident)
                self.broker.connections.apply_user_sync(
                    VersionedMap.serialize_entries(m.full()))
            self.connected_brokers.append(TestBroker(ident, remote))

    # -- assertion helpers (parity send_message_as!/assert_received!) -------

    async def send_message_as(self, entity, message: Message) -> None:
        await entity.remote.send_message(message, flush=True)

    async def assert_received(self, entity, expected: Message,
                              timeout: float = 0.25) -> None:
        """The entity receives exactly ``expected`` (payload-compared)."""
        raw = await asyncio.wait_for(entity.remote.recv_raw(), timeout)
        got = deserialize(raw.data)
        assert serialize(got) == serialize(expected), (
            f"{_name(entity)} got {got!r}, want {expected!r}")
        raw.release()

    async def assert_silence(self, entity, timeout: float = 0.1) -> None:
        """The entity receives NOTHING within ``timeout`` (duplicate /
        mis-delivery detection, mod.rs assert_received! absence mode)."""
        try:
            raw = await asyncio.wait_for(entity.remote.recv_raw(), timeout)
        except (asyncio.TimeoutError, Exception) as exc:
            if isinstance(exc, asyncio.TimeoutError):
                return
            return  # connection closed also counts as silence
        got = deserialize(raw.data)
        raise AssertionError(f"{_name(entity)} unexpectedly received {got!r}")

    async def shutdown(self) -> None:
        for u in self.connected_users:
            u.remote.close()
        for b in self.connected_brokers:
            b.remote.close()
        if self.tcp_listener is not None:
            await self.tcp_listener.close()
        await self.broker.stop()

    # index helpers (parity at_index!)
    def user(self, i: int) -> TestUser:
        return self.connected_users[i]

    def peer(self, j: int) -> TestBroker:
        return self.connected_brokers[j]


def _name(entity) -> str:
    if isinstance(entity, TestUser):
        return f"user {entity.public_key!r}"
    return f"broker {entity.identifier}"
