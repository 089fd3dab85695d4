"""Marshal + N brokers + shared discovery, all in one process.

Parity with the reference's ``tests`` crate fixture
(tests/src/tests/mod.rs:62-143): the Memory protocol's global listener
registry stands in for the network and a shared SQLite file stands in for
KeyDB, so multi-node behavior runs on a laptop with no cluster
(SURVEY.md §4 tier 3). Load steering mirrors double_connect.rs:100-121.

A copy of ``pushcdn_tpu.testing.cluster``. ``Cluster(device=...)`` is the
brokers' ``BrokerConfig.device``: None puts a device plane on CUDA, and
the tests pass ``"cpu"``.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import tempfile
from typing import TYPE_CHECKING, Optional, Type

from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
from pushcdn_tpu_torch.broker.tasks.heartbeat import heartbeat_once
from pushcdn_tpu_torch.client import Client, ClientConfig
from pushcdn_tpu_torch.marshal import Marshal, MarshalConfig
from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME, SignatureScheme
from pushcdn_tpu_torch.proto.def_ import testing_run_def as make_testing_run_def
from pushcdn_tpu_torch.proto.discovery.base import BrokerIdentifier
from pushcdn_tpu_torch.proto.discovery.embedded import Embedded
from pushcdn_tpu_torch.proto.topic import TopicSpace
from pushcdn_tpu_torch.proto.transport.memory import Memory

if TYPE_CHECKING:
    from pushcdn_tpu_torch._device import DeviceLike

_UNIQUE = itertools.count()


async def wait_until(predicate, timeout: float = 5.0, interval: float = 0.02):
    """Poll until ``predicate()`` is truthy (handshake completion on the
    broker side lags the client's return by a few event-loop ticks)."""
    deadline = asyncio.get_running_loop().time() + timeout
    while True:
        if predicate():
            return
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError(f"condition never became true: {predicate}")
        await asyncio.sleep(interval)


async def wait_mesh_interest(cluster: "Cluster", topic: int, links: int,
                             timeout: float = 60.0):
    """Wait until every broker holds ``links`` mesh links AND sees all of
    them as interested in ``topic`` (full interest propagation). Messages
    sent before a link exists are simply not forwarded (sender.rs
    failure-is-removal semantics), and BLS broker↔broker auth takes
    hundreds of ms — so tests and benches must wait explicitly, never
    sleep."""
    await wait_until(
        lambda: all(b.connections.num_brokers == links
                    for b in cluster.brokers), timeout)
    await wait_until(
        lambda: all(
            len(b.connections.get_interested_by_topic([topic], False)[1])
            == links
            for b in cluster.brokers), timeout)


class Cluster:
    """Marshal + N brokers + shared discovery, all in-process."""

    def __init__(self, num_brokers: int = 1, device_plane=None,
                 scheme: Type[SignatureScheme] = DEFAULT_SCHEME,
                 topics: Optional[TopicSpace] = None,
                 device: "DeviceLike" = None):
        self.uid = next(_UNIQUE)
        self.num_brokers = num_brokers
        self.device_plane = device_plane
        self.device = device
        self.scheme = scheme
        self.db = os.path.join(tempfile.mkdtemp(prefix="pushcdn-it-"),
                               "discovery.sqlite")
        self.run_def = make_testing_run_def(scheme=scheme, topics=topics)
        self.broker_keypair = scheme.generate_keypair(seed=10_000 + self.uid)
        self.brokers: list[Broker] = []
        self.marshal: Marshal = None

    def broker_endpoints(self, i: int):
        return (f"it{self.uid}-b{i}-pub", f"it{self.uid}-b{i}-priv")

    @property
    def marshal_endpoint(self) -> str:
        return f"it{self.uid}-marshal"

    async def start(self):
        for i in range(self.num_brokers):
            pub, priv = self.broker_endpoints(i)
            broker = await Broker.new(BrokerConfig(
                run_def=self.run_def,
                keypair=self.broker_keypair,  # one deployment key (same-key check)
                discovery_endpoint=self.db,
                public_advertise_endpoint=pub, public_bind_endpoint=pub,
                private_advertise_endpoint=priv, private_bind_endpoint=priv,
                # deterministic: we drive heartbeats/syncs manually
                heartbeat_interval_s=3600, sync_interval_s=3600,
                whitelist_interval_s=3600,
                device_plane=self.device_plane,
                device=self.device,
            ))
            await broker.start()
            self.brokers.append(broker)
        # two heartbeat rounds: all register, then dial each other
        for b in self.brokers:
            await heartbeat_once(b)
        for b in self.brokers:
            await heartbeat_once(b)
        await asyncio.sleep(0.1)  # let mesh links finish auth + full sync

        self.marshal = await Marshal.new(MarshalConfig(
            run_def=self.run_def,
            discovery_endpoint=self.db,
            bind_endpoint=self.marshal_endpoint,
        ))
        await self.marshal.start()
        return self

    def client(self, seed: int, topics=(), protocol: Type = Memory) -> Client:
        """``protocol`` lets a caller shape this client's link (e.g.
        ``shaped_memory(LinkShape(...))`` for geo-shaped consensus nodes);
        the default is the plain in-process transport."""
        return Client(ClientConfig(
            marshal_endpoint=self.marshal_endpoint,
            keypair=self.scheme.generate_keypair(seed=seed),
            protocol=protocol,
            scheme=self.scheme,
            subscribed_topics=set(topics),
        ))

    async def restart_broker(self, broker_index: int) -> "Broker":
        """Start a replacement broker under broker_index's identity
        (same endpoints + deployment keypair, same config shape as
        ``start`` — single source of truth for restart tests). The old
        instance must already be stopped."""
        pub, priv = self.broker_endpoints(broker_index)
        broker = await Broker.new(BrokerConfig(
            run_def=self.run_def,
            keypair=self.broker_keypair,
            discovery_endpoint=self.db,
            public_advertise_endpoint=pub, public_bind_endpoint=pub,
            private_advertise_endpoint=priv, private_bind_endpoint=priv,
            heartbeat_interval_s=3600, sync_interval_s=3600,
            whitelist_interval_s=3600,
            device_plane=self.device_plane,
            device=self.device,
        ))
        await broker.start()
        self.brokers[broker_index] = broker
        return broker

    async def restart_marshal(self) -> "Marshal":
        """Start a replacement marshal on the same endpoint (chaos tests:
        marshal loss mid-view). The old instance must already be
        stopped."""
        self.marshal = await Marshal.new(MarshalConfig(
            run_def=self.run_def,
            discovery_endpoint=self.db,
            bind_endpoint=self.marshal_endpoint,
        ))
        await self.marshal.start()
        return self.marshal

    async def steer_load(self, broker_index: int, load: int):
        """Fake a broker's advertised load to steer marshal placement
        (parity double_connect.rs:100-121)."""
        pub, priv = self.broker_endpoints(broker_index)
        handle = await Embedded.new(self.db,
                                    identity=BrokerIdentifier(pub, priv))
        await handle.perform_heartbeat(load, 60.0)
        await handle.close()

    async def place_on(self, broker_index: int):
        """Steer the next client onto one broker: everyone else looks busy."""
        for i in range(self.num_brokers):
            await self.steer_load(i, 0 if i == broker_index else 10_000)

    async def stop(self):
        if self.marshal:
            await self.marshal.stop()
        for b in self.brokers:
            await b.stop()
