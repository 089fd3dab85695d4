"""MeshCluster — N broker shards of one ``MeshBrokerGroup`` and a
marshal, users over the Memory transport: the harness for the mesh-group
tests and the smoke's mesh-broker phase.

A copy of ``pushcdn_tpu.testing.mesh_cluster``. ``devices`` are the
group's shards (``make_broker_mesh(num_shards, devices=devices)``);
``device`` folds every shard onto that one device when ``devices`` is
not given (``device="cpu"`` in the tests), and with neither the mesh is
one shard per visible CUDA device. ``fused_collective`` is the group's
exchange schedule (None: picked from the mesh's devices).

Brokers are registered in discovery WITHOUT dialing (external handles),
so mesh-only scenarios prove traffic crosses shards with zero host
broker links; ``start(form_host_mesh=True)`` dials the host links as the
backup plane instead.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import tempfile
from typing import TYPE_CHECKING, Optional

from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
from pushcdn_tpu_torch.broker.mesh_group import MeshBrokerGroup, MeshGroupConfig
from pushcdn_tpu_torch.broker.tasks.heartbeat import heartbeat_once
from pushcdn_tpu_torch.client import Client, ClientConfig
from pushcdn_tpu_torch.marshal import Marshal, MarshalConfig
from pushcdn_tpu_torch.parallel.mesh import make_broker_mesh
from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
from pushcdn_tpu_torch.proto.def_ import testing_run_def
from pushcdn_tpu_torch.proto.discovery.base import BrokerIdentifier
from pushcdn_tpu_torch.proto.discovery.embedded import Embedded
from pushcdn_tpu_torch.proto.transport.memory import Memory
from pushcdn_tpu_torch.testing.cluster import wait_until

if TYPE_CHECKING:
    from pushcdn_tpu_torch._device import DeviceLike

_UID = itertools.count()


class MeshCluster:
    def __init__(self, num_shards: int = 4, extra_lanes: tuple = (),
                 ring_slots: int = 32, frame_bytes: int = 1024,
                 num_user_slots: int = 64, batch_window_s: float = 0.002,
                 devices=None, prefix: str = "mg",
                 gather_frame_bytes: bool = False,
                 device: "DeviceLike" = None,
                 fused_collective: Optional[bool] = None):
        self.uid = next(_UID)
        self.num_shards = num_shards
        self.extra_lanes = extra_lanes
        self.ring_slots = ring_slots
        self.frame_bytes = frame_bytes
        self.num_user_slots = num_user_slots
        self.batch_window_s = batch_window_s
        self.gather_frame_bytes = gather_frame_bytes
        self.fused_collective = fused_collective
        if devices is None and device is not None:
            devices = [device] * num_shards
        self.devices = devices
        self.device = device
        self.prefix = f"{prefix}{self.uid}"
        self.db = os.path.join(tempfile.mkdtemp(prefix="pushcdn-mesh-"),
                               "d.sqlite")
        self.run_def = testing_run_def()
        self.keypair = DEFAULT_SCHEME.generate_keypair(seed=40_000 + self.uid)
        self.brokers: list[Broker] = []
        self.group: MeshBrokerGroup = None
        self.marshal: Marshal = None

    def _ident(self, i: int) -> BrokerIdentifier:
        return BrokerIdentifier(f"{self.prefix}-b{i}-pub",
                                f"{self.prefix}-b{i}-priv")

    async def start(self, form_host_mesh: bool = False) -> "MeshCluster":
        mesh = make_broker_mesh(self.num_shards, devices=self.devices)
        self.group = MeshBrokerGroup(mesh, MeshGroupConfig(
            num_user_slots=self.num_user_slots, ring_slots=self.ring_slots,
            frame_bytes=self.frame_bytes, extra_lanes=self.extra_lanes,
            batch_window_s=self.batch_window_s,
            gather_frame_bytes=self.gather_frame_bytes,
            fused_collective=self.fused_collective))
        for i in range(self.num_shards):
            ident = self._ident(i)
            b = await Broker.new(BrokerConfig(
                run_def=self.run_def, keypair=self.keypair,
                discovery_endpoint=self.db,
                public_advertise_endpoint=ident.public_advertise_endpoint,
                public_bind_endpoint=ident.public_advertise_endpoint,
                private_advertise_endpoint=ident.private_advertise_endpoint,
                private_bind_endpoint=ident.private_advertise_endpoint,
                heartbeat_interval_s=3600, sync_interval_s=3600,
                whitelist_interval_s=3600,
                form_mesh=form_host_mesh, device=self.device))
            self.group.attach(b, i)
            await b.start()
            self.brokers.append(b)
        # register in discovery WITHOUT dialing (external handles), so the
        # mesh-only tests prove traffic crosses shards with zero host links
        for i in range(self.num_shards):
            h = await Embedded.new(self.db, identity=self._ident(i))
            await h.perform_heartbeat(0, 60.0)
            await h.close()
        if form_host_mesh:
            for b in self.brokers:
                await heartbeat_once(b)  # dial host links as backup plane
            await asyncio.sleep(0.2)
        self.marshal = await Marshal.new(MarshalConfig(
            run_def=self.run_def, discovery_endpoint=self.db,
            bind_endpoint=f"{self.prefix}-marshal"))
        await self.marshal.start()
        return self

    async def place_client(self, seed: int, shard: int, topics) -> Client:
        """Steer the marshal so this client lands on ``shard``."""
        for i in range(self.num_shards):
            h = await Embedded.new(self.db, identity=self._ident(i))
            await h.perform_heartbeat(0 if i == shard else 100, 60.0)
            await h.close()
        c = Client(ClientConfig(
            marshal_endpoint=f"{self.prefix}-marshal",
            keypair=DEFAULT_SCHEME.generate_keypair(seed=seed),
            protocol=Memory, subscribed_topics=set(topics)))
        await c.ensure_initialized()
        await wait_until(
            lambda: self.brokers[shard].connections.has_user(c.public_key))
        return c

    async def stop(self) -> None:
        if self.marshal:
            await self.marshal.stop()
        for b in self.brokers:
            await b.stop()
