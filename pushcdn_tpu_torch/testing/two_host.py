"""The two-OS-process deployment shape, shared by its workers and their
parents.

A copy of ``pushcdn_tpu.testing.two_host``. Each process of the pair
joins the process group (``parallel.multihost.initialize``), builds the
global 8-shard mesh with its 4 local shards, attaches one TCP broker to
its first local shard, runs a marshal pinned to that broker, and
authenticates one TCP client through it. The workers are modules of
this package (``python -m pushcdn_tpu_torch.testing.<worker>``), started
in pairs by :func:`spawn_worker_pair`; they take ``--rank``, ``--world``
and ``--init`` (a ``file://`` or ``tcp://`` rendezvous) first.

Build a node only after ``initialize`` has run in the process.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import socket
import subprocess
import sys
from dataclasses import dataclass
from typing import List, Optional, Sequence

from pushcdn_tpu_torch._device import DeviceLike, resolve_device
from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
from pushcdn_tpu_torch.broker.mesh_group import MeshGroupConfig
from pushcdn_tpu_torch.broker.multihost_group import MultiHostBrokerGroup
from pushcdn_tpu_torch.client import Client, ClientConfig
from pushcdn_tpu_torch.marshal import Marshal, MarshalConfig
from pushcdn_tpu_torch.parallel.multihost import (
    local_shard_indices,
    pod_broker_mesh,
)
from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
from pushcdn_tpu_torch.proto.def_ import testing_run_def
from pushcdn_tpu_torch.proto.discovery.base import BrokerIdentifier
from pushcdn_tpu_torch.proto.discovery.embedded import Embedded
from pushcdn_tpu_torch.proto.transport import Tcp

N_SHARDS = 8
LOCAL_SHARDS = 4


def free_ports(n: int) -> List[int]:
    """``n`` distinct loopback ports free right now."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


@dataclass
class TwoHostNode:
    """One process's slice of the two-process deployment."""

    rank: int
    my_shard: int
    ident: BrokerIdentifier
    group: MultiHostBrokerGroup
    broker: Broker
    marshal: Marshal
    client: Client

    async def directory_rendezvous(self, want: int = 2,
                                   timeout_s: float = 20.0) -> None:
        """Wait until the user-slot directory shows ``want`` users: the
        phase barrier between the two processes."""
        for _ in range(int(timeout_s / 0.05)):
            if len(await self.group.discovery.get_user_slots()) >= want:
                return
            await asyncio.sleep(0.05)
        raise AssertionError("user-slot directory never converged")

    async def publish_marker(self, marker: bytes) -> None:
        await self.group.discovery.publish_user_slots({marker: (0, 0.0)}, 60)

    async def await_markers(self, markers: List[bytes],
                            timeout_s: float = 20.0) -> None:
        for _ in range(int(timeout_s / 0.05)):
            slots = await self.group.discovery.get_user_slots()
            if all(m in slots for m in markers):
                return
            await asyncio.sleep(0.05)
        raise AssertionError(f"markers {markers} never all appeared")

    async def stop(self) -> None:
        self.client.close()
        await self.marshal.stop()
        await self.broker.stop()
        await self.group.discovery.close()


async def make_two_host_node(rank: int, db: str, *,
                             client_seeds: Sequence[int],
                             broker_seed_base: int,
                             device: DeviceLike = None,
                             mesh_config: Optional[MeshGroupConfig] = None,
                             directory_refresh_s: float = 0.2,
                             collective_timeout_s: float = 20.0
                             ) -> TwoHostNode:
    """Build this process's half of the deployment, its shards folded
    onto ``device`` (the card unless the caller names another, raising
    without CUDA), and authenticate its client (subscribed to topic 0)."""
    mesh = pod_broker_mesh(N_SHARDS,
                           local_devices=[resolve_device(device)]
                           * LOCAL_SHARDS,
                           timeout_s=collective_timeout_s)
    my_shard = local_shard_indices(mesh)[0]
    rd = testing_run_def(broker_protocol=Tcp, user_protocol=Tcp)
    group = MultiHostBrokerGroup(
        mesh,
        mesh_config or MeshGroupConfig(
            num_user_slots=64, ring_slots=8, frame_bytes=1024,
            extra_lanes=(), direct_bucket_slots=4, batch_window_s=0.02),
        discovery=await Embedded.new(db),
        directory_refresh_s=directory_refresh_s,
        collective_timeout_s=collective_timeout_s)

    pub, priv, marshal_port = free_ports(3)
    ident = BrokerIdentifier(f"127.0.0.1:{pub}", f"127.0.0.1:{priv}")
    broker = await Broker.new(BrokerConfig(
        run_def=rd,
        keypair=DEFAULT_SCHEME.generate_keypair(
            seed=broker_seed_base + rank),
        discovery_endpoint=db,
        public_advertise_endpoint=ident.public_advertise_endpoint,
        public_bind_endpoint=ident.public_advertise_endpoint,
        private_advertise_endpoint=ident.private_advertise_endpoint,
        private_bind_endpoint=ident.private_advertise_endpoint,
        heartbeat_interval_s=0.5, sync_interval_s=3600,
        whitelist_interval_s=3600, form_mesh=False))
    group.attach(broker, my_shard)
    await broker.start()

    marshal = await Marshal.new(MarshalConfig(
        run_def=rd, discovery_endpoint=db,
        bind_endpoint=f"127.0.0.1:{marshal_port}"))
    await marshal.start()

    # pin placement: THIS process's marshal always assigns THIS process's
    # broker (production load-balances; the harness needs the
    # cross-process topology)
    async def pinned():
        return ident
    marshal.discovery.get_with_least_connections = pinned

    client = Client(ClientConfig(
        marshal_endpoint=f"127.0.0.1:{marshal_port}",
        keypair=DEFAULT_SCHEME.generate_keypair(seed=client_seeds[rank]),
        protocol=Tcp, subscribed_topics={0}))
    await client.ensure_initialized()
    for _ in range(200):
        if broker.connections.num_users == 1:
            break
        await asyncio.sleep(0.05)
    assert broker.connections.num_users == 1

    return TwoHostNode(rank=rank, my_shard=my_shard, ident=ident,
                       group=group, broker=broker, marshal=marshal,
                       client=client)


def worker_args(argv=None) -> argparse.Namespace:
    """The arguments every worker takes: ``--rank``, ``--world`` and
    ``--init``, then the worker's own (``args.rest``)."""
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--init", required=True,
                   help="rendezvous: file:///path or tcp://host:port")
    p.add_argument("rest", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def spawn_worker_pair(module: str, init: str, extra_args: Sequence[str],
                      log_dir: str) -> List[subprocess.Popen]:
    """Start ``python -m <module>`` as ranks 0 and 1 with the repo on
    ``PYTHONPATH``; each worker's output goes to ``rank<N>.log`` in
    ``log_dir`` (kept even when a worker is killed). The caller owns
    waiting and asserting."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = (repo + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else repo)
    procs = []
    for rank in (0, 1):
        argv = [sys.executable, "-m", module, "--rank", str(rank),
                "--world", "2", "--init", init, *extra_args]
        with open(os.path.join(log_dir, f"rank{rank}.log"), "w") as out:
            procs.append(subprocess.Popen(
                argv, env=env, stdout=out, stderr=subprocess.STDOUT))
    return procs
