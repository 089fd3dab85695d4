"""A HotShot view replay over two linked port brokers on the CPU, for
``test_torch_hotshot_replay.py`` and ``test_torch_link_tracing.py``.

Two brokers, each with a device plane on the CPU (the plain torch step,
every frame through the plane), linked over loopback TCP; the nodes are
in-process ``Client``s on the Memory transport, placed on the brokers as
a test asks. The schedule comes from the port's plain reference
(``pushcdn_tpu_torch.testing.hotshot_reference``): every node sends its
frames at their due times, each payload carrying its type, publisher and
sequence number, and every delivery is recorded in arrival order.
"""

from __future__ import annotations

import asyncio
import contextlib
import socket
import struct
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from pushcdn_tpu_torch.broker import metrics as broker_metrics
from pushcdn_tpu_torch.broker.device_plane import DevicePlaneConfig
from pushcdn_tpu_torch.broker.tasks.sync import (partial_topic_sync,
                                                  partial_user_sync)
from pushcdn_tpu_torch.client import Client, ClientConfig
from pushcdn_tpu_torch.proto import metrics as metrics_mod
from pushcdn_tpu_torch.proto.def_ import testing_run_def
from pushcdn_tpu_torch.proto.message import Broadcast, Direct
from pushcdn_tpu_torch.proto.transport import base as transport_base
from pushcdn_tpu_torch.proto.transport.memory import Memory
from pushcdn_tpu_torch.proto.transport.tcp import Tcp
from pushcdn_tpu_torch.testing import hotshot_reference as ref
from pushcdn_tpu_torch.testing.cluster import Cluster, wait_until

NODES, COMMITTEE, QUORUM, VIEWS = 48, 8, 33, 12
RATE = 20.0                       # views a second
GLOBAL, DA_TOPIC = 0, 1           # TestTopic.GLOBAL, TestTopic.DA
NUM_TOPICS = 2
SIZES = (1024, 12288, 192)        # proposal, DA proposal, vote
HDR = struct.Struct("<BHI")       # type, publisher, sequence
PLANE = dict(num_user_slots=64, ring_slots=64, frame_bytes=2048,
             extra_lanes=((16384, 16),), bypass_max_items=0)
LINK_CHILDREN = {("in", "direct"): broker_metrics.LINK_IN_DIRECT,
                 ("in", "broadcast"): broker_metrics.LINK_IN_BROADCAST,
                 ("out", "direct"): broker_metrics.LINK_OUT_DIRECT,
                 ("out", "broadcast"): broker_metrics.LINK_OUT_BROADCAST}


def schedule(seed: int, nodes: int = NODES, committee: int = COMMITTEE,
             views: int = VIEWS, rate: float = RATE):
    """``(frames, topics)`` of a seeded replay: round-robin leaders, a
    committee of ``committee`` on the DA topic, each vote due 20-120 ms
    after its view."""
    g = np.random.default_rng(seed)
    v = np.arange(views, dtype=np.int64)
    due = np.rint(v * 1e9 / rate).astype(np.int64)
    leader = np.arange(views + 1, dtype=np.int64) % nodes
    vote_due = due[:, None] + g.integers(20_000_000, 120_000_001,
                                         (views, nodes))
    da = set(g.choice(nodes, committee, replace=False).tolist())
    topics = [[GLOBAL, DA_TOPIC] if u in da else [GLOBAL]
              for u in range(nodes)]
    return ref.frames(v, due, leader, vote_due, SIZES, GLOBAL,
                      DA_TOPIC), topics


def placement(on_first: int, nodes: int = NODES) -> np.ndarray:
    """``broker_of[node]``: ``on_first`` nodes on broker 0 and the rest,
    spread evenly over the node indices (so over the leaders too), on
    broker 1."""
    u = np.arange(nodes + 1, dtype=np.int64) * (nodes - on_first) // nodes
    return np.diff(u)


def payload(mtype: int, pub: int, seq: int, size: int) -> bytes:
    return HDR.pack(mtype, pub, seq) + bytes([pub & 0xFF]) * (size - HDR.size)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class LinkedCluster(Cluster):
    """``Cluster`` of two plane brokers on the CPU whose link is TCP."""

    def __init__(self, plane: Optional[dict] = None):
        super().__init__(num_brokers=2,
                         device_plane=DevicePlaneConfig(**(plane or PLANE)),
                         device="cpu")
        self.run_def = testing_run_def(broker_protocol=Tcp,
                                       user_protocol=Memory)
        self._link_ports = [_free_port(), _free_port()]

    def broker_endpoints(self, i: int):
        public, _ = super().broker_endpoints(i)
        return public, f"127.0.0.1:{self._link_ports[i]}"


@dataclass
class Outcome:
    frames: Dict[str, np.ndarray]
    topics: List[List[int]]
    broker_of: np.ndarray
    got: np.ndarray                       # delivery codes, arrival order
    corrupt: int
    link: Dict[tuple, int]                # (dir, kind) -> frames
    stamps: List[tuple] = field(default_factory=list)   # receive stamps
    link_batches: int = 0                 # batches read off the links
    link_write_s: float = 0.0             # TCP stream write seconds

    def want(self) -> np.ndarray:
        return ref.deliveries(self.frames, self.topics, NUM_TOPICS)

    def votes_at_leaders(self) -> Dict[int, int]:
        """Distinct voters of each view that reached its next leader."""
        f = self.frames
        sender = (f["pub"] << ref.SEQ_BITS) | f["seq"]
        view_of = dict(zip(sender.tolist(), f["view"].tolist()))
        vote = set(sender[f["mtype"] == ref.VOTE].tolist())
        seen: Dict[int, set] = {}
        for code in self.got.tolist():
            s = code & ((1 << 40) - 1)
            if s in vote:
                seen.setdefault(view_of[s], set()).add(s >> ref.SEQ_BITS)
        return {v: len(p) for v, p in seen.items()}

    def crossings(self) -> np.ndarray:
        return ref.crossings(self.frames, self.topics, NUM_TOPICS,
                             self.broker_of, 2)


async def _connect(cluster: LinkedCluster, broker_of, topics):
    clients = []
    for u, b in enumerate(broker_of.tolist()):
        await cluster.place_on(b)
        c = Client(ClientConfig(
            marshal_endpoint=cluster.marshal_endpoint,
            keypair=cluster.scheme.generate_keypair(seed=70_000 + u),
            protocol=Memory, scheme=cluster.scheme,
            subscribed_topics=set(topics[u])))
        await c.ensure_initialized()
        clients.append(c)
    keys = [c.config.keypair.public_key for c in clients]
    idents = [b.connections.identity for b in cluster.brokers]
    await wait_until(lambda: all(
        k in cluster.brokers[b].connections.users
        for k, b in zip(keys, broker_of.tolist())), 30)
    held = [{t for u in np.flatnonzero(broker_of == b) for t in topics[u]}
            for b in range(2)]

    def synced():
        for b, broker in enumerate(cluster.brokers):
            conns = broker.connections
            if any(conns.get_broker_identifier_of_user(k) != idents[o]
                   for k, o in zip(keys, broker_of.tolist())):
                return False
            for t in (GLOBAL, DA_TOPIC):
                peers = set(conns.get_interested_by_topic([t], False)[1])
                if peers != ({idents[1 - b]} if t in held[1 - b] else set()):
                    return False
        return True

    deadline = time.monotonic() + 30
    while not synced():
        if time.monotonic() > deadline:
            raise AssertionError("the brokers did not sync their users and "
                                 "topics")
        for broker in cluster.brokers:
            await partial_user_sync(broker)
            await partial_topic_sync(broker)
        await asyncio.sleep(0.05)
    return clients, keys


async def replay(on_first: int, seed: int, plant=None) -> Outcome:
    """One replay of ``schedule(seed)`` with ``on_first`` nodes on broker
    0. ``plant``, a context manager, wraps the replay (a broken link)."""
    f, topics = schedule(seed)
    broker_of = placement(on_first)
    size_of = dict(zip(((f["pub"] << ref.SEQ_BITS) | f["seq"]).tolist(),
                       f["size"].tolist()))
    link_conns: set = set()
    counts = {"batches": 0}
    stamps: List[tuple] = []
    recv_raw_many = transport_base.Connection.recv_raw_many
    inc_each = metrics_mod.inc_each

    async def counted_recv(self, *a, **kw):
        out = await recv_raw_many(self, *a, **kw)
        if id(self) in link_conns:
            counts["batches"] += 1
        return out

    def recorded(counters, amounts):
        counters, amounts = tuple(counters), tuple(amounts)
        if counters and counters[0] is broker_metrics.LINK_RECEIVE_SECONDS:
            stamps.append(amounts)
        return inc_each(counters, amounts)

    transport_base.Connection.recv_raw_many = counted_recv
    metrics_mod.inc_each = recorded
    cluster = await LinkedCluster().start()
    clients: list = []
    receivers: list = []
    try:
        clients, keys = await _connect(cluster, broker_of, topics)
        for b in cluster.brokers:
            for ident in list(b.connections.brokers):
                link_conns.add(id(b.connections.get_broker_connection(ident)))
        got: list = []
        bad = [0]

        async def receive(u: int, c: Client):
            while True:
                for m in await c.receive_messages():
                    body = bytes(m.message)
                    mtype, pub, seq = HDR.unpack_from(body)
                    s = (pub << ref.SEQ_BITS) | seq
                    if len(body) != size_of.get(s) or body[HDR.size:] != \
                            bytes([pub & 0xFF]) * (len(body) - HDR.size):
                        bad[0] += 1
                        continue
                    got.append((u << 40) | s)

        receivers = [asyncio.ensure_future(receive(u, c))
                     for u, c in enumerate(clients)]
        want = ref.deliveries(f, topics, NUM_TOPICS).size
        before = {k: c.value for k, c in LINK_CHILDREN.items()}
        write_child = metrics_mod.STREAM_WRITE_SECONDS.labels(
            transport="tcp")
        write_before = write_child.value
        batches_before, stamps_before = counts["batches"], len(stamps)
        t0 = time.monotonic_ns() + 100_000_000
        pubs = f["pub"]

        async def node(u: int):
            idx = np.flatnonzero(pubs == u)
            for i in idx.tolist():
                wait = t0 + int(f["due"][i]) - time.monotonic_ns()
                if wait > 0:
                    await asyncio.sleep(wait / 1e9)
                body = payload(int(f["mtype"][i]), u, int(f["seq"][i]),
                               int(f["size"][i]))
                target = int(f["target"][i])
                await clients[u].send_message(
                    Direct(keys[target], body) if target >= 0
                    else Broadcast([int(f["t0"][i])], body))

        with plant or contextlib.nullcontext():
            await asyncio.gather(*(node(u) for u in range(NODES)))
            # every delivery due, or a second with none
            last, quiet = -1, time.monotonic()
            while len(got) + bad[0] < want \
                    and time.monotonic() - quiet < 1.0:
                if len(got) != last:
                    last, quiet = len(got), time.monotonic()
                await asyncio.sleep(0.05)
            await asyncio.sleep(0.3)   # room for anything extra
        return Outcome(
            frames=f, topics=topics, broker_of=broker_of,
            got=np.asarray(got, np.int64), corrupt=bad[0],
            link={k: c.value - before[k] for k, c in LINK_CHILDREN.items()},
            stamps=stamps[stamps_before:],
            link_batches=counts["batches"] - batches_before,
            link_write_s=write_child.value - write_before)
    finally:
        transport_base.Connection.recv_raw_many = recv_raw_many
        metrics_mod.inc_each = inc_each
        for t in receivers:
            t.cancel()
        await asyncio.gather(*receivers, return_exceptions=True)
        for c in clients:
            c.close()
        await cluster.stop()
