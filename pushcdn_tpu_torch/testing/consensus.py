"""View-driven consensus workload: the traffic shape Push-CDN
actually serves (PAPER.md — HotShot consensus), as a reusable driver for
benches and chaos tests.

Per view ``v``: the leader (``nodes[v % n]``) broadcasts a proposal on the
proposal topic; every node that receives it sends a vote Direct back to
the leader; the view *closes* when the leader holds a quorum of votes
(default ``2n//3 + 1``) and *times out* otherwise. This is the
view-synchronized burst + long-tail fan-in pattern: N-way broadcast out,
N-way direct in, latency gated by the slowest quorum member.

Geography rides the transport, not the driver: each node's client can use
a :func:`~pushcdn_tpu_torch.proto.transport.memory.shaped_memory` protocol whose
latency follows a zipf tail (a few far/slow nodes, most near), so quorum
formation sees realistic stragglers while the driver stays pure logic.

Every message is traced (1-in-1 sampling) and tagged with its u32 view
number (:data:`~pushcdn_tpu_torch.proto.message.TRACE_VIEW_FLAG`), so
``scripts/trace_report.py`` can aggregate per-view SLOs from the span log
the run leaves behind. Chaos is injected via the ``chaos`` hook map —
``{view: async callable}`` fired right after that view's proposal is
published, i.e. genuinely mid-view.

A copy of ``pushcdn_tpu.testing.consensus`` with one addition: the
driver's ``place`` hook, awaited before each node connects, which can
spread the nodes over a cluster's brokers (an in-process ``Cluster``
beats its brokers' heartbeats by hand at start only, so the marshal sees
every broker at its start-up load and puts every node on the first). It
drives the port's ``testing.cluster.Cluster``, whose brokers may carry a
device plane (``Cluster(device_plane=..., device=...)``): the proposal is
then one broadcast through the plane's kernel and each vote one direct.
"""

from __future__ import annotations

import asyncio
import struct
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Dict, List, Optional

from pushcdn_tpu_torch.proto import trace as trace_mod
from pushcdn_tpu_torch.proto.error import Error, ErrorKind
from pushcdn_tpu_torch.proto.message import Broadcast, Direct, Retained
from pushcdn_tpu_torch.proto.transport.memory import (LinkShape, Memory,
                                                      shaped_memory)

_U32 = struct.Struct("<I")
_VOTE = struct.Struct("<IH")  # (view, node_index)


@dataclass
class ConsensusConfig:
    """Knobs for one consensus-shaped run."""

    num_nodes: int = 4
    num_views: int = 10
    view_timeout_s: float = 5.0
    quorum: Optional[int] = None          # default 2n//3 + 1
    proposal_bytes: int = 256
    vote_bytes: int = 64
    topic: int = 0
    # zipf-tailed geography: node i's one-way latency is
    #   base_latency_s + tail_latency_s / (i + 1) ** zipf_alpha
    # (node 0 slowest; the tail decays zipf-like toward base). All zero →
    # plain unshaped Memory links.
    base_latency_s: float = 0.0
    tail_latency_s: float = 0.0
    zipf_alpha: float = 1.0
    jitter_s: float = 0.0
    loss: float = 0.0
    rto_s: float = 0.05
    seed: int = 0
    trace: bool = True                    # 1-in-1 sampled, view-tagged
    client_seed_base: int = 40_000

    def effective_quorum(self) -> int:
        q = self.quorum if self.quorum is not None else \
            (2 * self.num_nodes) // 3 + 1
        return min(q, self.num_nodes)

    def node_latency_s(self, i: int) -> float:
        if self.base_latency_s == 0.0 and self.tail_latency_s == 0.0:
            return 0.0
        return (self.base_latency_s
                + self.tail_latency_s / (i + 1) ** self.zipf_alpha)

    def node_protocol(self, i: int):
        lat = self.node_latency_s(i)
        if lat == 0.0 and self.jitter_s == 0.0 and self.loss == 0.0:
            return Memory
        return shaped_memory(LinkShape(
            latency_s=lat, jitter_s=self.jitter_s, loss=self.loss,
            rto_s=self.rto_s, seed=self.seed + i))


@dataclass
class ViewStat:
    view: int
    leader: int
    started_ns: int
    completed_ns: Optional[int] = None    # quorum reached at the leader
    votes: int = 0
    timed_out: bool = False

    @property
    def completion_s(self) -> Optional[float]:
        if self.completed_ns is None:
            return None
        return (self.completed_ns - self.started_ns) / 1e9


@dataclass
class ConsensusRun:
    """Everything a bench row or an SLO gate needs from one run."""

    views: List[ViewStat] = field(default_factory=list)
    proposal_delivery_s: List[float] = field(default_factory=list)
    vote_delivery_s: List[float] = field(default_factory=list)
    proposals_sent: int = 0
    votes_sent: int = 0
    sheds: int = 0
    replayed_proposals: int = 0   # Retained catch-up frames

    @property
    def completed(self) -> int:
        return sum(1 for v in self.views if v.completed_ns is not None)

    @property
    def timeouts(self) -> int:
        return sum(1 for v in self.views if v.timed_out)

    def completion_percentiles(self) -> Dict[str, Optional[float]]:
        samples = sorted(v.completion_s for v in self.views
                         if v.completion_s is not None)
        return {"p50": percentile(samples, 0.50),
                "p95": percentile(samples, 0.95),
                "p99": percentile(samples, 0.99)}

    def delivery_percentiles(self) -> Dict[str, Optional[float]]:
        samples = sorted(self.proposal_delivery_s + self.vote_delivery_s)
        return {"p50": percentile(samples, 0.50),
                "p95": percentile(samples, 0.95),
                "p99": percentile(samples, 0.99)}


def percentile(sorted_samples: List[float], q: float) -> Optional[float]:
    if not sorted_samples:
        return None
    idx = max(0, min(len(sorted_samples) - 1,
                     int(q * len(sorted_samples) + 0.5) - 1))
    return sorted_samples[idx]


def encode_proposal(view: int, size: int) -> bytes:
    body = b"P" + _U32.pack(view)
    return body + b"\x00" * max(0, size - len(body))


def encode_vote(view: int, node: int, size: int) -> bytes:
    body = b"V" + _VOTE.pack(view, node)
    return body + b"\x00" * max(0, size - len(body))


ChaosHook = Callable[[int], Awaitable[None]]
PlaceHook = Callable[[int], Awaitable[None]]


class ConsensusDriver:
    """Runs the view loop over a :class:`~pushcdn_tpu_torch.testing.cluster.
    Cluster`'s clients. One driver = one run; call :meth:`start`, then
    :meth:`run`, then :meth:`stop` (or use :func:`run_consensus`)."""

    def __init__(self, cluster, config: ConsensusConfig,
                 chaos: Optional[Dict[int, ChaosHook]] = None,
                 place: Optional[PlaceHook] = None):
        self.cluster = cluster
        self.cfg = config
        self.chaos = chaos or {}
        # awaited with node i's index before its client connects, e.g. to
        # steer the marshal (``Cluster.place_on``); None leaves placement
        # to the marshal, as the JAX driver does
        self.place = place
        self.result = ConsensusRun()
        self.clients = []
        self._loops: List[asyncio.Task] = []
        self._votes: Dict[int, set] = {}
        self._quorum_events: Dict[int, asyncio.Event] = {}
        self._view_sent_ns: Dict[int, int] = {}
        self._stopping = False
        # node index -> highest view whose proposal the node has seen
        # LIVE (replay_catchup chaos drops a node only once it has voted
        # the current view, so the drop never orphans a traced frame)
        self.last_view_seen: Dict[int, int] = {}

    # -- lifecycle ------------------------------------------------------

    async def start(self) -> "ConsensusDriver":
        cfg = self.cfg
        for i in range(cfg.num_nodes):
            c = self.cluster.client(seed=cfg.client_seed_base + i,
                                    topics=[cfg.topic],
                                    protocol=cfg.node_protocol(i))
            if cfg.trace:
                c._sampler.every = 1    # trace every consensus message
            else:
                c._sampler.every = 0
            if self.place is not None:
                await self.place(i)
            await c.ensure_initialized()
            self.clients.append(c)
        # the subscribe rides the handshake; wait until every broker sees
        # its share of users before the first proposal flies
        from pushcdn_tpu_torch.testing.cluster import wait_until
        await wait_until(
            lambda: sum(b.connections.num_users
                        for b in self.cluster.brokers) >= cfg.num_nodes,
            timeout=15.0)
        for i, c in enumerate(self.clients):
            self._loops.append(asyncio.ensure_future(self._node_loop(i, c)))
        return self

    async def stop(self) -> None:
        self._stopping = True
        for t in self._loops:
            t.cancel()
        for t in self._loops:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        for c in self.clients:
            c.close()

    async def drop_node(self, i: int) -> None:
        """Hard-drop node ``i`` mid-run (replay_catchup chaos): cancel
        its loop and close its client — no elastic re-dial. The node
        stops receiving and voting until :meth:`rejoin_node`."""
        t = self._loops[i]
        t.cancel()
        try:
            await t
        except (asyncio.CancelledError, Exception):
            pass
        self.clients[i].close()

    async def rejoin_node(self, i: int, from_seq: int = 1) -> None:
        """Re-home node ``i`` on a FRESH client and catch it up through
        the durable replay path: ``subscribe_from(topic,
        from_seq)`` replays every retained proposal as ``Retained``
        frames, then live delivery splices in gap-free — so a view in
        flight at rejoin time can still reach quorum on the rejoined
        nodes' replayed votes. Requires the serving broker to retain
        ``cfg.topic`` (``PUSHCDN_RETAIN_TOPICS``)."""
        cfg = self.cfg
        c = self.cluster.client(seed=cfg.client_seed_base + i, topics=[],
                                protocol=cfg.node_protocol(i))
        c._sampler.every = 1 if cfg.trace else 0
        await c.ensure_initialized()
        await c.subscribe_from(cfg.topic, from_seq)
        self.clients[i] = c
        self._loops[i] = asyncio.ensure_future(self._node_loop(i, c))

    # -- the view loop --------------------------------------------------

    def leader_of(self, view: int) -> int:
        return view % self.cfg.num_nodes

    async def run(self) -> ConsensusRun:
        for v in range(self.cfg.num_views):
            await self._run_view(v)
        return self.result

    async def _run_view(self, view: int) -> None:
        cfg = self.cfg
        leader_idx = self.leader_of(view)
        leader = self.clients[leader_idx]
        self._votes[view] = set()
        event = self._quorum_events[view] = asyncio.Event()
        stat = ViewStat(view=view, leader=leader_idx,
                        started_ns=time.time_ns())
        self.result.views.append(stat)

        # view-tag every message this view produces (sequential views:
        # the samplers are only touched from this loop and the node loops
        # reacting to THIS view's proposal)
        for c in self.clients:
            c._sampler.view = view

        self._view_sent_ns[view] = time.time_ns()
        await leader.send_broadcast_message(
            [cfg.topic], encode_proposal(view, cfg.proposal_bytes))
        self.result.proposals_sent += 1

        hook = self.chaos.get(view)
        if hook is not None:
            await hook(view)            # chaos lands mid-view

        try:
            await asyncio.wait_for(event.wait(), cfg.view_timeout_s)
            stat.completed_ns = time.time_ns()
        except asyncio.TimeoutError:
            stat.timed_out = True
        stat.votes = len(self._votes[view])

    # -- node behavior --------------------------------------------------

    async def _node_loop(self, idx: int, client) -> None:
        cfg = self.cfg
        while not self._stopping:
            try:
                msgs = await client.receive_messages()
            except asyncio.CancelledError:
                raise
            except Error as exc:
                if exc.kind == ErrorKind.SHED:
                    self.result.sheds += 1
                    continue
                if self._stopping:
                    return
                continue            # elastic client re-dials on next call
            except Exception:
                if self._stopping:
                    return
                continue
            now = time.time_ns()
            for m in msgs:
                body = m.payload if isinstance(m, Retained) else m.message
                data = bytes(body) if body is not None else b""
                if isinstance(m, (Broadcast, Retained)) and \
                        data[:1] == b"P":
                    (view,) = _U32.unpack_from(data, 1)
                    if isinstance(m, Retained):
                        # replayed catch-up: vote (a view in flight at
                        # rejoin completes on these), but keep the live
                        # delivery SLO samples honest
                        self.result.replayed_proposals += 1
                    else:
                        sent = self._view_sent_ns.get(view)
                        if sent is not None:
                            self.result.proposal_delivery_s.append(
                                (now - sent) / 1e9)
                        self.last_view_seen[idx] = max(
                            view, self.last_view_seen.get(idx, -1))
                    await self._send_vote(idx, client, view)
                elif isinstance(m, Direct) and data[:1] == b"V":
                    view, node = _VOTE.unpack_from(data, 1)
                    sent = self._view_sent_ns.get(view)
                    if sent is not None:
                        self.result.vote_delivery_s.append(
                            (now - sent) / 1e9)
                    votes = self._votes.get(view)
                    if votes is None:
                        continue
                    votes.add(node)
                    if (len(votes) >= cfg.effective_quorum()
                            and view in self._quorum_events):
                        self._quorum_events[view].set()

    async def _send_vote(self, idx: int, client, view: int) -> None:
        cfg = self.cfg
        leader = self.clients[self.leader_of(view)]
        client._sampler.view = view
        try:
            await client.send_direct_message(
                leader.public_key, encode_vote(view, idx, cfg.vote_bytes))
            self.result.votes_sent += 1
        except Error as exc:
            if exc.kind == ErrorKind.SHED:
                self.result.sheds += 1
            # any other send error: the elastic client already tore the
            # connection down; the vote for this view is simply lost
            # (that IS the consensus failure mode chaos is probing)


async def run_consensus(cluster, config: ConsensusConfig,
                        chaos: Optional[Dict[int, ChaosHook]] = None,
                        drain_s: float = 2.0,
                        driver_chaos=None,
                        place: Optional[PlaceHook] = None) -> ConsensusRun:
    """start → run → drain → stop, returning the run stats. The drain
    waits (bounded) for in-flight traced messages to finish delivering so
    the span log closes every chain — ``trace_report --strict``'s
    zero-orphan gate needs quiescence, not a mid-flight teardown.

    ``driver_chaos`` is the driver-aware twin of ``chaos``: a factory
    ``fn(driver) -> {view: hook}`` for chaos that manipulates the nodes
    themselves (drop/rejoin) rather than the cluster. ``place`` is the
    driver's placement hook."""
    driver = ConsensusDriver(cluster, config, chaos=chaos, place=place)
    if driver_chaos is not None:
        driver.chaos = dict(driver.chaos)
        driver.chaos.update(driver_chaos(driver))
    await driver.start()
    try:
        result = await driver.run()
        deadline = asyncio.get_running_loop().time() + drain_s
        want_proposals = result.proposals_sent * config.num_nodes
        while asyncio.get_running_loop().time() < deadline:
            # every delivered proposal triggers exactly one vote, so
            # quiescence = all proposals landed AND votes caught up
            if (len(result.proposal_delivery_s) >= want_proposals
                    and len(result.vote_delivery_s)
                    >= len(result.proposal_delivery_s)):
                break
            await asyncio.sleep(0.02)
        return result
    finally:
        await driver.stop()
