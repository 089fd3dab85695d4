"""Broker bootstrap and fail-fast supervision.

Capability parity with cdn-broker/src/lib.rs:43-319: config → ``local_ip``
substitution, discovery client, dual listeners (public = users, private =
peer brokers), optional metrics endpoint; ``start`` spawns the five
long-lived tasks (heartbeat, sync, whitelist, user listener, broker
listener) and the process dies if any of them exits (lib.rs:302-318).

A copy of ``pushcdn_tpu.broker.broker``. Every broker builds admission
control (``broker.admission``: connection budgets and subscribe-rate
shedding, off unless its knobs are set), the durable topics
(``broker.durable``: retention rings, replay subscribe and the topic
namespace) and, with a metrics endpoint, the operator drain ``GET
/drain`` that re-homes every user (``broker.rehome``).
A broker may be one of N worker shards of one identity: the worker sets
``shard_runtime`` (``broker.sharding.runtime_from_spec``, or
``attach_inprocess_shards`` on one loop), binds the user listener with
``SO_REUSEPORT`` or adopts accepted sockets from its parent
(``accept_handoff_fd``), and worker 0 alone owns the mesh links.

The device plane runs on ``BrokerConfig.device`` (CUDA unless the caller
passes ``"cpu"``); on the card its pump is one of the supervised tasks,
so a device step that fails brings the broker down after its frames took
the host path.
"""

from __future__ import annotations

import asyncio
import logging
import os
import socket
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

from pushcdn_tpu_torch.broker import metrics as broker_metrics
from pushcdn_tpu_torch.broker.admission import AdmissionControl
from pushcdn_tpu_torch.broker.connections import Connections
from pushcdn_tpu_torch.broker.retention import DurableTopics
from pushcdn_tpu_torch.broker.tasks import heartbeat as heartbeat_task
from pushcdn_tpu_torch.broker.tasks import listeners as listener_tasks
from pushcdn_tpu_torch.broker.tasks import sync as sync_task
from pushcdn_tpu_torch.broker.tasks import whitelist as whitelist_task
from pushcdn_tpu_torch.proto import health as health_mod
from pushcdn_tpu_torch.proto import ledger as ledger_mod
from pushcdn_tpu_torch.proto import metrics as metrics_mod
from pushcdn_tpu_torch.proto.crypto.signature import KeyPair
from pushcdn_tpu_torch.proto.crypto.tls import Certificate, generate_cert_from_ca, load_ca
from pushcdn_tpu_torch.proto.def_ import RunDef
from pushcdn_tpu_torch.proto.discovery.base import BrokerIdentifier
from pushcdn_tpu_torch.proto.error import Error, ErrorKind, bail
from pushcdn_tpu_torch.proto.limiter import Limiter
from pushcdn_tpu_torch.proto.util import mnemonic

if TYPE_CHECKING:  # import only for annotations (runtime import would cycle,
    # and a broker without a plane must not import torch)
    from pushcdn_tpu_torch._device import DeviceLike
    from pushcdn_tpu_torch.broker.device_plane import DevicePlaneConfig

logger = logging.getLogger("pushcdn.broker")

GIB = 1024 * 1024 * 1024


def _substitute_local_ip(endpoint: str) -> str:
    """Replace the magic host ``local_ip`` with this machine's primary
    address (parity cdn-broker/src/lib.rs:157-168)."""
    if not endpoint.startswith("local_ip"):
        return endpoint
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 80))  # no traffic sent; just picks a route
        ip = s.getsockname()[0]
    except OSError:
        ip = "127.0.0.1"
    finally:
        s.close()
    return endpoint.replace("local_ip", ip, 1)


@dataclass
class BrokerConfig:
    """Parity ``Config<R>`` (cdn-broker/src/lib.rs:43-96)."""

    run_def: RunDef
    keypair: KeyPair
    discovery_endpoint: str
    public_advertise_endpoint: str
    public_bind_endpoint: str
    private_advertise_endpoint: str
    private_bind_endpoint: str
    metrics_bind_endpoint: Optional[str] = None
    ca_cert_path: Optional[str] = None
    ca_key_path: Optional[str] = None
    # attach the device plane: eligible messages route on-device in
    # batched steps (broker/device_plane.py); None = host-only
    device_plane: Optional["DevicePlaneConfig"] = None
    # the device plane's device: None = the current CUDA device
    device: "DeviceLike" = None
    # 1 GiB default pool (binaries/broker.rs:67-72)
    global_memory_pool_size: int = GIB
    # operational cadences (heartbeat.rs:39,107; sync.rs:142; whitelist.rs)
    heartbeat_interval_s: float = 10.0
    sync_interval_s: float = 10.0
    whitelist_interval_s: float = 60.0
    membership_ttl_s: float = 60.0
    auth_timeout_s: float = 5.0
    # /readyz discovery check: re-probe the store at most this often (the
    # heartbeat's own successes/failures refresh the cache for free)
    discovery_probe_ttl_s: float = 5.0
    # False = register in discovery but never dial host broker links
    # (deployments whose inter-broker plane is the device mesh only)
    form_mesh: bool = True
    # ---- sharded data plane (ISSUE 6) ----
    # worker-shard role: shard 0 owns the private (mesh) listener and the
    # heartbeat/sync/whitelist control tasks; other workers run only the
    # user data plane. reuse_port spreads accepted users across workers.
    shard_index: int = 0
    num_shards: int = 1
    bind_private: bool = True
    reuse_port: bool = False
    # fd-handoff fallback (no SO_REUSEPORT): adopt accepted sockets from
    # the parent over this inherited unix-socketpair fd instead of binding
    accept_handoff_fd: Optional[int] = None


class Broker:
    """One broker process (parity ``Broker``/``Inner``, lib.rs:98-319)."""

    def __init__(self, config: BrokerConfig):
        self.config = config
        self.run_def = config.run_def
        self.identity: BrokerIdentifier = None       # set in new()
        self.discovery = None
        self.limiter: Limiter = None
        self.connections: Connections = None
        self.certificate: Optional[Certificate] = None
        self.user_listener = None
        self.broker_listener = None
        self.admission = None  # AdmissionControl, set in new()
        self._tasks: list[asyncio.Task] = []
        self._stopped = asyncio.Event()
        # set by the device plane when overflow traffic needs host links
        # before the next scheduled heartbeat tick
        self.host_links_kick = asyncio.Event()
        self._metrics_server = None
        self.device_plane = None
        self.shard_runtime = None  # ShardRuntime when this is one of N workers
        self.durable = None  # DurableTopics, set in new()
        self.seen_dialing: set[str] = set()  # peers we're currently dialing
        # readiness state (ISSUE 5): listeners-bound latch, cached
        # discovery probe (refreshed by the heartbeat task and, past the
        # TTL, by an active probe from the /readyz handler), and the peer
        # count discovery last reported (the solo-vs-partitioned signal)
        self.listeners_bound = False
        self._discovery_probe: tuple = (False, "not probed yet")
        self._discovery_probe_at: Optional[float] = None
        self.last_peer_count: Optional[int] = None
        # elastic membership (ISSUE 12): set by begin_drain; the heartbeat
        # task checks it to deregister instead of re-advertising, and the
        # re-homer refuses to run twice
        self.draining = False

    @classmethod
    async def new(cls, config: BrokerConfig) -> "Broker":
        self = cls(config)
        c = config

        public_adv = _substitute_local_ip(c.public_advertise_endpoint)
        private_adv = _substitute_local_ip(c.private_advertise_endpoint)
        self.identity = BrokerIdentifier(public_adv, private_adv)

        self.discovery = await self.run_def.discovery.new(
            c.discovery_endpoint, identity=self.identity,
            global_permits=self.run_def.global_permits)

        ca_cert, ca_key = load_ca(c.ca_cert_path, c.ca_key_path)
        self.certificate = generate_cert_from_ca(ca_cert, ca_key)

        self.limiter = Limiter(global_pool_bytes=c.global_memory_pool_size)
        self.connections = Connections(str(self.identity))
        # admission control: connection budgets + subscribe-rate
        # shedding; env-configured, disabled by default
        self.admission = AdmissionControl(self)
        # durable topics: retention rings + replay subscribe + wildcard
        # namespace; env-configured, retention disabled by default
        # (wildcard SubscribeFrom works either way)
        self.durable = DurableTopics.from_env(self)

        # The observability endpoint comes up BEFORE the listeners bind:
        # /readyz must be probe-able (and false) during startup, so an
        # orchestrator never routes to a broker that can't accept yet.
        if c.metrics_bind_endpoint:
            self._metrics_server = await metrics_mod.serve_metrics(
                c.metrics_bind_endpoint)
            self.register_observability()
            # CI/test hook: hold the listener binds open for a beat so an
            # external prober can observe the not-ready-before-bind state
            # (scripts/local_cluster.py uses this to prove the readiness
            # lifecycle end to end)
            delay = float(os.environ.get("PUSHCDN_BIND_DELAY_S", "") or 0)
            if delay > 0:
                await asyncio.sleep(delay)

        try:
            # public listener carries users, private carries peer brokers
            # (lib.rs:190-212)
            if c.accept_handoff_fd is not None:
                # sharded fd-handoff fallback: adopt accepted sockets from
                # the parent acceptor instead of binding (no SO_REUSEPORT)
                from pushcdn_tpu_torch.broker.sharding import (
                    FdHandoffListener,
                )
                self.user_listener = FdHandoffListener(socket.socket(
                    socket.AF_UNIX, socket.SOCK_STREAM,
                    fileno=c.accept_handoff_fd))
            elif c.reuse_port:
                self.user_listener = await self.run_def.user_def.protocol.bind(
                    _substitute_local_ip(c.public_bind_endpoint),
                    certificate=self.certificate, reuse_port=True)
            else:
                self.user_listener = await self.run_def.user_def.protocol.bind(
                    _substitute_local_ip(c.public_bind_endpoint),
                    certificate=self.certificate)
            if c.bind_private:
                self.broker_listener = await self.run_def.broker_def.protocol.bind(
                    _substitute_local_ip(c.private_bind_endpoint),
                    certificate=self.certificate)
            self.listeners_bound = True

            if c.device_plane is not None:
                from pushcdn_tpu_torch.broker.device_plane import DevicePlane
                self.device_plane = DevicePlane(c.device_plane, c.device,
                                                broker=self)
                self.connections.observer = self.device_plane
        except BaseException:
            # a failed bootstrap (port in use) must not strand a live
            # metrics server answering /readyz for a broker that never
            # existed, nor leave its checks in the process registries
            if self.user_listener is not None:
                try:
                    await self.user_listener.close()
                except Exception:
                    pass
            if self._metrics_server is not None:
                self._metrics_server.close()
                await self._metrics_server.wait_closed()
                self._metrics_server = None
                self.unregister_observability()
            raise

        logger.info("broker %s ready (users on %s, brokers on %s)",
                    self.identity, c.public_bind_endpoint, c.private_bind_endpoint)
        return self

    # -- observability plane (ISSUE 5) --------------------------------------

    def register_observability(self) -> None:
        """Register this broker's readiness checks + /debug/topology on
        the process-global health/metrics registries (one broker per
        process owns the endpoint; in-process test brokers without a
        metrics server never register)."""
        health_mod.register_readiness("listeners", self._check_listeners)
        health_mod.register_readiness("discovery", self._check_discovery)
        health_mod.register_readiness("mesh", self._check_mesh)
        health_mod.register_readiness("admission", self._check_admission)
        health_mod.register_readiness("conservation",
                                      ledger_mod.LEDGER.conservation_check)
        metrics_mod.register_debug_route("/debug/topology",
                                         self._topology_route)
        metrics_mod.register_debug_route("/debug/ledger",
                                         ledger_mod.ledger_route)
        metrics_mod.register_debug_route("/drain", self._drain_route)
        metrics_mod.register_debug_route("/debug/plane_steps",
                                         self._plane_steps_route)

    def unregister_observability(self) -> None:
        for name in ("listeners", "discovery", "mesh", "admission",
                     "conservation"):
            health_mod.unregister(name)
        metrics_mod.unregister_debug_route("/debug/plane_steps")
        metrics_mod.unregister_debug_route("/debug/topology")
        metrics_mod.unregister_debug_route("/debug/ledger")
        metrics_mod.unregister_debug_route("/drain")

    def _check_listeners(self):
        if not self.listeners_bound:
            return False, "listeners not bound yet"
        return True, "user + broker listeners bound"

    def _check_admission(self):
        """Not ready while the admission plane is actively shedding —
        the load balancer steers new connections away until the box has
        gone PUSHCDN_SHED_READY_S without refusing work."""
        if self.admission is None:
            return True, "admission control not configured"
        return self.admission.readiness_check()

    def note_discovery_probe(self, ok: bool, detail: str) -> None:
        """Cache a discovery-store contact outcome (the heartbeat task
        reports its own successes/failures here, so steady-state /readyz
        never pays an extra round-trip)."""
        self._discovery_probe = (ok, detail)
        self._discovery_probe_at = time.monotonic()

    async def _check_discovery(self):
        now = time.monotonic()
        if (self._discovery_probe_at is not None
                and now - self._discovery_probe_at
                < self.config.discovery_probe_ttl_s):
            return self._discovery_probe
        # cache expired: active probe (bounded — a hung store must not
        # wedge the /readyz handler)
        try:
            async with asyncio.timeout(2.0):
                peers = await self.discovery.get_other_brokers()
            self.last_peer_count = len(peers)
            self.note_discovery_probe(True, f"ok ({len(peers)} peers)")
        except Exception as exc:
            self.note_discovery_probe(False, f"probe failed: {exc!r}")
        return self._discovery_probe

    def _check_mesh(self):
        """Ready when the mesh has ≥1 live peer link, or being solo is
        intentional: discovery reports no other brokers (we ARE the
        deployment), or the inter-broker plane is the device mesh
        (form_mesh=False), or this is a non-zero worker shard (the mesh
        links live on shard 0)."""
        if self.config.num_shards > 1 and self.config.shard_index != 0:
            return True, "mesh links owned by shard 0"
        n = self.connections.num_brokers
        if n >= 1:
            return True, f"{n} peer links"
        if not self.config.form_mesh:
            return True, "device-mesh inter-broker plane (no host links)"
        if self.last_peer_count == 0:
            return True, "intentionally solo (no other brokers registered)"
        if self.last_peer_count is None:
            return False, "no peer links and discovery not consulted yet"
        return (False, f"0 peer links but discovery reports "
                       f"{self.last_peer_count} other brokers")

    def begin_drain(self, reason: str = "shutdown") -> None:
        """Flip /readyz to 503 (and record the ready-flip flight-recorder
        event) BEFORE any listener closes — the load balancer stops
        routing here while in-flight traffic still drains."""
        self.draining = True
        health_mod.set_draining(reason)

    async def _drain_route(self, params: dict) -> dict:
        """``GET /drain``: operator-triggered elastic drain, the same
        sequence SIGTERM runs: flip /readyz, leave discovery, then actively
        re-home every connected user to the live peers. Returns the re-home
        summary so the operator sees migrated/orphaned counts without
        tailing logs."""
        from pushcdn_tpu_torch.broker import rehome as rehome_mod
        already = self.draining
        self.begin_drain("operator /drain")
        summary = await rehome_mod.rehome_users(self)
        summary["was_draining"] = already
        return summary

    def _topology_route(self, params: dict) -> dict:
        return self.topology_snapshot()

    def _plane_steps_route(self, params: dict):
        """``GET /debug/plane_steps[?limit=N]``: the single-shard plane's
        newest step records (``DevicePlane.steps_json``; default 256); 404
        on a broker without one."""
        plane = self.device_plane
        if plane is None or not hasattr(plane, "steps_json"):
            return 404, "text/plain", "no single-shard device plane\n"
        try:
            limit = int(params.get("limit", "256"))
        except ValueError:
            return 400, "text/plain", "limit must be an integer\n"
        return plane.steps_json(limit)

    def topology_snapshot(self, max_users: int = 256) -> dict:
        """The live mesh as one JSON-able dict (``GET /debug/topology``):
        peer links with writer-queue backpressure, per-connection
        subscribe counts, interest-table summary, and the cut-through
        snapshot's age/churn state."""
        conns = self.connections
        peers = []
        for ident, handle in conns.brokers.items():
            depth, in_flight = handle.connection.queue_stats()
            peers.append({
                "id": ident,
                "writer_queue_depth": depth,
                "bytes_in_flight": in_flight,
                "topics": len(conns.broker_topics.get_values_of_key(ident)),
            })
        users = []
        for key, handle in conns.users.items():
            if len(users) >= max_users:
                break
            depth, in_flight = handle.connection.queue_stats()
            users.append({
                "key": mnemonic(key),
                "topics": len(conns.user_topics.get_values_of_key(key)),
                "writer_queue_depth": depth,
                "bytes_in_flight": in_flight,
            })
        topic_cardinality = {
            str(t): len(conns.user_topics.get_keys_by_value(t))
            for t in sorted(set(conns.user_topics.values()))}
        state = getattr(self, "_route_state", None)
        runtime = self.shard_runtime
        return {
            "shard_runtime": runtime.stats() if runtime is not None else None,
            "identity": str(self.identity),
            "draining": health_mod.draining() is not None,
            "interest_version": conns.interest_version,
            "num_users": conns.num_users,
            "num_brokers": conns.num_brokers,
            "peers": sorted(peers, key=lambda p: p["id"]),
            "users": users,
            "users_truncated": max(conns.num_users - len(users), 0),
            "interest": {
                "topic_cardinality": topic_cardinality,
                "broker_topics": len(set(conns.broker_topics.values())),
                "direct_map_size": len(conns.direct_map),
            },
            "cutthrough": state.summary() if state is not None else None,
            "admission": (self.admission.summary()
                          if self.admission is not None else None),
            "durable": (self.durable.stats()
                        if self.durable is not None and self.durable.enabled
                        else None),
        }

    # -- supervision --------------------------------------------------------

    async def start(self) -> None:
        """Spawn the five supervised tasks (lib.rs:269-318). A non-zero
        worker shard runs only the user data plane (+ whitelist for its
        own users); shard 0 / unsharded brokers run the full set."""
        if self.device_plane is not None:
            await self.device_plane.start()
        metrics_mod.PRE_RENDER_HOOKS.append(self.update_metrics)
        spawn = asyncio.create_task
        self._tasks = [
            spawn(listener_tasks.run_user_listener_task(self),
                  name="user-listener"),
            spawn(whitelist_task.run_whitelist_task(self), name="whitelist"),
            # continuous conservation auditor + SLO burn engine (ISSUE 20)
            spawn(metrics_mod.supervised(
                lambda: ledger_mod.run_auditor(
                    my_ident=self.connections.identity),
                "ledger-auditor"),
                name="ledger-auditor"),
        ]
        if self.config.bind_private:
            # heartbeat rides supervised(): a transient discovery outage
            # (store locked, network blip) must not fail-fast the whole
            # broker — readiness already degrades via note_discovery_probe,
            # each death lands in the supervised-tasks flight recorder, and
            # the task resumes once the store answers again
            self._tasks += [
                spawn(metrics_mod.supervised(
                    lambda: heartbeat_task.run_heartbeat_task(self),
                    "heartbeat"),
                    name="heartbeat"),
                spawn(sync_task.run_sync_task(self), name="sync"),
                spawn(listener_tasks.run_broker_listener_task(self),
                      name="broker-listener"),
            ]
        plane = self.device_plane
        if plane is not None and not plane.fails_open:
            # a plane on the card ends its pump with the exception of a
            # step that failed: the broker fails fast with it
            self._tasks.append(plane.pump_task)
        if self.shard_runtime is not None:
            self._tasks.append(spawn(self.shard_runtime.run_ring_drain(),
                                     name="shard-ring-drain"))
            bus = self.shard_runtime.bus
            if bus is not None and hasattr(bus, "run"):
                self._tasks.append(spawn(bus.run(), name="shard-bus"))

    async def run_until_failure(self) -> None:
        """Fail-fast: the first core task to exit brings the broker down
        (parity select! at lib.rs:302-318)."""
        await self.start()
        await self.wait_until_failure()

    async def wait_until_failure(self) -> None:
        """The supervision half of :meth:`run_until_failure`, for a caller
        that ran :meth:`start` itself (the broker binary reads the plane's
        warm-up in between)."""
        done, _pending = await asyncio.wait(
            self._tasks, return_when=asyncio.FIRST_COMPLETED)
        task = done.pop()
        exc = task.exception()
        await self.stop()
        if exc is not None:
            raise Error(ErrorKind.CONNECTION,
                        f"core task {task.get_name()!r} died: {exc!r}", exc)
        bail(ErrorKind.CONNECTION, f"core task {task.get_name()!r} exited")

    async def stop(self) -> None:
        # readiness flips false FIRST — before any listener closes — so a
        # prober sees "draining" rather than a connection refusal (only
        # the endpoint-owning broker touches the process-global latch)
        if self._metrics_server is not None:
            self.begin_drain("broker stop")
        self._stopped.set()
        if self.update_metrics in metrics_mod.PRE_RENDER_HOOKS:
            metrics_mod.PRE_RENDER_HOOKS.remove(self.update_metrics)
        if self.device_plane is not None:
            await self.device_plane.stop()
        for t in self._tasks:
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        self.connections.remove_all()
        if self.durable is not None:
            self.durable.close()
        if self.shard_runtime is not None:
            self.shard_runtime.close()
            self.shard_runtime = None
        for listener in (self.user_listener, self.broker_listener):
            if listener is not None:
                try:
                    await listener.close()
                except Exception:
                    pass
        self.listeners_bound = False
        if self.discovery is not None:
            await self.discovery.close()
        if self._metrics_server is not None:
            self._metrics_server.close()
            await self._metrics_server.wait_closed()
            self._metrics_server = None
            # leave the process-global registries clean for the next
            # owner (in-process restarts, test isolation)
            self.unregister_observability()
            health_mod.clear_draining()
        broker_metrics.NUM_USERS_CONNECTED.set(0)
        broker_metrics.NUM_BROKERS_CONNECTED.set(0)
        logger.info("broker %s stopped", self.identity)

    # -- convenience (used by tasks) ---------------------------------------

    def update_metrics(self) -> None:
        """Refresh the process-global gauges; runs on connection events
        AND as a metrics pre-render hook, so device-plane counters that
        move per pump step are current at scrape time without any
        hot-loop pushes."""
        broker_metrics.NUM_USERS_CONNECTED.set(self.connections.num_users)
        broker_metrics.NUM_BROKERS_CONNECTED.set(self.connections.num_brokers)
        plane = self.device_plane
        if plane is not None:
            broker_metrics.DEVICE_STEPS.set(plane.steps)
            broker_metrics.DEVICE_MESSAGES_ROUTED.set(plane.messages_routed)
