"""Heartbeat + mesh formation.

Capability parity with cdn-broker/src/tasks/broker/heartbeat.rs:28-109:
every heartbeat interval (10 s default), publish our user count to
discovery with the membership TTL (60 s), fetch the peer set, and dial any
live peer we aren't connected to — but only when ``peer ≥ self`` in the
identifier total order, so each unordered pair is dialed from exactly one
side (heartbeat.rs:69-73). The candidate list is shuffled to avoid
lockstep connection storms (heartbeat.rs:77).

The mesh self-heals through this task: a dead link is removed by the
senders/receive loops, and the next tick re-dials (SURVEY.md §5).
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import TYPE_CHECKING

from pushcdn_tpu_torch.broker.tasks.listeners import handle_broker_connection

if TYPE_CHECKING:
    from pushcdn_tpu_torch.broker.broker import Broker

logger = logging.getLogger("pushcdn.broker")


async def _dial(broker: "Broker", peer) -> None:
    peer_id = str(peer)
    try:
        connection = await broker.run_def.broker_def.protocol.connect(
            peer.private_advertise_endpoint, limiter=broker.limiter)
        await handle_broker_connection(broker, connection, outbound=True)
    except Exception as exc:
        logger.info("dial to broker %s failed: %r", peer_id, exc)
    finally:
        broker.seen_dialing.discard(peer_id)


async def heartbeat_once(broker: "Broker") -> None:
    if broker.draining:
        # elastic drain (ISSUE 12): a draining broker must leave placement
        # rotation immediately, not age out after the membership TTL — and
        # a heartbeat here would re-insert the row deregister just removed
        try:
            await broker.discovery.deregister()
        except Exception as exc:
            broker.note_discovery_probe(False, f"deregister failed: {exc!r}")
            raise
        broker.note_discovery_probe(True, "draining: deregistered")
        return
    # every heartbeat IS a discovery-store probe: report the outcome to
    # the readiness plane so /readyz's cached-TTL check stays fresh for
    # free in steady state (ISSUE 5)
    try:
        # num_users_global: on a sharded broker, shard 0 heartbeats for the
        # whole box (the marshal's load balancing must see every worker's
        # users, not just shard 0's)
        await broker.discovery.perform_heartbeat(
            broker.connections.num_users_global,
            broker.config.membership_ttl_s)
    except Exception as exc:
        broker.note_discovery_probe(False, f"heartbeat failed: {exc!r}")
        raise
    broker.note_discovery_probe(True, "heartbeat ok")
    if not broker.config.form_mesh:
        # device-mesh-only inter-broker plane: skip host dialing only while
        # the mesh plane actually covers ALL inter-broker traffic. Fail open
        # to host links when (a) there is no broker-covering plane, (b) the
        # plane disabled itself, or (c) overflow traffic exists that the
        # plane can't carry (oversized frames, out-of-range topics,
        # unmirrored users, out-of-group recipients) — that traffic rides
        # host links, so without them it would be silently lost.
        plane = broker.device_plane
        covers = plane is not None and getattr(plane, "covers_brokers", False)
        if covers and not plane.disabled and not plane.overflow_seen:
            return
        if plane is not None and (plane.disabled or plane.overflow_seen):
            state = "disabled" if plane.disabled else "has overflow traffic"
            if getattr(broker, "_fail_open_logged", None) != state:
                broker._fail_open_logged = state  # log each state change
                logger.warning(                   # once, not every tick
                    "device plane %s; enabling host mesh dialing", state)
    peers = await broker.discovery.get_other_brokers()
    broker.last_peer_count = len(peers)  # the /readyz solo-vs-partitioned signal
    me = str(broker.identity)
    candidates = [
        p for p in peers
        if str(p) >= me                                    # pairwise dedup
        and not broker.connections.has_broker(str(p))      # not connected
        and str(p) not in broker.seen_dialing              # not mid-dial
    ]
    random.shuffle(candidates)  # avoid lockstep (heartbeat.rs:77)
    for peer in candidates:
        broker.seen_dialing.add(str(peer))
        asyncio.create_task(_dial(broker, peer))


async def run_heartbeat_task(broker: "Broker") -> None:
    while True:
        await heartbeat_once(broker)
        # sleep until the next tick — or earlier, if the device plane sees
        # overflow traffic and kicks us to form host links promptly
        try:
            async with asyncio.timeout(broker.config.heartbeat_interval_s):
                await broker.host_links_kick.wait()
            broker.host_links_kick.clear()
        except asyncio.TimeoutError:
            pass
