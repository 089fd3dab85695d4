"""Accept loops + connection handlers for users and peer brokers.

Capability parity with cdn-broker/src/tasks/user/listener.rs:22-46,
tasks/user/handler.rs:26-103, tasks/broker/listener.rs:22-46 and
tasks/broker/handler.rs:31-117: accept cheaply, finalize + authenticate in
a spawned per-connection task (so one slow handshake can't stall the accept
loop), register, spawn the receive loop, and — for new peer brokers — push
a **full** topic + user sync (handler.rs:98-117).
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING

from pushcdn_tpu_torch.broker.tasks import sync as sync_task
from pushcdn_tpu_torch.broker.tasks.handlers import broker_receive_loop, user_receive_loop
from pushcdn_tpu_torch.proto.auth import broker as broker_auth
from pushcdn_tpu_torch.proto.error import Error
from pushcdn_tpu_torch.proto.message import AuthenticateResponse
from pushcdn_tpu_torch.proto.util import AbortOnDropHandle, mnemonic

if TYPE_CHECKING:
    from pushcdn_tpu_torch.broker.broker import Broker

logger = logging.getLogger("pushcdn.broker")


# ---------------------------------------------------------------------------
# users (public side)
# ---------------------------------------------------------------------------

async def run_user_listener_task(broker: "Broker") -> None:
    while True:
        unfinalized = await broker.user_listener.accept()
        asyncio.create_task(handle_user_connection(broker, unfinalized))


async def handle_user_connection(broker: "Broker", unfinalized) -> None:
    """Finalize → permit auth (5 s) → topic prune → register + spawn receive
    loop (user/handler.rs:26-103)."""
    connection = None
    try:
        connection = await unfinalized.finalize(broker.limiter)
        # admission control (ISSUE 7): an over-budget connection is shed
        # BEFORE the auth handshake — no signature verify or discovery
        # round-trip spent on a connection we won't keep. The typed
        # refusal (permit=0 + reason) is what the client library surfaces
        # as Error(AUTHENTICATION) and re-load-balances on.
        adm = broker.admission
        shed = adm.admit_user() if adm is not None else None
        if shed is not None:
            connection.flightrec.record("load-shed", shed, abnormal=True)
            try:
                await connection.send_message(
                    AuthenticateResponse(permit=0, context=shed),
                    flush=True)
            except Exception:
                pass
            connection.close()
            return
        async with asyncio.timeout(broker.config.auth_timeout_s):
            public_key, topics = await broker_auth.verify_user(
                connection, broker.discovery, broker.identity)
        pruned, had_invalid = broker.run_def.topics.prune(topics)
        if had_invalid:
            # invalid topics at the handshake ⇒ reject the connection
            connection.close()
            return

        connection.flightrec.label += f" user={mnemonic(public_key)}"
        connection.flightrec.record("auth-ok", mnemonic(public_key))
        loop_task = asyncio.create_task(
            user_receive_loop(broker, public_key, connection))
        broker.connections.add_user(public_key, connection, pruned,
                                    AbortOnDropHandle(loop_task))
        broker.update_metrics()

        if broker.run_def.strong_consistency:
            # push partial syncs immediately so peers learn about this user
            # now rather than at the next 10 s tick (user/handler.rs:79-90,
            # the `strong-consistency` feature — broker default)
            await sync_task.partial_user_sync(broker)
            await sync_task.partial_topic_sync(broker)
    except (Error, asyncio.TimeoutError) as exc:
        logger.info("user connection failed auth: %r", exc)
        if connection is not None:
            # routine under connection storms: recorded (visible at
            # /debug/flightrec while the handle lives) but not dumped
            connection.flightrec.record("auth-fail", repr(exc))
            connection.close()
    except asyncio.CancelledError:
        if connection is not None:
            connection.close()
        raise


# ---------------------------------------------------------------------------
# brokers (private side)
# ---------------------------------------------------------------------------

async def run_broker_listener_task(broker: "Broker") -> None:
    while True:
        unfinalized = await broker.broker_listener.accept()
        asyncio.create_task(
            handle_broker_connection(broker, unfinalized, outbound=False))


async def handle_broker_connection(broker: "Broker", connection_or_unfinalized,
                                   outbound: bool) -> None:
    """Mutual auth (direction-ordered), register, spawn receive loop, then
    full sync to the new peer (broker/handler.rs:31-117).

    ``outbound=True``: we dialed (already-finalized connection);
    ``outbound=False``: accepted (unfinalized).
    """
    connection = None
    try:
        if outbound:
            connection = connection_or_unfinalized
        else:
            connection = await connection_or_unfinalized.finalize(broker.limiter)
            # broker-tier budget (inbound only — a link WE dialed was a
            # deliberate mesh decision): over budget, the link is closed
            # pre-auth; the dialer's next heartbeat retries
            adm = broker.admission
            shed = adm.admit_broker() if adm is not None else None
            if shed is not None:
                connection.flightrec.record("load-shed", shed,
                                            abnormal=True)
                logger.warning("inbound broker link refused: %s", shed)
                connection.close()
                return
        async with asyncio.timeout(broker.config.auth_timeout_s):
            if outbound:
                peer = await broker_auth.authenticate_as_dialer(
                    connection, broker.run_def.broker_def.scheme,
                    broker.config.keypair, broker.identity)
            else:
                peer = await broker_auth.authenticate_as_listener(
                    connection, broker.run_def.broker_def.scheme,
                    broker.config.keypair, broker.identity)
        peer_id = str(peer)
        if peer_id == broker.connections.identity:
            connection.close()
            return

        connection.flightrec.label += f" broker={peer_id}"
        connection.flightrec.record("auth-ok", peer_id)
        loop_task = asyncio.create_task(
            broker_receive_loop(broker, peer_id, connection))
        broker.connections.add_broker(peer_id, connection,
                                      AbortOnDropHandle(loop_task))
        broker.update_metrics()
        logger.info("broker link %s established (%s)",
                    peer_id, "outbound" if outbound else "inbound")

        # Initial FULL sync so the newcomer converges instantly
        # (broker/handler.rs:98-117).
        await sync_task.full_topic_sync(broker, peer_id)
        await sync_task.full_user_sync(broker, peer_id)
    except (Error, asyncio.TimeoutError) as exc:
        logger.info("broker link failed auth: %r", exc)
        if connection is not None:
            connection.close()
    except asyncio.CancelledError:
        if connection is not None:
            connection.close()
        raise
