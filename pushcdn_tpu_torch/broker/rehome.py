"""Active user re-homing for elastic drain.

A draining broker does not abandon its users to an emergent reconnect
scramble — it plans the migration (the "RPC Considered Harmful" /
DMA-handoff lesson: batch the control work, keep the data plane moving):

1. leave placement rotation NOW: ``discovery.deregister()`` (the
   heartbeat task keeps re-deregistering while ``broker.draining``);
2. for each connected user, pick the least-loaded live peer (every
   issued permit counts toward that peer's load in
   ``get_with_least_connections``, so a mass drain spreads itself
   across the survivors instead of dog-piling one), pre-issue a permit
   bound to that peer, and send a typed :class:`Migrate` frame on the
   ordered egress path — after everything already queued for the user;
3. the client dials the target directly with the pre-issued permit (no
   per-connection marshal round-trip); the target's ``add_user`` claims
   the user in the DirectMap, the strong-consistency partial UserSync
   propagates the eviction row, and THIS broker's merge handler kicks
   the old connection ("user connected elsewhere") — in-flight directs
   chase the user to the new home through the same CRDT row.

The old connection is deliberately NOT closed here (make-before-break):
closing would release our DirectMap claim before the target claims it,
opening a zero-home window for mid-migration directs. Flight-recorder
trail: ``migrate-out`` here at send, ``migrate-in`` on the target at
``add_user``.

Sharded brokers: every worker re-homes its own shard's users (each has
its own discovery client); ``deregister`` is idempotent across workers.

The port's copy of ``pushcdn_tpu.broker.rehome``. On a broker with a
device plane nothing here touches the card: a migrated user's slot is
released through the plane's ordinary ``remove_user`` path.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING

from pushcdn_tpu_torch.proto.auth.marshal import PERMIT_EXPIRY_S
from pushcdn_tpu_torch.proto.error import Error
from pushcdn_tpu_torch.proto.message import Migrate
from pushcdn_tpu_torch.proto.util import mnemonic

if TYPE_CHECKING:
    from pushcdn_tpu_torch.broker.broker import Broker

logger = logging.getLogger("pushcdn.broker")


async def rehome_users(broker: "Broker", wait_s: float = 0.0) -> dict:
    """Signal every connected user to migrate; returns a summary dict
    (``users``/``signaled``/``orphaned``/``remaining``). ``wait_s > 0``
    polls for the UserSync evictions to land before reporting
    ``remaining`` (users still attached here)."""
    broker.draining = True
    try:
        await broker.discovery.deregister()
    except Exception as exc:  # a locked store must not abort the drain
        logger.warning("drain deregister failed: %r", exc)

    conns = broker.connections
    keys = list(conns.users.keys())
    signaled = 0
    no_target = False
    for key in keys:
        handle = conns.users.get(key)
        if handle is None:
            continue  # disconnected while we were draining
        try:
            target = await broker.discovery.get_with_least_connections()
        except Error:
            # no live peers: the remaining users stay attached until the
            # process exits, then reconnect through the marshal's backoff
            no_target = True
            break
        try:
            permit = await broker.discovery.issue_permit(
                target, PERMIT_EXPIRY_S, key)
        except Exception as exc:
            logger.warning("drain permit issue failed for %s: %r",
                           mnemonic(key), exc)
            continue
        endpoint = target.public_advertise_endpoint
        try:
            handle.connection.flightrec.record("migrate-out",
                                               f"to {endpoint}")
            await handle.connection.send_message(
                Migrate(target=endpoint, permit=permit), flush=True)
            signaled += 1
        except Exception as exc:
            logger.info("migrate signal to %s failed: %r",
                        mnemonic(key), exc)

    if wait_s > 0:
        deadline = asyncio.get_running_loop().time() + wait_s
        while conns.num_users > 0 \
                and asyncio.get_running_loop().time() < deadline:
            await asyncio.sleep(0.05)

    summary = {
        "users": len(keys),
        "signaled": signaled,
        "orphaned": len(keys) - signaled,
        "remaining": conns.num_users,
        "no_target": no_target,
    }
    logger.info("drain re-home: %s", summary)
    return summary
