"""Whitelist enforcement task.

Capability parity with cdn-broker/src/tasks/broker/whitelist.rs:19-44:
every whitelist interval (60 s default) re-check every connected user
against the discovery whitelist and kick anyone who has been removed.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING

from pushcdn_tpu_torch.proto.util import mnemonic

if TYPE_CHECKING:
    from pushcdn_tpu_torch.broker.broker import Broker

logger = logging.getLogger("pushcdn.broker")


async def whitelist_once(broker: "Broker") -> None:
    for public_key in list(broker.connections.users.keys()):
        if not await broker.discovery.check_whitelist(public_key):
            logger.info("user %s no longer whitelisted; kicking",
                        mnemonic(public_key))
            broker.connections.remove_user(public_key,
                                           reason="removed from whitelist")
    broker.update_metrics()


async def run_whitelist_task(broker: "Broker") -> None:
    while True:
        await asyncio.sleep(broker.config.whitelist_interval_s)
        await whitelist_once(broker)
