"""State sync / anti-entropy.

Capability parity with cdn-broker/src/tasks/broker/sync.rs:24-145: every
sync interval (10 s default) broadcast ``diff()``-based partial user + topic
syncs to all peers; on a new peer link, send **full** syncs. The CRDT delta
is serialized by the versioned-map codec and nested inside the
``UserSync``/``TopicSync`` message envelope (the reference nests rkyv inside
capnp the same way).
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING, Optional

from pushcdn_tpu_torch.broker.tasks.senders import try_send_to_broker, try_send_to_brokers
from pushcdn_tpu_torch.proto import ledger as ledger_mod
from pushcdn_tpu_torch.proto.limiter import Bytes
from pushcdn_tpu_torch.proto.message import LedgerSync, TopicSync, UserSync, serialize

if TYPE_CHECKING:
    from pushcdn_tpu_torch.broker.broker import Broker

logger = logging.getLogger("pushcdn.broker")


def _frame(message) -> Bytes:
    """Serialize a sync message into an unpooled Bytes frame (control-plane
    traffic doesn't draw from the user byte pool)."""
    return Bytes(serialize(message))


async def partial_user_sync(broker: "Broker") -> None:
    payload = broker.connections.get_partial_user_sync()
    if payload is None:
        return
    raw = _frame(UserSync(payload=payload))
    await try_send_to_brokers(broker, broker.connections.all_broker_identifiers(), raw)
    raw.release()


async def partial_topic_sync(broker: "Broker") -> None:
    payload = broker.connections.get_partial_topic_sync()
    if payload is None:
        return
    raw = _frame(TopicSync(payload=payload))
    await try_send_to_brokers(broker, broker.connections.all_broker_identifiers(), raw)
    raw.release()


async def full_user_sync(broker: "Broker", peer: str) -> None:
    """Full DirectMap snapshot to one (new) peer (sync.rs:49-104)."""
    raw = _frame(UserSync(payload=broker.connections.get_full_user_sync()))
    await try_send_to_broker(broker, peer, raw)
    raw.release()


async def full_topic_sync(broker: "Broker", peer: str) -> None:
    raw = _frame(TopicSync(payload=broker.connections.get_full_topic_sync()))
    await try_send_to_broker(broker, peer, raw)
    raw.release()


async def ledger_sync(broker: "Broker") -> None:
    """Broadcast this process's conservation balance sheet (ISSUE 20):
    monotone per-link sent/received counters + fate totals, as an opaque
    JSON ``LedgerSync``. Snapshot-sized and interval-paced — no
    per-frame wire overhead."""
    if not ledger_mod.LEDGER.enabled:
        return
    import json
    sheet = ledger_mod.LEDGER.sheet(broker.connections.identity)
    raw = _frame(LedgerSync(payload=json.dumps(sheet).encode()))
    await try_send_to_brokers(broker, broker.connections.all_broker_identifiers(), raw)
    raw.release()


async def run_sync_task(broker: "Broker") -> None:
    """Periodic partial syncs to every peer (sync.rs:129-145)."""
    while True:
        await asyncio.sleep(broker.config.sync_interval_s)
        await partial_user_sync(broker)
        await partial_topic_sync(broker)
        await ledger_sync(broker)
