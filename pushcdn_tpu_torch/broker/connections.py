"""``Connections`` — the broker's entire routing state plane.

Capability parity with cdn-broker/src/connections/mod.rs:34-388 and
connections/broadcast/mod.rs:19-55:

- users map: ``UserPublicKey → (Connection, AbortOnDropHandle)``;
- brokers map: ``BrokerIdentifier → (Connection, AbortOnDropHandle)`` plus a
  per-peer ``TopicSyncMap`` tracking that peer's advertised topics;
- ``DirectMap``: the global "which broker owns this user" CRDT
  (``VersionedMap[UserPublicKey, str, str]``, connections/direct/mod.rs:14);
- ``BroadcastMap``: RelationalMaps for local users and peer brokers, our own
  ``TopicSyncMap`` advertisement, and previous-topic-set delta tracking;
- interest queries, sync generation/application, double-connect eviction
  ("user connected elsewhere", connections/mod.rs:154-162).

Locking: one ``asyncio`` world — Connections is only touched from the
broker's event loop, which gives the same "one RwLock" discipline as the
reference (cdn-broker/src/lib.rs:98) for free. Methods are synchronous;
I/O (closing evicted connections) is delegated to abort handles.

Broker identifiers are carried as **strings** (``BrokerIdentifier``'s
canonical "pub/priv" form) inside CRDT payloads so the codec stays scalar.
"""

from __future__ import annotations

import asyncio
import enum
import logging
import os
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Set, Tuple

from pushcdn_tpu_torch.broker.relational_map import RelationalMap
from pushcdn_tpu_torch.broker.versioned_map import VersionedMap
from pushcdn_tpu_torch.proto import ledger as ledger_mod
from pushcdn_tpu_torch.proto.transport.base import Connection
from pushcdn_tpu_torch.proto.util import AbortOnDropHandle, mnemonic

logger = logging.getLogger("pushcdn.broker")

UserPublicKey = bytes
Topic = int

# How long a migration-evicted user's connection stays in ``parting``
# (sendable for already-routed deliveries AND for late directs that
# raced the eviction — see route_direct's parting chase) before the
# deferred flush-and-FIN. Must cover the UserSync propagation skew
# between mesh peers: a publisher's broker keeps forwarding to the old
# home until the out-versioned DirectMap row reaches it, which under
# load can lag by hundreds of ms. Kept just under the client's own
# drain backstop (PUSHCDN_MIGRATE_DRAIN_S, default 2 s) so the broker
# FINs first and the client's drain ends on EOF, not on its timer.
PARTING_GRACE_S = float(os.environ.get("PUSHCDN_PARTING_GRACE_S",
                                       "1.5") or 1.5)


class SubscriptionStatus(enum.IntEnum):
    """Value type of the topic-sync CRDT (broadcast/mod.rs SubscriptionStatus)."""

    UNSUBSCRIBED = 0
    SUBSCRIBED = 1


@dataclass
class UserHandle:
    connection: Connection
    abort_handle: Optional[AbortOnDropHandle] = None


@dataclass
class BrokerHandle:
    connection: Connection
    abort_handle: Optional[AbortOnDropHandle] = None
    # That peer's advertised topic set, as a CRDT we merge TopicSync into
    # (per-broker TopicSyncMap, connections/mod.rs:40-53).
    topic_sync_map: VersionedMap = None


# Bound on the typed route-delta log (ISSUE 7). A consumer that falls
# further behind than this rebuilds from scratch (version gap) instead of
# the log growing without bound; sized so steady churn never trims a
# snapshot that refreshes once per plan call.
ROUTE_LOG_MAX = int(os.environ.get("PUSHCDN_ROUTE_LOG_MAX", "8192") or 8192)


class Connections:
    """All routing state for one broker."""

    def __init__(self, identity: str):
        # identity = our BrokerIdentifier in canonical string form
        self.identity = identity
        # optional observer (the broker's DevicePlane mirrors user slots /
        # topic masks on device); duck-typed: on_user_added(key, topics),
        # on_user_removed(key), on_subscription_changed(key, topics)
        self.observer = None
        self.users: Dict[UserPublicKey, UserHandle] = {}
        self.brokers: Dict[str, BrokerHandle] = {}
        # Migration evictions (ISSUE 12): a user whose UserSync merge says
        # it now lives elsewhere leaves ``users`` immediately (routing must
        # follow the new owner) but its connection lingers here so
        # deliveries ALREADY routed to it — this very batch's egress, a
        # sibling shard's in-flight ring record — still flush to the old
        # connection the client is draining. A deferred soft_close empties
        # the writer, FINs, and drops the entry after PARTING_GRACE_S.
        self.parting: Dict[UserPublicKey, Connection] = {}
        # user → owning-broker CRDT (DirectMap, connections/direct/mod.rs:14)
        self.direct_map: VersionedMap = VersionedMap(local_identity=identity)
        # topic interest indexes (BroadcastMap, broadcast/mod.rs:19-55)
        self.user_topics: RelationalMap = RelationalMap()    # user -> topics
        self.broker_topics: RelationalMap = RelationalMap()  # peer -> topics
        # our own advertised-topics CRDT + previous snapshot for deltas
        self.our_topic_map: VersionedMap = VersionedMap(local_identity=identity)
        self._previous_local_topics: Set[Topic] = set()
        # Bumped by every mutation that can change an interest query's
        # answer; receive loops' per-batch interest caches validate against
        # it so a subscribe/sync landing from ANOTHER task mid-batch (the
        # batch awaits on egress/device backpressure) invalidates the cache
        # the same way the reference's per-message query would see it.
        self.interest_version = 0
        # ---- sharded data plane (ISSUE 6) ----
        # This process may be one of N worker shards presenting as ONE
        # broker identity. Siblings' users/mesh links are tracked here so
        # routing (scalar and cut-through) can hand their fan-out to the
        # shard rings; all four stay empty (and cost nothing) at N == 1.
        self.num_shards = 1
        self.shard_id = 0
        self.remote_user_shard: Dict[UserPublicKey, int] = {}   # key -> shard
        self.remote_broker_shard: Dict[str, int] = {}           # ident -> shard
        # control-plane delta emitter (ShardRuntime installs it): every
        # local routing-state mutation is mirrored to sibling shards as a
        # versioned delta via the parent hub
        self.shard_notifier = None
        # ---- typed route-delta log (ISSUE 7) ----
        # Every interest/DirectMap mutation appends a typed record naming
        # the entity whose routing contribution may have changed:
        #   ("user", key)     membership / shard residency / topic set
        #   ("broker", ident) link / shard residency / advertised topics
        #   ("dmap", key)     DirectMap ownership entry
        # Consumers (cutthrough.RouteState) re-resolve each named entity
        # against CURRENT state, so application is order-insensitive and
        # O(dirty entities) — the incremental alternative to the
        # O(users + brokers + DirectMap) snapshot rebuild. Records are
        # sequence-numbered; a consumer whose cursor predates
        # ``route_log_start`` has a version gap and must rebuild.
        self.route_log: Deque[tuple] = deque()
        self.route_log_start = 0     # seq of route_log[0]
        self.route_log_next = 0      # seq the next record gets

    def _notify_shards(self, event: tuple) -> None:
        if self.shard_notifier is not None:
            self.shard_notifier(event)

    def _log_route(self, kind: str, ident) -> None:
        """Append one typed route delta (and trim the log to its bound)."""
        self.route_log.append((kind, ident))
        self.route_log_next += 1
        if len(self.route_log) > ROUTE_LOG_MAX:
            self.route_log.popleft()
            self.route_log_start += 1

    # ---- users ------------------------------------------------------------

    def add_user(self, public_key: UserPublicKey, connection: Connection,
                 topics: List[Topic],
                 abort_handle: Optional[AbortOnDropHandle] = None) -> None:
        """Register a user: evict any same-broker double-connect, claim the
        user in the DirectMap, and apply initial subscriptions
        (connections/mod.rs add_user)."""
        existing = self.users.pop(public_key, None)
        if existing is not None:
            logger.info("user %s reconnected here; evicting old connection",
                        mnemonic(public_key))
            self._teardown(existing, "evicted by reconnect")
            self.user_topics.remove_key(public_key)
        # a user migrating here from a sibling shard (REUSEPORT lands the
        # reconnect on a different worker) sheds its remote record; the
        # ``user`` delta below makes the old shard evict its stale conn
        if self.remote_user_shard.pop(public_key, None) is not None:
            self.user_topics.remove_key(public_key)
        # elastic re-home arrival (ISSUE 12): the DirectMap still naming
        # ANOTHER broker as owner means this user just migrated here — the
        # insert below out-versions that claim, and the next UserSync delta
        # makes the old home evict its half of the connection
        prev_owner = self.direct_map.get(public_key)
        self.interest_version += 1
        self.users[public_key] = UserHandle(connection, abort_handle)
        if topics:
            self.user_topics.associate_key_with_values(public_key, topics)
        self.direct_map.insert(public_key, self.identity)
        if prev_owner is not None and prev_owner != self.identity:
            connection.flightrec.record("migrate-in", f"from {prev_owner}")
        self._log_route("user", public_key)
        self._log_route("dmap", public_key)
        if self.observer is not None:
            self.observer.on_user_added(public_key, topics)
        self._notify_shards(("user", public_key, list(topics)))
        logger.info("user %s connected (topics=%s)", mnemonic(public_key), topics)

    def remove_user(self, public_key: UserPublicKey,
                    reason: str = "disconnected") -> None:
        handle = self.users.pop(public_key, None)
        if handle is None:
            return
        self.interest_version += 1
        if reason == "user connected elsewhere":
            # elastic re-home (ISSUE 12): flush-then-close, never abort —
            # the client is still draining this connection. The interest
            # rows survive until the parting grace expires (``_part``
            # returns True and owns the deferred cleanup), so LATE
            # broadcasts — routed here by peers whose TopicSync view of
            # the new home still lags — chase the parting connection
            # instead of dropping into a zero-home window.
            deferred = self._part(public_key, handle)
        else:
            self._teardown(handle, reason)
            deferred = False
        if not deferred:
            self.user_topics.remove_key(public_key)
            self._log_route("user", public_key)
        # Release our DirectMap claim only if we still hold it — a newer
        # claim by another broker must not be clobbered.
        self.direct_map.remove_if_equals(public_key, self.identity)
        self._log_route("dmap", public_key)
        if self.observer is not None:
            self.observer.on_user_removed(public_key)
        self._notify_shards(("user_del", public_key))
        logger.info("user %s removed: %s", mnemonic(public_key), reason)

    def has_user(self, public_key: UserPublicKey) -> bool:
        return public_key in self.users

    def get_user_connection(self, public_key: UserPublicKey) -> Optional[Connection]:
        h = self.users.get(public_key)
        if h is not None:
            return h.connection
        # send-time fallback for deliveries routed before a migration
        # eviction landed mid-batch (see ``parting``); new routing
        # decisions never reach here — the interest indexes and the
        # DirectMap already point at the new home
        return self.parting.get(public_key)

    def _part(self, public_key: UserPublicKey, handle) -> bool:
        """Move a migration-evicted user's connection into ``parting``:
        the receive loop is aborted now (nothing further is accepted from
        the old connection), queued deliveries keep flushing to it, and a
        deferred ``soft_close`` drains the writer, FINs, and forgets the
        entry. Without this the egress batch that carried the eviction's
        own UserSync drops every delivery it had already routed to the
        user — a real delivered-message loss window under migration.

        Returns True when the deferred close task was scheduled and owns
        the user's interest-row cleanup (the rows stay live through the
        grace so late-routed broadcasts still reach the parting
        connection); False when everything was torn down synchronously
        and the caller must clean up now."""
        rec = getattr(handle.connection, "flightrec", None)
        if rec is not None:
            # routine under elastic drain — recorded, not dumped
            rec.record("removed", "user connected elsewhere (parting)")
        if handle.abort_handle is not None:
            handle.abort_handle.abort()
        conn = handle.connection
        self.parting[public_key] = conn

        async def _close_later():
            try:
                await asyncio.sleep(PARTING_GRACE_S)
                # the grace is over: whatever the flush below cannot get
                # onto the wire is a counted parting-expiry loss, not a
                # generic teardown (ISSUE 20)
                conn.ledger_drop_reason = "parting_expiry"
                await conn.soft_close()
            finally:
                if self.parting.get(public_key) is conn:
                    del self.parting[public_key]
                    # deferred interest cleanup (see remove_user): the
                    # grace is over — unless the user reconnected HERE
                    # meanwhile (their rows are live again), drop them.
                    # A superseding _part re-entered via the dict guard
                    # above owns its own cleanup.
                    if public_key not in self.users:
                        self.interest_version += 1
                        self.user_topics.remove_key(public_key)
                        self._log_route("user", public_key)

        try:
            asyncio.get_running_loop().create_task(_close_later())
        except RuntimeError:  # no loop (teardown from sync context)
            self.parting.pop(public_key, None)
            conn.close()
            return False
        return True

    @property
    def num_users(self) -> int:
        return len(self.users)

    # ---- brokers ----------------------------------------------------------

    def add_broker(self, identifier: str, connection: Connection,
                   abort_handle: Optional[AbortOnDropHandle] = None) -> None:
        existing = self.brokers.pop(identifier, None)
        if existing is not None:
            logger.info("broker %s reconnected; evicting old link", identifier)
            self._teardown(existing, "evicted by reconnect")
            self.broker_topics.remove_key(identifier)
        self.interest_version += 1
        self.remote_broker_shard.pop(identifier, None)  # now a live link
        # mesh links tag their connection for the conservation ledger:
        # writer dequeues on this link count relayed/mesh, not delivered —
        # and a (re)formed link opens a fresh per-link conservation epoch
        connection.ledger_peer = identifier
        ledger_mod.reset_link(identifier)
        self.brokers[identifier] = BrokerHandle(
            connection, abort_handle,
            topic_sync_map=VersionedMap(local_identity=identifier))
        # the new link also makes DirectMap entries owned by this peer
        # resolvable — RouteState's owner index re-resolves them off this
        # one record
        self._log_route("broker", identifier)
        self._notify_shards(("mesh_topics", identifier, []))
        logger.info("broker %s connected", identifier)

    def remove_broker(self, identifier: str, reason: str = "disconnected") -> None:
        handle = self.brokers.pop(identifier, None)
        if handle is None:
            return
        self._teardown(handle, reason)
        self.interest_version += 1
        self.broker_topics.remove_key(identifier)
        # Forget (locally, without tombstoning) every user the dead peer
        # owned — they will re-appear when they reconnect elsewhere
        # (remove_by_value_no_modify, versioned_map.rs).
        dropped = self.direct_map.remove_by_value_no_modify(identifier)
        self._log_route("broker", identifier)
        # per-dropped-key records, proportional to the actual forget work
        # (a mass drop that outruns the log bound falls back to a rebuild)
        for key in dropped:
            self._log_route("dmap", key)
        self._notify_shards(("mesh_broker_del", identifier))
        logger.info("broker %s removed (%s); forgot %d routed users",
                    identifier, reason, len(dropped))

    def has_broker(self, identifier: str) -> bool:
        return identifier in self.brokers

    def get_broker_connection(self, identifier: str) -> Optional[Connection]:
        h = self.brokers.get(identifier)
        return None if h is None else h.connection

    def all_broker_identifiers(self) -> List[str]:
        return list(self.brokers.keys())

    @property
    def num_brokers(self) -> int:
        return len(self.brokers)

    # ---- subscriptions ----------------------------------------------------

    def subscribe_user_to(self, public_key: UserPublicKey,
                          topics: List[Topic]) -> None:
        if public_key in self.users and topics:
            self.interest_version += 1
            self.users[public_key].connection.flightrec.record(
                "subscribe", topics)
            self.user_topics.associate_key_with_values(public_key, topics)
            self._log_route("user", public_key)
            if self.observer is not None:
                self.observer.on_subscription_changed(
                    public_key, self.user_topics.get_values_of_key(public_key))
            self._notify_shards((
                "user", public_key,
                list(self.user_topics.get_values_of_key(public_key))))

    def unsubscribe_user_from(self, public_key: UserPublicKey,
                              topics: List[Topic]) -> None:
        if topics:
            self.interest_version += 1
            handle = self.users.get(public_key)
            if handle is not None:
                handle.connection.flightrec.record("unsubscribe", topics)
            self.user_topics.dissociate_key_from_values(public_key, topics)
            self._log_route("user", public_key)
            if self.observer is not None:
                self.observer.on_subscription_changed(
                    public_key, self.user_topics.get_values_of_key(public_key))
            if handle is not None:
                self._notify_shards((
                    "user", public_key,
                    list(self.user_topics.get_values_of_key(public_key))))

    def subscribe_broker_to(self, identifier: str, topics: List[Topic]) -> None:
        if identifier in self.brokers and topics:
            self.interest_version += 1
            self.broker_topics.associate_key_with_values(identifier, topics)
            self._log_route("broker", identifier)

    def unsubscribe_broker_from(self, identifier: str,
                                topics: List[Topic]) -> None:
        if topics:
            self.interest_version += 1
            self.broker_topics.dissociate_key_from_values(identifier, topics)
            self._log_route("broker", identifier)

    # ---- sibling-shard delta application (ISSUE 6) -------------------------
    # Called by ShardRuntime.apply_event with state relayed from sibling
    # worker processes; these never re-emit to the shard bus (the parent
    # hub already fans deltas to every other worker).

    def add_remote_user_interest(self, public_key: UserPublicKey,
                                 shard: int, topics: List[Topic]) -> None:
        """ADDITIVE sibling-shard interest row (durable replay handover,
        ISSUE 14): the owner shard applying a ``durable_sub`` must see the
        user's interest BEFORE it snapshots the retention ring, ahead of
        the authoritative full-list "user" delta still in flight on the
        bus. Unlike :meth:`set_remote_user` this never clears existing
        associations (that would open a drop window for the user's other
        topics) and never evicts a local connection. A local user takes
        the ordinary subscribe path instead."""
        if public_key in self.users:
            self.subscribe_user_to(public_key, list(topics))
            return
        if not topics:
            return
        self.interest_version += 1
        self.remote_user_shard.setdefault(public_key, shard)
        self.user_topics.associate_key_with_values(public_key, list(topics))
        if self.shard_id == 0:
            self.direct_map.insert(public_key, self.identity)
            self._log_route("dmap", public_key)
        self._log_route("user", public_key)

    def set_remote_user(self, public_key: UserPublicKey, shard: int,
                        topics: List[Topic]) -> None:
        """A sibling shard owns (or re-announced) this user. Evicts any
        local connection for the same key — the cross-shard flavor of the
        double-connect kick (the user reconnected and SO_REUSEPORT landed
        them on another worker)."""
        if public_key in self.users:
            logger.info("user %s connected on shard %d; evicting local",
                        mnemonic(public_key), shard)
            self.remove_user(public_key,
                             reason=f"user connected on shard {shard}")
        self.interest_version += 1
        self.remote_user_shard[public_key] = shard
        self.user_topics.remove_key(public_key)
        if topics:
            self.user_topics.associate_key_with_values(public_key,
                                                       list(topics))
        if self.shard_id == 0:
            # shard 0 fronts the mesh: its DirectMap replica must claim
            # every shard's users so UserSync advertises the whole box
            self.direct_map.insert(public_key, self.identity)
        self._log_route("user", public_key)
        self._log_route("dmap", public_key)

    def remove_remote_user(self, public_key: UserPublicKey,
                           shard: int) -> None:
        """Sibling user disconnect. ``shard`` guards against reorder with
        a migration: a del from the OLD shard must not clobber the record
        the NEW shard's announcement just installed."""
        if self.remote_user_shard.get(public_key) != shard:
            return
        self.interest_version += 1
        del self.remote_user_shard[public_key]
        self.user_topics.remove_key(public_key)
        if self.shard_id == 0:
            self.direct_map.remove_if_equals(public_key, self.identity)
        self._log_route("user", public_key)
        self._log_route("dmap", public_key)

    def set_remote_broker(self, identifier: str, shard: int,
                          topics: List[Topic]) -> None:
        """Shard ``shard`` (0 — the mesh owner) holds a live link to this
        peer broker; record its advertised topics so broadcasts here plan
        fan-out through the ring to the link-owning shard."""
        if identifier in self.brokers:
            return  # we hold the live link ourselves
        self.interest_version += 1
        self.remote_broker_shard[identifier] = shard
        self.broker_topics.remove_key(identifier)
        if topics:
            self.broker_topics.associate_key_with_values(identifier,
                                                         list(topics))
        self._log_route("broker", identifier)

    def remove_remote_broker(self, identifier: str) -> None:
        self.interest_version += 1
        self.remote_broker_shard.pop(identifier, None)
        self.broker_topics.remove_key(identifier)
        # same local forget as remove_broker: users the dead peer owned
        # reappear when they reconnect elsewhere. The dropped claims get
        # per-key records — the peer may ALSO hold a live local link (no
        # slot transition for the owner index to re-resolve through)
        dropped = self.direct_map.remove_by_value_no_modify(identifier)
        self._log_route("broker", identifier)
        for key in dropped:
            self._log_route("dmap", key)

    @property
    def num_users_global(self) -> int:
        """Users across ALL shards of this broker (what shard 0 reports
        to discovery so the marshal's load balancing sees the box)."""
        return len(self.users) + len(self.remote_user_shard)

    # ---- routing queries --------------------------------------------------

    def get_broker_identifier_of_user(self,
                                      public_key: UserPublicKey) -> Optional[str]:
        """DirectMap lookup (connections/mod.rs:69)."""
        return self.direct_map.get(public_key)

    def get_interested_by_topic(self, topics: List[Topic], to_users_only: bool
                                ) -> Tuple[List[UserPublicKey], List[str]]:
        """Who should receive a broadcast on ``topics``
        (connections/mod.rs:94-124). ``to_users_only=True`` is the
        loop-prevention rule for broker-originated broadcasts."""
        users = list(self.user_topics.get_keys_by_values(topics))
        if to_users_only:
            return users, []
        return users, list(self.broker_topics.get_keys_by_values(topics))

    # ---- sync generation (parity tasks/broker/sync.rs + mod.rs:205-237) ---

    def get_full_user_sync(self) -> bytes:
        return VersionedMap.serialize_entries(self.direct_map.full())

    def get_partial_user_sync(self) -> Optional[bytes]:
        delta = self.direct_map.diff()
        if not delta:
            return None
        return VersionedMap.serialize_entries(delta)

    def _refresh_our_topics(self) -> None:
        """Fold the current local-interest topic set into our topic CRDT
        (set-difference vs previous snapshot, connections/mod.rs:205-237)."""
        current: Set[Topic] = set(self.user_topics.values())
        for t in current - self._previous_local_topics:
            self.our_topic_map.insert(t, int(SubscriptionStatus.SUBSCRIBED))
        for t in self._previous_local_topics - current:
            self.our_topic_map.insert(t, int(SubscriptionStatus.UNSUBSCRIBED))
        self._previous_local_topics = current

    def get_full_topic_sync(self) -> bytes:
        self._refresh_our_topics()
        return VersionedMap.serialize_entries(self.our_topic_map.full())

    def get_partial_topic_sync(self) -> Optional[bytes]:
        self._refresh_our_topics()
        delta = self.our_topic_map.diff()
        if not delta:
            return None
        return VersionedMap.serialize_entries(delta)

    # ---- sync application -------------------------------------------------

    def apply_user_sync(self, payload,
                        from_sibling: bool = False) -> List[UserPublicKey]:
        """Merge a peer's DirectMap delta. Returns local users to EVICT
        because the merge says they are now owned elsewhere — the
        double-connect kick across brokers (connections/mod.rs:154-162).

        ``from_sibling=True`` marks a payload relayed by a sibling shard
        (the mesh links live on shard 0; it forwards every merge): applied
        identically but not re-emitted to the shard bus."""
        incoming = VersionedMap.deserialize_entries(payload)
        changed = self.direct_map.merge(incoming)
        if changed:
            # DirectMap mutations change Direct-routing answers: bump the
            # version so route snapshots (cut-through plan tables, batch
            # interest caches) can't serve a pre-merge owner. The scalar
            # interest caches key only on topic queries, which a DirectMap
            # merge can't affect, so the extra bump is conservative there.
            self.interest_version += 1
            if not from_sibling:
                self._notify_shards(("usersync", bytes(payload)))
        evict: List[UserPublicKey] = []
        for key, _old, new in changed:
            self._log_route("dmap", key)
            if new is not None and new != self.identity and key in self.users:
                evict.append(key)
            if new is not None and new != self.identity:
                # a user the mesh now places on ANOTHER broker can't be a
                # sibling-shard resident either: drop the stale record so
                # routing stops ring-forwarding to a shard that lost it
                if self.remote_user_shard.pop(key, None) is not None:
                    self.user_topics.remove_key(key)
                    self._log_route("user", key)
        for key in evict:
            logger.info("user %s connected elsewhere (%s); evicting",
                        mnemonic(key), self.direct_map.get(key))
            self.remove_user(key, reason="user connected elsewhere")
        return evict

    def apply_topic_sync(self, from_broker: str, payload) -> None:
        """Merge a peer's advertised-topic delta into its per-broker map and
        mirror the result into the broker interest index
        (connections/mod.rs:165-191)."""
        handle = self.brokers.get(from_broker)
        if handle is None:
            return
        handle.connection.flightrec.record("topic-sync",
                                           f"{len(payload)} B")
        incoming = VersionedMap.deserialize_entries(payload)
        changed = handle.topic_sync_map.merge(incoming)
        for topic, _old, new in changed:
            if new == int(SubscriptionStatus.SUBSCRIBED):
                self.subscribe_broker_to(from_broker, [int(topic)])
            else:
                self.unsubscribe_broker_from(from_broker, [int(topic)])
        if changed:
            self._notify_shards((
                "mesh_topics", from_broker,
                list(self.broker_topics.get_values_of_key(from_broker))))

    # ---- teardown ---------------------------------------------------------

    # removal reasons that mean "something went wrong" — they arm the
    # connection's flight recorder so its trail hits the diagnostics log
    _ABNORMAL_REASONS = frozenset(
        ("send failed", "user connected elsewhere"))

    @classmethod
    def _teardown(cls, handle, reason: str = "disconnected") -> None:
        rec = getattr(handle.connection, "flightrec", None)
        if rec is not None:
            rec.record("removed", reason,
                       abnormal=reason in cls._ABNORMAL_REASONS)
            rec.maybe_dump(reason)
        if reason == "send failed":
            # failure-is-removal: frames the writer drains now take the
            # send_failed fate, not the generic teardown one (ISSUE 20)
            handle.connection.ledger_drop_reason = "send_failed"
        if handle.abort_handle is not None:
            handle.abort_handle.abort()
        try:
            handle.connection.close()
        except Exception:
            pass

    def remove_all(self) -> None:
        for key in list(self.users):
            self.remove_user(key, "broker shutdown")
        for ident in list(self.brokers):
            self.remove_broker(ident, "broker shutdown")
        for conn in self.parting.values():
            conn.close()  # shutdown outruns the deferred soft_close
        self.parting.clear()
