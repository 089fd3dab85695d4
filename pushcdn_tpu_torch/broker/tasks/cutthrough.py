"""Cut-through routing plane: whole-``FrameChunk`` batches from socket to
egress without per-frame Python objects.

The transports deliver parse batches (``FrameChunk``) and egress is
vectorized, but the scalar receive loops in ``handlers.py`` peel one frame
at a time — recv → ``deserialize`` → hook → ``route_*`` — materializing a
message object per frame before ``EgressBatch`` re-batches on the way out.
This module closes that gap:

- a **route plan** in C++ (``native/route_plan.cpp`` via
  ``pushcdn_tpu_torch.native.routeplan``) scans a chunk's frame headers in
  place and matches them against a snapshot of the broker's routing state
  (interest bitmasks + DirectMap hash), returning per-peer fan-out index
  lists;
- the egress handoff is (buffer, offset, length) **slices of the pooled
  chunk**: a peer receiving a contiguous run of frames gets a zero-copy
  ``memoryview`` of the chunk (its wire framing is byte-identical to what
  arrived), with the chunk's pool permit transferred batch-wise via
  :class:`pushcdn_tpu_torch.proto.limiter.BytesLease`; non-contiguous
  fan-out gathers with one C call into one owned buffer;
- **control frames** (Subscribe/Sync/auth/malformed) stop the plan at
  their index and take the existing scalar semantics, then planning
  resumes against the (possibly rebuilt) snapshot — so batch-vs-scalar
  behavior is identical even for mixes like ``[Subscribe(t),
  Broadcast(t)]`` landing in one chunk.

The port's copy of ``pushcdn_tpu.broker.tasks.cutthrough``. Where this
loop runs the io_uring engine and ``PUSHCDN_PUMP`` is not ``off``, the
fused native pump (``proto.transport.pump``) plans a chunk and queues its
linked sends in one C call; the pairs it hands back take the per-peer
writers as before. On a broker of N worker shards (``broker.sharding``) the pairs
bound for a sibling shard's user or mesh link are collected per shard and
written to the shared-memory handoff ring as wire bytes with per-peer
index lists (``ShardRuntime.handoff_chunk``).

The scalar loops in ``handlers.py`` remain the correctness twin. Selection:
``PUSHCDN_ROUTE_CUTTHROUGH`` env (``auto``/``native``/``python``, with
``1``/``0`` aliases) sets :data:`ROUTE_IMPL`; ``auto`` engages the native
plane when the library compiles AND the connection is eligible (no device
plane — staged traffic already routes in batched device steps — and the
default no-op message hook; a real hook must see every message, so those
deployments stay scalar). Observability: ``cdn_route_batch_*`` counters
via ``/metrics``.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import time
from typing import TYPE_CHECKING, List, Optional

import numpy as np

from pushcdn_tpu_torch.broker.tasks.handlers import (
    EgressBatch,
    _ingress_class,
    route_broadcast,
    route_direct,
)
from pushcdn_tpu_torch.native import routeplan
from pushcdn_tpu_torch.proto import flowclass
from pushcdn_tpu_torch.proto import ledger as ledger_mod
from pushcdn_tpu_torch.proto import metrics as metrics_mod
from pushcdn_tpu_torch.proto import trace as trace_mod
from pushcdn_tpu_torch.proto.def_ import no_hook
from pushcdn_tpu_torch.proto.error import Error
from pushcdn_tpu_torch.proto.limiter import Bytes
from pushcdn_tpu_torch.proto.message import (
    Broadcast,
    Direct,
    LedgerSync,
    Subscribe,
    SubscribeFrom,
    TopicSync,
    Unsubscribe,
    UserSync,
    deserialize,
)
from pushcdn_tpu_torch.proto.transport.base import FrameChunk
from pushcdn_tpu_torch.proto.util import mnemonic

if TYPE_CHECKING:
    from pushcdn_tpu_torch.broker.broker import Broker

logger = logging.getLogger("pushcdn.broker")

# Routing implementation selector: "auto" (native cut-through when
# available and eligible), "native" (insist; still degrades with a
# warning if the library can't compile), "python" (scalar loops only).
_env = os.environ.get("PUSHCDN_ROUTE_CUTTHROUGH", "auto").strip().lower()
ROUTE_IMPL = {"1": "native", "0": "python", "true": "native",
              "false": "python", "": "auto"}.get(_env, _env)

_MODE_USER = 0    # user-origin: Direct anywhere, Broadcast users+brokers
_MODE_BROKER = 1  # broker-origin: local users only (loop prevention)

# Incremental route-state maintenance: Connections mutations
# append typed deltas to a bounded log, and _refresh applies the suffix
# IN PLACE to the native table (stored masks diffed, lazy-deleted index
# entries, tombstoned dmap) — O(delta), never O(users). "0" forces the
# rebuild-per-invalidation behavior (the churn bench's baseline twin;
# the churn guard below is only live in that mode).
_env_inc = os.environ.get("PUSHCDN_ROUTE_INCREMENTAL", "1").strip().lower()
ROUTE_INCREMENTAL = _env_inc not in ("0", "false", "off")

# Rebuild churn guard — DEMOTED to last resort: with incremental
# deltas an invalidation costs O(delta), so the guard only arms on the
# rebuild-per-invalidation baseline path (ROUTE_INCREMENTAL off), where a
# snapshot rebuild is still O(users + brokers + DirectMap entries). When
# the previous snapshot amortized over fewer than _REBUILD_MIN_FRAMES
# planned frames, the next _REBUILD_BACKOFF invalidations route scalar
# instead of paying another full rebuild — the scalar path is always
# correct, so the guard only trades speed.
_REBUILD_MIN_FRAMES = 64
_REBUILD_BACKOFF = 16

# Compaction policy (checked every _COMPACT_CHECK_EVERY delta batches):
# lazy deletion and blob appends accrue garbage the plan loop must skip;
# a full rebuild purges it once it outweighs the live state.
_COMPACT_CHECK_EVERY = 64

_ZERO_MASK = np.zeros(routeplan.MASK_WORDS, np.uint64)  # reused, read-only

_warned_unavailable = False


def _inc_class_counts(classes, lens, frames_row, bytes_row) -> None:
    """Fold one plan's per-frame class array into the cdn_class_*
    counters (vectorized — one bincount per plan call, not per frame)."""
    frames, nbytes = flowclass.bincount_classes(classes, lens)
    for c in range(flowclass.N_CLASSES):
        n = int(frames[c])
        if n:
            frames_row[c].inc(n)
            bytes_row[c].inc(int(nbytes[c]))


def _note_link_classes(ident: str, fc, idx) -> None:
    """Bump the per-link conservation `sent` table for one broker-bound
    pair group — per class, off the plan's per-frame class array
    (one bincount per pair group, not per frame)."""
    if not ledger_mod.LEDGER.enabled:
        return
    if fc is None:
        ledger_mod.note_link_sent(ident, flowclass.LIVE, len(idx))
        return
    fci = np.asarray(fc)[idx]
    counts = np.bincount(fci[fci < flowclass.N_CLASSES],
                         minlength=flowclass.N_CLASSES)
    for c in range(flowclass.N_CLASSES):
        n = int(counts[c])
        if n:
            ledger_mod.note_link_sent(ident, c, n)


def _note_fate_classes(fate: str, reason: str, fc, idx) -> None:
    """Per-class terminal fates for one dropped pair group (plan path)."""
    if not ledger_mod.LEDGER.enabled:
        return
    if fc is None:
        ledger_mod.record_fate(fate, reason, flowclass.LIVE, len(idx))
        return
    fci = np.asarray(fc)[idx]
    counts = np.bincount(np.minimum(fci, flowclass.N_CLASSES),
                         minlength=flowclass.N_CLASSES + 1)
    for c in range(flowclass.N_CLASSES):
        n = int(counts[c])
        if n:
            ledger_mod.record_fate(fate, reason, c, n)
    n = int(counts[flowclass.N_CLASSES])
    if n:  # CLASS_NONE / out-of-range frames still get their fate
        ledger_mod.record_fate(fate, reason, flowclass.CLASS_NONE, n)


def acquire(broker: "Broker", hook) -> Optional["RouteState"]:
    """The receive loops' entry: the broker's shared cut-through state, or
    None when the scalar path should run (implementation forced to python,
    native kernel unavailable, a non-default message hook, or a device
    plane owning the eligible traffic)."""
    global _warned_unavailable
    impl = ROUTE_IMPL
    if impl not in ("auto", "native"):
        return None
    if hook is not no_hook or broker.device_plane is not None:
        return None
    durable = broker.durable
    if durable is not None and durable.enabled \
            and broker.connections.num_shards > 1:
        # sharded durable topics route scalar: the owner shard's ordered
        # drainer pins the replay-vs-live handover, and a chunk plan's
        # egress would bypass it (unsharded durable brokers keep the
        # cut-through plane — the retention scan rides the plan seam)
        return None
    state = getattr(broker, "_route_state", None)
    if state is None:
        planner = routeplan.RoutePlanner.create()
        if planner is None:
            if impl == "native" and not _warned_unavailable:
                _warned_unavailable = True
                logger.warning("route cut-through requested but the native "
                               "kernel is unavailable; using scalar routing")
            return None
        state = RouteState(broker, planner)
        broker._route_state = state
    return state


class RouteState:
    """Shared per-broker snapshot + planner (both receive loops use it).

    The snapshot keys on ``Connections.interest_version``, which every
    routing-state mutation bumps (subscriptions, membership, DirectMap
    merges) — the same token the scalar path's per-batch interest caches
    validate against. The version is revalidated before EVERY plan call
    (egress awaits can park the drain while another task mutates routing
    state), so a stale snapshot can never route a frame the scalar
    path's per-message version check would have routed differently.

    Maintenance is INCREMENTAL: peers occupy stable SLOTS
    (free-listed; ``n_users``/``n_brokers`` passed to the native build are
    capacities), and ``_refresh`` applies the ``Connections.route_log``
    suffix in place — each typed record names an entity (user / broker /
    DirectMap key) that is re-resolved against CURRENT Connections state,
    so application is order-insensitive and O(dirty entities). Full
    rebuilds remain only as the fallback: first build, version gap (log
    trimmed past our cursor), delta overflow (suffix longer than a
    rebuild costs), slot-capacity growth, and periodic compaction (lazy
    deletions / dmap tombstones / blob garbage crossed the purge
    threshold) — each counted under
    ``cdn_route_table_rebuilds{reason=...}``.
    """

    __slots__ = ("broker", "planner", "version", "usable",
                 "user_cap", "user_slot", "slot_user", "user_free",
                 "user_shard",
                 "broker_cap", "broker_slot", "slot_broker", "broker_free",
                 "broker_shard",
                 "dmap_mirror", "owner_keys", "log_seq",
                 "deltas_applied", "rebuild_counts", "last_delta_apply_s",
                 "_applies_since_compact_check", "_rebuild_reason",
                 "_frames_since_rebuild", "_skip_rebuilds",
                 "built_at", "_pump_state", "_pump_off")

    def __init__(self, broker: "Broker", planner):
        self.broker = broker
        self.planner = planner
        self.version = -1
        # peer slot space: users [0, user_cap), brokers [user_cap,
        # user_cap + broker_cap). The planner only distinguishes users
        # (< n_users == user_cap) from brokers — sibling-shard users count
        # as users so broker-origin frames still reach them; per-slot
        # shard arrays say whether egress is local or rides the ring.
        self.user_cap = 0
        self.user_slot: dict = {}          # key -> slot
        self.slot_user: List[Optional[bytes]] = []
        self.user_free: List[int] = []
        self.user_shard: List[int] = []    # == conns.shard_id -> local
        self.broker_cap = 0
        self.broker_slot: dict = {}        # ident -> slot (0-based)
        self.slot_broker: List[Optional[str]] = []
        self.broker_free: List[int] = []
        self.broker_shard: List[Optional[int]] = []  # None -> local link
        # DirectMap mirror + owner inverse index: which snapshot keys an
        # owner's entries resolve through, so a mesh link flap re-resolves
        # exactly its own keys (never a full-map scan)
        self.dmap_mirror: dict = {}        # key bytes -> owner str
        self.owner_keys: dict = {}         # owner str -> set of key bytes
        self.log_seq = 0                   # route_log cursor (next unseen)
        self.deltas_applied = 0
        self.rebuild_counts: dict = {}
        self.last_delta_apply_s: Optional[float] = None
        self._applies_since_compact_check = 0
        self._rebuild_reason: Optional[str] = None
        self.usable = True
        # cold start counts as amortized: the first build must not arm
        # the churn backoff
        self._frames_since_rebuild = 1 << 30
        self._skip_rebuilds = 0
        self.built_at: Optional[float] = None  # monotonic, last rebuild
        # fused data-plane pump: PumpState on this loop's
        # uring engine, or None. _pump_off latches when the composition
        # can never engage (env off / asyncio io impl / lib missing);
        # a transient None (engine not up yet) keeps retrying.
        self._pump_state = None
        self._pump_off = False

    def summary(self) -> dict:
        """Operator-facing snapshot state for ``/debug/topology``."""
        conns = self.broker.connections
        return {
            "usable": self.usable,
            "incremental": ROUTE_INCREMENTAL,
            "snapshot_version": self.version,
            "interest_version": conns.interest_version,
            "snapshot_age_s": (round(time.monotonic() - self.built_at, 3)
                               if self.built_at is not None else None),
            "churn_guard_skips_left": self._skip_rebuilds,
            "frames_since_rebuild": min(self._frames_since_rebuild, 1 << 30),
            "snapshot_users": len(self.user_slot),
            "snapshot_brokers": len(self.broker_slot),
            "slot_capacity": {"users": self.user_cap,
                              "brokers": self.broker_cap},
            "deltas_applied": self.deltas_applied,
            "last_delta_apply_s": self.last_delta_apply_s,
            "delta_log": {"start": conns.route_log_start,
                          "next": conns.route_log_next,
                          "cursor": self.log_seq},
            "rebuilds": dict(self.rebuild_counts),
            "index": self.planner.stats() if self.usable else None,
            "pump": (self._pump_state.summary()
                     if self._pump_state is not None
                     and not self._pump_state.closed else None),
        }

    def _get_pump(self):
        """The fused pump for this loop's uring engine, engaging lazily
        (the engine exists only once a uring transport served a
        connection). Returns None when the composition cannot engage —
        every such call is counted by the pump module, never silent."""
        ps = self._pump_state
        if ps is not None:
            if not ps.closed:
                return ps
            self._pump_state = None  # engine died; it may come back
        if self._pump_off:
            return None
        from pushcdn_tpu_torch.proto.transport import pump as pump_mod
        ok, _why = pump_mod.resolve_pump()
        if not ok:
            # permanent for this process config: env off, io impl not
            # uring, or a native layer failed to build/probe
            self._pump_off = True
            return None
        from pushcdn_tpu_torch.proto.transport import uring as umod
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return None
        ent = umod.UringEngine._engines.get(id(loop))
        eng = ent[1] if ent is not None else None
        if eng is None or eng.closed:
            return None  # no engine on this loop (yet): plain cut-through
        ps = pump_mod.PumpState.create(eng, self.broker, owner=self)
        self._pump_state = ps  # None if another broker owns the engine
        if ps is None:
            self._pump_off = True
        return ps

    # -- snapshot ------------------------------------------------------------

    def _refresh(self) -> bool:
        conns = self.broker.connections
        if self.version == conns.interest_version and self.usable:
            return True
        if ROUTE_INCREMENTAL and self.usable and self.version >= 0:
            # incremental path: apply the route-log suffix in place
            if self.log_seq < conns.route_log_start:
                return self._storm_rebuild("version_gap")
            pending = list(itertools.islice(
                conns.route_log, self.log_seq - conns.route_log_start,
                None))
            # past this many dirty entities a rebuild is the cheaper
            # O(users) operation (and resets slot packing for free)
            threshold = max(256, (len(self.user_slot)
                                  + len(self.broker_slot)) // 2)
            if len(pending) > threshold:
                return self._storm_rebuild("delta_overflow")
            if self._apply_deltas(pending):
                self.version = conns.interest_version
                self.log_seq = conns.route_log_next
                self._applies_since_compact_check += 1
                if self._applies_since_compact_check \
                        >= _COMPACT_CHECK_EVERY:
                    self._applies_since_compact_check = 0
                    if self._needs_compaction():
                        return self._rebuild("compaction")
                return True
            return self._rebuild(self._rebuild_reason or "growth")
        # full-rebuild path: first build, incremental disabled, or the
        # previous build failed. Only HERE does the (demoted) churn guard
        # apply — the rebuild-per-invalidation baseline's backoff.
        if self._skip_rebuilds > 0:
            self._skip_rebuilds -= 1
            return False
        if self.version < 0:
            reason = "first_build"
        elif not self.usable:
            reason = "retry"
        else:
            reason = "incremental_disabled"
        return self._rebuild(reason)

    def _storm_rebuild(self, reason: str) -> bool:
        """Fallback rebuild for the two EXTERNALLY-DRIVEN reasons
        (version gap / delta overflow): unlike growth or compaction —
        which are self-limiting by construction (capacity headroom grows
        25% per rebuild; a rebuild zeroes the garbage counters) — these
        recur at whatever rate the outside churn sustains, so the
        demoted churn guard still throttles them as the last resort: a
        rebuild that never amortized (< _REBUILD_MIN_FRAMES planned
        since) sends the next _REBUILD_BACKOFF invalidations to the
        always-correct scalar path instead of paying back-to-back
        O(users) rebuilds that would stall the loop."""
        if self._skip_rebuilds > 0:
            self._skip_rebuilds -= 1
            return False
        return self._rebuild(reason)

    def _needs_compaction(self) -> bool:
        """Garbage-vs-live thresholds over the native occupancy counters:
        lazy-deleted / duplicated index entries, dmap tombstones, and
        key-blob garbage are all purged by one rebuild."""
        s = self.planner.stats()
        return (s["list_entries"] > 2 * s["live_subs"] + 1024
                or s["dmap_tombstones"] > s["dmap_live"] + 64
                or s["keys_blob_garbage"]
                > s["keys_blob_bytes"] // 2 + 4096)

    def _rebuild(self, reason: str) -> bool:
        """Full snapshot rebuild (the fallback + compactor). Slots are
        re-packed densely with free-list headroom so steady growth does
        not rebuild per connection."""
        conns = self.broker.connections
        local_users = list(conns.users.keys())
        # parting users keep their interest rows through the migration
        # grace (late-broadcast chase, see Connections.remove_user) —
        # keep their slots plannable across a rebuild too
        local_users += [k for k in conns.parting if k not in conns.users]
        remote_users = list(conns.remote_user_shard.keys())
        users = local_users + remote_users
        local_brokers = list(conns.brokers.keys())
        remote_brokers = [ident for ident in conns.remote_broker_shard
                          if ident not in conns.brokers]
        brokers = local_brokers + remote_brokers
        n_u, n_b = len(users), len(brokers)
        user_cap = max(16, n_u + max(n_u // 4, 64))
        broker_cap = max(8, n_b + max(n_b // 4, 16))
        peer_masks = np.zeros((user_cap + broker_cap, routeplan.MASK_WORDS),
                              np.uint64)
        local_shard = conns.shard_id
        slot_user: List[Optional[bytes]] = [None] * user_cap
        user_shard = [local_shard] * user_cap
        user_slot: dict = {}
        for i, key in enumerate(users):
            topics = conns.user_topics.get_values_of_key(key)
            if topics:
                peer_masks[i] = routeplan.topic_mask(topics)
            slot_user[i] = key
            user_slot[key] = i
            if i >= len(local_users):
                user_shard[i] = conns.remote_user_shard[key]
        slot_broker: List[Optional[str]] = [None] * broker_cap
        broker_shard: List[Optional[int]] = [None] * broker_cap
        broker_slot: dict = {}
        for j, ident in enumerate(brokers):
            topics = conns.broker_topics.get_values_of_key(ident)
            if topics:
                peer_masks[user_cap + j] = routeplan.topic_mask(topics)
            slot_broker[j] = ident
            broker_slot[ident] = j
            if j >= len(local_brokers):
                broker_shard[j] = conns.remote_broker_shard[ident]
        valid = routeplan.topic_mask(self.broker.run_def.topics.valid)
        identity = conns.identity
        dmap: dict = {}
        mirror: dict = {}
        owner_keys: dict = {}
        for key, owner in conns.direct_map.items():
            bkey = bytes(key)
            mirror[bkey] = owner
            if owner == identity:
                peer = user_slot.get(key)
            else:
                owner_keys.setdefault(owner, set()).add(bkey)
                b = broker_slot.get(owner)
                peer = None if b is None else user_cap + b
            if peer is not None:
                dmap[bkey] = peer
            # unresolvable owner (user/broker not connected): omitted — a
            # plan miss drops the frame, exactly like the scalar flush
            # finding no connection
        # sibling-shard users aren't in this worker's DirectMap replica
        # (only shard 0 mirrors the claims for the mesh) — add them so
        # Direct frames plan straight onto the ring
        for key in remote_users:
            dmap.setdefault(bytes(key), user_slot[key])
        dkeys = list(dmap.keys())
        owners = list(dmap.values())
        self.usable = self.planner.build(
            user_cap, broker_cap, valid, peer_masks, dkeys,
            np.asarray(owners, np.int32))
        if self.usable:
            # mirror the flow-class taxonomy into the native table so the
            # plan (and the fused pump) classes frames exactly like the
            # scalar senders; deployment config, so every rebuild restores
            # the same map
            self.planner.set_classes(flowclass.active_table())
            self.version = conns.interest_version
            self.log_seq = conns.route_log_next
            self.user_cap = user_cap
            self.user_slot = user_slot
            self.slot_user = slot_user
            self.user_free = list(range(user_cap - 1, n_u - 1, -1))
            self.user_shard = user_shard
            self.broker_cap = broker_cap
            self.broker_slot = broker_slot
            self.slot_broker = slot_broker
            self.broker_free = list(range(broker_cap - 1, n_b - 1, -1))
            self.broker_shard = broker_shard
            self.dmap_mirror = mirror
            self.owner_keys = owner_keys
            self._rebuild_reason = None
            self._applies_since_compact_check = 0
            self.built_at = time.monotonic()
            self.rebuild_counts[reason] = \
                self.rebuild_counts.get(reason, 0) + 1
            metrics_mod.ROUTE_TABLE_REBUILDS.labels(reason=reason).inc()
            if self._frames_since_rebuild < _REBUILD_MIN_FRAMES \
                    and (not ROUTE_INCREMENTAL
                         or reason in ("version_gap", "delta_overflow")):
                self._skip_rebuilds = _REBUILD_BACKOFF
            self._frames_since_rebuild = 0
        return self.usable

    def _resolve_dmap_peer(self, bkey: bytes, owner: Optional[str],
                           local_shard: int) -> Optional[int]:
        """Current peer slot a DirectMap key routes to, mirroring the
        rebuild's resolution rules exactly: the owner wins when resolvable
        (self -> the user's own slot, remote -> the owning broker's link
        slot), and a sibling-shard RESIDENT without a resolvable owner
        gets the membership-implied entry straight onto the ring."""
        if owner == self.broker.connections.identity:
            return self.user_slot.get(bkey)
        if owner is not None:
            b = self.broker_slot.get(owner)
            if b is not None:
                return self.user_cap + b
        slot = self.user_slot.get(bkey)
        if slot is not None and self.user_shard[slot] != local_shard:
            return slot
        return None

    def _apply_deltas(self, records: list) -> bool:
        """Apply one route-log suffix IN PLACE. Re-resolves every named
        entity against current Connections state (order-insensitive), then
        ships the whole batch to the native table in ONE call. Returns
        False when a rebuild is required (slot growth, native alloc
        failure) — ``_rebuild_reason`` says why."""
        conns = self.broker.connections
        t0 = time.perf_counter()
        dirty_users: set = set()
        dirty_brokers: set = set()
        dirty_keys: set = set()
        for kind, ident in records:
            if kind == "user":
                dirty_users.add(ident)
            elif kind == "broker":
                dirty_brokers.add(ident)
            else:
                dirty_keys.add(ident)
        upd_peers: List[int] = []
        upd_masks: List[np.ndarray] = []
        # brokers first: a link transition re-resolves exactly the keys
        # its DirectMap entries own (the owner inverse index)
        for ident in dirty_brokers:
            slot = self.broker_slot.get(ident)
            if ident in conns.brokers:
                shard: Optional[int] = None
            else:
                shard = conns.remote_broker_shard.get(ident)
                if shard is None:  # link gone everywhere: free the slot
                    if slot is not None:
                        del self.broker_slot[ident]
                        self.slot_broker[slot] = None
                        self.broker_shard[slot] = None
                        self.broker_free.append(slot)
                        upd_peers.append(self.user_cap + slot)
                        upd_masks.append(_ZERO_MASK)
                        dirty_keys.update(self.owner_keys.get(ident, ()))
                    continue
            if slot is None:
                if not self.broker_free:
                    self._rebuild_reason = "growth"
                    return False
                slot = self.broker_free.pop()
                self.broker_slot[ident] = slot
                self.slot_broker[slot] = ident
                dirty_keys.update(self.owner_keys.get(ident, ()))
            self.broker_shard[slot] = shard
            upd_peers.append(self.user_cap + slot)
            upd_masks.append(routeplan.topic_mask(
                conns.broker_topics.get_values_of_key(ident)))
        local_shard = conns.shard_id
        for key in dirty_users:
            slot = self.user_slot.get(key)
            if key in conns.users:
                shard = local_shard
            else:
                shard = conns.remote_user_shard.get(key)
            if shard is None:  # gone from every shard: free the slot
                if slot is not None:
                    del self.user_slot[key]
                    self.slot_user[slot] = None
                    self.user_free.append(slot)
                    upd_peers.append(slot)
                    upd_masks.append(_ZERO_MASK)
                    dirty_keys.add(key)
                continue
            if slot is None:
                if not self.user_free:
                    self._rebuild_reason = "growth"
                    return False
                slot = self.user_free.pop()
                self.user_slot[key] = slot
                self.slot_user[slot] = key
                dirty_keys.add(key)
            elif self.user_shard[slot] != shard:
                # residency flip: the membership-implied dmap entry may
                # appear/disappear with it
                dirty_keys.add(key)
            self.user_shard[slot] = shard
            upd_peers.append(slot)
            upd_masks.append(routeplan.topic_mask(
                conns.user_topics.get_values_of_key(key)))
        dkeys: List[bytes] = []
        downers: List[int] = []
        identity = conns.identity
        for key in dirty_keys:
            bkey = bytes(key)
            new_owner = conns.direct_map.get(key)
            old_owner = self.dmap_mirror.get(bkey)
            if old_owner != new_owner:
                if old_owner is not None and old_owner != identity:
                    keyset = self.owner_keys.get(old_owner)
                    if keyset is not None:
                        keyset.discard(bkey)
                        if not keyset:
                            del self.owner_keys[old_owner]
                if new_owner is None:
                    self.dmap_mirror.pop(bkey, None)
                else:
                    self.dmap_mirror[bkey] = new_owner
                    if new_owner != identity:
                        self.owner_keys.setdefault(new_owner,
                                                   set()).add(bkey)
            peer = self._resolve_dmap_peer(bkey, new_owner, local_shard)
            dkeys.append(bkey)
            downers.append(-1 if peer is None else peer)
        if upd_peers or dkeys:
            if not self.planner.apply(upd_peers, upd_masks, dkeys,
                                      downers):
                self._rebuild_reason = "retry"
                return False
        n = len(records)
        self.deltas_applied += n
        dt = time.perf_counter() - t0
        self.last_delta_apply_s = round(dt, 6)
        if n:
            metrics_mod.ROUTE_DELTAS_APPLIED.inc(n)
        metrics_mod.ROUTE_DELTA_APPLY_SECONDS.observe(dt)
        return True

    # -- egress --------------------------------------------------------------

    @staticmethod
    def _ledger_ingress_fold(fc, pos: int, consumed: int, buf,
                             offs, lens, peer) -> None:
        """Fold one plan call's consumed frames into the ledger's ingress
        (and, for a mesh link, per-link recv) tables — one bincount for
        the classed frames; routed-nowhere frames (out_class 255) resolve
        their wire class per frame so both link ends count identically,
        and take their terminal fate here (no_interest for a pruned-empty
        Broadcast, no_route for an unknown-recipient Direct)."""
        if not ledger_mod.LEDGER.enabled or not consumed:
            return
        fci = np.asarray(fc[pos:pos + consumed])
        counts = np.bincount(
            np.minimum(fci, flowclass.N_CLASSES),
            minlength=flowclass.N_CLASSES + 1)
        for c in range(flowclass.N_CLASSES):
            n = int(counts[c])
            if n:
                ledger_mod.note_ingress(c, n, peer)
        if int(counts[flowclass.N_CLASSES]):
            mv = memoryview(buf)
            for i in np.nonzero(fci >= flowclass.N_CLASSES)[0].tolist():
                j = pos + i
                data = mv[int(offs[j]):int(offs[j]) + int(lens[j])]
                cls = flowclass.frame_class(data)
                ledger_mod.note_ingress(cls, 1, peer)
                kind = data[0] if len(data) else 0
                reason = ("no_interest" if (kind & 0x7F) == 5
                          else "no_route")
                ledger_mod.record_fate("dropped", reason, cls)

    async def _send_plan(self, chunk: FrameChunk, offs: np.ndarray,
                         lens: np.ndarray, peers: np.ndarray,
                         frames: np.ndarray, fc=None) -> None:
        """Hand one plan's fan-out to the per-peer writers. Pairs arrive in
        frame order; a stable sort groups them per peer without disturbing
        per-(sender→receiver) frame order. Failure ⇒ removal, exactly like
        ``EgressBatch.flush``. ``fc`` is the plan's per-frame class array
        (absolute indices) — dir=out accounting happens here at the pair
        level, so the writer stamps below carry nframes=0/nbytes=0."""
        if len(peers) == 0:
            return
        if fc is not None:
            _inc_class_counts(fc[frames], lens[frames],
                              metrics_mod.CLASS_FRAMES_OUT,
                              metrics_mod.CLASS_BYTES_OUT)
        broker = self.broker
        # Phase 1 — SYNCHRONOUS build: resolve peer indices against the
        # snapshot lists and assemble every per-peer stream before any
        # await. The pair arrays are views into the planner's shared
        # scratch and the index→key lists are replaced on rebuild; a
        # concurrent drain (another connection's receive loop running
        # during a send await) may re-plan or rebuild, so nothing below
        # the first await may touch planner scratch or snapshot state.
        user_cap = self.user_cap
        local_shard = broker.connections.shard_id
        slot_user = self.slot_user
        slot_broker = self.slot_broker
        user_shard = self.user_shard
        broker_shard = self.broker_shard
        order = np.argsort(peers, kind="stable")
        speers = peers[order]
        sframes = frames[order]
        bounds = np.nonzero(np.diff(speers))[0] + 1
        starts = np.concatenate(([0], bounds))
        ends = np.concatenate((bounds, [len(speers)]))
        buf = chunk.buf
        mv = None
        sends: list = []  # (is_user, key_or_ident, data, owner, n, cls)
        ring: Optional[dict] = None  # shard -> [(kind, ident, idx array)]
        for s, e in zip(starts.tolist(), ends.tolist()):
            peer = int(speers[s])
            idx = sframes[s:e]
            if peer < user_cap:
                key = slot_user[peer]
                if key is None:
                    # freed slot raced the plan: drop (defensive)
                    _note_fate_classes("dropped", "no_route", fc, idx)
                    continue
                shard = user_shard[peer]
                if shard != local_shard:
                    # sibling-shard user: cross-shard handoff (collected
                    # per shard; written to the ring below, still inside
                    # the synchronous phase — idx is COPIED because the
                    # pair arrays are reusable planner scratch)
                    if ring is None:
                        ring = {}
                    ring.setdefault(shard, []).append(
                        (0, bytes(key), idx.copy()))
                    continue
                target = (True, key)
            else:
                b = peer - user_cap
                ident = slot_broker[b]
                if ident is None:
                    # freed slot: drop (defensive)
                    _note_fate_classes("dropped", "no_route", fc, idx)
                    continue
                # mesh-bound pair group: the per-link conservation table
                # counts here (the routing decision) whether the frames
                # ride this shard's link or a sibling's ring
                _note_link_classes(ident, fc, idx)
                shard = broker_shard[b]
                if shard is not None:
                    if ring is None:
                        ring = {}
                    ring.setdefault(shard, []).append(
                        (1, ident.encode(), idx.copy()))
                    continue
                target = (False, ident)
            first, last = int(idx[0]), int(idx[-1])
            if last - first + 1 == len(idx):
                # contiguous run: the chunk's own bytes ARE the wire
                # stream (frames sit back-to-back, length-prefixed) —
                # zero-copy view + batch-wise permit lease
                if mv is None:
                    mv = memoryview(buf)
                data = mv[int(offs[first]) - 4:
                          int(offs[last]) + int(lens[last])]
                owner = chunk.lease()
            else:
                data = self.planner.gather(buf, offs, lens, idx)
                owner = None
                if data is None:  # can't happen on in-range indices
                    continue
            # queue-delay attribution class: the batch's first frame's
            # (volume was already counted pair-level above)
            cls = int(fc[first]) & 3 if fc is not None else flowclass.LIVE
            sends.append((*target, data, owner, len(idx), cls))
        if ring is not None:
            # still phase 1 (synchronous): the ring write copies the wire
            # bytes straight out of the pooled chunk into shared memory —
            # pre-encoded chunks + per-peer index lists, no per-frame
            # message objects, no re-serialization
            broker.shard_runtime.handoff_chunk(buf, offs, lens, ring)
        # Phase 2 — sends (may await). Connections are looked up by
        # stable identity here, like the scalar flush: a peer that left
        # mid-batch drops its frames; failure ⇒ removal.
        for is_user_peer, key, data, owner, n_frames, cls in sends:
            if is_user_peer:
                conn = broker.connections.get_user_connection(key)
            else:
                conn = broker.connections.get_broker_connection(key)
            if conn is None:
                # peer left since the plan: drop (scalar parity)
                ledger_mod.record_fate("dropped", "no_route", cls, n_frames)
                continue
            (metrics_mod.EGRESS_FRAMES_USER if is_user_peer
             else metrics_mod.EGRESS_FRAMES_BROKER).inc(n_frames)
            try:
                await conn.send_encoded(data, owner, cls=cls,
                                        nframes=0, nbytes=0,
                                        count=n_frames)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                if is_user_peer:
                    logger.info("send to user %s failed (%r); removing",
                                mnemonic(key), exc)
                    broker.connections.remove_user(key, reason="send failed")
                else:
                    logger.info("send to broker %s failed (%r); removing",
                                key, exc)
                    broker.connections.remove_broker(key,
                                                     reason="send failed")
                broker.update_metrics()

    # -- scalar twins for residual / depth-1 traffic -------------------------

    def _route_one_scalar(self, sender_id, message, raw: Bytes,
                          is_user: bool, egress: EgressBatch,
                          interest_cache: dict, conn=None) -> bool:
        """Route ONE already-deserialized message with the scalar rules
        (no device plane, no-op hook — both guaranteed by ``acquire``).
        Returns False when the sender must be disconnected. ``conn`` is
        the sender's own connection (the admission token bucket's seat)."""
        broker = self.broker
        topics_space = broker.run_def.topics
        ledger_mod.note_ingress(_ingress_class(message),
                                peer=None if is_user else sender_id)
        if isinstance(message, Direct):
            tr = message.trace
            if tr is not None:
                trace_mod.emit("ingress", tr, "residual")
            a0 = egress.appended
            route_direct(broker, message.recipient, raw,
                         to_user_only=not is_user, egress=egress)
            if tr is not None:
                # a plan span tagged "dropped" (and no egress span) means
                # the broker itself dropped the message — unknown
                # recipient / to-user-only suppression, not a downstream
                # loss
                if egress.appended > a0:
                    trace_mod.emit("plan", tr, "residual")
                    egress.note_trace(tr)
                else:
                    trace_mod.emit("plan", tr, "dropped")
        elif isinstance(message, Broadcast):
            tr = message.trace
            if tr is not None:
                trace_mod.emit("ingress", tr, "residual")
            a0 = egress.appended
            pruned, _bad = topics_space.prune(message.topics)
            if pruned:
                # durable stamp rides the same synchronous block as the
                # route decision (scalar-twin parity with handlers.py);
                # on_publish always returns True here — acquire() routes
                # sharded durable brokers scalar, so this plane only sees
                # the unsharded retain-and-route-normally case
                durable = broker.durable
                if durable is None or durable.on_publish(
                        pruned, message, raw, to_users_only=not is_user):
                    route_broadcast(broker, pruned, raw,
                                    to_users_only=not is_user,
                                    egress=egress,
                                    interest_cache=interest_cache,
                                    raw_topics=message.topics)
            if tr is not None:
                if egress.appended > a0:
                    trace_mod.emit("plan", tr, "residual")
                    egress.note_trace(tr)
                else:
                    trace_mod.emit("plan", tr, "dropped")
        elif is_user and isinstance(message, Subscribe):
            pruned, bad = topics_space.prune(message.topics)
            if bad:
                return False  # unknown topic ⇒ disconnect (scalar parity)
            adm = broker.admission
            if adm is not None and not adm.allow_subscribe(conn):
                adm.shed_subscribe(sender_id, conn, egress)
            else:
                broker.connections.subscribe_user_to(sender_id, pruned)
        elif is_user and isinstance(message, Unsubscribe):
            adm = broker.admission
            if adm is not None and not adm.allow_subscribe(conn):
                adm.shed_subscribe(sender_id, conn, egress)
            else:
                pruned, _bad = topics_space.prune(message.topics)
                broker.connections.unsubscribe_user_from(sender_id, pruned)
        elif is_user and isinstance(message, SubscribeFrom):
            # replay / pattern subscribe, scalar-twin parity
            adm = broker.admission
            if adm is not None and not adm.allow_subscribe(conn):
                adm.shed_subscribe(sender_id, conn, egress)
            else:
                durable = broker.durable
                if durable is None or not durable.handle_subscribe_from(
                        sender_id, message, conn):
                    return False
        elif not is_user and isinstance(message, UserSync):
            broker.connections.apply_user_sync(message.payload)
            broker.update_metrics()
        elif not is_user and isinstance(message, TopicSync):
            broker.connections.apply_topic_sync(sender_id, message.payload)
        elif not is_user and isinstance(message, LedgerSync):
            # peer's conservation balance sheet (scalar-twin parity
            # with broker_receive_loop — never link-fatal)
            import json
            try:
                sheet = json.loads(bytes(message.payload))
            except (ValueError, UnicodeDecodeError):
                sheet = None
            if sheet is not None:
                ledger_mod.LEDGER.note_peer_sheet(sender_id, sheet)
        else:
            # users may not send auth/sync post-handshake; brokers may not
            # send auth/subscribe — disconnect (scalar parity, including
            # the broker-loop diagnostic; the user loop logs nothing here)
            if not is_user:
                logger.warning("broker %s sent unexpected %s; dropping link",
                               sender_id, type(message).__name__)
            return False
        return True

    def _log_malformed(self, sender_id, is_user: bool, conn) -> None:
        """The scalar loops' malformed-frame diagnostics, verbatim (plus a
        flight-recorder event, so the disconnect dump shows the trigger).
        ``conn`` is the drain's OWN connection object — never resolved by
        identity here, because a quick reconnect swaps the map entry and
        the event would land on (and arm) the innocent new link."""
        if is_user:
            logger.info("user %s sent malformed frame; disconnecting",
                        mnemonic(sender_id))
        else:
            logger.warning("broker %s sent malformed frame; dropping link",
                           sender_id)
        if conn is not None:
            conn.flightrec.record("malformed-frame", abnormal=True)
        ledger_mod.record_fate("dropped", "malformed",
                               flowclass.CLASS_NONE)

    # -- drains --------------------------------------------------------------

    async def route_drain(self, sender_id, items: list,
                          is_user: bool, conn=None) -> bool:
        """Route one ``recv_frames()`` drain (a mix of :class:`FrameChunk`
        batches and depth-1 :class:`Bytes` frames), preserving arrival
        order end to end. Returns False when the sender must be
        disconnected; every item's pool permit is settled either way.
        ``conn`` is the sender's own connection (flight-recorder seat for
        malformed-frame events)."""
        mode = _MODE_USER if is_user else _MODE_BROKER
        egress = EgressBatch(self.broker)
        interest_cache: dict = {}
        alive = True
        idx = 0  # items[idx:] are the ones whose release is still owed
        try:
            while idx < len(items):
                item = items[idx]
                idx += 1
                if type(item) is not FrameChunk:
                    # depth-1 frame (the latency regime): scalar-route it
                    # through the accumulating egress (which clones), then
                    # settle its permit here
                    metrics_mod.ROUTE_RESIDUAL_FRAMES.inc()
                    try:
                        try:
                            message = deserialize(item.data)
                        except Error:
                            self._log_malformed(sender_id, is_user, conn)
                            alive = False
                        else:
                            alive = self._route_one_scalar(
                                sender_id, message, item, is_user, egress,
                                interest_cache, conn)
                    finally:
                        item.release()
                    if not alive:
                        break
                    continue
                # handoff guard: until _route_chunk/_chunk_scalar take
                # ownership (they release in their finally), an exception
                # or cancellation here must settle this chunk's permit —
                # the outer finally only covers items[idx:]
                try:
                    usable = self._refresh()
                    if usable:
                        # a chunk's plan enqueues per-peer streams
                        # immediately; flush accumulated singles first so
                        # per-peer order follows arrival order
                        await egress.flush()
                except BaseException:
                    item.release()
                    raise
                if usable:
                    alive = await self._route_chunk(sender_id, item, mode,
                                                    is_user, egress,
                                                    interest_cache, conn)
                else:
                    # snapshot build failed (allocation): scalar-route the
                    # chunk frame by frame — correctness over speed
                    alive = await self._chunk_scalar(sender_id, item,
                                                     is_user, egress,
                                                     interest_cache, conn)
                if not alive:
                    break
        finally:
            try:
                await egress.flush()
            finally:
                for item in items[idx:]:
                    item.release()
        return alive

    async def _route_chunk(self, sender_id, chunk: FrameChunk, mode: int,
                           is_user: bool, egress: EgressBatch,
                           interest_cache: dict, conn=None) -> bool:
        """Cut-through one chunk: plan → egress views → residual scalar →
        resume. The chunk's permit is released here (leases keep it alive
        under pending zero-copy flushes)."""
        offs = np.asarray(chunk.offs, np.int64)
        lens = np.asarray(chunk.lens, np.int64)
        buf = chunk.buf
        n = len(offs)
        pos = chunk._pos  # 0 unless someone partially took frames
        planner = self.planner
        try:
            while pos < n:
                # Revalidate the snapshot before EVERY plan call: the
                # egress awaits below can park this task while another
                # task mutates routing state (a subscribe on a different
                # connection), and the scalar path's per-message
                # interest_version check would see that mutation — so
                # must we. Two int compares when nothing changed.
                if not self._refresh():
                    return await self._chunk_scalar_from(
                        sender_id, chunk, offs, lens, pos, is_user,
                        egress, interest_cache, conn)
                t0 = time.perf_counter()
                pump = self._get_pump()
                if pump is not None:
                    # fused path: plan + native linked send SQEs in ONE C
                    # call; escalated (peer, frame) pairs come back and
                    # ride the normal _send_plan below
                    consumed, stop, peers, frames, pumped = \
                        pump.plan_and_pump(self, chunk, buf, offs, lens,
                                           pos, mode)
                else:
                    pumped = 0
                    consumed, stop, peers, frames = planner.plan(
                        buf, offs, lens, pos, mode)
                # one perf_counter pair + locked add per CHUNK-level plan
                # call — the latency-attribution seam /metrics exposes as
                # cdn_native_seconds{kernel="route_plan"}
                metrics_mod.NATIVE_PLAN_SECONDS.inc(
                    time.perf_counter() - t0)
                if consumed:
                    metrics_mod.ROUTE_BATCH_SIZE.observe(consumed)
                    if pumped:
                        metrics_mod.ROUTE_PUMP_FRAMES.inc(consumed)
                    else:
                        metrics_mod.ROUTE_CUTTHROUGH_FRAMES.inc(consumed)
                    self._frames_since_rebuild += consumed
                    # per-class ingress accounting off the plan's class
                    # array (pumped runs count their own dir=out in C;
                    # residual pairs count in _send_plan below)
                    fc = (pump.np_.frame_classes if pump is not None
                          else planner.frame_classes)
                    _inc_class_counts(fc[pos:pos + consumed],
                                      lens[pos:pos + consumed],
                                      metrics_mod.CLASS_FRAMES_IN,
                                      metrics_mod.CLASS_BYTES_IN)
                    self._ledger_ingress_fold(
                        fc, pos, consumed, buf, offs, lens,
                        None if is_user else sender_id)
                    # durable retention seam: stamp the consumed
                    # broadcasts in the same synchronous region as the plan
                    # (before the first egress await), so a SubscribeFrom
                    # landing mid-send sees exactly the planned frames in
                    # its replay snapshot — no gap, no dup
                    durable = self.broker.durable
                    if durable is not None and durable.topics:
                        durable.retain_from_chunk(buf, offs, lens, pos,
                                                  consumed)
                    await self._send_plan(chunk, offs, lens, peers, frames,
                                          fc)
                pos += consumed
                if stop == routeplan.STOP_END:
                    break
                if stop == routeplan.STOP_CAPACITY:
                    if consumed == 0:  # cannot make progress (can't
                        return await self._chunk_scalar_from(  # happen:
                            sender_id, chunk, offs, lens, pos,  # cap >=
                            is_user, egress, interest_cache, conn)
                    continue
                # STOP_RESIDUAL: the frame at `pos` is a control frame or
                # malformed — scalar semantics, then re-plan (the control
                # frame bumps interest_version, so the next plan call
                # rebuilds the snapshot first)
                metrics_mod.ROUTE_RESIDUAL_FRAMES.inc()
                o, ln = int(offs[pos]), int(lens[pos])
                try:
                    message = deserialize(memoryview(buf)[o:o + ln])
                except Error:
                    self._log_malformed(sender_id, is_user, conn)
                    return False  # malformed ⇒ disconnect/drop link
                if isinstance(message, (Direct, Broadcast)):
                    # TRACED hot frames stop the plan on the kind-tag flag
                    # bit (route_plan.cpp) and take this instrumented
                    # scalar path — the raw frame (flag + trace block
                    # intact) is forwarded verbatim so receivers emit the
                    # delivery span; the rest of the chunk stays batched.
                    # Untraced well-formed hot frames never stop the plan
                    # (this branch is then defensive only).
                    frame = Bytes(buf[o:o + ln])
                    alive = self._route_one_scalar(sender_id, message,
                                                   frame, is_user, egress,
                                                   interest_cache, conn)
                    frame.release()
                else:
                    alive = self._route_one_scalar(sender_id, message,
                                                   None, is_user, egress,
                                                   interest_cache, conn)
                if not alive:
                    return False
                # A residual hot frame (traced, or the defensive case)
                # landed in the egress ACCUMULATOR; the resumed plan's
                # _send_plan enqueues straight to the writers, so flush
                # now or the rest of the chunk overtakes it on the wire.
                # No-op for control frames (empty accumulator).
                await egress.flush()
                pos += 1  # loop top revalidates the (likely bumped) snapshot
        finally:
            chunk.release()
        return True

    async def _chunk_scalar(self, sender_id, chunk: FrameChunk,
                            is_user: bool, egress: EgressBatch,
                            interest_cache: dict, conn=None) -> bool:
        offs = np.asarray(chunk.offs, np.int64)
        lens = np.asarray(chunk.lens, np.int64)
        try:
            return await self._chunk_scalar_from(
                sender_id, chunk, offs, lens, chunk._pos, is_user, egress,
                interest_cache, conn)
        finally:
            chunk.release()

    async def _chunk_scalar_from(self, sender_id, chunk: FrameChunk,
                                 offs, lens, pos: int, is_user: bool,
                                 egress: EgressBatch,
                                 interest_cache: dict, conn=None) -> bool:
        """Scalar fallback over a chunk's remaining frames (snapshot build
        failed). Mirrors the handlers.py loop bodies exactly."""
        buf = chunk.buf
        for i in range(pos, len(offs)):
            metrics_mod.ROUTE_SCALAR_FRAMES.inc()
            o, ln = int(offs[i]), int(lens[i])
            try:
                message = deserialize(memoryview(buf)[o:o + ln])
            except Error:
                self._log_malformed(sender_id, is_user, conn)
                return False
            if isinstance(message, (Direct, Broadcast)):
                frame = Bytes(buf[o:o + ln])
                ok = self._route_one_scalar(sender_id, message, frame,
                                            is_user, egress,
                                            interest_cache, conn)
                frame.release()
            else:
                ok = self._route_one_scalar(sender_id, message, None,
                                            is_user, egress,
                                            interest_cache, conn)
            if not ok:
                return False
        return True
