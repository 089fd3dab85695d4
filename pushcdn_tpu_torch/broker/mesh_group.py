"""MeshGroup — N broker shards in one process whose routing runs as one
mesh step per tick, with no sockets.

The counterpart of ``pushcdn_tpu.broker.mesh_group.MeshBrokerGroup``
without its asyncio pump, brokers, host links and host fallback: a
caller claims and releases users per shard, stages items per shard, and
calls :meth:`MeshGroup.step`, which routes everything staged on every
shard in ONE mesh lane step (``parallel.router.MeshLaneStep``) and
returns each shard's ``(user, frame)`` pairs. A failed step raises.

Consistency: one process is one source of truth. The group owns the
GLOBAL user-slot table and host mirrors (owner shard, claim version and
topic mask per slot). A step snapshots the mirrors, every ring and
bucket, and the slot quarantine in one place; every shard's state row
is that same global view with identity = owner, so the in-step CRDT
merge reproduces it on every shard. An in-group double connect is
settled at claim time: the old shard's claim is released (its slot
quarantined until the next step completes) and the user gets a slot
for the new shard; the kicked ``(shard, key)`` goes back to the caller,
which owns the sessions.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pushcdn_tpu_torch.broker.staging import StageResult
from pushcdn_tpu_torch.broker.pump_common import (
    RevCache,
    TopicMaskCache,
    effective_users,
)
from pushcdn_tpu_torch.parallel.crdt import ABSENT, CrdtState
from pushcdn_tpu_torch.parallel.frames import (
    TOPIC_WORDS_FULL,
    DirectBuckets,
    FrameRing,
    UserSlots,
    mask_mirror_shape,
    mask_row_of,
    slice_batch,
    slice_direct_batch,
    stage_best_fit,
)
from pushcdn_tpu_torch.parallel.mesh import BrokerMesh, make_broker_mesh
from pushcdn_tpu_torch.parallel.router import (
    DirectIngress,
    IngressBatch,
    MeshLaneStep,
    RouterState,
    trace_collectives,
)
from pushcdn_tpu_torch.proto.error import Error
from pushcdn_tpu_torch.proto.message import KIND_BROADCAST, KIND_DIRECT

logger = logging.getLogger("pushcdn.broker.meshgroup")


@dataclass
class MeshGroupConfig:
    num_user_slots: int = 1024
    ring_slots: int = 256          # per shard per step (broadcast gather)
    direct_bucket_slots: int = 64  # per shard per DESTINATION per step
    frame_bytes: int = 2048
    # Size-bucketed lanes beyond the base lane, each (frame_bytes,
    # ring_slots, direct_bucket_slots). A frame stages into the smallest
    # lane it fits.
    extra_lanes: tuple = ((16384, 32, 8),)
    # u32 words per topic mask: 8 covers the reference's whole u8 topic
    # space; 1 keeps compact masks for deployments with ≤32 topics
    topic_words: int = TOPIC_WORDS_FULL
    # When everything staged fits the first ``latency_slots`` slots of
    # every base-lane ring and bucket and the extra lanes are idle, the
    # step runs on prefix-sliced shapes (sparse traffic).
    latency_slots: int = 8
    # Frame bytes stay in this process's host rings and egress from the
    # snapshots: only the delivery decision rides the mesh. A group whose
    # shards do not share a host sets this True.
    gather_frame_bytes: bool = False
    # The exchange's schedule: True packs every exchanged leaf into one
    # collective per tick (router._exchange_fused), False moves one array
    # at a time, None lets the mesh step pick (per array when every shard
    # shares one device, fused when the shards span devices).
    fused_collective: Optional[bool] = None

    def lane_shapes(self):
        """All lanes as (frame_bytes, ring_slots, direct_bucket_slots),
        ascending by frame width."""
        return sorted(
            ((self.frame_bytes, self.ring_slots, self.direct_bucket_slots),)
            + tuple(self.extra_lanes))


class ShardDeliveries(NamedTuple):
    """One shard's routing decision for one lane of one step: pair ``i``
    delivers frame ``frames[i]`` (an index into ``length``/``bytes_``) to
    user slot ``users[i]``, grouped per user, frames ascending.

    A broadcast lane's frames are every shard's ring slots in mesh order
    (shard ``src``'s slot ``k`` is frame ``src * S + k``). A direct lane's
    are what the shard received: the concatenation over source shards of
    each source's bucket for this shard."""

    shard: int
    lane: int
    direct: bool
    users: np.ndarray    # int[P]
    frames: np.ndarray   # int[P]
    length: np.ndarray   # int32[N]
    bytes_: np.ndarray   # uint8[N, F]


class MeshGroup:
    """Socket-free broker group over a mesh: global slot table, per-shard
    staging, one mesh step per :meth:`step`. ``mesh`` defaults to one
    shard per visible CUDA device and raises without CUDA."""

    def __init__(self, mesh: Optional[BrokerMesh] = None,
                 config: Optional[MeshGroupConfig] = None):
        if mesh is None:
            mesh = make_broker_mesh()
        self.mesh = mesh
        self.config = config or MeshGroupConfig()
        c = self.config
        B = self.num_shards = mesh.size
        self.step_fn = MeshLaneStep(
            mesh, gather_bytes=c.gather_frame_bytes,
            fused=c.fused_collective)
        # lane_rings[lane][shard]: size-bucketed broadcast staging
        self.lane_rings = [
            [FrameRing(slots=s, frame_bytes=f, topic_words=c.topic_words)
             for _ in range(B)]
            for f, s, _d in c.lane_shapes()]
        # lane_buckets[lane][shard]: direct frames keyed by owner shard
        self.lane_buckets = [
            [DirectBuckets(B, capacity=d, frame_bytes=f) for _ in range(B)]
            for f, _s, d in c.lane_shapes()]
        self.slots = UserSlots(c.num_user_slots)
        self._owner = np.full(c.num_user_slots, ABSENT, np.int32)
        self._claim_version = np.zeros(c.num_user_slots, np.uint32)
        self._masks = np.zeros(
            mask_mirror_shape(c.num_user_slots, c.topic_words), np.uint32)
        self._quarantine: List[int] = []
        # users the slot table couldn't hold, keyed to their shard so a
        # stopped shard's entries can be swept
        self._unmirrored: Dict[bytes, int] = {}
        # membership over the fixed mesh: a stopped shard is masked dead
        self._liveness = np.ones(B, bool)
        # bumped on every owner/mask/liveness change; device state is
        # uploaded again only when it moved
        self._state_rev = 0
        self._state_cache = RevCache()
        self._tmask_cache = TopicMaskCache(c.topic_words)
        self._idle_dev_lanes: dict = {}
        self._byte_stubs: dict = {}
        self._state_dirty = False  # forces a step with no staged traffic
        self.overflows = 0         # items staging sent to the host path
        self.steps = 0
        self.messages_routed = 0
        # collectives issued by the last step (router.trace_collectives)
        self.collectives_last_step: Optional[int] = None
        # seconds of the last step() on the host clock, split three ways:
        # host snapshot and upload; the mesh step (exchange and per-shard
        # routing) through the delivery matrices' readback; pair extraction
        self.last_step_seconds = (0.0, 0.0, 0.0)

    # ---- mirrors ---------------------------------------------------------

    def claim_user(self, shard: int, public_key: bytes,
                   topics) -> Optional[Tuple[int, bytes]]:
        """``public_key`` connected at ``shard`` with ``topics``. Returns
        ``(old shard, key)`` when this was an in-group double connect
        whose old session the caller must close, else None."""
        try:
            slot = self.slots.assign(public_key)
        except Error:
            self._unmirrored[public_key] = shard
            logger.warning("mesh-group slot table full; %d unmirrored",
                           len(self._unmirrored))
            return None
        kicked = None
        prev = int(self._owner[slot])
        if prev != ABSENT and prev != shard:
            # the old session is kicked, which releases its claim; the
            # freed slot stays quarantined until the next step, so the
            # user is re-assigned (and a full table can fail here too)
            self.release_user(prev, public_key)
            kicked = (prev, public_key)
            try:
                slot = self.slots.assign(public_key)
            except Error:
                self._unmirrored[public_key] = shard
                logger.warning(
                    "mesh-group slot table full after in-group kick; "
                    "%d unmirrored", len(self._unmirrored))
                return kicked
        self._owner[slot] = shard
        self._claim_version[slot] += 1
        self._masks[slot] = mask_row_of(topics, self.config.topic_words)
        self._state_rev += 1
        return kicked

    def release_user(self, shard: int, public_key: bytes) -> None:
        self._unmirrored.pop(public_key, None)
        slot = self.slots.slot_of(public_key)
        if slot is None or int(self._owner[slot]) != shard:
            return  # not ours (already taken over by another shard)
        self.slots.unmap(public_key)
        self._owner[slot] = ABSENT
        self._claim_version[slot] += 1
        self._masks[slot] = 0
        self._quarantine.append(slot)
        self._state_rev += 1

    def update_mask(self, shard: int, public_key: bytes, topics) -> None:
        slot = self.slots.slot_of(public_key)
        if slot is not None and int(self._owner[slot]) == shard:
            self._masks[slot] = mask_row_of(topics, self.config.topic_words)
            self._state_rev += 1

    def mark_shard_stopped(self, shard: int) -> None:
        """``shard`` stopped: mask it dead and release every slot it
        still owned (a crashed shard fires no per-user releases), so
        directs to its users go to the host path instead of dropping at
        the tombstone. The next step runs even with nothing staged."""
        self._liveness[shard] = False
        self._state_rev += 1
        for slot in np.nonzero(self._owner == shard)[0]:
            key = self.slots.key_of(int(slot))
            if key is not None:
                self.slots.unmap(key)
            self._owner[slot] = ABSENT
            self._claim_version[slot] += 1
            self._masks[slot] = 0
            self._quarantine.append(int(slot))
        # its unmirrored users would otherwise pin every broadcast to the
        # host path forever
        for key in [k for k, s in self._unmirrored.items() if s == shard]:
            del self._unmirrored[key]
        self._state_dirty = True

    # ---- staging ----------------------------------------------------------

    def _overflow(self) -> StageResult:
        """Traffic the mesh step can't carry: the host path's."""
        self.overflows += 1
        return StageResult.INELIGIBLE

    def _direct_route_info(self, recipient: bytes):
        """(device slot, owner shard) of a direct recipient, or None when
        the mesh can't carry it (unknown or absent recipient)."""
        slot = self.slots.slot_of(recipient)
        if slot is None:
            return None
        owner = int(self._owner[slot])
        if owner == ABSENT:
            return None
        return slot, owner

    def stage_batch(self, shard: int, items) -> List[StageResult]:
        """Stage ``(kind, payload, target)`` items for ``shard``: a
        ``KIND_BROADCAST`` target is a topic list, a ``KIND_DIRECT``
        target the recipient's public key. Broadcasts go to the smallest
        lane they fit with a free ring slot; directs to the owner's
        bucket of the smallest lane with room on that link.

        INELIGIBLE ⇒ host path: too big, unmirrored users present, a
        topic outside the configured space, an unknown recipient (each
        counted in ``overflows``), no topics, or another kind. FULL ⇒
        backpressure, retry."""
        results = [StageResult.INELIGIBLE] * len(items)
        groups: dict = {}   # lane -> [(idx, frame, mask)]
        rings = [lane[shard] for lane in self.lane_rings]
        free = [r.free_slots for r in rings]
        widest = rings[-1].frame_bytes
        for idx, (kind, payload, target) in enumerate(items):
            frame = bytes(payload)
            if len(frame) > widest:
                self._overflow()
                continue
            if kind == KIND_BROADCAST:
                if self._unmirrored:
                    self._overflow()
                    continue
                mask, out_of_range = self._tmask_cache.resolve(target)
                if out_of_range:
                    self._overflow()
                    continue
                if mask == 0:
                    continue  # no valid topics: a no-op send
                placed = False
                for li, ring in enumerate(rings):
                    if len(frame) <= ring.frame_bytes and free[li] > 0:
                        free[li] -= 1
                        groups.setdefault(li, []).append((idx, frame, mask))
                        placed = True
                        break
                results[idx] = (StageResult.STAGED if placed
                                else StageResult.FULL)
            elif kind == KIND_DIRECT:
                info = self._direct_route_info(bytes(target))
                if info is None:
                    self._overflow()
                    continue
                slot, owner = info
                ok = stage_best_fit(
                    [bkts[shard] for bkts in self.lane_buckets], len(frame),
                    lambda b: b.push(owner, frame, slot))
                results[idx] = StageResult.STAGED if ok else StageResult.FULL
        for li, group in groups.items():
            n = rings[li].push_batch(
                [g[1] for g in group], [KIND_BROADCAST] * len(group),
                [g[2] for g in group], [-1] * len(group))
            for idx, *_ in group[n:]:
                results[idx] = StageResult.FULL
        return results

    # ---- the step ---------------------------------------------------------

    def _staged_total(self) -> int:
        return (sum(r.slots - r.free_slots
                    for rings in self.lane_rings for r in rings)
                + sum(b.total_used
                      for bkts in self.lane_buckets for b in bkts))

    def step(self) -> List[ShardDeliveries]:
        """Route everything staged on every shard in one mesh step and
        return the deliveries of every (shard, lane) that delivered
        something: broadcast lanes first, then direct lanes, shards in
        mesh order. Stopped shards deliver nothing. Raises if the step
        fails."""
        t0 = time.perf_counter()
        c = self.config
        if not self._state_dirty and self._staged_total() == 0:
            return []
        self._state_dirty = False
        lat = c.latency_slots
        small = (all(r.slots - r.free_slots <= lat
                     for r in self.lane_rings[0])
                 and all(b.max_used <= lat for b in self.lane_buckets[0])
                 and all(r.free_slots == r.slots
                         for rings in self.lane_rings[1:] for r in rings)
                 and all(b.total_used == 0
                         for bkts in self.lane_buckets[1:] for b in bkts))
        # one snapshot: every lane's rings and buckets, the mirrors, the
        # liveness mask and the quarantine
        batches = [[r.take_batch() for r in rings]
                   for rings in self.lane_rings]
        directs = [[b.take_batch() for b in bkts]
                   for bkts in self.lane_buckets]
        if small:
            batches = [[slice_batch(b, lat) for b in batches[0]]]
            directs = [[slice_direct_batch(d, lat) for d in directs[0]]]
        u_eff = effective_users(self.slots.high_water, c.num_user_slots)
        owner = self._owner[:u_eff].copy()
        versions = self._claim_version[:u_eff].copy()
        masks = self._masks[:u_eff].copy()
        liveness = self._liveness.copy()
        quarantined, self._quarantine = self._quarantine, []
        try:
            return self._run_step(batches, directs, owner, versions, masks,
                                  liveness, self._state_rev, t0)
        finally:
            for slot in quarantined:  # safe to recycle now
                self.slots.free_slot(slot)

    def _run_step(self, batches, directs, owner, versions, masks, liveness,
                  state_rev: int, t0: float) -> List[ShardDeliveries]:
        """The mesh step against the snapshot. ``batches`` and
        ``directs`` are [lane][shard] host snapshots. Lanes idle on every
        shard reuse cached device-side empty batches; zero-width byte
        stubs stand in for frame bytes unless ``gather_frame_bytes``."""
        B = self.num_shards
        devices = self.mesh.devices
        gather = self.config.gather_frame_bytes

        def up(a, dev):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        def build_state():
            # every shard's row is the same global view: one upload per
            # distinct device, shared by the shards on it
            per_dev = {}
            for dev in self.mesh.distinct_devices():
                o = up(owner, dev)
                per_dev[dev] = (
                    RouterState(
                        crdt=CrdtState(o, up(versions.astype(np.int64), dev),
                                       o),  # identity = owner shard
                        topic_masks=up(masks.view(np.int32), dev)),
                    up(liveness, dev))
            return [per_dev[dev] for dev in devices]

        state_rows = self._state_cache.get(state_rev, build_state)

        def stub(shape, dev):
            key = (shape, dev)
            st = self._byte_stubs.get(key)
            if st is None:
                st = self._byte_stubs[key] = torch.zeros(
                    shape, dtype=torch.uint8, device=dev)
            return st

        def frame_bytes(a, dev):
            return up(a, dev) if gather else stub(a.shape[:-1] + (0,), dev)

        def lane_to_dev(key, lane, busy):
            """One lane's per-shard device batches; an idle lane reuses
            its cached device-side empties."""
            if not busy and key in self._idle_dev_lanes:
                return self._idle_dev_lanes[key]
            if key[0] == "b":
                dev_lane = [IngressBatch(
                    frame_bytes(b.bytes_, dev), up(b.kind, dev),
                    up(b.length, dev), up(b.topic_mask.view(np.int32), dev),
                    up(b.dest, dev), up(b.valid, dev))
                    for b, dev in zip(lane, devices)]
            else:
                dev_lane = [DirectIngress(
                    frame_bytes(d.bytes_, dev), up(d.length, dev),
                    up(d.dest, dev), up(d.valid, dev))
                    for d, dev in zip(lane, devices)]
            if not busy:
                self._idle_dev_lanes[key] = dev_lane
            return dev_lane

        busy_b = [any(b.valid.any() for b in lane) for lane in batches]
        busy_d = [any(d.valid.any() for d in lane) for lane in directs]
        lanes_dev = [lane_to_dev(("b", li, lane[0].valid.shape[0]), lane,
                                 busy_b[li])
                     for li, lane in enumerate(batches)]
        directs_dev = [lane_to_dev(("d", li, lane[0].valid.shape[1]), lane,
                                   busy_d[li])
                       for li, lane in enumerate(directs)]
        t1 = time.perf_counter()
        before = trace_collectives()
        result = self.step_fn(
            [s for s, _ in state_rows],
            [tuple(lane[i] for lane in lanes_dev) for i in range(B)],
            [tuple(lane[i] for lane in directs_dev) for i in range(B)],
            [live for _, live in state_rows])
        self.collectives_last_step = trace_collectives() - before
        self.steps += 1

        pairs_s = 0.0
        live = [s for s in range(B) if liveness[s]]
        out: List[ShardDeliveries] = []

        def pairs(deliver: torch.Tensor):
            nonlocal pairs_s
            d = deliver.cpu().numpy()
            t = time.perf_counter()
            users, frames = np.nonzero(d)
            pairs_s += time.perf_counter() - t
            return users, frames

        for li, lane in enumerate(batches):
            if not busy_b[li]:
                continue  # an idle lane can't deliver: skip its readback
            found = [(s, *pairs(result[s].lanes[li].deliver)) for s in live]
            found = [f for f in found if len(f[1])]
            if not found:
                continue
            if gather:
                g = result[0].lanes[li]
                lengths = g.gathered_length.cpu().numpy()
                blocks = g.gathered_bytes.cpu().numpy()
            else:
                lengths = np.concatenate([b.length for b in lane])
                blocks = np.concatenate([b.bytes_ for b in lane])
            out.extend(ShardDeliveries(s, li, False, users, frames, lengths,
                                       blocks) for s, users, frames in found)
        for li, lane in enumerate(directs):
            if not busy_d[li]:
                continue
            for s in live:
                g = result[s].direct_lanes[li]
                users, frames = pairs(g.deliver)
                if not len(users):
                    continue
                if gather:
                    # the exchange's output differs per shard: each
                    # shard's received frames pair with its own matrix
                    lengths = g.gathered_length.cpu().numpy()
                    blocks = g.gathered_bytes.cpu().numpy()
                else:
                    # the all_to_all transposes the buckets: shard s
                    # received, from each source, that source's bucket
                    # for s
                    lengths = np.concatenate(
                        [lane[src].length[s] for src in range(B)])
                    blocks = np.concatenate(
                        [lane[src].bytes_[s] for src in range(B)])
                out.append(ShardDeliveries(s, li, True, users, frames,
                                           lengths, blocks))
        self.messages_routed += sum(len(d.users) for d in out)
        self.last_step_seconds = (t1 - t0,
                                  time.perf_counter() - t1 - pairs_s, pairs_s)
        return out
