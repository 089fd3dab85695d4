"""N broker shards in one process whose routing runs as one mesh step
per tick.

Two layers, the second built on the first:

- :class:`MeshGroup`, socket-free: a caller claims and releases users
  per shard, stages ``(kind, payload, target)`` items per shard, and
  calls :meth:`MeshGroup.step`, which routes everything staged on every
  shard in ONE mesh lane step (``parallel.router.MeshLaneStep``) and
  returns each shard's ``(user, frame)`` pairs. A failed step raises.
- :class:`MeshBrokerGroup`, the counterpart of
  ``pushcdn_tpu.broker.mesh_group.MeshBrokerGroup``: each shard is a
  ``Broker`` whose ``device_plane`` is a :class:`MeshShardPlane`. The
  brokers' receive loops stage ``(message, raw)`` pairs, an asyncio pump
  takes the snapshot on the event loop and runs the step in a worker
  thread, and each shard's deliveries go out through its own broker
  (``senders.egress_delivery_rows``, Python). The inter-broker hop is
  the step's exchange, so member brokers need no host links; those stay
  the fallback plane for traffic the mesh cannot carry (overflow) and,
  on the CPU, for a group whose step failed.

Consistency: one process is one source of truth. The group owns the
GLOBAL user-slot table and host mirrors (owner shard, claim version and
topic mask per slot). A step snapshots the mirrors, every ring and
bucket, and the slot quarantine in one place; every shard's state row
is that same global view with identity = owner, so the in-step CRDT
merge reproduces it on every shard. An in-group double connect is
settled at claim time: the old shard's claim is released (its slot
quarantined until the next step completes) and the user gets a slot
for the new shard; the kicked ``(shard, key)`` goes back to the caller,
which owns the sessions (the broker group closes the old session).

Failure: on the CPU a broker group fails open as the JAX package's does
(a failed warm-up disables it; a failed step re-routes its frames, and
the frames staged while it ran, over the host links and disables it).
On the card a failed warm-up raises out of every member's
``Broker.start()``, and a failed step re-routes its frames the same way
and then ends the pump, which every member broker supervises, so the
group's brokers go down instead of serving on as host brokers.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pushcdn_tpu_torch.broker.device_plane import StepTiming
from pushcdn_tpu_torch.broker.pump_common import (
    CoalesceGate,
    RevCache,
    TopicMaskCache,
    effective_users,
    egress_snapshot_frames,
)
from pushcdn_tpu_torch.broker.staging import StageResult, frame_item
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
from pushcdn_tpu_torch.proto.limiter import Bytes
from pushcdn_tpu_torch.proto.message import (
    KIND_BROADCAST,
    KIND_DIRECT,
    Broadcast,
    Direct,
    deserialize,
)

if TYPE_CHECKING:
    from pushcdn_tpu_torch.broker.broker import Broker

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
    # Adaptive coalescing for the broker group's pump (pump_common
    # .CoalesceGate): step at once on a burst after idle or when
    # >= coalesce_min_frames are staged; a steady trickle waits
    # batch_window_s.
    batch_window_s: float = 0.001
    coalesce_min_frames: int = 16
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


class _MeshSnapshot(NamedTuple):
    """What one step routes: [lane][shard] ring and bucket snapshots, the
    mirrors, the liveness mask, the mirror revision, and the slots to
    free once the step is over."""

    batches: list
    directs: list
    owner: np.ndarray
    versions: np.ndarray
    masks: np.ndarray
    liveness: np.ndarray
    state_rev: int
    quarantined: List[int]


class MeshGroup:
    """Socket-free broker group over a mesh: global slot table, per-shard
    staging, one mesh step per :meth:`step`. ``mesh`` defaults to one
    shard per visible CUDA device and raises without CUDA.
    ``full_shapes`` makes every step run at full shapes, traffic or not
    (the ``lockstep`` snapshot); it defaults to whether the mesh spans
    processes."""

    def __init__(self, mesh: Optional[BrokerMesh] = None,
                 config: Optional[MeshGroupConfig] = None, *,
                 full_shapes: Optional[bool] = None):
        if mesh is None:
            mesh = make_broker_mesh()
        self.mesh = mesh
        self.config = config or MeshGroupConfig()
        c = self.config
        B = self.num_shards = mesh.size
        # every step at full shapes, traffic or not (see _snapshot)
        self.lockstep = (mesh.spans_processes if full_shapes is None
                         else full_shapes)
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

    def _snapshot(self) -> Optional[_MeshSnapshot]:
        """Take everything staged with the mirrors it routes against:
        every lane's rings and buckets (the base lane prefix-sliced to
        ``latency_slots`` when that holds all of it and the other lanes
        are idle), the mirrors up to the slot high-water mark, the
        liveness mask and the slots quarantined so far. None when nothing
        is staged and no state change forces a step. Under the broker
        group's pump this runs on the event loop, where the observer
        hooks run.

        A ``lockstep`` group (``full_shapes``: by default one whose mesh
        spans processes, where every process must enter the same
        collectives with the same shapes every tick, whatever it has
        staged) always steps, at full shapes and over the whole
        mirrors."""
        c = self.config
        lockstep = self.lockstep
        if not (lockstep or self._state_dirty or self._staged_total()):
            return None
        self._state_dirty = False
        lat = c.latency_slots
        small = not lockstep and (all(r.slots - r.free_slots <= lat
                                      for r in self.lane_rings[0])
                 and all(b.max_used <= lat for b in self.lane_buckets[0])
                 and all(r.free_slots == r.slots
                         for rings in self.lane_rings[1:] for r in rings)
                 and all(b.total_used == 0
                         for bkts in self.lane_buckets[1:] for b in bkts))
        batches = [[r.take_batch() for r in rings]
                   for rings in self.lane_rings]
        directs = [[b.take_batch() for b in bkts]
                   for bkts in self.lane_buckets]
        if small:
            batches = [[slice_batch(b, lat) for b in batches[0]]]
            directs = [[slice_direct_batch(d, lat) for d in directs[0]]]
        u_eff = (c.num_user_slots if lockstep else
                 effective_users(self.slots.high_water, c.num_user_slots))
        quarantined, self._quarantine = self._quarantine, []
        return _MeshSnapshot(
            batches, directs, self._owner[:u_eff].copy(),
            self._claim_version[:u_eff].copy(), self._masks[:u_eff].copy(),
            self._liveness.copy(), self._state_rev, quarantined)

    def _run_snapshot(self, snap: _MeshSnapshot):
        return self._run_step(snap.batches, snap.directs, snap.owner,
                              snap.versions, snap.masks, snap.liveness,
                              snap.state_rev)

    def _free_quarantined(self, snap: _MeshSnapshot) -> None:
        for slot in snap.quarantined:  # the step is over: safe to recycle
            self.slots.free_slot(slot)

    def step(self) -> List[ShardDeliveries]:
        """Route everything staged on every shard in one mesh step and
        return the deliveries of every (shard, lane) that delivered
        something: broadcast lanes first, then direct lanes, shards in
        mesh order. Stopped shards deliver nothing. Raises if the step
        fails."""
        t0 = time.perf_counter()
        snap = self._snapshot()
        if snap is None:
            return []
        t1 = time.perf_counter()
        try:
            out, upload_s, pairs_s = self._run_snapshot(snap)
        finally:
            self._free_quarantined(snap)
        t2 = time.perf_counter()
        self.messages_routed += sum(len(d.users) for d in out)
        self.last_step_seconds = (t1 - t0 + upload_s,
                                  t2 - t1 - upload_s - pairs_s, pairs_s)
        return out

    def _run_step(self, batches, directs, owner, versions, masks, liveness,
                  state_rev: Optional[int]):
        """The mesh step against the snapshot (under the broker group's
        pump, in a worker thread). ``batches`` and ``directs`` are
        [lane][shard] host snapshots. Lanes idle on every shard reuse
        cached device-side empty batches; zero-width byte stubs stand in
        for frame bytes unless ``gather_frame_bytes``. Only local shards'
        rows go up and only local shards deliver (every shard, in one
        process). Returns the deliveries, the seconds spent uploading and
        the seconds spent extracting pairs."""
        t0 = time.perf_counter()
        B = self.num_shards
        local = self.mesh.local_indices
        devices = self.mesh.local_devices
        gather = self.config.gather_frame_bytes

        def up(a, dev):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        def build_state():
            # every shard's row is the same global view: one upload per
            # distinct device, shared by the shards on it
            per_dev = {}
            for dev in dict.fromkeys(devices):
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
            rows = [lane[i] for i in local]
            if key[0] == "b":
                dev_lane = [IngressBatch(
                    frame_bytes(b.bytes_, dev), up(b.kind, dev),
                    up(b.length, dev), up(b.topic_mask.view(np.int32), dev),
                    up(b.dest, dev), up(b.valid, dev))
                    for b, dev in zip(rows, devices)]
            else:
                dev_lane = [DirectIngress(
                    frame_bytes(d.bytes_, dev), up(d.length, dev),
                    up(d.dest, dev), up(d.valid, dev))
                    for d, dev in zip(rows, devices)]
            if not busy:
                self._idle_dev_lanes[key] = dev_lane
            return dev_lane

        busy_b = [any(lane[i].valid.any() for i in local)
                  for lane in batches]
        busy_d = [any(lane[i].valid.any() for i in local)
                  for lane in directs]
        lanes_dev = [lane_to_dev(("b", li, lane[0].valid.shape[0]), lane,
                                 busy_b[li])
                     for li, lane in enumerate(batches)]
        directs_dev = [lane_to_dev(("d", li, lane[0].valid.shape[1]), lane,
                                   busy_d[li])
                       for li, lane in enumerate(directs)]
        t1 = time.perf_counter()
        before = trace_collectives()
        n = len(local)
        result = self.step_fn(
            [s for s, _ in state_rows],
            [tuple(lane[k] for lane in lanes_dev) for k in range(n)],
            [tuple(lane[k] for lane in directs_dev) for k in range(n)],
            [live for _, live in state_rows])
        self.collectives_last_step = trace_collectives() - before
        self.steps += 1
        result = dict(zip(local, result))

        pairs_s = 0.0
        live = [s for s in local if liveness[s]]
        out: List[ShardDeliveries] = []
        # across processes a lane idle here may carry other processes'
        # frames: its readback is skipped only when it delivers nothing
        remote = self.mesh.spans_processes
        none = (np.empty(0, np.int64), np.empty(0, np.int64))

        def pairs(deliver: torch.Tensor, busy: bool):
            nonlocal pairs_s
            if not busy and not bool(deliver.any()):
                return none
            d = deliver.cpu().numpy()
            t = time.perf_counter()
            users, frames = np.nonzero(d)
            pairs_s += time.perf_counter() - t
            return users, frames

        for li, lane in enumerate(batches):
            if not (busy_b[li] or remote):
                continue  # an idle lane can't deliver: skip its readback
            found = [(s, *pairs(result[s].lanes[li].deliver, busy_b[li]))
                     for s in live]
            found = [f for f in found if len(f[1])]
            if not found:
                continue
            if gather:
                g = result[found[0][0]].lanes[li]
                lengths = g.gathered_length.cpu().numpy()
                blocks = g.gathered_bytes.cpu().numpy()
            else:
                lengths = np.concatenate([b.length for b in lane])
                blocks = np.concatenate([b.bytes_ for b in lane])
            out.extend(ShardDeliveries(s, li, False, users, frames, lengths,
                                       blocks) for s, users, frames in found)
        for li, lane in enumerate(directs):
            if not (busy_d[li] or remote):
                continue
            for s in live:
                g = result[s].direct_lanes[li]
                users, frames = pairs(g.deliver, busy_d[li])
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
        return out, t1 - t0, pairs_s


# ---------------------------------------------------------------------------
# the group wired into brokers
# ---------------------------------------------------------------------------


class MeshShardPlane:
    """Per-broker facade: the ``Connections`` observer and the staging
    interface of one shard, duck-compatible with ``DevicePlane`` where
    the broker and its handlers read a plane."""

    covers_brokers = True  # staged broadcasts reach the group's peers in-step

    def __init__(self, group: "MeshBrokerGroup", shard: int):
        self.group = group
        self.shard = shard
        self._watch: Optional[asyncio.Task] = None

    # Connections observer protocol --------------------------------------
    def on_user_added(self, public_key: bytes, topics) -> None:
        self.group.claim_user(self.shard, public_key, topics)

    def on_user_removed(self, public_key: bytes) -> None:
        self.group.release_user(self.shard, public_key)

    def on_subscription_changed(self, public_key: bytes, topics) -> None:
        self.group.update_mask(self.shard, public_key, topics)

    # staging -------------------------------------------------------------
    def try_stage(self, message, raw: Bytes) -> StageResult:
        return self.group.try_stage(self.shard, message, raw)

    def stage_batch(self, items) -> List[StageResult]:
        return self.group.stage_batch(self.shard, items)

    def covered_broker_idents(self) -> set:
        """Identifiers of the group's member brokers: the mesh step covers
        delivery to them, so the host path must not also forward (but
        still forwards to interested brokers outside the group)."""
        return self.group.member_idents()

    # lifecycle (driven by the owning broker's start/stop) ---------------
    async def start(self) -> None:
        await self.group.ensure_started()
        if not self.fails_open:
            self._watch = asyncio.create_task(
                self._watch_pump(), name=f"mesh-group-pump-{self.shard}")

    async def _watch_pump(self) -> None:
        # ends with the group pump's exception; cancelling this watch (a
        # member broker stopping) leaves the shared pump running
        await asyncio.shield(self.group.pump_task)

    async def stop(self) -> None:
        if self._watch is not None:
            self._watch.cancel()
            self._watch = None
        await self.group.on_shard_stopped(self.shard)

    @property
    def pump_task(self) -> Optional[asyncio.Task]:
        """What the broker supervises on the card: a watch on the group's
        pump that ends when the pump does."""
        return self._watch

    @property
    def fails_open(self) -> bool:
        return self.group.fails_open

    @property
    def disabled(self) -> bool:
        return self.group.disabled

    @property
    def overflow_seen(self) -> bool:
        return self.group.overflow_seen

    @property
    def steps(self) -> int:
        return self.group.steps

    @property
    def messages_routed(self) -> int:
        return self.group.messages_routed


class MeshBrokerGroup(MeshGroup):
    """A :class:`MeshGroup` whose shards are brokers (see the module
    docstring). Every shard starts dead and :meth:`attach` marks it live,
    so a shard with no broker receives nothing."""

    def __init__(self, mesh: Optional[BrokerMesh] = None,
                 config: Optional[MeshGroupConfig] = None, *,
                 full_shapes: Optional[bool] = None):
        super().__init__(mesh, config, full_shapes=full_shapes)
        self.brokers: List[Optional["Broker"]] = [None] * self.num_shards
        self._liveness[:] = False
        self._member_idents: Optional[set] = None
        self.disabled = False
        # set when traffic falls outside what the mesh step can carry:
        # heartbeats then form host links even in mesh-only deployments
        self.overflow_seen = False
        self._kick = asyncio.Event()
        self._starting: Optional[asyncio.Future] = None
        self._task: Optional[asyncio.Task] = None
        # the pump's recent steps (StepTiming: snapshot on the loop;
        # upload, mesh step and readback in the worker thread; pair
        # extraction; egress), newest last
        self.recent_steps: collections.deque = collections.deque(
            maxlen=4096)

    @property
    def fails_open(self) -> bool:
        """Whether a failed warm-up or step leaves the brokers serving on
        their host links (the CPU, as in the JAX package) rather than
        ending them (the card)."""
        return all(d.type != "cuda" for d in self.mesh.distinct_devices())

    @property
    def pump_task(self) -> Optional[asyncio.Task]:
        return self._task

    # ---- wiring ----------------------------------------------------------

    # the per-broker facade :meth:`attach` installs
    plane_class = MeshShardPlane

    def attach(self, broker: "Broker", shard: int) -> MeshShardPlane:
        """Make ``broker`` shard ``shard`` of this group (call after
        ``Broker.new``, before ``Broker.start``)."""
        plane = self.plane_class(self, shard)
        self.brokers[shard] = broker
        self._liveness[shard] = True
        self._state_rev += 1
        broker.device_plane = plane
        broker.connections.observer = plane
        self._member_idents = None
        return plane

    def member_idents(self) -> set:
        if self._member_idents is None:
            self._member_idents = {str(b.identity) for b in self.brokers
                                   if b is not None}
        return self._member_idents

    async def ensure_started(self) -> None:
        """Warm the step up off the event loop (the first launch of each
        kernel loads it), then spawn the pump; once for the group, every
        member awaiting the same start. On the card a warm-up that fails
        raises here, in every member."""
        if self._starting is None:
            self._starting = asyncio.ensure_future(self._start())
        await asyncio.shield(self._starting)

    async def _start(self) -> None:
        await asyncio.to_thread(self._warmup)
        self._task = asyncio.create_task(self._pump(), name="mesh-group-pump")

    def _warmup(self) -> None:
        """Run the two shapes the pump uses first, empty: every lane at
        full size and the latency-sliced base lane. A failure disables a
        group that fails open and raises on the card."""
        c = self.config
        batches = [[r.take_batch() for r in rings] for rings in self.lane_rings]
        directs = [[b.take_batch() for b in bkts] for bkts in self.lane_buckets]
        lat = c.latency_slots
        small = [[slice_batch(b, lat) for b in batches[0]]]
        small_d = [[slice_direct_batch(d, lat) for d in directs[0]]]
        u0 = effective_users(0, c.num_user_slots)
        live = np.ones(self.num_shards, bool)
        steps = self.steps
        try:
            for b, d in ((batches, directs), (small, small_d)):
                self._run_step(b, d, self._owner[:u0].copy(),
                               self._claim_version[:u0].copy(),
                               self._masks[:u0].copy(), live, None)
        except Exception:
            if not self.fails_open:
                raise
            logger.exception("mesh-group warmup step failed")
            self.disabled = True
        finally:
            self.steps = steps  # warmup doesn't count

    async def on_shard_stopped(self, shard: int) -> None:
        """``shard``'s broker stopped: mask it dead and sweep its slots
        (``mark_shard_stopped``), wake the pump so the change reaches
        the device even with nothing staged, and end the pump once the
        last member has stopped."""
        self.brokers[shard] = None
        self._member_idents = None
        self.mark_shard_stopped(shard)
        self._kick.set()
        if any(b is not None for b in self.brokers):
            return
        task, self._task, self._starting = self._task, None, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            except Exception:
                logger.exception("mesh-group pump died during stop")

    # ---- mirrors (event-loop only) ---------------------------------------

    def claim_user(self, shard: int, public_key: bytes,
                   topics) -> Optional[Tuple[int, bytes]]:
        """As :meth:`MeshGroup.claim_user`; an in-group double connect
        also closes the old session at its shard, whose release then
        finds the claim already moved and changes nothing."""
        kicked = super().claim_user(shard, public_key, topics)
        if kicked is not None:
            prev, key = kicked
            old = self.brokers[prev]
            if old is not None and old.connections.has_user(key):
                logger.info("user connected elsewhere in group "
                            "(shard %d -> %d)", prev, shard)
                old.connections.remove_user(
                    key, reason="user connected elsewhere")
        return kicked

    def release_user(self, shard: int, public_key: bytes) -> None:
        if self._unmirrored.get(public_key, shard) != shard:
            return  # a kicked session: its claim already moved elsewhere
        super().release_user(shard, public_key)

    # ---- staging ----------------------------------------------------------

    def _overflow(self) -> StageResult:
        """Traffic the mesh step can't carry rides host links: flag it and
        wake every member's heartbeat so those links form promptly."""
        if not self.overflow_seen:
            self.overflow_seen = True
            logger.info("mesh-group overflow traffic; host links requested")
        for b in self.brokers:
            if b is not None:
                b.host_links_kick.set()
        return super()._overflow()

    def try_stage(self, shard: int, message, raw: Bytes) -> StageResult:
        return self.stage_batch(shard, [(message, raw)])[0]

    def stage_batch(self, shard: int, items) -> List[StageResult]:
        """Stage ``(message, raw)`` pairs for member ``shard``, as
        :meth:`MeshGroup.stage_batch` stages their frames; a disabled
        group answers INELIGIBLE (the host path)."""
        if self.disabled:
            return [StageResult.INELIGIBLE] * len(items)
        results = super().stage_batch(
            shard, [frame_item(m, r) for m, r in items])
        if StageResult.STAGED in results:
            self._kick.set()
        return results

    # ---- the pump ---------------------------------------------------------

    async def _pump(self) -> None:
        c = self.config
        loop = asyncio.get_running_loop()
        gate = CoalesceGate(c.batch_window_s, c.coalesce_min_frames)
        while True:
            await self._kick.wait()
            self._kick.clear()
            await asyncio.sleep(0)  # let same-tick stagers land
            wait = gate.wait_s(self._staged_total(), loop.time())
            if wait:
                # steady trickle: coalesce one window; bursts after idle
                # and saturated pipelines step now
                await asyncio.sleep(wait)
            t0 = time.perf_counter()
            snap = self._snapshot()
            if snap is None:
                continue
            t1 = time.perf_counter()
            try:
                out, _upload_s, pairs_s = await asyncio.to_thread(
                    self._run_snapshot, snap)
                t2 = time.perf_counter()
                gate.stepped(loop.time())
                # each shard's deliveries go out through its own broker
                # (one stopped while the step ran gets none)
                delivered = sum(
                    egress_snapshot_frames(self.brokers[d.shard], self.slots,
                                           d.users, d.frames, d.length,
                                           d.bytes_)
                    for d in out if self.brokers[d.shard] is not None)
                t3 = time.perf_counter()
                self.messages_routed += delivered
                frames = (sum(int(b.valid.sum()) for lane in snap.batches
                              for b in lane)
                          + sum(int(d.valid.sum()) for lane in snap.directs
                                for d in lane))
                self.recent_steps.append(StepTiming(
                    t1 - t0, t2 - t1 - pairs_s, pairs_s, t3 - t2, frames,
                    delivered))
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception(
                    "mesh-group step failed; re-routing batches over host "
                    "links and disabling the group")
                self.disabled = True
                # frames staged (and acked STAGED) while the failing step
                # ran in the worker thread sit in the fresh rings: drain
                # them too, or they'd be lost with no fallback
                late = [[r.take_batch() for r in rings]
                        for rings in self.lane_rings]
                late_d = [[b.take_batch() for b in bkts]
                          for bkts in self.lane_buckets]
                for lane in snap.batches + late:
                    await self._host_fallback(lane)
                for lane in snap.directs + late_d:
                    await self._host_fallback_direct(lane)
                if self.fails_open:
                    return
                raise   # on the card: every member broker goes down
            finally:
                self._free_quarantined(snap)

    async def _host_fallback(self, batches) -> None:
        """Re-route one broadcast lane's staged frames (a batch per shard)
        over the host plane."""
        from pushcdn_tpu_torch.broker.tasks.handlers import (
            handle_broadcast_message,
            handle_direct_message,
        )
        members = self.member_idents()
        for shard, b in enumerate(batches):
            broker = self.brokers[shard]
            if broker is None:
                continue
            # staged broadcasts were already forwarded to interested
            # brokers outside the group at staging time: the fallback owes
            # only what the failed step owed, local users and the members
            out_of_group = frozenset(
                ident for ident in broker.connections.all_broker_identifiers()
                if ident not in members)
            for i in np.flatnonzero(b.valid):
                raw = Bytes(b.bytes_[i, :b.length[i]].tobytes())
                try:
                    message = deserialize(raw.data)
                    if isinstance(message, Direct):
                        await handle_direct_message(
                            broker, bytes(message.recipient), raw,
                            to_user_only=False)
                    elif isinstance(message, Broadcast):
                        await handle_broadcast_message(
                            broker, list(message.topics), raw,
                            to_users_only=False,
                            exclude_brokers=out_of_group)
                except Error:
                    pass
                finally:
                    raw.release()

    async def _host_fallback_direct(self, directs) -> None:
        """Re-route one direct lane's staged bucket frames (a batch per
        shard) over the host plane; the recipient is in the wire frame."""
        from pushcdn_tpu_torch.broker.tasks.handlers import (
            handle_direct_message,
        )
        for shard, d in enumerate(directs):
            broker = self.brokers[shard]
            if broker is None:
                continue
            dests, idx = np.nonzero(d.valid)
            for b_dest, i in zip(dests.tolist(), idx.tolist()):
                raw = Bytes(d.bytes_[b_dest, i, :d.length[b_dest, i]]
                            .tobytes())
                try:
                    message = deserialize(raw.data)
                    if isinstance(message, Direct):
                        await handle_direct_message(
                            broker, bytes(message.recipient), raw,
                            to_user_only=False)
                except Error:
                    pass
                finally:
                    raw.release()
