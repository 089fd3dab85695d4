"""DevicePlane — the routing decision for a broker's local users, on the
device.

Eligible messages (wire frames that fit a lane's slot) are staged into
the size-bucketed frame rings and routed in batched device steps. Frame
bytes never go to the device: only metadata is uploaded, and only the
decision — per lane, the ``(user, frame)`` delivery pairs — comes back;
each delivered frame then goes verbatim from the host ring snapshot to
the user's connection, so receivers are byte-identical with the host
path.

Two ways to drive it:

- **attached to a broker** (``DevicePlane(config, device, broker=b)``,
  what ``Broker.new(BrokerConfig(device_plane=...))`` builds): the user
  receive loop stages each eligible frame (``try_stage``/``stage_batch``
  with ``(message, raw)`` items, as in the JAX package), :meth:`start`
  spawns an asyncio pump that steps the plane in a worker thread, and
  the pump writes every delivered frame to the users' connections
  (``senders.egress_delivery_rows``);
- **socket-free**: :meth:`stage_frames` takes ``(kind, payload, target)``
  items and :meth:`step` returns the per-lane pairs plus the lane's host
  ``length`` and ``bytes_`` arrays.

Consistency design (single-writer, snapshot-per-step):

- The **host mirrors** (``_owned`` bool[U], ``_masks`` u32[U] or
  u32[U, W]) are the source of truth, mutated only by the observer hooks
  (``on_user_added``, ``on_user_removed``, ``on_subscription_changed``).
  Each step SNAPSHOTS them together with ``take_batch()``, and the device
  ``RouterState`` is rebuilt from that snapshot — re-uploaded only when
  the mirror revision moved.
- **Slot quarantine**: a released user slot is not reusable until the
  step that might still carry frames addressed to it has completed.
- **Ragged index**: under ``delivery_impl="ragged"`` the per-topic page
  index (``RaggedInterest``) is maintained from the same hooks; page-pool
  exhaustion demotes the plane to the dense step, and once membership
  halves a rebuild is tried and the plane returns to the page walk.
- **Pump snapshot on the loop**: the pump takes the snapshot (the
  rings, the mirrors, the ragged walk, the quarantine swap) in one
  event-loop step, so an observer hook racing the threaded step lands in
  the next snapshot; only the device step runs in the worker thread, and
  quarantined slots are freed on the loop after it returns.
- **Failure**: under the pump, a step that raises disables the plane and
  re-routes the failed batch and the frames staged meanwhile on the host
  path (users only), so no acknowledged frame is lost; staging then
  always answers INELIGIBLE. On the CPU the broker serves on as a plain
  host broker, as the JAX package's does; on the card the pump then ends
  with the step's exception, and a warm-up that fails raises out of
  :meth:`start`, so a kernel that does not build or launch brings the
  broker down (``Broker.run_until_failure``) instead of passing as a
  host broker. The socket-free ``step()`` raises to its caller.

Egress is Python (``senders.egress_delivery_rows``); the JAX package's
native egress engine is not copied yet.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, List, NamedTuple, Optional

import numpy as np
import torch

from pushcdn_tpu_torch._device import DeviceLike, resolve_device
from pushcdn_tpu_torch.broker.pump_common import (
    CoalesceGate,
    RevCache,
    TopicMaskCache,
    effective_users,
    egress_snapshot_frames,
)
from pushcdn_tpu_torch.broker.staging import StageResult, frame_item
from pushcdn_tpu_torch.ops.ragged_delivery import (
    RaggedInterest,
    ragged_pairs,
    ragged_pairs_grouped,
)
from pushcdn_tpu_torch.parallel import router as _router
from pushcdn_tpu_torch.parallel.crdt import ABSENT, CrdtState
from pushcdn_tpu_torch.parallel.frames import (
    TOPIC_WORDS_FULL,
    FrameRing,
    UserSlots,
    mask_mirror_shape,
    mask_of_topics,
    mask_row_of,
    slice_batch,
)
from pushcdn_tpu_torch.parallel.router import (
    IngressBatch,
    RouterState,
    routing_step_lanes_single,
    routing_step_ragged_single,
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

logger = logging.getLogger("pushcdn.broker.device")

__all__ = ["DevicePlane", "DevicePlaneConfig", "LaneDeliveries",
           "StageResult", "StepTiming"]


@dataclass
class DevicePlaneConfig:
    num_user_slots: int = 1024
    ring_slots: int = 1024
    frame_bytes: int = 2048
    # Size-bucketed lanes beyond the base (ring_slots × frame_bytes) ring:
    # each entry is (frame_bytes, ring_slots). A frame is staged into the
    # smallest lane it fits.
    extra_lanes: tuple = ((16384, 64),)
    # u32 words per topic mask: 8 covers the reference's whole u8 topic
    # space; 1 keeps compact masks for deployments with ≤32 topics
    topic_words: int = TOPIC_WORDS_FULL
    # Adaptive coalescing for a pump driving step() (pump_common
    # .CoalesceGate): step at once on a burst after idle or when
    # >= coalesce_min_frames are staged; a steady trickle waits
    # batch_window_s.
    batch_window_s: float = 0.001
    coalesce_min_frames: int = 16
    # prefix-slice the base lane to this many slots when only it is busy
    # and holds at most this many frames (sparse traffic)
    latency_slots: int = 8
    # Depth-1 bypass: when the rings are empty and at most this many
    # messages arrive in one batch, staging answers INELIGIBLE so the
    # caller routes them on its host path at once. 0 disables.
    bypass_max_items: int = 2
    # "auto" follows router.DELIVERY_IMPL (dense unless set); "ragged"
    # selects the page walk; "dense" the delivery matrix
    delivery_impl: str = "auto"
    # page-pool capacity for the ragged interest index (PAGE-slot pages;
    # exhaustion falls the plane back to the dense step, never drops)
    ragged_max_pages: int = 1024
    # Relaxed-order pair extraction (ragged_pairs_grouped): a multi-topic
    # subscriber's same-tick frames arrive grouped per topic mask instead
    # of in staging order. Off by default: the strict extractor keeps
    # per-user order identical to the dense plane.
    ragged_relaxed_order: bool = False

    def lane_shapes(self):
        """All lanes as (frame_bytes, ring_slots), sorted ascending by
        frame width (best-fit staging walks this order)."""
        return sorted(((self.frame_bytes, self.ring_slots),)
                      + tuple(self.extra_lanes))


class LaneDeliveries(NamedTuple):
    """One lane's routing decision for one step: pair ``i`` delivers
    frame ``frames[i]`` (an index into ``length``/``bytes_``) to user slot
    ``users[i]``; pairs are grouped per user, frames ascending within a
    user (relaxed order aside)."""

    lane: int
    users: np.ndarray    # int[P]
    frames: np.ndarray   # int[P]
    length: np.ndarray   # int32[S] — the lane's payload lengths
    bytes_: np.ndarray   # uint8[S, F] — the lane's host frame bytes


class StepTiming(NamedTuple):
    """One step, in seconds, with its frame and delivery counts."""

    snapshot_s: float   # rings, mirrors and ragged walk (on the loop)
    device_s: float     # upload, kernels and readback
    pairs_s: float      # pair extraction
    egress_s: float     # delivered frames queued to the connections
                        # (0 for the socket-free step())
    frames: int         # frames the step routed
    deliveries: int     # what messages_routed adds: the pairs step()
                        # returns, or the frames the pump queued to users


class _Snapshot(NamedTuple):
    batches: list
    owned: np.ndarray
    masks: np.ndarray
    state_rev: int
    walks: Optional[list]
    quarantined: List[int]


class DevicePlane:
    """The device plane: staging, host mirrors, the step and, attached to
    a broker, the pump with its egress and host fallback."""

    # single-shard plane: inter-broker fan-out stays on the host links
    covers_brokers = False

    def __init__(self, config: Optional[DevicePlaneConfig] = None,
                 device: DeviceLike = None,
                 broker: Optional["Broker"] = None):
        self.device = resolve_device(device)
        self.config = config or DevicePlaneConfig()
        self.broker = broker
        c = self.config
        self.slots = UserSlots(c.num_user_slots)
        self.rings = [FrameRing(slots=s, frame_bytes=f,
                                topic_words=c.topic_words)
                      for f, s in c.lane_shapes()]
        self._owned = np.zeros(c.num_user_slots, bool)
        self._masks = np.zeros(
            mask_mirror_shape(c.num_user_slots, c.topic_words), np.uint32)
        self._quarantine: List[int] = []   # slots awaiting step completion
        # users the slot table couldn't hold: broadcasts stay on the host
        # path while any exist (they'd miss device-only fan-out)
        self._unmirrored: set[bytes] = set()
        self._state_rev = 0
        self._state_cache = RevCache()
        self._tmask_cache = TopicMaskCache(c.topic_words)
        self._idle_dev_lanes: dict = {}
        self._byte_stubs: dict = {}
        impl = c.delivery_impl
        if impl == "auto":
            impl = _router.DELIVERY_IMPL or "dense"
        self.delivery_impl = "ragged" if impl == "ragged" else "dense"
        self._ragged: Optional[RaggedInterest] = None
        self._ragged_retry_below = 0  # rebuild-retry mark post-overflow
        if self.delivery_impl == "ragged":
            self._ragged = RaggedInterest(
                32 * c.topic_words, max_pages=c.ragged_max_pages)
        self.ragged_steps = 0       # ticks routed through the page walk
        self.ragged_fallbacks = 0   # ticks that fell back to dense
        self.steps = 0
        self.messages_routed = 0
        # the recent steps (StepTiming), newest last
        self.recent_steps: collections.deque = collections.deque(
            maxlen=4096)
        self.disabled = False
        # the heartbeat's fail-open check reads this off any plane; a
        # single-shard plane never needs host links for overflow
        self.overflow_seen = False
        self._kick = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._step_inflight = False

    @property
    def fails_open(self) -> bool:
        """Whether a failed warm-up or pump step leaves the broker serving
        on its host path (the CPU, as in the JAX package) rather than
        raising (the card)."""
        return self.device.type != "cuda"

    @property
    def pump_task(self) -> Optional[asyncio.Task]:
        """The running pump, once :meth:`start` has spawned it."""
        return self._task

    # ---- user lifecycle (observer hooks) ---------------------------------

    def _ragged_set_mask(self, slot: int, topics) -> None:
        """Mirror a mask change into the ragged page index. Pool
        exhaustion falls the plane back to the dense step — never a
        dropped delivery — and once membership shrinks to half the
        overflow-time population a ``rebuild()`` is attempted (the retry
        mark halves on failure)."""
        if self._ragged is None:
            return
        self._ragged.set_mask(
            slot, mask_of_topics(topics, self.config.topic_words)
            if topics else 0)
        if not self._ragged.overflowed:
            return
        if self.delivery_impl == "ragged":
            logger.warning(
                "ragged page pool exhausted (%d pages); device plane "
                "falling back to the dense delivery step",
                self.config.ragged_max_pages)
            self.delivery_impl = "dense"
            self._ragged_retry_below = max(len(self._ragged) // 2, 1)
        elif len(self._ragged) <= self._ragged_retry_below:
            if self._ragged.rebuild():
                logger.info("ragged page index rebuilt (%d users); "
                            "resuming paged delivery", len(self._ragged))
                self.delivery_impl = "ragged"
            else:
                self._ragged_retry_below = max(len(self._ragged) // 2, 1)

    def on_user_added(self, public_key: bytes, topics) -> None:
        try:
            slot = self.slots.assign(public_key)
        except Error:
            # table full: this user is host-routed only
            self._unmirrored.add(public_key)
            logger.warning("device user-slot table full; %d unmirrored users",
                           len(self._unmirrored))
            return
        self._owned[slot] = True
        self._masks[slot] = mask_row_of(topics, self.config.topic_words)
        self._ragged_set_mask(slot, topics)
        self._state_rev += 1

    def on_user_removed(self, public_key: bytes) -> None:
        self._unmirrored.discard(public_key)
        slot = self.slots.unmap(public_key)
        if slot is None:
            return
        self._owned[slot] = False
        self._masks[slot] = 0
        self._ragged_set_mask(slot, None)
        self._state_rev += 1
        # the slot index stays quarantined until the next step completes
        self._quarantine.append(slot)

    def on_subscription_changed(self, public_key: bytes, topics) -> None:
        slot = self.slots.slot_of(public_key)
        if slot is None:
            return
        self._masks[slot] = mask_row_of(topics, self.config.topic_words)
        self._ragged_set_mask(slot, topics)
        self._state_rev += 1

    # ---- ingress ----------------------------------------------------------

    def _idle_bypass(self, n_items: int) -> bool:
        """True when the latency regime should skip the device: nothing
        staged, no step in flight, and the arriving batch is small."""
        return (n_items <= self.config.bypass_max_items
                and not self._step_inflight
                and all(r.free_slots == r.slots for r in self.rings))

    def try_stage(self, message, raw: Bytes) -> StageResult:
        """Stage one decoded message's WIRE FRAME for device routing.
        INELIGIBLE ⇒ host path; FULL ⇒ slot-credit backpressure, the
        caller retries."""
        return self.stage_frames([frame_item(message, raw)])[0]

    def stage_batch(self, items) -> List[StageResult]:
        """Stage a whole receive batch of ``(message, raw)`` pairs in one
        pass; returns a ``StageResult`` per item, aligned with ``items``
        (FULL items are the leftovers the caller retries singly)."""
        return self.stage_frames([frame_item(m, r) for m, r in items])

    def stage_frames(self, items) -> List[StageResult]:
        """Stage a batch of ``(kind, payload, target)`` items, where
        ``payload`` is the wire frame and ``target`` the topic list of a
        ``KIND_BROADCAST`` frame or the recipient's public key of a
        ``KIND_DIRECT`` frame. Each eligible frame goes to the smallest
        lane it fits with a free slot; each lane's group is packed with
        one ``FrameRing.push_batch``.

        INELIGIBLE ⇒ host path (plane disabled, too big, unknown
        recipient, unmirrored users present, a topic outside the
        configured space, no topics, another kind, or the idle bypass);
        FULL ⇒ backpressure, retry."""
        results = [StageResult.INELIGIBLE] * len(items)
        if self.disabled or self._idle_bypass(len(items)):
            return results
        groups: dict[int, list] = {}   # lane -> [(idx, frame, kind, mask, dest)]
        free = [r.free_slots for r in self.rings]
        widest = self.rings[-1].frame_bytes
        for idx, (kind, payload, target) in enumerate(items):
            frame = bytes(payload)
            if len(frame) > widest:
                continue
            if kind == KIND_BROADCAST:
                if self._unmirrored:
                    continue
                mask, out_of_range = self._tmask_cache.resolve(target)
                if out_of_range or mask == 0:
                    continue
                dest = -1
            elif kind == KIND_DIRECT:
                dest = self.slots.slot_of(bytes(target))
                if dest is None:
                    continue
                mask = 0
            else:
                continue
            placed = False
            for li, ring in enumerate(self.rings):
                if len(frame) <= ring.frame_bytes and free[li] > 0:
                    free[li] -= 1
                    groups.setdefault(li, []).append(
                        (idx, frame, kind, mask, dest))
                    placed = True
                    break
            results[idx] = StageResult.STAGED if placed else StageResult.FULL
        staged_any = False
        for li, group in groups.items():
            n = self.rings[li].push_batch(
                [g[1] for g in group], [g[2] for g in group],
                [g[3] for g in group], [g[4] for g in group])
            staged_any = staged_any or n > 0
            for idx, *_ in group[n:]:
                results[idx] = StageResult.FULL
        if staged_any:
            self._kick.set()
        return results

    def covered_broker_idents(self) -> set:
        """Broker identifiers whose delivery this plane covers — none for
        the single-shard plane (host links handle all peers)."""
        return set()

    # ---- the step -----------------------------------------------------------

    def _pack_walks(self, batches):
        """Pack one walk list per lane. Returns None when any frame
        spilled (transient-page exhaustion) — the dense step covers that
        tick."""
        walks = []
        spilled = False
        for b in batches:
            w = self._ragged.pack(b.kind, b.topic_mask, b.dest, b.valid,
                                  page_round=64)
            walks.append(w)
            spilled = spilled or bool(w.spilled)
        # pack() snapshots the pool, so transient pages recycle at once
        self._ragged.release_transient()
        if spilled:
            self.ragged_fallbacks += 1
            return None
        return walks

    def _idle(self) -> bool:
        return all(r.free_slots == r.slots for r in self.rings)

    def _snapshot(self) -> Optional[_Snapshot]:
        """Take everything staged with the mirrors it routes against: the
        rings' batches (the base lane prefix-sliced to ``latency_slots``
        when only it is busy with at most that many frames), the mirrors
        up to the slot high-water mark, the ragged walk, and the slots
        quarantined so far. None when nothing is staged. Under the pump
        this runs on the event loop, where the observer hooks run."""
        if self._idle():
            return None
        c = self.config
        lat = c.latency_slots
        small = (self.rings[0].slots - self.rings[0].free_slots <= lat
                 and all(r.free_slots == r.slots for r in self.rings[1:]))
        batches = [r.take_batch() for r in self.rings]
        if small:
            batches = [slice_batch(batches[0], lat)]
        u_eff = effective_users(self.slots.high_water, c.num_user_slots)
        walks = self._pack_walks(batches) \
            if self.delivery_impl == "ragged" else None
        quarantined, self._quarantine = self._quarantine, []
        return _Snapshot(batches, self._owned[:u_eff].copy(),
                         self._masks[:u_eff].copy(), self._state_rev, walks,
                         quarantined)

    def _free_quarantined(self, snap: _Snapshot) -> None:
        for slot in snap.quarantined:  # the step is over: safe to recycle
            self.slots.free_slot(slot)

    def step(self) -> List[LaneDeliveries]:
        """Route everything staged: snapshot the rings and mirrors, run
        the dense or the ragged device step, and return the delivery
        pairs of every lane that delivered something. Raises if the step
        fails."""
        t0 = time.perf_counter()
        snap = self._snapshot()
        if snap is None:
            return []
        t1 = time.perf_counter()
        try:
            out, pairs_s = self._run_step(snap.batches, snap.owned,
                                          snap.masks, snap.state_rev,
                                          snap.walks)
        finally:
            self._free_quarantined(snap)
        pairs = sum(len(j.users) for j in out)
        self.recent_steps.append(StepTiming(
            t1 - t0, time.perf_counter() - t1 - pairs_s, pairs_s, 0.0,
            sum(b.num_valid for b in snap.batches), pairs))
        self.messages_routed += pairs
        return out

    # ---- the pump (attached to a broker) ------------------------------------

    async def start(self) -> None:
        """Warm both lane shapes up off the event loop (the first launch
        of each kernel builds and loads it), then spawn the pump. On the
        card a warm-up that fails raises here."""
        await asyncio.to_thread(self._warmup)
        self._task = asyncio.create_task(self._pump(), name="device-pump")

    def _warmup(self) -> None:
        """Run the two shapes the pump uses once: all lanes at full size
        and the latency-sliced base lane. A failure disables a plane that
        fails open and raises on the card."""
        empty = [r.take_batch() for r in self.rings]
        lat = [slice_batch(empty[0], self.config.latency_slots)]
        u0 = effective_users(0, self.config.num_user_slots)
        steps = self.steps
        try:
            walks = self._pack_walks(empty) \
                if self.delivery_impl == "ragged" else None
            for batches in (empty, lat):
                self._run_step(batches, self._owned[:u0].copy(),
                               self._masks[:u0].copy(), None,
                               None if walks is None else walks[:len(batches)],
                               warmup=True)
        except Exception:
            if not self.fails_open:
                raise
            logger.exception("device-plane warmup step failed")
            self.disabled = True
        finally:
            self.steps = steps  # warmup doesn't count

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            except Exception:
                logger.exception("device pump died during stop")

    async def _pump(self) -> None:
        c = self.config
        loop = asyncio.get_running_loop()
        gate = CoalesceGate(c.batch_window_s, c.coalesce_min_frames)
        while True:
            await self._kick.wait()
            self._kick.clear()
            await asyncio.sleep(0)  # let same-tick stagers land
            staged = sum(r.slots - r.free_slots for r in self.rings)
            wait = gate.wait_s(staged, loop.time())
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
                self._step_inflight = True
                try:
                    jobs, pairs_s = await asyncio.to_thread(
                        self._run_step, snap.batches, snap.owned,
                        snap.masks, snap.state_rev, snap.walks)
                finally:
                    self._step_inflight = False
                t2 = time.perf_counter()
                gate.stepped(loop.time())
                delivered = sum(
                    egress_snapshot_frames(self.broker, self.slots, j.users,
                                           j.frames, j.length, j.bytes_)
                    for j in jobs)
                t3 = time.perf_counter()
                self.messages_routed += delivered
                self.recent_steps.append(StepTiming(
                    t1 - t0, t2 - t1 - pairs_s, pairs_s, t3 - t2,
                    sum(b.num_valid for b in snap.batches), delivered))
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception(
                    "device routing step failed; re-routing the batch on "
                    "the host path and disabling the device plane")
                self.disabled = True
                # frames staged (and acked STAGED) while the failing step
                # ran in the worker thread sit in the fresh rings: drain
                # them too, or they'd be lost with no fallback
                late = [r.take_batch() for r in self.rings]
                await self._host_fallback(snap.batches)
                await self._host_fallback(late)
                if self.fails_open:
                    return
                raise   # on the card: the broker goes down with it
            finally:
                self._free_quarantined(snap)

    async def _host_fallback(self, lane_batches) -> None:
        """Deliver batches the device failed to route, via the host path.
        Users only on purpose: any broker-bound fan-out for these messages
        already ran on the host at staging time."""
        from pushcdn_tpu_torch.broker.tasks.handlers import (
            handle_broadcast_message,
            handle_direct_message,
        )
        for b in lane_batches:
            for i in np.flatnonzero(b.valid):
                raw = Bytes(b.bytes_[i, :b.length[i]].tobytes())
                try:
                    message = deserialize(raw.data)
                    if isinstance(message, Direct):
                        await handle_direct_message(
                            self.broker, bytes(message.recipient), raw,
                            to_user_only=True)
                    elif isinstance(message, Broadcast):
                        await handle_broadcast_message(
                            self.broker, list(message.topics), raw,
                            to_users_only=True)
                except Error:
                    pass
                finally:
                    raw.release()

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _run_step(self, lane_batches, owned: np.ndarray, masks: np.ndarray,
                  state_rev: Optional[int], walks, warmup: bool = False):
        """The device step against the snapshotted mirrors (under the
        pump, in a worker thread). Idle lanes reuse cached device-side
        empty batches; zero-width byte stubs stand in for the frame bytes
        (``gather_bytes=False``). Returns the lanes' deliveries and the
        seconds spent extracting pairs. ``warmup`` routes every lane
        whatever its traffic (idle ragged lanes too) and delivers
        nothing."""
        up = self._upload

        def build_state():
            owners = np.where(owned, 0, ABSENT).astype(np.int32)
            return RouterState(
                crdt=CrdtState(owners=up(owners),
                               versions=up(owned.astype(np.int64)),
                               identities=up(owners)),
                topic_masks=up(masks.view(np.int32)))

        state = self._state_cache.get(state_rev, build_state)

        def stub(n):
            st = self._byte_stubs.get(n)
            if st is None:
                st = self._byte_stubs[n] = torch.zeros(
                    (n, 0), dtype=torch.uint8, device=self.device)
            return st

        def to_dev(li, b, busy):
            key = (li, b.valid.shape[0])
            if not busy and key in self._idle_dev_lanes:
                return self._idle_dev_lanes[key]
            dev = IngressBatch(
                stub(b.valid.shape[0]), up(b.kind), up(b.length),
                up(b.topic_mask.view(np.int32)), up(b.dest), up(b.valid))
            if not busy:
                self._idle_dev_lanes[key] = dev
            return dev

        busy = [bool(b.valid.any()) for b in lane_batches]
        jobs: List[LaneDeliveries] = []
        pairs_s = 0.0
        self.steps += 1

        if walks is not None:
            for li, (b, walk) in enumerate(zip(lane_batches, walks)):
                if not busy[li] and not warmup:
                    continue  # an idle lane has no walk entries
                res = routing_step_ragged_single(
                    state, to_dev(li, b, busy[li]), up(walk.pages),
                    up(walk.walk_page), up(walk.walk_frame))
                out_user = res.out_user.cpu().numpy()
                if warmup:
                    continue
                t = time.perf_counter()
                if self.config.ragged_relaxed_order:
                    users, frames = ragged_pairs_grouped(
                        out_user, walk, num_users=self.config.num_user_slots)
                else:
                    users, frames = ragged_pairs(
                        out_user, walk.walk_frame,
                        num_users=self.config.num_user_slots)
                pairs_s += time.perf_counter() - t
                if len(users):
                    jobs.append(LaneDeliveries(li, users, frames, b.length,
                                               b.bytes_))
            if not warmup:
                self.ragged_steps += 1
        else:
            batches = tuple(to_dev(li, b, busy[li])
                            for li, b in enumerate(lane_batches))
            result = routing_step_lanes_single(state, batches,
                                               gather_bytes=False)
            for li, lane in enumerate(result.lanes):
                if not busy[li] and not warmup:
                    continue  # an idle lane can't deliver: skip its copy
                deliver = lane.deliver.cpu().numpy()
                if warmup:
                    continue
                t = time.perf_counter()
                users, frames = np.nonzero(deliver)
                pairs_s += time.perf_counter() - t
                if len(users):
                    b = lane_batches[li]
                    jobs.append(LaneDeliveries(li, users, frames, b.length,
                                               b.bytes_))
        return jobs, pairs_s
