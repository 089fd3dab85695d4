"""The slice as a whole: the port's socket-free DevicePlane against the
JAX package's own pieces on the same snapshots.

A seeded scenario — user adds, subscription changes, removals with slot
quarantine, broadcast and direct frames over both lanes, oversized and
non-delivery frames — drives ``pushcdn_tpu_torch.broker.device_plane``
on the CPU. Beside it, ``JaxPlaneTwin`` wires the JAX package's
``UserSlots``, ``FrameRing``, ``RaggedInterest`` and single-chip routing
steps the way ``pushcdn_tpu.broker.device_plane`` wires them (snapshot,
quarantine, ragged overflow → dense → rebuild, then ``np.nonzero`` or
``ragged_pairs``). Every tick's staging results and per-lane
``(user, frame)`` pairs must be identical, and so must every user's
delivery sequence.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pushcdn_tpu.broker.pump_common import TopicMaskCache, effective_users
from pushcdn_tpu.ops.ragged_delivery import (
    RaggedInterest,
    ragged_pairs,
    ragged_pairs_grouped,
)
from pushcdn_tpu.parallel.crdt import ABSENT, CrdtState
from pushcdn_tpu.parallel.frames import (
    FrameRing,
    UserSlots,
    mask_mirror_shape,
    mask_of_topics,
    mask_row_of,
    slice_batch,
    stage_best_fit,
)
from pushcdn_tpu.parallel.router import (
    IngressBatch,
    RouterState,
    routing_step_lanes_single,
    routing_step_ragged_single,
)
from pushcdn_tpu.proto.error import Error
from pushcdn_tpu_torch.broker.device_plane import (
    DevicePlane,
    DevicePlaneConfig,
    StageResult,
)
from pushcdn_tpu_torch.proto.message import KIND_BROADCAST, KIND_DIRECT


class JaxPlaneTwin:
    """The reference plane built from the JAX package's pieces."""

    def __init__(self, c: DevicePlaneConfig):
        self.c = c
        self.slots = UserSlots(c.num_user_slots)
        self.rings = [FrameRing(slots=s, frame_bytes=f,
                                topic_words=c.topic_words)
                      for f, s in c.lane_shapes()]
        self.owned = np.zeros(c.num_user_slots, bool)
        self.masks = np.zeros(
            mask_mirror_shape(c.num_user_slots, c.topic_words), np.uint32)
        self.quarantine = []
        self.unmirrored = set()
        self.tmask = TopicMaskCache(c.topic_words)
        self.impl = c.delivery_impl
        self.ragged = None
        self.retry_below = 0
        if self.impl == "ragged":
            self.ragged = RaggedInterest(32 * c.topic_words,
                                         max_pages=c.ragged_max_pages)

    def _set_mask(self, slot, topics):
        if self.ragged is None:
            return
        self.ragged.set_mask(slot, mask_of_topics(topics, self.c.topic_words)
                             if topics else 0)
        if not self.ragged.overflowed:
            return
        if self.impl == "ragged":
            self.impl = "dense"
            self.retry_below = max(len(self.ragged) // 2, 1)
        elif len(self.ragged) <= self.retry_below:
            if self.ragged.rebuild():
                self.impl = "ragged"
            else:
                self.retry_below = max(len(self.ragged) // 2, 1)

    def on_user_added(self, key, topics):
        try:
            slot = self.slots.assign(key)
        except Error:
            self.unmirrored.add(key)
            return
        self.owned[slot] = True
        self.masks[slot] = mask_row_of(topics, self.c.topic_words)
        self._set_mask(slot, topics)

    def on_user_removed(self, key):
        self.unmirrored.discard(key)
        slot = self.slots.unmap(key)
        if slot is None:
            return
        self.owned[slot] = False
        self.masks[slot] = 0
        self._set_mask(slot, None)
        self.quarantine.append(slot)

    def on_subscription_changed(self, key, topics):
        slot = self.slots.slot_of(key)
        if slot is None:
            return
        self.masks[slot] = mask_row_of(topics, self.c.topic_words)
        self._set_mask(slot, topics)

    def stage_batch(self, items):
        out = [StageResult.INELIGIBLE] * len(items)
        if len(items) <= self.c.bypass_max_items and all(
                r.free_slots == r.slots for r in self.rings):
            return out
        for i, (kind, payload, target) in enumerate(items):
            if len(payload) > self.rings[-1].frame_bytes:
                continue
            if kind == KIND_BROADCAST:
                mask, oor = self.tmask.resolve(target)
                if self.unmirrored or oor or mask == 0:
                    continue
                ok = stage_best_fit(self.rings, len(payload),
                                    lambda r: r.push_broadcast(payload, mask))
            elif kind == KIND_DIRECT:
                slot = self.slots.slot_of(target)
                if slot is None:
                    continue
                ok = stage_best_fit(self.rings, len(payload),
                                    lambda r: r.push_direct(payload, slot))
            else:
                continue
            out[i] = StageResult.STAGED if ok else StageResult.FULL
        return out

    def step(self):
        if all(r.free_slots == r.slots for r in self.rings):
            return []
        c = self.c
        small = (self.rings[0].slots - self.rings[0].free_slots
                 <= c.latency_slots
                 and all(r.free_slots == r.slots for r in self.rings[1:]))
        batches = [r.take_batch() for r in self.rings]
        if small:
            batches = [slice_batch(batches[0], c.latency_slots)]
        u = effective_users(self.slots.high_water, c.num_user_slots)
        owned, masks = self.owned[:u].copy(), self.masks[:u].copy()
        walks = None
        if self.impl == "ragged":
            walks = [self.ragged.pack(b.kind, b.topic_mask, b.dest, b.valid,
                                      page_round=64) for b in batches]
            self.ragged.release_transient()
            if any(w.spilled for w in walks):
                walks = None
        quarantined, self.quarantine = self.quarantine, []
        owners = np.where(owned, 0, ABSENT).astype(np.int32)
        state = RouterState(
            CrdtState(jnp.asarray(owners), jnp.asarray(owned.astype(np.uint32)),
                      jnp.asarray(owners)), jnp.asarray(masks))

        def dev(b):
            return IngressBatch(
                jnp.zeros((b.valid.shape[0], 0), jnp.uint8),
                jnp.asarray(b.kind), jnp.asarray(b.length),
                jnp.asarray(b.topic_mask), jnp.asarray(b.dest),
                jnp.asarray(b.valid))

        jobs = []
        if walks is not None:
            for li, (b, w) in enumerate(zip(batches, walks)):
                if not b.valid.any():
                    continue
                res = routing_step_ragged_single(
                    state, dev(b), jnp.asarray(w.pages),
                    jnp.asarray(w.walk_page), jnp.asarray(w.walk_frame))
                out_user = np.asarray(res.out_user)
                if c.ragged_relaxed_order:
                    users, frames = ragged_pairs_grouped(
                        out_user, w, num_users=c.num_user_slots)
                else:
                    users, frames = ragged_pairs(
                        out_user, w.walk_frame, num_users=c.num_user_slots)
                if len(users):
                    jobs.append((li, users, frames, b))
        else:
            res = routing_step_lanes_single(
                state, tuple(dev(b) for b in batches), gather_bytes=False)
            for li, (b, lane) in enumerate(zip(batches, res.lanes)):
                if not b.valid.any():
                    continue
                users, frames = np.nonzero(np.asarray(lane.deliver))
                if len(users):
                    jobs.append((li, users, frames, b))
        for slot in quarantined:
            self.slots.free_slot(slot)
        return jobs


def _topics(rng, width, n_max=3):
    return sorted({int(t) for t in rng.integers(0, width,
                                                int(rng.integers(1, n_max + 1)))})


def _drive(impl, W, relaxed, max_pages, ticks=14, seed=0):
    cfg = DevicePlaneConfig(
        num_user_slots=48, ring_slots=16, frame_bytes=64,
        extra_lanes=((256, 4),), topic_words=W, latency_slots=4,
        bypass_max_items=0, delivery_impl=impl, ragged_max_pages=max_pages,
        ragged_relaxed_order=relaxed)
    plane = DevicePlane(cfg, device="cpu")
    twin = JaxPlaneTwin(cfg)
    rng = np.random.default_rng(seed)
    T = 32 * W
    users = {}          # key -> topics
    next_key = 0
    seq_port, seq_ref = {}, {}
    impls = []

    def add(width):
        nonlocal next_key
        key = b"user-%d" % next_key
        next_key += 1
        topics = _topics(rng, width)
        users[key] = topics
        plane.on_user_added(key, topics)
        twin.on_user_added(key, topics)

    for _ in range(20):
        add(4)
    for tick in range(ticks):
        # narrow interest first; a wide phase can overflow a small pool;
        # then the wide subscribers leave and the index can be rebuilt
        wide = 4 <= tick < 8
        width = T if wide else 4
        for _ in range(int(rng.integers(2, 8))):
            r = rng.random()
            keys = sorted(users)
            if r < 0.4 and len(users) < 46:
                add(width)
            elif r < 0.7 and keys:
                key = keys[int(rng.integers(0, len(keys)))]
                del users[key]
                plane.on_user_removed(key)
                twin.on_user_removed(key)
            elif keys:
                key = keys[int(rng.integers(0, len(keys)))]
                users[key] = _topics(rng, width)
                plane.on_subscription_changed(key, users[key])
                twin.on_subscription_changed(key, users[key])
        if tick == 8:   # the wide subscribers leave
            for key in sorted(users):
                if max(users[key]) >= 4 or rng.random() < 0.5:
                    del users[key]
                    plane.on_user_removed(key)
                    twin.on_user_removed(key)
        items = []
        keys = sorted(users)
        for _ in range(int(rng.integers(0, 24))):
            size = int(rng.choice([8, 40, 64, 65, 200, 256, 300]))
            payload = bytes(rng.integers(0, 256, size, dtype=np.uint8))
            r = rng.random()
            if r < 0.65:
                items.append((KIND_BROADCAST, payload, _topics(rng, width, 2)))
            elif r < 0.9 and keys:
                key = keys[int(rng.integers(0, len(keys)))]
                if rng.random() < 0.1:
                    key = b"nobody"
                items.append((KIND_DIRECT, payload, key))
            else:
                items.append((6, payload, [0]))
        got = plane.stage_frames(items)
        assert got == twin.stage_batch(items), f"tick {tick}"
        port_jobs = plane.step()
        ref_jobs = twin.step()
        assert plane.delivery_impl == twin.impl
        impls.append(plane.delivery_impl)
        assert len(port_jobs) == len(ref_jobs), f"tick {tick}"
        for p, (li, users_r, frames_r, b) in zip(port_jobs, ref_jobs):
            assert p.lane == li
            np.testing.assert_array_equal(p.users, users_r)
            np.testing.assert_array_equal(p.frames, frames_r)
            np.testing.assert_array_equal(p.length, b.length)
            np.testing.assert_array_equal(p.bytes_, b.bytes_)
            for seq, jb, us, fs in ((seq_port, p, p.users, p.frames),
                                    (seq_ref, b, users_r, frames_r)):
                length = jb.length
                data = jb.bytes_
                for u, f in zip(us.tolist(), fs.tolist()):
                    seq.setdefault(u, []).append(
                        data[f, :length[f]].tobytes())
    assert seq_port == seq_ref
    assert sum(len(v) for v in seq_port.values()) > 50
    return plane, impls


@pytest.mark.parametrize("impl,W,relaxed", [
    ("dense", 1, False), ("dense", 8, False), ("ragged", 1, True),
    ("ragged", 8, False)])
def test_plane_matches_jax_pieces(impl, W, relaxed):
    plane, impls = _drive(impl, W, relaxed, max_pages=1024)
    assert set(impls) == {impl}
    assert plane.steps > 0
    if impl == "ragged":
        assert plane.ragged_steps > 0


def test_ragged_overflow_demotes_to_dense_then_rebuilds():
    """A small page pool: the wide phase overflows it (dense ticks), and
    once the wide subscribers leave the index is rebuilt (ragged again)."""
    plane, impls = _drive("ragged", 8, False, max_pages=8, seed=3)
    assert impls[0] == "ragged"
    assert "dense" in impls
    assert impls[-1] == "ragged"
    assert plane.ragged_steps > 0


def test_quarantined_slot_is_not_reused_before_the_step():
    cfg = DevicePlaneConfig(num_user_slots=2, ring_slots=4, frame_bytes=32,
                            extra_lanes=(), bypass_max_items=0)
    plane = DevicePlane(cfg, device="cpu")
    plane.on_user_added(b"a", [0])
    plane.on_user_added(b"b", [0])
    plane.on_user_removed(b"a")
    plane.on_user_added(b"c", [0])      # table full: a's slot quarantined
    assert plane.slots.slot_of(b"c") is None
    # while an unmirrored user exists, broadcasts stay on the host path
    assert plane.stage_frames([(KIND_BROADCAST, b"x", [0])]) == \
        [StageResult.INELIGIBLE]
    plane.on_user_removed(b"c")
    assert plane.stage_frames([(KIND_BROADCAST, b"x", [0])]) == \
        [StageResult.STAGED]
    (lane,) = plane.step()
    assert lane.users.tolist() == [1]   # only b; a's slot delivered nothing
    # the socket-free step records its timing as the pump does
    (timing,) = plane.recent_steps
    assert (timing.frames, timing.deliveries, timing.egress_s) == (1, 1, 0.0)
    assert plane.messages_routed == 1
    plane.on_user_added(b"d", [0])
    assert plane.slots.slot_of(b"d") == 0   # recycled after the step


@pytest.mark.parametrize("inflight", [False, True])
def test_broker_staging_api_and_idle_bypass_match_jax(inflight):
    """``try_stage`` and ``stage_batch`` take decoded ``(message, raw)``
    pairs as the JAX plane's do, and answer the same: an idle plane with
    no step in flight sends a small batch to the host path at once; with
    a step in flight it stages, so no frame overtakes the step."""
    from pushcdn_tpu.broker.device_plane import DevicePlane as JaxPlane
    from pushcdn_tpu.broker.device_plane import \
        DevicePlaneConfig as JaxConfig
    from pushcdn_tpu.proto import message as jax_message
    from pushcdn_tpu.proto.limiter import Bytes as JaxBytes
    from pushcdn_tpu_torch.proto import message as port_message
    from pushcdn_tpu_torch.proto.limiter import Bytes
    from pushcdn_tpu_torch.proto.message import (
        Broadcast,
        Direct,
        Subscribe,
        serialize,
    )

    kw = dict(num_user_slots=4, ring_slots=4, frame_bytes=64,
              extra_lanes=((128, 2),), topic_words=1, bypass_max_items=2)
    port = DevicePlane(DevicePlaneConfig(**kw), device="cpu")
    ref = JaxPlane(None, JaxConfig(**kw))
    frames = [serialize(m) for m in (
        Broadcast([1], b"a"), Direct(b"u", b"b"), Broadcast([40], b"c"),
        Direct(b"nobody", b"d"), Broadcast([1], b"e" * 100),
        Broadcast([1], b"f" * 200), Subscribe([1]), Broadcast([1], b"g"))]
    for plane, wrap, m in ((port, Bytes, port_message),
                           (ref, JaxBytes, jax_message)):
        plane.on_user_added(b"u", [1])
        plane._step_inflight = inflight
        plane.results = [plane.try_stage(m.deserialize(f), wrap(f))
                         for f in frames[:2]]
        plane.results += plane.stage_batch(
            [(m.deserialize(f), wrap(f)) for f in frames[:2]])
        plane.results += plane.stage_batch(
            [(m.deserialize(f), wrap(f)) for f in frames])
    assert [r.name for r in port.results] == [r.name for r in ref.results]
    staged = [r.name for r in port.results[:4]]
    assert staged == (["STAGED"] * 4 if inflight else ["INELIGIBLE"] * 4)
    # with a step in flight the base lane is full by now: the small
    # frames fall to the wide lane until it fills too
    full = "FULL" if inflight else "STAGED"
    assert [r.name for r in port.results[4:]] == [
        "STAGED", "STAGED", "INELIGIBLE", "INELIGIBLE", full,
        "INELIGIBLE", "INELIGIBLE", full]
