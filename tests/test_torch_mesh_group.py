"""The socket-free MeshGroup against the JAX package's pieces, tick by
tick.

A seeded scenario — claims on every shard, releases with slot
quarantine, mask updates, in-group double connects, a full slot table,
a shard stopped mid-run, broadcasts and directs on both lanes from every
shard, oversized, unknown-recipient and out-of-range-topic items, sparse
ticks that take the latency slice and idle ticks — drives
``pushcdn_tpu_torch.broker.mesh_group.MeshGroup`` with every shard on
the CPU. Beside it, ``JaxMeshGroupTwin`` wires the JAX package's
``UserSlots``, ``FrameRing``, ``DirectBuckets`` and
``make_mesh_lane_step`` (on the virtual CPU mesh) the way
``pushcdn_tpu/broker/mesh_group.py`` wires them. Every claim's kick,
every staging result, every tick's per-shard ``(user, frame)`` pairs
with their lengths and bytes, and every user's delivery sequence must
be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pushcdn_tpu.broker.pump_common import TopicMaskCache, effective_users
from pushcdn_tpu.parallel.crdt import ABSENT, CrdtState
from pushcdn_tpu.parallel.frames import (
    DirectBuckets,
    FrameRing,
    UserSlots,
    mask_mirror_shape,
    mask_row_of,
    slice_batch,
    slice_direct_batch,
    stage_best_fit,
)
from pushcdn_tpu.parallel.mesh import make_broker_mesh as jax_mesh
from pushcdn_tpu.parallel.router import (
    DirectIngress,
    IngressBatch,
    RouterState,
    make_mesh_lane_step,
)
from pushcdn_tpu.proto.error import Error
from pushcdn_tpu_torch.broker.device_plane import StageResult
from pushcdn_tpu_torch.broker.mesh_group import MeshGroup, MeshGroupConfig
from pushcdn_tpu_torch.parallel.mesh import make_broker_mesh
from pushcdn_tpu_torch.proto.message import KIND_BROADCAST, KIND_DIRECT

BATCH = ("bytes_", "kind", "length", "topic_mask", "dest", "valid")
DIRECT = ("bytes_", "length", "dest", "valid")


class JaxMeshGroupTwin:
    """The reference group built from the JAX package's pieces, wired as
    ``MeshBrokerGroup`` wires them (minus its pump and brokers)."""

    def __init__(self, n: int, c: MeshGroupConfig):
        self.n, self.c = n, c
        self.step_fn = make_mesh_lane_step(
            jax_mesh(n), gather_bytes=c.gather_frame_bytes,
            fused=c.fused_collective)
        self.lane_rings = [[FrameRing(slots=s, frame_bytes=f,
                                      topic_words=c.topic_words)
                            for _ in range(n)] for f, s, _d in c.lane_shapes()]
        self.lane_buckets = [[DirectBuckets(n, capacity=d, frame_bytes=f)
                              for _ in range(n)]
                             for f, _s, d in c.lane_shapes()]
        self.slots = UserSlots(c.num_user_slots)
        self.owner = np.full(c.num_user_slots, ABSENT, np.int32)
        self.version = np.zeros(c.num_user_slots, np.uint32)
        self.masks = np.zeros(
            mask_mirror_shape(c.num_user_slots, c.topic_words), np.uint32)
        self.quarantine = []
        self.unmirrored = {}
        self.live = np.ones(n, bool)
        self.tmask = TopicMaskCache(c.topic_words)
        self.dirty = False
        self.overflows = 0

    def claim_user(self, shard, key, topics):
        try:
            slot = self.slots.assign(key)
        except Error:
            self.unmirrored[key] = shard
            return None
        kicked = None
        prev = int(self.owner[slot])
        if prev != ABSENT and prev != shard and self.live[prev]:
            # the old shard's session is removed: its observer releases
            self.release_user(prev, key)
            kicked = (prev, key)
            try:
                slot = self.slots.assign(key)
            except Error:
                self.unmirrored[key] = shard
                return kicked
        self.owner[slot] = shard
        self.version[slot] += 1
        self.masks[slot] = mask_row_of(topics, self.c.topic_words)
        return kicked

    def release_user(self, shard, key):
        self.unmirrored.pop(key, None)
        slot = self.slots.slot_of(key)
        if slot is None or int(self.owner[slot]) != shard:
            return
        self.slots.unmap(key)
        self.owner[slot] = ABSENT
        self.version[slot] += 1
        self.masks[slot] = 0
        self.quarantine.append(slot)

    def update_mask(self, shard, key, topics):
        slot = self.slots.slot_of(key)
        if slot is not None and int(self.owner[slot]) == shard:
            self.masks[slot] = mask_row_of(topics, self.c.topic_words)

    def mark_shard_stopped(self, shard):
        self.live[shard] = False
        for slot in np.nonzero(self.owner == shard)[0]:
            key = self.slots.key_of(int(slot))
            if key is not None:
                self.slots.unmap(key)
            self.owner[slot] = ABSENT
            self.version[slot] += 1
            self.masks[slot] = 0
            self.quarantine.append(int(slot))
        for key in [k for k, s in self.unmirrored.items() if s == shard]:
            del self.unmirrored[key]
        self.dirty = True

    def _overflow(self):
        self.overflows += 1

    def stage_batch(self, shard, items):
        results = [StageResult.INELIGIBLE] * len(items)
        groups = {}
        rings = [lane[shard] for lane in self.lane_rings]
        free = [r.free_slots for r in rings]
        for idx, (kind, frame, target) in enumerate(items):
            if len(frame) > rings[-1].frame_bytes:
                self._overflow()
                continue
            if kind == KIND_BROADCAST:
                if self.unmirrored:
                    self._overflow()
                    continue
                mask, oor = self.tmask.resolve(target)
                if oor:
                    self._overflow()
                    continue
                if mask == 0:
                    continue
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
                slot = self.slots.slot_of(target)
                owner = ABSENT if slot is None else int(self.owner[slot])
                if owner == ABSENT:
                    self._overflow()
                    continue
                ok = stage_best_fit(
                    [b[shard] for b in self.lane_buckets], len(frame),
                    lambda b: b.push(owner, frame, slot))
                results[idx] = StageResult.STAGED if ok else StageResult.FULL
        for li, group in groups.items():
            k = rings[li].push_batch([g[1] for g in group],
                                     [KIND_BROADCAST] * len(group),
                                     [g[2] for g in group], [-1] * len(group))
            for idx, *_ in group[k:]:
                results[idx] = StageResult.FULL
        return results

    def step(self):
        c, B = self.c, self.n
        staged = (sum(r.slots - r.free_slots
                      for rings in self.lane_rings for r in rings)
                  + sum(b.total_used for bk in self.lane_buckets for b in bk))
        if not self.dirty and staged == 0:
            return []
        self.dirty = False
        lat = c.latency_slots
        small = (all(r.slots - r.free_slots <= lat for r in self.lane_rings[0])
                 and all(b.max_used <= lat for b in self.lane_buckets[0])
                 and all(r.free_slots == r.slots
                         for rings in self.lane_rings[1:] for r in rings)
                 and all(b.total_used == 0
                         for bk in self.lane_buckets[1:] for b in bk))
        batches = [[r.take_batch() for r in rings] for rings in self.lane_rings]
        directs = [[b.take_batch() for b in bk] for bk in self.lane_buckets]
        if small:
            batches = [[slice_batch(b, lat) for b in batches[0]]]
            directs = [[slice_direct_batch(d, lat) for d in directs[0]]]
        u = effective_users(self.slots.high_water, c.num_user_slots)
        owner, ver, masks = (self.owner[:u].copy(), self.version[:u].copy(),
                             self.masks[:u].copy())
        live = self.live.copy()
        quarantined, self.quarantine = self.quarantine, []

        def rows(a):
            return jnp.asarray(np.broadcast_to(a, (B,) + a.shape))

        state = RouterState(CrdtState(rows(owner), rows(ver), rows(owner)),
                            rows(masks))
        lanes = tuple(IngressBatch(*(jnp.asarray(np.stack(
            [getattr(b, f) for b in lane])) for f in BATCH))
            for lane in batches)
        dlanes = tuple(DirectIngress(*(jnp.asarray(np.stack(
            [getattr(d, f) for d in lane])) for f in DIRECT))
            for lane in directs)
        result = self.step_fn(state, lanes, dlanes, rows(live))
        out = []
        for li, l in enumerate(result.lanes):
            lane = batches[li]
            if not any(b.valid.any() for b in lane):
                continue
            deliver = np.asarray(l.deliver)
            if c.gather_frame_bytes:
                lengths = np.asarray(l.gathered_length[0])
                blocks = np.asarray(l.gathered_bytes[0])
            else:
                lengths = np.concatenate([b.length for b in lane])
                blocks = np.concatenate([b.bytes_ for b in lane])
            for s in range(B):
                if live[s] and deliver[s].any():
                    users, frames = np.nonzero(deliver[s])
                    out.append((s, li, False, users, frames, lengths, blocks))
        for li, l in enumerate(result.direct_lanes):
            lane = directs[li]
            if not any(d.valid.any() for d in lane):
                continue
            deliver = np.asarray(l.deliver)
            for s in range(B):
                if not (live[s] and deliver[s].any()):
                    continue
                users, frames = np.nonzero(deliver[s])
                if c.gather_frame_bytes:
                    lengths = np.asarray(l.gathered_length[s])
                    blocks = np.asarray(l.gathered_bytes[s])
                else:
                    lengths = np.concatenate(
                        [lane[src].length[s] for src in range(B)])
                    blocks = np.concatenate(
                        [lane[src].bytes_[s] for src in range(B)])
                out.append((s, li, True, users, frames, lengths, blocks))
        for slot in quarantined:
            self.slots.free_slot(slot)
        return out


def _config(W, fused, gather, users=40):
    return MeshGroupConfig(
        num_user_slots=users, ring_slots=8, direct_bucket_slots=3,
        frame_bytes=64, extra_lanes=((256, 4, 2),), topic_words=W,
        latency_slots=3, gather_frame_bytes=gather, fused_collective=fused)


def _pair(n, c):
    return (MeshGroup(make_broker_mesh(n, devices=["cpu"] * n), c),
            JaxMeshGroupTwin(n, c))


def _assert_step(group, twin, seqs=None):
    got, want = group.step(), twin.step()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        s, li, direct, users, frames, lengths, blocks = w
        assert (g.shard, g.lane, g.direct) == (s, li, direct)
        np.testing.assert_array_equal(g.users, users)
        np.testing.assert_array_equal(g.frames, frames)
        np.testing.assert_array_equal(g.length, lengths)
        np.testing.assert_array_equal(g.bytes_, blocks)
        if seqs is not None:
            for u, f in zip(users.tolist(), frames.tolist()):
                key = group.slots.key_of(u)
                assert key is not None and key == twin.slots.key_of(u)
                seqs.setdefault((s, key), []).append(
                    blocks[f, :lengths[f]].tobytes())
    if group.collectives_last_step is not None and got:
        assert (group.collectives_last_step == 1) == group.step_fn.fused
    return got


def _topics(rng, pool, k=3):
    return sorted({int(t) for t in rng.choice(pool,
                                              int(rng.integers(1, k + 1)))})


def _drive(n, W, fused, gather, ticks=12, seed=0):
    c = _config(W, fused, gather)
    group, twin = _pair(n, c)
    rng = np.random.default_rng(seed)
    # a few busy topics, and for 8 words some past the first word
    pool = list(range(6)) + ([40, 100, 200, 255] if W == 8 else [31])
    users = {}       # key -> (shard, topics)
    next_key = 0
    seqs = {}
    stopped = None
    both = (group, twin)

    def claim(key, shard, topics):
        kicks = [g.claim_user(shard, key, topics) for g in both]
        assert kicks[0] == kicks[1]
        users[key] = (shard, topics)
        return kicks[0]

    def live_shards():
        return [s for s in range(n) if s != stopped]

    for _ in range(16):
        claim(b"u%d" % next_key, int(rng.integers(0, n)), _topics(rng, pool))
        next_key += 1
    kicked = 0
    for tick in range(ticks):
        if tick == ticks - 3 and n > 1:
            stopped = n - 1
            for g in both:
                g.mark_shard_stopped(stopped)
            users = {k: v for k, v in users.items() if v[0] != stopped}
        for _ in range(int(rng.integers(2, 8))):
            r = rng.random()
            keys = sorted(users)
            if r < 0.3:
                claim(b"u%d" % next_key, int(rng.choice(live_shards())),
                      _topics(rng, pool))
                next_key += 1
            elif r < 0.45 and keys:
                key = keys[int(rng.integers(len(keys)))]
                shard = users.pop(key)[0]
                for g in both:
                    g.release_user(shard, key)
            elif r < 0.6 and keys:
                key = keys[int(rng.integers(len(keys)))]
                shard = users[key][0]
                topics = _topics(rng, pool)
                users[key] = (shard, topics)
                for g in both:
                    g.update_mask(shard, key, topics)
                    g.update_mask((shard + 1) % n, key, [0])  # not its owner
            elif keys:
                # an in-group double connect: the same key at another shard
                key = keys[int(rng.integers(len(keys)))]
                old = users[key][0]
                new = int(rng.choice(live_shards()))
                k = claim(key, new, users[key][1])
                assert k == ((old, key) if new != old else None)
                kicked += k is not None
        sparse = tick % 4 == 1
        idle = tick % 4 == 3
        for shard in range(n):
            items = []
            for _ in range(0 if idle else int(rng.integers(0, 3 if sparse
                                                           else 14))):
                size = int(rng.choice([8, 40, 64, 65, 200, 256, 300]))
                payload = rng.bytes(size)
                r = rng.random()
                keys = sorted(users)
                if r < 0.6:
                    topics = _topics(rng, pool, 2)
                    if rng.random() < 0.05:
                        topics.append(32 * W + 1)   # outside the space
                    items.append((KIND_BROADCAST, payload, topics))
                elif r < 0.9 and keys:
                    key = keys[int(rng.integers(len(keys)))]
                    if rng.random() < 0.1:
                        key = b"nobody"
                    items.append((KIND_DIRECT, payload, key))
                else:
                    items.append((KIND_BROADCAST, payload, []) if r < 0.95
                                 else (6, payload, [0]))
            assert group.stage_batch(shard, items) == \
                twin.stage_batch(shard, items), f"tick {tick}"
        _assert_step(group, twin, seqs)
        assert group.overflows == twin.overflows
        # the host mirrors the state rows are built from
        np.testing.assert_array_equal(group._owner, twin.owner)
        np.testing.assert_array_equal(group._claim_version, twin.version)
        np.testing.assert_array_equal(group._masks, twin.masks)
        np.testing.assert_array_equal(group._liveness, twin.live)
    assert sum(len(v) for v in seqs.values()) > 30
    assert kicked > 0 or n == 1
    return group, seqs


@pytest.mark.parametrize("n,W,fused,gather", [
    (3, 1, True, False), (3, 8, False, False), (4, 8, True, True),
    (2, 1, False, True), (1, 8, True, False)])
def test_mesh_group_matches_jax_pieces(n, W, fused, gather):
    group, seqs = _drive(n, W, fused, gather, seed=n * 10 + W)
    assert group.steps > 0 and group.messages_routed > 0
    assert group.overflows > 0
    if n > 1:
        # the stopped shard delivered nothing after its stop
        assert not group._liveness[n - 1]


def test_double_connect_releases_the_old_claim():
    group, twin = _pair(2, _config(1, True, False, users=4))
    for g in (group, twin):
        assert g.claim_user(0, b"a", [1]) is None
    slot0 = group.slots.slot_of(b"a")
    assert group.claim_user(1, b"a", [2]) == (0, b"a")
    assert twin.claim_user(1, b"a", [2]) == (0, b"a")
    # the old slot is quarantined until the step: the user got a new one
    assert group.slots.slot_of(b"a") != slot0
    assert int(group._owner[slot0]) == ABSENT
    for g in (group, twin):
        g.stage_batch(0, [(KIND_BROADCAST, b"to topic 2", [2]),
                          (KIND_DIRECT, b"direct", b"a")])
    (bcast, direct) = _assert_step(group, twin)
    assert (bcast.shard, direct.shard) == (1, 1)
    assert bcast.users.tolist() == direct.users.tolist() == \
        [group.slots.slot_of(b"a")]


def test_shard_stop_sweeps_its_slots_and_steps_with_nothing_staged():
    group, twin = _pair(3, _config(8, False, False))
    for g in (group, twin):
        g.claim_user(0, b"a", [5])
        g.claim_user(2, b"b", [5])
        g.stage_batch(2, [(KIND_BROADCAST, b"staged before the stop", [5])])
    for g in (group, twin):
        g.mark_shard_stopped(2)
    assert group.slots.slot_of(b"b") is None
    # the dead shard's staged frame never delivers, and a direct to its
    # user now goes to the host path
    assert _assert_step(group, twin) == []
    assert group.steps == 1
    assert group.stage_batch(0, [(KIND_DIRECT, b"x", b"b")]) == \
        [StageResult.INELIGIBLE]
    assert group.overflows == 1
    # nothing staged, nothing dirty: no step
    assert group.step() == [] and group.steps == 1


def test_latency_slice_and_wide_lane():
    group, twin = _pair(2, _config(1, True, False))
    for g in (group, twin):
        g.claim_user(0, b"a", [0])
        g.claim_user(1, b"b", [0])
    # sparse: the base lane only, prefix-sliced to latency_slots frames
    for g in (group, twin):
        g.stage_batch(1, [(KIND_BROADCAST, b"small", [0])])
    got = _assert_step(group, twin)
    assert [(d.shard, d.lane, len(d.length)) for d in got] == \
        [(0, 0, 2 * 3), (1, 0, 2 * 3)]
    # a wide frame rides the 256-byte lane, at full shapes
    for g in (group, twin):
        g.stage_batch(0, [(KIND_BROADCAST, b"W" * 200, [0]),
                          (KIND_DIRECT, b"D" * 100, b"b")])
    got = _assert_step(group, twin)
    assert [(d.shard, d.lane, d.direct) for d in got] == \
        [(0, 1, False), (1, 1, False), (1, 1, True)]
    assert got[0].bytes_.shape == (2 * 4, 256)
    (direct,) = [d for d in got if d.direct]
    f = int(direct.frames[0])
    assert direct.bytes_[f, :direct.length[f]].tobytes() == b"D" * 100


def test_full_table_pins_broadcasts_to_the_host_path():
    group, twin = _pair(2, _config(1, True, False, users=2))
    for g in (group, twin):
        g.claim_user(0, b"a", [0])
        g.claim_user(1, b"b", [0])
        assert g.claim_user(1, b"c", [0]) is None   # unmirrored
    item = [(KIND_BROADCAST, b"x", [0])]
    assert group.stage_batch(0, item) == twin.stage_batch(0, item) == \
        [StageResult.INELIGIBLE]
    for g in (group, twin):
        g.release_user(1, b"c")
    assert group.stage_batch(0, item) == twin.stage_batch(0, item) == \
        [StageResult.STAGED]
    assert [d.shard for d in _assert_step(group, twin)] == [0, 1]


def test_full_rings_and_buckets_are_backpressure():
    group, twin = _pair(2, _config(1, False, False))
    for g in (group, twin):
        g.claim_user(1, b"b", [0])
    items = [(KIND_BROADCAST, b"x", [0])] * 13 + [(KIND_DIRECT, b"y", b"b")] * 6
    got = group.stage_batch(0, items)
    assert got == twin.stage_batch(0, items)
    # 8 base + 4 wide ring slots, 3 + 2 bucket slots toward shard 1
    assert got.count(StageResult.STAGED) == 12 + 5
    assert got.count(StageResult.FULL) == 2
    _assert_step(group, twin)


def test_default_schedule_on_one_device_is_per_array():
    """The default config lets the mesh step pick: shards on one device
    exchange one array at a time."""
    group = MeshGroup(make_broker_mesh(2, devices=["cpu"] * 2),
                      MeshGroupConfig(num_user_slots=8))
    assert group.step_fn.fused is False
    group.claim_user(1, b"k", [3])
    assert group.stage_batch(0, [(KIND_BROADCAST, b"hi", [3])]) == \
        [StageResult.STAGED]
    (d,) = group.step()
    assert (d.shard, d.lane, d.direct) == (1, 0, False)
    assert group.collectives_last_step > 1
