"""The port's multi-shard mesh step against the JAX package's.

The same seeded numpy state rows, lanes and direct buckets go through
``pushcdn_tpu.parallel.router.make_mesh_lane_step`` on the virtual CPU
mesh (``tests/conftest.py``) and through the port's
``make_mesh_lane_step`` with every shard on ``cpu``. Delivery matrices,
gathered frames, merged state and evictions must be bit-identical
(tolerance 0), for every shard, over n ∈ {1, 2, 4, 8}, the fused and
the per-array exchange, one and eight mask words, with and without
frame bytes, and with and without a dead shard. The named tests below
the matrix mirror ``tests/test_router.py``'s mesh tests one by one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pushcdn_tpu.parallel import router as jr
from pushcdn_tpu.parallel import frames as jframes
from pushcdn_tpu.parallel.crdt import CrdtState as JCrdtState
from pushcdn_tpu.parallel.mesh import make_broker_mesh as jax_mesh
from _torch_trees import stack_rows
from pushcdn_tpu_torch import convert
from pushcdn_tpu_torch.broker.mesh_group import MeshGroup
from pushcdn_tpu_torch.entry import dryrun_multichip
from pushcdn_tpu_torch.parallel import mesh as tmesh
from pushcdn_tpu_torch.parallel import router as tr
from pushcdn_tpu_torch.parallel.crdt import ABSENT
from pushcdn_tpu_torch.parallel.frames import (
    DirectBuckets,
    FrameRing,
    mask_of_topics,
    slice_direct_batch,
    split_mask,
)
from pushcdn_tpu_torch.proto.error import Error

U32_MAX = 0xFFFFFFFF
BATCH = ("bytes_", "kind", "length", "topic_mask", "dest", "valid")
DIRECT = ("bytes_", "length", "dest", "valid")


def _stack(parts, fields):
    return tuple(np.stack([getattr(p, f) for p in parts]) for f in fields)


def _jstate(s):
    return jr.RouterState(JCrdtState(*(jnp.asarray(x) for x in s[:3])),
                          jnp.asarray(s[3]))


def _jtree(cls, arrays):
    return cls(*(jnp.asarray(a) for a in arrays))


def _port_inputs(n, state_np, lanes_np, directs_np=(), live_np=None):
    """The mesh of ``n`` CPU shards and the per-shard inputs built from
    the same stacked numpy leaves the JAX step takes."""
    mesh = tmesh.make_broker_mesh(n, devices=["cpu"] * n)
    tree = (convert.router_state_from_numpy(*state_np, device="cpu"),
            tuple(convert.ingress_batch_from_numpy(*b, device="cpu")
                  for b in lanes_np),
            tuple(convert.direct_ingress_from_numpy(*d, device="cpu")
                  for d in directs_np),
            None if live_np is None
            else convert.liveness_from_numpy(live_np, device="cpu"))
    states, batches, directs, lives = zip(*tmesh.shard_rows(mesh, tree))
    return mesh, states, batches, directs, \
        (None if live_np is None else lives)


def _eq(j, t):
    if j is None:
        assert t is None
        return
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def _assert_state(j_state, t_state):
    want = (j_state.crdt.owners, j_state.crdt.versions,
            j_state.crdt.identities, j_state.topic_masks)
    for a, b in zip(want, convert.router_state_to_numpy(t_state)):
        np.testing.assert_array_equal(np.asarray(a), b)


def _assert_lane_results(j, t_list):
    """The JAX step's stacked output against the port's per-shard list."""
    t = stack_rows(t_list)
    assert len(j.lanes) == len(t.lanes)
    assert len(j.direct_lanes) == len(t.direct_lanes)
    for jl, tl in zip(j.lanes + j.direct_lanes, t.lanes + t.direct_lanes):
        _eq(jl.deliver, tl.deliver)
        _eq(jl.gathered_length, tl.gathered_length)
        _eq(jl.gathered_bytes, tl.gathered_bytes)
    _eq(j.evictions, t.evictions)
    _assert_state(j.state, t.state)
    return t


def _assert_route_results(j, t_list):
    t = stack_rows(t_list)
    for f in ("gathered_bytes", "gathered_length", "deliver", "evictions",
              "direct_bytes", "direct_length", "direct_deliver"):
        _eq(getattr(j, f), getattr(t, f))
    _assert_state(j.state, t.state)
    return t


# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------

U, S1, F1, S2, F2, C = 24, 8, 32, 3, 128, 3


def _random_mask(rng, W):
    return int.from_bytes(rng.bytes(4 * W), "little") \
        & int.from_bytes(rng.bytes(4 * W), "little")


def _scenario(n, W, seed, dead):
    """Stacked numpy inputs for ``n`` shards. Every shard row holds its
    own view of the claims: owners in [-1, n + 2) (an index past the
    mesh included), small versions with ties and 0xFFFFFFFF, random
    identities, so the fold hands slots off and evicts; masks ride the
    claims. Two broadcast lanes of broadcasts and directs (garbage dests
    too), and direct buckets of different fill per source and
    destination. With ``dead`` the last shard is dead in every row."""
    rng = np.random.default_rng(seed)
    owners = rng.integers(-1, n + 2, (n, U)).astype(np.int32)
    versions = rng.integers(0, 4, (n, U)).astype(np.uint32)
    versions[:, :2] = U32_MAX
    owners[:, 1] = n + 1   # past the mesh: reads the last shard's flag
    ids = rng.integers(-1, n, (n, U)).astype(np.int32)
    mshape = (n, U) if W == 1 else (n, U, W)
    masks = (rng.integers(0, 2**32, mshape, dtype=np.uint64)
             & rng.integers(0, 2**32, mshape, dtype=np.uint64)
             ).astype(np.uint32)
    # shard 0 surely owns slot 2, subscribed to everything
    owners[:, 2], versions[:, 2], ids[:, 2], masks[:, 2] = 0, 5, 0, U32_MAX
    lanes = []
    for slots, fbytes, count in ((S1, F1, S1 - 2), (S2, F2, S2)):
        rings = []
        for _ in range(n):
            ring = FrameRing(slots=slots, frame_bytes=fbytes, topic_words=W)
            for _ in range(int(rng.integers(2, count + 1))):
                payload = rng.bytes(int(rng.integers(1, fbytes + 1)))
                if rng.random() < 0.7:
                    ring.push_broadcast(payload, _random_mask(rng, W) or 1)
                else:
                    ring.push_direct(payload, int(rng.integers(-2, U + 3)))
            rings.append(ring.take_batch())
        lanes.append(_stack(rings, BATCH))
    buckets = []
    for i in range(n):
        b = DirectBuckets(n, capacity=C, frame_bytes=F1)
        for _ in range(int(rng.integers(0, C * n + 1))):
            b.push(int(rng.integers(0, n)), rng.bytes(int(rng.integers(1, F1))),
                   int(rng.integers(-1, U)))
        buckets.append(b.take_batch())
    live = None
    if dead:
        live = np.ones((n, n), bool)
        live[:, n - 1] = False
    return ((owners, versions, ids, masks), lanes,
            [_stack(buckets, DIRECT)], live)


@pytest.mark.parametrize("dead", [False, True], ids=["all-live", "dead"])
@pytest.mark.parametrize("gather_bytes", [True, False],
                         ids=["bytes", "no-bytes"])
@pytest.mark.parametrize("W", [1, 8], ids=["W1", "W8"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per-array"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_lane_step_matches_jax(n, fused, W, gather_bytes, dead):
    state_np, lanes_np, directs_np, live_np = _scenario(
        n, W, seed=n * 100 + W * 10 + dead, dead=dead)
    j = jr.make_mesh_lane_step(jax_mesh(n), gather_bytes=gather_bytes,
                               fused=fused)(
        _jstate(state_np),
        tuple(_jtree(jr.IngressBatch, b) for b in lanes_np),
        tuple(_jtree(jr.DirectIngress, d) for d in directs_np),
        None if live_np is None else jnp.asarray(live_np))
    mesh, states, batches, directs, lives = _port_inputs(
        n, state_np, lanes_np, directs_np, live_np)
    step = tr.make_mesh_lane_step(mesh, gather_bytes=gather_bytes,
                                  fused=fused)
    before = tr.trace_collectives()
    out = step(states, batches, directs, lives)
    count = tr.trace_collectives() - before
    t = _assert_lane_results(j, out)
    # fused: one collective; per-array: 4 state + 5 or 6 per broadcast
    # lane + 3 or 4 per direct lane
    extra = 1 if gather_bytes else 0
    assert count == (1 if fused else 4 + 2 * (5 + extra) + (3 + extra))
    assert all((lane.gathered_bytes is None) != gather_bytes
               for lane in t.lanes + t.direct_lanes)
    assert int(t.lanes[0].deliver.sum()) > 0 or (dead and n == 1)
    if n >= 2:
        assert t.evictions.any()          # the fold handed slots off
    if dead:
        # the dead shard's frames deliver nowhere, its slots tombstoned
        S = S1
        assert not t.lanes[0].deliver[:, :, (n - 1) * S:n * S].any()
        assert not (t.state.crdt.owners == n - 1).any()
        # slot 1's owner past the mesh reads the last (dead) shard's
        # flag: tombstoned, its 0xFFFFFFFF version bumped to 0
        assert (t.state.crdt.owners[:, 1] == ABSENT).all()
        assert (t.state.crdt.versions[:, 1] == 0).all()


def test_asymmetric_directs_land_at_their_owner():
    """Direct buckets with a different fill per (source, destination):
    each shard receives, in source order, exactly what each source
    addressed to it. A wrong slice axis after the fused gather would
    still pass a one-shard mesh, so this runs on three."""
    n = 3
    owners = np.full((n, 8), ABSENT, np.int32)
    for i in range(n):
        owners[:, i] = i
    state_np = (owners, np.where(owners >= 0, 1, 0).astype(np.uint32),
                owners.copy(), np.zeros((n, 8), np.uint32))
    empty = [FrameRing(slots=2, frame_bytes=16).take_batch()
             for _ in range(n)]
    pushes = {(0, 1): [b"a", b"b"], (0, 2): [b"c"], (2, 1): [b"d"],
              (1, 0): [b"e", b"f", b"g"]}
    buckets = [DirectBuckets(n, capacity=3, frame_bytes=16)
               for _ in range(n)]
    for (src, dst), payloads in pushes.items():
        for p in payloads:
            assert buckets[src].push(dst, p, dest_slot=dst)
    directs_np = [_stack([b.take_batch() for b in buckets], DIRECT)]
    for fused in (True, False):
        mesh, states, batches, directs, _ = _port_inputs(
            n, state_np, [_stack(empty, BATCH)], directs_np)
        out = tr.make_mesh_lane_step(mesh, fused=fused)(
            states, batches, directs)
        for dst in range(n):
            d = out[dst].direct_lanes[0]
            users, frames = torch.nonzero(d.deliver, as_tuple=True)
            got = [d.gathered_bytes[f, :d.gathered_length[f]].numpy()
                   .tobytes() for f in frames.tolist()]
            want = [p for src in range(n) for p in pushes.get((src, dst), [])]
            assert got == want and set(users.tolist()) <= {dst}
        j = jr.make_mesh_lane_step(jax_mesh(n), fused=fused)(
            _jstate(state_np), (_jtree(jr.IngressBatch, _stack(empty, BATCH)),),
            (_jtree(jr.DirectIngress, directs_np[0]),), None)
        _assert_lane_results(j, out)


# ---------------------------------------------------------------------------
# tests/test_router.py's mesh tests, on both packages
# ---------------------------------------------------------------------------

Ur, Sr, Fr = 16, 8, 64


def _one_owned_user_each(n, mask=0b1):
    owners = np.full((n, Ur), ABSENT, np.int32)
    versions = np.zeros((n, Ur), np.uint32)
    ids = np.full((n, Ur), ABSENT, np.int32)
    masks = np.zeros((n, Ur), np.uint32)
    for i in range(n):
        owners[i, i], versions[i, i], ids[i, i], masks[i, i] = i, 1, i, mask
    return owners, versions, ids, masks


def _rings(n, fill, slots=Sr, frame_bytes=Fr):
    parts = []
    for i in range(n):
        ring = FrameRing(slots=slots, frame_bytes=frame_bytes)
        fill(i, ring)
        parts.append(ring.take_batch())
    return _stack(parts, BATCH)


def _routing_step_both(n, state_np, batch_np, direct_np=None):
    with_direct = direct_np is not None
    jstep = jr.make_mesh_routing_step(jax_mesh(n), with_direct=with_direct)
    jargs = [_jstate(state_np), _jtree(jr.IngressBatch, batch_np)]
    if with_direct:
        jargs.append(_jtree(jr.DirectIngress, direct_np))
    mesh, states, batches, directs, _ = _port_inputs(
        n, state_np, [batch_np], [direct_np] if with_direct else ())
    tstep = tr.make_mesh_routing_step(mesh)
    targs = [states, [b[0] for b in batches]]
    if with_direct:
        targs.append([d[0] for d in directs])
    return _assert_route_results(jstep(*jargs), tstep(*targs))


def test_mesh_routing_8_shards():
    n = 8

    def fill(i, ring):
        ring.push_broadcast(f"from-{i}".encode(), topic_mask=0b1)
        if i == 2:
            ring.push_direct(b"direct to user 5", dest_slot=5)

    t = _routing_step_both(n, _one_owned_user_each(n), _rings(n, fill))
    d = t.deliver
    for b in range(n):
        assert int(d[b, b].sum()) == n + (1 if b == 5 else 0)
        others = [u for u in range(Ur) if u != b]
        assert not d[b][others].any()


def test_mesh_eviction_on_ownership_change():
    n = 8
    owners, versions, ids, masks = _one_owned_user_each(n)
    owners[:], versions[:], ids[:] = ABSENT, 0, ABSENT
    owners[0, 0], versions[0, 0], ids[0, 0] = 0, 1, 0
    owners[1, 0], versions[1, 0], ids[1, 0] = 1, 2, 1
    t = _routing_step_both(n, (owners, versions, ids, masks),
                           _rings(n, lambda i, r: None))
    assert t.evictions[0, 0] and not t.evictions[1:].any()
    assert (t.state.crdt.owners[:, 0] == 1).all()


def test_mask_rides_ownership_handoff():
    n = 8
    owners = np.full((n, Ur), ABSENT, np.int32)
    versions = np.zeros((n, Ur), np.uint32)
    ids = np.full((n, Ur), ABSENT, np.int32)
    masks = np.zeros((n, Ur), np.uint32)
    owners[:, 0], versions[:, 0], ids[:, 0], masks[:, 0] = 0, 1, 0, 0b01
    owners[1, 0], versions[1, 0], ids[1, 0], masks[1, 0] = 1, 2, 1, 0b10

    def fill(i, ring):
        if i == 3:
            ring.push_broadcast(b"new-topic msg", topic_mask=0b10)

    t = _routing_step_both(n, (owners, versions, ids, masks),
                           _rings(n, fill))
    assert (t.state.topic_masks[:, 0] == 0b10).all()
    assert int(t.deliver[1, 0].sum()) == 1 and int(t.deliver[0, 0].sum()) == 0


def test_mesh_direct_all_to_all():
    n, cap = 8, 4
    owners, versions, ids, masks = _one_owned_user_each(n, mask=0)
    buckets = [DirectBuckets(n, capacity=cap, frame_bytes=Fr)
               for _ in range(n)]
    assert buckets[2].push(5, b"to user 5", dest_slot=5)
    assert buckets[2].push(7, b"to user 7", dest_slot=7)
    assert buckets[6].push(0, b"to user 0", dest_slot=0)
    direct_np = _stack([b.take_batch() for b in buckets], DIRECT)
    t = _routing_step_both(n, (owners, versions, ids, masks),
                           _rings(n, lambda i, r: None), direct_np)
    assert not t.deliver.any()
    dd, db, dl = t.direct_deliver, t.direct_bytes, t.direct_length
    assert int(dd.sum()) == 3
    for shard, user, payload in [(5, 5, b"to user 5"), (7, 7, b"to user 7"),
                                 (0, 0, b"to user 0")]:
        (f,) = torch.nonzero(dd[shard, user]).flatten().tolist()
        assert db[shard, f, :dl[shard, f]].numpy().tobytes() == payload
        assert int(dd[:, user].sum()) == 1
    # a full bucket is per-link backpressure
    small = DirectBuckets(n, capacity=1, frame_bytes=Fr)
    assert small.push(3, b"x", 3)
    assert not small.push(3, b"y", 3)
    assert small.push(4, b"z", 4)


def _lane_step_both(n, state_np, lanes_np, directs_np=(), live_np=None,
                    fused=False, gather_bytes=True):
    j = jr.make_mesh_lane_step(jax_mesh(n), fused=fused,
                               gather_bytes=gather_bytes)(
        _jstate(state_np), tuple(_jtree(jr.IngressBatch, b) for b in lanes_np),
        tuple(_jtree(jr.DirectIngress, d) for d in directs_np),
        None if live_np is None else jnp.asarray(live_np))
    mesh, states, batches, directs, lives = _port_inputs(
        n, state_np, lanes_np, directs_np, live_np)
    out = tr.make_mesh_lane_step(mesh, fused=fused,
                                 gather_bytes=gather_bytes)(
        states, batches, directs, lives)
    return _assert_lane_results(j, out)


def _one_hop_directs(n, capacity=2, frame_bytes=256):
    parts = []
    for i in range(n):
        d = DirectBuckets(n, capacity=capacity, frame_bytes=frame_bytes)
        d.push((i + 1) % n, b"d%d" % i, dest_slot=(i + 1) % n)
        parts.append(d.take_batch())
    return _stack(parts, DIRECT)


def test_lane_step_mesh():
    n = 8
    small = _rings(n, lambda i, r: r.push_broadcast(b"s%d" % i, 0b1),
                   slots=4, frame_bytes=64)
    big = _rings(n, lambda i, r: r.push_broadcast(b"L" * 400, 0b1),
                 slots=2, frame_bytes=512)
    t = _lane_step_both(n, _one_owned_user_each(n), [small, big],
                        [_one_hop_directs(n)])
    assert int(t.lanes[0].deliver.sum()) == n * n
    assert int(t.lanes[1].deliver.sum()) == n * n
    assert int(t.direct_lanes[0].deliver.sum()) == n
    assert (t.state.crdt.owners[0] == t.state.crdt.owners).all()


def test_liveness_mask_dead_shard():
    n, dead = 8, 3
    live = np.ones((n, n), bool)
    live[:, dead] = False
    batch = _rings(n, lambda i, r: r.push_broadcast(b"from %d" % i, 0b1),
                   slots=4)
    t = _lane_step_both(n, _one_owned_user_each(n), [batch], live_np=live)
    deliver = t.lanes[0].deliver
    owners = t.state.crdt.owners
    assert (owners[0] == owners).all() and (owners[:, dead] == ABSENT).all()
    assert not deliver[:, :, dead * 4:(dead + 1) * 4].any()
    assert int(deliver.sum()) == (n - 1) * (n - 1)
    assert (t.state.topic_masks[:, dead] == 0).all()


def test_multiword_topic_masks_on_the_mesh():
    """8 mask words: a subscriber of topic 200 on shard 1 gets the
    topic-200 broadcast from shard 0 and not the topic-7 one."""
    n, W = 2, 8
    owners = np.full((n, Ur), ABSENT, np.int32)
    versions = np.zeros((n, Ur), np.uint32)
    masks = np.zeros((n, Ur, W), np.uint32)
    owners[:, 0], versions[:, 0] = 1, 1
    masks[:, 0] = split_mask(mask_of_topics([200], W), W)

    def fill(i, ring):
        if i == 0:
            ring.push_broadcast(b"topic 200", mask_of_topics([200], W))
            ring.push_broadcast(b"topic 7", mask_of_topics([7], W))

    parts = []
    for i in range(n):
        ring = FrameRing(slots=8, frame_bytes=64, topic_words=W)
        fill(i, ring)
        parts.append(ring.take_batch())
    t = _lane_step_both(n, (owners, versions, owners.copy(), masks),
                        [_stack(parts, BATCH)])
    d = t.lanes[0].deliver
    assert d[1, 0, 0] and not d[1, 0, 1] and not d[0].any()


def _seeded_mesh_inputs(n, seed):
    """test_router.py's ``_seeded_mesh_inputs``: one owned user per
    shard with a random mask, 1-3 broadcasts per shard, two directs."""
    rng = np.random.default_rng(seed)
    owners, versions, ids, masks = _one_owned_user_each(n)
    for i in range(n):
        masks[i, i] = rng.integers(1, 8)

    def fill(i, ring):
        for k in range(int(rng.integers(1, 4))):
            ring.push_broadcast(b"b%d-%d" % (i, k), int(rng.integers(1, 8)))

    batch = _rings(n, fill)
    parts = []
    for i in range(n):
        d = DirectBuckets(n, capacity=4, frame_bytes=Fr)
        d.push((i + 1) % n, b"d%d" % i, dest_slot=(i + 1) % n)
        d.push((i + 3) % n, b"e%d" % i, dest_slot=(i + 3) % n)
        parts.append(d.take_batch())
    return (owners, versions, ids, masks), batch, _stack(parts, DIRECT)


def test_fused_tick_matches_per_array_and_counts_one_collective():
    n = 8
    state_np, batch_np, direct_np = _seeded_mesh_inputs(n, seed=3)
    live = np.ones((n, n), bool)
    counts = {}
    outs = {}
    for fused in (True, False):
        mesh, states, batches, directs, lives = _port_inputs(
            n, state_np, [batch_np], [direct_np], live)
        before = tr.trace_collectives()
        outs[fused] = stack_rows(tr.make_mesh_lane_step(
            mesh, fused=fused)(states, batches, directs, lives))
        counts[fused] = tr.trace_collectives() - before
        _lane_step_both(n, state_np, [batch_np], [direct_np], live,
                        fused=fused)
    f, u = outs[True], outs[False]
    for a, b in ((f.lanes[0].deliver, u.lanes[0].deliver),
                 (f.lanes[0].gathered_bytes, u.lanes[0].gathered_bytes),
                 (f.direct_lanes[0].deliver, u.direct_lanes[0].deliver),
                 (f.direct_lanes[0].gathered_bytes,
                  u.direct_lanes[0].gathered_bytes),
                 (f.state.crdt.owners, u.state.crdt.owners),
                 (f.evictions, u.evictions)):
        assert torch.equal(a, b)
    assert counts[True] == 1 and counts[False] > 1
    state2, batch2, direct2 = _seeded_mesh_inputs(n, seed=4)
    mesh, states, batches, directs, lives = _port_inputs(
        n, state2, [batch2], [direct2], live)
    before = tr.trace_collectives()
    tr.make_mesh_lane_step(mesh, fused=True, gather_bytes=False)(
        states, batches, directs, lives)
    assert tr.trace_collectives() - before == 1


def test_fused_tick_liveness_and_eviction_equivalence():
    n = 8
    (owners, versions, ids, masks), batch_np, direct_np = \
        _seeded_mesh_inputs(n, seed=9)
    owners[1, 0], versions[1, 0], ids[1, 0] = 1, 5, 1
    live = np.ones((n, n), bool)
    live[:, 2] = live[:, 5] = False
    state_np = (owners, versions, ids, masks)
    f = _lane_step_both(n, state_np, [batch_np], [direct_np], live,
                        fused=True)
    u = _lane_step_both(n, state_np, [batch_np], [direct_np], live,
                        fused=False)
    for a, b in ((f.lanes[0].deliver, u.lanes[0].deliver),
                 (f.direct_lanes[0].deliver, u.direct_lanes[0].deliver),
                 (f.state.crdt.versions, u.state.crdt.versions),
                 (f.evictions, u.evictions)):
        assert torch.equal(a, b)
    assert (f.state.crdt.owners[:, 2] == ABSENT).all()
    assert (f.state.crdt.owners[:, 5] == ABSENT).all()
    assert f.evictions[0, 0]


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def test_word_packer_round_trips_every_leaf_dtype():
    rng = np.random.default_rng(5)
    leaves = [
        torch.from_numpy(rng.integers(-2**31, 2**31, (3, 5)).astype(np.int32)),
        torch.tensor([0, 1, 2**31 - 1, 2**31, U32_MAX, U32_MAX - 1],
                     dtype=torch.int64),
        torch.from_numpy(rng.integers(0, 256, (7, 3)).astype(np.uint8)),
        torch.from_numpy(rng.integers(0, 256, (2, 4)).astype(np.uint8)),
        torch.zeros((4, 0), dtype=torch.uint8),
        torch.from_numpy(rng.random((5,)) < 0.5),
        torch.from_numpy(rng.integers(0, 2**32, (3, 8), dtype=np.uint64)
                         .astype(np.uint32).view(np.int32)),
    ]
    pk = tr._WordPacker()
    for x in leaves:
        pk.add(x)
    words = pk.pack()
    assert words.dtype == torch.int32
    B = 3
    gathered = torch.stack([words] * B)
    for x, y in zip(leaves, pk.unpack(gathered)):
        assert y.dtype == x.dtype and y.shape == (B,) + tuple(x.shape)
        for b in range(B):
            assert torch.equal(y[b], x)
    versions = pk.unpack(gathered)[1][0]
    assert int(versions[4]) == U32_MAX
    # the next bump wraps to 0, as u32 arithmetic does
    from pushcdn_tpu_torch.parallel.crdt import bump
    assert int(bump(versions)[4]) == 0
    with pytest.raises(TypeError):
        tr._WordPacker().add(torch.zeros(2, dtype=torch.float32))


def test_direct_buckets_match_jax():
    rng = np.random.default_rng(11)
    n, cap, F = 3, 4, 16
    port = DirectBuckets(n, capacity=cap, frame_bytes=F)
    ref = jframes.DirectBuckets(n, capacity=cap, frame_bytes=F)
    for _ in range(14):
        args = (int(rng.integers(0, n)), rng.bytes(int(rng.integers(0, F + 1))),
                int(rng.integers(-1, 9)))
        assert port.push(*args) == ref.push(*args)
        assert (port.total_used, port.max_used) == \
            (ref.total_used, ref.max_used)
    with pytest.raises(Error):
        port.push(0, b"x" * (F + 1), 0)
    got, want = port.take_batch(), ref.take_batch()
    for f in DIRECT:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(
            getattr(slice_direct_batch(got, 2), f),
            getattr(jframes.slice_direct_batch(want, 2), f))
    assert port.total_used == 0
    assert port.take_batch() is port.take_batch()   # cached idle batch


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_multichip_counts_on_the_cpu(n):
    counts = dryrun_multichip(n, devices=["cpu"] * n)
    assert counts == dict(base=n * n + n, wide=n * n, direct=n,
                          collectives=1)


def test_broker_mesh_devices(monkeypatch):
    mesh = tmesh.make_broker_mesh(3, devices=["cpu"] * 4)
    assert mesh.size == 3 and mesh.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(Error, match="asked for 5 broker shards"):
        tmesh.make_broker_mesh(5, devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (tmesh.make_broker_mesh, MeshGroup,
                 lambda: tmesh.make_broker_mesh(devices=["cuda:0"] * 2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(RuntimeError, match="devices="):
        dryrun_multichip(2)


def test_shard_rows_and_stack_rows_round_trip():
    mesh = tmesh.make_broker_mesh(devices=["cpu"] * 3)
    state = convert.router_state_from_numpy(
        np.arange(12, dtype=np.int32).reshape(3, 4),
        np.full((3, 4), U32_MAX, np.uint32),
        np.zeros((3, 4), np.int32), np.ones((3, 4, 2), np.uint32),
        device="cpu")
    rows = tmesh.shard_rows(mesh, (state, None))
    assert len(rows) == 3 and rows[1][1] is None
    assert rows[2][0].crdt.owners.tolist() == [8, 9, 10, 11]
    back = stack_rows([r[0] for r in rows])
    for a, b in zip(convert.router_state_to_numpy(back),
                    convert.router_state_to_numpy(state)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("devices,fused", [(("cpu",) * 4, False),
                                           (("cpu", "meta"), True)])
def test_mesh_lane_step_picks_its_schedule_from_the_devices(devices, fused):
    """Per array when every shard shares one device, fused when the
    shards span devices; an explicit ``fused`` wins."""
    mesh = tmesh.BrokerMesh(tuple(torch.device(d) for d in devices))
    assert tr.MeshLaneStep(mesh).fused is fused
    assert tr.MeshLaneStep(mesh, fused=not fused).fused is (not fused)
