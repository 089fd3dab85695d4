"""The port's route-plan library held against the JAX package's, byte for
byte, in one process.

Both libraries get the same seeded tables (users and broker peers with
4-word u64 topic masks, a valid-topic mask, DirectMap keys owned by users
and by brokers, a topic -> flow-class map) and the same chunks (broadcasts
with valid, invalid and duplicate topics, directs to known and unknown
keys, traced frames, control frames, garbage). Then ``plan`` must give the
same pair arrays, per-frame classes, stop index and stop reason at every
resume point, ``gather`` the same bytes (and the wire's framing), random
``apply`` delta batches the same ``stats`` and plans, and a plan that
stops on its pair capacity must resume to the same fan-out.
"""

import numpy as np
import pytest

from _torch_libs import jax_routeplan_available
from pushcdn_tpu.native import routeplan as jax_rp
from pushcdn_tpu_torch.native import routeplan as port_rp
from pushcdn_tpu_torch.proto import trace as trace_lib
from pushcdn_tpu_torch.proto.message import (
    Broadcast,
    Direct,
    Subscribe,
    Unsubscribe,
    UserSync,
    serialize,
)

pytestmark = pytest.mark.skipif(
    not (jax_routeplan_available() and port_rp.available()),
    reason="native route-plan library unavailable (no working g++)")

N_USERS, N_BROKERS = 40, 4
VALID_TOPICS = 200          # topics 200.. are outside the run's space


def _table(rng):
    """A seeded snapshot: masks, valid mask, DirectMap keys and owners,
    and a flow-class map."""
    n_peers = N_USERS + N_BROKERS
    masks = np.zeros((n_peers, port_rp.MASK_WORDS), np.uint64)
    for i in range(n_peers):
        k = int(rng.integers(0, 6))
        masks[i] = port_rp.topic_mask(rng.integers(0, 256, k).tolist())
    valid = port_rp.topic_mask(range(VALID_TOPICS))
    keys = [b"user-%d" % u for u in range(N_USERS)
            if rng.random() < 0.8]
    owners = [int(k[5:]) for k in keys]
    remote = [b"remote-%d" % i for i in range(12)]
    keys += remote
    owners += [N_USERS + int(rng.integers(0, N_BROKERS)) for _ in remote]
    classes = rng.integers(0, 4, 256).astype(np.uint8)
    return masks, valid, keys, np.asarray(owners, np.int32), classes


def _planners(rng):
    masks, valid, keys, owners, classes = _table(rng)
    out = {}
    for name, rp in (("jax", jax_rp), ("port", port_rp)):
        planner = rp.RoutePlanner.create()
        assert planner.build(N_USERS, N_BROKERS, valid, masks, keys, owners)
        assert planner.set_classes(classes)
        out[name] = planner
    return out


def _frames(rng, n: int, hot_topics=None):
    """A seeded chunk's frames. ``hot_topics`` narrows broadcasts to those
    topics and drops the control frames (a fan-out-heavy chunk)."""
    frames = []
    for _ in range(n):
        roll = int(rng.integers(0, 100))
        body = bytes(rng.integers(0, 256, int(rng.integers(0, 80)),
                                  dtype=np.uint8))
        if hot_topics is not None:
            frames.append(serialize(Broadcast(list(hot_topics), body)))
        elif roll < 50:
            topics = rng.integers(0, 256, int(rng.integers(1, 4))).tolist()
            frames.append(serialize(Broadcast(topics, body)))
        elif roll < 75:
            u = int(rng.integers(0, N_USERS + 16))
            rcpt = (b"user-%d" % u if u < N_USERS
                    else b"remote-%d" % (u - N_USERS))
            frames.append(serialize(Direct(rcpt, body)))
        elif roll < 80:
            frame = serialize(Broadcast([int(rng.integers(0, 256))], body))
            frames.append(trace_lib.stamp_frame(frame, trace_lib.new_trace()))
        elif roll < 86:
            frames.append(serialize(Subscribe([int(rng.integers(0, 256))])))
        elif roll < 90:
            frames.append(serialize(Unsubscribe([1, 2])))
        elif roll < 94:
            frames.append(serialize(UserSync(body)))
        elif roll < 97:
            frames.append(b"\xfe" + body)      # unknown kind
        else:
            frames.append(bytes([5]) + body[:3])  # truncated broadcast
    return frames


def _chunk(frames):
    buf = bytearray()
    offs, lens = [], []
    for f in frames:
        offs.append(len(buf) + 4)
        lens.append(len(f))
        buf += len(f).to_bytes(4, "big") + f
    return bytes(buf), np.asarray(offs, np.int64), np.asarray(lens, np.int64)


def _plan_all(planner, chunk, mode: int) -> list:
    """Every plan call over the chunk, resuming as the broker does (past a
    residual frame, from the returned index after a capacity stop): per
    call (start, consumed, stop, peers, frames, classes)."""
    buf, offs, lens = chunk
    calls = []
    pos = 0
    while pos < len(offs):
        consumed, stop, peers, frames = planner.plan(buf, offs, lens, pos,
                                                     mode)
        calls.append((pos, consumed, stop, peers.tobytes(), frames.tobytes(),
                      planner.frame_classes[pos:pos + consumed].tobytes()))
        pos += consumed
        if stop == port_rp.STOP_END:
            break
        if stop == port_rp.STOP_RESIDUAL:
            pos += 1
    return calls


def _wire(chunk, idx) -> bytes:
    """The plain framing of frames ``idx``: a 4-byte big-endian length
    before each."""
    buf, offs, lens = chunk
    return b"".join(int(lens[i]).to_bytes(4, "big")
                    + buf[int(offs[i]):int(offs[i]) + int(lens[i])]
                    for i in idx)


@pytest.mark.parametrize("mode", [0, 1], ids=["user", "broker"])
@pytest.mark.parametrize("seed", range(8))
def test_plan_and_gather_match_jax(seed, mode):
    rng = np.random.default_rng(100 + seed)
    planners = _planners(rng)
    chunk = _chunk(_frames(rng, 160))
    calls = {name: _plan_all(p, chunk, mode) for name, p in planners.items()}
    assert calls["port"] == calls["jax"]
    stops = {c[2] for c in calls["port"]}
    assert port_rp.STOP_RESIDUAL in stops
    pairs = 0
    for _pos, _n, _stop, peers, frames, _cls in calls["port"]:
        peers = np.frombuffer(peers, np.int32)
        frames = np.frombuffer(frames, np.int32)
        pairs += len(peers)
        for peer in np.unique(peers):
            idx = frames[peers == peer]
            got = {name: p.gather(*chunk, idx) for name, p in planners.items()}
            assert got["port"] == got["jax"] == _wire(chunk, idx)
    assert pairs > 0


@pytest.mark.parametrize("seed", range(8))
def test_apply_deltas_match_jax(seed):
    rng = np.random.default_rng(200 + seed)
    planners = _planners(rng)
    chunk = _chunk(_frames(rng, 120))
    for _ in range(12):
        n = int(rng.integers(0, 10))
        peers = rng.integers(0, N_USERS + N_BROKERS, n).astype(np.int32)
        masks = np.stack([port_rp.topic_mask(
            rng.integers(0, 256, int(rng.integers(0, 5))).tolist())
            for _ in range(n)]) if n else np.zeros((0, 4), np.uint64)
        keys = [b"user-%d" % int(u) if rng.random() < 0.5
                else b"new-%d" % int(u)
                for u in rng.integers(0, N_USERS, int(rng.integers(0, 8)))]
        owners = [-1 if rng.random() < 0.3
                  else int(rng.integers(0, N_USERS + N_BROKERS))
                  for _ in keys]
        for p in planners.values():
            assert p.apply(peers, masks, keys, owners)
        assert planners["port"].stats() == planners["jax"].stats()
        for mode in (0, 1):
            assert _plan_all(planners["port"], chunk, mode) == \
                _plan_all(planners["jax"], chunk, mode)
    # out-of-range slots refuse the batch on both
    bad = np.asarray([N_USERS + N_BROKERS + 5], np.int32)
    zero = np.zeros((1, 4), np.uint64)
    assert [p.apply(bad, zero, [], []) for p in planners.values()] == \
        [False, False]


@pytest.mark.parametrize("mode", [0, 1], ids=["user", "broker"])
@pytest.mark.parametrize("seed", range(4))
def test_capacity_stop_resumes_as_jax(seed, mode):
    """A chunk whose fan-out outgrows the pair scratch (4096 pairs) stops
    on capacity and resumes from the returned index; the joined pairs
    equal one plan per frame."""
    rng = np.random.default_rng(300 + seed)
    masks, valid, keys, owners, classes = _table(rng)
    masks[:] = port_rp.topic_mask([7])     # every peer hears topic 7
    planners = {}
    for name, rp in (("jax", jax_rp), ("port", port_rp)):
        planners[name] = p = rp.RoutePlanner.create()
        assert p.build(N_USERS, N_BROKERS, valid, masks, keys, owners)
    chunk = _chunk(_frames(rng, 240, hot_topics=[7]))
    calls = {name: _plan_all(p, chunk, mode) for name, p in planners.items()}
    assert calls["port"] == calls["jax"]
    assert port_rp.STOP_CAPACITY in {c[2] for c in calls["port"]}
    joined = np.concatenate([np.frombuffer(c[4], np.int32)
                             for c in calls["port"]])
    per_frame = []
    buf, offs, lens = chunk
    for i in range(len(offs)):
        _n, _stop, _peers, frames = planners["port"].plan(
            buf, offs[:i + 1], lens[:i + 1], i, mode)
        per_frame.append(frames.copy())
    assert np.array_equal(joined, np.concatenate(per_frame))
    fanout = N_USERS if mode == 1 else N_USERS + N_BROKERS
    assert len(joined) == 240 * fanout
