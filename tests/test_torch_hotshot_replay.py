"""HotShot views replayed open loop over two linked port brokers, held
against the plain reference.

Two brokers with device planes on the CPU (the plain torch step, every
frame through the plane), linked over loopback TCP; 48 nodes, a DA
committee of 8, a quorum of 33, 12 views, placed 24/24, 40/8 and 48/0
over the brokers (``tests/_torch_replay.py``). Every delivery equals the
reference's (``pushcdn_tpu_torch.testing.hotshot_reference``), in
per-publisher order; every view's votes reach its next leader and its
quorum; ``cdn_link_frames`` counts exactly the frames the reference says
cross the link; a link that drops one forwarded vote shows as one
delivery missing and one view one vote short. The reference's two copies
(the port's and the benchmark's ``cdnbench/views_reference.py``) agree
on seeded schedules, and the reference itself is checked by hand on a
small schedule. Last, the benchmark's traffic kind ``views_replay``: its
plan, its checks and the readers of its cell.
"""

import asyncio
import contextlib
import functools

import numpy as np
import pytest

from cdnbench import oracle
from cdnbench import views_reference as bench_ref
from pushcdn_tpu_torch.broker.tasks import handlers
from pushcdn_tpu_torch.proto.message import KIND_BROADCAST
from pushcdn_tpu_torch.testing import hotshot_reference as ref

from _torch_replay import NODES, NUM_TOPICS, QUORUM, VIEWS, replay, schedule

PLACEMENTS = {"24/24": 24, "40/8": 40, "48/0": 48}
SEED = 20261018


@functools.lru_cache(maxsize=None)
def outcome(on_first: int):
    return asyncio.run(replay(on_first, SEED))


@contextlib.contextmanager
def drop_one_forwarded_vote():
    """The link loses the first direct it is handed."""
    to_broker = handlers.EgressBatch.to_broker
    dropped = []

    def lossy(self, identifier, raw, cls=handlers.flowclass.LIVE,
              direct=False):
        if direct and not dropped:
            dropped.append(identifier)
            return
        return to_broker(self, identifier, raw, cls=cls, direct=direct)

    handlers.EgressBatch.to_broker = lossy
    try:
        yield dropped
    finally:
        handlers.EgressBatch.to_broker = to_broker


# ---------------------------------------------------------------------------
# the replay over two linked brokers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("placed", sorted(PLACEMENTS))
def test_every_delivery_equals_the_reference(placed):
    out = outcome(PLACEMENTS[placed])
    assert out.corrupt == 0
    numbers = oracle.judge(out.want(), out.got)
    assert numbers == dict(missing=0, extra=0, out_of_order=0, corrupt=0)
    # 2,148 deliveries a view at 1024 nodes; here N + committee + N
    assert out.want().size == VIEWS * (NODES + 8 + NODES)


@pytest.mark.parametrize("placed", sorted(PLACEMENTS))
def test_every_view_reaches_its_quorum_at_its_next_leader(placed):
    out = outcome(PLACEMENTS[placed])
    q = ref.quorums(out.frames, QUORUM)
    assert q["closed"].all() and (q["votes"] == NODES).all()
    assert out.votes_at_leaders() == {v: NODES for v in range(VIEWS)}


@pytest.mark.parametrize("placed", sorted(PLACEMENTS))
def test_link_frames_equal_the_reference_crossings(placed):
    """Both brokers count into the one process's ``cdn_link_frames``, so
    each direction's count holds the frames of both links."""
    out = outcome(PLACEMENTS[placed])
    cross = out.crossings()
    for d in ("in", "out"):
        assert out.link[(d, "direct")] == cross[:, :, ref.DIRECT].sum()
        assert out.link[(d, "broadcast")] == cross[:, :, ref.BROADCAST].sum()
    if PLACEMENTS[placed] == NODES:
        assert cross.sum() == 0
    else:
        # every view's proposal crosses once, and votes both ways
        assert (out.broker_of == 0).sum() == PLACEMENTS[placed]
        assert cross[:, :, ref.BROADCAST].sum() >= VIEWS
        assert cross[0, 1, ref.DIRECT] > 0 and cross[1, 0, ref.DIRECT] > 0


def test_a_link_that_drops_one_vote_is_one_missing_and_one_view_short():
    plant = drop_one_forwarded_vote()
    out = asyncio.run(replay(24, SEED + 1, plant=plant))
    numbers = oracle.judge(out.want(), out.got)
    assert numbers["missing"] == 1
    assert numbers["extra"] == numbers["out_of_order"] == 0
    votes = out.votes_at_leaders()
    assert sorted(votes.values()) == [NODES - 1] + [NODES] * (VIEWS - 1)
    # the view is one vote short, and its quorum still holds
    assert min(votes.values()) >= QUORUM
    # the vote was lost before the link took it: the counters agree
    cross = out.crossings()[:, :, ref.DIRECT].sum()
    assert out.link[("out", "direct")] == out.link[("in", "direct")] \
        == cross - 1


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2718281828, 2 ** 40 + 7])
def test_the_two_copies_of_the_reference_agree(seed):
    g = np.random.default_rng(seed)
    nodes, views = int(g.integers(8, 64)), int(g.integers(1, 20))
    f, topics = schedule(seed, nodes=nodes, committee=min(5, nodes),
                         views=views, rate=float(g.integers(1, 200)))
    v = np.arange(-3, views, dtype=np.int64)
    due = np.rint(v * 1e9 / 7.0).astype(np.int64)
    leader = g.permutation(np.arange(v.size + 1) % nodes)
    vote_due = due[:, None] + g.integers(0, 10 ** 9, (v.size, nodes))
    brokers = g.integers(0, 3, nodes)
    mine = ref.frames(v, due, leader, vote_due, (5, 6, 7), 0, 1)
    theirs = bench_ref.frames(v, due, leader, vote_due, (5, 6, 7), 0, 1)
    assert mine.keys() == theirs.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])
    np.testing.assert_array_equal(
        ref.deliveries(mine, topics, NUM_TOPICS),
        bench_ref.deliveries(theirs, topics, NUM_TOPICS))
    for k in ("view", "leader", "votes", "closed"):
        np.testing.assert_array_equal(ref.quorums(mine, nodes // 2)[k],
                                      bench_ref.quorums(theirs, nodes // 2)[k])
    np.testing.assert_array_equal(
        ref.crossings(mine, topics, NUM_TOPICS, brokers, 3),
        bench_ref.crossings(theirs, topics, NUM_TOPICS, brokers, 3))


def test_the_reference_on_a_small_schedule_by_hand():
    """Three nodes, two views, node 2 alone on broker 1 and alone on DA."""
    f = ref.frames([0, 1], [0, 100], [0, 1, 2],
                   [[50, 10, 150], [120, 110, 130]], (10, 20, 3), 0, 1)
    topics = [[0], [0], [0, 1]]
    # node 0: proposal 0, DA 0 at 0, its votes at 50 and 120
    # node 1: vote at 10, proposal 1 and DA 1 at 100, vote at 110
    # node 2: votes at 130 and 150
    assert f["pub"].tolist() == [0, 0, 0, 0, 1, 1, 1, 1, 2, 2]
    assert f["mtype"].tolist() == [2, 3, 4, 4, 4, 2, 3, 4, 4, 4]
    assert f["seq"].tolist() == [0, 1, 2, 3, 0, 1, 2, 3, 0, 1]
    assert f["view"].tolist() == [0, 0, 0, 1, 0, 1, 1, 1, 1, 0]
    assert f["target"].tolist() == [-1, -1, 1, 2, 1, -1, -1, 2, 2, 1]
    assert f["size"].tolist() == [10, 20, 3, 3, 3, 10, 20, 3, 3, 3]
    want = ref.deliveries(f, topics, 2)
    # 2 proposals x 3 nodes, 2 DA x node 2, 6 votes
    assert want.size == 6 + 2 + 6
    q = ref.quorums(f, 3)
    assert q["view"].tolist() == [0, 1] and q["leader"].tolist() == [1, 2]
    assert q["votes"].tolist() == [3, 3] and q["closed"].all()
    assert not ref.quorums(f, 4)["closed"].any()
    c = ref.crossings(f, topics, 2, [0, 0, 1], 2)
    # broadcasts: each proposal and DA to broker 1 (node 2 holds both)
    assert c[0, 1, ref.BROADCAST] == 4 and c[1, 0, ref.BROADCAST] == 0
    # votes: to node 1 from node 2 (view 0); to node 2 from 0 and 1
    assert c[1, 0, ref.DIRECT] == 1 and c[0, 1, ref.DIRECT] == 2


def test_a_nodes_frames_go_out_in_due_order_with_rising_sequence():
    f, _ = schedule(5)
    for u in range(NODES):
        mine = f["pub"] == u
        assert (np.diff(f["due"][mine]) >= 0).all()
        assert f["seq"][mine].tolist() == list(range(int(mine.sum())))


# ---------------------------------------------------------------------------
# the plane keeps a sender's order across its lanes (the fault the replay
# found: a step egresses its lanes one after another, so a sender's small
# frame staged after its wide one used to reach a receiver first)
# ---------------------------------------------------------------------------


def _lane_plane(wide_slots: int = 4):
    from pushcdn_tpu_torch.broker.device_plane import (DevicePlane,
                                                       DevicePlaneConfig)
    plane = DevicePlane(DevicePlaneConfig(
        num_user_slots=8, ring_slots=8, frame_bytes=64,
        extra_lanes=((1024, wide_slots),), bypass_max_items=0),
        device="cpu")
    plane.on_user_added(b"r", [0])
    return plane


def _delivered_order(plane):
    """The frames' first bytes in the order the step egresses them to
    the one user: lane by lane, frames ascending within a lane."""
    return [bytes(d.bytes_[f, :1]) for d in plane.step()
            for f in d.frames.tolist()]


WIDE = (KIND_BROADCAST, b"W" * 500, [0])
SMALL = (KIND_BROADCAST, b"s" * 10, [0])


def test_without_a_sender_a_later_small_frame_overtakes_a_wide_one():
    plane = _lane_plane()
    plane.stage_frames([WIDE, SMALL])
    assert _delivered_order(plane) == [b"s", b"W"]


@pytest.mark.parametrize("batches", [[[WIDE, SMALL]], [[WIDE], [SMALL]]],
                         ids=["one batch", "two batches"])
def test_a_senders_frames_keep_their_order_across_lanes(batches):
    plane = _lane_plane()
    for items in batches:
        assert set(plane.stage_frames(items, source=b"p")) == {
            ref_stage("staged")}
    assert _delivered_order(plane) == [b"W", b"s"]
    # the next step starts from the narrowest lane again, and another
    # sender never had a floor
    plane.stage_frames([SMALL], source=b"p")
    plane.stage_frames([SMALL], source=b"q")
    assert [d.lane for d in plane.step()] == [0]


def test_a_full_lane_holds_back_the_rest_of_its_senders_batch():
    plane = _lane_plane(wide_slots=1)
    got = plane.stage_frames([WIDE, WIDE, SMALL], source=b"p")
    assert got == [ref_stage("staged"), ref_stage("full"),
                   ref_stage("full")]
    # without a sender the small frame would have taken the base lane
    assert _lane_plane(wide_slots=1).stage_frames([WIDE, WIDE, SMALL])[2] \
        == ref_stage("staged")


def ref_stage(name):
    from pushcdn_tpu_torch.broker.staging import StageResult
    return StageResult(name)


async def test_a_users_wide_then_small_broadcasts_arrive_in_order():
    """Through a broker's plane (every frame through the step): each
    publish of a 12 KB frame then a 192 B frame reaches the subscriber
    in that order."""
    from pushcdn_tpu_torch.broker.device_plane import DevicePlaneConfig
    from pushcdn_tpu_torch.testing.cluster import Cluster
    cluster = await Cluster(num_brokers=1, device_plane=DevicePlaneConfig(
        num_user_slots=8, ring_slots=64, frame_bytes=2048,
        extra_lanes=((16384, 16),), bypass_max_items=0),
        device="cpu").start()
    pub, sub = cluster.client(seed=1), cluster.client(seed=2, topics=[0])
    try:
        await pub.ensure_initialized()
        await sub.ensure_initialized()
        await asyncio.sleep(0.1)
        from pushcdn_tpu_torch.proto.message import Broadcast
        for i in range(20):
            await pub.send_message(Broadcast([0], b"W%03d" % i + b"w" * 12280))
            await pub.send_message(Broadcast([0], b"s%03d" % i + b"s" * 188))
        got = []
        while len(got) < 40:
            got += [bytes(m.message[:4]) for m in
                    await asyncio.wait_for(sub.receive_messages(), 10)]
        want = [x for i in range(20) for x in (b"W%03d" % i, b"s%03d" % i)]
        assert got == want
        assert cluster.brokers[0].device_plane.messages_routed >= 40
    finally:
        pub.close()
        sub.close()
        await cluster.stop()


# ---------------------------------------------------------------------------
# the benchmark's traffic kind views_replay and its cell's files
# ---------------------------------------------------------------------------


def _cell():
    from cdnbench import common
    wl = common.workload("hotshot_1k_2b.views_replay")
    return common.config(wl["config"]), wl


@functools.lru_cache(maxsize=None)
def _frames(seed: int, seconds: float = 3.0):
    from cdnbench.traffic import views_replay
    cfg, wl = _cell()
    return views_replay.frames(cfg, wl, seed, seconds)


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11, 5 * 10 ** 11 + 3])
def test_views_replay_offers_the_same_work_for_every_seed(seed):
    from cdnbench.traffic import views_replay
    cfg, wl = _cell()
    f, base = _frames(seed), _frames(1)
    for k in ("mtype", "view", "due", "size"):
        np.testing.assert_array_equal(np.sort(f[k]), np.sort(base[k]))
    topics = views_replay.users_topics(cfg, wl, seed)
    assert sum(len(t) == 2 for t in topics) == wl["da_committee"]
    per_view = bench_ref.deliveries(f, topics, cfg["topics"]).size \
        / np.unique(f["view"]).size
    assert per_view == 2 * cfg["users"] + wl["da_committee"]   # 2,148
    q = bench_ref.quorums(f, wl["quorum"])
    assert q["closed"].all() and (q["votes"] == cfg["users"]).all()


def test_views_replay_schedule_follows_the_cell():
    from cdnbench.traffic import views_replay
    cfg, wl = _cell()
    f = _frames(99)
    rate = wl["views_per_s"]
    views = np.unique(f["view"])
    assert views.tolist() == list(range(-int(rate), int(3.0 * rate)))
    lead = f["mtype"] == bench_ref.PROPOSAL
    np.testing.assert_array_equal(
        f["due"][lead][np.argsort(f["view"][lead])],
        views_replay.view_due_ns(views, rate))
    vote = f["mtype"] == bench_ref.VOTE
    late = f["due"][vote] - views_replay.view_due_ns(f["view"][vote], rate)
    lo, hi = wl["vote_delay_ms"]
    assert late.min() >= lo * 1e6 and late.max() <= hi * 1e6
    # round-robin leaders rotate over the generators' shares of the users
    share = cfg["users"] // cfg["generators"]
    by_view = f["pub"][lead][np.argsort(f["view"][lead])]
    assert (np.diff(by_view // share) != 0).all()
    assert np.unique(by_view // share).size == cfg["generators"]
    # every vote goes to the next view's leader
    nxt = dict(zip(f["view"][lead].tolist(), f["pub"][lead].tolist()))
    for v, t in zip(f["view"][vote][:5000].tolist(),
                    f["target"][vote][:5000].tolist()):
        assert nxt.get(v + 1, t) == t
    assert set(f["size"].tolist()) == {wl["proposal_bytes"], wl["da_bytes"],
                                       wl["vote_bytes"]}


def test_views_replay_checks_count_what_went_wrong():
    from cdnbench.traffic import views_replay
    cfg, wl = _cell()
    seed = 12345
    f = _frames(seed)
    sends = {"pub": f["pub"], "seq": f["seq"]}
    views = np.unique(f["view"])
    closed = {"quorum_view": views[views >= 0]}
    ok = views_replay.checks(cfg, wl, seed, 3.0, sends, closed)
    assert ok == dict(unsent=0, unplanned=0, unclosed_views=0)
    short = {"pub": f["pub"][1:], "seq": f["seq"][1:]}
    extra = {"pub": np.r_[f["pub"], f["pub"][:1]],
             "seq": np.r_[f["seq"], f["seq"][:1]]}
    one_open = {"quorum_view": views[views >= 1]}
    assert views_replay.checks(cfg, wl, seed, 3.0, short, closed)[
        "unsent"] == 1
    assert views_replay.checks(cfg, wl, seed, 3.0, extra, closed)[
        "unplanned"] == 1
    assert views_replay.checks(cfg, wl, seed, 3.0, sends, one_open)[
        "unclosed_views"] == 1


def test_a_leader_records_each_views_quorum_once():
    from types import SimpleNamespace

    from cdnbench.traffic import views_replay
    gen = SimpleNamespace(wl={"quorum": 2})
    # a vote before the process made its plan waits for it
    views_replay.on_message(gen, 0, 4, pub=5, seq=1, ref_ns=0)
    assert len(gen.early_votes) == 1
    st = views_replay._State({(5 << 28) | 1: 7, (6 << 28) | 0: 7,
                              (6 << 28) | 2: 8}, quorum=2)
    for early in gen.early_votes:
        st.vote(*early)
    gen.state = st
    for pub, seq in ((5, 1), (6, 0), (6, 0), (6, 2), (9, 9)):
        views_replay.on_message(gen, 0, 4, pub=pub, seq=seq, ref_ns=0)
    assert st.quorum_view == [7] and len(st.quorum_ns) == 1
    assert {v: len(p) for v, p in st.votes.items()} == {7: 2, 8: 1}
