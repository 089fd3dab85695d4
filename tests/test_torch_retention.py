"""The port's durable topics (retention rings, replay subscribe, the
last-value cache and wildcard interest) held against the JAX package's.

Every case of ``tests/test_retention.py`` runs on both packages with the
same seeds, and each run returns a record of what it saw: wire frames,
namespace bindings, ring snapshots and counters, pool balances, and the
replay-then-live streams each receiver got, on the cut-through plane and
on its scalar twin, with one shard and with two worker shards. The
port's record must equal JAX's, byte for byte where it holds frames.
Then the cases the reference has no twin of: a seeded run of publishes
on several retained topics, with rings that evict, and ``SubscribeFrom``
at every kind of sequence (from the start, from the middle, the
last-value sentinel, live only, and a pattern), quiescent between steps
so that every stream is exact; the knobs read from the environment; and
a broker with a device plane (the port's on the CPU) that retains and
replays what JAX's plane broker does.
"""

import asyncio
import gc
import importlib
import itertools
import os
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import pytest
from _torch_libs import jax_routeplan_available

from pushcdn_tpu_torch.native import routeplan as port_routeplan

ROOTS = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}
IMPLS = ("python", "native")
NATIVE_OK = jax_routeplan_available() and port_routeplan.available()
_UID = itertools.count()


def _pkg(name: str) -> SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{ROOTS[name]}.{path}")

    return SimpleNamespace(
        name=name, retention=mod("broker.retention"),
        connections=mod("broker.connections"),
        cutthrough=mod("broker.tasks.cutthrough"),
        harness=mod("broker.test_harness"), broker=mod("broker.broker"),
        plane=mod("broker.device_plane"), def_=mod("proto.def_"),
        limiter=mod("proto.limiter"), error=mod("proto.error"),
        msg=mod("proto.message"), topic=mod("proto.topic"),
        metrics=mod("proto.metrics"), sig=mod("proto.crypto.signature"),
        routeplan=mod("native.routeplan"),
        shardharness=mod("testing.shardharness"))


PACKAGES = {name: _pkg(name) for name in ROOTS}
PORT = PACKAGES["port"]


def _need(impl: str) -> None:
    if impl == "native" and not NATIVE_OK:
        pytest.skip("native route-plan library unavailable (no working g++)")


def _both(record):
    out = {name: record(p) for name, p in PACKAGES.items()}
    assert out["port"] == out["jax"], out
    return out["port"]


async def _both_async(record, *args, timeout: float = 50):
    out = {}
    for name, p in PACKAGES.items():
        async with asyncio.timeout(timeout):
            out[name] = await record(p, *args)
    assert out["port"] == out["jax"], out
    return out["port"]


def _set_impl(monkeypatch, impl: str) -> None:
    for p in PACKAGES.values():
        monkeypatch.setattr(p.cutthrough, "ROUTE_IMPL", impl)


# ---------------------------------------------------------------------------
# tier 1: wire round-trips
# ---------------------------------------------------------------------------

def test_subscribe_from_round_trip():
    def record(p):
        m = p.msg
        out = []
        for msg in (m.SubscribeFrom(topic=7, seq=0),
                    m.SubscribeFrom(topic=0, seq=m.SEQ_LAST),
                    m.SubscribeFrom(topic=3, seq=m.SEQ_LIVE, pattern="a.b.*"),
                    m.SubscribeFrom(topic=255, seq=2**63, pattern="x")):
            raw = m.serialize(msg)
            for decode in (m.deserialize, m.deserialize_owned):
                got = decode(raw)
                assert isinstance(got, m.SubscribeFrom)
                out.append((raw, got.topic, got.seq, got.pattern))
        return out
    out = _both(record)
    assert [r[1:] for r in out[::2]] == [
        (7, 0, ""), (0, PORT.msg.SEQ_LAST, ""),
        (3, PORT.msg.SEQ_LIVE, "a.b.*"), (255, 2**63, "x")]


def test_retained_round_trip():
    def record(p):
        m = p.msg
        out = []
        for payload in (b"", b"x", b"y" * 70_000):
            raw = m.serialize(m.Retained(topic=9, seq=41, payload=payload))
            got = m.deserialize(raw)
            owned = m.deserialize_owned(raw)
            assert not isinstance(owned.payload, memoryview)
            out.append((raw, got.topic, got.seq, bytes(got.payload),
                        bytes(owned.payload)))
        return out
    for _raw, topic, seq, payload, owned in _both(record):
        assert (topic, seq) == (9, 41) and payload == owned


def test_malformed_durable_frames_raise():
    for p in PACKAGES.values():
        for bad in (bytes([11]), bytes([11, 3, 0, 0]),  # truncated seq
                    bytes([12, 3, 1, 2, 3])):            # truncated seq
            with pytest.raises(p.error.Error):
                p.msg.deserialize(bad)


# ---------------------------------------------------------------------------
# tier 2: hierarchical namespace
# ---------------------------------------------------------------------------

def _raises(fn, *args) -> bool:
    try:
        fn(*args)
    except ValueError:
        return True
    return False


def test_namespace_bind_and_conflicts():
    def record(p):
        ns = p.topic.TopicNamespace(p.topic.TopicSpace.range(4))
        out = [ns.bind("a.b", 2), ns.bind("a.b"), ns.bind("a.c"),
               ns.bind("a.d"),
               _raises(ns.bind, "a.b", 3),      # conflicting re-bind
               _raises(ns.bind, "other", 2),    # topic already bound
               _raises(ns.bind, "oob", 9),      # outside the space
               _raises(ns.bind, ".leading"),
               ns.bind("last"),
               _raises(ns.bind, "overflow")]    # space exhausted
        ns.unbind("a.b")
        return out + [ns.topic_of("a.b"), ns.bind("fresh")]
    assert _both(record) == [2, 2, 0, 1, True, True, True, True, 3, True,
                             None, 2]


def test_namespace_wildcard_match_semantics():
    def record(p):
        ns = p.topic.TopicNamespace(p.topic.TopicSpace.range(16))
        t = {n: ns.bind(n) for n in (
            "c.view.1", "c.view.2", "c.view.2.retry", "c.vote.1", "c",
            "d.x")}
        return [t] + [ns.match(pat) for pat in (
            "c.*.1", "c.view.*", "c.*", "c", "*", "nope.*")]
    t, one, view, c_star, c, star, nope = _both(record)
    # mid `*` matches exactly one segment
    assert one == tuple(sorted((t["c.view.1"], t["c.vote.1"])))
    # final `*` matches one-or-more trailing segments
    assert view == tuple(sorted(
        (t["c.view.1"], t["c.view.2"], t["c.view.2.retry"])))
    assert c_star == tuple(sorted((t["c.view.1"], t["c.view.2"],
                                   t["c.view.2.retry"], t["c.vote.1"])))
    assert c == (t["c"],) and star == tuple(sorted(t.values()))
    assert nope == ()


def test_namespace_watch_lifecycle():
    def record(p):
        ns = p.topic.TopicNamespace(p.topic.TopicSpace.range(8))
        added, removed = [], []
        h = ns.watch("a.*", on_add=lambda n, t: added.append((n, t)),
                     on_remove=lambda n, t: removed.append((n, t)))
        ta = ns.bind("a.one")
        ns.bind("b.one")                    # no match, no event
        ns.unbind("a.one")
        ns.unwatch(h)
        ns.bind("a.two")                    # no events after unwatch
        return [ta, added, removed]
    ta, added, removed = _both(record)
    assert added == [("a.one", ta)] and removed == [("a.one", ta)]


# ---------------------------------------------------------------------------
# tier 3: rings, LVC, leases
# ---------------------------------------------------------------------------

class _FakeBroker:
    """Just enough broker surface for a standalone DurableTopics."""

    def __init__(self, p, pool_bytes=None):
        self.connections = p.connections.Connections("pub:me/priv:me")
        self.run_def = p.def_.testing_run_def(
            topics=p.topic.TopicSpace.range(8))
        self.limiter = p.limiter.Limiter(global_pool_bytes=pool_bytes)
        self.shard_runtime = None
        self.durable = None


def _durable(p, **kw):
    broker = _FakeBroker(p, pool_bytes=kw.pop("pool_bytes", None))
    d = p.retention.DurableTopics(broker, **kw)
    broker.durable = d
    return d


def _payloads(entries) -> list:
    return [(e.seq, bytes(e.payload)) for e in entries]


def test_ring_count_eviction_and_snapshot():
    def record(p):
        d = _durable(p, topics=[0], max_count=4)
        for i in range(10):
            d._retain([0], b"p%d" % i, None)
        return [_payloads(d.snapshot(0, 0)), _payloads(d.snapshot(0, 9)),
                d.snapshot(0, p.msg.SEQ_LIVE), d.evicted_entries,
                d.stats()["next_seq"][0]]
    assert _both(record) == [
        [(7, b"p6"), (8, b"p7"), (9, b"p8"), (10, b"p9")],
        [(9, b"p8"), (10, b"p9")], [], 6, 11]


def test_ring_bytes_eviction():
    def record(p):
        d = _durable(p, topics=[0], max_count=1000, max_bytes=100)
        for _ in range(10):
            d._retain([0], bytes(40), None)
        # at most 100 bytes retained => 2 entries of 40
        return [len(d.snapshot(0, 0)), d._rings[0].nbytes,
                d.evictions_by_reason]
    assert _both(record) == [2, 80, {"bytes": 8}]


def test_ring_age_eviction():
    ds = {name: _durable(p, topics=[0], max_age_s=0.03)
          for name, p in PACKAGES.items()}
    for d in ds.values():
        d._retain([0], b"old", None)
    time.sleep(0.05)
    out = {}
    for name, d in ds.items():
        d._retain([0], b"new", None)
        out[name] = [_payloads(d.snapshot(0, 0))]
    time.sleep(0.05)
    for name, d in ds.items():
        # the LVC entry survives aging out of the ring
        out[name] += [d.snapshot(0, 0),
                      _payloads(d.snapshot(0, PACKAGES[name].msg.SEQ_LAST)),
                      d.evictions_by_reason]
    assert out["port"] == out["jax"] == [
        [(2, b"new")], [], [(2, b"new")], {"age": 2}]


def test_lvc_survives_eviction_and_tracks_latest():
    def record(p):
        d = _durable(p, topics=[0, 1], max_count=2)
        for i in range(6):
            d._retain([0], b"v%d" % i, None)
        # untouched topic: no LVC
        return [_payloads(d.snapshot(0, p.msg.SEQ_LAST)),
                d.snapshot(1, p.msg.SEQ_LAST)]
    assert _both(record) == [[(6, b"v5")], []]


async def _leases_never_deadlock(p) -> list:
    d = _durable(p, topics=[0], pool_bytes=1024, max_count=1000,
                 max_bytes=1 << 20)
    pool = d.broker.limiter.pool
    # seed the ring with leased entries: ~200 pooled bytes held by
    # retention (under the 256-byte pooled clamp)
    for i in range(4):
        b = p.limiter.Bytes(bytes([i]) * 50, await pool.allocate(50))
        d._retain([0], b.data, b)
        b.release()                     # retention's clone keeps the lease
    held, avail = d.stats()["pooled_bytes"], pool.available
    # exhaust: without the reclaimer this allocation blocks forever on
    # retention's idle leases
    permit = await asyncio.wait_for(pool.allocate(1000), timeout=2)
    permit.release()
    return [held, avail, d.pool_reclaims >= 1,
            d.materialized_entries >= 1, d.stats()["pooled_bytes"] < held,
            _payloads(d.snapshot(0, 0))]


async def test_retained_leases_never_deadlock_pool_reclaim():
    """Retention holds pooled leases, a new allocation exhausts the pool,
    and the allocation completes (the reclaimer materializes retention's
    leases synchronously), every payload intact."""
    assert await _both_async(_leases_never_deadlock) == [
        200, 1024 - 200, True, True, True,
        [(i + 1, bytes([i]) * 50) for i in range(4)]]


async def _pooled_clamp(p) -> list:
    d = _durable(p, topics=[0], pool_bytes=400, max_count=1000,
                 max_bytes=1 << 20)
    pool = d.broker.limiter.pool
    for i in range(8):                  # 8 x 50 = 400 leased bytes offered
        b = p.limiter.Bytes(bytes([i]) * 50, await pool.allocate(50))
        d._retain([0], b.data, b)
        b.release()
    return [d.stats()["pooled_bytes"], d.materialized_entries,
            pool.available, _payloads(d.snapshot(0, 0))]


async def test_pooled_clamp_bounds_idle_leases():
    """Retention may pin at most a quarter of the pool: more leased bytes
    than that materialize oldest-first inline, nothing lost."""
    pooled, materialized, available, entries = \
        await _both_async(_pooled_clamp)
    assert pooled <= 100 and materialized >= 6 and available >= 300
    assert entries == [(i + 1, bytes([i]) * 50) for i in range(8)]


def test_close_releases_everything():
    def record(p):
        d = _durable(p, topics=[0, 1], max_count=100)
        for i in range(5):
            d._retain([0, 1], b"x%d" % i, None)
        d.close()
        return [d.stats()["pooled_bytes"], d.stats()["ring_entries"]]
    assert _both(record) == [0, {0: 0, 1: 0}]


# ---------------------------------------------------------------------------
# tier 4: replay -> live handover
# ---------------------------------------------------------------------------

async def _pool_balanced(broker) -> bool:
    pool = broker.limiter.pool
    if pool is None:
        return True
    for _ in range(20):
        gc.collect()
        if pool.available == pool.capacity:
            return True
        await asyncio.sleep(0.02)
    return False


async def _drain_stream(p, entity, quiet=0.4) -> list:
    """Everything the entity receives, in order, as (kind, seq, payload)
    with the raw frame."""
    m = p.msg
    out = []
    while True:
        try:
            raw = await asyncio.wait_for(entity.remote.recv_raw(), quiet)
        except (asyncio.TimeoutError, Exception):
            return out
        frame = bytes(raw.data)
        msg = m.deserialize(frame)
        if isinstance(msg, m.Retained):
            out.append(("retained", msg.seq, bytes(msg.payload), frame))
        elif isinstance(msg, m.Broadcast):
            out.append(("live", None, bytes(msg.message), frame))
        else:
            out.append((type(msg).__name__, None, None, frame))
        if hasattr(raw, "release"):
            raw.release()


def _assert_handover(stream, published, what):
    """The gap/dup-free contract: a run of Retained frames then a run of
    live Broadcasts, whose payloads are the whole publish history exactly
    once, in order."""
    kinds = [k for k, _, _, _ in stream]
    split = kinds.index("live") if "live" in kinds else len(stream)
    assert all(k == "retained" for k in kinds[:split]), (what, kinds)
    assert all(k == "live" for k in kinds[split:]), (what, kinds)
    assert [s for _, s, _, _ in stream[:split]] == \
        list(range(1, split + 1)), what
    assert [x for _, _, x, _ in stream] == published, what


async def _handover_one_shard(p, seed: int) -> dict:
    m = p.msg
    rng = np.random.default_rng(1400 + seed)
    k1, k2 = int(rng.integers(3, 9)), int(rng.integers(3, 9))
    published = [b"m%03d" % i for i in range(k1 + k2)]
    run = await p.harness.TestDefinition(connected_users=((1,), ())).run()
    try:
        sender, rx = run.user(0), run.user(1)
        for x in published[:k1]:
            await run.send_message_as(sender, m.Broadcast([0], x))
        await asyncio.sleep(0.1)        # phase 1 fully retained
        # phase 2: rejoin AND keep publishing, interleaved
        await rx.remote.send_message(m.SubscribeFrom(topic=0, seq=1),
                                     flush=True)
        for x in published[k1:]:
            await run.send_message_as(sender, m.Broadcast([0], x))
        stream = await _drain_stream(p, rx)
        _assert_handover(stream, published, f"{p.name} 1-shard s{seed}")
        stats = run.broker.durable.stats()
        return dict(enabled=run.broker.durable.enabled,
                    replayed=run.broker.durable.replayed_frames >= k1,
                    payloads=[x for _, _, x, _ in stream],
                    ring=stats["ring_entries"], next_seq=stats["next_seq"])
    finally:
        await run.shutdown()
        assert await _pool_balanced(run.broker)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", [0, 1])
async def test_replay_live_handover_one_shard(impl, seed, monkeypatch):
    _need(impl)
    _set_impl(monkeypatch, impl)
    monkeypatch.setenv("PUSHCDN_RETAIN_TOPICS", "0")
    out = await _both_async(_handover_one_shard, seed)
    assert out["enabled"] and out["replayed"]


async def _handover_two_shards(p, topic: int) -> dict:
    m = p.msg
    published = [b"s%03d" % i for i in range(10)]
    run = await p.shardharness.run_sharded([(0, ()), (1, (topic,))],
                                           num_shards=2)
    try:
        rx, sender = run.user(0), run.user(1)
        for x in published[:5]:
            await sender.remote.send_message(m.Broadcast([topic], x),
                                             flush=True)
        await run.settle()
        await rx.remote.send_message(m.SubscribeFrom(topic=topic, seq=1),
                                     flush=True)
        for x in published[5:]:
            await sender.remote.send_message(m.Broadcast([topic], x),
                                             flush=True)
        await run.settle()
        stream = await _drain_stream(p, rx)
        _assert_handover(stream, published, f"{p.name} 2-shard t{topic}")
        owner = run.brokers[topic % 2]
        return dict(enabled=[b.durable.enabled for b in run.brokers],
                    replayed=owner.durable.replayed_frames >= 5,
                    ring=owner.durable.stats()["ring_entries"][topic],
                    payloads=[x for _, _, x, _ in stream])
    finally:
        await run.shutdown()
        for b in run.brokers:
            assert await _pool_balanced(b)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("topic", [0, 1])
async def test_replay_live_handover_two_shards(impl, topic, monkeypatch):
    """``topic`` picks the owner shard (topic % 2): topic 1 is owned by
    the sender's shard, so the cross-shard replay handoff and the owner
    drainer's live path both run."""
    _need(impl)
    _set_impl(monkeypatch, impl)
    monkeypatch.setenv("PUSHCDN_RETAIN_TOPICS", "0,1")
    out = await _both_async(_handover_two_shards, topic)
    assert out["enabled"] == [True, True] and out["replayed"]
    assert out["ring"] == 10


async def _sentinels(p) -> list:
    m = p.msg
    run = await p.harness.TestDefinition(
        connected_users=((1,), (), ())).run()
    try:
        sender, lvc_rx, live_rx = run.user(0), run.user(1), run.user(2)
        for i in range(4):
            await run.send_message_as(sender, m.Broadcast([0], b"b%d" % i))
        await asyncio.sleep(0.1)
        await lvc_rx.remote.send_message(
            m.SubscribeFrom(topic=0, seq=m.SEQ_LAST), flush=True)
        await live_rx.remote.send_message(
            m.SubscribeFrom(topic=0, seq=m.SEQ_LIVE), flush=True)
        await asyncio.sleep(0.1)
        await run.send_message_as(sender, m.Broadcast([0], b"tail"))
        return [await _drain_stream(p, lvc_rx),
                await _drain_stream(p, live_rx)]
    finally:
        await run.shutdown()


@pytest.mark.parametrize("impl", IMPLS)
async def test_seq_last_and_live_sentinels_through_broker(impl, monkeypatch):
    _need(impl)
    _set_impl(monkeypatch, impl)
    monkeypatch.setenv("PUSHCDN_RETAIN_TOPICS", "0")
    lvc, live = await _both_async(_sentinels)
    # LVC: exactly the newest retained entry, then the live tail
    assert [x[:3] for x in lvc] == [("retained", 4, b"b3"),
                                    ("live", None, b"tail")]
    # SEQ_LIVE: no replay at all
    assert [x[:3] for x in live] == [("live", None, b"tail")]


async def _unknown_topic(p) -> bool:
    run = await p.harness.TestDefinition(connected_users=((0,),)).run()
    try:
        u = run.user(0)
        await u.remote.send_message(p.msg.SubscribeFrom(topic=77, seq=0),
                                    flush=True)
        await asyncio.sleep(0.1)
        return run.broker.connections.has_user(u.public_key)
    finally:
        await run.shutdown()


async def test_subscribe_from_unknown_topic_disconnects(monkeypatch):
    monkeypatch.setenv("PUSHCDN_RETAIN_TOPICS", "0")
    assert await _both_async(_unknown_topic) is False


async def _pool_pressure(p) -> dict:
    m = p.msg
    run = await p.harness.TestDefinition(connected_users=((1,), (0,)),
                                         pool_bytes=64 * 1024).run()
    try:
        sender, rx = run.user(0), run.user(1)
        payload = bytes(2048)
        # drain concurrently: the pressure comes from retention's idle
        # leases plus in-flight frames, not from a wedged receiver
        drain = asyncio.create_task(_drain_stream(p, rx, quiet=1.0))
        for _ in range(64):             # 128 KiB through a 64 KiB pool
            await run.send_message_as(sender, m.Broadcast([0], payload))
        got = await asyncio.wait_for(drain, timeout=30)
        return dict(live=len([g for g in got if g[0] == "live"]),
                    ring=run.broker.durable.stats()["ring_entries"][0])
    finally:
        await run.shutdown()
        assert await _pool_balanced(run.broker)


async def test_pool_pressure_through_broker(monkeypatch):
    """A small pool, retention on, and four times the pool published:
    every frame still delivers and the pool balances after shutdown."""
    monkeypatch.setenv("PUSHCDN_RETAIN_TOPICS", "0")
    monkeypatch.setenv("PUSHCDN_RETAIN_BYTES", str(1 << 20))
    for impl in ("python", "native") if NATIVE_OK else ("python",):
        _set_impl(monkeypatch, impl)
        assert await _both_async(_pool_pressure) == dict(live=64, ring=64)


# ---------------------------------------------------------------------------
# tier 5: wildcard interest == explicit interest
# ---------------------------------------------------------------------------

def _plan_fanout(p, broker, frames):
    """{identity: (frame indices...)} for one native plan over
    ``frames``."""
    state = p.cutthrough.RouteState(broker,
                                    p.routeplan.RoutePlanner.create())
    assert state._refresh()
    buf = bytearray()
    offs, lens = [], []
    for f in frames:
        offs.append(len(buf) + 4)
        lens.append(len(f))
        buf += len(f).to_bytes(4, "big") + f
    offs = np.asarray(offs, np.int64)
    lens = np.asarray(lens, np.int64)
    out: dict = {}
    pos, n = 0, len(lens)
    while pos < n:
        consumed, stop, peers, fidx = state.planner.plan(
            bytes(buf), offs, lens, pos, 0)
        for peer, f in zip(peers.tolist(), fidx.tolist()):
            key = (state.slot_user[peer] if peer < state.user_cap
                   else state.slot_broker[peer - state.user_cap])
            out.setdefault(key, []).append(f)
        pos += consumed
        if stop == p.routeplan.STOP_RESIDUAL:
            pos += 1
    return {k: tuple(v) for k, v in out.items()}


async def _wildcard_plan(p) -> list:
    m = p.msg
    run = await p.harness.TestDefinition(
        connected_users=((), ()), topics=p.topic.TopicSpace.range(8)).run()
    try:
        broker = run.broker
        ns = broker.durable.namespace
        for name, t in (("c.view.1", 1), ("c.view.2", 2), ("other.x", 3)):
            ns.bind(name, t)
        wild, expl = run.user(0), run.user(1)
        await wild.remote.send_message(
            m.SubscribeFrom(topic=0, seq=m.SEQ_LIVE, pattern="c.view.*"),
            flush=True)
        await expl.remote.send_message(m.Subscribe([1, 2]), flush=True)
        await asyncio.sleep(0.1)
        conns = broker.connections
        probe = [m.serialize(m.Broadcast([t], b"probe%d" % t))
                 for t in range(8)]
        out = [sorted(conns.user_topics.get_values_of_key(wild.public_key)),
               sorted(conns.user_topics.get_values_of_key(expl.public_key))]

        def check():
            fan = _plan_fanout(p, broker, probe)
            out.append([fan.get(wild.public_key), fan.get(expl.public_key)])
        check()
        # a NEW binding covered by the pattern reaches the wildcard user
        # through the watch; mirror it explicitly on the twin
        ns.bind("c.view.9", 4)
        conns.subscribe_user_to(expl.public_key, [4])
        await asyncio.sleep(0.05)
        check()
        ns.unbind("c.view.1")
        conns.unsubscribe_user_from(expl.public_key, [1])
        check()
        # and the delivered traffic agrees with the plan
        await run.send_message_as(run.user(1), m.Broadcast([4], b"hit"))
        out.append(await _drain_stream(p, wild))
        return out
    finally:
        await run.shutdown()


async def test_wildcard_plan_bit_identical_to_explicit(monkeypatch):
    """A wildcard subscriber and an explicit-set subscriber get the same
    native plan fan-out, before and after bind/unbind churn, on both
    packages."""
    _need("native")
    monkeypatch.setenv("PUSHCDN_RETAIN_TOPICS", "1,2")
    out = await _both_async(_wildcard_plan)
    assert out[0] == out[1] == [1, 2]
    for wild, expl in out[2:5]:
        assert wild == expl and wild is not None
    assert [x[:3] for x in out[5]] == [("live", None, b"hit")]


async def _wildcard_replay(p) -> list:
    m = p.msg
    run = await p.harness.TestDefinition(
        connected_users=((1, 2), ()),
        topics=p.topic.TopicSpace.range(8)).run()
    try:
        ns = run.broker.durable.namespace
        ns.bind("v.1", 1)
        ns.bind("v.2", 2)
        sender, rx = run.user(0), run.user(1)
        await run.send_message_as(sender, m.Broadcast([1], b"one"))
        await run.send_message_as(sender, m.Broadcast([2], b"two"))
        await asyncio.sleep(0.1)
        await rx.remote.send_message(
            m.SubscribeFrom(topic=0, seq=1, pattern="v.*"), flush=True)
        return await _drain_stream(p, rx)
    finally:
        await run.shutdown()


async def test_wildcard_pattern_with_replay(monkeypatch):
    """A pattern with a real from-seq replays every durable topic it
    covers, byte for byte the same on both packages."""
    monkeypatch.setenv("PUSHCDN_RETAIN_TOPICS", "1,2")
    got = await _both_async(_wildcard_replay)
    assert {(s, x) for k, s, x, _ in got if k == "retained"} == \
        {(1, b"one"), (1, b"two")}


# ---------------------------------------------------------------------------
# beyond the reference's cases: a seeded, quiescent run on both packages
# ---------------------------------------------------------------------------

RETAINED = (0, 1, 2)
MIX_TOPICS = 8


def _mix(seed: int) -> list:
    """Steps of (publisher, topics, payload) and (receiver, kind, topic,
    seq): three bursts of seeded broadcasts, the later two each preceded
    by a round of replay subscribes."""
    rng = np.random.default_rng(9100 + seed)
    steps = []
    for burst in range(3):
        if burst:
            for rx in range(3):
                kind = ("from", "last", "live", "pattern")[
                    int(rng.integers(0, 4))]
                topic = int(rng.choice(RETAINED))
                seq = int(rng.integers(0, 12)) if kind == "from" else 0
                steps.append(("sub", 2 + 3 * (burst - 1) + rx, kind, topic,
                              seq))
        for i in range(int(rng.integers(10, 20))):
            n = int(rng.integers(1, 3))
            topics = sorted({int(t) for t in rng.integers(0, MIX_TOPICS, n)})
            size = int(rng.integers(1, 300))
            steps.append(("pub", i % 2, topics,
                          bytes([burst, i]) + bytes(rng.integers(
                              0, 256, size, dtype=np.uint8))))
    return steps


def _apply_mix(p, steps, send_user, settle):
    """Drive ``steps`` through ``send_user(i, msg)``, settling after each
    subscribe round and burst."""
    m = p.msg

    async def run():
        last = None
        for step in steps:
            if step[0] != last and last is not None:
                await settle()
            last = step[0]
            if step[0] == "pub":
                _, u, topics, payload = step
                await send_user(u, m.Broadcast(topics, payload))
            else:
                _, u, kind, topic, seq = step
                msg = {"from": lambda: m.SubscribeFrom(topic=topic, seq=seq),
                       "last": lambda: m.SubscribeFrom(topic=topic,
                                                       seq=m.SEQ_LAST),
                       "live": lambda: m.SubscribeFrom(topic=topic,
                                                       seq=m.SEQ_LIVE),
                       "pattern": lambda: m.SubscribeFrom(
                           topic=0, seq=1, pattern="keep.*")}[kind]()
                await send_user(u, msg)
        await settle()
    return run()


def _stats(durable) -> dict:
    s = durable.stats()
    s.pop("replay_lag")
    return s


async def _mix_run(p, seed: int, num_shards: int) -> dict:
    """The seeded mix on one broker or on ``num_shards`` worker shards:
    two publishers (users 0, 1) and six late receivers (users 2-7)."""
    users = [(0, ()), (0, ())] + [(0, ())] * 6
    if num_shards == 1:
        run = await p.harness.TestDefinition(
            connected_users=[t for _, t in users],
            topics=p.topic.TopicSpace.range(MIX_TOPICS)).run()
        brokers = [run.broker]

        async def settle():
            await asyncio.sleep(0.1)
    else:
        run = await p.shardharness.run_sharded(
            [(i % num_shards, t) for i, (_, t) in enumerate(users)],
            num_shards=num_shards,
            topics=p.topic.TopicSpace.range(MIX_TOPICS))
        brokers = run.brokers

        async def settle():
            await run.settle(40)
            await asyncio.sleep(0.05)
    for b in brokers:
        b.durable.namespace.bind("keep.0", 0)
        b.durable.namespace.bind("keep.2", 2)

    async def send_user(i, msg):
        await run.user(i).remote.send_message(msg, flush=True)
    try:
        await _apply_mix(p, _mix(seed), send_user, settle)
        streams = [[x[3] for x in await _drain_stream(p, run.user(i),
                                                      quiet=0.2)]
                   for i in range(8)]
        return dict(streams=streams,
                    stats=[_stats(b.durable) for b in brokers])
    finally:
        await run.shutdown()


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", [0, 1])
async def test_seeded_replay_streams_match_jax(seed, impl, num_shards,
                                               monkeypatch):
    """Rings of 4 entries evict under the seeded bursts; every receiver's
    stream (replayed ``Retained`` frames, then live broadcasts) and every
    ring's stats are the same on both packages, byte for byte, and each
    replay is the tail of its ring with contiguous sequence numbers."""
    _need(impl)
    _set_impl(monkeypatch, impl)
    monkeypatch.setenv("PUSHCDN_RETAIN_TOPICS", "0-2")
    monkeypatch.setenv("PUSHCDN_RETAIN_COUNT", "4")
    out = await _both_async(_mix_run, seed, num_shards)
    m = PORT.msg
    assert sum(s["evicted_entries"] for s in out["stats"]) > 0
    for stream in out["streams"][2:]:
        seqs = {}
        for frame in stream:
            x = m.deserialize(frame)
            if isinstance(x, m.Retained):
                seqs.setdefault(x.topic, []).append(x.seq)
        for topic, got in seqs.items():
            assert got == list(range(got[0], got[0] + len(got))), got


def test_retention_reads_the_same_knobs(monkeypatch):
    """``PUSHCDN_RETAIN_*`` and ``PUSHCDN_TOPIC_NAMES`` configure the same
    store on both packages."""
    monkeypatch.setenv("PUSHCDN_RETAIN_TOPICS", "0,3,5-7")
    monkeypatch.setenv("PUSHCDN_RETAIN_COUNT", "16")
    monkeypatch.setenv("PUSHCDN_RETAIN_BYTES", "4096")
    monkeypatch.setenv("PUSHCDN_RETAIN_AGE_S", "2.5")
    monkeypatch.setenv("PUSHCDN_TOPIC_NAMES", "a.b=3,c=5")

    def record(p):
        d = p.retention.DurableTopics.from_env(_FakeBroker(p))
        return [sorted(d.topics), d.max_count, d.max_bytes, d.max_age_s,
                d.enabled, d.namespace.bindings(), d.stats()]
    topics, count, nbytes, age, enabled, bindings, _ = _both(record)
    assert topics == [0, 3, 5, 6, 7] and enabled
    assert (count, nbytes, age) == (16, 4096, 2.5)
    assert bindings == {"a.b": 3, "c": 5}


def _ring_metrics(p) -> dict:
    """``cdn_retention_ring_entries`` per topic as the scrape renders it."""
    for hook in list(p.metrics.PRE_RENDER_HOOKS):
        hook()
    fam = p.metrics.RETENTION_RING_ENTRIES
    return {t: fam.labels(topic=str(t)).value for t in range(3)}


async def _metrics_run(p) -> dict:
    m = p.msg
    run = await p.harness.TestDefinition(
        connected_users=((0,), ()),
        topics=p.topic.TopicSpace.range(8)).run()
    try:
        for i in range(11):
            await run.send_message_as(run.user(0),
                                      m.Broadcast([i % 3], b"g%d" % i))
        await asyncio.sleep(0.1)
        return dict(metric=_ring_metrics(p),
                    rings=run.broker.durable.stats()["ring_entries"])
    finally:
        await run.shutdown()


async def test_ring_gauges_equal_the_rings(monkeypatch):
    """The ``/metrics`` pre-render hook publishes each ring's entries."""
    monkeypatch.setenv("PUSHCDN_RETAIN_TOPICS", "0-2")
    out = await _both_async(_metrics_run)
    assert out["rings"] == {0: 4, 1: 4, 2: 3}
    assert out["metric"] == {0: 4.0, 1: 4.0, 2: 3.0}


# ---------------------------------------------------------------------------
# a broker with a device plane (the port's on the CPU)
# ---------------------------------------------------------------------------

async def _plane_run(p) -> dict:
    """A broker with a dense device plane retains topics 0-1: a burst is
    staged and routed by the plane, then late users replay and take a
    second burst live."""
    m = p.msg
    uid = next(_UID)
    db = os.path.join(tempfile.mkdtemp(prefix="pushcdn-torch-ret-"),
                      "discovery.sqlite")
    extra = {"device": "cpu"} if p.name == "port" else {}
    plane = p.plane.DevicePlaneConfig(
        num_user_slots=32, ring_slots=64, frame_bytes=512, topic_words=1,
        batch_window_s=0.002, bypass_max_items=0, delivery_impl="dense")
    broker = await p.broker.Broker.new(p.broker.BrokerConfig(
        run_def=p.def_.testing_run_def(topics=p.topic.TopicSpace.range(8)),
        keypair=p.sig.DEFAULT_SCHEME.generate_keypair(seed=uid),
        discovery_endpoint=db,
        public_advertise_endpoint=f"ret-pub-{p.name}-{uid}",
        public_bind_endpoint=f"ret-pub-{p.name}-{uid}",
        private_advertise_endpoint=f"ret-priv-{p.name}-{uid}",
        private_bind_endpoint=f"ret-priv-{p.name}-{uid}",
        heartbeat_interval_s=3600, sync_interval_s=3600,
        whitelist_interval_s=3600, device_plane=plane, **extra))
    await broker.start()
    run = p.harness.TestRun(broker=broker)
    await run.inject_users([[0, 1], [1, 2], [], [], []])
    try:
        rng = np.random.default_rng(4242)

        async def burst(tag: int):
            for i in range(20):
                t = int(rng.integers(0, 3))
                await run.send_message_as(
                    run.user(i % 2), m.Broadcast([t], b"%d-%d" % (tag, i)))
            await asyncio.sleep(0.3)
        await burst(0)
        for u, msg in ((2, m.SubscribeFrom(topic=0, seq=0)),
                       (3, m.SubscribeFrom(topic=1, seq=5)),
                       (4, m.SubscribeFrom(topic=1, seq=m.SEQ_LAST))):
            await run.user(u).remote.send_message(msg, flush=True)
        await asyncio.sleep(0.2)
        await burst(1)
        streams = [sorted(x[3] for x in await _drain_stream(p, run.user(i),
                                                           quiet=0.3))
                   if i < 2 else
                   [x[3] for x in await _drain_stream(p, run.user(i),
                                                      quiet=0.3)]
                   for i in range(5)]
        return dict(streams=streams, stats=_stats(broker.durable),
                    routed=broker.device_plane.messages_routed > 0)
    finally:
        await run.shutdown()


async def test_plane_broker_retains_and_replays_like_jax(monkeypatch):
    """The rings of a broker with a device plane hold what JAX's plane
    broker's hold, and the late users' replay-then-live streams are the
    same bytes (the two always-on users compared as multisets: the plane
    and the host path may interleave a publisher's two lanes)."""
    monkeypatch.setenv("PUSHCDN_RETAIN_TOPICS", "0,1")
    out = await _both_async(_plane_run, timeout=100)
    assert out["routed"]
    assert out["stats"]["retained_frames"] == sum(
        out["stats"]["ring_entries"].values())
