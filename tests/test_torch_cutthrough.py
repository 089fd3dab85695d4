"""The port's cut-through routing plane held against its scalar twin and
against the JAX package's cut-through plane.

The twins of the non-sharded cases of ``tests/test_route_cutthrough.py``
and ``tests/test_route_state.py``:

- the same seeded frame mixes (broadcast / direct / control / garbage)
  go through the port's broker with ``ROUTE_IMPL`` ``native`` and
  ``python`` and through the JAX package's broker with ``native``, on the
  same topology. Every run must give the same per-peer delivery
  sequences, the same disconnect decision, a byte pool that refills once
  every receiver has drained, and the same per-class frame and byte
  counters; a native run must route its chunks through the plan (the
  ``cdn_route_batch_frames`` paths say which ran);
- the same seeded interleavings of ``Connections`` mutations go to a
  port ``RouteState`` and a JAX one kept incrementally, and a port twin
  rebuilt from scratch: all three must plan the same fan-out for a probe
  chunk, and take the same labelled rebuilds;
- the same seeded mixes over loopback TCP go through the port's broker on
  asyncio with the scalar loops, on io_uring with the plan, and on
  io_uring with the fused native pump, and through the JAX package's
  broker with its pump: the same deliveries, disconnect decisions and
  pool balance, with the pump legs' frames counted under
  ``cdn_route_batch_frames{path="pump"}``.
"""

import asyncio
import gc
import importlib
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from _torch_libs import jax_pump_available, jax_routeplan_available
from pushcdn_tpu_torch.native import routeplan as port_routeplan

pytestmark = pytest.mark.skipif(
    not (jax_routeplan_available() and port_routeplan.available()),
    reason="native route-plan library unavailable (no working g++)")

ROOTS = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}


def _pkg(name: str) -> SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{ROOTS[name]}.{path}")

    return SimpleNamespace(
        name=name, cutthrough=mod("broker.tasks.cutthrough"),
        harness=mod("broker.test_harness"),
        connections=mod("broker.connections"),
        vmap=mod("broker.versioned_map"), def_=mod("proto.def_"),
        flightrec=mod("proto.flightrec"), flowclass=mod("proto.flowclass"),
        metrics=mod("proto.metrics"), msg=mod("proto.message"),
        trace=mod("proto.trace"), base=mod("proto.transport.base"),
        memory=mod("proto.transport.memory"),
        routeplan=mod("native.routeplan"),
        umod=mod("proto.transport.uring"), pump_mod=mod("proto.transport.pump"))


JAX, PORT = _pkg("jax"), _pkg("port")

# topology shared by every mix: sender is user 0 / peer 0; receivers are
# users 1-4 (topics {0}, {0}, {1}, {}) and peer brokers (topic sets below)
USER_TOPICS = [[], [0], [0], [1], []]
BROKER_DEFS = [([0], [b"remote-user"]), ([1], [])]
KNOWN_DIRECTS = [b"user-1", b"user-2", b"user-3", b"user-4",
                 b"remote-user", b"nobody-home"]
SYNC_OWNER = "testbrokerpub-0:0/testbrokerpriv-0:0"


def _sync_payload(ident: str) -> bytes:
    m = PORT.vmap.VersionedMap(local_identity=ident)
    m.insert(b"synced-user", ident)
    return PORT.vmap.VersionedMap.serialize_entries(m.full())


def _gen_frames(rng: np.random.Generator, n: int, as_user: bool):
    """A seeded mix of wire frames (the port's serializer; the wire is the
    JAX package's byte for byte)."""
    m = PORT.msg
    frames = []
    for _ in range(n):
        roll = rng.integers(0, 100)
        payload = bytes(rng.integers(0, 256, int(rng.integers(1, 64)),
                                     dtype=np.uint8))
        if roll < 55:
            # broadcasts, sometimes with invalid (7) or duplicate topics
            topics = [int(t) for t in rng.choice(
                [0, 1, 7], size=int(rng.integers(1, 4)))]
            frames.append(m.serialize(m.Broadcast(topics, payload)))
        elif roll < 80:
            rcpt = KNOWN_DIRECTS[int(rng.integers(0, len(KNOWN_DIRECTS)))]
            frames.append(m.serialize(m.Direct(rcpt, payload)))
        elif roll < 88:
            topics = [int(t) for t in rng.choice(
                [0, 1, 7] if not as_user else [0, 1],
                size=int(rng.integers(1, 3)))]
            frames.append(m.serialize(m.Subscribe(topics)))
        elif roll < 93:
            frames.append(m.serialize(m.Unsubscribe([0])))
        elif roll < 96:
            frames.append(m.serialize(m.UserSync(_sync_payload(SYNC_OWNER))))
        elif roll < 98:
            frames.append(m.serialize(m.TopicSync(_sync_payload(SYNC_OWNER))))
        elif roll < 99:
            frames.append(m.serialize(m.AuthenticateWithPermit(permit=7)))
        else:
            frames.append(b"\xfe" + payload)  # garbage: unknown kind
    return frames


def _gen_churn_frames(rng: np.random.Generator, n: int):
    """A control-frame-heavy mix: every hot frame is planned against a
    snapshot that just absorbed a mutation."""
    m = PORT.msg
    frames = []
    for _ in range(n):
        roll = rng.integers(0, 100)
        payload = bytes(rng.integers(0, 256, int(rng.integers(1, 48)),
                                     dtype=np.uint8))
        if roll < 30:
            topics = [int(t) for t in rng.choice(
                [0, 1], size=int(rng.integers(1, 3)))]
            frames.append(m.serialize(m.Broadcast(topics, payload)))
        elif roll < 45:
            rcpt = KNOWN_DIRECTS[int(rng.integers(0, len(KNOWN_DIRECTS)))]
            frames.append(m.serialize(m.Direct(rcpt, payload)))
        elif roll < 70:
            frames.append(m.serialize(m.Subscribe(
                [int(t) for t in rng.choice([0, 1],
                                            size=int(rng.integers(1, 3)))])))
        elif roll < 90:
            frames.append(m.serialize(m.Unsubscribe(
                [int(rng.integers(0, 2))])))
        elif roll < 97:
            frames.append(m.serialize(m.UserSync(_sync_payload(SYNC_OWNER))))
        else:
            frames.append(m.serialize(m.TopicSync(_sync_payload(SYNC_OWNER))))
    return frames


async def _drain_all(p, conn, settle_s: float = 0.05):
    """Collect every delivered frame (as bytes) until silence."""
    got = []
    while True:
        try:
            items = await asyncio.wait_for(conn.recv_frames(), settle_s)
        except (asyncio.TimeoutError, Exception):
            return got
        for item in items:
            if type(item) is p.base.FrameChunk:
                got.extend(bytes(mv) for mv in item.views())
            else:
                got.append(bytes(item.data))
            item.release()


# consensus, live, bulk (control is timer-driven, not a function of the mix)
_ACCOUNTED_CLASSES = (1, 2, 3)
_PATHS = ("cutthrough", "residual", "scalar")


def _counters(p) -> list:
    m = p.metrics
    classes = [fam[i].value
               for fam in (m.CLASS_FRAMES_OUT, m.CLASS_FRAMES_IN,
                           m.CLASS_BYTES_OUT, m.CLASS_BYTES_IN)
               for i in _ACCOUNTED_CLASSES]
    paths = [m.ROUTE_FRAMES.labels(path=path).value for path in _PATHS]
    return classes + paths


async def _run_mix(p, impl: str, frames, as_user: bool, chunked: bool,
                   incremental=None) -> dict:
    """One mix through package ``p``'s broker with ``ROUTE_IMPL = impl``:
    per-peer delivery lists, sender still connected, pool balanced, the
    per-class counter deltas and the frames routed per path."""
    cut = p.cutthrough
    prev = (cut.ROUTE_IMPL, cut.ROUTE_INCREMENTAL)
    prev_win = p.memory.Memory.set_duplex_window(512 * 1024)
    cut.ROUTE_IMPL = impl
    if incremental is not None:
        cut.ROUTE_INCREMENTAL = incremental
    before = _counters(p)
    try:
        run = await p.harness.TestDefinition(
            connected_users=USER_TOPICS, connected_brokers=BROKER_DEFS).run()
        try:
            sender = (run.user(0) if as_user else run.peer(0)).remote
            try:
                if chunked:
                    # one batch ⇒ arrives as FrameChunk(s): the plan path
                    await sender.send_raw_many(list(frames), flush=True)
                else:
                    # flushed singles ⇒ depth-1 Bytes: the residual path
                    for f in frames:
                        await sender.send_raw(f, flush=True)
            except Exception:
                pass  # peer disconnected us mid-send: a legal outcome
            await asyncio.sleep(0.15)

            ends = {f"user-{i}": run.user(i).remote
                    for i in range(1, len(USER_TOPICS))}
            for j in range(len(BROKER_DEFS)):
                if as_user or j != 0:  # skip the sender itself
                    ends[f"peer-{j}"] = run.peer(j).remote
            if as_user:
                ends["user-0"] = run.user(0).remote
            deliveries = dict(zip(ends, await asyncio.gather(
                *(_drain_all(p, conn) for conn in ends.values()))))
            if as_user:
                alive = run.broker.connections.has_user(b"user-0")
            else:
                alive = run.broker.connections.has_broker(
                    run.peer(0).identifier)

            # permit balance: everything drained and released above; the
            # pool must refill (leases release via refcount/GC)
            pool = run.broker.limiter.pool
            balanced = True
            if pool is not None:
                for _ in range(10):
                    gc.collect()
                    if pool.available == pool.capacity:
                        break
                    await asyncio.sleep(0.02)
                balanced = pool.available == pool.capacity
        finally:
            await run.shutdown()
    finally:
        cut.ROUTE_IMPL, cut.ROUTE_INCREMENTAL = prev
        p.memory.Memory.set_duplex_window(prev_win)
    delta = [a - b for a, b in zip(_counters(p), before)]
    n = 4 * len(_ACCOUNTED_CLASSES)
    return dict(deliveries=deliveries, alive=alive, balanced=balanced,
                classes=delta[:n], paths=dict(zip(_PATHS, delta[n:])))


def _check_paths(run: dict, impl: str) -> None:
    """The run took the path its impl names: the plan (its residual twin
    takes control frames, depth-1 singles and a first frame that drops
    the sender) for native, the scalar loops for python."""
    paths = run["paths"]
    if impl == "python":
        assert paths["cutthrough"] == paths["residual"] == 0, paths
        assert paths["scalar"] > 0, paths
    else:
        assert paths["scalar"] == 0, paths
        assert paths["cutthrough"] + paths["residual"] > 0, paths


def _same(runs: dict, label) -> None:
    """Port native = port python = JAX native, on every recorded fact."""
    ref = runs["jax native"]
    assert ref["balanced"], f"{label}: JAX pool permits leaked"
    for name, run in runs.items():
        assert run["alive"] == ref["alive"], f"{label}: {name} disconnects"
        assert run["deliveries"] == ref["deliveries"], \
            f"{label}: {name} delivery sequences differ"
        assert run["balanced"], f"{label}: {name} pool permits leaked"
        assert run["classes"] == ref["classes"], \
            f"{label}: {name} per-class counters differ"


async def _three_ways(frames, as_user: bool, chunked: bool = True) -> dict:
    runs = {}
    for p, impl in ((PORT, "native"), (PORT, "python"), (JAX, "native")):
        runs[f"{p.name} {impl}"] = run = await _run_mix(
            p, impl, frames, as_user=as_user, chunked=chunked)
        if p is PORT:
            _check_paths(run, impl)
    return runs


@pytest.mark.parametrize("seed", range(8))
async def test_user_mix_matches_scalar_and_jax(seed):
    rng = np.random.default_rng(1000 + seed)
    frames = _gen_frames(rng, 60, as_user=True)
    _same(await _three_ways(frames, as_user=True), seed)


@pytest.mark.parametrize("seed", range(4))
async def test_broker_mix_matches_scalar_and_jax(seed):
    rng = np.random.default_rng(2000 + seed)
    frames = _gen_frames(rng, 60, as_user=False)
    _same(await _three_ways(frames, as_user=False), seed)


async def test_subscribe_then_broadcast_same_chunk():
    """The residual seam: a Subscribe and a Broadcast on the just-
    subscribed topic land in ONE chunk — the plan must stop, apply the
    subscription, refresh, and deliver the broadcast back to the
    sender."""
    m = PORT.msg
    frames = [m.serialize(m.Subscribe([1])),
              m.serialize(m.Broadcast([1], b"fresh-topic")),
              m.serialize(m.Unsubscribe([1])),
              m.serialize(m.Broadcast([1], b"after-unsub"))]
    runs = await _three_ways(frames, as_user=True)
    _same(runs, "subscribe-then-broadcast")
    d = runs["port native"]["deliveries"]
    assert runs["port native"]["alive"]
    assert d["user-0"] == [m.serialize(m.Broadcast((1,), b"fresh-topic"))]
    # user-3 is subscribed to topic 1 throughout: gets both broadcasts
    assert d["user-3"] == [m.serialize(m.Broadcast((1,), b"fresh-topic")),
                           m.serialize(m.Broadcast((1,), b"after-unsub"))]


async def test_traced_frame_mid_chunk():
    """A traced Broadcast mid-chunk stops the plan on the kind-tag flag
    bit and takes the instrumented scalar path, forwarded verbatim, while
    its twelve untraced neighbours cut through; the port's broker emits
    the ingress / plan / egress spans for it."""
    m, tr_lib = PORT.msg, PORT.trace
    tr = tr_lib.new_trace()
    traced = tr_lib.stamp_frame(m.serialize(m.Broadcast([0], b"traced")), tr)
    frames = ([m.serialize(m.Broadcast([0], b"pre-%d" % i)) for i in range(6)]
              + [traced]
              + [m.serialize(m.Broadcast([0], b"post-%d" % i))
                 for i in range(6)])
    tr_lib.recent.clear()
    runs = await _three_ways(frames, as_user=True)
    _same(runs, "traced")
    hops = {h for h, tid, *_ in tr_lib.recent if tid == tr[0]}
    assert {"ingress", "plan", "egress"} <= hops, hops
    paths = runs["port native"]["paths"]
    assert paths["cutthrough"] >= 12 and paths["residual"] == 1, paths
    for peer in ("user-1", "user-2"):
        got = runs["port native"]["deliveries"][peer]
        assert len(got) == 13 and got[6] == traced, peer


@pytest.mark.parametrize("seed", range(4))
async def test_churn_mix_incremental_vs_rebuild_vs_python(seed):
    """Under subscribe-churn-heavy mixes the port's in-place deltas, its
    rebuild-per-invalidation baseline, its scalar loops and the JAX
    package's deltas give the same deliveries and decisions."""
    rng = np.random.default_rng(8000 + seed)
    frames = _gen_churn_frames(rng, 70)
    runs = {}
    for p, impl, inc in ((PORT, "native", True), (PORT, "native", False),
                         (PORT, "python", None), (JAX, "native", True)):
        runs[f"{p.name} {impl} {inc}"] = await _run_mix(
            p, impl, frames, as_user=True, chunked=True, incremental=inc)
    runs["jax native"] = runs.pop("jax native True")
    _same(runs, seed)
    _check_paths(runs["port native True"], "native")
    _check_paths(runs["port python None"], "python")
    # the rebuild baseline's churn guard sends some chunks to the scalar
    # loop, never all of them
    assert runs["port native False"]["paths"]["cutthrough"] > 0


async def test_depth1_singles():
    """Flushed singles ride the depth-1 Bytes path through the cut-through
    drain; decisions still match the scalar loops and JAX."""
    rng = np.random.default_rng(77)
    frames = _gen_frames(rng, 25, as_user=True)
    _same(await _three_ways(frames, as_user=True, chunked=False), "depth-1")


@pytest.mark.parametrize("seed,chunked", [(0, True), (1, True), (2, False)])
async def test_class_accounting(seed, chunked, monkeypatch):
    """With topic names binding consensus (topic 0) and bulk (topic 1)
    classes, the plan's per-frame classes fold the same per-class frame
    and byte counters as the scalar senders, and as JAX's plan."""
    rng = np.random.default_rng(5000 + seed)
    frames = _gen_frames(rng, 60, as_user=True)
    monkeypatch.setenv("PUSHCDN_TOPIC_NAMES", "consensus.votes=0,bulk.replay=1")
    try:
        runs = await _three_ways(frames, as_user=True, chunked=chunked)
    finally:
        monkeypatch.delenv("PUSHCDN_TOPIC_NAMES")
        for p in (JAX, PORT):
            p.flowclass.install_table(p.flowclass.compile_table())
    _same(runs, seed)
    # the mix must move the classed topics, or this proves nothing
    frames_out = dict(zip(_ACCOUNTED_CLASSES,
                          runs["port native"]["classes"][:3]))
    assert frames_out[1] > 0, "no consensus egress accounted"
    assert frames_out[3] > 0, "no bulk egress accounted"


# ---------------------------------------------------------------------------
# RouteState: incremental maintenance against a fresh rebuild and JAX's
# ---------------------------------------------------------------------------

IDENTITY = "pub:me/priv:me"
PEERS = ["pub:a/priv:a", "pub:b/priv:b", "pub:c/priv:c"]
USERS = [b"user-%d" % i for i in range(12)]
TOPICS = [0, 1]


class _FakeConn:
    """Just enough Connection surface for Connections bookkeeping."""

    def __init__(self, p):
        self.flightrec = p.flightrec.FlightRecorder("fake")

    def close(self):
        pass


class _PlanBroker:
    """Minimal broker shim for a control-plane-only RouteState."""

    def __init__(self, p):
        self.connections = p.connections.Connections(IDENTITY)
        self.run_def = p.def_.testing_run_def()
        self.device_plane = None
        self.admission = None
        self.durable = None


def _vmap_payload(p, owner: str, entries) -> bytes:
    m = p.vmap.VersionedMap(local_identity=owner)
    for k, v in entries:
        m.insert(k, v)
    return p.vmap.VersionedMap.serialize_entries(m.full())


def _apply_random_op(p, rng, conns) -> None:
    roll = int(rng.integers(0, 100))
    user = USERS[int(rng.integers(0, len(USERS)))]
    peer = PEERS[int(rng.integers(0, len(PEERS)))]
    topics = [int(t) for t in
              rng.choice(TOPICS, size=int(rng.integers(1, 3)))]
    if roll < 22:
        conns.add_user(user, _FakeConn(p), topics)
    elif roll < 34:
        conns.remove_user(user)
    elif roll < 52:
        if user in conns.users:
            conns.subscribe_user_to(user, topics)
    elif roll < 64:
        conns.unsubscribe_user_from(user, topics)
    elif roll < 72:
        if peer not in conns.brokers:
            conns.add_broker(peer, _FakeConn(p))
        else:
            conns.remove_broker(peer)
    elif roll < 82:
        # mesh topic sync: the peer (if linked) advertises a random flip
        if peer in conns.brokers:
            status = p.connections.SubscriptionStatus
            conns.apply_topic_sync(peer, _vmap_payload(p, peer, [
                (int(t), int(status.SUBSCRIBED if rng.integers(0, 2)
                             else status.UNSUBSCRIBED)) for t in topics]))
    else:
        # DirectMap merge: a peer claims some users (evicts local ones)
        claim = [USERS[int(i)] for i in rng.integers(0, len(USERS), size=2)]
        conns.apply_user_sync(_vmap_payload(p, peer,
                                            [(k, peer) for k in claim]))


class _Twins:
    """One ``_PlanBroker`` and incremental ``RouteState`` per package,
    driven by the same seeded operations."""

    def __init__(self, seed: int = 0):
        self.side = {}
        for p in (PORT, JAX):
            broker = _PlanBroker(p)
            state = p.cutthrough.RouteState(
                broker, p.routeplan.RoutePlanner.create())
            self.side[p.name] = (p, broker, state,
                                 np.random.default_rng(seed))

    def each(self):
        return self.side.values()

    def op(self, n: int = 1) -> None:
        for p, broker, _state, rng in self.each():
            for _ in range(n):
                _apply_random_op(p, rng, broker.connections)

    def do(self, fn) -> None:
        """``fn(p, connections)`` on both packages."""
        for p, broker, _state, _rng in self.each():
            fn(p, broker.connections)

    def refresh(self) -> None:
        for p, _broker, state, _rng in self.each():
            assert state._refresh(), f"{p.name}: incremental refresh failed"

    def state(self, name: str = "port"):
        return self.side[name][2]

    def check(self) -> None:
        """Port incremental = port rebuilt = JAX incremental, in both
        modes, and both packages took the same labelled rebuilds."""
        self.refresh()
        p, broker, inc, _rng = self.side["port"]
        twin = p.cutthrough.RouteState(broker,
                                       p.routeplan.RoutePlanner.create())
        assert twin._refresh()
        chunk = _probe_chunk()
        for mode in (0, 1):
            want = _plan_map(inc, chunk, mode)
            assert _plan_map(twin, chunk, mode) == want, mode
            assert _plan_map(self.state("jax"), chunk, mode) == want, mode
        assert inc.rebuild_counts == self.state("jax").rebuild_counts


def _probe_chunk():
    """One chunk touching every topic and every known Direct recipient."""
    m = PORT.msg
    frames = [m.serialize(m.Broadcast([t], b"probe-t%d" % t)) for t in TOPICS]
    frames.append(m.serialize(m.Broadcast(TOPICS, b"probe-all")))
    frames += [m.serialize(m.Direct(u, b"probe-d")) for u in USERS]
    buf = bytearray()
    offs, lens = [], []
    for f in frames:
        offs.append(len(buf) + 4)
        lens.append(len(f))
        buf += len(f).to_bytes(4, "big") + f
    return bytes(buf), np.asarray(offs, np.int64), np.asarray(lens, np.int64)


def _plan_map(state, chunk, mode: int) -> dict:
    """{(kind, identity, shard): (frame indices...)} for one full plan —
    slot numbering is an implementation detail, identity and shard
    placement are the contract."""
    buf, offs, lens = chunk
    out: dict = {}
    pos, n = 0, len(offs)
    while pos < n:
        consumed, stop, peers, frames = state.planner.plan(
            buf, offs, lens, pos, mode)
        for peer, f in zip(peers.tolist(), frames.tolist()):
            if peer < state.user_cap:
                key = ("user", state.slot_user[peer], state.user_shard[peer])
            else:
                b = peer - state.user_cap
                key = ("broker", state.slot_broker[b], state.broker_shard[b])
            assert key[1] is not None, "plan emitted a freed slot"
            out.setdefault(key, []).append(f)
        pos += consumed
        if stop == PORT.routeplan.STOP_RESIDUAL:
            pos += 1
    return {k: tuple(v) for k, v in out.items()}


@pytest.mark.parametrize("seed", range(6))
def test_incremental_equals_rebuild_and_jax(seed):
    twins = _Twins(9000 + seed)
    twins.refresh()
    for step in range(120):
        twins.op()
        if step % 3 == 0:  # often enough to stay on deltas
            twins.refresh()
        if step % 10 == 9:
            twins.check()
    twins.check()
    inc = twins.state()
    assert inc.rebuild_counts == {"first_build": 1}, inc.rebuild_counts
    assert inc.deltas_applied == twins.state("jax").deltas_applied > 50


def test_delta_overflow_falls_back_and_recovers():
    twins = _Twins(42)
    twins.refresh()
    twins.op(400)  # > max(256, live/2) dirty records, unrefreshed
    twins.check()
    assert twins.state().rebuild_counts.get("delta_overflow") == 1
    twins.do(lambda p, c: c.add_user(b"user-0", _FakeConn(p), [0]))
    twins.check()
    assert twins.state().rebuild_counts.get("delta_overflow") == 1


def test_version_gap_falls_back_and_recovers(monkeypatch):
    for p in (PORT, JAX):
        monkeypatch.setattr(p.connections, "ROUTE_LOG_MAX", 16)
    twins = _Twins(43)
    twins.refresh()
    twins.op(60)  # >> 16 records: the log trims past the cursor
    for p, broker, state, _rng in twins.each():
        assert broker.connections.route_log_start > state.log_seq, p.name
    twins.check()
    assert twins.state().rebuild_counts.get("version_gap") == 1


def test_slot_growth_falls_back_and_recovers():
    twins = _Twins()
    twins.refresh()
    cap0 = twins.state().user_cap
    for i in range(cap0 + 40):
        twins.do(lambda p, c: c.add_user(b"grow-%d" % i, _FakeConn(p), [0]))
        if i % 7 == 0:
            twins.refresh()
    twins.check()
    assert twins.state().rebuild_counts.get("growth", 0) >= 1
    assert twins.state().user_cap == twins.state("jax").user_cap > cap0


def test_compaction_purges_lazy_garbage(monkeypatch):
    for p in (PORT, JAX):
        monkeypatch.setattr(p.cutthrough, "_COMPACT_CHECK_EVERY", 4)
    twins = _Twins()
    for i in range(8):
        twins.do(lambda p, c: c.add_user(b"user-%d" % i, _FakeConn(p), [0]))
    twins.refresh()
    # the refresh lands BETWEEN the subscribe and the unsubscribe: a pair
    # inside one delta batch coalesces to no mask change and no garbage
    for _ in range(300):
        for i in range(8):
            twins.do(lambda p, c: c.subscribe_user_to(b"user-%d" % i, [1]))
        twins.refresh()
        for i in range(8):
            twins.do(lambda p, c: c.unsubscribe_user_from(b"user-%d" % i,
                                                          [1]))
        twins.refresh()
        if twins.state().rebuild_counts.get("compaction"):
            break
    inc = twins.state()
    assert inc.rebuild_counts.get("compaction", 0) >= 1, inc.rebuild_counts
    s = inc.planner.stats()
    assert s["list_entries"] <= 2 * s["live_subs"] + 1024
    assert s == twins.state("jax").planner.stats()
    twins.check()


def test_delta_apply_is_o_delta_not_o_users():
    """One subscribe against a 10,000-user table is one update row
    (both packages keep to the first build), and applying it costs far
    less than a rebuild of that table."""
    p = PORT
    broker = _PlanBroker(p)
    conns = broker.connections
    for i in range(10_000):
        conns.add_user(b"u%05d" % i, _FakeConn(p), [i % 2])
    inc = p.cutthrough.RouteState(broker, p.routeplan.RoutePlanner.create())
    t0 = time.perf_counter()
    assert inc._refresh()
    rebuild_s = time.perf_counter() - t0

    def one_delta_seconds() -> float:
        conns.subscribe_user_to(b"u00001", [1])
        t0 = time.perf_counter()
        assert inc._refresh()
        dt = time.perf_counter() - t0
        conns.unsubscribe_user_from(b"u00001", [1])
        assert inc._refresh()
        return dt

    samples = sorted(one_delta_seconds() for _ in range(7))
    assert samples[len(samples) // 2] < rebuild_s / 5, (samples, rebuild_s)
    assert inc.rebuild_counts == {"first_build": 1}, inc.rebuild_counts
    assert inc.deltas_applied == 14


def test_storm_rebuilds_arm_the_churn_guard(monkeypatch):
    """Version-gap rebuilds that never amortized arm the churn guard: the
    next invalidations route scalar instead of rebuilding again, as on
    JAX's table."""
    for p in (PORT, JAX):
        monkeypatch.setattr(p.connections, "ROUTE_LOG_MAX", 16)
    twins = _Twins(77)
    twins.refresh()
    twins.op(60)
    twins.refresh()
    for _p, _broker, state, _rng in twins.each():
        assert state.rebuild_counts.get("version_gap") == 1
        assert state._skip_rebuilds > 0
    twins.op(60)
    for p, _broker, state, _rng in twins.each():
        skips = state._skip_rebuilds
        assert not state._refresh(), p.name
        assert state._skip_rebuilds == skips - 1
        assert state.rebuild_counts.get("version_gap") == 1
        # amortized: the next storm pays a rebuild again
        state._skip_rebuilds = 0
        state._frames_since_rebuild = 1 << 20
    twins.check()
    for _p, _broker, state, _rng in twins.each():
        assert state.rebuild_counts.get("version_gap") == 2
        assert state._skip_rebuilds == 0


def test_acquire_selects_as_jax_does(monkeypatch):
    """``ROUTE_IMPL`` selects the plane as the reference's does: auto and
    native engage on a broker without a plane and with the default hook;
    python, a device plane or a custom hook keep the scalar loops; a
    library that did not build degrades to them with one warning."""
    p = PORT
    cut = p.cutthrough
    no_hook = p.def_.no_hook
    for impl, plane, hook, engaged in (
            ("auto", None, no_hook, True), ("native", None, no_hook, True),
            ("python", None, no_hook, False),
            ("auto", object(), no_hook, False),
            ("auto", None, lambda s, m: None, False)):
        monkeypatch.setattr(cut, "ROUTE_IMPL", impl)
        broker = _PlanBroker(p)
        broker.device_plane = plane
        state = cut.acquire(broker, hook)
        assert (state is not None) == engaged, (impl, plane, hook)
        if engaged:
            assert cut.acquire(broker, hook) is state  # one per broker
    monkeypatch.setattr(cut, "ROUTE_IMPL", "native")
    monkeypatch.setattr(cut, "_warned_unavailable", False)
    monkeypatch.setattr(p.routeplan.RoutePlanner, "create",
                        classmethod(lambda cls: None))
    assert cut.acquire(_PlanBroker(p), no_hook) is None
    assert cut._warned_unavailable


@pytest.mark.parametrize("value,impl", [
    ("", "auto"), ("auto", "auto"), ("native", "native"),
    ("python", "python"), ("1", "native"), ("0", "python")])
def test_route_impl_env(value, impl):
    """``PUSHCDN_ROUTE_CUTTHROUGH`` reads as JAX's does (default auto)."""
    import subprocess
    import sys
    code = ("from pushcdn_tpu_torch.broker.tasks import cutthrough as c; "
            "print(c.ROUTE_IMPL)")
    env = dict(os.environ, PUSHCDN_ROUTE_CUTTHROUGH=value)
    if not value:
        env.pop("PUSHCDN_ROUTE_CUTTHROUGH")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == impl


# ---------------------------------------------------------------------------
# the fused native pump: the twins of test_pump_mix_equivalence and its
# durable case
# ---------------------------------------------------------------------------

from pushcdn_tpu_torch.native import pump as _port_npump  # noqa: E402
from pushcdn_tpu_torch.native import uring as _port_nuring  # noqa: E402

_PUMP_OK = (_port_nuring.available() and _port_npump.available()
            and jax_pump_available())
requires_pump = pytest.mark.skipif(
    not _PUMP_OK,
    reason="fused pump needs io_uring + the native route-plan library")

# legs: the port's scalar reference, its cut-through on io_uring, its
# fused pump, and the JAX package's fused pump
_PUMP_LEGS = ((PORT, "asyncio", "python", "off"),
              (PORT, "uring", "native", "off"),
              (PORT, "uring", "native", "auto"),
              (JAX, "uring", "native", "auto"))


def _gen_pump_frames(rng: np.random.Generator, n: int, popularity: str):
    """A seeded mix covering every pump escalation class: broadcasts
    (uniform or zipf topic popularity), directs, control (sub/unsub),
    traced frames, and trailing garbage. The warmup prefix engages the
    pump before the interesting frames arrive."""
    m, trace_lib = PORT.msg, PORT.trace
    topic_p = np.array([0.85, 0.15] if popularity == "zipf"
                       else [0.5, 0.5])

    def pick_topics(k):
        return [int(t) for t in rng.choice([0, 1], size=k, p=topic_p)]

    frames = [m.serialize(m.Broadcast([0], b"warm-%02d" % i))
              for i in range(8)]
    for _ in range(n):
        roll = rng.integers(0, 100)
        payload = bytes(rng.integers(0, 256, int(rng.integers(1, 256)),
                                     dtype=np.uint8))
        if roll < 60:
            frames.append(m.serialize(m.Broadcast(
                pick_topics(int(rng.integers(1, 3))), payload)))
        elif roll < 78:
            rcpt = KNOWN_DIRECTS[int(rng.integers(0, len(KNOWN_DIRECTS)))]
            frames.append(m.serialize(m.Direct(rcpt, payload)))
        elif roll < 86:
            frames.append(m.serialize(m.Subscribe(pick_topics(1))))
        elif roll < 92:
            frames.append(m.serialize(m.Unsubscribe([0])))
        elif roll < 97:
            tr = trace_lib.new_trace()
            frames.append(trace_lib.stamp_frame(
                m.serialize(m.Broadcast(pick_topics(1), payload)), tr))
        else:
            frames.append(b"\xfe" + payload)  # garbage: unknown kind
    return frames


async def _drain_tcp(p, user, quiet=0.3):
    """Every frame a TCP user receives until silence, as full bytes."""
    got = []
    while True:
        try:
            raw = await asyncio.wait_for(user.remote.recv_raw(), quiet)
        except (asyncio.TimeoutError, Exception):
            return got
        if type(raw) is p.base.FrameChunk:
            got.extend(bytes(mv) for mv in raw.views())
        elif hasattr(raw, "data"):
            got.append(bytes(raw.data))
        else:
            got.append(bytes(raw))
        if hasattr(raw, "release"):
            raw.release()


async def _pool_balanced(pool) -> bool:
    if pool is None:
        return True
    for _ in range(20):
        gc.collect()
        if pool.available == pool.capacity:
            return True
        await asyncio.sleep(0.02)
    return pool.available == pool.capacity


async def _run_mix_pump(p, io_impl, route_impl, pump, frames, retain=None):
    """One mix through package ``p``'s broker on one (io, route, pump) leg
    over loopback TCP: (deliveries, sender alive, balanced, pump summary,
    frames counted under path=pump)."""
    cut, umod, pump_mod = p.cutthrough, p.umod, p.pump_mod
    prev_impl = cut.ROUTE_IMPL
    saved = (umod._resolved, umod._warned_demote,
             pump_mod.PUMP_IMPL, pump_mod._warned_demote)
    prev_env = {k: os.environ.get(k)
                for k in ("PUSHCDN_RETAIN_TOPICS", "PUSHCDN_IO_IMPL")}
    pumped = p.metrics.ROUTE_PUMP_FRAMES
    pumped_before = pumped.value
    umod.set_io_impl(io_impl)
    cut.ROUTE_IMPL = route_impl
    pump_mod.set_pump_impl(pump)
    if retain is not None:
        os.environ["PUSHCDN_RETAIN_TOPICS"] = retain
    else:
        os.environ.pop("PUSHCDN_RETAIN_TOPICS", None)
    try:
        run = await p.harness.TestDefinition(
            connected_users=USER_TOPICS, connected_brokers=BROKER_DEFS,
            tcp_users=True).run()
        try:
            sender = run.user(0).remote
            try:
                # warmup wave, then an idle gap: the pump legs engage
                # before the seeded mix arrives (a no-op for the others)
                await sender.send_raw_many(list(frames[:8]), flush=True)
                await asyncio.sleep(0.2)
                await sender.send_raw_many(list(frames[8:]), flush=True)
            except Exception:
                pass  # disconnected mid-send: a legal outcome
            await asyncio.sleep(0.3)
            deliveries = {}
            for i in range(1, len(USER_TOPICS)):
                deliveries[f"user-{i}"] = await _drain_tcp(p, run.user(i))
            for j in range(len(BROKER_DEFS)):
                deliveries[f"peer-{j}"] = await _drain_all(
                    p, run.peer(j).remote)
            deliveries["user-0"] = await _drain_tcp(p, run.user(0))
            alive = run.broker.connections.has_user(b"user-0")
            state = getattr(run.broker, "_route_state", None)
            ps = getattr(state, "_pump_state", None)
            summary = (ps.summary() if ps is not None and not ps.closed
                       else None)
            # with retention on, the rings park leases until broker close
            balanced = (retain is not None
                        or await _pool_balanced(run.broker.limiter.pool))
        finally:
            await run.shutdown()
        if retain is not None:
            balanced = await _pool_balanced(run.broker.limiter.pool)
        return (deliveries, alive, balanced, summary,
                pumped.value - pumped_before)
    finally:
        umod.UringEngine.shutdown()
        cut.ROUTE_IMPL = prev_impl
        (umod._resolved, umod._warned_demote,
         pump_mod.PUMP_IMPL, pump_mod._warned_demote) = saved
        for k, v in prev_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


async def _pump_legs(frames, label, retain=None):
    baseline = base_alive = None
    for p, io_impl, route_impl, pump in _PUMP_LEGS:
        leg = f"{label}: {p.name} {io_impl}/{route_impl}/pump={pump}"
        d, alive, balanced, summary, pumped = await _run_mix_pump(
            p, io_impl, route_impl, pump, frames, retain=retain)
        assert balanced, f"{leg}: pool permits leaked"
        if baseline is None:
            baseline, base_alive = d, alive
            assert any(len(v) > 0 for v in d.values()), d
        assert alive == base_alive, f"{leg}: disconnect decisions differ"
        assert d == baseline, f"{leg}: delivery diverged"
        if pump == "auto":
            assert summary is not None and summary["pump_frames"] > 0, (
                f"{leg}: never pumped: {summary}")
            assert pumped > 0, f"{leg}: nothing counted under path=pump"
        else:
            assert pumped == 0, f"{leg}: path=pump counted without a pump"


@requires_pump
@pytest.mark.parametrize("popularity", ("uniform", "zipf"))
@pytest.mark.parametrize("seed", range(3))
async def test_pump_mix_equivalence(seed, popularity):
    rng = np.random.default_rng(17_000 + seed
                                + (500 if popularity == "zipf" else 0))
    await _pump_legs(_gen_pump_frames(rng, 48, popularity),
                     f"seed {seed}/{popularity}")


@requires_pump
async def test_pump_mix_equivalence_durable():
    """The durable escalation class: with topic 0 retained, the pump must
    hand retained broadcasts to the retention ring exactly as the scalar
    path does — identical live deliveries, and the pump still engaged
    for the rest of the mix."""
    rng = np.random.default_rng(17_900)
    await _pump_legs(_gen_pump_frames(rng, 48, "uniform"), "durable",
                     retain="0")
