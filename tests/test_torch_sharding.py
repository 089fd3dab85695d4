"""The port's worker shards (the sharded host data plane) held against
the JAX package's.

The twins of the sharded cases of ``tests/test_route_cutthrough.py``,
``tests/test_route_state.py``, ``tests/test_migration.py``,
``tests/test_ledger.py`` and ``tests/test_composition_invariants.py``.
Each case feeds the same seeded frames to the port's N-worker-shard
harness (``pushcdn_tpu_torch.testing.shardharness.run_sharded``), to the
JAX package's N-shard harness and to the JAX package's broker of one
shard, under ``ROUTE_IMPL`` ``native`` and ``python`` on both packages,
and holds **port N-shard = JAX N-shard = JAX 1-shard** on the per-peer
delivery sequences, the disconnect decisions, the permit balance of every
byte pool and the per-class counters; the port's and JAX's N-shard runs
must also hand the same records to the rings. A native case skips only
where ``g++`` cannot build either route-plan library.
"""

import asyncio
import gc
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

import test_torch_cutthrough as cut_twins
from _torch_libs import jax_routeplan_available
from pushcdn_tpu_torch.native import routeplan as port_routeplan

ROOTS = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}
IMPLS = ("native", "python")
NATIVE_OK = jax_routeplan_available() and port_routeplan.available()


def _pkg(name: str) -> SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{ROOTS[name]}.{path}")

    base = getattr(cut_twins, name.upper())
    return SimpleNamespace(
        **vars(base), shardharness=mod("testing.shardharness"),
        handlers=mod("broker.tasks.handlers"), ledger=mod("proto.ledger"),
        sharding=mod("broker.sharding"))


JAX, PORT = _pkg("jax"), _pkg("port")
USER_TOPICS = cut_twins.USER_TOPICS
BROKER_DEFS = cut_twins.BROKER_DEFS


def _need(impl: str) -> None:
    if impl == "native" and not NATIVE_OK:
        pytest.skip("native route-plan library unavailable (no working g++)")


def _handoffs(p) -> list:
    m = p.metrics
    return [m.SHARD_HANDOFF_RING.value, m.SHARD_HANDOFF_FRAMES_RING.value,
            m.SHARD_HANDOFF_FALLBACK.value, m.SHARD_HANDOFF_SHED.value]


async def _pools_balanced(brokers) -> bool:
    balanced = True
    for broker in brokers:
        pool = broker.limiter.pool
        if pool is None:
            continue
        for _ in range(20):
            gc.collect()
            if pool.available == pool.capacity:
                break
            await asyncio.sleep(0.02)
        balanced = balanced and pool.available == pool.capacity
    return balanced


async def _run_sharded_mix(p, impl: str, frames, as_user: bool,
                           num_shards: int = 2) -> dict:
    """The sharded twin of ``test_torch_cutthrough._run_mix``: the same
    topology, users dealt round-robin over the worker shards (sender
    user-0 / peer-0 on shard 0), every frame batch sent as one chunk."""
    cut = p.cutthrough
    prev_impl = cut.ROUTE_IMPL
    prev_win = p.memory.Memory.set_duplex_window(512 * 1024)
    cut.ROUTE_IMPL = impl
    before = cut_twins._counters(p)
    ring_before = _handoffs(p)
    try:
        run = await p.shardharness.run_sharded(
            [(i % num_shards, topics)
             for i, topics in enumerate(USER_TOPICS)],
            num_shards=num_shards, connected_brokers=BROKER_DEFS)
        try:
            sender = (run.user(0) if as_user else run.peer(0)).remote
            try:
                await sender.send_raw_many(list(frames), flush=True)
            except Exception:
                pass  # disconnected mid-send: a legal outcome
            await asyncio.sleep(0.15)
            await run.settle(40)
            ends = {f"user-{i}": run.user(i).remote
                    for i in range(1, len(USER_TOPICS))}
            for j in range(len(BROKER_DEFS)):
                if as_user or j != 0:
                    ends[f"peer-{j}"] = run.peer(j).remote
            if as_user:
                ends["user-0"] = run.user(0).remote
            deliveries = dict(zip(ends, await asyncio.gather(
                *(cut_twins._drain_all(p, conn) for conn in ends.values()))))
            shard0 = run.brokers[0]
            if as_user:
                alive = shard0.connections.has_user(b"user-0")
            else:
                alive = shard0.connections.has_broker(run.peer(0).identifier)
            balanced = await _pools_balanced(run.brokers)
        finally:
            await run.shutdown()
    finally:
        cut.ROUTE_IMPL = prev_impl
        p.memory.Memory.set_duplex_window(prev_win)
    delta = [a - b for a, b in zip(cut_twins._counters(p), before)]
    n = 4 * len(cut_twins._ACCOUNTED_CLASSES)
    return dict(deliveries=deliveries, alive=alive, balanced=balanced,
                classes=delta[:n],
                paths=dict(zip(cut_twins._PATHS, delta[n:])),
                handoffs=[a - b for a, b in zip(_handoffs(p), ring_before)])


def _same(runs: dict, label) -> None:
    """Every run agrees with JAX's one-shard run on every recorded fact,
    and the port's N-shard run handed the rings what JAX's did."""
    ref = runs["jax 1-shard"]
    for name, run in runs.items():
        assert run["balanced"], f"{label}: {name} pool permits leaked"
        assert run["alive"] == ref["alive"], f"{label}: {name} disconnects"
        assert run["deliveries"] == ref["deliveries"], \
            f"{label}: {name} delivery sequences differ"
        assert run["classes"] == ref["classes"], \
            f"{label}: {name} per-class counters differ"
    assert runs["port sharded"]["handoffs"] == \
        runs["jax sharded"]["handoffs"], label
    assert runs["port sharded"]["paths"] == runs["jax sharded"]["paths"], \
        label


async def _three_ways(impl: str, frames, as_user: bool,
                      incremental=None) -> dict:
    runs = {}
    for p in (PORT, JAX):
        runs[f"{p.name} sharded"] = await _run_sharded_mix(
            p, impl, frames, as_user=as_user)
    runs["jax 1-shard"] = await cut_twins._run_mix(
        JAX, impl, frames, as_user=as_user, chunked=True,
        incremental=incremental)
    cut_twins._check_paths(runs["port sharded"], impl)
    return runs


# ---------------------------------------------------------------------------
# the sharded cases of tests/test_route_cutthrough.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", range(4))
async def test_sharded_user_mix(seed, impl):
    """User-origin mixes through 2 worker shards: the sender's fan-out to
    the odd-shard receivers crosses the handoff rings."""
    _need(impl)
    rng = np.random.default_rng(5000 + seed)
    frames = cut_twins._gen_frames(rng, 50, as_user=True)
    runs = await _three_ways(impl, frames, as_user=True)
    _same(runs, seed)
    assert runs["port sharded"]["handoffs"][0] > 0, "no ring record"


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", range(2))
async def test_sharded_broker_mix(seed, impl):
    """Broker-origin (mesh) mixes arrive on worker 0 and reach the
    sibling's users over the rings, local-users-only semantics intact."""
    _need(impl)
    rng = np.random.default_rng(6000 + seed)
    frames = cut_twins._gen_frames(rng, 50, as_user=False)
    _same(await _three_ways(impl, frames, as_user=False), seed)


@pytest.mark.parametrize("impl", IMPLS)
async def test_sharded_scalar_seam(impl):
    """The scalar loops drive the same shard-egress seam
    (``EgressBatch.to_shard``) as the plan: the handoff is not a
    cut-through-only feature."""
    _need(impl)
    rng = np.random.default_rng(7000)
    frames = cut_twins._gen_frames(rng, 40, as_user=True)
    _same(await _three_ways(impl, frames, as_user=True), "scalar seam")


@pytest.mark.parametrize("impl", IMPLS)
async def test_sharded_subscribe_propagates_to_sibling(impl):
    """A Subscribe on worker 0 reaches the sibling's snapshot through the
    delta bus before later traffic routes: a sibling's user broadcasts and
    the subscriber receives it."""
    _need(impl)
    got = {}
    for p in (PORT, JAX):
        m = p.msg
        cut = p.cutthrough
        prev = (cut.ROUTE_IMPL,
                p.memory.Memory.set_duplex_window(512 * 1024))
        cut.ROUTE_IMPL = impl
        try:
            run = await p.shardharness.run_sharded([(0, []), (1, [])],
                                                   num_shards=2)
            try:
                await run.user(0).remote.send_raw(
                    m.serialize(m.Subscribe([1])), flush=True)
                await run.settle(30)
                await run.user(1).remote.send_raw(
                    m.serialize(m.Broadcast([1], b"cross-shard-pub")),
                    flush=True)
                await run.settle(40)
                got[p.name] = await cut_twins._drain_all(p, run.user(0).remote)
            finally:
                await run.shutdown()
        finally:
            cut.ROUTE_IMPL = prev[0]
            p.memory.Memory.set_duplex_window(prev[1])
    m = PORT.msg
    assert got["port"] == got["jax"] == \
        [m.serialize(m.Broadcast((1,), b"cross-shard-pub"))]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", range(2))
async def test_churn_mix_sharded(seed, impl):
    """Subscribe churn: sibling deltas keep every worker's snapshot
    converged — the same sequences as the one-shard rebuild baseline."""
    _need(impl)
    rng = np.random.default_rng(8500 + seed)
    frames = cut_twins._gen_churn_frames(rng, 50)
    _same(await _three_ways(impl, frames, as_user=True, incremental=False),
          seed)


def _route_direct_cases(p) -> list:
    """The sharded scalar ``route_direct``'s decisions: the DirectMap
    owner takes precedence as on one shard; a sibling's user or a link on
    another shard rides the ring."""
    EgressBatch, route_direct = p.handlers.EgressBatch, p.handlers.route_direct

    class _Raw:
        def clone(self):
            return self

        def release(self):
            pass

    class _Conns:
        num_shards = 2
        identity = "pub:me/priv:me"

        def __init__(self):
            self.users = {}
            self.remote_user_shard = {}
            self.brokers = {}
            self.remote_broker_shard = {}
            self.direct = {}
            self.parting = {}

        def get_broker_identifier_of_user(self, key):
            return self.direct.get(key)

    class _Broker:
        def __init__(self):
            self.connections = _Conns()

    other = "pub:other/priv:other"

    def decide(setup, to_user_only=False):
        broker = _Broker()
        setup(broker.connections)
        egress = EgressBatch(broker)
        route_direct(broker, b"u", _Raw(), to_user_only=to_user_only,
                     egress=egress)
        return (sorted(egress.users), sorted(egress.brokers),
                {s: sorted(t) for s, t in egress.shards.items()})

    def rehomed(c):
        c.users[b"u"] = object()
        c.brokers[other] = object()
        c.direct[b"u"] = other

    def local(c):
        c.users[b"u"] = object()
        c.direct[b"u"] = _Conns.identity

    def sibling(c):
        c.remote_user_shard[b"u"] = 1

    def link_elsewhere(c):
        c.direct[b"u"] = other
        c.remote_broker_shard[other] = 0

    def parting(c):
        c.direct[b"u"] = other
        c.parting[b"u"] = object()

    return [decide(rehomed), decide(rehomed, to_user_only=True),
            decide(local), decide(sibling), decide(link_elsewhere),
            decide(parting, to_user_only=True), decide(lambda c: None)]


def test_sharded_route_direct_directmap_precedence():
    port = _route_direct_cases(PORT)
    assert port == _route_direct_cases(JAX)
    other = "pub:other/priv:other"
    assert port == [
        ([], [other], {}),                      # re-homed: forward
        ([], [], {}),                           # one-hop rule
        ([b"u"], [], {}),                       # this box's own user
        ([], [], {1: [(0, b"u")]}),             # a sibling's user: ring
        ([], [], {0: [(1, other)]}),            # owner's link on worker 0
        ([b"u"], [], {}),                       # evicted mid-flight: chase
        ([], [], {}),                           # unknown: drop
    ]


# ---------------------------------------------------------------------------
# tests/test_route_state.py: the sharded interleavings
# ---------------------------------------------------------------------------

def _apply_random_sharded_op(p, rng, conns) -> None:
    roll = int(rng.integers(0, 100))
    user = cut_twins.USERS[int(rng.integers(0, len(cut_twins.USERS)))]
    topics = [int(t) for t in
              rng.choice(cut_twins.TOPICS, size=int(rng.integers(1, 3)))]
    if roll < 60:
        cut_twins._apply_random_op(p, rng, conns)
    elif roll < 80:
        conns.set_remote_user(user, 1, topics)
    elif roll < 90:
        conns.remove_remote_user(user, 1)
    elif roll < 95:
        conns.set_remote_broker(cut_twins.PEERS[0], 0, topics)
    else:
        conns.remove_remote_broker(cut_twins.PEERS[0])


@pytest.mark.parametrize("seed", range(4))
def test_route_state_sharded_interleavings(seed):
    """Two-shard interleavings: sibling users and links on the other
    worker enter and leave the snapshot; shard placement is part of the
    compared plan. Port incremental = port rebuilt = JAX incremental, and
    only the first build is a rebuild."""
    _need("native")
    twins = cut_twins._Twins(9500 + seed)
    for _p, broker, _state, _rng in twins.each():
        broker.connections.shard_id = 0
        broker.connections.num_shards = 2
    twins.refresh()
    for step in range(100):
        for p, broker, _state, rng in twins.each():
            _apply_random_sharded_op(p, rng, broker.connections)
        if step % 2 == 0:
            twins.refresh()
        if step % 10 == 9:
            twins.check()
    twins.check()
    inc = twins.state()
    assert inc.rebuild_counts == {"first_build": 1}, inc.rebuild_counts
    assert any(s == 1 for s in inc.user_shard), "no sibling user planned"


# ---------------------------------------------------------------------------
# tests/test_migration.py: the DirectMap race in the worker harness
# ---------------------------------------------------------------------------

def _seq(payload) -> int:
    return int.from_bytes(bytes(payload)[:4], "big")


async def _drain_messages(p, conn) -> list:
    return [p.msg.deserialize(raw)
            for raw in await cut_twins._drain_all(p, conn)]


def _claim(p, peer_ident: str, key: bytes) -> bytes:
    """A peer's out-versioning DirectMap claim (what the new home's
    ``add_user`` produces)."""
    claim = p.vmap.VersionedMap(local_identity=peer_ident)
    claim.insert(key, peer_ident)
    claim.insert(key, peer_ident)  # version 2 > local 1
    return p.vmap.VersionedMap.serialize_entries(claim.full())


async def _eviction_race(p, num_shards: int) -> dict:
    m = p.msg
    run = await p.shardharness.run_sharded(
        [(num_shards - 1, [0]), (0, [])], num_shards=num_shards,
        connected_brokers=[([0], [])])
    try:
        peer = run.peer(0)
        key = b"user-0"

        def directs(lo, hi):
            return [m.serialize(m.Direct(
                recipient=key, message=s.to_bytes(4, "big") + b"d"))
                for s in range(lo, hi)]

        sender = run.user(1).remote
        await sender.send_raw_many(directs(0, 10), flush=True)
        await run.settle(40)
        run.brokers[0].connections.apply_user_sync(
            _claim(p, peer.identifier, key))
        await run.settle(40)
        evicted = (not any(b.connections.has_user(key) for b in run.brokers)
                   and all(b.connections.direct_map.get(key)
                           == peer.identifier for b in run.brokers))
        await sender.send_raw_many(directs(10, 20), flush=True)
        await run.settle(40)
        local = [_seq(x.message)
                 for x in await _drain_messages(p, run.user(0).remote)
                 if isinstance(x, m.Direct)]
        chased = [_seq(x.message)
                  for x in await _drain_messages(p, peer.remote)
                  if isinstance(x, m.Direct)]
        return dict(evicted=evicted, local=local, chased=chased)
    finally:
        await run.shutdown()


async def _late_direct(p, num_shards: int) -> dict:
    m = p.msg
    run = await p.shardharness.run_sharded(
        [(0, [0])], num_shards=num_shards, connected_brokers=[([0], [])])
    try:
        peer = run.peer(0)
        key = b"user-0"
        run.brokers[0].connections.apply_user_sync(
            _claim(p, peer.identifier, key))
        await run.settle(40)
        conns = run.brokers[0].connections
        parting = (not conns.has_user(key)) and key in conns.parting
        late = [m.serialize(m.Direct(
            recipient=key, message=s.to_bytes(4, "big") + b"late"))
            for s in range(5)]
        await peer.remote.send_raw_many(late, flush=True)
        await run.settle(40)
        got = [_seq(x.message)
               for x in await _drain_messages(p, run.user(0).remote)
               if isinstance(x, m.Direct)]
        bounced = [x for x in await _drain_messages(p, peer.remote)
                   if isinstance(x, m.Direct)]
        return dict(parting=parting, got=got, bounced=len(bounced))
    finally:
        await run.shutdown()


async def _late_broadcast(p, num_shards: int) -> dict:
    m = p.msg
    topic = 1
    run = await p.shardharness.run_sharded(
        [(0, [topic])], num_shards=num_shards,
        connected_brokers=[([topic], [])])
    try:
        peer = run.peer(0)
        key = b"user-0"
        run.brokers[0].connections.apply_user_sync(
            _claim(p, peer.identifier, key))
        await run.settle(40)
        conns = run.brokers[0].connections
        window = (key in conns.parting
                  and bool(conns.user_topics.get_values_of_key(key)))
        late = [m.serialize(m.Broadcast(
            topics=[topic], message=s.to_bytes(4, "big") + b"late"))
            for s in range(5)]
        await peer.remote.send_raw_many(late, flush=True)
        await run.settle(40)
        got = [_seq(x.message)
               for x in await _drain_messages(p, run.user(0).remote)
               if isinstance(x, m.Broadcast)]
        await asyncio.sleep(0.5)
        expired = (key not in conns.parting
                   and not conns.user_topics.get_values_of_key(key))
        return dict(window=window, got=got, expired=expired)
    finally:
        await run.shutdown()


MIGRATION = {
    "eviction_race": (_eviction_race, dict(
        evicted=True, local=list(range(10)), chased=list(range(10, 20)))),
    "late_direct_chases_parting": (_late_direct, dict(
        parting=True, got=list(range(5)), bounced=0)),
    "late_broadcast_chases_parting": (_late_broadcast, dict(
        window=True, got=list(range(5)), expired=True)),
}


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", MIGRATION)
async def test_migration_race_sharded(case, impl, num_shards, monkeypatch):
    """A peer's out-versioning claim mid-stream: pre-claim directs land
    locally and post-claim ones chase the user to the claimant; late
    forwarded directs and broadcasts chase the evicted user over its
    ``parting`` connection, never re-forwarded, and the interest rows
    expire with the grace. Exactly one home per frame, on the port's N
    worker shards as on JAX's N and on JAX's one."""
    _need(impl)
    scenario, want = MIGRATION[case]
    out = {}
    for p, n in ((PORT, num_shards), (JAX, num_shards), (JAX, 1)):
        monkeypatch.setattr(p.connections, "PARTING_GRACE_S", 0.2)
        monkeypatch.setattr(p.cutthrough, "ROUTE_IMPL", impl)
        out[f"{p.name} {n}"] = await scenario(p, n)
    for name, got in out.items():
        assert got == want, f"{case} {name}: {got}"


# ---------------------------------------------------------------------------
# tests/test_ledger.py: conservation across the ring
# ---------------------------------------------------------------------------

def _assert_balanced(p, note: str) -> None:
    L = p.ledger.LEDGER
    derived = L.derived_in_queue()
    assert sum(derived) == L.walk_live_queues(), note
    assert all(d >= 0 for d in derived), f"{note}: negative {derived}"
    for _ in range(3):
        L.check_conservation()
    assert L.violations == 0, f"{note}: clean run flagged a violation"


async def _drain_writers(p) -> None:
    for _ in range(200):
        if p.ledger.LEDGER.walk_live_queues() == 0:
            return
        await asyncio.sleep(0.01)


@pytest.mark.parametrize("num_shards", (1, 2))
async def test_conservation_sharded_run_balances(num_shards):
    """A cross-shard broadcast rides the ring (``relayed/shard_ring``,
    outside the writer identity) and the in-process ledger balances
    exactly; the port's fates equal JAX's."""
    fates = {}
    for p in (PORT, JAX):
        m = p.msg
        p.ledger.reset_for_tests()
        try:
            run = await p.shardharness.run_sharded(
                [(0, [0]), (num_shards - 1, [0])], num_shards=num_shards)
            try:
                raw = m.serialize(m.Broadcast(topics=[0], message=b"x-shard"))
                await run.user(0).remote.send_raw_many([raw], flush=True)
                await run.settle(40)
                await _drain_writers(p)
                _assert_balanced(p, f"{p.name} {num_shards} shards")
                fates[p.name] = {k: list(v) for k, v in
                                 p.ledger.LEDGER.fates.items() if any(v)}
            finally:
                await run.shutdown()
        finally:
            p.ledger.reset_for_tests()
    assert fates["port"] == fates["jax"]
    f = {k: sum(v) for k, v in fates["port"].items()}
    assert f.get(("delivered", "egress"), 0) >= 1, f
    if num_shards == 2:
        assert f.get(("relayed", "shard_ring"), 0) >= 1, f


# ---------------------------------------------------------------------------
# tests/test_composition_invariants.py: a worker dies mid-stream
# ---------------------------------------------------------------------------

async def _worker_death(p) -> dict:
    m = p.msg
    run = await p.shardharness.run_sharded([(0, [0]), (1, [0]), (0, [])],
                                           num_shards=2)
    try:
        rng = np.random.default_rng(1311)

        def frame(seq: int) -> bytes:
            tail = bytes(rng.integers(0, 256, int(rng.integers(8, 64)),
                                      dtype=np.uint8))
            return m.serialize(m.Broadcast([0], seq.to_bytes(4, "big") + tail))

        sender = run.user(2).remote
        await sender.send_raw_many([frame(s) for s in range(20)], flush=True)
        await run.settle(40)
        # mid-stream worker death: worker 1 stops draining its rings and
        # its users are gone
        await run.brokers[1].stop()
        await sender.send_raw_many([frame(s) for s in range(20, 40)],
                                   flush=True)
        await run.settle(40)
        seqs = []
        for raw in await cut_twins._drain_all(p, run.user(0).remote):
            x = m.deserialize(raw)
            assert isinstance(x, m.Broadcast)
            seqs.append(_seq(x.message))
        stats = run.runtimes[0].stats()
        return dict(seqs=seqs,
                    publisher=run.brokers[0].connections.has_user(b"user-2"),
                    counted="relay_fallbacks" in stats
                    and "relay_shed" in stats)
    finally:
        await run.shutdown()


@pytest.mark.parametrize("impl", IMPLS)
async def test_shard_worker_death_no_survivor_reorder(impl, monkeypatch):
    """A sibling worker's death costs the surviving subscriber no frame
    and no reorder; the publisher rides it out."""
    _need(impl)
    out = {}
    for p in (PORT, JAX):
        monkeypatch.setattr(p.cutthrough, "ROUTE_IMPL", impl)
        prev = p.memory.Memory.set_duplex_window(512 * 1024)
        try:
            out[p.name] = await _worker_death(p)
        finally:
            p.memory.Memory.set_duplex_window(prev)
    assert out["port"] == out["jax"] == dict(
        seqs=list(range(40)), publisher=True, counted=True)


# ---------------------------------------------------------------------------
# the control bus's events, and the harness over real TCP
# ---------------------------------------------------------------------------

def test_durable_events_are_not_interest_deltas():
    """Durable-topic events between worker shards are kept out of the
    interest-delta counters: they go to the broker's durable topics
    (``apply_shard_event``, the owner shard's retention and replay) where
    it has them, and are dropped where it has none, on both packages; an
    interest delta is applied and counted on both."""
    out = {}
    events = [(kind, 0, b"payload")
              for kind in ("durable_pub", "durable_retain", "durable_sub")]
    for p in (PORT, JAX):
        got = []
        for durable in (None, SimpleNamespace(apply_shard_event=got.append)):
            conns = p.connections.Connections("pub:me/priv:me")
            broker = SimpleNamespace(connections=conns, durable=durable)
            rt = p.sharding.ShardRuntime(broker, 1, 2, {}, {}, None)
            for event in events:
                rt.apply_event(0, event)
            dropped = rt.deltas_applied
            rt.apply_event(0, ("user", b"u", [0]))
            out.setdefault(p.name, []).append(
                (dropped, rt.deltas_applied, dict(conns.remote_user_shard)))
        out[p.name].append(got)
    assert out["port"] == out["jax"] == [
        (0, 1, {b"u": 0}), (0, 1, {b"u": 0}), events]


async def test_sharded_tcp_users():
    """``run_sharded(tcp_users=True)``: the users' links are loopback TCP,
    one listener per worker; a broadcast reaches a sibling's subscriber
    over the ring and a direct crosses back."""
    got = {}
    for p in (PORT, JAX):
        m = p.msg
        run = await p.shardharness.run_sharded(
            [(0, [0]), (1, [0])], num_shards=2, tcp_users=True)
        try:
            await run.user(0).remote.send_raw(
                m.serialize(m.Broadcast([0], b"over tcp")), flush=True)
            await run.user(1).remote.send_raw(
                m.serialize(m.Direct(b"user-0", b"and back")), flush=True)
            await run.settle(40)
            got[p.name] = [await cut_twins._drain_all(p, run.user(i).remote)
                           for i in (0, 1)]
        finally:
            await run.shutdown()
    m = PORT.msg
    assert got["port"] == got["jax"] == [
        [m.serialize(m.Broadcast((0,), b"over tcp")),
         m.serialize(m.Direct(b"user-0", b"and back"))],
        [m.serialize(m.Broadcast((0,), b"over tcp"))]]


def test_acquire_routes_sharded_durable_brokers_scalar():
    """``acquire``'s rule, as JAX's: a worker shard whose durable topics
    retain routes scalar (the owner shard's ordered drainer pins the
    replay handover); one shard, or no retention, keeps the plan."""
    _need("native")
    out = {}
    for p in (PORT, JAX):
        got = []
        for retains, shards in ((True, 2), (True, 1), (False, 2)):
            broker = cut_twins._PlanBroker(p)
            broker.durable = SimpleNamespace(enabled=retains)
            broker.connections.num_shards = shards
            got.append(p.cutthrough.acquire(broker, p.def_.no_hook)
                       is not None)
        out[p.name] = got
    assert out["port"] == out["jax"] == [False, True, True]
