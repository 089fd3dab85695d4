"""The port's MultiHostBrokerGroup against the JAX package's.

- ``PartitionedUserSlots`` against JAX's over seeded sequences of
  assigns, frees and exhaustion (the twin of
  ``tests/test_multihost_group.py::test_partitioned_slots_owner_by_construction``);
- the single-process group's routing, user-slot directory lifecycle and
  partial retirement on a 4-shard CPU mesh, the same script through
  both packages' groups with fake brokers, records compared (the twin
  of ``test_single_process_group_routes_and_directory``), and the
  same-process cross-shard reconnect kick;
- two gloo processes (``python -m pushcdn_tpu_torch.testing.*``): the
  socket-free lockstep group against the one-process group on the same
  users and traffic; the deployment (the twin of
  ``tests/test_multihost.py::test_two_process_multihost_deployment``); a
  killed and a stalled peer (the twins of the kill and stall tests), the
  survivor failing closed within its watchdog, logging its stranded
  frames, serving on and exiting within a stated bound;
- on the card (and on the CPU with the group set not to fail open): a
  group whose warm-up fails raises out of every member's
  ``Broker.start()``, and one whose step fails after the warm-up takes
  every member broker down.
"""

import asyncio
import importlib
import os
import pickle
import signal
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pushcdn_tpu_torch.testing.two_host import spawn_worker_pair

PACKAGES = ("jax", "port")
PAIR_TIMEOUT_S = 45      # one two-process run, start to exit
WATCHDOG_S = 5.0         # the fault twins' collective watchdog
# the survivor's exit after its peer's fault: the watchdog, the bounded
# last barrier and the host-path checks, with slack for a loaded machine
SURVIVOR_EXIT_S = 5 * WATCHDOG_S + 15


def _pkg(name: str) -> SimpleNamespace:
    root = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}[name]

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    def mesh(n):
        if name == "port":
            return mod("parallel.mesh").make_broker_mesh(
                n, devices=["cpu"] * n)
        import jax
        return mod("parallel.mesh").make_broker_mesh(
            n, devices=jax.devices("cpu")[:n])

    return SimpleNamespace(
        name=name, mesh=mesh, mhg=mod("broker.multihost_group"),
        mg=mod("broker.mesh_group"), err=mod("proto.error"),
        msg=mod("proto.message"), limiter=mod("proto.limiter"),
        staging=mod("broker.staging"),
        embedded=mod("proto.discovery.embedded"))


# ---------------------------------------------------------------------------
# PartitionedUserSlots
# ---------------------------------------------------------------------------


def _slot_ops(seed: int):
    """A seeded sequence of assigns (some of them re-assigns), frees of
    assigned keys and assigns on non-local shards."""
    rng = np.random.default_rng(seed)
    ops, live = [], []
    for i in range(300):
        r = rng.random()
        if r < 0.55 or not live:
            shard = int(rng.integers(0, 4))
            key = (live[int(rng.integers(len(live)))]
                   if live and rng.random() < 0.1 else b"k%d" % i)
            ops.append(("assign", key, shard))
            live.append(key)
        else:
            key = live.pop(int(rng.integers(len(live))))
            ops.append(("free", key, None))
    return ops


def _run_slot_ops(p, ops):
    slots = p.mhg.PartitionedUserSlots(64, num_shards=4, local_shards=[1, 3])
    out = []
    for op, key, shard in ops:
        if op == "assign":
            try:
                out.append(slots.assign_in_shard(key, shard))
            except p.err.Error as e:
                out.append(("bail", str(e.kind)))
        else:
            slot = slots.unmap(key)
            if slot is not None:
                slots.free_slot(slot)
            out.append(("freed", slot))
    out.append({s: list(v) for s, v in slots.shard_free.items()})
    return out


@pytest.mark.parametrize("seed", range(4))
def test_partitioned_slots_match_jax(seed):
    ops = _slot_ops(seed)
    got = [_run_slot_ops(_pkg(name), ops) for name in PACKAGES]
    assert got[0] == got[1]
    K = 16
    for (op, key, shard), res in zip(ops, got[1]):
        if op == "assign" and isinstance(res, int):
            assert res // K in (1, 3)   # owner by construction
    # exhaustion of a range bails, typed
    assert any(isinstance(r, tuple) and r[0] == "bail" for r in got[1])


def test_partitioned_slots_owner_by_construction():
    p = _pkg("port")
    slots = p.mhg.PartitionedUserSlots(64, num_shards=4, local_shards=[1, 3])
    a = slots.assign_in_shard(b"alice", 1)
    b = slots.assign_in_shard(b"bob", 3)
    assert (a // slots.slots_per_shard, b // slots.slots_per_shard) == (1, 3)
    assert slots.assign_in_shard(b"alice", 1) == a
    slots.unmap(b"alice")
    slots.free_slot(a)
    assert slots.assign_in_shard(b"carol", 1) == a
    with pytest.raises(p.err.Error):
        slots.assign_in_shard(b"dave", 0)   # not local: no free list
    for i in range(slots.slots_per_shard - 1):
        slots.assign_in_shard(b"u%d" % i, 1)
    with pytest.raises(p.err.Error):
        slots.assign_in_shard(b"overflow", 1)


# ---------------------------------------------------------------------------
# the single-process group, both packages
# ---------------------------------------------------------------------------


class FakeUserConnection:
    """Records each delivered frame's wire bytes, from either package's
    egress (pre-encoded u32-BE length-prefixed streams, or raw frames)."""

    def __init__(self):
        self.frames = []

    def send_encoded_nowait(self, data, owner=None, cls=2, nframes=0):
        data = bytes(data)
        while data:
            n = int.from_bytes(data[:4], "big")
            self.frames.append(data[4:4 + n])
            data = data[4 + n:]

    def send_raw_many_nowait(self, raws):
        for raw in raws:
            self.frames.append(bytes(raw.data))
            raw.release()


class FakeConnections:
    """The Connections contract the group depends on: remove_user fires
    the observer's on_user_removed synchronously (that releases the old
    slot during a kick); egress looks sessions up by key."""

    def __init__(self):
        self.removed = []
        self.users = {}
        self.observer = None

    def has_user(self, pk):
        return bytes(pk) in self.users

    def get_user_connection(self, pk):
        return self.users.get(bytes(pk))

    def remove_user(self, pk, reason=""):
        self.removed.append((bytes(pk), reason))
        self.users.pop(bytes(pk), None)
        if self.observer is not None:
            self.observer.on_user_removed(bytes(pk))


class FakeBroker:
    def __init__(self, ident):
        self.identity = ident
        self.connections = FakeConnections()
        self.host_links_kick = asyncio.Event()

    def update_metrics(self):
        pass


async def _until(cond, what, timeout=10.0):
    for _ in range(int(timeout / 0.02)):
        if await cond():
            return
        await asyncio.sleep(0.02)
    raise AssertionError(what)


async def _group_script(p, db):
    """tests/test_multihost_group.py's script, with a record of what the
    group did at each point."""
    group = p.mhg.MultiHostBrokerGroup(
        p.mesh(4),
        p.mg.MeshGroupConfig(num_user_slots=32, ring_slots=8,
                             frame_bytes=512, extra_lanes=(),
                             direct_bucket_slots=4, batch_window_s=0.02),
        discovery=await p.embedded.Embedded.new(db),
        directory_refresh_s=0.1)
    rec = {"local_shards": list(group.local_shards),
           "K": group.slots_per_shard}
    brokers = [FakeBroker("mhg-b0"), FakeBroker("mhg-b2")]
    planes = [group.attach(brokers[0], 0), group.attach(brokers[1], 2)]
    for fb, plane in zip(brokers, planes):
        fb.connections.observer = plane
    Broadcast, serialize = p.msg.Broadcast, p.msg.serialize

    def stage(plane, payload):
        m = Broadcast(topics=[0], message=payload)
        return plane.try_stage(m, p.limiter.Bytes(serialize(m))).name

    try:
        await group.ensure_started()
        alice, bob = FakeUserConnection(), FakeUserConnection()
        brokers[0].connections.users[b"alice-pk"] = alice
        group.claim_user(0, b"alice-pk", [0])
        brokers[1].connections.users[b"bob-pk"] = bob
        group.claim_user(2, b"bob-pk", [0])
        rec["slots"] = [group.slots.slot_of(b"alice-pk"),
                        group.slots.slot_of(b"bob-pk")]

        async def both_published():
            d = await group.discovery.get_user_slots()
            return b"alice-pk" in d and b"bob-pk" in d
        await _until(both_published, "directory never converged")
        d = await group.discovery.get_user_slots()
        rec["directory"] = sorted((k, v[0]) for k, v in d.items())
        rec["route_bob"] = group._direct_route_info(b"bob-pk")

        rec["stage"] = stage(planes[0], b"lockstep!")

        async def delivered():
            return bool(alice.frames and bob.frames)
        await _until(delivered, "lockstep pump never delivered")
        rec["alice"], rec["bob"] = list(alice.frames), list(bob.frames)
        rec["routed"] = group.messages_routed
        assert group.steps >= 1

        # same-process cross-shard reconnect: the old session is kicked
        # and the claim moves into shard 2's range in one call
        brokers[1].connections.users[b"alice-pk"] = FakeUserConnection()
        group.claim_user(2, b"alice-pk", [0])
        rec["kicked"] = list(brokers[0].connections.removed)
        rec["alice_moved"] = group.slots.slot_of(b"alice-pk")

        # release drops the directory entry (this process owns it)
        group.release_user(2, b"bob-pk")

        async def bob_dropped():
            return b"bob-pk" not in await group.discovery.get_user_slots()
        await _until(bob_dropped, "release never dropped the claim")
        rec["disabled_before"] = group.disabled

        # partial retirement: one of the process's brokers stops, and
        # the collective keeps running for the others
        await group.on_shard_stopped(0)
        rec["partial"] = (group._task is not None, group._stop_requested,
                          group.disabled)
        bob2 = FakeUserConnection()
        brokers[1].connections.users[b"bob-pk"] = bob2
        group.claim_user(2, b"bob-pk", [0])
        rec["stage_after"] = stage(planes[1], b"after partial")

        async def bob2_got():
            return bool(bob2.frames)
        await _until(bob2_got, "no routing after a partial retirement")
        rec["bob2"] = list(bob2.frames)
    finally:
        await group.on_shard_stopped(0)
        await group.on_shard_stopped(2)
        await group.discovery.close()
    rec["stopped"] = (group._stop_requested, group.disabled)
    return rec


async def test_single_process_group_matches_jax(tmp_path):
    recs = {}
    for name in PACKAGES:
        recs[name] = await asyncio.wait_for(
            _group_script(_pkg(name), str(tmp_path / f"{name}.sqlite")), 50)
    jax_rec, port = recs["jax"], recs["port"]
    assert port == jax_rec
    K = port["K"]
    assert port["local_shards"] == [0, 1, 2, 3]
    assert [s // K for s in port["slots"]] == [0, 2]
    assert port["route_bob"] == (port["slots"][1], 2)
    assert port["stage"] == "STAGED"
    assert port["kicked"] == [(b"alice-pk", "user connected elsewhere")]
    assert port["alice_moved"] // K == 2
    assert port["partial"] == (True, False, False)
    assert port["stopped"] == (True, True)


async def test_same_process_cross_shard_reconnect_kicks(tmp_path):
    """A user reconnecting at another local shard gets a slot in the new
    shard's range and its old session is closed; a mapping whose session
    is already gone is released instead."""
    p = _pkg("port")
    group = p.mhg.MultiHostBrokerGroup(
        p.mesh(4), p.mg.MeshGroupConfig(num_user_slots=16, ring_slots=4,
                                        frame_bytes=256, extra_lanes=()))
    brokers = [FakeBroker(f"b{i}") for i in range(3)]
    for i, b in enumerate(brokers):
        b.connections.observer = group.attach(b, i)
    K = group.slots_per_shard
    brokers[0].connections.users[b"u"] = FakeUserConnection()
    group.claim_user(0, b"u", [1])
    first = group.slots.slot_of(b"u")
    brokers[1].connections.users[b"u"] = FakeUserConnection()
    group.claim_user(1, b"u", [1])
    assert brokers[0].connections.removed == [(b"u", "user connected "
                                                     "elsewhere")]
    moved = group.slots.slot_of(b"u")
    assert (first // K, moved // K) == (0, 1)
    assert group._owner[first] == -1 and group._owner[moved] == 1
    assert first in group._quarantine
    # the session at shard 1 vanished without a release: reconnecting at
    # shard 2 releases the stale claim and kicks no one
    del brokers[1].connections.users[b"u"]
    group.claim_user(2, b"u", [1])
    assert brokers[1].connections.removed == []
    assert group.slots.slot_of(b"u") // K == 2
    with pytest.raises(p.err.Error, match="not local"):
        p.mhg.MultiHostBrokerGroup(p.mesh(2)).attach(FakeBroker("x"), 5)


async def test_directory_entry_outlives_a_stall_inside_the_watchdog(
        tmp_path, monkeypatch):
    """A process whose event loop a burst holds for seconds republishes
    its claims late. Its entries outlast any stall the collective
    watchdog lets a live group have, so the other processes' mirrors keep
    its users and their directs stay on the mesh; past the watchdog they
    expire."""
    p = _pkg("port")
    db = str(tmp_path / "directory.sqlite")
    group = p.mhg.MultiHostBrokerGroup(
        p.mesh(4), p.mg.MeshGroupConfig(num_user_slots=16, ring_slots=4,
                                        frame_bytes=256, extra_lanes=()),
        discovery=await p.embedded.Embedded.new(db),
        directory_refresh_s=0.25, collective_timeout_s=20.0)
    broker = FakeBroker("b0")
    broker.connections.observer = group.attach(broker, 0)
    broker.connections.users[b"u"] = FakeUserConnection()
    group.claim_user(0, b"u", [1])
    peer = await p.embedded.Embedded.new(db)   # another process's store
    task = asyncio.create_task(group._directory_loop())
    try:
        async def published():
            return b"u" in await peer.get_user_slots()
        await _until(published, "the claim was never published")
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
    real = time.time
    try:
        # the reads run in this order: a read deletes what has expired
        for stall_s, kept in ((2.5, True), (20.0, True), (22.0, False)):
            monkeypatch.setattr(p.embedded, "time", SimpleNamespace(
                time=lambda s=stall_s: real() + s))
            assert (b"u" in await peer.get_user_slots()) is kept, stall_s
    finally:
        monkeypatch.undo()
        await peer.close()
        await group.discovery.close()


def test_lockstep_snapshot_keeps_full_shapes():
    """A lockstep group steps every tick at full shapes whatever it has
    staged (every process must enter the same collectives with the same
    shapes): its snapshot is never None, never latency-sliced, and holds
    the whole mirrors; the one-process MeshGroup skips an idle tick and
    slices a small one, unless it is built with ``full_shapes``."""
    p = _pkg("port")

    def cfg():
        return p.mg.MeshGroupConfig(
            num_user_slots=4096, ring_slots=16, frame_bytes=256,
            extra_lanes=((1024, 4, 2),), direct_bucket_slots=4,
            latency_slots=2)
    group = p.mhg.MultiHostBrokerGroup(p.mesh(4), cfg())
    plain = p.mg.MeshGroup(p.mesh(4), cfg())
    full = p.mg.MeshGroup(p.mesh(4), cfg(), full_shapes=True)
    assert group.lockstep and full.lockstep and not plain.lockstep
    assert plain._snapshot() is None
    assert full._snapshot() is not None
    for g in (group, plain):
        g.claim_user(0, b"u", [1])
        p.mg.MeshGroup.stage_batch(g, 0, [(5, b"x", [1])])
    idle = group._snapshot()
    assert idle is not None
    small = plain._snapshot()
    assert len(small.batches) == 1 and small.batches[0][0].valid.shape == (2,)
    assert len(small.owner) < 4096
    snap = group._snapshot()
    for s_ in (idle, snap):
        assert [lane[0].valid.shape for lane in s_.batches] == [(16,), (4,)]
        assert [lane[0].valid.shape for lane in s_.directs] == [(4, 4),
                                                                (4, 2)]
        assert len(s_.owner) == len(s_.masks) == 4096


# ---------------------------------------------------------------------------
# two processes
# ---------------------------------------------------------------------------


def _wait_pair(procs, logs, timeout=PAIR_TIMEOUT_S):
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [open(path).read() for path in logs]


def test_two_process_lockstep_group_matches_one_process(tmp_path):
    """Two processes step a socket-free MultiHostBrokerGroup of 8 CPU
    shards (4 each) in lockstep over 3 ticks of broadcasts and directs
    to users on any shard; their deliveries together equal the
    one-process MeshGroup's on the same users and traffic, user for user
    and frame for frame, with one collective a fused tick."""
    from pushcdn_tpu_torch.broker.mesh_group import MeshGroup, MeshGroupConfig
    from pushcdn_tpu_torch.parallel.mesh import make_broker_mesh

    B, U, T = 8, 64, 16
    rng = np.random.default_rng(5)
    cfg = dict(num_user_slots=U, ring_slots=8, frame_bytes=256,
               extra_lanes=((1024, 2, 2),), direct_bucket_slots=2,
               topic_words=1)
    users = [(b"user-%03d" % i, i % B,
              sorted({int(t) for t in rng.integers(0, T, 2)}))
             for i in range(48)]
    keys = [u[0] for u in users]
    ticks = []
    for _ in range(3):
        per = [[] for _ in range(B)]
        for s in range(B):
            for _ in range(int(rng.integers(1, 7))):
                size = int(rng.integers(300, 1000)) if rng.random() < 0.1 \
                    else int(rng.integers(8, 200))
                payload = rng.bytes(size)
                if rng.random() < 0.25:
                    per[s].append((4, payload,
                                   keys[int(rng.integers(len(keys)))]))
                else:
                    per[s].append((5, payload, [int(rng.integers(0, T))]))
        ticks.append(per)
    script = tmp_path / "script.pkl"
    with open(script, "wb") as f:
        pickle.dump({"shards": B, "config": cfg, "users": users,
                     "ticks": ticks}, f)
    procs = spawn_worker_pair(
        "pushcdn_tpu_torch.testing.lockstep_worker",
        f"file://{tmp_path}/rendezvous",
        ["group", str(tmp_path), str(script), "--device", "cpu"],
        log_dir=str(tmp_path))
    logs = _wait_pair(procs, [tmp_path / f"rank{r}.log" for r in (0, 1)])
    for rank, log in enumerate(logs):
        assert f"rank {rank}: LOCKSTEP OK" in log, log[-3000:]
    runs = [pickle.load(open(tmp_path / f"rank{r}-0.pkl", "rb"))
            for r in (0, 1)]

    ref = MeshGroup(make_broker_mesh(B, devices=["cpu"] * B),
                    MeshGroupConfig(**cfg))
    for key, shard, topics in users:
        ref.claim_user(shard, key, topics)
    for t, per in enumerate(ticks):
        for s in range(B):
            ref.stage_batch(s, per[s])
        want = {}
        for d in ref.step():
            k = [ref.slots.key_of(int(u)) for u in d.users]
            want[(d.shard, d.lane, d.direct)] = (k, d.frames.tolist(),
                                                 d.length.tolist())
        got = {}
        for run in runs:
            for shard, lane, direct, k, frames, length, _crc in \
                    run["ticks"][t]:
                got[(shard, lane, direct)] = (k, frames.tolist(),
                                              length.tolist())
        assert got == want, f"tick {t}"
    for run in runs:
        assert [r[4] for r in run["rows"]] == [1, 1, 1]   # fused ticks
        assert run["transport"] == "gloo, CPU tensors"


def test_two_process_deployment(tmp_path):
    """Two processes, each a marshal, a TCP broker on a local shard of
    the global 8-shard mesh and an authenticated TCP client: a broadcast
    crosses from rank 0 to rank 1, a direct crosses back through the
    user-slot directory, both brokers hold zero host links, and rank 0's
    retirement disables rank 1's group on the same tick."""
    procs = spawn_worker_pair(
        "pushcdn_tpu_torch.testing.two_host_worker",
        f"file://{tmp_path}/rendezvous",
        ["deploy", str(tmp_path / "d.sqlite"), str(tmp_path),
         "--device", "cpu"],
        log_dir=str(tmp_path))
    logs = _wait_pair(procs, [tmp_path / f"rank{r}.log" for r in (0, 1)])
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"rank {rank}: MULTIHOST OK" in log, \
            log[-3000:]


@pytest.mark.parametrize("fault", ["kill", "stall"])
def test_two_process_fault_fails_closed(tmp_path, fault):
    """One process of a live pair is SIGKILLed, or wedges its collective
    for good while staying alive. The survivor's group fails closed
    (disabled, pump ended) within its watchdog, logs the frames it
    strands, keeps serving its own client on the host path and exits 0
    within ``SURVIVOR_EXIT_S`` of the fault."""
    procs = spawn_worker_pair(
        "pushcdn_tpu_torch.testing.two_host_worker",
        f"file://{tmp_path}/rendezvous",
        [fault, str(tmp_path / "d.sqlite"), str(tmp_path),
         "--watchdog", str(WATCHDOG_S), "--device", "cpu"],
        log_dir=str(tmp_path))
    logs = [tmp_path / f"rank{r}.log" for r in (0, 1)]
    try:
        deadline = time.monotonic() + PAIR_TIMEOUT_S
        while not all(os.path.exists(tmp_path / f"ready-{r}")
                      for r in (0, 1)):
            assert time.monotonic() < deadline, "workers never got ready"
            for p, log in zip(procs, logs):
                assert p.poll() is None, \
                    f"worker died early:\n{open(log).read()[-3000:]}"
            time.sleep(0.05)
        t0 = time.monotonic()
        if fault == "kill":
            procs[1].send_signal(signal.SIGKILL)
        try:
            procs[0].wait(timeout=SURVIVOR_EXIT_S)
        except Exception:
            raise AssertionError(
                f"survivor still running {SURVIVOR_EXIT_S} s after the "
                f"fault:\n{open(logs[0]).read()[-3000:]}")
        exit_s = time.monotonic() - t0
        if fault == "stall":
            # the stalled process stayed alive: a wedge, not a death
            assert procs[1].poll() is None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out0 = open(logs[0]).read()
    assert procs[0].returncode == 0, out0[-3000:]
    assert f"rank 0: {fault.upper()} OK" in out0, out0[-3000:]
    assert "multi-host group halted" in out0
    assert exit_s < SURVIVOR_EXIT_S


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def _boom(*args, **kwargs):
    raise RuntimeError("injected step failure")


async def _members(devices, db: str, **config):
    """A MultiHostBrokerGroup over a one-process mesh of ``devices`` and
    a Broker attached to each shard, not started."""
    from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.def_ import testing_run_def

    p = _pkg("port")
    mesh = importlib.import_module("pushcdn_tpu_torch.parallel.mesh")
    group = p.mhg.MultiHostBrokerGroup(
        mesh.make_broker_mesh(len(devices), devices=devices),
        p.mg.MeshGroupConfig(num_user_slots=16, ring_slots=8,
                             frame_bytes=512, extra_lanes=(), **config))
    brokers = []
    for i in range(len(devices)):
        name = f"mh-{os.getpid()}-{id(group)}-{i}"
        b = await Broker.new(BrokerConfig(
            run_def=testing_run_def(),
            keypair=DEFAULT_SCHEME.generate_keypair(seed=7),
            discovery_endpoint=db,
            public_advertise_endpoint=f"{name}-pub",
            public_bind_endpoint=f"{name}-pub",
            private_advertise_endpoint=f"{name}-priv",
            private_bind_endpoint=f"{name}-priv",
            heartbeat_interval_s=3600, sync_interval_s=3600,
            whitelist_interval_s=3600, form_mesh=False))
        group.attach(b, i)
        brokers.append(b)
    return group, brokers


async def _warmup_fails_in_every_member(devices, db: str):
    """Two brokers on a group over ``devices`` whose warm-up step fails:
    each one's ``start()`` must raise and leave no task running."""
    group, brokers = await _members(devices, db)
    assert not group.fails_open
    group.step_fn = _boom
    try:
        for b in brokers:
            with pytest.raises(RuntimeError, match="injected"):
                await b.start()
            assert not b._tasks
        assert group.pump_task is None and not group.disabled
    finally:
        for b in brokers:
            await b.stop()


async def _pump_end_in_every_member(devices, db: str, end: str):
    """Two started brokers on a group over ``devices`` that does not fail
    open. ``end="step failure"``: a step fails after a good warm-up, the
    group disables itself and every member's ``wait_until_failure``
    raises with the step's exception. ``end="peer retired"``: the stop
    barrier reports a retired peer, the pump ends cleanly and the members
    keep serving."""
    from pushcdn_tpu_torch.proto.error import Error

    group, brokers = await _members(devices, db, batch_window_s=0.01)
    assert not group.fails_open
    try:
        for b in brokers:
            await b.start()
        steps = group.steps
        async with asyncio.timeout(10):
            while group.steps < steps + 2:   # the lockstep pump ticks
                await asyncio.sleep(0.01)
        if end == "step failure":
            group.step_fn = _boom
        else:
            group._collective_stop = lambda want_stop: True
        async with asyncio.timeout(10):
            while not group.pump_task.done():
                await asyncio.sleep(0.01)
        assert group.disabled
        if end == "step failure":
            for b in brokers:
                with pytest.raises(Error, match="injected step failure"):
                    async with asyncio.timeout(10):
                        await b.wait_until_failure()
        else:
            waits = [asyncio.ensure_future(b.wait_until_failure())
                     for b in brokers]
            done, _ = await asyncio.wait(waits, timeout=0.5)
            assert not done   # no member went down
            for w in waits:
                w.cancel()
            await asyncio.gather(*waits, return_exceptions=True)
    finally:
        for b in brokers:
            await b.stop()


def test_group_warmup_failure_raises_in_every_member_when_failing_closed(
        tmp_path, monkeypatch):
    """The warm-up rule the card follows, on the CPU: with the group set
    not to fail open, a warm-up that fails raises out of every member's
    start."""
    p = _pkg("port")
    monkeypatch.setattr(p.mhg.MultiHostBrokerGroup, "fails_open", False)
    asyncio.run(_warmup_fails_in_every_member(
        ["cpu"] * 2, str(tmp_path / "d.sqlite")))


@pytest.mark.parametrize("end", ["step failure", "peer retired"])
def test_group_pump_end_in_every_member_when_failing_closed(
        tmp_path, monkeypatch, end):
    """The pump rule the card follows, on the CPU: with the group set not
    to fail open, a step that fails after the warm-up takes every member
    broker down with its exception, and a peer's clean retirement takes
    none down."""
    p = _pkg("port")
    monkeypatch.setattr(p.mhg.MultiHostBrokerGroup, "fails_open", False)
    asyncio.run(_pump_end_in_every_member(
        ["cpu"] * 2, str(tmp_path / "d.sqlite"), end))


def test_group_config_is_copied_not_mutated():
    """The group forces ``gather_frame_bytes`` on its own copy of the
    caller's config, and steps at full shapes in any world size."""
    p = _pkg("port")
    cfg = p.mg.MeshGroupConfig(num_user_slots=16, ring_slots=8,
                               frame_bytes=512, extra_lanes=())
    group = p.mhg.MultiHostBrokerGroup(p.mesh(2), cfg)
    assert not cfg.gather_frame_bytes and group.config.gather_frame_bytes
    assert group.lockstep and group.config.ring_slots == 8


@pytest.mark.cuda
def test_group_warmup_failure_raises_in_every_member_on_the_card(tmp_path):
    """A group on the card whose warm-up step fails (a kernel that does
    not build or launch) raises out of every member's start."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    asyncio.run(_warmup_fails_in_every_member(
        ["cuda:0"] * 2, str(tmp_path / "d.sqlite")))


@pytest.mark.cuda
def test_group_step_failure_ends_every_member_on_the_card(tmp_path):
    """A group on the card whose step fails after the warm-up (a kernel
    launch error, a device fault) takes every member broker down with the
    step's exception; it does not go on serving on the host path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    asyncio.run(_pump_end_in_every_member(
        ["cuda:0"] * 2, str(tmp_path / "d.sqlite"), "step failure"))
