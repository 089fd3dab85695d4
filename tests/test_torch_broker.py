"""The port's broker with its device plane, held against the JAX
package's broker on the CPU.

Both packages build a real ``Broker`` over the Memory transport with the
same device-plane configuration (the port's on ``device="cpu"``), inject
the same seeded users through their own ``TestRun.inject_users`` and
take the same seeded traffic: broadcasts on one or two topics, some
beyond the plane's topic space, directs to connected and unknown users,
frames for the wide lane and frames too wide for any lane. Every user
must receive the same frames from both brokers, byte for byte: the same
multiset, and per publisher the same order within each path a frame can
take (a lane of the plane, or the host path), which is also the order the
publisher sent them in. Then the scenarios of
``tests/test_device_plane.py``, run on the port's broker through the
harness.
"""

import asyncio
import importlib
import itertools
import os
import tempfile
import threading
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from _torch_libs import jax_routeplan_available

USERS = 40
PUBLISHERS = 8
ROUNDS = 3
PER_ROUND = 10              # frames per publisher per round
TOPICS = 48                 # the brokers' topic space
PLANE_TOPICS = 32           # topic_words=1: topics 32.. take the host path
BASE_BYTES, WIDE_BYTES = 1024, 4096
_UID = itertools.count()


def _pkg(name: str) -> SimpleNamespace:
    root = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}[name]

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    return SimpleNamespace(
        name=name, broker=mod("broker.broker"),
        plane=mod("broker.device_plane"), harness=mod("broker.test_harness"),
        handlers=mod("broker.tasks.handlers"),
        cutthrough=mod("broker.tasks.cutthrough"), def_=mod("proto.def_"),
        topic=mod("proto.topic"), sig=mod("proto.crypto.signature"),
        memory=mod("proto.transport.memory"), util=mod("proto.util"),
        msg=mod("proto.message"))


def _plane_config(p, impl: str, **over):
    kw = dict(num_user_slots=64, ring_slots=64, frame_bytes=BASE_BYTES,
              extra_lanes=((WIDE_BYTES, 16),), topic_words=1,
              batch_window_s=0.002, bypass_max_items=0, delivery_impl=impl)
    kw.update(over)
    return p.plane.DevicePlaneConfig(**kw)


async def _start(p, plane_cfg):
    """A started broker of package ``p`` wrapped in its own TestRun."""
    broker = await _new(p, plane_cfg)
    await broker.start()
    return p.harness.TestRun(broker=broker)


async def _new(p, plane_cfg):
    """A broker of package ``p``, built and not started."""
    uid = next(_UID)
    db = os.path.join(tempfile.mkdtemp(prefix="pushcdn-torch-test-"),
                      "discovery.sqlite")
    extra = {"device": "cpu"} if p.name == "port" else {}
    config = p.broker.BrokerConfig(
        run_def=p.def_.testing_run_def(
            topics=p.topic.TopicSpace.range(TOPICS)),
        keypair=p.sig.DEFAULT_SCHEME.generate_keypair(seed=uid),
        discovery_endpoint=db,
        public_advertise_endpoint=f"torch-test-pub-{p.name}-{uid}",
        public_bind_endpoint=f"torch-test-pub-{p.name}-{uid}",
        private_advertise_endpoint=f"torch-test-priv-{p.name}-{uid}",
        private_bind_endpoint=f"torch-test-priv-{p.name}-{uid}",
        heartbeat_interval_s=3600, sync_interval_s=3600,
        whitelist_interval_s=3600, device_plane=plane_cfg, **extra)
    return await p.broker.Broker.new(config)


async def _connect(p, run, key: bytes, topics):
    """Inject one more user under ``key``, the way ``inject_users`` does."""
    local, remote = await p.memory.gen_testing_connection_pair(
        run.broker.limiter)
    task = asyncio.create_task(
        p.handlers.user_receive_loop(run.broker, key, local))
    run.broker.connections.add_user(key, local, list(topics),
                                    p.util.AbortOnDropHandle(task))
    user = p.harness.TestUser(key, remote)
    run.connected_users.append(user)
    return user


class _Inbox:
    """Drains every given user's remote end into a list of frame bytes."""

    def __init__(self, users):
        self.frames = {u.public_key: [] for u in users}
        self._tasks = [asyncio.create_task(self._drain(u)) for u in users]

    async def _drain(self, user):
        box = self.frames[user.public_key]
        try:
            while True:
                for raw in await user.remote.recv_raw_many():
                    box.append(bytes(raw.data))
                    raw.release()
        except Exception:
            return  # the connection closed

    async def wait_for(self, counts, timeout: float = 30.0):
        """Until every user holds at least its count, then a short quiet
        window in which a duplicate or a stray frame would land."""
        async with asyncio.timeout(timeout):
            while any(len(self.frames[k]) < n for k, n in counts.items()):
                await asyncio.sleep(0.005)
        await asyncio.sleep(0.1)

    def close(self):
        for t in self._tasks:
            t.cancel()


# ---------------------------------------------------------------------------
# the seeded scenario and its oracle
# ---------------------------------------------------------------------------


def _scenario(seed: int):
    """Users' topics and the publishers' rounds of (frame, meta) pairs,
    where meta is (publisher, seq, kind, target)."""
    from pushcdn_tpu_torch.proto.message import Broadcast, Direct, serialize
    rng = np.random.default_rng(seed)
    topics = [sorted({int(t) for t in rng.integers(0, TOPICS - 8, k)})
              for k in rng.integers(0, 4, USERS)]
    rounds = []
    seq = itertools.count()
    for _ in range(ROUNDS):
        batches = []
        for pub in range(PUBLISHERS):
            batch = []
            for _ in range(PER_ROUND):
                s = next(seq)
                r = rng.random()
                size = (int(rng.integers(8, 700)) if r < 0.8 else
                        int(rng.integers(1200, 3500)) if r < 0.95 else
                        int(rng.integers(4500, 6000)))
                body = b"%d:%d:" % (pub, s) + rng.integers(
                    0, 256, size, dtype=np.uint8).tobytes()
                if rng.random() < 0.2:
                    target = b"user-%d" % int(rng.integers(0, USERS + 4))
                    batch.append((serialize(Direct(target, body)),
                                  (pub, s, "direct", target)))
                else:
                    k = 1 if rng.random() < 0.8 else 2
                    target = tuple(int(t) for t in rng.integers(0, TOPICS, k))
                    batch.append((serialize(Broadcast(target, body)),
                                  (pub, s, "broadcast", target)))
            batches.append(batch)
        rounds.append(batches)
    return topics, rounds


def _oracle(topics, frames_meta, plane: bool):
    """Each user's expected frames, in publisher order, and each frame's
    path: the lane it fits, or "host" when the plane cannot take it."""
    keys = [b"user-%d" % i for i in range(USERS)]
    want = {k: [] for k in keys}
    path = {}
    for frame, (pub, _s, kind, target) in frames_meta:
        if kind == "direct":
            receivers = [target] if target in want else []
            eligible = target in want
        else:
            ts = set(target)
            receivers = [k for k, t in zip(keys, topics) if ts & set(t)]
            eligible = all(t < PLANE_TOPICS for t in target)
        if not plane:
            path[frame] = "host"
        elif not eligible or len(frame) > WIDE_BYTES:
            path[frame] = "host"
        else:
            path[frame] = "base" if len(frame) <= BASE_BYTES else "wide"
        for k in receivers:
            want[k].append(frame)
    return want, path


def _streams(frames, meta, path):
    """A user's frames split per (publisher, path), in arrival order."""
    out = {}
    for f in frames:
        out.setdefault((meta[f][0], path[f]), []).append(f)
    return out


async def _serve(p, impl: str, topics, rounds):
    """Run the scenario through package ``p``'s broker; returns each
    user's received frames and the plane (None on the host path)."""
    plane_cfg = None if impl == "host" else _plane_config(p, impl)
    run = await _start(p, plane_cfg)
    try:
        await run.inject_users(topics)
        inbox = _Inbox(run.connected_users)
        for batches in rounds:
            # each round is delivered before the next is sent, so no lane
            # ever fills and staging order is send order
            want, _ = _oracle(topics, [fm for b in batches for fm in b],
                              plane=False)
            done = {k: len(inbox.frames[k]) + len(v) for k, v in want.items()}
            for pub, batch in enumerate(batches):
                await run.user(pub).remote.send_raw_many(
                    [f for f, _ in batch], flush=True)
            await inbox.wait_for(done)
        inbox.close()
        return inbox.frames, run.broker.device_plane
    finally:
        await run.shutdown()


def _cutthrough_frames(name: str) -> float:
    root = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}[name]
    metrics = importlib.import_module(f"{root}.proto.metrics")
    return metrics.ROUTE_CUTTHROUGH_FRAMES.value


@pytest.mark.parametrize("impl,route", [
    pytest.param("dense", "python", id="dense"),
    pytest.param("ragged", "python", id="ragged"),
    pytest.param("host", "python", id="host"),
    pytest.param("host", "auto", id="host-auto")])
async def test_broker_delivers_what_the_jax_broker_delivers(impl, route,
                                                            monkeypatch):
    # a broker with a plane takes the scalar twin on both packages; the
    # host path runs the scalar twin (python) and the reference's default
    # (auto: the cut-through plane) on both
    assert route == "python" or jax_routeplan_available()
    for name in ("port", "jax"):
        monkeypatch.setattr(_pkg(name).cutthrough, "ROUTE_IMPL", route)
    topics, rounds = _scenario(seed={"dense": 1, "ragged": 2, "host": 3}[impl])
    frames_meta = [fm for batches in rounds for b in batches for fm in b]
    meta = dict(frames_meta)
    want, path = _oracle(topics, frames_meta, plane=impl != "host")
    assert {"base", "wide", "host"} <= set(path.values()) or impl == "host"
    got = {}
    planes = {}
    cut = {}
    for name in ("port", "jax"):
        before = _cutthrough_frames(name)
        got[name], planes[name] = await _serve(_pkg(name), impl, topics,
                                               rounds)
        cut[name] = _cutthrough_frames(name) - before
    if route == "auto":
        # both brokers planned their publishers' chunks through the plane
        assert cut["port"] > 0 and cut["jax"] > 0, cut
    else:
        assert cut == {"port": 0, "jax": 0}, cut
    for key, frames in want.items():
        for name in ("port", "jax"):
            assert Counter(got[name][key]) == Counter(frames), (name, key)
            assert _streams(got[name][key], meta, path) == \
                _streams(frames, meta, path), (name, key)
        assert Counter(got["port"][key]) == Counter(got["jax"][key])
        assert _streams(got["port"][key], meta, path) == \
            _streams(got["jax"][key], meta, path)
    if impl == "host":
        assert planes["port"] is None
        return
    device_deliveries = sum(path[f] != "host" for fs in want.values()
                            for f in fs)
    assert device_deliveries > 0
    for name, plane in planes.items():
        assert not plane.disabled, name
        assert plane.steps > 0, name
        assert plane.messages_routed == device_deliveries, name
        assert plane.delivery_impl == impl, name
    if impl == "ragged":
        assert planes["port"].ragged_steps > 0
        assert planes["port"].ragged_fallbacks == 0


# ---------------------------------------------------------------------------
# the scenarios of tests/test_device_plane.py, through the harness
# ---------------------------------------------------------------------------


def _broadcast(body: bytes, topics=(0,)) -> bytes:
    from pushcdn_tpu_torch.proto.message import Broadcast, serialize
    return serialize(Broadcast(list(topics), body))


def _direct(key: bytes, body: bytes) -> bytes:
    from pushcdn_tpu_torch.proto.message import Direct, serialize
    return serialize(Direct(key, body))


async def test_churn_during_device_traffic():
    """Users joining and leaving while steps run never lose frames for
    the connected ones, and released slots come back after their step:
    twelve churners pass through an 8-slot table without leaving a user
    unmirrored."""
    p = _pkg("port")
    run = await _start(p, _plane_config(p, "dense", num_user_slots=8))
    try:
        stable = await _connect(p, run, b"stable", [0])
        inbox = _Inbox([stable])
        plane = run.broker.device_plane
        for i in range(12):
            churner = await _connect(p, run, b"churner-%d" % i, [0])
            await churner.remote.send_raw_many(
                [_broadcast(b"round-%d" % i)], flush=True)
            await inbox.wait_for({b"stable": i + 1})
            churner.remote.close()
            async with asyncio.timeout(10):
                while run.broker.connections.has_user(churner.public_key):
                    await asyncio.sleep(0.005)
        inbox.close()
        assert inbox.frames[b"stable"] == [_broadcast(b"round-%d" % i)
                                           for i in range(12)]
        assert not plane._unmirrored
        assert plane.slots.high_water <= 8
        assert plane.steps >= 12 and not plane.disabled
        # every round reached the stable user and its churner on the device
        assert plane.messages_routed == 24
    finally:
        await run.shutdown()


async def test_slot_table_exhaustion_falls_back_to_host():
    """More users than slots: they all register, and broadcasts take the
    host path while any user is unmirrored (no silent miss)."""
    p = _pkg("port")
    run = await _start(p, _plane_config(p, "dense", num_user_slots=2))
    try:
        await run.inject_users([[0]] * 4)
        plane = run.broker.device_plane
        assert len(plane._unmirrored) == 2
        await run.send_message_as(
            run.user(0), p.msg.Broadcast([0], b"everyone"))
        for u in run.connected_users:
            await run.assert_received(u, p.msg.Broadcast([0], b"everyone"),
                                      timeout=5)
        assert plane.messages_routed == 0
    finally:
        await run.shutdown()


async def test_idle_bypass_routes_on_host_path():
    """A lone frame at an idle plane is host-routed at once; a burst
    larger than the bypass budget rides the device."""
    p = _pkg("port")
    run = await _start(p, _plane_config(p, "dense", bypass_max_items=2))
    try:
        await run.inject_users([[0]])
        u = run.user(0)
        plane = run.broker.device_plane
        for i in range(3):
            msg = p.msg.Direct(u.public_key, b"solo %d" % i)
            await run.send_message_as(u, msg)
            await run.assert_received(u, msg, timeout=5)
        assert plane.steps == 0 and plane.messages_routed == 0
        inbox = _Inbox([u])
        burst = [_direct(u.public_key, b"burst %d" % i) for i in range(16)]
        await u.remote.send_raw_many(burst, flush=True)
        await inbox.wait_for({u.public_key: 16})
        inbox.close()
        assert inbox.frames[u.public_key] == burst
        assert plane.messages_routed == 16 and plane.steps > 0
    finally:
        await run.shutdown()


async def test_device_plane_fail_open_to_host_path(monkeypatch):
    """A step that raises loses no acknowledged frame: the failed batch
    and the frames staged while it ran go out on the host path, the plane
    disables itself and the broker serves on as a host broker."""
    p = _pkg("port")
    run = await _start(p, _plane_config(p, "dense"))
    try:
        await run.inject_users([[0], [0]])
        a, b = run.user(0), run.user(1)
        plane = run.broker.device_plane
        pre = p.msg.Broadcast([0], b"pre-failure")
        await run.send_message_as(a, pre)
        for u in (a, b):
            await run.assert_received(u, pre, timeout=5)
        assert plane.messages_routed == 2

        started, release = threading.Event(), threading.Event()

        def boom(*args, **kwargs):
            started.set()
            release.wait(10)
            raise RuntimeError("injected device failure")

        monkeypatch.setattr(plane, "_run_step", boom)
        inbox = _Inbox([a, b])
        first, late = _broadcast(b"in the failed step"), \
            _broadcast(b"staged while it ran")
        await a.remote.send_raw_many([first], flush=True)
        async with asyncio.timeout(5):
            while not started.is_set():
                await asyncio.sleep(0.002)
        await a.remote.send_raw_many([late], flush=True)
        async with asyncio.timeout(5):   # the late frame is staged
            while plane.rings[0].free_slots == plane.rings[0].slots:
                await asyncio.sleep(0.002)
        release.set()
        await inbox.wait_for({a.public_key: 2, b.public_key: 2})
        assert plane.disabled
        after = _direct(a.public_key, b"host path onward")
        await b.remote.send_raw_many([after], flush=True)
        await inbox.wait_for({a.public_key: 3})
        inbox.close()
        assert inbox.frames[a.public_key] == [first, late, after]
        assert inbox.frames[b.public_key] == [first, late]
        assert plane.messages_routed == 2
    finally:
        await run.shutdown()


def _fail_steps(plane, monkeypatch, on_card: bool, warmup: bool):
    """Make the plane's device step raise (its warm-up too when
    ``warmup``), and make a CPU plane read as one on the card when
    ``on_card``."""

    def step(*args, **kwargs):
        if kwargs.get("warmup") and not warmup:
            return [], 0.0
        raise RuntimeError("injected kernel failure")

    if on_card:
        monkeypatch.setattr(plane, "device", torch.device("cuda"))
    monkeypatch.setattr(plane, "_run_step", step)


@pytest.mark.parametrize("on_card", [True, False])
async def test_warmup_failure_raises_on_the_card_only(on_card, monkeypatch):
    """A kernel that does not build or launch on the card stops the
    broker's start; on the CPU the plane disables itself and the broker
    starts as a host broker, as the JAX package's does."""
    p = _pkg("port")
    broker = await _new(p, _plane_config(p, "dense"))
    plane = broker.device_plane
    _fail_steps(plane, monkeypatch, on_card, warmup=True)
    try:
        if on_card:
            with pytest.raises(RuntimeError, match="injected"):
                await broker.start()
            assert plane.pump_task is None and not broker._tasks
        else:
            await broker.start()
            assert plane.disabled and plane.pump_task is not None
            assert plane.pump_task not in broker._tasks
    finally:
        await broker.stop()


async def test_step_failure_on_the_card_reroutes_then_ends_the_broker(
        monkeypatch):
    """On the card a step that raises still sends its frames out on the
    host path, then ends the pump with the exception; the pump is one of
    the broker's supervised tasks, so ``run_until_failure`` goes down
    with it instead of serving on as a host broker."""
    p = _pkg("port")
    broker = await _new(p, _plane_config(p, "dense"))
    plane = broker.device_plane
    _fail_steps(plane, monkeypatch, on_card=True, warmup=False)
    await broker.start()
    run = p.harness.TestRun(broker=broker)
    try:
        assert plane.pump_task in broker._tasks
        await run.inject_users([[0], [0]])
        a, b = run.user(0), run.user(1)
        inbox = _Inbox([a, b])
        frame = _broadcast(b"in the failed step")
        await a.remote.send_raw_many([frame], flush=True)
        await inbox.wait_for({a.public_key: 1, b.public_key: 1})
        inbox.close()
        assert inbox.frames[a.public_key] == [frame]
        assert inbox.frames[b.public_key] == [frame]
        assert plane.disabled and plane.messages_routed == 0
        # what run_until_failure waits on
        done, _ = await asyncio.wait(broker._tasks, timeout=5,
                                     return_when=asyncio.FIRST_COMPLETED)
        assert done == {plane.pump_task}
        with pytest.raises(RuntimeError, match="injected"):
            plane.pump_task.result()
    finally:
        await run.shutdown()


async def test_ragged_page_pool_exhaustion_falls_back_then_recovers():
    """A too-small page pool flips the plane to the dense step (never a
    dropped delivery); once membership shrinks, the rebuild restores the
    page walk."""
    p = _pkg("port")
    run = await _start(p, _plane_config(p, "ragged", ragged_max_pages=2))
    try:
        plane = run.broker.device_plane
        a = await _connect(p, run, b"a", [0])
        b = await _connect(p, run, b"b", [1])
        assert plane.delivery_impl == "dense"
        inbox = _Inbox([a])
        sender = await _connect(p, run, b"sender", [])
        await sender.remote.send_raw_many([_broadcast(b"after-fallback")],
                                          flush=True)
        await inbox.wait_for({b"a": 1})
        assert plane.ragged_steps == 0
        b.remote.close()
        async with asyncio.timeout(10):
            while plane.delivery_impl != "ragged":
                await asyncio.sleep(0.005)
        await sender.remote.send_raw_many([_broadcast(b"after-recovery")],
                                          flush=True)
        await inbox.wait_for({b"a": 2})
        inbox.close()
        assert inbox.frames[b"a"] == [_broadcast(b"after-fallback"),
                                      _broadcast(b"after-recovery")]
        assert plane.ragged_steps >= 1 and not plane.disabled
    finally:
        await run.shutdown()


async def test_broker_plane_needs_cuda_unless_told(monkeypatch):
    p = _pkg("port")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _plane_config(p, "dense")
    uid = next(_UID)
    db = os.path.join(tempfile.mkdtemp(prefix="pushcdn-torch-test-"),
                      "discovery.sqlite")
    config = p.broker.BrokerConfig(
        run_def=p.def_.testing_run_def(),
        keypair=p.sig.DEFAULT_SCHEME.generate_keypair(seed=uid),
        discovery_endpoint=db,
        public_advertise_endpoint=f"torch-cuda-pub-{uid}",
        public_bind_endpoint=f"torch-cuda-pub-{uid}",
        private_advertise_endpoint=f"torch-cuda-priv-{uid}",
        private_bind_endpoint=f"torch-cuda-priv-{uid}",
        device_plane=cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        await p.broker.Broker.new(config)
