"""The port's test harness over loopback TCP (``TestDefinition(
tcp_users=True)``) held against the JAX package's.

The seeded mixes of ``tests/test_route_cutthrough.py::
test_pump_mix_equivalence`` (broadcasts at uniform or zipf topic
popularity, directs, subscribe / unsubscribe, traced frames, trailing
garbage) go from user 0 over real TCP sockets through each package's
broker, with its users injected over TCP, on asyncio with the pump off
and under both route impls. Every peer's delivered byte sequence, the
sender's disconnect decision and the byte pool's balance must be the same
in both packages.
"""

import asyncio
import gc
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from _torch_libs import jax_routeplan_available
from pushcdn_tpu.proto import trace as trace_lib
from pushcdn_tpu.proto.message import (
    Broadcast,
    Direct,
    Subscribe,
    Unsubscribe,
    serialize,
)
from pushcdn_tpu.proto.transport import pump as jax_pump
from pushcdn_tpu.proto.transport import uring as jax_uring

ROOTS = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}

# the topology of tests/test_route_cutthrough.py: sender is user 0;
# receivers are users 1-4 (topics {0}, {0}, {1}, {}) and two peer brokers
USER_TOPICS = [[], [0], [0], [1], []]
BROKER_DEFS = [([0], [b"remote-user"]), ([1], [])]
KNOWN_DIRECTS = [b"user-1", b"user-2", b"user-3", b"user-4",
                 b"remote-user", b"nobody-home"]


def _pkg(name: str) -> SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{ROOTS[name]}.{path}")

    return SimpleNamespace(
        name=name, cutthrough=mod("broker.tasks.cutthrough"),
        harness=mod("broker.test_harness"), base=mod("proto.transport.base"),
        routeplan=mod("native.routeplan"))


JAX, PORT = _pkg("jax"), _pkg("port")


def _gen_frames(rng: np.random.Generator, n: int, popularity: str):
    """``tests/test_route_cutthrough.py``'s pump mix: a warm-up prefix,
    then broadcasts, directs, control frames, traced frames and
    garbage."""
    topic_p = np.array([0.85, 0.15] if popularity == "zipf" else [0.5, 0.5])

    def pick_topics(k):
        return [int(t) for t in rng.choice([0, 1], size=k, p=topic_p)]

    frames = [serialize(Broadcast([0], b"warm-%02d" % i)) for i in range(8)]
    for _ in range(n):
        roll = rng.integers(0, 100)
        payload = bytes(rng.integers(0, 256, int(rng.integers(1, 256)),
                                     dtype=np.uint8))
        if roll < 60:
            frames.append(serialize(Broadcast(
                pick_topics(int(rng.integers(1, 3))), payload)))
        elif roll < 78:
            rcpt = KNOWN_DIRECTS[int(rng.integers(0, len(KNOWN_DIRECTS)))]
            frames.append(serialize(Direct(rcpt, payload)))
        elif roll < 86:
            frames.append(serialize(Subscribe(pick_topics(1))))
        elif roll < 92:
            frames.append(serialize(Unsubscribe([0])))
        elif roll < 97:
            tr = trace_lib.new_trace()
            frames.append(trace_lib.stamp_frame(
                serialize(Broadcast(pick_topics(1), payload)), tr))
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
        else:
            got.append(bytes(raw.data))
        raw.release()


async def _drain_all(p, conn, settle_s: float = 0.05):
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


async def _run_mix(p, impl: str, frames) -> tuple:
    """One mix through package ``p``'s broker with its users over TCP:
    (deliveries per peer, sender alive, pool balanced)."""
    prev = p.cutthrough.ROUTE_IMPL
    p.cutthrough.ROUTE_IMPL = impl
    try:
        run = await p.harness.TestDefinition(
            connected_users=USER_TOPICS, connected_brokers=BROKER_DEFS,
            tcp_users=True).run()
        try:
            assert run.tcp_listener is not None
            sender = run.user(0).remote
            try:
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
            pool = run.broker.limiter.pool
            balanced = True
            if pool is not None:
                for _ in range(20):
                    gc.collect()
                    if pool.available == pool.capacity:
                        break
                    await asyncio.sleep(0.02)
                balanced = pool.available == pool.capacity
            return deliveries, alive, balanced
        finally:
            await run.shutdown()
    finally:
        p.cutthrough.ROUTE_IMPL = prev


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("popularity", ("uniform", "zipf"))
@pytest.mark.parametrize("impl", ("native", "python"))
async def test_tcp_users_mix_matches_jax(impl, popularity, seed, monkeypatch):
    if impl == "native" and not (jax_routeplan_available()
                                 and PORT.routeplan.available()):
        pytest.skip("native route-plan library unavailable (no working g++)")
    rng = np.random.default_rng(17_000 + seed
                                + (500 if popularity == "zipf" else 0))
    frames = _gen_frames(rng, 48, popularity)
    # the JAX package on asyncio with its pump off, as the reference legs
    saved = (jax_uring._resolved, jax_uring._warned_demote,
             jax_pump.PUMP_IMPL, jax_pump._warned_demote)
    monkeypatch.setenv("PUSHCDN_IO_IMPL", "asyncio")  # restored after
    jax_uring.set_io_impl("asyncio")
    jax_pump.set_pump_impl("off")
    try:
        want = await _run_mix(JAX, impl, frames)
    finally:
        (jax_uring._resolved, jax_uring._warned_demote,
         jax_pump.PUMP_IMPL, jax_pump._warned_demote) = saved
    got = await _run_mix(PORT, impl, frames)
    assert any(len(v) > 0 for v in want[0].values()), want[0]
    assert got[1] == want[1], "the sender's disconnect decision differs"
    assert got[2] and want[2], "permits leaked"
    assert got[0] == want[0], "deliveries differ"
