"""The port's copies of the host pieces held against the JAX package's:
the wire codec, the Memory transport with its byte pool, the two CRDT
maps, the ``Connections`` observer hooks and the ``native`` stand-in.

Every case feeds the same seeded values to both packages and compares
the results exactly.
"""

import asyncio

import numpy as np
import pytest

from pushcdn_tpu.broker import connections as jconn
from pushcdn_tpu.broker import relational_map as jrel
from pushcdn_tpu.broker import versioned_map as jvm
from pushcdn_tpu.proto import limiter as jlim
from pushcdn_tpu.proto import message as jmsg
from pushcdn_tpu.proto.error import Error as JError
from pushcdn_tpu.proto.transport import memory as jmem
from pushcdn_tpu_torch import native as tnative
from pushcdn_tpu_torch.broker import connections as tconn
from pushcdn_tpu_torch.broker import relational_map as trel
from pushcdn_tpu_torch.broker import versioned_map as tvm
from pushcdn_tpu_torch.proto import limiter as tlim
from pushcdn_tpu_torch.proto import message as tmsg
from pushcdn_tpu_torch.proto.error import Error as TError
from pushcdn_tpu_torch.proto.transport import memory as tmem

PACKAGES = {
    "jax": (jmsg, jlim, jmem, jvm, jrel, jconn),
    "port": (tmsg, tlim, tmem, tvm, trel, tconn),
}

KINDS = ["authenticate_with_key", "authenticate_with_permit",
         "authenticate_response", "direct", "broadcast", "subscribe",
         "unsubscribe", "user_sync", "topic_sync", "ledger_sync", "migrate",
         "subscribe_from", "retained", "traced_direct", "traced_broadcast",
         "traced_direct_view", "traced_broadcast_view"]


def _build(m, kind: str, seed: int):
    """One message of ``kind`` from the message module ``m``, its fields
    drawn from ``seed``."""
    rng = np.random.default_rng(seed)

    def blob(lo=0, hi=300):
        return rng.integers(0, 256, int(rng.integers(lo, hi)),
                            dtype=np.uint8).tobytes()

    def topics():
        return [int(t) for t in rng.integers(0, 256, int(rng.integers(0, 6)))]

    def u64():
        return int(rng.integers(0, 2**63)) * 2 + int(rng.integers(0, 2))

    def text():
        return "".join(chr(int(c)) for c in rng.integers(32, 0x3000, 12))

    base = kind.removeprefix("traced_").removesuffix("_view")
    if base == "authenticate_with_key":
        msg = m.AuthenticateWithKey(blob(1, 64), u64(), blob(1, 96))
    elif base == "authenticate_with_permit":
        msg = m.AuthenticateWithPermit(u64())
    elif base == "authenticate_response":
        msg = m.AuthenticateResponse(u64(), text())
    elif base == "direct":
        msg = m.Direct(blob(1, 48), blob())
    elif base == "broadcast":
        msg = m.Broadcast(topics(), blob())
    elif base == "subscribe":
        msg = m.Subscribe(topics())
    elif base == "unsubscribe":
        msg = m.Unsubscribe(topics())
    elif base == "user_sync":
        msg = m.UserSync(blob())
    elif base == "topic_sync":
        msg = m.TopicSync(blob())
    elif base == "ledger_sync":
        msg = m.LedgerSync(blob())
    elif base == "migrate":
        msg = m.Migrate(text(), u64())
    elif base == "subscribe_from":
        msg = m.SubscribeFrom(int(rng.integers(0, 256)), u64(), text())
    else:
        msg = m.Retained(int(rng.integers(0, 256)), u64(), blob())
    if kind.startswith("traced_"):
        trace = (u64(), int(rng.integers(0, 2**62)))
        if kind.endswith("_view"):
            trace += (int(rng.integers(0, 2**32)),)
        msg = m.with_trace(msg, trace)
    return msg


@pytest.mark.parametrize("kind", KINDS)
def test_codec_matches_jax(kind):
    for seed in range(8):
        frames = {name: mods[0].serialize(_build(mods[0], kind, seed))
                  for name, mods in PACKAGES.items()}
        assert frames["port"] == frames["jax"], (kind, seed)
        for name, mods in PACKAGES.items():
            m = mods[0]
            decoded = m.deserialize(frames["jax"])
            assert type(decoded).__name__ == type(
                jmsg.deserialize(frames["jax"])).__name__
            assert m.serialize(decoded) == frames["jax"], (name, kind, seed)
            assert getattr(decoded, "trace", None) == getattr(
                jmsg.deserialize(frames["jax"]), "trace", None)


@pytest.mark.parametrize("frame", [b"", b"\x04\x00\x00\x00\x09ab",
                                   b"\x05\x00\x09\x01", b"\xee", b"\x85\x00"])
def test_codec_rejects_the_same_malformed_frames(frame):
    for m, err in ((jmsg, JError), (tmsg, TError)):
        with pytest.raises(err):
            m.deserialize(frame)


async def _round_trip(m, lim, mem, batches):
    """Send ``batches`` of frames one way over a Memory pair sharing one
    byte pool; return what arrived and the pool's free bytes after every
    received frame was released."""
    limiter = lim.Limiter(global_pool_bytes=1 << 20)
    local, remote = await mem.gen_testing_connection_pair(limiter)
    want = sum(len(b) for b in batches)
    got = []
    try:
        for batch in batches:
            await local.send_raw_many(list(batch), flush=True)
        async with asyncio.timeout(20):
            while len(got) < want:
                for raw in await remote.recv_raw_many():
                    got.append(bytes(raw.data))
                    raw.release()
    finally:
        local.close()
        remote.close()
    return got, limiter.pool.available, limiter.pool.capacity


@pytest.mark.parametrize("shape", ["small frames", "frames past the window",
                                   "one frame per batch"])
async def test_memory_transport_round_trip_matches_jax(shape):
    rng = np.random.default_rng(7)
    sizes = {"small frames": (1, 400, 6, 40),
             "frames past the window": (8000, 40000, 3, 4),
             "one frame per batch": (1, 2000, 20, 1)}[shape]
    lo, hi, n_batches, per_batch = sizes
    batches = [[tmsg.serialize(tmsg.Broadcast(
        [int(rng.integers(0, 256))],
        rng.integers(0, 256, int(rng.integers(lo, hi)),
                     dtype=np.uint8).tobytes()))
        for _ in range(per_batch)] for _ in range(n_batches)]
    results = {}
    for name, (m, lim, mem, *_rest) in PACKAGES.items():
        got, free, cap = await _round_trip(m, lim, mem, batches)
        assert got == [f for b in batches for f in b], name
        assert free == cap, f"{name}: {cap - free} pool bytes still held"
        results[name] = got
    assert results["port"] == results["jax"]


def _crdt_script(seed: int):
    """Seeded operations on three replicas: (replica, op, key, value)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(60):
        r = int(rng.integers(0, 3))
        key = b"user-%d" % int(rng.integers(0, 12))
        op = ("insert", "remove", "remove_if_equals")[
            int(rng.choice(3, p=[0.6, 0.25, 0.15]))]
        ops.append((r, op, key, f"broker-{int(rng.integers(0, 3))}"))
        if rng.random() < 0.3:
            ops.append((r, "merge", int(rng.integers(0, 3)), None))
    return ops


def _run_crdt(vm, ops):
    reps = [vm.VersionedMap(local_identity=f"broker-{i}") for i in range(3)]
    changes = []
    for r, op, key, value in ops:
        if op == "insert":
            reps[r].insert(key, value)
        elif op == "remove":
            reps[r].remove(key)
        elif op == "remove_if_equals":
            reps[r].remove_if_equals(key, value)
        else:
            wire = vm.VersionedMap.serialize_entries(reps[key].full())
            changes.append(reps[r].merge(
                vm.VersionedMap.deserialize_entries(wire)))
    return ([sorted(rep.items()) for rep in reps],
            [vm.VersionedMap.serialize_entries(rep.full()) for rep in reps],
            changes)


@pytest.mark.parametrize("seed", range(4))
def test_versioned_map_merges_match_jax(seed):
    ops = _crdt_script(seed)
    assert _run_crdt(tvm, ops) == _run_crdt(jvm, ops)


@pytest.mark.parametrize("seed", range(2))
def test_relational_map_matches_jax(seed):
    rng = np.random.default_rng(seed)
    maps = [jrel.RelationalMap(), trel.RelationalMap()]
    for _ in range(80):
        key = b"k%d" % int(rng.integers(0, 10))
        values = [int(v) for v in rng.integers(0, 8, int(rng.integers(0, 4)))]
        op = int(rng.integers(0, 3))
        out = []
        for rm in maps:
            if op == 0:
                out.append(rm.associate_key_with_values(key, values))
            elif op == 1:
                out.append(rm.dissociate_key_from_values(key, values))
            else:
                out.append(rm.remove_key(key))
            assert rm.check_invariants()
        assert out[0] == out[1]
        for rm in maps[1:]:
            assert sorted(rm.keys()) == sorted(maps[0].keys())
            assert sorted(rm.values()) == sorted(maps[0].values())
            assert rm.get_keys_by_values(values) == \
                maps[0].get_keys_by_values(values)


class _Recorder:
    def __init__(self):
        self.calls = []

    def on_user_added(self, key, topics):
        self.calls.append(("added", key, sorted(topics)))

    def on_user_removed(self, key):
        self.calls.append(("removed", key))

    def on_subscription_changed(self, key, topics):
        self.calls.append(("changed", key, sorted(topics)))


async def _drive_connections(mods, seed):
    _m, lim, mem, _vm, _rel, conn = mods
    rng = np.random.default_rng(seed)
    c = conn.Connections("test-broker")
    c.observer = rec = _Recorder()
    remotes = []
    for _ in range(40):
        key = b"user-%d" % int(rng.integers(0, 6))
        topics = [int(t) for t in rng.integers(0, 16, int(rng.integers(0, 4)))]
        op = int(rng.integers(0, 4))
        if op == 0:   # connect (a second connect evicts the first)
            local, remote = await mem.gen_testing_connection_pair(lim.NO_LIMIT)
            remotes.append(remote)
            c.add_user(key, local, topics)
        elif op == 1:
            c.subscribe_user_to(key, topics)
        elif op == 2:
            c.unsubscribe_user_from(key, topics)
        else:
            c.remove_user(key)
    state = sorted((k, sorted(c.user_topics.get_values_of_key(k)))
                   for k in c.users)
    c.remove_all()
    for r in remotes:
        r.close()
    return rec.calls, state


@pytest.mark.parametrize("seed", range(3))
async def test_connections_fire_observer_hooks_as_jax(seed):
    got = await _drive_connections(PACKAGES["port"], seed)
    want = await _drive_connections(PACKAGES["jax"], seed)
    assert got == want
    assert {call[0] for call in got[0]} >= {"added", "removed"}


@pytest.mark.parametrize("routine", [
    lambda: tnative.FrameScanner.create(),
    lambda: tnative.FrameEncoder.create(),
    tnative.shared_encoder,
    tnative.pydecode,
    lambda: tnative.egress_encode(np.ones((2, 2), bool),
                                  np.ones(2, np.int32),
                                  [np.zeros((2, 4), np.uint8)]),
], ids=["FrameScanner", "FrameEncoder", "shared_encoder", "pydecode",
        "egress_encode"])
def test_native_reports_every_routine_unavailable(routine):
    assert routine() is None


def test_build_info_names_torch_not_jax():
    """``cdn_build_info`` carries torch's version and the device the
    process runs on, where the JAX package's carries jax's."""
    import torch

    from pushcdn_tpu_torch.proto import metrics as tmetrics
    line = next(row for row in tmetrics.render_all().splitlines()
                if row.startswith("cdn_build_info{"))
    assert f'torch="{torch.__version__}"' in line
    assert "jax" not in line
    want = "cpu" if torch.version.cuda is None else "uninitialized"
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        want = "cuda"
    assert f'backend="{want}"' in line and line.endswith(" 1")


# ---------------------------------------------------------------------------
# embedded discovery: one fresh file opened by several processes at once
# ---------------------------------------------------------------------------

_OPENER = r"""
import asyncio, sys, time
from pushcdn_tpu_torch.proto.discovery.base import BrokerIdentifier
from pushcdn_tpu_torch.proto.discovery.embedded import Embedded

root, start, gap, rounds, me = sys.argv[1:]
start, gap, rounds = float(start), float(gap), int(rounds)

async def main():
    for r in range(rounds):
        at = start + r * gap                   # every opener in step
        time.sleep(max(at - time.time() - 0.002, 0))
        while time.time() < at:
            pass
        disc = await Embedded.new(f"{root}/r{r}.sqlite",
                                  identity=BrokerIdentifier(f"p{me}", f"q{me}"))
        await disc.perform_heartbeat(int(me), 60.0)
        await disc.close()

asyncio.run(main())
"""


def test_embedded_opens_one_fresh_file_from_many_processes(tmp_path):
    """Six processes open each of 20 fresh files at the same instant and
    write a heartbeat: none may see 'database is locked' (the WAL switch
    of a fresh file answers the loser of its lock race at once)."""
    import os
    import subprocess
    import sys
    import time

    from pushcdn_tpu_torch.proto.discovery.embedded import Embedded

    procs, rounds = 6, 20
    start = time.time() + 8          # past every process's imports
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    children = [subprocess.Popen(
        [sys.executable, "-c", _OPENER, str(tmp_path), str(start), "0.1",
         str(rounds), str(i)], cwd=root, stderr=subprocess.PIPE, text=True)
        for i in range(procs)]
    errors = [c.communicate(timeout=90)[1] for c in children]
    assert [c.returncode for c in children] == [0] * procs, \
        "\n".join(e[-600:] for e in errors if e)

    async def rows(r):
        disc = await Embedded.new(str(tmp_path / f"r{r}.sqlite"))
        try:
            return sorted(b.public_advertise_endpoint
                          for b in await disc.get_other_brokers())
        finally:
            await disc.close()

    for r in range(rounds):
        assert asyncio.run(rows(r)) == [f"p{i}" for i in range(procs)]
