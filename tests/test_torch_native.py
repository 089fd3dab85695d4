"""The port's native host routines (``pushcdn_tpu_torch.native``) held
against the JAX package's (``pushcdn_tpu.native``) on the CPU.

Both packages build their C++ with ``g++`` at first use, each from its
own sources. The same seeded numpy inputs go through both, and through
the port's Python branch where one exists; the results must be equal
byte for byte: the ring packer, the wire scanner and encoders, the
egress encoder and the batch decoder. Then the device plane and the mesh
group with native egress against the same runs with the library
removed, the card's rule that a plane there requires the library, and
the libraries' isolation from the JAX package's.
"""

import asyncio
import os
import random
import struct
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

from pushcdn_tpu import native as jnative
from pushcdn_tpu.parallel.frames import FrameRing as JaxFrameRing
from pushcdn_tpu.proto import message as jmessage
from pushcdn_tpu_torch import native as tnative
from pushcdn_tpu_torch.parallel.frames import FrameRing
from pushcdn_tpu.proto.error import Error as JaxError
from pushcdn_tpu_torch.proto import message as tmessage
from pushcdn_tpu_torch.proto.error import Error
from pushcdn_tpu_torch.proto.message import KIND_BROADCAST, KIND_DIRECT
from pushcdn_tpu_torch.proto.transport.base import _py_scan_frames

ROOT = Path(__file__).resolve().parents[1]
NATIVE = {"jax": jnative, "port": tnative}

pytestmark = pytest.mark.skipif(
    not (jnative.available() and tnative.available()),
    reason="g++ did not build the native libraries")


def _wire(payloads) -> bytes:
    """The length-delimited stream, the obvious way (u32 big-endian)."""
    return b"".join(struct.pack(">I", len(p)) + p for p in payloads)


def _burst(rng, n, frame_bytes, W):
    """n frames of a mixed burst: broadcasts with 1-3 topics, directs."""
    payloads = [rng.integers(0, 256, int(rng.integers(0, frame_bytes + 1)),
                             dtype=np.uint8).tobytes() for _ in range(n)]
    kinds = [KIND_BROADCAST if rng.random() < 0.8 else KIND_DIRECT
             for _ in range(n)]
    tmasks = [sum(1 << int(t) for t in rng.integers(0, 32 * W, 3))
              if k == KIND_BROADCAST else 0 for k in kinds]
    dests = [-1 if k == KIND_BROADCAST else int(rng.integers(0, 64))
             for k in kinds]
    return payloads, kinds, tmasks, dests


@pytest.fixture
def no_native(monkeypatch):
    """The port's native library made unavailable, as if g++ had failed:
    every routine answers None and callers take their Python branch."""
    for name, value in (("_lib", None), ("_tried", True),
                        ("_pydecode_fn", None), ("_pydecode_tried", True),
                        ("_shared_encoder", None),
                        ("_shared_encoder_tried", True)):
        monkeypatch.setattr(tnative, name, value)
    monkeypatch.setattr(tmessage, "_native_decode", None)
    monkeypatch.setattr(tmessage, "_native_decode_tried", True)
    assert not tnative.available()


# ---------------------------------------------------------------------------
# the ring packer
# ---------------------------------------------------------------------------


def _pack_out(capacity, frame_bytes, W):
    shape = (capacity,) if W == 1 else (capacity, W)
    return [np.zeros((capacity, frame_bytes), np.uint8),
            np.zeros(capacity, np.int32), np.zeros(capacity, np.int32),
            np.zeros(shape, np.uint32), np.full(capacity, -1, np.int32),
            np.zeros(capacity, np.uint8)]


@pytest.mark.parametrize("W,tail", [(1, False), (1, True), (8, False),
                                    (8, True)])
def test_pack_frames_into_matches_jax(W, tail):
    """The same burst packed by both packages into fresh arrays, or into
    a ring-tail view (the arrays sliced at a cursor)."""
    rng = np.random.default_rng(10 * W + tail)
    payloads, kinds, tmasks, dests = _burst(rng, 40, 64, W)
    words = np.stack([np.frombuffer(int(m).to_bytes(4 * W, "little"),
                                    np.uint32) for m in tmasks])
    words = words[:, 0] if W == 1 else words
    got = {}
    for name, mod in NATIVE.items():
        out = _pack_out(48, 64, W)
        start = 13 if tail else 0
        n = mod.pack_frames_into(
            payloads, np.asarray(kinds, np.int32), words,
            np.asarray(dests, np.int32), *(a[start:] for a in out))
        got[name] = (n, out)
    n, out = got["port"]
    assert n == got["jax"][0] == (35 if tail else 40)
    for a, b in zip(out, got["jax"][1]):
        np.testing.assert_array_equal(a, b)
    start = 13 if tail else 0
    for i in range(n):
        p = payloads[i]
        assert out[0][start + i, :len(p)].tobytes() == p
        assert not out[0][start + i, len(p):].any()


@pytest.mark.parametrize("W", [1, 8])
def test_push_batch_matches_python_loop_and_jax(W, monkeypatch):
    """``FrameRing.push_batch`` packs natively into a partly filled ring
    exactly as its Python loop does and as the JAX package's ring
    does."""
    rng = np.random.default_rng(W)
    payloads, kinds, tmasks, dests = _burst(rng, 30, 48, W)
    tmasks[3] = (1 << (32 * W)) | 0b11   # above the topic space
    tmasks[4] = -1                       # a pathological caller input

    def run(cls):
        ring = cls(slots=32, frame_bytes=48, topic_words=W)
        assert ring.push_broadcast(b"first", 0b1)
        n = ring.push_batch(payloads, kinds, tmasks, dests)
        return n, ring.take_batch()

    native_n, native_b = run(FrameRing)
    jax_n, jax_b = run(JaxFrameRing)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    py_n, py_b = run(FrameRing)
    assert native_n == jax_n == py_n == 30
    for field in ("bytes_", "kind", "length", "topic_mask", "dest", "valid"):
        np.testing.assert_array_equal(getattr(native_b, field),
                                      getattr(py_b, field), err_msg=field)
        np.testing.assert_array_equal(getattr(native_b, field),
                                      getattr(jax_b, field), err_msg=field)


@pytest.mark.parametrize("name", ["port", "jax"])
@pytest.mark.parametrize("case", ["oversized", "length_mismatch"])
def test_pack_frames_into_rejects_as_jax(case, name):
    mod = NATIVE[name]
    out = _pack_out(8, 16, 1)
    if case == "oversized":
        args = ([b"ok", b"z" * 17], [5, 5], [1, 1], [-1, -1])
        match = "frame slot"
    else:
        args = ([b"a", b"b"], [5], [1, 1], [-1, -1])
        match = "mismatch"
    with pytest.raises(ValueError, match=match):
        mod.pack_frames_into(*(np.asarray(a) if i else a
                               for i, a in enumerate(args)), *out)
    ring = FrameRing(slots=8, frame_bytes=16)
    with pytest.raises(ValueError, match=match):
        ring.push_batch(*args)
    assert ring.free_slots == 8   # nothing was partly packed


def test_push_batch_ring_full_means_requeue():
    ring = FrameRing(slots=2, frame_bytes=16)
    assert ring.push_batch([b"a", b"b", b"c"], [5] * 3, [1] * 3,
                           [-1] * 3) == 2
    assert ring.take_batch().num_valid == 2


# ---------------------------------------------------------------------------
# the wire scanner and encoders
# ---------------------------------------------------------------------------


def _scan_all(scan, chunks, max_len):
    """Feed ``chunks`` through a reader's carry buffer as the transport
    does; returns the payloads found and whether an error was flagged."""
    carry = bytearray()
    found = []
    for chunk in chunks:
        carry += chunk
        while True:   # a scanner caps its frames per call: scan again
            offs, lens, consumed, error = scan(bytes(carry), max_len)
            found += [bytes(carry[o:o + n]) for o, n in zip(offs, lens)]
            if error:
                return found, True
            del carry[:consumed]
            if not consumed:
                break
    return found, False


@pytest.mark.parametrize("case", ["whole", "partial", "oversized",
                                  "chunks"])
def test_scanner_matches_jax_and_python_scan(case):
    rng = random.Random(len(case))
    payloads = [rng.randbytes(rng.randrange(0, 300)) for _ in range(50)]
    stream = _wire(payloads)
    max_len = 1024
    if case == "whole":
        chunks = [stream]
    elif case == "partial":
        chunks = [stream + b"\x00\x00\x01\x00part"]
    elif case == "oversized":
        chunks = [_wire(payloads[:3]) + struct.pack(">I", 10_000) + b"x" * 10]
    else:
        cuts = sorted(rng.sample(range(1, len(stream)), 40))
        chunks = [stream[a:b] for a, b in zip([0] + cuts, cuts + [None])]
    tscan = tnative.FrameScanner.create(max_frames=16)
    jscan = jnative.FrameScanner.create(max_frames=16)
    got = {"port": _scan_all(tscan.scan, chunks, max_len),
           "jax": _scan_all(jscan.scan, chunks, max_len),
           "python": _scan_all(_py_scan_frames, chunks, max_len)}
    assert got["port"] == got["jax"] == got["python"]
    want_error = case == "oversized"
    assert got["port"][1] is want_error
    n = 3 if want_error else len(payloads)
    assert got["port"][0] == payloads[:n]
    if case != "oversized":
        frames, consumed, error = tnative.scan_frames(chunks[0], max_len)
        assert (frames, consumed, error) == jnative.scan_frames(chunks[0],
                                                                max_len)


@pytest.mark.parametrize("how", ["encode", "encode_detached",
                                 "encode_frames"])
def test_encoders_match_jax_and_the_wire_format(how):
    rng = random.Random(how)
    payloads = [rng.randbytes(rng.randrange(0, 200)) for _ in range(300)]
    want = _wire(payloads)
    got = {}
    for name, mod in NATIVE.items():
        if how == "encode_frames":
            got[name] = mod.encode_frames(payloads)
            continue
        enc = mod.FrameEncoder.create(capacity=len(want))
        out = getattr(enc, how)(payloads)
        got[name] = bytes(out)
        if how == "encode":
            assert enc.encode(payloads + [b"x"]) is None   # does not fit
        else:
            assert enc.encode_detached([b"a", memoryview(b"b")]) is None
    assert got["port"] == got["jax"] == want
    # the round trip: the scanner finds every payload again
    offs, lens, consumed, error = tnative.FrameScanner.create().scan(
        got["port"], 1024)
    assert not error and consumed == len(want)
    assert [want[o:o + n] for o, n in zip(offs, lens)] == payloads


def test_shared_encoder_is_one_instance():
    enc = tnative.shared_encoder()
    assert enc is not None and enc is tnative.shared_encoder()
    assert bytes(enc.encode_detached([b"ab", b""])) == _wire([b"ab", b""])


# ---------------------------------------------------------------------------
# the egress encoder
# ---------------------------------------------------------------------------


def _egress_reference(deliver, lengths, blocks):
    """Per-user streams: row-major ``np.nonzero``, then each delivered
    frame as its u32 big-endian length and payload."""
    rows = blocks[0].shape[0]
    out = {}
    users, frames = np.nonzero(deliver)
    for u in np.unique(users):
        fs = frames[users == u]
        out[int(u)] = (b"".join(
            struct.pack(">I", int(lengths[f]))
            + blocks[f // rows][f % rows, :lengths[f]].tobytes()
            for f in fs), len(fs))
    return out


def _egress_case(case):
    rng = np.random.default_rng(abs(hash(case)) % 1000)
    U, B, S, F, pitch = 24, 3, 13, 96, 96   # N = 39: a ragged 8-byte tail
    density = {"sparse": 0.02, "half": 0.5, "full": 1.0, "empty": 0.0,
               "one_user": 0.4, "pitch": 0.3, "retry": 1.0}[case]
    if case == "one_user":
        U = 1
    if case == "pitch":
        pitch = F + 40      # each block a view whose rows are wider
    if case == "retry":
        U, B, S, F, pitch = 64, 2, 32, 2048, 2048   # 8 MiB > a fresh buffer
    blocks = [rng.integers(0, 256, (S, pitch), dtype=np.uint8)[:, :F]
              for _ in range(B)]
    lengths = rng.integers(0, F + 1, B * S).astype(np.int32)
    if case == "retry":
        lengths[:] = F
    deliver = rng.random((U, B * S)) < density
    return deliver, lengths, blocks


@pytest.mark.parametrize("case", ["sparse", "half", "full", "empty",
                                  "one_user", "pitch", "retry"])
def test_egress_encode_matches_jax_and_reference(case, monkeypatch):
    deliver, lengths, blocks = _egress_case(case)
    ref = _egress_reference(deliver, lengths, blocks)
    for name, mod in NATIVE.items():
        if case == "retry":
            # an empty pool: the first fused pass finds its buffer too
            # small, counts, takes one of the exact size and retries
            monkeypatch.setattr(mod, "_EGRESS_POOL", [])
            calls = []
            count = mod._get().pushcdn_egress_count
            monkeypatch.setattr(mod._get(), "pushcdn_egress_count",
                                lambda *a: calls.append(1) or count(*a))
        streams = mod.egress_encode(deliver, lengths, blocks)
        if case == "retry":
            assert calls == [1], name
        assert streams.users == sorted(ref), name
        assert streams.total_msgs == int(deliver.sum()), name
        for u in range(deliver.shape[0]):
            want, n = ref.get(u, (b"", 0))
            assert bytes(streams.stream(u)) == want, (name, u)
            assert int(streams.msgs[u]) == n, (name, u)
    a = tnative.egress_encode(deliver, lengths, blocks)
    b = jnative.egress_encode(deliver, lengths, blocks)
    for field in ("offsets", "nbytes", "msgs"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_egress_encode_checks_its_blocks():
    deliver = np.ones((2, 8), bool)
    lengths = np.ones(8, np.int32)
    with pytest.raises(ValueError, match="blocks cover"):
        tnative.egress_encode(deliver, lengths, [np.zeros((4, 8), np.uint8)])
    with pytest.raises(ValueError, match="share shape"):
        tnative.egress_encode(deliver, lengths,
                              [np.zeros((4, 8), np.uint8),
                               np.zeros((4, 16), np.uint8)[:, :8]])


def test_egress_pool_recycles_a_released_buffer():
    deliver, lengths, blocks = _egress_case("half")
    streams = tnative.egress_encode(deliver, lengths, blocks)
    buf = streams.buf
    seen = []
    tnative.add_egress_registrar(seen.append)
    seen.clear()   # the replay of the buffers pooled before
    try:
        del streams
        assert any(b is buf for b in tnative.egress_pool_buffers())
        again = tnative.egress_encode(deliver, lengths, blocks)
        assert again.buf is buf and not seen   # reused, not allocated
    finally:
        tnative._EGRESS_REGISTRARS.remove(seen.append)


# ---------------------------------------------------------------------------
# the batch decoder
# ---------------------------------------------------------------------------


def _frames(mod, seed):
    rng = random.Random(seed)
    out = []
    for _ in range(120):
        pick = rng.randrange(4)
        if pick == 0:
            m = mod.Broadcast(topics=[rng.randrange(256)
                                      for _ in range(rng.randrange(4))],
                              message=rng.randbytes(rng.randrange(0, 600)))
        elif pick == 1:
            m = mod.Direct(recipient=rng.randbytes(rng.randrange(48)),
                           message=rng.randbytes(rng.randrange(0, 600)))
        elif pick == 2:
            m = mod.Subscribe(topics=[rng.randrange(256)
                                      for _ in range(rng.randrange(4))])
        else:
            m = mod.Broadcast(topics=[], message=b"")
        out.append(mod.serialize(m))
    return out


def _as_record(m):
    return (type(m).__name__,
            {k: (bytes(v) if isinstance(v, (bytes, memoryview)) else
                 list(v) if isinstance(v, (list, tuple)) else v)
             for k in type(m).__slots__ for v in [getattr(m, k)]})


@pytest.mark.parametrize("zero_copy", [False, True])
def test_pydecode_matches_jax_and_the_python_loop(zero_copy, monkeypatch):
    frames = _frames(tmessage, 5)
    assert frames == _frames(jmessage, 5)
    buf = b"".join(frames)
    offs = np.cumsum([0] + [len(f) for f in frames[:-1]]).tolist()
    lens = [len(f) for f in frames]
    fn = tnative.pydecode()
    native_out = fn(buf, offs, lens, 0, tmessage.Broadcast, tmessage.Direct,
                    tmessage.deserialize_owned,
                    tmessage.ZERO_COPY_MIN if zero_copy else 0)
    assert native_out is not None
    jax_out = jmessage.decode_frames(buf, offs, lens, zero_copy=zero_copy)
    monkeypatch.setattr(tmessage, "_native_decode", None)
    monkeypatch.setattr(tmessage, "_native_decode_tried", True)
    py_out = tmessage.decode_frames(buf, offs, lens, zero_copy=zero_copy)
    assert [type(m) for m in native_out] == [type(m) for m in py_out]
    assert all(type(m).__module__ == "pushcdn_tpu_torch.proto.message"
               for m in native_out)
    assert [_as_record(m) for m in native_out] == \
        [_as_record(m) for m in py_out] == [_as_record(m) for m in jax_out]
    if zero_copy:
        assert any(isinstance(m.message, memoryview) for m in native_out
                   if hasattr(m, "message"))


@pytest.mark.parametrize("bad", [b"\x05\xff\xff", b"\x04\xff\xff\xff\x7f"])
def test_pydecode_malformed_raises_as_the_python_loop(bad):
    fn = tnative.pydecode()
    with pytest.raises(Error) as nat:
        fn(bad, [0], [len(bad)], 0, tmessage.Broadcast, tmessage.Direct,
           tmessage.deserialize_owned, 0)
    with pytest.raises(JaxError) as ref:
        jmessage.decode_frames(bad, [0], [len(bad)])
    assert nat.value.kind.name == ref.value.kind.name


def test_both_decoders_in_one_process_keep_their_classes():
    """The two packages' decoders are two libraries: alternating calls
    construct each package's own classes, never the other's."""
    frames = _frames(tmessage, 8)
    buf = b"".join(frames)
    offs = np.cumsum([0] + [len(f) for f in frames[:-1]]).tolist()
    lens = [len(f) for f in frames]
    for _ in range(3):
        t = tmessage.decode_frames(buf, offs, lens)
        j = jmessage.decode_frames(buf, offs, lens)
        assert {type(m).__module__ for m in t} == {
            "pushcdn_tpu_torch.proto.message"}
        assert {type(m).__module__ for m in j} == {"pushcdn_tpu.proto.message"}
        assert [_as_record(m) for m in t] == [_as_record(m) for m in j]


# ---------------------------------------------------------------------------
# the libraries are the port's own
# ---------------------------------------------------------------------------


def test_libraries_build_from_the_ports_sources():
    paths = tnative.library_paths()
    assert set(paths) == {"framing", "pydecode"}
    for name, path in paths.items():
        assert path.parent == ROOT / ".build" / "torch_native"
        assert path.is_file(), name
        assert (ROOT / "pushcdn_tpu_torch" / "native" / f"{name}.cpp").is_file()
    assert paths["framing"] != Path(jnative._LIB_PATH)
    assert paths["pydecode"] != Path(jnative._pydecode_lib_path())
    assert paths["pydecode"].name.endswith(
        f"-{tnative._pydecode_abi()}.so")
    maps = Path("/proc/self/maps").read_text()
    for path in paths.values():
        assert str(path) in maps   # the port's own files are the loaded ones
    src = (ROOT / "pushcdn_tpu_torch" / "native" / "__init__.py").read_text()
    assert '"native"' not in src and "_REPO" not in src


def test_library_name_follows_source_and_flags(monkeypatch, tmp_path):
    for name in ("framing", "pydecode"):
        (tmp_path / f"{name}.cpp").write_bytes(
            (tnative.SRC_DIR / f"{name}.cpp").read_bytes())
    monkeypatch.setattr(tnative, "SRC_DIR", tmp_path)
    first = tnative.library_path("framing")
    assert first == tnative.library_paths()["framing"]
    assert tnative.library_path("framing", ("-g",)) != first
    (tmp_path / "framing.cpp").write_text("// edited\n")
    assert tnative.library_path("framing") != first


def test_failed_build_degrades_and_is_recorded(monkeypatch, tmp_path):
    (tmp_path / "framing.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC_DIR", tmp_path)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(tnative, "_build_errors", {})
    assert tnative._build_lib("framing", None) is None
    assert "g++ exited" in tnative.build_errors()["framing"]
    assert not list((tmp_path / "out").glob("*"))   # no partial library


_NO_TORCH = r"""
import sys
sys.modules["torch"] = None
sys.modules["jax"] = None
sys.modules["pushcdn_tpu"] = None
import numpy as np
from pushcdn_tpu_torch import native
native.build()
s = native.egress_encode(np.eye(3, dtype=bool), np.array([1, 2, 3], np.int32),
                         [np.arange(12, dtype=np.uint8).reshape(3, 4)])
assert bytes(s.stream(2)) == b"\x00\x00\x00\x03\x08\x09\x0a", bytes(s.stream(2))
print("ok")
"""


def test_native_module_needs_neither_torch_nor_jax():
    r = subprocess.run([sys.executable, "-c", _NO_TORCH], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


# ---------------------------------------------------------------------------
# the egress paths: native against the Python walk
# ---------------------------------------------------------------------------


async def _plane_run(tag: str) -> tuple:
    """A port broker with a dense plane on the CPU: 12 users, 4 publish
    broadcasts and directs in two rounds; returns every user's frames in
    arrival order and the plane's egress counters."""
    from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
    from pushcdn_tpu_torch.broker.device_plane import DevicePlaneConfig
    from pushcdn_tpu_torch.broker.test_harness import TestRun
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.def_ import testing_run_def
    from pushcdn_tpu_torch.proto.topic import TopicSpace

    db = os.path.join(tempfile.mkdtemp(prefix="pushcdn-native-"), "d.sqlite")
    broker = await Broker.new(BrokerConfig(
        run_def=testing_run_def(topics=TopicSpace.range(8)),
        keypair=DEFAULT_SCHEME.generate_keypair(seed=3),
        discovery_endpoint=db,
        public_advertise_endpoint=f"native-{tag}-pub",
        public_bind_endpoint=f"native-{tag}-pub",
        private_advertise_endpoint=f"native-{tag}-priv",
        private_bind_endpoint=f"native-{tag}-priv",
        heartbeat_interval_s=3600, sync_interval_s=3600,
        whitelist_interval_s=3600, device="cpu",
        device_plane=DevicePlaneConfig(
            num_user_slots=32, ring_slots=64, frame_bytes=256,
            extra_lanes=((2048, 8),), topic_words=1, bypass_max_items=0,
            delivery_impl="dense")))
    await broker.start()
    run = TestRun(broker=broker)
    rng = random.Random(11)
    try:
        await run.inject_users([[u % 3, 3 + u % 2] for u in range(12)])
        users = run.connected_users
        got = {u.public_key: [] for u in users}

        async def drain(u):
            while True:
                raws = await u.remote.recv_raw_many()
                got[u.public_key] += [bytes(r.data) for r in raws]
                for r in raws:
                    r.release()

        drains = [asyncio.create_task(drain(u)) for u in users]
        want = 0
        try:
            for rnd in range(2):
                for pub in range(4):
                    frames = []
                    for i in range(6):
                        body = f"{rnd}/{pub}/{i}/".encode() + rng.randbytes(
                            rng.choice([8, 100, 900]))
                        if i % 3 == 2:
                            to = users[rng.randrange(12)].public_key
                            frames.append(tmessage.serialize(
                                tmessage.Direct(to, body)))
                            want += 1
                        else:
                            topic = rng.randrange(5)
                            frames.append(tmessage.serialize(
                                tmessage.Broadcast([topic], body)))
                            want += sum(topic in (u % 3, 3 + u % 2)
                                        for u in range(12))
                    await run.user(pub).remote.send_raw_many(frames,
                                                             flush=True)
                async with asyncio.timeout(20):
                    while sum(map(len, got.values())) < want:
                        await asyncio.sleep(0.005)
        finally:
            for t in drains:
                t.cancel()
            await asyncio.gather(*drains, return_exceptions=True)
        plane = broker.device_plane
        return (got, plane.busy_steps, plane.native_egress_steps,
                plane.messages_routed)
    finally:
        await run.shutdown()


async def test_dense_plane_native_egress_equals_the_python_walk(
        monkeypatch):
    native_got, busy, native_steps, routed = await _plane_run("n")
    assert busy > 0 and native_steps == busy
    with monkeypatch.context() as m:
        for name, value in (("_lib", None), ("_tried", True)):
            m.setattr(tnative, name, value)
        py_got, py_busy, py_native, py_routed = await _plane_run("p")
    assert py_busy > 0 and py_native == 0
    assert routed == py_routed == sum(map(len, native_got.values()))
    assert native_got == py_got


async def _mesh_run(prefix: str) -> tuple:
    from pushcdn_tpu_torch.testing import MeshCluster

    cl = await MeshCluster(num_shards=3, device="cpu",
                           prefix=prefix).start()
    try:
        clients = [await cl.place_client(seed=700 + i, shard=i % 3,
                                         topics=[i % 2])
                   for i in range(6)]
        sent = []
        for i, c in enumerate(clients):
            for k in range(3):
                body = f"{i}/{k}".encode() * (1 + 40 * k)
                await c.send_broadcast_message([k % 2], body)
                sent.append((k % 2, body))
            await c.send_direct_message(clients[(i + 1) % 6].public_key,
                                        f"d{i}".encode())
        got = []
        for i, c in enumerate(clients):
            n = sum(t == i % 2 for t, _ in sent) + 1
            msgs = [await asyncio.wait_for(c.receive_message(), 10)
                    for _ in range(n)]
            got.append(sorted((type(m).__name__, bytes(m.message))
                              for m in msgs))
        g = cl.group
        for c in clients:
            c.close()
        return got, g.busy_steps, g.native_egress_steps, g.messages_routed
    finally:
        await cl.stop()


async def test_mesh_group_native_egress_equals_the_python_walk(monkeypatch):
    native_got, busy, native_steps, routed = await _mesh_run("nat-mg")
    assert busy > 0 and native_steps == busy
    with monkeypatch.context() as m:
        for name, value in (("_lib", None), ("_tried", True)):
            m.setattr(tnative, name, value)
        py_got, py_busy, py_native, py_routed = await _mesh_run("py-mg")
    assert py_busy > 0 and py_native == 0
    assert routed == py_routed
    assert native_got == py_got


# ---------------------------------------------------------------------------
# on the card a plane requires the library
# ---------------------------------------------------------------------------


def test_strict_encode_raises_without_the_library(no_native):
    from pushcdn_tpu_torch.broker.pump_common import encode_egress

    deliver, lengths, blocks = _egress_case("half")
    assert encode_egress(deliver, lengths, blocks, strict=False) is None
    with pytest.raises(RuntimeError, match="native egress engine"):
        encode_egress(deliver, lengths, blocks, strict=True)


async def test_plane_on_the_card_needs_the_library_at_warmup(no_native,
                                                             monkeypatch):
    """A DevicePlane on the card (its device made to read as CUDA) whose
    library did not load raises out of ``start``; on the CPU it warms up
    and egresses through the Python walk."""
    import torch

    from pushcdn_tpu_torch.broker.device_plane import (
        DevicePlane,
        DevicePlaneConfig,
    )

    cfg = DevicePlaneConfig(num_user_slots=8, ring_slots=4, frame_bytes=32,
                            extra_lanes=())
    cpu = DevicePlane(cfg, device="cpu")
    await cpu.start()
    assert not cpu.disabled
    await cpu.stop()
    card = DevicePlane(cfg, device="cpu")
    monkeypatch.setattr(card, "device", torch.device("cuda"))
    with pytest.raises(RuntimeError, match="requires the native egress"):
        await card.start()
    assert card.pump_task is None


async def test_group_on_the_card_needs_the_library_in_every_member(
        no_native, monkeypatch):
    from pushcdn_tpu_torch.broker import mesh_group as mg
    from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
    from pushcdn_tpu_torch.parallel.mesh import make_broker_mesh
    from pushcdn_tpu_torch.testing import MeshCluster

    monkeypatch.setattr(mg.MeshBrokerGroup, "fails_open", False)
    cluster = MeshCluster(num_shards=2, device="cpu", prefix="nat-card")
    group = mg.MeshBrokerGroup(make_broker_mesh(2, devices=["cpu"] * 2),
                               mg.MeshGroupConfig(num_user_slots=16,
                                                  ring_slots=8,
                                                  frame_bytes=512,
                                                  extra_lanes=()))
    brokers = []
    for i in range(2):
        ident = cluster._ident(i)
        b = await Broker.new(BrokerConfig(
            run_def=cluster.run_def, keypair=cluster.keypair,
            discovery_endpoint=cluster.db,
            public_advertise_endpoint=ident.public_advertise_endpoint,
            public_bind_endpoint=ident.public_advertise_endpoint,
            private_advertise_endpoint=ident.private_advertise_endpoint,
            private_bind_endpoint=ident.private_advertise_endpoint,
            heartbeat_interval_s=3600, sync_interval_s=3600,
            whitelist_interval_s=3600, form_mesh=False, device="cpu"))
        group.attach(b, i)
        brokers.append(b)
    try:
        for b in brokers:
            with pytest.raises(RuntimeError,
                               match="MeshBrokerGroup on the card"):
                await b.start()
            assert not b._tasks
    finally:
        for b in brokers:
            await b.stop()
