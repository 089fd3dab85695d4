"""The port's shared-memory handoff ring held against the JAX package's.

The twins of ``tests/test_shardring.py``: every scenario runs once on
``pushcdn_tpu_torch.broker.shardring`` (and ``sharding``) and once on the
JAX package's modules, with the reference's assertions on each, and the
two runs must leave the same transcript: what was drained, the counters,
and the ring's shared memory byte for byte. Then the cross-package cases:
a record one package's ``RingWriter`` pushes is read back by the other
package's ``RingReader`` byte for byte, in both directions, through
wraparound, a padded record, a permuted index span, and the torn-write
and poison flags.

Every ring a case creates is unlinked before it ends (a leaked segment
makes the resource tracker warn at exit).
"""

import contextlib
import importlib
import struct
from types import SimpleNamespace

import numpy as np
import pytest

ROOTS = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}


def _pkg(name: str) -> SimpleNamespace:
    root = ROOTS[name]
    return SimpleNamespace(
        name=name,
        sr=importlib.import_module(f"{root}.broker.shardring"),
        sharding=importlib.import_module(f"{root}.broker.sharding"))


JAX, PORT = _pkg("jax"), _pkg("port")
PKGS = (PORT, JAX)


@contextlib.contextmanager
def _ring(sr, capacity: int = 16 * 1024, notify_sock=None):
    """(writer, reader, shm name) on a fresh ring of ``sr``'s package."""
    name = sr.create_ring(capacity)
    w = sr.RingWriter(name, capacity, notify_sock=notify_sock)
    r = sr.RingReader(name, capacity)
    try:
        yield w, r, name
    finally:
        w.close()
        r.close()
        sr.unlink_ring(name)


def _memory(ring) -> bytes:
    return bytes(ring.buf)


def _twin(scenario):
    """Run ``scenario(p)`` on the port and on JAX; the transcripts must
    agree. Returns the port's."""
    port, jax = (scenario(p) for p in PKGS)
    assert port == jax
    return port


# ---------------------------------------------------------------------------
# the twins of tests/test_shardring.py
# ---------------------------------------------------------------------------

def test_roundtrip_frames_and_peers():
    def scenario(p):
        sr = p.sr
        with _ring(sr) as (w, r, _):
            assert w.try_push([b"alpha", b"bravo!"],
                              [(sr.KIND_USER, b"user-1", [0, 1]),
                               (sr.KIND_BROKER, b"pub:1/priv:1", [1])])
            recs = r.drain()
            assert len(recs) == 1
            rec = recs[0]
            assert rec.peers == [(sr.KIND_USER, b"user-1", [0, 1]),
                                 (sr.KIND_BROKER, b"pub:1/priv:1", [1])]
            both = rec.stream_for([0, 1])
            assert bytes(both) == \
                b"\x00\x00\x00\x05alpha\x00\x00\x00\x06bravo!"
            assert bytes(rec.stream_for([1])) == b"\x00\x00\x00\x06bravo!"
            # contiguous index run -> zero-copy view of the shm payload
            assert isinstance(both, memoryview)
            out = (rec.peers, bytes(both), _memory(w))
            both.release()
            rec.release()
            assert r.tail == r.head
            return out
    _twin(scenario)


def test_prefixed_frames_copied_verbatim():
    def scenario(p):
        sr = p.sr
        with _ring(sr) as (w, r, _):
            wire = b"\x00\x00\x00\x03abc"
            assert w.try_push([wire], [(sr.KIND_USER, b"u", [0])],
                              prefixed=True)
            rec = r.drain()[0]
            got = bytes(rec.stream_for([0]))
            assert got == wire
            rec.release()
            return got, _memory(w)
    _twin(scenario)


def test_non_contiguous_index_gathers():
    def scenario(p):
        sr = p.sr
        with _ring(sr) as (w, r, _):
            assert w.try_push([b"a", b"b", b"c"],
                              [(sr.KIND_USER, b"u", [0, 2])])
            rec = r.drain()[0]
            data = rec.stream_for([0, 2])
            assert not isinstance(data, memoryview)
            assert bytes(data) == b"\x00\x00\x00\x01a\x00\x00\x00\x01c"
            rec.release()
            return bytes(data), _memory(w)
    _twin(scenario)


def test_permuted_index_span_gathers_in_idx_order():
    """A same-span permutation (a peer sharing frames first indexed by an
    earlier peer) gathers in idx order, not table order."""
    def scenario(p):
        sr = p.sr
        with _ring(sr) as (w, r, _):
            assert w.try_push([b"f0", b"f1", b"f2", b"f3"],
                              [(sr.KIND_USER, b"a", [0, 1]),
                               (sr.KIND_USER, b"b", [0, 2, 1, 3])])
            rec = r.drain()[0]
            data = rec.stream_for([0, 2, 1, 3])
            assert not isinstance(data, memoryview)
            assert bytes(data) == (b"\x00\x00\x00\x02f0\x00\x00\x00\x02f2"
                                   b"\x00\x00\x00\x02f1\x00\x00\x00\x02f3")
            run = rec.stream_for([0, 1])
            assert isinstance(run, memoryview)
            out = (bytes(data), bytes(run))
            run.release()
            rec.release()
            return out
    _twin(scenario)


def test_poisoned_ring_rejects_pushes():
    def scenario(p):
        sr = p.sr
        with _ring(sr) as (w, r, _):
            assert w.try_push([b"a"], [(sr.KIND_USER, b"u", [0])])
            r.poison()
            assert w.poisoned
            dropped = w.dropped
            assert not w.try_push([b"b"], [(sr.KIND_USER, b"u", [0])])
            assert w.dropped == dropped + 1
            return w.dropped, _memory(w)
    _twin(scenario)


def test_poison_landing_mid_push_reports_failure():
    """The producer re-checks the poison flag after committing: a record
    the consumer abandoned mid-push is reported failed, not counted."""
    def scenario(p):
        sr = p.sr
        with _ring(sr) as (w, r, _):
            checks = []

            class _MidPushPoisoned(type(w)):
                @property
                def poisoned(self):
                    checks.append(1)
                    return len(checks) > 1

            w.__class__ = _MidPushPoisoned
            assert not w.try_push([b"x"], [(sr.KIND_USER, b"u", [0])])
            assert w.dropped == 1
            assert w.records_pushed == 0
            return len(checks), w.dropped
    _twin(scenario)


def test_wraparound_many_records():
    """Thousands of seeded pushes through a small ring: every record
    survives the wrap (PAD records at the boundary) and the ring fully
    reclaims."""
    def scenario(p):
        sr = p.sr
        rng = np.random.default_rng(11)
        sent, got = [], []
        with _ring(sr) as (w, r, _):
            for i in range(3000):
                payload = bytes(rng.integers(0, 256, int(rng.integers(1, 900)),
                                             dtype=np.uint8))
                while not w.try_push([payload], [(sr.KIND_USER, b"u", [0])]):
                    recs = r.drain(8)
                    assert recs, "ring full but nothing drainable"
                    for rec in recs:
                        got.append(bytes(rec.stream_for([0]))[4:])
                        rec.release()
                sent.append(payload)
                if (i + 1) % 7 == 0:
                    for rec in r.drain(3):
                        got.append(bytes(rec.stream_for([0]))[4:])
                        rec.release()
            for rec in r.drain(100000):
                got.append(bytes(rec.stream_for([0]))[4:])
                rec.release()
            assert got == sent
            assert r.tail == r.head
            assert r.torn_reads == 0
            return w.dropped, r.head, r.records_drained, _memory(w)
    _twin(scenario)


def test_ring_full_counts_drops():
    def scenario(p):
        sr = p.sr
        with _ring(sr) as (w, r, _):
            big = b"z" * 5000
            pushed = 0
            while w.try_push([big], [(sr.KIND_USER, b"u", [0])]):
                pushed += 1
            assert pushed >= 2
            assert w.dropped == 1
            assert not w.try_push([big], [(sr.KIND_USER, b"u", [0])])
            assert w.dropped == 2
            for rec in r.drain(100):
                rec.release()
            assert w.try_push([big], [(sr.KIND_USER, b"u", [0])])
            return pushed, w.dropped, _memory(w)
    _twin(scenario)


def test_torn_write_detected_and_recovered():
    """A record whose commit word has not landed stops the drain and is
    counted; once the commit appears the record drains."""
    def scenario(p):
        sr = p.sr
        with _ring(sr) as (w, r, _):
            assert w.try_push([b"first"], [(sr.KIND_USER, b"u", [0])])
            pos = sr.HEADER_BYTES + (r._cursor % r.capacity)
            saved = bytes(r.buf[pos + 4:pos + 8])
            r.buf[pos + 4:pos + 8] = b"\x00\x00\x00\x00"
            assert r.drain() == []
            assert r.torn_reads == 1
            assert r.drain() == []
            assert r.torn_reads == 2
            r.buf[pos + 4:pos + 8] = saved
            recs = r.drain()
            assert len(recs) == 1
            got = bytes(recs[0].stream_for([0]))
            assert got == b"\x00\x00\x00\x05first"
            recs[0].release()
            return got, r.torn_reads
    _twin(scenario)


def test_corrupt_length_detected():
    def scenario(p):
        sr = p.sr
        with _ring(sr) as (w, r, _):
            assert w.try_push([b"x"], [(sr.KIND_USER, b"u", [0])])
            pos = sr.HEADER_BYTES + (r._cursor % r.capacity)
            r.buf[pos:pos + 4] = struct.pack("<I", r.capacity + 8)
            assert r.drain() == []
            assert r.torn_reads == 1
            return r.torn_reads
    _twin(scenario)


def test_lease_pins_slot_until_last_holder_drops():
    """Reclamation is in order and waits for every pending flush's lease
    (the ``PreEncoded.owner`` contract)."""
    def scenario(p):
        sr = p.sr
        with _ring(sr) as (w, r, _):
            assert w.try_push([b"one"], [(sr.KIND_USER, b"u", [0])])
            assert w.try_push([b"two"], [(sr.KIND_USER, b"u", [0])])
            rec1, rec2 = r.drain()
            lease1 = rec1.lease()
            rec1.release()
            rec2.release()
            assert r.tail == 0
            del lease1
            assert r.tail == r.head
            return r.tail
    _twin(scenario)


def test_notify_socket_signals_every_push():
    def scenario(p):
        sr = p.sr
        rx, tx = sr.notify_pair()
        try:
            with _ring(sr, 8192, notify_sock=tx) as (w, r, _):
                wakes = []
                assert w.try_push([b"a"], [(sr.KIND_USER, b"u", [0])])
                wakes.append(rx.recv(16))
                assert w.try_push([b"b"], [(sr.KIND_USER, b"u", [0])])
                wakes.append(rx.recv(16))
                with pytest.raises(BlockingIOError):
                    rx.recv(16)
                for rec in r.drain():
                    rec.release()
                assert w.try_push([b"c"], [(sr.KIND_USER, b"u", [0])])
                wakes.append(rx.recv(16))
                assert wakes == [b"\x01"] * 3
                return wakes
        finally:
            rx.close()
            tx.close()
    _twin(scenario)


async def test_runtime_ring_full_falls_back_to_relay():
    """Ring full: the handoff relays through the control plane (counted)
    and stays on the relay until the consumer drains and acks; past the
    relay budget a handoff is shed with a counter."""
    def scenario(p):
        sr = p.sr

        class _Conns:
            num_shards = 2
            shard_id = 0
            shard_notifier = None

        class _Broker:
            connections = _Conns()

        relayed = []

        class _Bus:
            def publish(self, origin, event):
                relayed.append((origin, event))

        name = sr.create_ring(4096)
        rx, tx = sr.notify_pair()
        try:
            w = sr.RingWriter(name, 4096, notify_sock=tx)
            rt = p.sharding.ShardRuntime(_Broker(), 0, 2, {1: w}, {}, None)
            rt.set_bus(_Bus())
            big = b"q" * 1200
            n_ring = 0
            while True:
                before = rt.relay_fallbacks
                rt.handoff(1, [big], [(sr.KIND_USER, b"u", [0])])
                if rt.relay_fallbacks > before:
                    break
                n_ring += 1
            assert n_ring >= 1
            assert w.dropped == 1
            assert len(relayed) == 1
            origin, event = relayed[0]
            assert event[0] == "relay" and event[1] == 1
            kind, ident, stream, n = event[2][0]
            assert (kind, ident, n) == (sr.KIND_USER, b"u", 1)
            assert stream == len(big).to_bytes(4, "big") + big
            rt.handoff(1, [b"tail"], [(sr.KIND_USER, b"u", [0])])
            assert len(relayed) == 2
            r = sr.RingReader(name, 4096)
            for rec in r.drain(1000):
                rec.release()
            rt.apply_event(1, ("relay_ack", 0, rt._relay_epoch[1]))
            assert not rt._relay_unacked[1]
            before = rt.relay_fallbacks
            rt.handoff(1, [b"back"], [(sr.KIND_USER, b"u", [0])])
            assert rt.relay_fallbacks == before
            while w.try_push([big], [(sr.KIND_USER, b"u", [0])]):
                pass
            rt._RELAY_MAX_BYTES = 2000
            rt.handoff(1, [big], [(sr.KIND_USER, b"u", [0])])
            shed_before = rt.relay_shed
            rt.handoff(1, [big], [(sr.KIND_USER, b"u", [0])])
            assert rt.relay_shed == shed_before + 1
            out = (n_ring, relayed, rt.relay_fallbacks, rt.relay_shed,
                   w.dropped)
            r.close()
            w.close()
            return out
        finally:
            rx.close()
            tx.close()
            sr.unlink_ring(name)
    _twin(scenario)


def test_inject_shard_label_handles_spaced_label_values():
    text = ("# HELP cdn_x help text\n"
            'cdn_x{path="GET /metrics",code="200"} 3\n'
            "cdn_plain 1\n"
            "cdn_empty{} 2")
    out = PORT.sharding._inject_shard_label(text, 1)
    assert out == JAX.sharding._inject_shard_label(text, 1)
    assert out.splitlines() == [
        "# HELP cdn_x help text",
        'cdn_x{shard="1",path="GET /metrics",code="200"} 3',
        'cdn_plain{shard="1"} 1',
        'cdn_empty{shard="1"} 2']


def test_hub_send_disconnects_wedged_worker():
    """A worker that stops draining its control socket is cut loose
    (aborted, not closed) once its buffered hub traffic passes
    ``HUB_MAX_BUFFER``."""
    def scenario(p):
        sharding = p.sharding

        class _Transport:
            def __init__(self, size):
                self._size = size
                self.aborted = False

            def get_write_buffer_size(self):
                return self._size

            def abort(self):
                self.aborted = True

        class _Writer:
            def __init__(self, buffered):
                self.transport = _Transport(buffered)
                self.frames = []

            def write(self, frame):
                self.frames.append(frame)

        sup = sharding.ShardSupervisor.__new__(sharding.ShardSupervisor)
        sup.hub_disconnects = 0
        sup._hub_buffer_cap = sharding.HUB_MAX_BUFFER
        healthy = _Writer(0)
        wedged = _Writer(sharding.HUB_MAX_BUFFER)
        writers = {0: healthy, 1: wedged}
        sup._hub_send(writers, 0, b"delta")
        sup._hub_send(writers, 1, b"delta")
        assert healthy.frames == [b"delta"]
        assert wedged.frames == [] and wedged.transport.aborted
        assert 1 not in writers and 0 in writers
        assert sup.hub_disconnects == 1
        sup._hub_send(writers, 1, b"delta")
        return healthy.frames, sorted(writers), sup.hub_disconnects
    _twin(scenario)


def test_layout_constants_match():
    for attr in ("HEADER_BYTES", "COMMIT_FLAG", "PAD_MAGIC", "KIND_USER",
                 "KIND_BROKER", "DEFAULT_CAPACITY"):
        assert getattr(PORT.sr, attr) == getattr(JAX.sr, attr), attr
    for attr in ("_HDR", "_REC", "_BODY", "_FRAME", "_PEER"):
        assert getattr(PORT.sr, attr).format == \
            getattr(JAX.sr, attr).format, attr


# ---------------------------------------------------------------------------
# across the packages: one writes, the other reads
# ---------------------------------------------------------------------------

DIRECTIONS = {"port-writes-jax-reads": (PORT, JAX),
              "jax-writes-port-reads": (JAX, PORT)}


@contextlib.contextmanager
def _cross(writer_pkg, reader_pkg, capacity: int = 16 * 1024):
    name = writer_pkg.sr.create_ring(capacity)
    w = writer_pkg.sr.RingWriter(name, capacity)
    r = reader_pkg.sr.RingReader(name, capacity)
    try:
        yield w, r
    finally:
        w.close()
        r.close()
        writer_pkg.sr.unlink_ring(name)


def _read_all(r, peers_idx):
    out = []
    for rec in r.drain(100000):
        out.append((rec.peers,
                    [bytes(rec.stream_for(idx)) for idx in peers_idx(rec)]))
        rec.release()
    return out


def _expected_stream(frames, idx, prefixed=False):
    if prefixed:
        return b"".join(frames[i] for i in idx)
    return b"".join(len(frames[i]).to_bytes(4, "big") + frames[i]
                    for i in idx)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_cross_roundtrip_byte_for_byte(direction):
    """One record with two peers: the reader sees the writer's peers and
    streams, and the ring's memory equals what a same-package writer
    leaves."""
    wp, rp = DIRECTIONS[direction]
    frames = [b"alpha", b"bravo!", b"c" * 300]
    peers = [(0, b"user-1", [0, 1, 2]), (1, b"pub:1/priv:1", [2])]
    with _cross(wp, rp) as (w, r):
        assert w.try_push(frames, peers)
        mem = _memory(w)
        got = _read_all(r, lambda rec: [idx for _k, _i, idx in rec.peers])
        assert r.tail == r.head
    with _cross(rp, rp) as (w2, _r2):
        assert w2.try_push(frames, peers)
        assert _memory(w2) == mem
    assert got == [(peers, [_expected_stream(frames, idx)
                            for _k, _i, idx in peers])]


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_cross_wraparound(direction):
    """Seeded records of every size through a small ring, drained in
    uneven batches: the reader gets every payload in order across the
    wrap, and reclaims fully."""
    wp, rp = DIRECTIONS[direction]
    rng = np.random.default_rng(23)
    sent, got = [], []
    with _cross(wp, rp, 8192) as (w, r):
        for i in range(1500):
            payload = bytes(rng.integers(0, 256, int(rng.integers(1, 700)),
                                         dtype=np.uint8))
            while not w.try_push([payload], [(0, b"u", [0])]):
                recs = r.drain(5)
                assert recs
                for rec in recs:
                    got.append(bytes(rec.stream_for([0]))[4:])
                    rec.release()
            sent.append(payload)
            if i % 5 == 0:
                for rec in r.drain(2):
                    got.append(bytes(rec.stream_for([0]))[4:])
                    rec.release()
        for rec in r.drain(100000):
            got.append(bytes(rec.stream_for([0]))[4:])
            rec.release()
        assert got == sent
        assert r.tail == r.head and r.torn_reads == 0
        assert w.head > 4 * w.capacity  # it wrapped several times


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_cross_padded_record(direction):
    """A record that does not fit before the end of the data region is
    preceded by a PAD record: the reader skips the pad and reads the
    record from offset 0."""
    wp, rp = DIRECTIONS[direction]
    cap = 4096
    with _cross(wp, rp, cap) as (w, r):
        first = b"a" * 2500
        assert w.try_push([first], [(0, b"u", [0])])
        for rec in r.drain():
            rec.release()
        second = b"b" * 2000  # needs more than the 1.5 KiB left at the end
        assert w.try_push([second], [(1, b"p:1/q:1", [0])], prefixed=False)
        pos = r._cursor % cap
        total, commit = struct.unpack_from("<II", r.buf,
                                           rp.sr.HEADER_BYTES + pos)
        assert commit == rp.sr.PAD_MAGIC and total == cap - pos
        recs = r.drain()
        assert len(recs) == 1
        assert recs[0].peers == [(1, b"p:1/q:1", [0])]
        assert bytes(recs[0].stream_for([0])) == \
            len(second).to_bytes(4, "big") + second
        recs[0].release()
        assert r.tail == r.head == w.head
        assert r._cursor % cap != 0  # the record itself sat at offset 0


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_cross_prefixed_and_permuted_span(direction):
    """Already-framed slices copied verbatim, and a permuted index span
    gathered in idx order on the other side."""
    wp, rp = DIRECTIONS[direction]
    raw = [b"f0", b"f1", b"f2", b"f3"]
    wire = [len(f).to_bytes(4, "big") + f for f in raw]
    peers = [(0, b"a", [0, 1]), (0, b"b", [0, 2, 1, 3]), (1, b"c", [3])]
    with _cross(wp, rp) as (w, r):
        assert w.try_push(wire, peers, prefixed=True)
        rec = r.drain()[0]
        assert rec.peers == peers
        permuted = rec.stream_for([0, 2, 1, 3])
        assert not isinstance(permuted, memoryview)
        assert bytes(permuted) == _expected_stream(wire, [0, 2, 1, 3], True)
        run = rec.stream_for([0, 1])
        assert isinstance(run, memoryview)
        assert bytes(run) == wire[0] + wire[1]
        run.release()
        rec.release()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_cross_torn_write_flag(direction):
    """The reader of one package backs off a record whose commit word the
    other package's writer has not stored, and reads it once stored."""
    wp, rp = DIRECTIONS[direction]
    with _cross(wp, rp) as (w, r):
        assert w.try_push([b"first"], [(0, b"u", [0])])
        pos = rp.sr.HEADER_BYTES + (r._cursor % r.capacity)
        saved = bytes(r.buf[pos + 4:pos + 8])
        assert int.from_bytes(saved, "little") & rp.sr.COMMIT_FLAG
        r.buf[pos + 4:pos + 8] = b"\x00\x00\x00\x00"
        assert r.drain() == [] and r.torn_reads == 1
        r.buf[pos + 4:pos + 8] = saved
        recs = r.drain()
        assert [bytes(rec.stream_for([0])) for rec in recs] == \
            [b"\x00\x00\x00\x05first"]
        recs[0].release()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_cross_poison_flag(direction):
    """A reader that abandons the ring poisons the header: the other
    package's writer refuses further pushes and counts each."""
    wp, rp = DIRECTIONS[direction]
    with _cross(wp, rp) as (w, r):
        assert w.try_push([b"a"], [(0, b"u", [0])])
        r.poison()
        assert w.poisoned
        assert not w.try_push([b"b"], [(0, b"u", [0])])
        assert w.dropped == 1 and r.dropped == 1
        assert w.records_pushed == 1
