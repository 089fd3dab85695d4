"""In-process "memory" transport for deterministic single-process tests.

Capability parity with cdn-proto/src/connection/protocols/memory.rs:32-204:
listeners live in a process-global registry keyed by endpoint string; a
connect hands one side of a duplex pipe to the listener's accept queue.
This is the seam that lets whole-system integration tests (marshal + brokers
+ clients) run in one process with no sockets (SURVEY.md §4).
"""

from __future__ import annotations

import asyncio
import itertools
import random
from collections import deque
from typing import Dict, Optional, Tuple

from pushcdn_tpu_torch.proto.error import Error, ErrorKind, bail
from pushcdn_tpu_torch.proto.limiter import Limiter, NO_LIMIT
from pushcdn_tpu_torch.proto.transport.base import (
    Connection,
    Listener,
    Protocol,
    RawStream,
    UnfinalizedConnection,
)

_DUPLEX_BUFFER = 8192  # parity: 8192-byte duplex buffers (memory.rs)

# The conformance default stays at the reference's 8 KiB; deployments and
# benches that push large frames through the in-process transport can widen
# it (``Memory.set_duplex_window``) so the window constant — test-infra
# parity, not a behavioral guarantee — doesn't bound throughput.
_duplex_window = _DUPLEX_BUFFER


class _BoundedBuffer:
    """A bounded in-process byte pipe with real backpressure: writers
    block while ``size >= capacity`` (parity with the reference's 8192-byte
    duplex halves — a fast producer cannot grow memory unboundedly).

    Storage is a deque of immutable byte chunks, not a flat bytearray:
    a write appends (at most one copy, from the caller's possibly-reused
    buffer), and ``read_some`` pops a whole chunk with ZERO copies — the
    reader's whole-chunk scan path then parses frames out of that very
    object, so a frame's bytes are copied once end-to-end through the
    in-process transport instead of four times."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity if capacity is not None else _duplex_window
        self._chunks: "deque" = deque()
        self._size = 0
        self._eof = False
        self._cond = asyncio.Condition()

    async def write(self, data) -> None:
        async with self._cond:
            # Chunk so a frame larger than the capacity still flows.
            view = memoryview(data)
            n = len(view)
            off = 0
            while off < n:
                while self._size >= self.capacity and not self._eof:
                    await self._cond.wait()
                if self._eof:
                    raise ConnectionResetError("memory stream closed")
                room = max(self.capacity - self._size, 1)
                piece = bytes(view[off:off + room])  # detach: caller's
                off += len(piece)                    # buffer may be reused
                self._chunks.append(piece)
                self._size += len(piece)
                self._cond.notify_all()

    async def read_exactly(self, n: int) -> bytes:
        # Consume incrementally: n may exceed the buffer capacity (a frame
        # bigger than the duplex window streams through it).
        out = bytearray()
        async with self._cond:
            while len(out) < n:
                if not self._chunks:
                    if self._eof:
                        raise asyncio.IncompleteReadError(bytes(out), n)
                    await self._cond.wait()
                    continue
                head = self._chunks[0]
                take = n - len(out)
                if len(head) <= take:
                    self._chunks.popleft()
                    out += head
                else:
                    out += head[:take]
                    self._chunks[0] = head[take:]
                self._size -= min(take, len(head))
                self._cond.notify_all()
            return bytes(out)

    async def read_some(self, max_n: int) -> bytes:
        async with self._cond:
            while not self._chunks:
                if self._eof:
                    raise asyncio.IncompleteReadError(b"", 1)
                await self._cond.wait()
            head = self._chunks[0]
            if len(head) <= max_n:
                # whole-chunk take: zero copies
                self._chunks.popleft()
                self._size -= len(head)
            else:
                self._chunks[0] = head[max_n:]
                head = head[:max_n]
                self._size -= max_n
            self._cond.notify_all()
            return head

    def set_eof(self) -> None:
        self._eof = True
        # May be called from sync context (abort); schedule the wakeup.
        async def _notify():
            async with self._cond:
                self._cond.notify_all()
        try:
            asyncio.get_running_loop().create_task(_notify())
        except RuntimeError:
            pass


class _PipeStream(RawStream):
    """One side of an in-process duplex over two bounded buffers."""

    def __init__(self, rx: _BoundedBuffer, tx: _BoundedBuffer):
        self._rx = rx
        self._tx = tx
        self._closed = False

    async def read_exactly(self, n: int) -> bytes:
        return await self._rx.read_exactly(n)

    async def read_some(self, max_n: int) -> bytes:
        return await self._rx.read_some(max_n)

    async def write(self, data) -> None:
        if self._closed:
            raise ConnectionResetError("memory stream closed")
        await self._tx.write(data)  # the buffer detaches per chunk itself

    async def close(self) -> None:
        self.abort()

    def abort(self) -> None:
        if not self._closed:
            self._closed = True
            self._tx.set_eof()
            self._rx.set_eof()


def _duplex() -> Tuple[_PipeStream, _PipeStream]:
    ab, ba = _BoundedBuffer(), _BoundedBuffer()
    return _PipeStream(rx=ba, tx=ab), _PipeStream(rx=ab, tx=ba)


class _Registry:
    """Process-global endpoint → listener map (parity: the reference's
    ``OnceLock<RwLock<HashMap<String, ChannelExchange>>>``, memory.rs:32-36)."""

    def __init__(self):
        self.listeners: Dict[str, "MemoryListener"] = {}


_REGISTRY = _Registry()


class _MemoryUnfinalized(UnfinalizedConnection):
    def __init__(self, stream: _PipeStream):
        self._stream = stream

    async def finalize(self, limiter: Limiter = NO_LIMIT) -> Connection:
        return Connection(self._stream, limiter, label="memory")


class MemoryListener(Listener):
    def __init__(self, endpoint: str):
        self.endpoint = endpoint
        self._accept_q: "asyncio.Queue[_PipeStream]" = asyncio.Queue()
        self._closed = False

    async def accept(self) -> UnfinalizedConnection:
        if self._closed:
            bail(ErrorKind.CONNECTION, "listener closed")
        stream = await self._accept_q.get()
        return _MemoryUnfinalized(stream)

    async def close(self) -> None:
        self._closed = True
        _REGISTRY.listeners.pop(self.endpoint, None)


class Memory(Protocol):
    """The in-process transport (parity protocols/memory.rs)."""

    name = "memory"

    @staticmethod
    def set_duplex_window(capacity: int) -> int:
        """Set the duplex-buffer capacity used by subsequently-created
        connections; returns the previous value. 8192 (the reference
        constant) is the default."""
        global _duplex_window
        prev = _duplex_window
        _duplex_window = capacity
        return prev

    @classmethod
    async def connect(cls, endpoint: str, use_local_authority: bool = True,
                      limiter: Limiter = NO_LIMIT) -> Connection:
        listener = _REGISTRY.listeners.get(endpoint)
        if listener is None or listener._closed:
            bail(ErrorKind.CONNECTION, f"no memory listener bound at {endpoint!r}")
        ours, theirs = _duplex()
        await listener._accept_q.put(theirs)
        return Connection(ours, limiter, label=f"memory:{endpoint}")

    @classmethod
    async def bind(cls, endpoint: str, certificate=None,
                   reuse_port: bool = False) -> Listener:
        if reuse_port:
            bail(ErrorKind.CONNECTION,
                 "memory transport has no kernel socket to SO_REUSEPORT")
        if endpoint in _REGISTRY.listeners:
            bail(ErrorKind.CONNECTION, f"memory endpoint {endpoint!r} already bound")
        listener = MemoryListener(endpoint)
        _REGISTRY.listeners[endpoint] = listener
        return listener


# -- geo-shaped links (ISSUE 11) ---------------------------------------
#
# Consensus-shaped workloads need WAN-ish links between in-process nodes:
# propagation delay, jitter, and loss. The memory transport is a reliable
# ordered stream (like the QUIC transport above it), so "loss" is modeled
# the way a reliable stream experiences it — a retransmit (RTO) delay
# penalty on the affected chunk, never a dropped or reordered byte.
# Delivery times are monotone per direction (a delayed chunk delays
# everything behind it), so stream ordering is preserved by construction.


class LinkShape:
    """One direction's shaping parameters. ``latency_s`` is the one-way
    propagation delay, ``jitter_s`` a uniform [0, jitter) addition,
    ``loss`` the per-chunk probability of a modeled retransmit costing
    ``rto_s`` extra. ``seed`` makes every connection's delay sequence
    deterministic."""

    __slots__ = ("latency_s", "jitter_s", "loss", "rto_s", "seed")

    def __init__(self, latency_s: float = 0.0, jitter_s: float = 0.0,
                 loss: float = 0.0, rto_s: float = 0.05, seed: int = 0):
        self.latency_s = latency_s
        self.jitter_s = jitter_s
        self.loss = loss
        self.rto_s = rto_s
        self.seed = seed

    def __repr__(self):
        return (f"LinkShape(latency_s={self.latency_s}, "
                f"jitter_s={self.jitter_s}, loss={self.loss}, "
                f"rto_s={self.rto_s}, seed={self.seed})")


class _ShapedStream(RawStream):
    """Write-side shaping wrapper: each written chunk is released into the
    underlying pipe at ``max(prev_release, now + delay)`` by a pump task —
    pipelined (a burst pays the latency once, not per chunk) and ordered
    (release times are monotone)."""

    def __init__(self, inner: _PipeStream, shape: LinkShape,
                 rng: random.Random):
        self._inner = inner
        self._shape = shape
        self._rng = rng
        self._q: "asyncio.Queue" = asyncio.Queue(maxsize=64)
        self._pump_task = None
        self._release_at = 0.0
        self._closed = False

    async def read_exactly(self, n: int) -> bytes:
        return await self._inner.read_exactly(n)

    async def read_some(self, max_n: int) -> bytes:
        return await self._inner.read_some(max_n)

    async def write(self, data) -> None:
        if self._closed:
            raise ConnectionResetError("memory stream closed")
        loop = asyncio.get_running_loop()
        if self._pump_task is None:
            self._pump_task = loop.create_task(self._pump())
        sh = self._shape
        delay = sh.latency_s
        if sh.jitter_s:
            delay += self._rng.random() * sh.jitter_s
        if sh.loss and self._rng.random() < sh.loss:
            delay += sh.rto_s  # modeled retransmit on a reliable stream
        release = max(self._release_at, loop.time() + delay)
        self._release_at = release
        # detach now: the deferred write outlives the caller's buffer
        await self._q.put((release, bytes(data)))

    async def _pump(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                release, data = await self._q.get()
                dt = release - loop.time()
                if dt > 0:
                    await asyncio.sleep(dt)
                await self._inner.write(data)
                self._q.task_done()
        except (ConnectionResetError, asyncio.CancelledError):
            pass

    async def close(self) -> None:
        # let queued (in-flight) chunks land before tearing the pipe down
        if self._pump_task is not None and not self._closed:
            try:
                await asyncio.wait_for(self._q.join(), timeout=5.0)
            except asyncio.TimeoutError:
                pass
        self.abort()

    def abort(self) -> None:
        if not self._closed:
            self._closed = True
            if self._pump_task is not None:
                self._pump_task.cancel()
            self._inner.abort()


_shaped_conn_counter = itertools.count()


def shaped_memory(shape: LinkShape) -> type:
    """A :class:`Memory` subclass whose connections traverse ``shape`` in
    BOTH directions. Pass it as ``ClientConfig.protocol`` so every
    (re)connect of that client stays shaped — per-client geography, no
    global state. Listeners bound via the plain :class:`Memory` accept
    shaped peers transparently (the shaping rides the connecting side's
    stream pair)."""

    link_shape = shape

    class ShapedMemory(Memory):
        name = f"memory+shaped({shape.latency_s * 1e3:g}ms)"
        _shape = link_shape

        @classmethod
        async def connect(cls, endpoint: str, use_local_authority: bool = True,
                          limiter: Limiter = NO_LIMIT) -> Connection:
            listener = _REGISTRY.listeners.get(endpoint)
            if listener is None or listener._closed:
                bail(ErrorKind.CONNECTION,
                     f"no memory listener bound at {endpoint!r}")
            n = next(_shaped_conn_counter)
            ours, theirs = _duplex()
            # independent deterministic streams per direction
            rng_c2s = random.Random((link_shape.seed << 21) ^ (2 * n))
            rng_s2c = random.Random((link_shape.seed << 21) ^ (2 * n + 1))
            await listener._accept_q.put(
                _ShapedStream(theirs, link_shape, rng_s2c))
            return Connection(_ShapedStream(ours, link_shape, rng_c2s),
                              limiter, label=f"memory+shaped:{endpoint}")

    return ShapedMemory


async def gen_testing_connection_pair(limiter: Limiter = NO_LIMIT
                                      ) -> Tuple[Connection, Connection]:
    """Directly build a connected pair (parity ``gen_testing_connection``,
    memory.rs — used heavily by the broker injection harness)."""
    a, b = _duplex()
    return Connection(a, limiter, "memory:a"), Connection(b, limiter, "memory:b")
