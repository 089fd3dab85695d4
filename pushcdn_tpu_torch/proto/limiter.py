"""Flow control: a global byte-denominated memory pool with RAII-style
permits attached to message buffers, plus optional per-connection queue
depth bounds.

Capability parity with the reference's limiter
(cdn-proto/src/connection/limiter/mod.rs:15-75, limiter/pool.rs:28-111):

- The pool is a semaphore denominated in *bytes*. A connection's reader task
  acquires ``len(message)`` permits **before** allocating the receive buffer
  (protocols/mod.rs:328), so many large in-flight messages cannot OOM the
  broker ("block the reader, not the router").
- The permit is attached to the decoded byte buffer (``Bytes``) and released
  only when the **last clone** drops — i.e. after broadcast fan-out to every
  recipient queue has completed (pool.rs:7-14, :85-111).
- Permit-lifetime (allocation → final release) is the reference's latency
  proxy metric (pool.rs:44-52); we record it the same way.

TPU lowering note: on the device data plane the analog of this pool is a
fixed ring of HBM frame slots — credit accounting over slots instead of
bytes (see pushcdn_tpu_torch.parallel.frames.FrameRing).
"""

from __future__ import annotations

import asyncio
import time
import weakref
from typing import Optional

from pushcdn_tpu_torch.proto.error import ErrorKind, bail

# Live pools, for the metrics pre-render occupancy gauge
# (cdn_pool_bytes{state=...}); weak so a dropped Limiter's pool vanishes.
LIVE_POOLS: "weakref.WeakSet[MemoryPool]" = weakref.WeakSet()


class _ByteSemaphore:
    """An asyncio semaphore that acquires/releases in arbitrary byte counts.

    ``asyncio.Semaphore`` only steps by 1; we need `acquire(n_bytes)` with
    FIFO fairness so one huge frame can't be starved by streams of small
    ones (parity with tokio's `Semaphore::acquire_many` used at
    pool.rs:60-68).
    """

    def __init__(self, capacity: int):
        self._capacity = capacity
        self._available = capacity
        self._wait_list: list[tuple[int, asyncio.Future]] = []

    async def acquire(self, n: int) -> None:
        if n <= self._available and not self._wait_list:
            self._available -= n
            return
        fut = asyncio.get_running_loop().create_future()
        self._wait_list.append((n, fut))
        try:
            await fut
        except asyncio.CancelledError:
            if (n, fut) in self._wait_list:
                self._wait_list.remove((n, fut))
            elif fut.done() and not fut.cancelled():
                # Woken and cancelled concurrently: hand the grant back.
                self.release(n)
            raise

    def try_acquire(self, n: int) -> bool:
        """Synchronous fast path: take ``n`` without suspending, or return
        False when the acquisition would have to wait. FIFO fairness is the
        same invariant ``acquire`` keeps — never jump an existing waiter."""
        if self._wait_list or n > self._available:
            return False
        self._available -= n
        return True

    def release(self, n: int) -> None:
        self._available += n
        self._wake()

    def _wake(self) -> None:
        # FIFO: only the head waiter may proceed (prevents small-frame
        # starvation of a large waiter).
        while self._wait_list:
            n, fut = self._wait_list[0]
            if fut.cancelled():
                self._wait_list.pop(0)
                continue
            if n > self._available:
                break
            self._wait_list.pop(0)
            self._available -= n
            fut.set_result(None)

    @property
    def available(self) -> int:
        return self._available


class AllocationPermit:
    """A byte reservation in a :class:`MemoryPool`; release exactly once.

    Python has no deterministic drop, so release is explicit (the last
    ``Bytes`` clone releases it) with a GC backstop. Records the
    allocation-lifetime latency sample on release (parity pool.rs:44-52).
    """

    __slots__ = ("_pool", "nbytes", "_released", "_t_alloc", "__weakref__")

    def __init__(self, pool: "MemoryPool", nbytes: int):
        self._pool = pool
        self.nbytes = nbytes
        self._released = False
        self._t_alloc = time.monotonic()

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._pool._on_release(self.nbytes, time.monotonic() - self._t_alloc)

    def __del__(self):  # GC backstop only
        try:
            self.release()
        except Exception:
            pass


class Bytes:
    """A refcounted message buffer carrying its pool permit.

    Parity: ``Allocation<Vec<u8>>`` aka ``Bytes``
    (cdn-proto/src/connection/mod.rs:19, pool.rs:85-111) — cloned per
    recipient during fan-out with **no copy** of the underlying buffer; the
    permit returns to the pool when the last clone is released.
    """

    __slots__ = ("data", "_permit", "_refs")

    def __init__(self, data, permit: Optional[AllocationPermit] = None):
        self.data = data  # bytes or memoryview
        self._permit = permit
        self._refs = [1]  # shared mutable refcount across clones

    def clone(self) -> "Bytes":
        self._refs[0] += 1
        b = Bytes.__new__(Bytes)
        b.data = self.data
        b._permit = self._permit
        b._refs = self._refs
        return b

    def release(self) -> None:
        self._refs[0] -= 1
        if self._refs[0] == 0 and self._permit is not None:
            self._permit.release()

    def __len__(self) -> int:
        return len(self.data)

    def __bytes__(self) -> bytes:
        return bytes(self.data)


class BytesLease:
    """Batch-wise permit transfer: holds ONE clone reference of a
    :class:`Bytes` until this object is garbage-collected.

    The cut-through routing plane hands whole-chunk byte ranges to
    connection writers as zero-copy views (``PreEncoded.data``); the
    chunk's single pool permit must outlive every pending flush that
    still reads its buffer. A lease rides each writer entry's ``owner``
    seat, so the permit releases when the LAST flush (or queue drain)
    drops its entry — the chunk-granular analog of the per-frame
    ``Bytes.clone()`` fan-out accounting.
    """

    __slots__ = ("_b",)

    def __init__(self, b: "Bytes"):
        self._b = b.clone()

    def __del__(self):
        b, self._b = self._b, None
        if b is not None:
            try:
                b.release()
            except Exception:
                pass


class MemoryPool:
    """Global byte budget for in-flight message buffers.

    Parity: ``MemoryPool`` (pool.rs:28-68). Broker default is 1 GiB
    (cdn-broker/src/binaries/broker.rs:67-72).
    """

    def __init__(self, capacity_bytes: int):
        if capacity_bytes <= 0:
            bail(ErrorKind.PARSE, "memory pool capacity must be positive")
        self.capacity = capacity_bytes
        self._sem = _ByteSemaphore(capacity_bytes)
        # latency proxy: permit alloc→release lifetimes (metrics hook)
        self.latency_samples: list[float] = []
        self._latency_cap = 4096
        # pressure hooks (durable-topic retention, ISSUE 14): callables
        # fn(deficit_bytes) invoked synchronously when an allocation is
        # about to wait — a holder of idle permits (retention leases) can
        # give them back so a blocked reader never deadlocks against
        # passively-held reservations
        self._reclaimers: list = []
        LIVE_POOLS.add(self)

    def add_reclaimer(self, fn) -> None:
        self._reclaimers.append(fn)

    def remove_reclaimer(self, fn) -> None:
        try:
            self._reclaimers.remove(fn)
        except ValueError:
            pass

    def _run_reclaimers(self, deficit: int) -> None:
        for fn in list(self._reclaimers):
            try:
                fn(deficit)
            except Exception:  # a broken hook must not wedge the reader
                pass
            if self._sem.available >= deficit >= 0:
                break

    async def allocate(self, nbytes: int) -> AllocationPermit:
        """Reserve ``nbytes``; blocks (backpressuring the reader) until the
        pool has room. A single message larger than the whole pool is an
        error rather than a deadlock."""
        if nbytes > self.capacity:
            bail(ErrorKind.EXCEEDED_SIZE,
                 f"message of {nbytes} B exceeds pool capacity {self.capacity} B")
        if self._sem.try_acquire(nbytes):
            return AllocationPermit(self, nbytes)
        # about to wait: let passive permit holders (retention) release
        # before the reader blocks — "block the reader, not the router"
        # must never become "wedge the reader behind idle leases"
        if self._reclaimers:
            self._run_reclaimers(nbytes)
        await self._sem.acquire(nbytes)
        return AllocationPermit(self, nbytes)

    def try_allocate(self, nbytes: int) -> Optional[AllocationPermit]:
        """Synchronous fast path: reserve ``nbytes`` without suspending, or
        return None when the reservation would have to wait (FIFO fairness
        preserved: never jumps an existing waiter). The reader's batch scan
        uses this so the common non-backpressured case costs no awaits."""
        if nbytes > self.capacity:
            bail(ErrorKind.EXCEEDED_SIZE,
                 f"message of {nbytes} B exceeds pool capacity {self.capacity} B")
        if not self._sem.try_acquire(nbytes):
            return None
        return AllocationPermit(self, nbytes)

    def _on_release(self, nbytes: int, lifetime_s: float) -> None:
        self._sem.release(nbytes)
        if len(self.latency_samples) < self._latency_cap:
            self.latency_samples.append(lifetime_s)

    @property
    def available(self) -> int:
        return self._sem.available


class Limiter:
    """Bundle of the global pool + optional per-connection queue bound.

    Parity: ``Limiter`` (limiter/mod.rs:15-21): global byte pool shared by
    every connection, plus an optional bound on each connection's channel
    depth (applied by the transport when building queues,
    protocols/mod.rs:149-153).
    """

    def __init__(self, global_pool_bytes: Optional[int] = None,
                 per_connection_queue: Optional[int] = None):
        self.pool = MemoryPool(global_pool_bytes) if global_pool_bytes else None
        self.per_connection_queue = per_connection_queue

    async def allocate_message_bytes(self, nbytes: int) -> Optional[AllocationPermit]:
        if self.pool is None:
            return None
        return await self.pool.allocate(nbytes)

    def queue_size(self) -> int:
        # 0 = unbounded for asyncio.Queue
        return self.per_connection_queue or 0


NO_LIMIT = Limiter(None, None)
