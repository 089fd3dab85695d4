"""Adaptive batching signature verifier for connection storms.

A marshal under a storm verifies many signatures in the same few
milliseconds; pairing schemes amortize dramatically when those checks
share one final exponentiation (``BlsBn254Scheme.verify_batch``, ~1.7 ms
single vs ~0.5 ms/sig at n=8 with warm per-pk line tables — the batched
path fuses every item's cached Miller table onto ONE squaring chain). Batching here is ADAPTIVE —
no coalescing timer: the first arrival verifies immediately (an isolated
auth pays zero extra latency), and anything arriving while a
verification is in flight queues and runs as the next batch. Under a
storm the crypto itself is the window.

Semantics are identical to per-item verification:

- batch accepts ⇒ every item is individually valid (random-linear-
  combination soundness, failure probability 2^-128 per forged item);
- batch rejects ⇒ at least one item is invalid ⇒ items are re-checked
  individually — in parallel threads on multi-core hosts, so a single
  forged signature costs the honest co-batched users ~one extra verify
  of latency; on a single hardware thread the re-check is necessarily
  sequential (parallelism cannot exist there) but still yields to the
  loop between pairings, and can never deny honest users service.

Schemes without ``verify_batch`` (Ed25519 — already microseconds) pass
straight through. On multi-core hosts all crypto runs off the event loop
(ctypes releases the GIL), so a storm's pairings never stall the accept
loop. On a single hardware thread an offload buys no parallelism and
costs two context switches per auth (~0.3-0.7 ms measured), so there the
verifier runs pairings inline and yields to the loop around each one —
co-arrivals still coalesce into batches between the yields.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import List, Optional, Set, Tuple

logger = logging.getLogger("pushcdn.crypto.batch")


class BatchVerifier:
    def __init__(self, scheme, max_batch: int = 32,
                 offload: Optional[bool] = None):
        self.scheme = scheme
        self.max_batch = max_batch
        if offload is None:
            # PUSHCDN_CRYPTO_OFFLOAD=0/1 overrides the autodetect: the
            # affinity is sampled once here, so a later cgroup/affinity
            # change is invisible — an operator who knows better can pin
            # the policy instead of restarting into the right mask
            env = os.environ.get("PUSHCDN_CRYPTO_OFFLOAD", "").strip().lower()
            if env in ("0", "1", "false", "true", "no", "yes", "off", "on"):
                offload = env in ("1", "true", "yes", "on")
                logger.info("crypto offload policy: %s (PUSHCDN_CRYPTO_OFFLOAD)",
                            "thread" if offload else "inline")
            else:
                if env:
                    logger.warning(
                        "PUSHCDN_CRYPTO_OFFLOAD=%r not recognized "
                        "(want 0/1); falling back to autodetect", env)
                # usable CPUs, not machine CPUs: a marshal pinned to one
                # core by taskset/cgroups should take the inline path too
                try:
                    usable = len(os.sched_getaffinity(0))
                except (AttributeError, OSError):
                    usable = os.cpu_count() or 1
                offload = usable > 1
                logger.info(
                    "crypto offload policy: %s (auto: %d usable CPU%s)",
                    "thread" if offload else "inline",
                    usable, "" if usable == 1 else "s")
        self._offload = offload
        self._batchable = hasattr(scheme, "verify_batch")
        self._inflight = False
        self._pending: List[Tuple[tuple, asyncio.Future]] = []
        # strong refs: the loop holds only weak refs to tasks, and a
        # GC'd batch task would leave _inflight wedged True forever
        self._tasks: Set[asyncio.Task] = set()
        # observability (tested, and handy when sizing a deployment)
        self.batches = 0
        self.batched_items = 0
        self.singles = 0

    def cache_stats(self):
        """The scheme's verification-cache counters (the BLS per-public-
        key line-table LRU: repeat connectors replay a cached Miller
        table in both the single and the batched path), or None for
        schemes without one. Complements batches/batched_items when
        sizing a marshal: a high hit rate means even the single-arrival
        path runs at the warm-verify cost."""
        from pushcdn_tpu_torch.proto.crypto.signature import BlsBn254Scheme
        if self.scheme is not BlsBn254Scheme:
            return None
        from pushcdn_tpu_torch.native import bls
        return bls.pk_cache_stats()

    async def verify(self, public_key: bytes, namespace, message: bytes,
                     signature: bytes) -> bool:
        if not self._batchable:
            # microsecond schemes (Ed25519): a thread handoff would cost
            # 10x the verify itself — run inline
            self.singles += 1
            return self.scheme.verify(public_key, namespace, message,
                                      signature)
        item = (public_key, namespace, message, signature)
        if self._inflight:
            fut = asyncio.get_running_loop().create_future()
            self._pending.append((item, fut))
            return await fut
        # idle: verify NOW (no window to wait out); arrivals during this
        # call accumulate into the next batch
        self._inflight = True
        try:
            self.singles += 1
            return await self._call(self.scheme.verify, *item)
        finally:
            self._drain()

    async def _call(self, fn, *args):
        """Run one crypto call per the offload policy, keeping the
        batch-formation window alive either way."""
        if self._offload:
            return await asyncio.to_thread(fn, *args)
        result = fn(*args)
        # the loop was blocked for the call's duration: co-arrivals are
        # queued behind it. Two passes let their handler chains (reader
        # wakeup, then the handler itself) reach verify() and register in
        # _pending before _drain decides whether a batch formed.
        await asyncio.sleep(0)
        await asyncio.sleep(0)
        return result

    def _drain(self) -> None:
        """Kick the queued batch (keeps ``_inflight`` until the queue is
        empty, so a sustained storm stays in batch mode)."""
        batch, self._pending = (self._pending[:self.max_batch],
                                self._pending[self.max_batch:])
        if batch:
            task = asyncio.ensure_future(self._run(batch))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)
        else:
            self._inflight = False

    async def _run(self, batch) -> None:
        items = [item for item, _ in batch]
        try:
            try:
                if len(items) == 1:
                    self.singles += 1
                    results = [await self._call(self.scheme.verify,
                                                *items[0])]
                else:
                    self.batches += 1
                    self.batched_items += len(items)
                    ok = await self._call(self.scheme.verify_batch, items)
                    if ok:
                        results = [True] * len(items)
                    elif self._offload:
                        # at least one forgery: identify it in PARALLEL so
                        # it cannot serialize the honest co-batched users
                        results = await asyncio.gather(*(
                            asyncio.to_thread(self.scheme.verify, *it)
                            for it in items))
                    else:
                        # single core: parallelism cannot help; re-check
                        # sequentially with a yield per item so the loop
                        # breathes between pairings
                        results = []
                        for it in items:
                            results.append(self.scheme.verify(*it))
                            await asyncio.sleep(0)
                for (_, fut), ok in zip(batch, results):
                    if not fut.done():
                        fut.set_result(ok)
            except BaseException as exc:
                # includes CancelledError: waiters must never hang on a
                # dead batch, and the drain below must still run
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(
                            exc if isinstance(exc, Exception)
                            else ConnectionError("batch verify cancelled"))
                raise
        finally:
            self._drain()