"""MultiHostBrokerGroup: the mesh broker group assembled across OS
processes, one lockstep deployment with zero host broker links.

The counterpart of ``pushcdn_tpu.broker.multihost_group``. Every process
joins the ``torch.distributed`` process group, builds the SAME global
broker mesh (``parallel.multihost.pod_broker_mesh``), attaches its
brokers to its LOCAL shards, and runs the routing step collectively: its
local shards' rows go in, the process group's collective assembles the
global view, and the dense kernel routes each local shard on its device.
Inter-broker bytes touch no socket this code owns.

Differences from the single-process :class:`MeshBrokerGroup`:

- **Lockstep stepping.** Every process must enter the same collectives
  with the same shapes, so the pump steps at a fixed cadence
  (``batch_window_s``) every tick, traffic or not, at full shapes (the
  group is ``lockstep``, see ``MeshGroup._snapshot``). A one-int
  stop barrier (an ``all_reduce``) runs before each step, so every
  process leaves the loop on the same tick and none strands a peer
  inside a collective.
- **Statically partitioned slot space.** Shard ``i`` owns user slots
  ``[i*K, (i+1)*K)`` (K = num_user_slots / num_shards): a slot's owner is
  ``slot // K`` by construction, and no process needs another's
  allocator. Claims carry versions and converge through the in-step CRDT
  merge; each process authors only its own shards' claims.
- **Frame bytes ride the collectives** (``gather_frame_bytes=True``): a
  remote shard's payload exists here only through the step, and egress
  is host-local: each local shard's matrix is encoded into wire streams
  in the step's worker thread (``native.egress_encode``, the gathered
  bytes pulled only for shards that deliver) and goes out through that
  shard's broker.
- **pk -> slot rendezvous through discovery.** A direct needs its
  recipient's slot; across processes that mapping travels through the
  discovery store's user-slot directory, re-published on a TTL that
  outlasts the collective watchdog (the JAX group's two seconds let a
  peer busy with a burst drop out of the directory). A
  cross-process double connect resolves through the same directory: the
  newer claim wins and the older process kicks its session.

Failure: the group fails closed on the CPU and on the card alike, as the
JAX group does. There is no cross-process fallback plane: a failed or
timed-out collective (``collective_timeout_s``, the watchdog) or a failed
step logs, disables the group (staging answers INELIGIBLE, the host
path), logs the staged frames it strands and ends the pump. On the CPU
the brokers then go on serving their own users on the host path, as the
JAX group's do. On the card the pump ends with the failure's exception
and every local member broker goes down with it, as the port's other
planes do there; a warm-up that fails (a native egress library that did
not build or load included) raises out of every member's
``Broker.start()``. A peer process that retires cleanly ends the pump
without an exception, and the brokers keep serving.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import logging
import time
from typing import Dict, List, Optional

import numpy as np

from pushcdn_tpu_torch.broker.device_plane import StepTiming
from pushcdn_tpu_torch.broker.mesh_group import (
    MeshBrokerGroup,
    MeshGroupConfig,
    MeshShardPlane,
)
from pushcdn_tpu_torch.broker.pump_common import require_native_egress
from pushcdn_tpu_torch.parallel.crdt import ABSENT
from pushcdn_tpu_torch.parallel.frames import UserSlots, mask_row_of
from pushcdn_tpu_torch.parallel.multihost import (
    COLLECTIVE_TIMEOUT_S,
    all_reduce_flag,
    local_shard_indices,
)
from pushcdn_tpu_torch.parallel.router import exchange_seconds
from pushcdn_tpu_torch.proto.error import Error, ErrorKind, bail

logger = logging.getLogger("pushcdn.broker.multihost")


class PartitionedUserSlots(UserSlots):
    """Slot allocator over a static per-shard partition: ``assign`` is
    replaced by :meth:`assign_in_shard`, and freed slots return to their
    shard's own list (the inherited pump calls ``free_slot``)."""

    def __init__(self, capacity: int, num_shards: int,
                 local_shards: List[int]):
        super().__init__(capacity)
        self._free = []  # the global list is never used here
        self.slots_per_shard = capacity // num_shards
        K = self.slots_per_shard
        self.shard_free: Dict[int, List[int]] = {
            s: list(range((s + 1) * K - 1, s * K - 1, -1))
            for s in local_shards}

    def assign_in_shard(self, public_key: bytes, shard: int) -> int:
        existing = self.slot_of(public_key)
        if existing is not None:
            return existing
        free = self.shard_free.get(shard)
        if not free:
            bail(ErrorKind.EXCEEDED_SIZE, f"shard {shard} slot range full")
        slot = free.pop()
        self._key_to_slot[public_key] = slot
        self._slot_to_key[slot] = public_key
        if slot + 1 > self.high_water:
            self.high_water = slot + 1
        return slot

    def free_slot(self, slot: int) -> None:
        if self.key_of(slot) is None:
            free = self.shard_free.get(slot // self.slots_per_shard)
            if free is not None and slot not in free:
                free.append(slot)


class MultiHostShardPlane(MeshShardPlane):
    """A member broker's facade on a multi-process group. On the card the
    broker supervises the lockstep pump as it does the one-process
    group's: a pump that ends with an exception takes the broker down. A
    pump that ends cleanly (a peer process retired) leaves it serving."""

    async def _watch_pump(self) -> None:
        await asyncio.shield(self.group.pump_task)
        await asyncio.Event().wait()   # a clean end: keep serving


class MultiHostBrokerGroup(MeshBrokerGroup):
    """See the module docstring. ``mesh`` comes from ``pod_broker_mesh``;
    ``discovery`` (an ``Embedded`` store) carries the user-slot directory;
    ``collective_timeout_s`` is the watchdog on every collective tick
    (default: the mesh group's own timeout)."""

    plane_class = MultiHostShardPlane

    def __init__(self, mesh, config: Optional[MeshGroupConfig] = None,
                 discovery=None, directory_refresh_s: float = 0.5,
                 collective_timeout_s: Optional[float] = None):
        # bytes must cross processes
        config = dataclasses.replace(config or MeshGroupConfig(),
                                     gather_frame_bytes=True)
        # the lockstep pump steps at full shapes in any world size
        super().__init__(mesh, config, full_shapes=True)
        self.local_shards = local_shard_indices(mesh)
        self.slots = PartitionedUserSlots(
            config.num_user_slots, self.num_shards, self.local_shards)
        self.slots_per_shard = self.slots.slots_per_shard
        # remote shards are live unless the control plane says otherwise
        self._liveness[:] = True
        self._state_rev += 1
        self.discovery = discovery
        self.directory_refresh_s = directory_refresh_s
        self._remote_slots: Dict[bytes, int] = {}   # directory mirror
        self._local_claim_ts: Dict[bytes, float] = {}
        self._dir_task: Optional[asyncio.Task] = None
        self._stop_requested = False
        # The watchdog on every collective tick: a wedged or dead peer
        # fails the group closed within it. The mesh group's own timeout
        # makes the collective itself raise by then, so the worker thread
        # that ran it ends too (and the process can exit).
        self.collective_timeout_s = (
            collective_timeout_s if collective_timeout_s is not None
            else mesh.timeout_s or COLLECTIVE_TIMEOUT_S)
        # per pump step: (staging s, collective s) of the exchange; per
        # tick: the stop barrier's seconds on the loop (the wait for the
        # slowest process included) and how late the pump's window sleep
        # returned (the event loop's other work); per directory refresh:
        # (publish s, read s), both on the loop
        self.recent_exchange: collections.deque = collections.deque(
            maxlen=4096)
        self.recent_barrier: collections.deque = collections.deque(
            maxlen=4096)
        self.recent_wake_lag: collections.deque = collections.deque(
            maxlen=4096)
        self.recent_directory: collections.deque = collections.deque(
            maxlen=4096)

    # ---- collective stop barrier ----------------------------------------

    def _collective_stop(self, want_stop: bool) -> bool:
        """One tiny collective per tick: every process contributes its
        stop intent; all see the same total and leave the loop on the
        same tick."""
        return all_reduce_flag(self.mesh, want_stop)

    # ---- wiring ------------------------------------------------------------

    def attach(self, broker, shard: int):
        if shard not in self.local_shards:
            bail(ErrorKind.PARSE,
                 f"shard {shard} is not local to this process (local "
                 f"shards: {self.local_shards})")
        return super().attach(broker, shard)

    # ---- user lifecycle ---------------------------------------------------

    def claim_user(self, shard: int, public_key: bytes, topics) -> None:
        existing = self.slots.slot_of(public_key)
        if existing is not None and \
                existing // self.slots_per_shard != shard:
            # same-process cross-shard reconnect: the slot // K owner
            # invariant needs a slot in the NEW shard's range, so the old
            # session is kicked (its observer releases the slot) and the
            # user gets a fresh assignment
            old_shard = existing // self.slots_per_shard
            old_broker = self.brokers[old_shard]
            if old_broker is not None and \
                    old_broker.connections.has_user(public_key):
                logger.info("user reconnected at another local shard "
                            "(%d -> %d); kicking", old_shard, shard)
                old_broker.connections.remove_user(
                    public_key, reason="user connected elsewhere")
            else:  # a stale mapping with no live session
                self.release_user(old_shard, public_key)
        try:
            slot = self.slots.assign_in_shard(public_key, shard)
        except Error:
            self._unmirrored[public_key] = shard
            logger.warning("shard %d slot range full; %d unmirrored",
                           shard, len(self._unmirrored))
            return
        self._owner[slot] = shard
        self._claim_version[slot] += 1
        self._masks[slot] = mask_row_of(topics, self.config.topic_words)
        self._local_claim_ts[public_key] = time.time()
        self._state_rev += 1

    def release_user(self, shard: int, public_key: bytes) -> None:
        # only the process that believes it OWNS the claim may delete the
        # directory entry: after a cross-process double-connect kick the
        # entry belongs to the winner (the kick path clears
        # _local_claim_ts first), and deleting it would blackhole directs
        # until the winner's next refresh
        owned = self._local_claim_ts.pop(public_key, None) is not None
        super().release_user(shard, public_key)
        if owned and self.discovery is not None:
            asyncio.ensure_future(
                self.discovery.drop_user_slots([public_key]))

    # ---- direct routing over the static partition -------------------------

    def _direct_route_info(self, recipient: bytes):
        slot = self.slots.slot_of(recipient)
        if slot is None:
            slot = self._remote_slots.get(recipient)
        if slot is None:
            return None
        return slot, slot // self.slots_per_shard

    # ---- the directory refresh (heartbeat-style) --------------------------

    async def _directory_loop(self) -> None:
        # An entry must outlive the longest stall of a live peer's event
        # loop (a burst's egress and deliveries hold it for seconds), and
        # a stall past the collective watchdog fails the whole group: the
        # peers' stop barrier times out. A shorter life dropped a busy
        # peer's users from every mirror, and the directs staged to them
        # meanwhile left the mesh for a host path with no broker links.
        ttl = max(2.0, self.collective_timeout_s
                  + 4 * self.directory_refresh_s)
        while True:
            try:
                t0 = time.perf_counter()
                entries = {pk: (self.slots.slot_of(pk), ts)
                           for pk, ts in self._local_claim_ts.items()
                           if self.slots.slot_of(pk) is not None}
                if entries:
                    await self.discovery.publish_user_slots(entries, ttl)
                t1 = time.perf_counter()
                all_slots = await self.discovery.get_user_slots()
                remote = {}
                for pk, (slot, ts) in all_slots.items():
                    local_slot = self.slots.slot_of(pk)
                    if local_slot is None:
                        remote[pk] = slot
                    elif slot != local_slot and \
                            ts > self._local_claim_ts.get(pk, 0.0):
                        # cross-process double connect: the newer claim
                        # wins (the reference's CRDT kick, through the
                        # directory). ts is the host's wall clock: hosts
                        # must be NTP-synced with skew below the
                        # reconnect gap, as auth's signed timestamps
                        # already require
                        shard = local_slot // self.slots_per_shard
                        broker = self.brokers[shard]
                        if broker is not None and \
                                broker.connections.has_user(pk):
                            logger.info(
                                "user connected in another process; "
                                "kicking")
                            # the winner's entry must survive our release
                            self._local_claim_ts.pop(pk, None)
                            broker.connections.remove_user(
                                pk, reason="user connected elsewhere")
                self._remote_slots = remote
                self.recent_directory.append(
                    (t1 - t0, time.perf_counter() - t1))
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("user-slot directory refresh failed")
            await asyncio.sleep(self.directory_refresh_s)

    # ---- the lockstep pump ------------------------------------------------

    async def _start(self) -> None:
        await super()._start()
        if self.discovery is not None:
            self._dir_task = asyncio.create_task(
                self._directory_loop(), name="multihost-directory")

    def _warmup(self) -> None:
        """The ONE shape the lockstep pump uses (full shapes), run
        collectively once, then the stop barrier's first rendezvous: the
        first pump tick then pays no first-launch cost inside the
        watchdog's window. A failure disables a group on the CPU and
        raises on the card."""
        steps = self.steps
        try:
            if not self.fails_open:
                require_native_egress("a MultiHostBrokerGroup")
            self._run_snapshot(self._snapshot())
            self._collective_stop(False)
        except Exception:
            if not self.fails_open:
                raise
            logger.exception("multi-host warmup step failed")
            self.disabled = True
        finally:
            self.steps = steps   # warmup doesn't count

    async def on_shard_stopped(self, shard: int) -> None:
        # release the stopped shard's local users (the single-process
        # group's sweep, restricted to its range); liveness stays as the
        # other processes see it
        dropped = []
        for slot in np.nonzero(self._owner == shard)[0]:
            key = self.slots.key_of(int(slot))
            if key is not None:
                self.slots.unmap(key)
                if self._local_claim_ts.pop(key, None) is not None:
                    dropped.append(key)
            self._owner[slot] = ABSENT
            self._claim_version[slot] += 1
            self._masks[slot] = 0
            self._quarantine.append(int(slot))
        # a stopped shard's unmirrored users must not pin broadcasts to
        # the (nonexistent cross-process) overflow path forever
        for key in [k for k, sh in self._unmirrored.items() if sh == shard]:
            del self._unmirrored[key]
        if dropped and self.discovery is not None:
            asyncio.ensure_future(self.discovery.drop_user_slots(dropped))
        self.brokers[shard] = None
        self._member_idents = None
        self._state_rev += 1
        # The collective stops only when THIS process fully retires (one
        # broker of several restarting keeps the deployment running); a
        # retiring process stops the whole collective, since lockstep
        # steps need every process.
        if any(self.brokers[s] is not None for s in self.local_shards):
            return
        self._stop_requested = True
        if self._dir_task is not None:
            self._dir_task.cancel()
            self._dir_task = None
        task, self._task, self._starting = self._task, None, None
        if task is not None:
            try:
                await asyncio.wait_for(task, timeout=max(
                    10.0, 2 * self.collective_timeout_s))
            except (asyncio.TimeoutError, asyncio.CancelledError):
                task.cancel()
            except Exception:
                logger.exception("multi-host pump died during stop")

    async def _pump(self) -> None:
        c = self.config
        while True:
            ts = time.perf_counter()
            await asyncio.sleep(c.batch_window_s)
            tb = time.perf_counter()
            self.recent_wake_lag.append(tb - ts - c.batch_window_s)
            try:
                stop = await asyncio.wait_for(
                    asyncio.to_thread(self._collective_stop,
                                      self._stop_requested),
                    timeout=self.collective_timeout_s)
            except Exception as exc:  # CancelledError is BaseException
                logger.error(
                    "stop-barrier collective %s after %.1f s: peer process "
                    "dead or wedged; group disabled",
                    "timed out" if isinstance(exc, asyncio.TimeoutError)
                    else f"failed ({exc!r})", self.collective_timeout_s)
                self._fail_group("stop-barrier failure")
                if not self.fails_open:
                    raise   # on the card: every member broker goes down
                return
            self.recent_barrier.append(time.perf_counter() - tb)
            if stop:
                # a peer process retired: the collective is over
                # everywhere. Disabled, so staging stops ACKing frames
                # into rings nothing will drain.
                self.disabled = True
                self._halt_aux("peer process retired")
                return
            t0 = time.perf_counter()
            snap = self._snapshot()
            t1 = time.perf_counter()
            x0 = exchange_seconds()
            try:
                out, _upload_s, pairs_s = await asyncio.wait_for(
                    asyncio.to_thread(self._run_snapshot, snap, True),
                    timeout=self.collective_timeout_s)
                t2 = time.perf_counter()
                x1 = exchange_seconds()
                delivered = self._egress(out)
                t3 = time.perf_counter()
                self.messages_routed += delivered
                frames = (sum(int(b.valid.sum()) for lane in snap.batches
                              for b in lane)
                          + sum(int(d.valid.sum()) for lane in snap.directs
                                for d in lane))
                self.recent_steps.append(StepTiming(
                    t1 - t0, t2 - t1 - pairs_s, pairs_s, t3 - t2, frames,
                    delivered))
                self.recent_exchange.append(
                    (x1["stage"] - x0["stage"],
                     x1["collective"] - x0["collective"]))
            except asyncio.CancelledError:
                raise
            except asyncio.TimeoutError:
                logger.error(
                    "multi-host step exceeded the %.1f s collective "
                    "watchdog: peer process dead or wedged; group disabled",
                    self.collective_timeout_s)
                self._fail_group("step watchdog breach", snap)
                if not self.fails_open:
                    raise
                return
            except Exception:
                logger.exception("multi-host step failed; group disabled "
                                 "(no cross-process fallback plane exists)")
                self._fail_group("step failure", snap)
                # one last barrier so the peers leave cleanly, bounded:
                # with a dead peer it fails within the mesh's timeout
                try:
                    await asyncio.wait_for(
                        asyncio.to_thread(self._collective_stop, True),
                        timeout=self.collective_timeout_s)
                except Exception:
                    pass
                if not self.fails_open:
                    raise   # the step's exception
                return
            finally:
                self._free_quarantined(snap)

    def _fail_group(self, why: str, snap=None) -> None:
        """The shared disable-and-halt path of every pump failure.
        ``snap`` is the failed step's snapshot: its frames were already
        drained out of the rings, the loss most certain to have
        happened."""
        self.disabled = True
        self._stop_requested = True
        taken = 0
        if snap is not None:
            taken = (sum(int(b.valid.sum()) for lane in snap.batches
                         for b in lane)
                     + sum(int(d.valid.sum()) for lane in snap.directs
                           for d in lane))
        self._halt_aux(why, taken=taken)

    def _halt_aux(self, why: str, taken: int = 0) -> None:
        """Stop republishing claims and account for the frames that were
        ACKed STAGED but will never be stepped (no cross-process fallback
        plane exists: log the loss rather than hide it). ``taken`` counts
        frames already drained for a step that then failed."""
        if self._dir_task is not None:
            self._dir_task.cancel()
            self._dir_task = None
        stranded = self._staged_total() + taken
        logger.warning(
            "multi-host group halted (%s) with %d staged frame(s) "
            "undeliverable: no cross-process fallback plane exists", why,
            stranded)
