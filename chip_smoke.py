#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pushcdn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — requires CUDA, probed first in a child process
   (``testing.accel_probe.require_accelerator``: a wedged card ends the
   run with the probe's reason instead of a hang); prints the card's name
   and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them, and the torch and CUDA versions;
2. build — both kernels from ``pushcdn_tpu_torch/csrc`` with nvcc and,
   beside them, the native host routines from
   ``pushcdn_tpu_torch/native/*.cpp`` with g++ (the framing library, the
   batch decoder and the cut-through route plan; each one's seconds) and
   the BLS-over-BN254 library (``native/bls_bn254.cpp``), which must pass
   its self-test;
3. kernels vs plain — each CUDA kernel against its plain PyTorch version
   on the card, bit for bit, at edge shapes (the cases of
   ``pushcdn_tpu_torch/testing/kernel_cases.py``) and the main path's
   shapes;
4. the slice at full size — the socket-free ``DevicePlane`` with 4096 user
   slots, 256 topics (8 mask words), 3 topics per user drawn uniform and
   zipf(1/rank), 2048 frames per tick (90% broadcast, 10% direct) over the
   2048-slot x 2048 B base lane and the 64 x 16384 B lane, 8 ticks with
   user churn, under the dense and then the ragged impl; every tick's
   pairs are checked against a scalar oracle written here, and each
   kernel's launch count over this phase must be > 0;
5. the ``bench.py`` shape (1024 users, 65536 frames, one mask word), one
   dense tick through ``routing_step_single``;
6. the mesh tick — a socket-free ``MeshGroup`` of 4 broker shards folded
   onto the card (``make_broker_mesh(4, devices=["cuda:0"] * 4)``) at the
   slice's width: 4096 user slots spread evenly over the shards, 256
   topics, 2048 frames per tick (512 base-lane slots x 2048 B per shard,
   the (16384, 32, 8) extra lane, 64-slot direct buckets), 90% broadcast
   and 10% direct to users on any shard, 8 ticks with churn and one
   in-group double connect each, the last shard stopped for the last two
   ticks; uniform and zipf interest, each with the fused and the
   per-array exchange. Every tick's per-shard pairs are checked against a
   scalar oracle written here and against the same group run on the CPU,
   a fused tick must count one collective, and each of the four runs
   must launch the dense kernel. Then ``dryrun_multichip(4)`` on the
   folded card, its launches on a line of their own;
7. times — each kernel at the shapes of phases 4, 5 and 6 (CUDA events
   around 5 groups of 20 back-to-back launches queued behind a GPU spin;
   the median group's mean), its plain version's time, its bound counted
   for these inputs (``bytes_ms``, ``ops_ms``, ``bound_ms``, ``bound_by``),
   its launches per tick, for the dense kernel the time of a plain
   ``fill_`` of its output (the floor of a kernel that only writes those
   bytes), ``step()`` split into host packing, device step and pair
   extraction, and the mesh tick split into staging, host snapshot and
   upload, the mesh step through readback and pair extraction on the
   host clock, plus the last tick's exchange (pack + gather:
   device-to-device copies on one card, not interconnect time) and
   per-shard device step replayed on their recorded inputs under CUDA
   events;
8. the broker — the port's ``Broker`` with a ``DevicePlane`` on the card
   (4096 user slots, the 2048 x 2048 B base lane and the 64 x 16384 B
   lane, 8 mask words, no idle bypass), 4096 users injected over the
   Memory transport as the test harness does it, 3 topics each of 256
   drawn uniform or zipf(1/rank); 64 of them publish bursts of 2048 frames
   in the slice's mix (8 publishers' frames a turn of the event loop),
   every payload ending in (publisher, seq, send time), and every user's
   remote end drains and records what arrives.
   Dense and ragged at uniform and zipf (1 burst each), then the
   same bursts through a broker with no device plane (the port's host
   path on the same machine), as the reference routes by default
   (``PUSHCDN_ROUTE_CUTTHROUGH`` unset: the cut-through plane); the run
   on its scalar twin (``python``) at uniform was cut for the script's
   time limit, named on the uniform host run's line. Each run must deliver
   exactly the scalar oracle's frames to every user, in publisher order
   within each lane; a plane run must route every delivery on the plane
   (``messages_routed``) without disabling it, and launch its kernel; a
   dense run must egress every busy step through ``native.egress_encode``
   (``native_egress_steps`` equal to ``busy_steps``). Every publisher
   frame must be counted by ``cdn_route_batch_frames`` under
   ``path=cutthrough`` on a default host run, and under ``path=scalar``
   under a plane; one ``broker`` line per run, then one
   ``broker_ratio`` line, each plane's msgs/s over each host run's;
9. the cluster as processes, started as the README's quick start starts
   it: ``python -m pushcdn_tpu_torch.bin.marshal`` and ``python -m
   pushcdn_tpu_torch.bin.broker --device-plane`` as child processes on a
   fresh discovery file, loopback TCP endpoints, TCP+TLS for users and
   the binaries' own defaults otherwise (256 topics; 1024 user slots, the
   1024 x 2048 B and 64 x 16384 B lanes). 1024 ``Client``s in this
   process authenticate through the marshal over TCP+TLS with seeded
   Ed25519 keys, 3 uniform topics each; 64 publish bursts of 2048 frames
   in phase 8's mix. ``PUSHCDN_DELIVERY_IMPL=dense``, then ``ragged``: 2
   uniform bursts, every client moves to zipf topics through
   ``Client.subscribe``/``unsubscribe``, 1 zipf burst; then a broker
   without a plane takes the uniform bursts. Each run must deliver
   exactly the oracle's frames (as a multiset: the plane's idle bypass
   sends some frames by the host path), a plane run's ``/metrics`` must
   show ``cdn_device_messages_routed`` > 0 and its broker's exit line
   launches of its kernel after the warm-up (none for the host path), its
   exit line the native host routines loaded and, on the dense run, every
   busy step egressed natively, and both children must exit 0 on SIGTERM;
   the plane-less broker's ``/metrics`` must count frames under
   ``cdn_route_batch_frames{path="cutthrough"}``, a plane broker's none;
   one ``cluster`` line per run;
10. four broker shards serving users through the mesh group — phase 6's
   shape in brokers: a ``MeshBrokerGroup`` on the 4 shards folded onto the
   card (4096 user slots, 512 x 2048 B base-lane slots and the (16384,
   32, 8) lane per shard, 64-slot direct buckets, 8 mask words), 1024
   users injected on each shard's broker over the Memory transport as in
   phase 8, 3 topics each of 256 drawn uniform or zipf(1/rank), 64 of
   them (16 a shard) publishing bursts of 2048 frames in phase 8's mix,
   directs to users on any shard. Runs: (1) the per-array exchange, 2
   uniform bursts (3 until the script's time limit cut one, named on the
   run's line), every user moved to zipf topics, 1 zipf burst; (2) the
   fused exchange, 2 uniform bursts, every tick counting one collective;
   (3) on that group, shard 3's broker stopped, 1 uniform burst from the
   survivors' publishers (directs to its users take the host path and
   reach no one); (4) the same four brokers without a group, joined by
   host links, run 2's first burst, routed as the reference does by default
   (every broker's user loops and broker links must plan frames through
   the cut-through plane; the pass on the scalar twin was cut for the
   script's time limit, named on the run's line), with one
   ``mesh_broker_ratio`` line (the fused group's msgs/s over it); (5) a
   small ``MeshCluster`` on the card,
   a marshal and one authenticated ``Client`` per shard, a cross-shard
   broadcast and direct each arriving exactly once. Each run's deliveries
   must equal the scalar oracle's (as a multiset, and per publisher in
   send order on each path: size lane, broadcast or direct), the group
   must route every one without disabling itself, launch the dense
   kernel and egress every busy step through ``native.egress_encode``;
   one ``mesh_broker`` line per run;
11. the multi-host group — a global mesh of 8 shards in 2 processes, each
   folding its 4 shards onto the card, the exchange over a gloo process
   group (the phase names its transport: gloo takes the CUDA tensors), at
   phase 10's width with 256 x 2048 B base-lane
   slots a shard (8 shards carry a 2048-frame burst in one tick) and 512
   user slots a shard. Runs: (1) two worker processes (``python -m
   pushcdn_tpu_torch.testing.lockstep_worker``) step a socket-free
   ``MultiHostBrokerGroup`` in lockstep for 8 ticks of phase 6's traffic
   (4032 users, no churn), uniform fused and zipf per-array (the other
   two of the four were cut for the script's time limit, named on each
   run's line); each
   tick's deliveries of both processes must equal phase 6's oracle and
   the one-process ``MeshGroup`` of 8 shards on the card, pair for pair
   and frame for frame, with 8 dense launches a tick per process; (2) two
   worker processes (``testing.burst_worker``) each run a group with a
   ``Broker`` on each local shard and 2048 users injected over the Memory
   transport (512 a broker); 32 publishers in each send 3 uniform bursts
   of 2048 frames in phase 8's mix, every user moves to zipf topics, 1
   zipf burst, directs to users of the other process through the
   discovery directory; every delivery against the oracle, zero host
   broker links, 8 launches a step and one collective a tick, the idle
   lockstep tick measured and split (the stop barrier, the step, how
   late the pump's window sleep returns, the directory's refreshes)
   (the same users and bursts through one process's group of 8 shards
   beside it were cut for the script's time limit, named on the run's
   line); (3) a marshal and two ``broker --mesh-shards 2 --multihost-*
   --device cuda:0`` processes, a TCP+TLS client on each: a broadcast
   crosses, a direct crosses back, no broker link, both exit 0 on
   SIGTERM with their launches on their exit lines. Runs 2 and 3 must
   egress every busy step through ``native.egress_encode``. Then the
   dense kernel's time at this shape. One ``multihost`` line per run;
12. the native host routines (appended after phase 11, whose number it
   follows) at the slice's shape: on the dense kernel's own matrices of
   phase 4 (a base-lane launch per popularity, U x 2048 frames,
   recomputed by its plain version) and a 2048-frame burst in the slice's
   mix, ``egress_encode`` against a plain per-user walk (``np.nonzero``
   row-major, a 4-byte big-endian length before each frame: the wire's
   framing), ``FrameRing.push_batch`` against its ``_put`` loop,
   ``FrameEncoder.encode`` and ``FrameScanner.scan`` round-tripping the
   burst against the Python prefix and scan, and ``pydecode`` against
   ``decode_frames``'s Python loop; every result equal, both sides timed
   on the host clock (median of repeats). One ``native`` line per
   popularity;
13. the host routing plane on the card's host (appended after phase 12):
   ``testing.routebench.forward_rate`` at the JAX package's defaults (8
   receivers, 2000 msgs of 512 B, batches of 64, 3 trials), the plane
   forced ``native`` against its scalar twin ``python``; the same with
   4096 parked users and a churner flooding Subscribe / Unsubscribe, the
   native row with in-place deltas and rebuilding per change; each row
   delivering what its twin delivers through the path it names. Then one
   ``RoutePlanner.plan`` call and one whole chunk over a 2048-frame burst
   of phase 8's mix against phase 8's 4096-user table, its pairs equal to
   the oracle's deliveries (host-clock medians). One ``route`` line per
   row;
14. the sharded host data plane on the card's host (appended after phase
   13): (a) ``testing.shardharness.run_sharded`` in this process, phase
   8's 4096 users dealt round-robin over the worker shards, 3 topics of
   256 each, users 0-63 publishing one 2048-frame burst of phase 8's mix
   paced as phase 8 paces it, the pipes widened as there, rings at the
   binary's default size: 2 worker shards at uniform and at zipf, on
   phase 8's seeds, the zipf run on 2048 of the 4096 users (4 worker
   shards: ``phase_shards``'s ``runs``; both cuts for the time limit, the
   second named on its line); each run must deliver exactly the
   oracle's frames in publisher order per lane, plan every publisher
   frame under ``path=cutthrough``, hand records to the rings (shed
   none) and leave every worker's byte pool whole after shutdown; its
   delivered msgs/s beside phase 8's ``host`` run on the same burst (all
   workers share one event loop here, so the ratio is reported, not
   claimed). (b) Phase 9's plane-less deployment with ``python -m
   pushcdn_tpu_torch.bin.broker --shards 2``: 1024 TCP+TLS clients spread
   over the workers by ``SO_REUSEPORT``, the 2 uniform bursts against the
   oracle as a multiset; the supervisor's ``/debug/topology`` must show
   users on both workers, its merged ``/metrics`` the ``shard`` labels
   and ring handoffs, every worker's ``cdn_build_info`` torch as absent,
   and every process must exit 0 on SIGTERM; msgs/s and p50 / p99 beside
   phase 9's plane-less broker. (c) ``--shards 2 --device-plane`` must
   exit non-zero with the JAX binary's message. One ``shards`` line per
   run;
15. durable topics, admission and re-homing under the dense plane
   (appended after phase 14): (a) phase 8's dense broker retaining
   topics 0-31 (``PUSHCDN_RETAIN_TOPICS``, rings of the default 1024
   entries), its plane widened to 4384 user slots so the 256 late
   subscribers and the 32 last-value readers sit on it too; phase 8's
   uniform burst, then the 256 late users each ``SubscribeFrom`` one
   retained topic from seq 0, a second burst, and 32 last-value reads.
   Both bursts' deliveries must equal the oracle's in publisher order per
   lane, the late users' included, all routed on the plane with every
   busy step egressed natively; each ring must hold the broadcasts the
   oracle retained there (whether any ring evicts is worked out from the
   mix first and printed), with contiguous sequence numbers and each
   publisher's frames in send order; each replay must equal its ring's
   snapshot, each last value the ring's newest entry, and
   ``cdn_retention_ring_entries`` the rings' sum. (b) A broker with a
   1024-slot dense plane and ``PUSHCDN_MAX_CONNS_USER=64``,
   ``PUSHCDN_SUBSCRIBE_RATE=20``, ``_BURST=20`` and
   ``PUSHCDN_SHED_READY_S=2``: the 65th user is refused before
   authentication (``permit=0``, a ``shed:`` context; a real client
   through an in-process marshal raises ``Error(SHED)`` with the
   readiness window as its retry hint), one user's 100 subscribe
   mutations meet the bucket (every shed answered by a typed notice and
   counted by ``cdn_route_shed_total{tier="subscribe"}``), a broadcast
   on a shed topic reaches no one while the plane launches, and
   ``/readyz``'s admission check reads false, then true 2 s later. (c) A
   marshal and ``broker --device-plane`` (A) on a fresh discovery file,
   256 TCP+TLS clients on it, then broker B (``--device-plane``); a
   SIGTERM to A must re-home all 256 (its ``drain re-home`` line), each
   client reaching B with its pre-issued permit and without a marshal
   round trip; a uniform burst from 16 clients must then reach every
   client through B's plane as the oracle says (a multiset), B's
   ``/metrics`` must show ``cdn_device_messages_routed`` > 0 and its exit
   line launches after its warm-up, and ``GET /drain`` on B, which has
   no peer left, must report ``no_target`` and keep the users. One
   ``durable`` line per run;
16. the operator's and the measurer's tooling on the card (appended after
   phase 15): (a) ``python -m pushcdn_tpu_torch.scripts.local_cluster
   --device-plane --duration 10 --base-port 0 --trace-log DIR``, the
   README's quick start (the marshal, two brokers with dense planes on the
   card, the echo client), which must exit 0 with every OK line of the JAX
   runner's tier-1 test and no FAIL, each broker serving on the card; its
   brokers' exit lines split their launches into warm-up and traffic and
   give the frames the planes routed and those the depth-1 bypass sent
   the host way. (b) ``testing.consensus.run_consensus`` over the port's
   ``Cluster`` of two brokers, each with a 1024-slot plane on the card and
   ``bypass_max_items=0``, 1024 nodes spread over them (quorum 683), 8
   views of a 256 B proposal to every node and 1024 64 B vote directs to
   the leader, dense then ragged: every view completes with no timeout,
   every node receives every proposal, every leader holds a quorum, both
   planes route and the impl's kernel launches. (c) A marshal and ``broker
   --device-plane --user-transport tcp`` at the binary's defaults; 4
   ``testing.clientpack`` soak processes of 255 clients on 8 topics (with
   the publisher here, 1021 users: every one on the plane's 1024 slots);
   64 sequenced 512 B broadcasts a topic in 8 waves of 64, 50 ms apart
   (65,280 deliveries); every pack must end with no gap, no reorder, no
   hard reconnect and every client's 64, the broker's ``/metrics`` must
   show at least 512 routed on the plane and its exit line dense launches
   after the warm-up; then a storm pack of 128 clients x 250 reconnect
   cycles against it (2 packs until the script's time limit cut one,
   named on the line), each cycle connected or shed with a typed
   retry-after; then the same soak against ``broker --shards 2`` without a
   plane. One ``tooling`` line per run, the soaks' delivered msgs/s beside
   phase 9's;
17. the host I/O engines under the planes (appended after phase 16): the
   port's io_uring probe first (``native.uring.probe()``; the shim must
   build, and only ``ENOSYS`` or ``EPERM`` may deny it, reported as
   ``{"phase": "io", "io_uring": "denied: <errno>"}``). Where it is
   allowed: (a) phase 16 (c)'s soak against ``broker --device-plane
   --user-transport tcp --io-impl uring`` (the marshal on ``--io-impl
   uring``, the packs with ``PUSHCDN_IO_IMPL=uring``, no storm), every
   pack whole, the broker's ``/metrics`` reading ``cdn_io_impl{impl=
   "uring"}`` 1, at least 512 routed on the plane and its io_uring_enter
   timings, its exit line dense launches after the warm-up with every busy
   step egressed natively; (b) the same soak against a plane-less broker
   with ``--io-impl uring --pump auto`` (frames under
   ``cdn_route_batch_frames{path="pump"}``) and, allowed or not, on
   asyncio (frames under ``path="cutthrough"``), with (a)'s rate over
   each. (c) A marshal and ``broker --device-plane --user-transport
   quic`` with ``PUSHCDN_DELIVERY_IMPL=ragged`` (the broker link on
   TCP); 256 QUIC clients here with seeded keys, 32 on each of 8 topics,
   and a QUIC publisher sending 64 sequenced 512 B broadcasts a topic in
   8 waves 50 ms apart (16,384 deliveries), then each client a direct to
   itself: every client gets its topic's 64 in order and its direct,
   ``/metrics`` at least 512 routed, the exit line ragged launches after
   the warm-up, every process exits 0 on SIGTERM; connect seconds,
   delivered msgs/s and publish-to-receive p50 / p99. One ``io`` line per
   run;
18. the production run definition's shape (``def_.production_run_def``:
   BLS-over-BN254 keys on both links, brokers linked over TCP, users on
   TCP+TLS, Redis discovery) under dense planes (appended after phase
   17). It probes for the ``redis`` package and a ``redis-server`` or
   ``keydb-server`` on ``PATH``; where both exist, (a)'s discovery runs on
   a throwaway server, otherwise on a fresh SQLite file, and the line says
   ``"redis": "absent: <what>"``. (a) A marshal ``--scheme bls-bn254``
   (its line-table cache sized to 1024 keys) and brokers A and B, each
   ``--device-plane --scheme bls-bn254`` with the broker link on TCP and
   users on TCP+TLS; phase 15 (c)'s users: 256 clients here with seeded
   BLS keys, 3 uniform topics of 256, placed over both brokers by the
   marshal; 16 publish one uniform burst of phase 8's mix, which every
   client must receive exactly as the oracle says, some of it across the
   A-B link; the marshal's ``/metrics`` must show
   ``cdn_native_seconds{kernel="bls_verify"}`` > 0 and
   ``cdn_bls_pk_cache{stat="misses"}`` >= 256, and, after every client
   reconnects once, ``cdn_bls_pk_cache{stat="hits"}`` >= 256; each
   broker's ``/metrics`` ``cdn_device_messages_routed`` > 0 and its exit
   line dense launches after the warm-up; connect seconds p50 / p99, cold
   and warm; a plane-less broker given ``redis://`` where the package is
   absent must exit non-zero with the JAX package's message. (b) In
   process: ``production_run_def().user_def.scheme`` must be
   ``BlsBn254Scheme``; then phase 16 (b)'s consensus cluster (two brokers
   with 1024-slot dense planes on the card, ``bypass_max_items=0``) with
   BLS keys, the 1024 nodes connected concurrently (half onto each
   broker), the marshal's batching verifier reporting ``batches`` > 0 and
   more than one item a batch, one node with a forged signature refused
   while every other is admitted; 2 views, each completing with its
   leader holding a quorum of 683. One ``prod`` line per run.

Then the ``{"kernels": [...]}`` line, and last the ``{"ok": true, ...}``
line. Any failed check exits non-zero before the last line.
"""

from __future__ import annotations

import asyncio
import json
import os
import struct
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks. Memory: NVIDIA's data sheet, 3.35 TB/s of HBM3. The
# kernels' work is 32-bit integer logic and compares: the CUDA C++
# Programming Guide's arithmetic-instruction throughput table gives
# compute capability 9.0 64 results per clock per SM for 32-bit integer
# add, compare, min/max and bitwise AND/OR/XOR. Times the SM count and
# the card's maximum SM clock, both read at run time (132 SMs x 1980 MHz
# = 16.7e12 per second on the H100 SXM).
PEAK_BYTES_PER_S = 3.35e12
INT32_OPS_PER_CLOCK_PER_SM = 64
H100_SMS = 132
H100_MAX_SM_CLOCK_HZ = 1.98e9
TIMING_GROUPS = 5
TIMING_REPS = 20
SPIN_CYCLES = 200_000_000  # ~0.1 s of GPU spin to queue timed calls behind
FRAMES = 1 << 16   # frame-index radix of the oracle's delivery codes

# the slice's deployment shape (benches/route_bench.py device/delivery)
SLICE = dict(users=4096, initial_users=4032, topics=256, topic_words=8,
             topics_per_user=3, frames=2048, wide_frames=40,
             direct_share=0.1, two_topic_share=0.1, churn=32, ticks=8)

# the mesh phase: the slice's users, topics and frames per tick over four
# broker shards (MeshGroupConfig's lanes; 512 base-lane slots per shard
# carry the slice's 2048 frames per tick)
MESH = dict(SLICE, shards=4, ring_slots=512, frame_bytes=2048,
            extra_lane=(16384, 32, 8), direct_bucket_slots=64)

# the broker phase: the slice's users, topics and frame mix, published by
# 64 of the users through a broker (bursts per popularity)
BROKER = dict(SLICE, publishers=64, bursts={"uniform": 1, "zipf": 1},
              ring_slots=2048, frame_bytes=2048, extra_lane=(16384, 64))
# the cluster phase: the broker binary's own defaults (256 topics, a
# 1024-slot plane with the 1024 x 2048 B lane and the 64 x 16384 B lane),
# as many TCP+TLS clients as the plane has user slots
CLUSTER = dict(SLICE, users=1024, publishers=64, frame_bytes=2048,
               bursts={"uniform": 2, "zipf": 1}, auth_concurrency=64)
# the mesh-broker phase: the mesh phase's shards, lanes and users in four
# brokers, 16 of each shard's users publishing
MESH_BROKER = dict(MESH, publishers=64)
# the multi-host phase: the mesh phase's users, topics and lanes over 8
# shards in 2 processes (4 folded onto the card in each); 256 base-lane
# slots a shard carry a 2048-frame burst in one tick; 64 publishers, 32
# in each process
MULTIHOST = dict(MESH, shards=8, processes=2, ring_slots=256, publishers=64)
# the host routing plane's phase: testing.routebench.forward_rate at the
# JAX package's defaults, and its churn row over a parked herd as large as
# phase 8's users
ROUTE = dict(receivers=8, msgs=2000, trials=3, payload=512, batch=64,
             parked_users=4096)
# publishers whose bursts go out in one turn of the event loop (phases 8
# and 10). The broker routes a burst's chunks in the turn after they
# arrive; 64 publishers' chunks in one turn made one turn of routing at
# zipf on the host path outlast the transports' 5 s write and read
# timeouts, which dropped receivers
PUBLISH_GROUP = 8
# every payload ends in (publisher, seq, send time in perf_counter ns)
TAIL = struct.Struct("<IIq")
BARRIER = 0xFFFFFFFF   # the publisher of a resubscription barrier


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, groups: int = TIMING_GROUPS, reps: int = TIMING_REPS):
    """Device time of one call of ``fn``: the median over ``groups`` of
    the mean over ``reps`` back-to-back calls bracketed by one pair of
    CUDA events; and the mean wall time of a call with its host dispatch.

    The calls are queued behind a GPU spin, so the host's dispatch
    (Python, argument checks, the ctypes call) opens no gaps between
    them and the device time is the kernels' own."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(groups)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in events:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    torch.cuda.synchronize()
    device_ms = float(np.median([s.elapsed_time(e) / reps
                                 for s, e in events]))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    return device_ms, wall_ms


def timed(kernel, plain):
    """Kernel and plain-version times, interleaved kernel, plain, plain,
    kernel on the same inputs; the device times are the medians' mean."""
    k1, kw1 = time_ms(kernel)
    p1, pw1 = time_ms(plain)
    p2, pw2 = time_ms(plain)
    k2, kw2 = time_ms(kernel)
    return dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                wall_ms=(kw1 + kw2) / 2, plain_wall_ms=(pw1 + pw2) / 2)


def write_floor_ms(U: int, N: int, device) -> float:
    """Device time of ``fill_`` on a bool[U, N]: what a kernel that only
    writes the dense output costs on this card, launch included."""
    import torch
    out = torch.empty((U, N), dtype=torch.bool, device=device)
    return time_ms(lambda: out.fill_(True))[0]


def int32_peak(sms: int = H100_SMS,
               clock_hz: float = H100_MAX_SM_CLOCK_HZ) -> float:
    """32-bit integer operations per second: 64 a clock on each SM."""
    return INT32_OPS_PER_CLOCK_PER_SM * sms * clock_hz


def bound(bytes_moved: int, ops: int, peak_ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the integer rate ``peak_ops``."""
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / peak_ops * 1e3
    return dict(bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def dense_work(user_masks, local, frame_tmask, kind, dest):
    """Bytes and integer operations the dense delivery matrix needs for
    these inputs (torch tensors, as the kernel takes them).

    Bytes: each input read once, the bool[U, N] output written once.
    Operations: one per cell for its output byte; for every cell of a
    local user, one per non-zero mask word of a broadcast frame (a LOP3
    folds acc | umask & tmask) and one compare for a direct frame."""
    from pushcdn_tpu_torch.ops.delivery_kernel import mask_words
    from pushcdn_tpu_torch.proto.message import KIND_BROADCAST, KIND_DIRECT
    U, N, W = user_masks.shape[0], frame_tmask.shape[0], mask_words(user_masks)
    nnz = (frame_tmask.reshape(N, W) != 0).sum(dim=1)
    per_user = (int(nnz[kind == KIND_BROADCAST].sum())
                + int((kind == KIND_DIRECT).sum()))
    ops = U * N + int(local.sum()) * per_user
    return U * N + U * (4 * W + 1) + N * (4 * W + 8), ops


def ragged_work(pages, walk_page, walk_frame, local, user_masks,
                frame_tmask, kind, dest):
    """Bytes and integer operations the ragged walk needs for these
    inputs (torch tensors, as the kernel takes them).

    Bytes: the distinct pages the walk visits (512 bytes each), its two
    index lists, the table rows (W mask words and the local flag) of its
    distinct in-range candidates and the rows (W mask words, kind, dest)
    of its distinct frames, each read once; out_user and counts written
    once. Rows whose page or frame index is out of range read no page.
    Operations: per lane a range compare and the select of its output;
    per in-range candidate the local test, plus one per non-zero mask
    word of a broadcast frame or one compare for a direct frame."""
    import torch
    from pushcdn_tpu_torch.ops.delivery_kernel import mask_words
    from pushcdn_tpu_torch.proto.message import KIND_BROADCAST, KIND_DIRECT
    G, Wp, U, N = (pages.shape[0], walk_page.shape[0], local.shape[0],
                   kind.shape[0])
    W = mask_words(user_masks)
    lanes = pages.shape[1]
    ok = ((walk_page >= 0) & (walk_page < G)
          & (walk_frame >= 0) & (walk_frame < N))
    pg = walk_page[ok].long()
    f = walk_frame[ok].long()
    cand = pages[pg]
    in_range = (cand >= 0) & (cand < U)
    n_pages = int(torch.unique(pg).numel())
    n_frames = int(torch.unique(f).numel())
    n_users = int(torch.unique(cand[in_range]).numel())
    nnz = (frame_tmask.reshape(N, W) != 0).sum(dim=1)
    per_cand = 1 + torch.where(kind == KIND_BROADCAST, nnz,
                               (kind == KIND_DIRECT).long())
    ops = (2 * lanes * Wp
           + int((in_range.sum(dim=1) * per_cand[f]).sum()))
    nbytes = (4 * lanes * n_pages + 8 * Wp + n_users * (4 * W + 1)
              + n_frames * (4 * W + 8) + Wp * (4 * lanes + 4))
    return nbytes, ops


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _rand_u32(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def dense_inputs(rng, U, N, W, device, all_invalid=False):
    import torch
    ushape = (U,) if W == 1 else (U, W)
    nshape = (N,) if W == 1 else (N, W)
    umask = _rand_u32(rng, ushape)
    tmask = _rand_u32(rng, nshape) & _rand_u32(rng, nshape) \
        & _rand_u32(rng, nshape)
    kind = rng.choice([0, 4, 5, 5, 9], N).astype(np.int32)
    if all_invalid:
        kind[:] = 0
    dest = rng.integers(-3, U + 5, N).astype(np.int32)  # garbage dests too
    local = rng.random(U) < 0.7
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (umask.view(np.int32), local,
                           tmask.view(np.int32), kind, dest))


def topic_weights(T: int, popularity: str) -> np.ndarray:
    """Topic popularity: uniform, or zipf with weight 1/rank."""
    p = 1.0 / np.arange(1, T + 1) if popularity == "zipf" else np.ones(T)
    return p / p.sum()


def ragged_inputs(rng, popularity, device):
    """A packed walk at the slice's shape from the port's own index:
    uniform or zipf interest, broadcasts, directs with garbage dests past
    the user table, and padding entries."""
    import torch
    from pushcdn_tpu_torch.ops.ragged_delivery import RaggedInterest
    from pushcdn_tpu_torch.parallel.frames import mask_of_topics, split_mask
    U, T, N, W = SLICE["users"], SLICE["topics"], SLICE["frames"], 8
    p = topic_weights(T, popularity)
    ri = RaggedInterest(T, max_pages=4096)
    masks = np.zeros((U, W), np.uint32)
    for u, topics in enumerate(rng.choice(T, size=(U, 3), p=p)):
        m = mask_of_topics(topics, W)
        ri.set_mask(u, m)
        masks[u] = split_mask(m, W)
    kind = np.where(rng.random(N) < 0.9, 5, 4).astype(np.int32)
    tmask = np.zeros((N, W), np.uint32)
    for n in np.nonzero(kind == 5)[0]:
        tmask[n] = split_mask(1 << int(rng.choice(T, p=p)), W)
    dest = np.where(kind == 4, rng.integers(-3, U + 64, N), -1).astype(np.int32)
    valid = rng.random(N) < 0.97
    kz = np.where(valid, kind, 0).astype(np.int32)
    walk = ri.pack(kz, tmask, dest, valid, page_round=64)
    check(not walk.spilled and not ri.overflowed, "ragged inputs spilled")
    local = rng.random(U) < 0.9
    arrays = (walk.pages, walk.walk_page, walk.walk_frame, local,
              masks.view(np.int32), tmask.view(np.int32), kz, dest)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays), walk


def max_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def phase_kernels_vs_plain(device):
    import torch
    from pushcdn_tpu_torch.ops import delivery_kernel as dk
    from pushcdn_tpu_torch.ops import ragged_delivery as rd
    from pushcdn_tpu_torch.testing import kernel_cases as kc
    rng = np.random.default_rng(1)
    errs = {"dense": 0, "ragged": 0}
    cases = [("tile-aligned", 64, 256, 1, False),
             ("ragged edge", 37, 301, 8, False),
             ("ragged edge", 1000, 999, 3, False),
             ("all invalid", 1000, 1000, 1, True),
             ("slice shape", SLICE["users"], SLICE["frames"], 8, False),
             ("bench.py shape", 1024, 65536, 1, False)]
    for label, U, N, W, inv in cases:
        args = dense_inputs(rng, U, N, W, device, all_invalid=inv)
        got = dk.delivery_matrix_cuda(*args)
        torch.cuda.synchronize()
        want = dk.delivery_matrix_reference(*args)
        err = max_err(got, want)
        errs["dense"] = max(errs["dense"], err)
        emit("kernel_vs_plain", kernel="delivery_matrix_cuda", case=label,
             U=U, N=N, W=W, equal=bool(torch.equal(got, want)),
             max_abs_err=err, deliveries=int(want.sum().item()))
        check(torch.equal(got, want), f"delivery_matrix_cuda != plain ({label})")
        if inv:
            check(not got.any(), "an all-invalid batch delivered")
    for label in kc.DENSE_CASES:
        args = kc.as_torch(kc.dense_case(label), device)
        got = dk.delivery_matrix_cuda(*args)
        torch.cuda.synchronize()
        want = dk.delivery_matrix_reference(*args)
        err = max_err(got, want)
        errs["dense"] = max(errs["dense"], err)
        U, N = got.shape
        emit("kernel_vs_plain", kernel="delivery_matrix_cuda", case=label,
             U=U, N=N, W=dk.mask_words(args[0]),
             equal=bool(torch.equal(got, want)), max_abs_err=err,
             deliveries=int(want.sum().item()))
        check(torch.equal(got, want), f"delivery_matrix_cuda != plain ({label})")
    for label in kc.RAGGED_CASES:
        args = kc.as_torch(kc.ragged_case(label), device)
        out, cnt = rd.ragged_delivery_cuda(*args)
        torch.cuda.synchronize()
        r_out, r_cnt = kc.ragged_oracle(*args)
        err = max(max_err(out, r_out), max_err(cnt, r_cnt))
        errs["ragged"] = max(errs["ragged"], err)
        ok = bool(torch.equal(out, r_out) and torch.equal(cnt, r_cnt))
        emit("kernel_vs_plain", kernel="ragged_delivery_cuda", case=label,
             walk_rows=int(args[1].shape[0]), pages=int(args[0].shape[0]),
             equal=ok, max_abs_err=err, deliveries=int(r_cnt.sum().item()))
        check(ok, f"ragged_delivery_cuda != plain ({label})")
    for popularity in ("uniform", "zipf"):
        args, walk = ragged_inputs(rng, popularity, device)
        out, cnt = rd.ragged_delivery_cuda(*args)
        torch.cuda.synchronize()
        r_out, r_cnt = rd.ragged_delivery_reference(*args)
        err = max(max_err(out, r_out), max_err(cnt, r_cnt))
        errs["ragged"] = max(errs["ragged"], err)
        ok = bool(torch.equal(out, r_out) and torch.equal(cnt, r_cnt))
        emit("kernel_vs_plain", kernel="ragged_delivery_cuda",
             case=popularity, walk_rows=int(args[1].shape[0]),
             real_rows=walk.n_walk, pages=int(args[0].shape[0]),
             out_of_range_candidates=int((walk.pages >= SLICE["users"]).sum()),
             equal=ok, max_abs_err=err, deliveries=int(r_cnt.sum().item()))
        check(ok, f"ragged_delivery_cuda != plain ({popularity})")
        check(walk.n_walk < len(walk.walk_page), "no padding entries")
    return errs


# ---------------------------------------------------------------------------
# phase 4: the slice at full size, against a scalar oracle
# ---------------------------------------------------------------------------


class Scenario:
    """Seeded users, churn and traffic for the slice, plus the oracle's
    own view of who is subscribed to what."""

    def __init__(self, popularity: str, seed: int):
        self.rng = np.random.default_rng(seed)
        self.T = SLICE["topics"]
        self.p = topic_weights(self.T, popularity)
        self.users = {}   # key -> topic list
        self.next_id = 0
        self.payload_pool = self.rng.integers(0, 256, 1 << 16,
                                              dtype=np.uint8).tobytes()

    def topics(self, k):
        return sorted({int(t) for t in self.rng.choice(self.T, size=k,
                                                       p=self.p)})

    def add(self, plane):
        key = b"user-%08d" % self.next_id
        self.next_id += 1
        self.users[key] = self.topics(SLICE["topics_per_user"])
        plane.on_user_added(key, self.users[key])

    def churn(self, plane):
        keys = sorted(self.users)
        picks = self.rng.choice(len(keys), 2 * SLICE["churn"], replace=False)
        for i in picks[:SLICE["churn"]]:
            key = keys[i]
            del self.users[key]
            plane.on_user_removed(key)
        for i in picks[SLICE["churn"]:]:
            key = keys[i]
            self.users[key] = self.topics(SLICE["topics_per_user"])
            plane.on_subscription_changed(key, self.users[key])
        for _ in range(SLICE["churn"]):
            self.add(plane)

    def traffic(self, n: int = SLICE["frames"],
                wide_frames: int = SLICE["wide_frames"]):
        """One tick of ``n`` (kind, payload, target) items: broadcasts on
        one topic (two for a tenth of them), directs to current users,
        and ``wide_frames`` frames too wide for the base lane."""
        rng = self.rng
        keys = sorted(self.users)
        wide = set(rng.choice(n, wide_frames, replace=False).tolist())
        items = []
        for i in range(n):
            size = int(rng.integers(4096, 16385)) if i in wide \
                else int(rng.integers(16, 513))
            off = int(rng.integers(0, len(self.payload_pool) - size))
            payload = self.payload_pool[off:off + size]
            if rng.random() < SLICE["direct_share"]:
                items.append((4, payload, keys[int(rng.integers(len(keys)))]))
            else:
                k = 2 if rng.random() < SLICE["two_topic_share"] else 1
                items.append((5, payload, self.topics(k)))
        return items

    @staticmethod
    def user_id(key: bytes) -> int:
        return int(key[5:])

    def oracle(self, items, lanes):
        """Expected delivery codes ``(user id * lanes + lane) * FRAMES +
        frame``, computed with scalar Python over this scenario's own
        subscription table and the best-fit lane rule (rings start empty
        every tick), sorted."""
        by_topic = {}
        for key, topics in self.users.items():
            for t in topics:
                by_topic.setdefault(t, []).append(self.user_id(key))
        by_topic = {t: np.asarray(ids, np.int64) for t, ids in by_topic.items()}
        none = np.empty(0, np.int64)
        used = [0] * len(lanes)
        parts = []
        for kind, payload, target in items:
            lane = next(li for li, (fbytes, slots) in enumerate(lanes)
                        if len(payload) <= fbytes and used[li] < slots)
            frame = used[lane]
            used[lane] += 1
            if kind == 4:
                ids = np.asarray([self.user_id(target)], np.int64) \
                    if target in self.users else none
            else:
                ids = np.unique(np.concatenate(
                    [by_topic.get(t, none) for t in target]))
            parts.append((ids * len(lanes) + lane) * FRAMES + frame)
        return np.sort(np.concatenate(parts))


def run_slice(impl: str, popularity: str, device, seed: int,
              capture=None):
    """Drive the DevicePlane for the slice's ticks, checking every tick
    against the oracle; returns per-tick rows of (staging s, host pack s,
    device step s, pair extraction s, pairs) and the plane."""
    from pushcdn_tpu_torch.broker.device_plane import (
        DevicePlane,
        DevicePlaneConfig,
        StageResult,
    )
    cfg = DevicePlaneConfig(
        num_user_slots=SLICE["users"], ring_slots=2048, frame_bytes=2048,
        extra_lanes=((16384, 64),), topic_words=SLICE["topic_words"],
        delivery_impl=impl, ragged_max_pages=4096)
    plane = DevicePlane(cfg, device=device)
    n_lanes = len(cfg.lane_shapes())
    sc = Scenario(popularity, seed)
    for _ in range(SLICE["initial_users"]):
        sc.add(plane)
    rows = []
    for tick in range(SLICE["ticks"]):
        if tick:
            sc.churn(plane)
        items = sc.traffic()
        t0 = time.perf_counter()
        staged = plane.stage_frames(items)
        stage_s = time.perf_counter() - t0
        check(all(r is StageResult.STAGED for r in staged),
              f"{impl}/{popularity} tick {tick}: not every frame staged")
        if capture is not None and tick == SLICE["ticks"] - 1:
            with capture:
                jobs = plane.step()
        else:
            jobs = plane.step()
        check(plane.delivery_impl == impl,
              f"{impl}/{popularity}: plane switched to {plane.delivery_impl}")
        slot_ids = np.asarray([-1 if k is None else sc.user_id(k) for k in
                               map(plane.slots.key_of, range(cfg.num_user_slots))],
                              np.int64)
        got = []
        for job in jobs:
            # per-user runs, frames ascending within a user
            order = np.lexsort((job.frames, job.users))
            check((order == np.arange(len(order))).all(),
                  f"{impl}/{popularity} tick {tick}: pairs out of order")
            ids = slot_ids[job.users]
            check((ids >= 0).all(), f"{impl}/{popularity} tick {tick}: "
                  "delivery to an unmapped slot")
            got.append((ids * n_lanes + job.lane) * FRAMES
                       + job.frames.astype(np.int64))
        got = np.sort(np.concatenate(got)) if got else np.empty(0, np.int64)
        want = sc.oracle(items, cfg.lane_shapes())
        check(got.shape == want.shape and (got == want).all(),
              f"{impl}/{popularity} tick {tick}: {len(got)} pairs, "
              f"oracle {len(want)}")
        rows.append((stage_s, *plane.recent_steps[-1][:3], len(got)))
    return rows, plane


class Capture:
    """Records the arguments of every kernel launch inside a ``with``
    block (the main path's own inputs, for timing)."""

    def __init__(self):
        from pushcdn_tpu_torch.ops import delivery_kernel as dk
        from pushcdn_tpu_torch.ops import ragged_delivery as rd
        self.mods = {"dense": (dk, "delivery_matrix_cuda"),
                     "ragged": (rd, "ragged_delivery_cuda")}
        self.calls = {"dense": [], "ragged": []}

    def __enter__(self):
        self.saved = {}
        for name, (mod, attr) in self.mods.items():
            orig = getattr(mod, attr)
            self.saved[name] = orig

            def wrapped(*args, _orig=orig, _name=name):
                self.calls[_name].append(tuple(a.clone() for a in args))
                return _orig(*args)
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self.mods.items():
            setattr(mod, attr, self.saved[name])
        return False


# ---------------------------------------------------------------------------
# phase 5: the bench.py shape
# ---------------------------------------------------------------------------


def phase_bench_shape(device):
    import torch
    from pushcdn_tpu_torch.convert import (
        ingress_batch_from_numpy,
        router_state_from_numpy,
    )
    from pushcdn_tpu_torch.ops import delivery_kernel as dk
    from pushcdn_tpu_torch.parallel.router import routing_step_single
    U, S, F, TOPICS = 1024, 65536, 1024, 8
    rng = np.random.default_rng(0)
    masks = rng.integers(1, 2**TOPICS, U).astype(np.uint32)
    state = router_state_from_numpy(
        np.zeros(U, np.int32), np.ones(U, np.uint32), np.zeros(U, np.int32),
        masks, device=device)
    tmask = (1 << rng.integers(0, TOPICS, S)).astype(np.uint32)
    batch = ingress_batch_from_numpy(
        rng.integers(0, 256, (S, F)).astype(np.uint8),
        np.full(S, 5, np.int32), np.full(S, F, np.int32), tmask,
        np.full(S, -1, np.int32), np.ones(S, bool), device=device)
    before = dk.LAUNCHES
    t0 = time.perf_counter()
    res = routing_step_single(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    check(dk.LAUNCHES == before + 1, "bench-shape tick did not launch")
    want = (masks[:, None] & tmask[None, :]) != 0
    got = res.deliver.cpu().numpy()
    check(got.shape == (U, S) and (got == want).all(),
          "bench-shape delivery matrix != numpy oracle")
    emit("bench_shape", U=U, S=S, W=1, deliveries=int(got.sum()),
         step_s=step_s, matches_oracle=True)
    mask_i32 = state.topic_masks
    local = torch.ones(U, dtype=torch.bool, device=device)
    return (mask_i32, local, batch.topic_mask.contiguous(),
            batch.kind.contiguous(), batch.dest.contiguous())


# ---------------------------------------------------------------------------
# phase 6: the mesh tick, four shards folded onto the card
# ---------------------------------------------------------------------------


class MeshScenario(Scenario):
    """The slice's users, churn and traffic spread over broker shards:
    each user belongs to one shard, every shard stages its share of the
    tick's frames, and one user per tick reconnects at another shard."""

    def __init__(self, popularity: str, seed: int, shape: dict):
        super().__init__(popularity, seed)
        self.shape = shape
        self.T = shape["topics"]
        self.p = topic_weights(self.T, popularity)
        self.shard = {}   # key -> owning shard
        self.dead = set()

    def live_shards(self):
        return [s for s in range(self.shape["shards"]) if s not in self.dead]

    def add_at(self, groups, shard: int):
        key = b"user-%08d" % self.next_id
        self.next_id += 1
        self.users[key] = self.topics(self.shape["topics_per_user"])
        self.shard[key] = shard
        for g in groups:
            check(g.claim_user(shard, key, self.users[key]) is None,
                  "a new user kicked someone")

    def stop(self, groups, shard: int):
        self.dead.add(shard)
        for g in groups:
            g.mark_shard_stopped(shard)
        for key in [k for k, s in self.shard.items() if s == shard]:
            del self.users[key], self.shard[key]

    def churn(self, groups):
        """32 removals, 32 subscription changes, 32 adds on live shards
        and one in-group double connect."""
        n = self.shape["churn"]
        keys = sorted(self.users)
        picks = self.rng.choice(len(keys), 2 * n + 1, replace=False)
        for i in picks[:n]:
            key = keys[i]
            shard = self.shard.pop(key)
            del self.users[key]
            for g in groups:
                g.release_user(shard, key)
        for i in picks[n:2 * n]:
            key = keys[i]
            self.users[key] = self.topics(self.shape["topics_per_user"])
            for g in groups:
                g.update_mask(self.shard[key], key, self.users[key])
        live = self.live_shards()
        for i in range(n):
            self.add_at(groups, live[i % len(live)])
        key = keys[picks[2 * n]]
        old = self.shard[key]
        new = int(self.rng.choice([s for s in live if s != old]))
        self.shard[key] = new
        for g in groups:
            check(g.claim_user(new, key, self.users[key]) == (old, key),
                  "the double connect did not kick the old session")

    def mesh_traffic(self):
        """Per shard, its share of the tick's frames as (kind, payload,
        target) items: frame i stages at shard i % shards."""
        B = self.shape["shards"]
        items = self.traffic(self.shape["frames"], self.shape["wide_frames"])
        return [items[s::B] for s in range(B)]

    def code(self, shard, lane, direct, uid, frame):
        """One delivery as an int64: (shard, lane, direct?, user id,
        frame index in the shard's view of the lane)."""
        return ((((np.asarray(shard, np.int64) * 2 + lane) * 2 + direct)
                 * (1 << 20) + uid) * FRAMES + frame)

    def mesh_oracle(self, per_shard, lanes):
        """Expected delivery codes with scalar Python over this
        scenario's own tables: frames placed by the best-fit lane rule
        (rings and buckets start empty every tick), a broadcast delivered
        at each subscriber's shard, a direct at its recipient's shard,
        nothing from a dead shard. Also the expected length arrays of
        each (lane, direct, receiving shard)."""
        B = self.shape["shards"]
        ids_of = {}
        for key, topics in self.users.items():
            for t in topics:
                ids_of.setdefault(t, []).append(self.user_id(key))
        ids_of = {t: np.asarray(v, np.int64) for t, v in ids_of.items()}
        shard_of = np.full(self.next_id, -1, np.int64)
        for key, s in self.shard.items():
            shard_of[self.user_id(key)] = s
        none = np.empty(0, np.int64)
        lengths = {}
        for li, (fbytes, slots, cap) in enumerate(lanes):
            for dst in range(B):
                lengths[(li, True, dst)] = np.zeros(B * cap, np.int32)
            lengths[(li, False)] = np.zeros(B * slots, np.int32)
        codes = []
        for src, items in enumerate(per_shard):
            used = [0] * len(lanes)
            bucket = {}
            for kind, payload, target in items:
                if kind == 4:
                    owner = self.shard[target]
                    li = next(li for li, (f, _s, cap) in enumerate(lanes)
                              if len(payload) <= f
                              and bucket.get((li, owner), 0) < cap)
                    k = bucket.get((li, owner), 0)
                    bucket[(li, owner)] = k + 1
                    frame = src * lanes[li][2] + k
                    lengths[(li, True, owner)][frame] = len(payload)
                    if src not in self.dead:
                        codes.append(self.code(owner, li, 1,
                                               self.user_id(target), frame))
                else:
                    li = next(li for li, (f, slots, _c) in enumerate(lanes)
                              if len(payload) <= f and used[li] < slots)
                    frame = src * lanes[li][1] + used[li]
                    used[li] += 1
                    lengths[(li, False)][frame] = len(payload)
                    if src not in self.dead:
                        ids = np.unique(np.concatenate(
                            [ids_of.get(t, none) for t in target]))
                        codes.append(self.code(shard_of[ids], li, 0, ids,
                                               frame))
        codes = [np.atleast_1d(c) for c in codes]
        return np.sort(np.concatenate(codes)), lengths


class StepRecorder:
    """Wraps a MeshGroup's mesh step and keeps the arguments of its last
    call (the main path's own exchange and routing inputs, for timing)."""

    def __init__(self, step):
        self.step = step
        self.args = None

    def __call__(self, *args):
        self.args = args
        return self.step(*args)


def run_mesh(popularity: str, fused: bool, seed: int, devices, shape: dict,
             capture=None):
    """Drive a MeshGroup on ``devices`` and its twin on the CPU in
    lockstep for the shape's ticks: every tick's pairs against the
    oracle, and the two groups' outputs against each other. Returns the
    card group's per-tick rows (stage s, host snapshot and upload s, mesh
    step through readback s, pair extraction s, pairs, collectives), its
    group, and the recorder of its mesh step's arguments."""
    from pushcdn_tpu_torch.broker.device_plane import StageResult
    from pushcdn_tpu_torch.broker.mesh_group import (
        MeshGroup,
        MeshGroupConfig,
    )
    from pushcdn_tpu_torch.parallel.mesh import make_broker_mesh
    B = shape["shards"]
    cfg = MeshGroupConfig(
        num_user_slots=shape["users"], ring_slots=shape["ring_slots"],
        direct_bucket_slots=shape["direct_bucket_slots"],
        frame_bytes=shape["frame_bytes"],
        extra_lanes=(shape["extra_lane"],),
        topic_words=shape["topic_words"], fused_collective=fused)
    card = MeshGroup(make_broker_mesh(B, devices=devices), cfg)
    card.step_fn = recorder = StepRecorder(card.step_fn)
    cpu = MeshGroup(make_broker_mesh(B, devices=["cpu"] * B), cfg)
    groups = (card, cpu)
    lanes = cfg.lane_shapes()
    sc = MeshScenario(popularity, seed, shape)
    for i in range(shape["initial_users"]):
        sc.add_at(groups, i % B)
    label = f"mesh {popularity}/{'fused' if fused else 'per-array'}"
    rows = []
    for tick in range(shape["ticks"]):
        if tick == shape["ticks"] - 2:
            sc.stop(groups, B - 1)   # the shard-stop sweep
        if tick:
            sc.churn(groups)
        per_shard = sc.mesh_traffic()
        t0 = time.perf_counter()
        staged = [card.stage_batch(s, items)
                  for s, items in enumerate(per_shard)]
        stage_s = time.perf_counter() - t0
        check(all(r is StageResult.STAGED for rs in staged for r in rs),
              f"{label} tick {tick}: not every frame staged")
        check([cpu.stage_batch(s, items) for s, items in enumerate(per_shard)]
              == staged, f"{label} tick {tick}: CPU staging differs")
        if capture is not None and tick == shape["ticks"] - 1:
            with capture:
                got = card.step()
        else:
            got = card.step()
        want = cpu.step()
        check(len(got) == len(want) and all(
            (g.shard, g.lane, g.direct) == (w.shard, w.lane, w.direct)
            and np.array_equal(g.users, w.users)
            and np.array_equal(g.frames, w.frames)
            and np.array_equal(g.length, w.length)
            and np.array_equal(g.bytes_, w.bytes_)
            for g, w in zip(got, want)),
            f"{label} tick {tick}: the card's pairs differ from the CPU's")
        check(not fused or card.collectives_last_step == 1,
              f"{label} tick {tick}: {card.collectives_last_step} "
              "collectives in a fused tick")
        slot_uid = np.asarray(
            [-1 if k is None else sc.user_id(k)
             for k in map(card.slots.key_of, range(cfg.num_user_slots))],
            np.int64)
        want_codes, want_len = sc.mesh_oracle(per_shard, lanes)
        parts = []
        for d in got:
            uids = slot_uid[d.users]
            check((uids >= 0).all(), f"{label} tick {tick}: delivery to an "
                  "unmapped slot")
            check(d.shard not in sc.dead,
                  f"{label} tick {tick}: stopped shard {d.shard} delivered")
            key = (d.lane, True, d.shard) if d.direct else (d.lane, False)
            check(np.array_equal(d.length, want_len[key]),
                  f"{label} tick {tick}: frame lengths differ")
            parts.append(sc.code(d.shard, d.lane, int(d.direct), uids,
                                 d.frames.astype(np.int64)))
        got_codes = np.sort(np.concatenate(parts)) if parts \
            else np.empty(0, np.int64)
        check(got_codes.shape == want_codes.shape
              and (got_codes == want_codes).all(),
              f"{label} tick {tick}: {len(got_codes)} pairs, oracle "
              f"{len(want_codes)}")
        rows.append((stage_s, *card.last_step_seconds, len(got_codes),
                     card.collectives_last_step))
    return rows, card, recorder


def phase_mesh(devices, shape: dict = MESH):
    """Phase 6: the MeshGroup on ``devices`` for uniform and zipf
    interest, each with the fused and the per-array exchange, then
    ``dryrun_multichip``. Each MeshGroup run must launch the dense
    kernel. Returns the per-run tick rows, the dense kernel's captured
    launches of each run's last tick, the recorders of each run's mesh
    step, its launches per tick, and its launches over the MeshGroup runs
    (the dryrun's are reported on their own line)."""
    from pushcdn_tpu_torch.entry import dryrun_multichip
    from pushcdn_tpu_torch.ops import delivery_kernel as dk
    steps, captured, recorded, launches = {}, {}, {}, {}
    for seed, (popularity, fused) in enumerate(
            (p, f) for p in ("uniform", "zipf") for f in (True, False)):
        schedule = "fused" if fused else "per-array"
        key = (popularity, schedule)
        cap = Capture()
        dk.LAUNCHES = 0
        rows, group, recorded[key] = run_mesh(popularity, fused, 10 + seed,
                                              devices, shape, cap)
        launches[key] = dk.LAUNCHES
        captured[key] = cap.calls["dense"]
        steps[key] = rows
        emit("mesh", popularity=popularity, schedule=schedule,
             shards=shape["shards"], devices=devices, users=shape["users"],
             topics=shape["topics"], frames_per_tick=shape["frames"],
             ticks=len(rows), stopped_shard=shape["shards"] - 1,
             stopped_from_tick=shape["ticks"] - 2,
             pairs_per_tick=[r[4] for r in rows],
             collectives_per_tick=[r[5] for r in rows],
             matches_oracle=True, matches_cpu=True, steps=group.steps,
             overflows=group.overflows,
             delivery_matrix_cuda=launches[key])
        check(launches[key] > 0, f"mesh {popularity}/{schedule} never "
              "launched delivery_matrix_cuda")
    per_tick = {k: v / len(steps[k]) for k, v in launches.items()}
    emit("mesh_launches", delivery_matrix_cuda=sum(launches.values()),
         per_tick=[{"popularity": k[0], "schedule": k[1], "launches": v}
                   for k, v in per_tick.items()])
    dk.LAUNCHES = 0
    t0 = time.perf_counter()
    dry = dryrun_multichip(shape["shards"], devices=devices)
    emit("mesh_dryrun", shards=shape["shards"], devices=devices,
         seconds=time.perf_counter() - t0, delivery_matrix_cuda=dk.LAUNCHES,
         **dry)
    return steps, captured, recorded, per_tick, sum(launches.values())


# ---------------------------------------------------------------------------
# phase 8: the broker, users over the Memory transport
# ---------------------------------------------------------------------------


class Burst(NamedTuple):
    """One burst: per publisher its wire frames (send time 0) and its
    messages as ``(direct, target, body without the send time)``; the
    oracle's delivery codes, and per user the frame and payload bytes it
    must receive."""

    frames: list
    messages: list
    codes: np.ndarray
    nbytes: np.ndarray
    payload_bytes: np.ndarray


class BrokerScenario:
    """Seeded subscriptions and bursts for the broker phases, with the
    oracle's own view of who receives what. A delivery is coded
    ``uid << 40 | (publisher * 2 + lane) << 32 | seq``, lane 1 for a frame
    wider than the base lane; ``seq`` rises through the run. User ``uid``
    is ``keys[uid]`` (``user-<uid>`` by default)."""

    def __init__(self, popularity: str, seed: int, shape: dict, keys=None):
        self.rng = np.random.default_rng(seed)
        self.shape = shape
        self.keys = keys or [b"user-%d" % u for u in range(shape["users"])]
        self.subscribe(popularity)
        self.filler = self.rng.integers(0, 256, 1 << 15,
                                        dtype=np.uint8).tobytes()
        self.seq = 0

    def subscribe(self, popularity: str) -> None:
        """Draw every user's topics anew under ``popularity``."""
        self.popularity = popularity
        self.p = topic_weights(self.shape["topics"], popularity)
        self.topics = [self.draw(self.shape["topics_per_user"])
                       for _ in range(self.shape["users"])]
        by_topic = {}
        for uid, topics in enumerate(self.topics):
            for t in topics:
                by_topic.setdefault(t, []).append(uid)
        self.by_topic = {t: np.asarray(v, np.int64)
                         for t, v in by_topic.items()}

    def draw(self, k):
        return sorted({int(t) for t in self.rng.choice(
            self.shape["topics"], size=k, p=self.p)})

    def burst(self, pubs=None, alive=None, direct_pool=None) -> Burst:
        """One burst, frame i from publisher ``pubs[i % len(pubs)]`` (by
        default users 0..publishers-1): broadcasts on one topic (two for
        a tenth of them), directs to any user (or to one of
        ``direct_pool(publisher)``), ``wide_frames`` frames for the wide
        lane. ``frames[j]`` and ``messages[j]`` are publisher
        ``pubs[j]``'s. Only users marked in ``alive`` (default: all)
        receive."""
        from pushcdn_tpu_torch.proto.message import (
            Broadcast,
            Direct,
            serialize,
        )
        s, rng = self.shape, self.rng
        n, U = s["frames"], s["users"]
        pubs = list(range(s["publishers"])) if pubs is None else list(pubs)
        P = len(pubs)
        wide = set(rng.choice(n, s["wide_frames"], replace=False).tolist())
        frames = [[] for _ in range(P)]
        messages = [[] for _ in range(P)]
        codes = []
        nbytes = np.zeros(U, np.int64)
        payload_bytes = np.zeros(U, np.int64)
        for i in range(n):
            pub, seq = pubs[i % P], self.seq
            self.seq += 1
            size = int(rng.integers(4096, 16001)) if i in wide \
                else int(rng.integers(16, 513))
            off = int(rng.integers(0, len(self.filler) - size))
            body = self.filler[off:off + size] + TAIL.pack(pub, seq, 0)
            if rng.random() < s["direct_share"]:
                if direct_pool is None:
                    uid = int(rng.integers(U))
                else:
                    pool = direct_pool(pub)
                    uid = int(pool[int(rng.integers(len(pool)))])
                target = self.keys[uid]
                frame = serialize(Direct(target, body))
                uids = np.asarray([uid], np.int64)
            else:
                k = 2 if rng.random() < s["two_topic_share"] else 1
                target = self.draw(k)
                frame = serialize(Broadcast(target, body))
                uids = np.unique(np.concatenate(
                    [self.by_topic.get(t, np.empty(0, np.int64))
                     for t in target]))
            if alive is not None:
                uids = uids[alive[uids]]
            lane = int(len(frame) > s["frame_bytes"])
            frames[i % P].append(frame)
            messages[i % P].append((isinstance(target, bytes), target,
                                    body[:-8]))
            codes.append((uids << 40) | (((pub * 2 + lane) << 32) | seq))
            nbytes[uids] += len(frame)
            payload_bytes[uids] += len(body)
        return Burst(frames, messages, np.concatenate(codes), nbytes,
                     payload_bytes)


ROUTE_PATHS = ("cutthrough", "residual", "scalar")


def route_frames() -> dict:
    """This process's ``cdn_route_batch_frames`` by path so far."""
    from pushcdn_tpu_torch.proto import metrics
    return {p: metrics.ROUTE_FRAMES.labels(path=p).value
            for p in ROUTE_PATHS}


def route_delta(before: dict) -> dict:
    after = route_frames()
    return {p: int(after[p] - before[p]) for p in ROUTE_PATHS}


async def publish_and_drain(label: str, remotes: list, bursts: list,
                            base: int) -> tuple:
    """Publish ``bursts`` from users 0..P-1 (``remotes`` are every user's
    remote ends, over the Memory transport), ``PUBLISH_GROUP`` publishers'
    frames a turn of the event loop, each burst drained before the next,
    while every user's remote end drains and records what arrives.
    Returns per user its delivery codes (without the uid) and bytes, the
    publish-to-receive latencies in ns and the bursts' busy seconds."""
    got = [[] for _ in remotes]
    got_bytes = [0] * len(remotes)
    latency_ns = []
    seen = [0, 0]   # frames received, perf_counter ns of the last

    async def drain(uid, remote):
        box = got[uid]
        while True:
            raws = await remote.recv_raw_many()
            now = time.perf_counter_ns()
            for raw in raws:
                d = raw.data
                pub, seq, sent = TAIL.unpack_from(d, len(d) - TAIL.size)
                box.append(((pub * 2 + (len(d) > base)) << 32) | seq)
                got_bytes[uid] += len(d)
                latency_ns.append(now - sent)
                raw.release()
            seen[0] += len(raws)
            seen[1] = now

    drains = [asyncio.create_task(drain(uid, remote))
              for uid, remote in enumerate(remotes)]
    busy_s = 0.0
    want_total = 0
    try:
        for frames, _, codes, _, _ in bursts:
            want_total += len(codes)
            t0 = time.perf_counter_ns()
            for pub, pub_frames in enumerate(frames):
                stamp = struct.pack("<q", time.perf_counter_ns())
                await remotes[pub].send_raw_many(
                    [f[:-8] + stamp for f in pub_frames])
                if pub % PUBLISH_GROUP == PUBLISH_GROUP - 1:
                    await asyncio.sleep(0)
            async with asyncio.timeout(300):
                while seen[0] < want_total:
                    await asyncio.sleep(0.002)
            busy_s += (seen[1] - t0) / 1e9
        # a duplicate or a stray frame would land in this window
        await asyncio.sleep(0.2)
    except TimeoutError:
        raise SmokeFailure(f"{label}: {seen[0]} of {want_total} "
                           "frames arrived") from None
    finally:
        for t in drains:
            t.cancel()
        ends = await asyncio.gather(*drains, return_exceptions=True)
    check(all(isinstance(e, asyncio.CancelledError) for e in ends),
          f"{label}: a receiver failed: "
          f"{[e for e in ends if not isinstance(e, asyncio.CancelledError)][:1]}")
    return got, got_bytes, latency_ns, busy_s


def check_in_process_deliveries(label: str, got: list, got_bytes: list,
                                bursts: list):
    """Every user's frames against the oracle, its bytes, and publisher
    order per lane. Returns the oracle's sorted delivery codes."""
    want = np.sort(np.concatenate([b.codes for b in bursts]))
    have = np.sort(np.concatenate(
        [np.empty(0, np.int64)]
        + [(np.int64(uid) << 40) | np.asarray(c, np.int64)
           for uid, c in enumerate(got)]))
    check(have.shape == want.shape and (have == want).all(),
          f"{label}: the {len(have)} deliveries differ from the oracle's "
          f"{len(want)}")
    check(np.array_equal(np.asarray(got_bytes),
                         sum(b.nbytes for b in bursts)),
          f"{label}: received bytes differ from the oracle's")
    for uid, c in enumerate(got):
        c = np.asarray(c, np.int64)
        order = np.argsort(c >> 32, kind="stable")
        hi, seq = (c >> 32)[order], (c & 0xFFFFFFFF)[order]
        check(((np.diff(seq) > 0) | (np.diff(hi) != 0)).all(),
              f"{label}: user {uid} got a publisher's frames out of order")
    return want


async def broker_run(impl: str, popularity: str, seed: int, device,
                     shape: dict) -> dict:
    """One run of the broker phase: a broker with a device plane of
    ``impl`` on ``device``, or none: ``impl="host"`` routes as the
    reference does by default (``PUSHCDN_ROUTE_CUTTHROUGH`` unset: the
    cut-through plane). Its users are injected over the Memory transport, the
    scenario's bursts published and drained; every check of the run,
    then its numbers."""
    from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
    from pushcdn_tpu_torch.broker.device_plane import DevicePlaneConfig
    from pushcdn_tpu_torch.broker.tasks import cutthrough
    from pushcdn_tpu_torch.broker.test_harness import TestRun
    from pushcdn_tpu_torch.ops import delivery_kernel as dk
    from pushcdn_tpu_torch.ops import ragged_delivery as rd
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.def_ import testing_run_def
    from pushcdn_tpu_torch.proto.topic import TopicSpace
    from pushcdn_tpu_torch.proto.transport.memory import Memory

    label = f"broker {impl}/{popularity}"
    U, base = shape["users"], shape["frame_bytes"]
    sc = BrokerScenario(popularity, seed, shape)
    bursts = [sc.burst() for _ in range(shape["bursts"][popularity])]
    host = impl == "host"
    route = cutthrough.ROUTE_IMPL
    plane_cfg = None if host else DevicePlaneConfig(
        num_user_slots=U, ring_slots=shape["ring_slots"], frame_bytes=base,
        extra_lanes=(shape["extra_lane"],), topic_words=shape["topic_words"],
        bypass_max_items=0, delivery_impl=impl, ragged_max_pages=4096)
    build = os.path.join(HERE, ".build")
    os.makedirs(build, exist_ok=True)
    db = os.path.join(build, f"smoke-discovery-{os.getpid()}.sqlite")
    name = f"smoke-{impl}-{popularity}"
    # the JAX package's forwarding bench widens the in-process pipes the
    # same way, so 16 KB frames are not chopped into 8 KB writes
    prev_window = Memory.set_duplex_window(256 * 1024)
    t_run = time.perf_counter()
    try:
        broker = await Broker.new(BrokerConfig(
            run_def=testing_run_def(
                topics=TopicSpace.range(shape["topics"])),
            keypair=DEFAULT_SCHEME.generate_keypair(seed=seed),
            discovery_endpoint=db, public_advertise_endpoint=f"{name}-pub",
            public_bind_endpoint=f"{name}-pub",
            private_advertise_endpoint=f"{name}-priv",
            private_bind_endpoint=f"{name}-priv",
            heartbeat_interval_s=3600, sync_interval_s=3600,
            whitelist_interval_s=3600, device_plane=plane_cfg,
            device=device))
        warm = (dk.LAUNCHES, rd.LAUNCHES)
        await broker.start()   # the plane warms both lane shapes up
        warm = (dk.LAUNCHES - warm[0], rd.LAUNCHES - warm[1])
        run = TestRun(broker=broker)
        try:
            await run.inject_users(sc.topics)
            plane = broker.device_plane
            dk.LAUNCHES = 0
            rd.LAUNCHES = 0
            paths0 = route_frames()
            try:
                got, got_bytes, latency_ns, busy_s = await publish_and_drain(
                    label, [u.remote for u in run.connected_users], bursts,
                    base)
            finally:
                launches = (dk.LAUNCHES, rd.LAUNCHES)
                paths = route_delta(paths0)
            stats = plane_stats(plane)
        finally:
            await run.shutdown()
    finally:
        Memory.set_duplex_window(prev_window)
        if os.path.exists(db):
            os.remove(db)

    want = check_in_process_deliveries(label, got, got_bytes, bursts)
    if plane is not None:
        check(not plane.disabled, f"{label}: the device plane disabled itself")
        check(plane.steps > 0, f"{label}: the plane never stepped")
        check(plane.messages_routed == len(want),
              f"{label}: the plane routed {plane.messages_routed} of "
              f"{len(want)} deliveries; the rest took the host path")
        check(plane.delivery_impl == impl,
              f"{label}: the plane switched to {plane.delivery_impl}")
    else:
        check(launches == (0, 0), f"{label}: the host path launched a kernel")
    # which path routed the publishers' frames (every one a Broadcast or a
    # Direct): the cut-through plan on the reference's default host path,
    # the scalar loops under a plane (acquire refuses a broker with a
    # plane)
    sent = sum(len(f) for b in bursts for f in b.frames)
    want_paths = ({"cutthrough": sent, "residual": 0, "scalar": 0}
                  if impl == "host"
                  else {"cutthrough": 0, "residual": 0, "scalar": sent})
    check(paths == want_paths, f"{label}: route {route} routed the "
          f"publishers' {sent} frames by path {paths}, not {want_paths}")
    lat_ms = np.asarray(latency_ns, np.float64) / 1e6
    return dict(
        impl=impl, popularity=popularity, route=route,
        cdn_route_batch_frames=paths,
        path="device plane" if plane is not None
        else "the port's host path (cut-through plane), same machine",
        users=U, topics=shape["topics"], publishers=shape["publishers"],
        bursts=len(bursts), frames_per_burst=shape["frames"],
        deliveries=len(want), matches_oracle=True,
        fifo_per_publisher_and_lane=True,
        delivered_msgs_per_s=len(want) / busy_s,
        publish_to_receive_ms_p50=float(np.percentile(lat_ms, 50)),
        publish_to_receive_ms_p99=float(np.percentile(lat_ms, 99)),
        busy_s=busy_s, run_s=time.perf_counter() - t_run,
        delivery_matrix_cuda=launches[0], ragged_delivery_cuda=launches[1],
        warmup_launches={"delivery_matrix_cuda": warm[0],
                         "ragged_delivery_cuda": warm[1]},
        **stats)


def plane_stats(plane) -> dict:
    """The plane's counters and per-step medians over the pump's steps
    (host snapshot, device step, the native encode on a dense step or
    pair extraction on a ragged one, egress), in ms."""
    if plane is None:
        return {}
    r = np.asarray(plane.recent_steps, np.float64).reshape(-1, 6)
    med = (lambda col: float(np.median(r[:, col]) * 1e3)) if len(r) \
        else (lambda col: None)
    third = ("encode_ms_median" if plane.delivery_impl == "dense"
             else "pair_extract_ms_median")
    return dict(
        steps=plane.steps, messages_routed=plane.messages_routed,
        ragged_steps=plane.ragged_steps,
        ragged_fallbacks=plane.ragged_fallbacks,
        busy_steps=plane.busy_steps,
        native_egress_steps=plane.native_egress_steps,
        frames_per_step_median=float(np.median(r[:, 4])) if len(r) else None,
        snapshot_ms_median=med(0), device_step_ms_median=med(1),
        **{third: med(2)}, egress_ms_median=med(3))


def phase_broker(device, shape: dict = BROKER):
    """Phase 8: dense and ragged at uniform and zipf interest, then the
    same bursts with no device plane on the reference's default host path
    (the cut-through plane); the run on its scalar twin was cut for the
    script's time limit (the twin is held against the cut-through plane
    frame for frame on the CPU). Returns each run's line and the kernels'
    launches over the device runs' traffic; fails unless each device run
    launched its kernel."""
    rows = {}
    for impl, popularity in (("dense", "uniform"), ("dense", "zipf"),
                             ("ragged", "uniform"), ("ragged", "zipf"),
                             ("host", "uniform"), ("host", "zipf")):
        # one seed per popularity: every impl takes the same bursts
        seed = 40 + (popularity == "zipf")
        rows[(impl, popularity)] = row = asyncio.run(
            broker_run(impl, popularity, seed, device, shape))
        if (impl, popularity) == ("host", "uniform"):
            row["cut"] = ("no host-scalar run, for the script's time limit: "
                          "the scalar twin is held on the CPU")
        emit("broker", **row)
    for (impl, popularity), row in rows.items():
        if impl == "dense":
            check(row["delivery_matrix_cuda"] > 0, f"broker dense/{popularity}"
                  " never launched delivery_matrix_cuda")
            check(row["native_egress_steps"] == row["busy_steps"] > 0,
                  f"broker dense/{popularity}: {row['native_egress_steps']} "
                  f"of {row['busy_steps']} busy steps egressed through "
                  "native.egress_encode")
        if impl == "ragged":
            check(row["ragged_delivery_cuda"] > 0 and row["ragged_steps"] > 0,
                  f"broker ragged/{popularity} never launched "
                  "ragged_delivery_cuda")
    # the planes' delivered msgs/s over each host path's on the same
    # bursts (reported, not claimed)
    rate = {k: r["delivered_msgs_per_s"] for k, r in rows.items()}
    emit("broker_ratio", **{
        f"{impl}_{pop}_over_host": rate[(impl, pop)] / rate[("host", pop)]
        for impl in ("dense", "ragged") for pop in ("uniform", "zipf")})
    launches = {"dense": sum(r["delivery_matrix_cuda"] for r in rows.values()),
                "ragged": sum(r["ragged_delivery_cuda"] for r in rows.values())}
    return rows, launches


# ---------------------------------------------------------------------------
# phase 9: the cluster as processes, clients over TCP+TLS
# ---------------------------------------------------------------------------


def raise_fd_limit() -> int:
    """Raise this process's soft limit of open files to the hard limit
    (children inherit it); returns the new limit."""
    import resource
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft != hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    return resource.getrlimit(resource.RLIMIT_NOFILE)[0]


def free_ports(n: int) -> list:
    import socket
    socks = [socket.socket() for _ in range(n)]
    for sock in socks:
        sock.bind(("127.0.0.1", 0))
    ports = [sock.getsockname()[1] for sock in socks]
    for sock in socks:
        sock.close()
    return ports


def log_tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            return f.read().decode(errors="replace")[-n:]
    except OSError:
        return ""


def log_all_fields(path: str, what: str) -> list:
    """The JSON of every ``<what> {...}`` line the broker binary wrote."""
    found = []
    for line in log_tail(path, 1 << 20).splitlines():
        at = line.find(what + " {")
        if at >= 0:
            found.append(json.loads(line[at + len(what) + 1:]))
    return found


def log_fields(path: str, what: str):
    """The JSON of the last ``<what> {...}`` line the broker binary wrote,
    or None."""
    found = log_all_fields(path, what)
    return found[-1] if found else None


class Children:
    """The child processes of one run, each logging to its own file; any
    left running is killed when the run ends, on every path."""

    def __init__(self, tag: str):
        self.tag = tag
        self.procs = {}
        self.logs = {}

    def spawn(self, name: str, *args: str, env=None, binary=None):
        """Start ``pushcdn_tpu_torch.bin.<binary>`` (default: ``name``)
        as the child ``name``."""
        from pushcdn_tpu_torch.bin.common import spawn_binary
        log = os.path.join(HERE, ".build", f"{self.tag}-{name}.log")
        if os.path.exists(log):
            os.remove(log)
        self.logs[name] = log
        self.procs[name] = spawn_binary(binary or name, *args, env_extra=env,
                                        log_path=log)

    def check_alive(self, label: str) -> None:
        for name, proc in self.procs.items():
            rc = proc.poll()
            check(rc is None, f"{label}: the {name} process exited with {rc}:"
                  f"\n{log_tail(self.logs[name])}")

    async def wait_for_line(self, name: str, what: str, label: str,
                            timeout: float, count: int = 1):
        """The last ``what`` line of the child ``name``, once it has
        written ``count`` of them (a sharded broker's workers log to one
        file, each its own line)."""
        try:
            async with asyncio.timeout(timeout):
                while len(found := log_all_fields(self.logs[name],
                                                  what)) < count:
                    self.check_alive(label)
                    await asyncio.sleep(0.1)
        except TimeoutError:
            raise SmokeFailure(f"{label}: {len(found)} of {count} {what!r} "
                               f"lines from the {name} in {timeout} s:\n"
                               f"{log_tail(self.logs[name])}") from None
        return found[-1]

    def terminate(self, label: str, timeout: float = 60.0) -> None:
        """SIGTERM every child; each must exit 0 within ``timeout``."""
        import signal
        for proc in self.procs.values():
            proc.send_signal(signal.SIGTERM)
        rcs = {}
        for name, proc in self.procs.items():
            try:
                rcs[name] = proc.wait(timeout)
            except subprocess.TimeoutExpired:
                rcs[name] = None
        for name, rc in rcs.items():
            check(rc == 0, f"{label}: the {name} process exited with {rc} "
                  f"on SIGTERM:\n{log_tail(self.logs[name])}")

    def kill(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def http_get(port: int, path: str):
    """``(status, body)`` of a GET on the loopback, or None when refused."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    except OSError:
        return None


def metric(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[-1])
    return 0.0


def metric_sum(text: str, name: str, **labels) -> float:
    """The sum of ``name``'s labelled samples that carry every label of
    ``labels`` (a sharded broker's supervisor serves one sample a worker
    shard, each with its ``shard`` label; a family's unlabelled total is
    not one of them)."""
    want = [f'{k}="{v}"' for k, v in labels.items()]
    total = 0.0
    for line in text.splitlines():
        if line.startswith(name + "{") and all(
                w in line[:line.rfind("}")] for w in want):
            total += float(line.split()[-1])
    return total


def metrics_port(workers: int, taken=()) -> int:
    """A free loopback port, none of ``taken``, whose next ``workers``
    ports are free too: a sharded broker's supervisor serves its merged
    endpoints there and each worker shard its own on the next ports."""
    import socket
    for _ in range(100):
        base = free_ports(1)[0]
        if any(base + k in taken for k in range(workers + 1)):
            continue
        socks = []
        try:
            for k in range(1, workers + 1):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + k))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise SmokeFailure(f"no {workers + 1} free loopback ports in a row")


def percentiles_ms(latency_ns) -> dict:
    lat = np.asarray(latency_ns, np.float64) / 1e6
    return dict(publish_to_receive_ms_p50=float(np.percentile(lat, 50)),
                publish_to_receive_ms_p99=float(np.percentile(lat, 99)))


async def cluster_run(impl: str, seed: int, shape: dict,
                      device=None, shards: int = 1) -> dict:
    """One run of phase 9: a marshal and a broker (with a device plane of
    ``impl``, or none for ``impl="host"``) as child processes on a fresh
    discovery file, ``users`` clients authenticating through the marshal
    over TCP+TLS, the uniform bursts, and for a plane run every client's
    subscriptions redrawn zipf through ``Client.subscribe`` and
    ``unsubscribe`` and the zipf bursts. The plane runs on the binary's
    default device (CUDA) unless ``device`` names another. ``shards`` > 1
    starts the plane-less broker as ``--shards`` worker shards (phase 14):
    its supervisor's merged ``/debug/topology`` must show users on every
    worker, its merged ``/metrics`` ring handoffs and every worker's
    ``cdn_build_info`` torch as absent. Every check of the run, then its
    numbers."""
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.message import Broadcast, Direct
    from pushcdn_tpu_torch.proto.transport import TcpTls

    label = f"cluster {impl}" + (f" --shards {shards}" if shards > 1 else "")
    check(shards == 1 or impl == "host",
          f"{label}: worker shards run without a plane")
    U, P = shape["users"], shape["publishers"]
    pairs = [DEFAULT_SCHEME.generate_keypair(seed=seed * 1_000_000 + u)
             for u in range(U)]
    sc = BrokerScenario("uniform", seed, shape,
                        keys=[k.public_key for k in pairs])
    first_topics = sc.topics
    plan = [("uniform", sc.burst())
            for _ in range(shape["bursts"]["uniform"])]
    if impl != "host":
        sc.subscribe("zipf")
        plan += [("zipf", sc.burst()) for _ in range(shape["bursts"]["zipf"])]
    tag = f"cluster-{impl}-{shards}-{os.getpid()}"
    db = os.path.join(HERE, ".build", f"{tag}.sqlite")
    for suffix in ("", "-wal", "-shm"):
        if os.path.exists(db + suffix):
            os.remove(db + suffix)
    pub, priv, marshal, marshal_metrics = ports = free_ports(4)
    broker_metrics = metrics_port(shards if shards > 1 else 0, ports)
    kids = Children(tag)
    clients = []
    drains = []
    t_run = time.perf_counter()
    try:
        kids.spawn("broker", "--discovery-endpoint", db,
                   "--public-advertise-endpoint", f"127.0.0.1:{pub}",
                   "--public-bind-endpoint", f"127.0.0.1:{pub}",
                   "--private-advertise-endpoint", f"127.0.0.1:{priv}",
                   "--private-bind-endpoint", f"127.0.0.1:{priv}",
                   "--metrics-bind-endpoint", f"127.0.0.1:{broker_metrics}",
                   "--user-transport", "tcp+tls", "--broker-transport", "tcp",
                   *(["--device-plane"] if impl != "host" else []),
                   *(["--device", str(device)] if device else []),
                   *(["--shards", str(shards)] if shards > 1 else []),
                   env={"PUSHCDN_DELIVERY_IMPL": impl} if impl != "host"
                   else None)
        kids.spawn("marshal", "--discovery-endpoint", db,
                   "--bind-endpoint", f"127.0.0.1:{marshal}",
                   "--metrics-bind-endpoint", f"127.0.0.1:{marshal_metrics}",
                   "--user-transport", "tcp+tls")
        # the broker logs this line once its plane has warmed up (each
        # worker shard its own)
        serving = await kids.wait_for_line("broker", "broker serving", label,
                                           timeout=180, count=shards)
        startup_s = time.perf_counter() - t_run
        try:
            async with asyncio.timeout(60):   # the broker registered
                while (await asyncio.to_thread(http_get, marshal_metrics,
                                               "/readyz") or (0,))[0] != 200:
                    kids.check_alive(label)
                    await asyncio.sleep(0.1)
        except TimeoutError:
            raise SmokeFailure(f"{label}: the marshal was not ready in 60 s:"
                               f"\n{log_tail(kids.logs['marshal'])}") from None

        clients = [Client(ClientConfig(
            marshal_endpoint=f"127.0.0.1:{marshal}", keypair=kp,
            protocol=TcpTls, subscribed_topics=set(topics)))
            for kp, topics in zip(pairs, first_topics)]
        gate = asyncio.Semaphore(shape["auth_concurrency"])

        async def authenticate(client):
            async with gate:
                await client.ensure_initialized()

        t0 = time.perf_counter()
        try:
            async with asyncio.timeout(300):
                await asyncio.gather(*(authenticate(c) for c in clients))
        except TimeoutError:
            raise SmokeFailure(f"{label}: the clients did not all "
                               "authenticate in 300 s") from None
        auth_s = time.perf_counter() - t0
        kids.check_alive(label)

        got = [[] for _ in range(U)]
        got_bytes = np.zeros(U, np.int64)
        latency_ns = []
        seen = [0, 0, 0]   # frames, barriers, perf_counter ns of the last

        async def drain(uid, client):
            box = got[uid]
            while True:
                messages = await client.receive_messages()
                now = time.perf_counter_ns()
                for m in messages:
                    body = m.message
                    pub_, seq, sent = TAIL.unpack_from(body,
                                                       len(body) - TAIL.size)
                    if pub_ == BARRIER:
                        seen[1] += 1
                        continue
                    box.append((pub_ * 2 << 32) | seq)
                    got_bytes[uid] += len(body)
                    latency_ns.append(now - sent)
                    seen[0] += 1
                seen[2] = now

        drains = [asyncio.create_task(drain(uid, c))
                  for uid, c in enumerate(clients)]

        async def publish(burst):
            async def one(pub_):
                client = clients[pub_]
                for direct, target, head in burst.messages[pub_]:
                    body = head + struct.pack("<q", time.perf_counter_ns())
                    await client.send_message(
                        Direct(target, body) if direct
                        else Broadcast(target, body))
            await asyncio.gather(*(one(p) for p in range(P)))

        async def resubscribe():
            """Every client moves to its zipf topics, then sends itself a
            barrier: once it is back, the broker has applied the change."""
            async def one(uid):
                old, new = first_topics[uid], sc.topics[uid]
                await clients[uid].unsubscribe([t for t in old
                                                if t not in new])
                await clients[uid].subscribe(new)
                await clients[uid].send_message(Direct(
                    pairs[uid].public_key, TAIL.pack(BARRIER, uid, 0)))
            await asyncio.gather(*(one(u) for u in range(U)))
            async with asyncio.timeout(120):
                while seen[1] < U:
                    await asyncio.sleep(0.005)

        runs = {}
        want_total = 0
        resubscribe_s = None
        try:
            for popularity, burst in plan:
                if popularity == "zipf" and resubscribe_s is None:
                    t0 = time.perf_counter()
                    await resubscribe()
                    resubscribe_s = time.perf_counter() - t0
                want_total += len(burst.codes)
                first_latency = len(latency_ns)
                t0 = time.perf_counter_ns()
                await publish(burst)
                async with asyncio.timeout(300):
                    while seen[0] < want_total:
                        kids.check_alive(label)
                        await asyncio.sleep(0.002)
                r = runs.setdefault(popularity, dict(
                    bursts=0, deliveries=0, busy_s=0.0, latency_ns=[]))
                r["bursts"] += 1
                r["deliveries"] += len(burst.codes)
                r["busy_s"] += (seen[2] - t0) / 1e9
                r["latency_ns"] += latency_ns[first_latency:]
            # a duplicate or a stray frame would land in this window
            await asyncio.sleep(0.3)
        except TimeoutError:
            raise SmokeFailure(f"{label}: {seen[0]} of {want_total} frames "
                               f"and {seen[1]} barriers arrived") from None
        finally:
            for t in drains:
                t.cancel()
            ends = await asyncio.gather(*drains, return_exceptions=True)
        check(all(isinstance(e, asyncio.CancelledError) for e in ends),
              f"{label}: a client's receive failed: "
              f"{[e for e in ends if not isinstance(e, asyncio.CancelledError)][:1]}")
        scraped = await asyncio.to_thread(http_get, broker_metrics, "/metrics")
        check(scraped is not None and scraped[0] == 200,
              f"{label}: the broker's /metrics did not answer")
        routed_metric = metric(scraped[1], "cdn_device_messages_routed")
        route = {p: metric_sum(scraped[1], "cdn_route_batch_frames", path=p)
                 for p in ROUTE_PATHS}
        workers = None
        if shards > 1:
            workers = await sharded_broker_checks(label, broker_metrics,
                                                  scraped[1], shards)
        for c in clients:
            c.close()
        kids.terminate(label)
        exits = log_all_fields(kids.logs["broker"], "device plane exit")
        check(len(exits) == shards,
              f"{label}: the broker logged {len(exits)} of {shards} exit "
              f"lines:\n{log_tail(kids.logs['broker'])}")
        exit_fields = exits[-1]
    finally:
        for t in drains:
            t.cancel()
        for c in clients:
            c.close()
        kids.kill()
        for suffix in ("", "-wal", "-shm"):
            if os.path.exists(db + suffix):
                os.remove(db + suffix)

    # every client's frames against the oracle, as a multiset: the idle
    # bypass may send a few frames of a burst by the host path
    lane_bit = np.int64(1) << 32
    want = np.sort(np.concatenate([b.codes for _, b in plan]) & ~lane_bit)
    have = np.sort(np.concatenate(
        [np.empty(0, np.int64)]
        + [(np.int64(uid) << 40) | np.asarray(c, np.int64)
           for uid, c in enumerate(got)]))
    check(have.shape == want.shape and (have == want).all(),
          f"{label}: the {len(have)} deliveries differ from the oracle's "
          f"{len(want)}")
    check(np.array_equal(got_bytes, sum(b.payload_bytes for _, b in plan)),
          f"{label}: received payload bytes differ from the oracle's")
    barriers = U if impl != "host" else 0
    traffic = {k: exit_fields["launches"][k] - serving["launches"][k]
               for k in exit_fields["launches"]}
    kernel = {"dense": "delivery_matrix_cuda",
              "ragged": "ragged_delivery_cuda"}.get(impl)
    if kernel is None:
        check(not any(v for e in exits for v in e["launches"].values()),
              f"{label}: the host-path broker launched a kernel")
        check(routed_metric == 0 and "messages_routed" not in exit_fields,
              f"{label}: a host-path broker routed on a plane")
        # the plane-less broker routes as the reference's does by default
        check(route["cutthrough"] > 0, f"{label}: /metrics shows "
              f"cdn_route_batch_frames {route}: no cut-through")
    else:
        check(route["cutthrough"] == 0, f"{label}: a broker with a plane "
              f"planned {route['cutthrough']} frames through cut-through")
        check(routed_metric > 0, f"{label}: /metrics shows "
              "cdn_device_messages_routed 0")
        check(routed_metric == exit_fields["messages_routed"],
              f"{label}: /metrics and the exit line disagree on the routed "
              "count")
        check(traffic[kernel] > 0, f"{label}: the broker never launched "
              f"{kernel} after its warm-up")
        check(not exit_fields["disabled"],
              f"{label}: the device plane disabled itself")
        check(exit_fields["delivery_impl"] == impl,
              f"{label}: the plane switched to {exit_fields['delivery_impl']}")
    check(all(e["native"] for e in exits), f"{label}: the broker's native "
          "host routines did not load")
    if impl == "dense":
        check(exit_fields["native_egress_steps"] == exit_fields["busy_steps"]
              > 0, f"{label}: {exit_fields['native_egress_steps']} of "
              f"{exit_fields['busy_steps']} busy steps egressed through "
              "native.egress_encode")
    busy = sum(r["busy_s"] for r in runs.values())
    return dict(
        impl=impl,
        popularity="uniform, then zipf" if impl != "host" else "uniform",
        path="device plane in the broker process" if kernel
        else "the port's host path (cut-through plane), same machine"
        + (f", {shards} worker shard processes" if shards > 1 else ""),
        shards=shards,
        clients=U, transport="tcp+tls", topics=shape["topics"],
        publishers=P, frames_per_burst=shape["frames"],
        startup_s=startup_s, auth_s=auth_s, resubscribe_s=resubscribe_s,
        deliveries=len(want), matches_oracle=True,
        delivered_msgs_per_s=len(want) / busy,
        **percentiles_ms([x for r in runs.values() for x in r["latency_ns"]]),
        by_popularity={
            k: dict(bursts=r["bursts"], deliveries=r["deliveries"],
                    delivered_msgs_per_s=r["deliveries"] / r["busy_s"],
                    **percentiles_ms(r["latency_ns"]))
            for k, r in runs.items()},
        messages_routed=routed_metric,
        cdn_route_batch_frames=route,
        routed_share=routed_metric / (len(want) + barriers),
        steps=exit_fields.get("steps"),
        native=exit_fields["native"],
        busy_steps=exit_fields.get("busy_steps"),
        native_egress_steps=exit_fields.get("native_egress_steps"),
        broker_step_ms_median=exit_fields.get("step_ms_median"),
        delivery_matrix_cuda=traffic["delivery_matrix_cuda"],
        ragged_delivery_cuda=traffic["ragged_delivery_cuda"],
        warmup_launches=serving["launches"],
        **({"workers": workers} if workers is not None else {}),
        busy_s=busy, run_s=time.perf_counter() - t_run)


def phase_cluster(shape: dict = CLUSTER, device=None):
    """Phase 9: dense and ragged planes, then the host path. Returns each
    run's line and the brokers' launches over the runs' traffic; fails
    unless each plane run's broker launched its kernel."""
    need = 2 * shape["users"] + 256
    limit = raise_fd_limit()
    check(limit >= need, f"cluster: {shape['users']} TCP+TLS clients need "
          f"{need} open files; the hard limit is {limit}")
    rows = {}
    for impl in ("dense", "ragged", "host"):
        rows[impl] = row = asyncio.run(cluster_run(impl, 90, shape, device))
        emit("cluster", **row)
    launches = {"dense": sum(r["delivery_matrix_cuda"] for r in rows.values()),
                "ragged": sum(r["ragged_delivery_cuda"]
                              for r in rows.values())}
    return rows, launches


# ---------------------------------------------------------------------------
# phase 10: four broker shards serving users through the mesh group
# ---------------------------------------------------------------------------


class MeshBrokers:
    """One setup of phase 10: ``shards`` brokers on one discovery file,
    user ``uid`` injected over the Memory transport on broker ``uid %
    shards`` (the harness's way, no auth), and a receiver draining every
    user. With ``group`` the brokers are the shards of a
    ``MeshBrokerGroup`` on ``devices`` and dial no host links; without,
    they are plain brokers joined by host links (the reference
    architecture)."""

    def __init__(self, name: str, shape: dict, sc: BrokerScenario, devices,
                 group: bool, fused=None):
        self.name, self.shape, self.sc = name, shape, sc
        self.devices, self.use_group, self.fused = devices, group, fused
        self.brokers = []
        self.stopped = set()
        self.group = None
        self.remotes = []
        self.drains = []
        U = shape["users"]
        self.got = [[] for _ in range(U)]
        # per delivery: whether it was a direct (a mesh group's direct
        # lanes are paths of their own beside its broadcast lanes)
        self.got_direct = [[] for _ in range(U)]
        self.got_bytes = np.zeros(U, np.int64)
        self.latency_ns = []
        self.seen = [0, 0]   # frames received, perf_counter ns of the last

    async def start(self) -> None:
        from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
        from pushcdn_tpu_torch.broker.mesh_group import (
            MeshBrokerGroup,
            MeshGroupConfig,
        )
        from pushcdn_tpu_torch.broker.tasks.handlers import user_receive_loop
        from pushcdn_tpu_torch.broker.tasks.heartbeat import heartbeat_once
        from pushcdn_tpu_torch.ops import delivery_kernel as dk
        from pushcdn_tpu_torch.parallel.mesh import make_broker_mesh
        from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
        from pushcdn_tpu_torch.proto.def_ import testing_run_def
        from pushcdn_tpu_torch.proto.message import KIND_DIRECT
        from pushcdn_tpu_torch.proto.topic import TopicSpace
        from pushcdn_tpu_torch.proto.transport.memory import (
            gen_testing_connection_pair,
        )
        from pushcdn_tpu_torch.proto.util import AbortOnDropHandle

        sh, B = self.shape, self.shape["shards"]
        build = os.path.join(HERE, ".build")
        os.makedirs(build, exist_ok=True)
        self.db = os.path.join(build, f"smoke-{self.name}-{os.getpid()}.sqlite")
        if self.use_group:
            self.group = MeshBrokerGroup(
                make_broker_mesh(B, devices=self.devices), MeshGroupConfig(
                    num_user_slots=sh["users"], ring_slots=sh["ring_slots"],
                    frame_bytes=sh["frame_bytes"],
                    extra_lanes=(sh["extra_lane"],),
                    direct_bucket_slots=sh["direct_bucket_slots"],
                    topic_words=sh["topic_words"],
                    fused_collective=self.fused))
        run_def = testing_run_def(topics=TopicSpace.range(sh["topics"]))
        for i in range(B):
            ep = f"smoke-{self.name}-{os.getpid()}-b{i}"
            b = await Broker.new(BrokerConfig(
                run_def=run_def,
                keypair=DEFAULT_SCHEME.generate_keypair(seed=70),
                discovery_endpoint=self.db,
                public_advertise_endpoint=f"{ep}-pub",
                public_bind_endpoint=f"{ep}-pub",
                private_advertise_endpoint=f"{ep}-priv",
                private_bind_endpoint=f"{ep}-priv",
                heartbeat_interval_s=3600, sync_interval_s=3600,
                whitelist_interval_s=3600, form_mesh=not self.use_group))
            if self.group is not None:
                self.group.attach(b, i)
            self.brokers.append(b)
        warm = dk.LAUNCHES
        for b in self.brokers:   # the group warms both shapes up once
            await b.start()
        self.warm_launches = dk.LAUNCHES - warm
        for uid, topics in enumerate(self.sc.topics):
            broker = self.brokers[uid % B]
            local, remote = await gen_testing_connection_pair(broker.limiter)
            task = asyncio.create_task(
                user_receive_loop(broker, self.sc.keys[uid], local))
            broker.connections.add_user(self.sc.keys[uid], local,
                                        list(topics), AbortOnDropHandle(task))
            self.remotes.append(remote)
        base = sh["frame_bytes"]

        async def drain(uid, remote):
            box, direct = self.got[uid], self.got_direct[uid]
            while True:
                raws = await remote.recv_raw_many()
                now = time.perf_counter_ns()
                for raw in raws:
                    d = raw.data
                    pub, seq, sent = TAIL.unpack_from(d, len(d) - TAIL.size)
                    box.append(((pub * 2 + (len(d) > base)) << 32) | seq)
                    direct.append(d[0] & 0x7F == KIND_DIRECT)
                    self.got_bytes[uid] += len(d)
                    self.latency_ns.append(now - sent)
                    raw.release()
                self.seen[0] += len(raws)
                self.seen[1] = now

        self.drains = [asyncio.create_task(drain(uid, r))
                       for uid, r in enumerate(self.remotes)]
        if not self.use_group:
            # host links as the reference forms them: every broker
            # registers, then dials; the full syncs on each new link carry
            # the users' claims and interest
            for _ in range(2):
                for b in self.brokers:
                    await heartbeat_once(b)
            want = {str(b.identity): {t for uid in range(i, len(
                self.sc.topics), B) for t in self.sc.topics[uid]}
                for i, b in enumerate(self.brokers)}
            async with asyncio.timeout(120):
                while not all(
                        b.connections.num_brokers == B - 1
                        and len(b.connections.direct_map) == sh["users"]
                        and all(set(b.connections.broker_topics
                                    .get_values_of_key(o)) == t
                                for o, t in want.items()
                                if o != str(b.identity))
                        for b in self.brokers):
                    await asyncio.sleep(0.05)

    def move_users(self, popularity: str) -> None:
        """Every user's topics drawn anew under ``popularity`` and applied
        at its broker (unsubscribe, then subscribe), as the user's own
        ``Unsubscribe``/``Subscribe`` would be."""
        old = self.sc.topics
        self.sc.subscribe(popularity)
        self.apply_topics(old)

    def apply_topics(self, old) -> None:
        """Move every user from its topics ``old`` to the scenario's."""
        B = self.shape["shards"]
        for uid, (was, now) in enumerate(zip(old, self.sc.topics)):
            conns = self.brokers[uid % B].connections
            key = self.sc.keys[uid]
            gone = sorted(set(was) - set(now))
            if gone:
                conns.unsubscribe_user_from(key, gone)
            conns.subscribe_user_to(key, list(now))

    async def stop_shard(self, shard: int) -> None:
        """Stop one shard's broker; its users' receivers stop first, since
        their connections close with it."""
        dead = [self.drains[uid] for uid in range(shard, len(self.remotes),
                                                  self.shape["shards"])]
        for t in dead:
            t.cancel()
        await asyncio.gather(*dead, return_exceptions=True)
        await self.brokers[shard].stop()
        self.stopped.add(shard)

    async def publish(self, label: str, bursts, pubs) -> float:
        """Publish each burst (publisher ``pubs[j]`` sends its frames in
        one write, stamped at send time) and wait until it has drained.
        Returns the seconds from each burst's first send to its last
        receive, summed."""
        busy_s = 0.0
        want = self.seen[0]
        try:
            for b in bursts:
                want += len(b.codes)
                t0 = time.perf_counter_ns()
                for j, pub_frames in enumerate(b.frames):
                    stamp = struct.pack("<q", time.perf_counter_ns())
                    await self.remotes[pubs[j]].send_raw_many(
                        [f[:-8] + stamp for f in pub_frames])
                    if j % PUBLISH_GROUP == PUBLISH_GROUP - 1:
                        await asyncio.sleep(0)
                async with asyncio.timeout(300):
                    while self.seen[0] < want:
                        await asyncio.sleep(0.002)
                busy_s += (self.seen[1] - t0) / 1e9
            # a duplicate or a stray frame would land in this window
            await asyncio.sleep(0.2)
        except TimeoutError:
            raise SmokeFailure(f"{label}: {self.seen[0]} of {want} frames "
                               "arrived") from None
        check(self.seen[0] == want, f"{label}: {self.seen[0] - want} frames "
              "more than the oracle's arrived")
        return busy_s

    def check_oracle(self, label: str, bursts, since: list) -> None:
        """Every user's frames since ``since`` (per-user counts) against
        the bursts' oracle, and publisher order per path: per size lane,
        broadcasts and directs apart, since a group step's egress walks
        its broadcast lanes before its direct lanes, as the JAX group's
        does."""
        check_deliveries(label, [c[n:] for c, n in zip(self.got, since)],
                         [d[n:] for d, n in zip(self.got_direct, since)],
                         self.got_bytes - self.bytes_since, bursts)

    def mark(self) -> list:
        """Per-user delivery counts so far, the start of a check."""
        self.bytes_since = self.got_bytes.copy()
        return [len(c) for c in self.got]

    async def shutdown(self) -> None:
        for t in self.drains:
            t.cancel()
        ends = await asyncio.gather(*self.drains, return_exceptions=True)
        for r in self.remotes:
            r.close()
        for i, b in enumerate(self.brokers):
            if i not in self.stopped:
                await b.stop()
        if os.path.exists(self.db):
            os.remove(self.db)
        check(all(isinstance(e, asyncio.CancelledError) for e in ends),
              f"{self.name}: a receiver failed: "
              f"{[e for e in ends if not isinstance(e, asyncio.CancelledError)][:1]}")


def check_deliveries(label: str, got, got_direct, got_bytes, bursts) -> None:
    """Per user ``uid``: its delivery codes ``got[uid]``, whether each was
    a direct, and its bytes, against the bursts' oracle, and publisher
    order per path (size lane, broadcast or direct)."""
    want = np.sort(np.concatenate([b.codes for b in bursts]))
    have = np.sort(np.concatenate(
        [np.empty(0, np.int64)]
        + [(np.int64(uid) << 40) | np.asarray(c, np.int64)
           for uid, c in enumerate(got)]))
    check(have.shape == want.shape and (have == want).all(),
          f"{label}: the {len(have)} deliveries differ from the oracle's "
          f"{len(want)}")
    check(np.array_equal(got_bytes, sum(b.nbytes for b in bursts)),
          f"{label}: received bytes differ from the oracle's")
    for uid, c in enumerate(got):
        c = np.asarray(c, np.int64)
        path = (c >> 32) * 2 + np.asarray(got_direct[uid], bool)
        order = np.argsort(path, kind="stable")
        hi, seq = path[order], (c & 0xFFFFFFFF)[order]
        check(((np.diff(seq) > 0) | (np.diff(hi) != 0)).all(),
              f"{label}: user {uid} got a publisher's frames out of order")


class PlanTally:
    """While installed, counts the frames each ``RoutePlanner`` planned,
    by mode: 0 a user's chunk, 1 a broker link's."""

    def __init__(self):
        self.frames = {}

    def __enter__(self):
        from pushcdn_tpu_torch.native.routeplan import RoutePlanner
        self.cls, plan = RoutePlanner, RoutePlanner.plan
        frames = self.frames

        def counted(planner, buf, offs, lens, start, mode):
            out = plan(planner, buf, offs, lens, start, mode)
            key = (id(planner), mode)
            frames[key] = frames.get(key, 0) + out[0]
            return out

        self.plan, RoutePlanner.plan = plan, counted
        return self

    def __exit__(self, *exc):
        self.cls.plan = self.plan

    def of(self, broker) -> dict:
        """Frames ``broker``'s cut-through state planned, by origin."""
        state = getattr(broker, "_route_state", None)
        key = id(state.planner) if state is not None else None
        return {"user": self.frames.get((key, 0), 0),
                "broker": self.frames.get((key, 1), 0)}


class CollectiveCounter:
    """Wraps a group's mesh step and counts the collectives of each call
    (``router.trace_collectives``)."""

    def __init__(self, step):
        self.step = step
        self.counts = []

    def __call__(self, *args):
        from pushcdn_tpu_torch.parallel.router import trace_collectives
        before = trace_collectives()
        out = self.step(*args)
        self.counts.append(trace_collectives() - before)
        return out


async def mesh_broker_runs(devices, shape: dict, seed: int) -> dict:
    """Phase 10's runs, in order: (1) the per-array group, uniform then
    zipf; (2) the fused group, uniform, (3) and on it again with shard
    3's broker stopped; (4) the same brokers with no group, over host
    links; (5) a small ``MeshCluster`` with real clients. Returns each
    run's line."""
    from pushcdn_tpu_torch.broker.tasks import cutthrough
    from pushcdn_tpu_torch.ops import delivery_kernel as dk
    from pushcdn_tpu_torch.proto.transport.memory import Memory

    B, U, P = shape["shards"], shape["users"], shape["publishers"]
    pubs = list(range(P))   # publisher p is user p, on shard p % B
    rows = {}
    prev_window = Memory.set_duplex_window(256 * 1024)
    try:
        async def group_run(mb, label, plan, pubs, fused_ticks=False,
                            alive=None):
            """Publish ``plan`` [(popularity, n bursts)] through ``mb``'s
            group and check it; the line of the run."""
            g = mb.group
            counter = g.step_fn = CollectiveCounter(g.step_fn)
            steps0, routed0 = g.steps, g.messages_routed
            busy0, native0 = g.busy_steps, g.native_egress_steps
            recent0 = len(g.recent_steps)
            since = mb.mark()
            lat0 = len(mb.latency_ns)
            bursts, busy, by_pop = [], {}, {}
            dk.LAUNCHES = 0
            for popularity, n in plan:
                if popularity != mb.sc.popularity:
                    mb.move_users(popularity)
                these = [mb.sc.burst(pubs, alive) for _ in range(n)]
                lat = len(mb.latency_ns)
                busy[popularity] = await mb.publish(label, these, pubs)
                by_pop[popularity] = dict(
                    delivered_msgs_per_s=sum(len(b.codes) for b in these)
                    / busy[popularity],
                    **percentiles_ms(mb.latency_ns[lat:]))
                bursts += these
            launches = dk.LAUNCHES
            mb.check_oracle(label, bursts, since)
            deliveries = sum(len(b.codes) for b in bursts)
            routed = g.messages_routed - routed0
            steps = g.steps - steps0
            check(not g.disabled, f"{label}: the group disabled itself")
            check(routed == deliveries, f"{label}: the group routed "
                  f"{routed} of {deliveries} deliveries; the rest took the "
                  "host path")
            check(steps > 0 and launches > 0,
                  f"{label}: {steps} steps, {launches} launches of "
                  "delivery_matrix_cuda")
            busy_steps = g.busy_steps - busy0
            native_steps = g.native_egress_steps - native0
            check(native_steps == busy_steps > 0, f"{label}: {native_steps} "
                  f"of {busy_steps} busy steps egressed through "
                  "native.egress_encode")
            if fused_ticks:
                check(set(counter.counts) == {1}, f"{label}: a fused tick "
                      f"counted {sorted(set(counter.counts))} collectives")
            r = np.asarray(list(g.recent_steps)[recent0:],
                           np.float64).reshape(-1, 6)
            med = (lambda col: float(np.median(r[:, col]) * 1e3)) if len(r) \
                else (lambda col: None)
            g.step_fn = counter.step
            return dict(
                run=label, shards=B, devices=[str(d) for d in g.mesh.devices],
                exchange="fused" if g.step_fn.fused else "per-array",
                live_shards=int(g._liveness.sum()), users=U,
                topics=shape["topics"], publishers=len(pubs),
                bursts={p: n for p, n in plan},
                frames_per_burst=shape["frames"], deliveries=deliveries,
                matches_oracle=True, fifo_per_publisher_and_lane=True,
                delivered_msgs_per_s=deliveries / sum(busy.values()),
                by_popularity=by_pop,
                **percentiles_ms(mb.latency_ns[lat0:]),
                busy_s=sum(busy.values()), steps=steps,
                frames_per_step_median=float(np.median(r[:, 4]))
                if len(r) else None,
                busy_steps=busy_steps, native_egress_steps=native_steps,
                snapshot_ms_median=med(0), device_step_ms_median=med(1),
                encode_ms_median=med(2), egress_ms_median=med(3),
                routed_share=routed / deliveries,
                delivery_matrix_cuda=launches,
                launches_per_step=launches / steps,
                collectives_per_tick=sorted(set(counter.counts)),
                warmup_launches=mb.warm_launches,
                host_links=[b.connections.num_brokers for b in mb.brokers
                            if b.listeners_bound],
                overflow_seen=g.overflow_seen)

        # 1. the per-array exchange (the default on one device)
        t = time.perf_counter()
        mb = MeshBrokers("meshbroker-per-array", shape,
                         BrokerScenario("uniform", seed, shape), devices,
                         group=True)
        await mb.start()
        try:
            rows["per-array"] = await group_run(
                mb, "mesh broker per-array", [("uniform", 2), ("zipf", 1)],
                pubs)
            rows["per-array"]["cut"] = ("2 uniform bursts, not 3, for the "
                                        "script's time limit")
        finally:
            await mb.shutdown()
        rows["per-array"]["run_s"] = time.perf_counter() - t
        emit("mesh_broker", **rows["per-array"])

        # 2. the fused exchange, then 3. shard 3 stopped on the same group
        t = time.perf_counter()
        mb = MeshBrokers("meshbroker-fused", shape,
                         BrokerScenario("uniform", seed + 1, shape), devices,
                         group=True, fused=True)
        await mb.start()
        try:
            rows["fused"] = await group_run(
                mb, "mesh broker fused", [("uniform", 2)], pubs,
                fused_ticks=True)
            rows["fused"]["run_s"] = time.perf_counter() - t
            emit("mesh_broker", **rows["fused"])
            t = time.perf_counter()
            dead = B - 1
            await mb.stop_shard(dead)
            alive = np.arange(U) % B != dead
            rows["survivors"] = await group_run(
                mb, "mesh broker survivors", [("uniform", 1)],
                [p for p in pubs if p % B != dead], fused_ticks=True,
                alive=alive)
            check(not mb.group._liveness[dead],
                  "mesh broker survivors: the stopped shard is still live")
            gone = [uid for uid in range(dead, U, B)
                    if mb.group.slots.slot_of(mb.sc.keys[uid]) is not None]
            check(not gone, f"mesh broker survivors: {len(gone)} of the "
                  "stopped shard's users still hold slots")
        finally:
            await mb.shutdown()
        rows["survivors"]["run_s"] = time.perf_counter() - t
        emit("mesh_broker", **rows["survivors"])

        # 4. the same brokers without a group, joined by host links, run 2's
        # first burst on the reference's default host path (the
        # cut-through plane, on the users' loops and on the broker links);
        # the pass on the scalar twin was cut for the script's time limit
        key = "host-links"
        label = f"mesh broker {key}"
        t = time.perf_counter()
        mb = MeshBrokers(f"meshbroker-{key}", shape,
                         BrokerScenario("uniform", seed + 1, shape),
                         devices, group=False)
        try:
            with PlanTally() as tally:
                await mb.start()
                since = mb.mark()
                bursts = [mb.sc.burst(pubs)]
                dk.LAUNCHES = 0
                paths0 = route_frames()
                busy = await mb.publish(label, bursts, pubs)
                paths = route_delta(paths0)
            mb.check_oracle(label, bursts, since)
            check(dk.LAUNCHES == 0,
                  f"{label}: the host path launched a kernel")
            planned = [tally.of(b) for b in mb.brokers]
            check(all(p["user"] > 0 and p["broker"] > 0 for p in planned),
                  f"{label}: frames planned through cut-through per broker "
                  f"{planned}: a user loop or a broker link took the scalar "
                  "twin")
            deliveries = sum(len(b.codes) for b in bursts)
            rows[key] = dict(
                run=f"host links, no group, route {cutthrough.ROUTE_IMPL}",
                shards=B, users=U, topics=shape["topics"], publishers=P,
                bursts={"uniform": 1}, frames_per_burst=shape["frames"],
                deliveries=deliveries, matches_oracle=True,
                fifo_per_publisher_and_lane=True,
                delivered_msgs_per_s=deliveries / busy,
                **percentiles_ms(mb.latency_ns), busy_s=busy,
                host_links=[b.connections.num_brokers for b in mb.brokers],
                cdn_route_batch_frames=paths,
                cutthrough_frames_per_broker=planned,
                routed_share=0.0, delivery_matrix_cuda=0,
                cut="no scalar-twin pass, for the script's time limit: the "
                    "twin is held on the CPU")
        finally:
            await mb.shutdown()
        rows[key]["run_s"] = time.perf_counter() - t
        emit("mesh_broker", **rows[key])
        # the fused group over the host links on the same bursts (reported,
        # not claimed)
        emit("mesh_broker_ratio", fused_over_host_links=rows["fused"][
            "delivered_msgs_per_s"] / rows[key]["delivered_msgs_per_s"])
    finally:
        Memory.set_duplex_window(prev_window)

    # 5. a small MeshCluster: a marshal and real clients, one per shard
    rows["cluster"] = await mesh_cluster_run(devices)
    emit("mesh_broker", **rows["cluster"])
    return rows


async def mesh_cluster_run(devices) -> dict:
    """A ``MeshCluster`` on ``devices``: a marshal, one authenticated
    ``Client`` placed on each shard over the Memory transport, no host
    broker links; a cross-shard broadcast and a cross-shard direct must
    each arrive exactly once."""
    from pushcdn_tpu_torch.ops import delivery_kernel as dk
    from pushcdn_tpu_torch.proto.message import Broadcast, Direct
    from pushcdn_tpu_torch.testing import MeshCluster

    label = "mesh cluster"
    t = time.perf_counter()
    cluster = await MeshCluster(num_shards=len(devices),
                                devices=devices).start()
    try:
        clients = [await cluster.place_client(seed=500 + s, shard=s,
                                              topics=[0])
                   for s in range(len(devices))]
        dk.LAUNCHES = 0
        t0 = time.perf_counter()
        await clients[0].send_broadcast_message([0], b"across the mesh")
        got = [await asyncio.wait_for(c.receive_message(), 30)
               for c in clients]
        check(all(isinstance(m, Broadcast)
                  and bytes(m.message) == b"across the mesh" for m in got),
              f"{label}: the broadcast did not reach every shard's client")
        await clients[0].send_direct_message(clients[-1].public_key,
                                             b"shard 0 to the last")
        m = await asyncio.wait_for(clients[-1].receive_message(), 30)
        check(isinstance(m, Direct) and bytes(m.message)
              == b"shard 0 to the last", f"{label}: the direct went astray")
        took_ms = (time.perf_counter() - t0) * 1e3
        pending = [asyncio.create_task(c.receive_message()) for c in clients]
        await asyncio.sleep(0.3)
        check(not any(p.done() for p in pending),
              f"{label}: a frame arrived twice")
        for p in pending:
            p.cancel()
        g = cluster.group
        links = [b.connections.num_brokers for b in cluster.brokers]
        check(links == [0] * len(devices), f"{label}: host links {links}")
        check(not g.disabled, f"{label}: the group disabled itself")
        check(g.messages_routed == len(devices) + 1,
              f"{label}: the group routed {g.messages_routed} of "
              f"{len(devices) + 1} deliveries")
        check(dk.LAUNCHES > 0, f"{label}: delivery_matrix_cuda never launched")
        check(g.native_egress_steps == g.busy_steps > 0,
              f"{label}: {g.native_egress_steps} of {g.busy_steps} busy "
              "steps egressed through native.egress_encode")
        for c in clients:
            c.close()
        return dict(run=label, shards=len(devices),
                    busy_steps=g.busy_steps,
                    native_egress_steps=g.native_egress_steps,
                    devices=[str(d) for d in g.mesh.devices],
                    clients=len(clients), deliveries=len(devices) + 1,
                    exactly_once=True, broadcast_then_direct_ms=took_ms,
                    steps=g.steps, messages_routed=g.messages_routed,
                    host_links=links, delivery_matrix_cuda=dk.LAUNCHES,
                    run_s=time.perf_counter() - t)
    finally:
        await cluster.stop()


def phase_mesh_broker(devices, shape: dict = MESH_BROKER):
    """Phase 10. Returns each run's line and the dense kernel's launches
    over the group runs' traffic; fails unless each group run launched
    it."""
    rows = asyncio.run(mesh_broker_runs(devices, shape, 60))
    return rows, sum(r["delivery_matrix_cuda"] for r in rows.values())


# ---------------------------------------------------------------------------
# phase 11: the multi-host group, two processes stepping one global mesh
# ---------------------------------------------------------------------------


def spawn_pair(module: str, tag: str, args, device) -> tuple:
    """Start a worker pair of ``module`` on a fresh ``file://`` rendezvous
    under ``.build/<tag>``; returns the procs and the directory (each
    rank logs to ``rank<R>.log`` there)."""
    import shutil
    from pushcdn_tpu_torch.testing.two_host import spawn_worker_pair
    d = os.path.join(HERE, ".build", tag)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    procs = spawn_worker_pair(
        module, f"file://{d}/rendezvous",
        [*args(d), "--device", str(device)], log_dir=d)
    return procs, d


def wait_pair(procs, d: str, label: str, timeout: float) -> None:
    """Both workers must exit 0 within ``timeout``; any left running is
    killed."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {rank} exited with {p.returncode}:\n"
              f"{log_tail(os.path.join(d, f'rank{rank}.log'))}"
              for rank, p in enumerate(procs) if p.returncode != 0]
    check(not failed, f"{label}: " + "\n".join(failed))


# phase 11's socket-free runs, (popularity, fused): two of the four, one
# of each popularity and each schedule, cut for the script's time limit
LOCKSTEP_RUNS = (("uniform", True), ("zipf", False))


def lockstep_scripts(shape: dict) -> list:
    """Phase 11's socket-free runs: per (popularity, schedule) of
    ``LOCKSTEP_RUNS`` the users (phase 6's, no churn) and ticks of a
    MeshScenario over the global mesh, with the scenario to check them
    by. Each run keeps the seed it had among all four."""
    import pickle
    cfg = dict(num_user_slots=shape["users"], ring_slots=shape["ring_slots"],
               direct_bucket_slots=shape["direct_bucket_slots"],
               frame_bytes=shape["frame_bytes"],
               extra_lanes=(shape["extra_lane"],),
               topic_words=shape["topic_words"])
    runs = []
    for seed, (popularity, fused) in enumerate(
            (p, f) for p in ("uniform", "zipf") for f in (True, False)):
        if (popularity, fused) not in LOCKSTEP_RUNS:
            continue
        sc = MeshScenario(popularity, 110 + seed, shape)
        for i in range(shape["initial_users"]):
            sc.add_at((), i % shape["shards"])
        users = [(k, sc.shard[k], sc.users[k]) for k in sorted(
            sc.users, key=sc.user_id)]
        ticks = [sc.mesh_traffic() for _ in range(shape["ticks"])]
        script = dict(shards=shape["shards"],
                      config=dict(cfg, fused_collective=fused), users=users,
                      ticks=ticks)
        runs.append((popularity, fused, sc, script,
                     pickle.dumps(script)))
    return runs


def multihost_lockstep(device, shape: dict) -> tuple:
    """Phase 11 run 1: two processes step the global mesh of
    ``shape["shards"]`` shards (half of them each, folded onto
    ``device``) in lockstep, socket-free, for each (popularity,
    schedule); each tick's deliveries of both processes against the
    oracle and against the one-process MeshGroup of every shard folded on
    ``device``. Returns the runs' lines, the workers' dense launches and
    the captured launches of the reference's last tick."""
    import pickle
    import zlib
    from pushcdn_tpu_torch.broker.mesh_group import MeshGroup, MeshGroupConfig
    from pushcdn_tpu_torch.parallel.mesh import make_broker_mesh
    B = shape["shards"]
    local = B // shape["processes"]
    runs = lockstep_scripts(shape)
    t0 = time.perf_counter()

    def args(d):
        paths = []
        for i, run in enumerate(runs):
            path = os.path.join(d, f"script{i}.pkl")
            with open(path, "wb") as f:
                f.write(run[-1])
            paths.append(path)
        return ["group", d, *paths]
    procs, d = spawn_pair("pushcdn_tpu_torch.testing.lockstep_worker",
                          f"multihost-lockstep-{os.getpid()}", args, device)
    wait_pair(procs, d, "multihost lockstep", 600)
    workers_s = time.perf_counter() - t0
    lines, launches, captured = [], 0, None
    for i, (popularity, fused, sc, script, _) in enumerate(runs):
        schedule = "fused" if fused else "per-array"
        label = f"multihost lockstep {popularity}/{schedule}"
        outs = []
        for rank in range(shape["processes"]):
            with open(os.path.join(d, f"rank{rank}-{i}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        # full shapes, as the lockstep group steps: the same pairs, and
        # the kernel's captured inputs at the main path's shape
        ref = MeshGroup(make_broker_mesh(B, devices=[device] * B),
                        MeshGroupConfig(**script["config"]),
                        full_shapes=True)
        for key, shard, topics in script["users"]:
            ref.claim_user(shard, key, topics)
        lanes = ref.config.lane_shapes()
        for tick, per_shard in enumerate(script["ticks"]):
            for s in range(B):
                ref.stage_batch(s, per_shard[s])
            if tick == len(script["ticks"]) - 1 and i == 0:
                cap = Capture()
                with cap:
                    want_ref = ref.step()
                captured = cap.calls["dense"]
            else:
                want_ref = ref.step()
            ref_codes = {}
            for r in want_ref:
                uids = np.asarray([sc.user_id(ref.slots.key_of(int(u)))
                                   for u in r.users], np.int64)
                ref_codes[(r.shard, r.lane, r.direct)] = (
                    sc.code(r.shard, r.lane, int(r.direct), uids,
                            r.frames.astype(np.int64)),
                    zlib.crc32(np.ascontiguousarray(r.bytes_)))
            want_codes, want_len = sc.mesh_oracle(per_shard, lanes)
            parts, got_ref = [], {}
            for out in outs:
                for shard, lane, direct, keys, frames, length, crc in \
                        out["ticks"][tick]:
                    uids = np.asarray([sc.user_id(k) for k in keys],
                                      np.int64)
                    code = sc.code(shard, lane, int(direct), uids,
                                   frames.astype(np.int64))
                    key = (lane, True, shard) if direct else (lane, False)
                    check(np.array_equal(length, want_len[key]),
                          f"{label} tick {tick}: frame lengths differ")
                    parts.append(code)
                    got_ref[(shard, lane, direct)] = (code, crc)
            got_codes = np.sort(np.concatenate(parts)) if parts \
                else np.empty(0, np.int64)
            check(got_codes.shape == want_codes.shape
                  and (got_codes == want_codes).all(),
                  f"{label} tick {tick}: {len(got_codes)} pairs, oracle "
                  f"{len(want_codes)}")
            check(got_ref.keys() == ref_codes.keys() and all(
                np.array_equal(got_ref[k][0], ref_codes[k][0])
                and got_ref[k][1] == ref_codes[k][1] for k in ref_codes),
                f"{label} tick {tick}: the two processes' pairs or frames "
                "differ from the one-process group's")
        rows = np.asarray([r for out in outs for r in out["rows"]], float)
        per_tick = [int(x) for x in rows[:, 7]]
        check(set(per_tick) == {2 * local}, f"{label}: dense launches a "
              f"tick per process {sorted(set(per_tick))}, want {2 * local}")
        collectives = sorted({int(x) for x in rows[:, 4]})
        check(not fused or collectives == [1],
              f"{label}: a fused tick counted {collectives} collectives")
        launches += int(rows[:, 7].sum())
        med = lambda col: float(np.median(rows[:, col]) * 1e3)  # noqa: E731
        lines.append(dict(
            run=label, processes=shape["processes"], shards=B,
            local_shards=local, devices=[str(device)] * local,
            transport=outs[0]["transport"], users=len(script["users"]),
            topics=shape["topics"], frames_per_tick=shape["frames"],
            ticks=len(script["ticks"]), matches_oracle=True,
            matches_one_process_group=True,
            pairs_per_tick=[sum(len(t[3]) for out in outs
                                for t in out["ticks"][k])
                            for k in range(len(script["ticks"]))],
            collectives_per_tick=collectives,
            dense_launches_per_tick_per_process=2 * local,
            stage_ms_median=med(0), snapshot_upload_ms_median=med(1),
            mesh_step_readback_ms_median=med(2),
            pair_extract_ms_median=med(3),
            exchange_staging_ms_median=med(5),
            exchange_collective_ms_median=med(6),
            delivery_matrix_cuda=int(rows[:, 7].sum()),
            cut=f"{len(runs)} of the 4 (popularity, schedule) runs, for "
                "the script's time limit"))
    return lines, launches, captured, workers_s


def multihost_plan(shape: dict, seed: int, db: str):
    """Phase 11 run 2's plan: users ``uid`` on shard ``uid % shards``
    (half the shards in each process), publishers 0..publishers-1, three
    uniform bursts, every user moved to zipf topics, one zipf burst;
    directs go to users of the other process. Returns the plan, the
    bursts and the publishers."""
    B, U = shape["shards"], shape["users"]
    local = B // shape["processes"]
    sc = BrokerScenario("uniform", seed, shape)
    proc = (np.arange(U) % B) // local
    pools = [np.flatnonzero(proc != r) for r in range(shape["processes"])]
    pubs = list(range(shape["publishers"]))
    topics = {"uniform": sc.topics}
    plan_bursts, bursts = [], []
    for popularity, n in (("uniform", 3), ("zipf", 1)):
        if popularity != sc.popularity:
            sc.subscribe(popularity)
            topics[popularity] = sc.topics
        for _ in range(n):
            b = sc.burst(pubs, direct_pool=lambda p: pools[proc[p]])
            bursts.append((popularity, b))
            plan_bursts.append(dict(
                popularity=popularity,
                frames={pubs[j]: fr for j, fr in enumerate(b.frames)},
                expect=np.bincount(b.codes >> 40, minlength=U)))
    plan = dict(
        config=dict(num_user_slots=U, ring_slots=shape["ring_slots"],
                    direct_bucket_slots=shape["direct_bucket_slots"],
                    frame_bytes=shape["frame_bytes"],
                    extra_lanes=(shape["extra_lane"],),
                    topic_words=shape["topic_words"]),
        shards=B, num_topics=shape["topics"], db=db, keys=sc.keys,
        topics=topics, first="uniform", frame_bytes=shape["frame_bytes"],
        bursts=plan_bursts)
    return plan, bursts, pubs


def multihost_check(label: str, outs, bursts, shape: dict) -> None:
    """Every user's frames in the two processes against the bursts'
    oracle (``check_deliveries``)."""
    U = shape["users"]
    got = [None] * U
    got_direct = [None] * U
    got_bytes = np.zeros(U, np.int64)
    for out in outs:
        for uid, codes in out["got"].items():
            got[uid] = codes
            got_direct[uid] = out["got_direct"][uid]
            got_bytes[uid] = out["got_bytes"][uid]
    check(all(c is not None for c in got), f"{label}: users missing")
    check_deliveries(label, got, got_direct, got_bytes,
                     [b for _, b in bursts])


def step_medians(steps, exchange) -> dict:
    """Medians in ms over pump steps (StepTiming tuples: the third part
    is the native encode of the steps' matrices) and their exchange parts
    (staging, collective)."""
    r = np.asarray(steps, np.float64).reshape(-1, 6)
    x = np.asarray(exchange, np.float64).reshape(-1, 2)
    med = (lambda a, col: float(np.median(a[:, col]) * 1e3)
           if len(a) else None)
    return dict(snapshot_ms_median=med(r, 0), device_step_ms_median=med(r, 1),
                exchange_staging_ms_median=med(x, 0),
                exchange_collective_ms_median=med(x, 1),
                encode_ms_median=med(r, 2),
                egress_ms_median=med(r, 3))


def idle_split(out: dict) -> dict:
    """One process's idle lockstep tick, in ms, as the mean of each part
    over the quiet second: the window sleep, how late it returned (the
    event loop's other work), the stop barrier, the step's parts, and
    what none of them holds. Beside it the user-slot directory's share
    of the loop (publish and read, per tick)."""
    idle = out["idle"]
    ticks = max(idle["steps"], 1)
    mean = (lambda xs: float(np.mean(xs)) * 1e3 if len(xs) else 0.0)
    steps = np.asarray(idle["recent_steps"], np.float64).reshape(-1, 6)
    parts = dict(window=out["batch_window_s"] * 1e3,
                 wake_lag=mean(idle["wake_lag"]),
                 barrier=mean(idle["barrier"]),
                 snapshot=mean(steps[:, 0]), device_step=mean(steps[:, 1]),
                 encode=mean(steps[:, 2]), egress=mean(steps[:, 3]))
    tick = idle["seconds"] / ticks * 1e3
    return dict(tick=tick, **parts, rest=tick - sum(parts.values()),
                directory_per_tick=float(np.sum(idle["directory"])) * 1e3
                / ticks)


def multihost_brokers(device, shape: dict, seed: int) -> tuple:
    """Phase 11 run 2: in each of two processes a MultiHostBrokerGroup
    with a Broker on each local shard and its users injected over the
    Memory transport; the plan's bursts, every delivery against the
    oracle. Returns the run's line and the workers' dense launches."""
    import pickle
    label = "multihost brokers"
    B = shape["shards"]
    local = B // shape["processes"]
    tag = f"multihost-brokers-{os.getpid()}"
    db = os.path.join(HERE, ".build", f"{tag}.sqlite")
    for suffix in ("", "-wal", "-shm"):
        if os.path.exists(db + suffix):
            os.remove(db + suffix)
    plan, bursts, pubs = multihost_plan(shape, seed, db)
    t0 = time.perf_counter()

    def args(d):
        path = os.path.join(d, "plan.pkl")
        with open(path, "wb") as f:
            pickle.dump(plan, f)
        return [path, d]
    procs, d = spawn_pair("pushcdn_tpu_torch.testing.burst_worker", tag,
                          args, device)
    wait_pair(procs, d, label, 600)
    run_s = time.perf_counter() - t0
    outs = []
    for rank in range(shape["processes"]):
        with open(os.path.join(d, f"rank{rank}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    multihost_check(label, outs, bursts, shape)
    deliveries = sum(len(b.codes) for _, b in bursts)
    routed = sum(o["busy"]["routed"] for o in outs)
    check(routed == deliveries, f"{label}: the groups routed {routed} of "
          f"{deliveries} deliveries")
    check(not any(o["disabled"] for o in outs),
          f"{label}: a group disabled itself")
    check(all(o["overflows"] == 0 for o in outs), f"{label}: the groups "
          f"staged {[o['overflows'] for o in outs]} frames to the host path")
    links = [n for o in outs for n in o["host_links"]]
    check(links == [0] * B, f"{label}: host broker links {links}")
    for o in outs:
        b = o["busy"]
        # counted per whole step (a step in flight at the window's edge
        # is in or out whole)
        check(b["steps"] > 0 and set(b["launches_per_step"]) == {2 * local},
              f"{label}: rank {o['rank']} launched delivery_matrix_cuda "
              f"{sorted(set(b['launches_per_step']))} times a step over "
              f"{b['steps']} steps, want {2 * local}")
        check(set(b["collectives"]) == {1}, f"{label}: a fused tick counted "
              f"{sorted(set(b['collectives']))} collectives")
        check(b["native_egress_steps"] == b["busy_steps"] > 0,
              f"{label}: rank {o['rank']} egressed "
              f"{b['native_egress_steps']} of {b['busy_steps']} busy steps "
              "through native.egress_encode")
    lat = np.concatenate([o["latency_ns"] for o in outs])
    busy_s, by_pop = 0.0, {}
    for i, (popularity, b) in enumerate(bursts):
        span = (max(o["bursts"][i]["last_ns"] for o in outs)
                - min(o["bursts"][i]["start_ns"] for o in outs)) / 1e9
        busy_s += span
        pop = by_pop.setdefault(popularity, dict(deliveries=0, busy_s=0.0,
                                                 lat=[]))
        pop["deliveries"] += len(b.codes)
        pop["busy_s"] += span
        pop["lat"] += [o["latency_ns"][o["bursts"][i]["latency_from"]:
                                       o["bursts"][i]["latency_to"]]
                       for o in outs]
    busy_steps = [s for o in outs for s in o["busy"]["recent_steps"]
                  if s[4] > 0]
    busy_x = [x for o in outs
              for s, x in zip(o["busy"]["recent_steps"], o["busy"]["exchange"])
              if s[4] > 0]
    idle_steps = [s for o in outs for s in o["idle"]["recent_steps"]]
    idle_x = [x for o in outs for x in o["idle"]["exchange"]]
    line = dict(
        run=label, processes=shape["processes"], shards=B,
        local_shards=local, devices=[str(device)] * local,
        transport=outs[0]["transport"], users=shape["users"],
        users_per_broker=shape["users"] // B, topics=shape["topics"],
        publishers=len(pubs), bursts={"uniform": 3, "zipf": 1},
        frames_per_burst=shape["frames"], deliveries=deliveries,
        matches_oracle=True, fifo_per_publisher_and_lane=True,
        delivered_msgs_per_s=deliveries / busy_s,
        by_popularity={p: dict(delivered_msgs_per_s=v["deliveries"]
                               / v["busy_s"],
                               **percentiles_ms(np.concatenate(v["lat"])))
                       for p, v in by_pop.items()},
        **percentiles_ms(lat), busy_s=busy_s,
        steps_per_process=[o["busy"]["steps"] for o in outs],
        busy_steps=len(busy_steps),
        native_egress_steps=[o["busy"]["native_egress_steps"] for o in outs],
        busy_step=step_medians(busy_steps, busy_x),
        launches_per_step_per_process=2 * local,
        collectives_per_tick=[1],
        idle_tick_ms=[o["idle"]["seconds"] / max(o["idle"]["steps"], 1) * 1e3
                      for o in outs],
        idle_step=step_medians(idle_steps, idle_x),
        idle_barrier_ms_median=float(np.median(
            [b for o in outs for b in o["idle"]["barrier"]]) * 1e3),
        idle_tick_split_ms_mean=[idle_split(o) for o in outs],
        idle_directory_refreshes=[len(o["idle"]["directory"]) for o in outs],
        idle_directory_publish_ms_median=float(np.median(
            [r[0] for o in outs for r in o["idle"]["directory"]]) * 1e3),
        idle_directory_read_ms_median=float(np.median(
            [r[1] for o in outs for r in o["idle"]["directory"]]) * 1e3),
        busy_barrier_ms_median=float(np.median(
            [b for o in outs for b in o["busy"]["barrier"]]) * 1e3),
        batch_window_ms=outs[0]["batch_window_s"] * 1e3,
        routed_share=routed / deliveries,
        warmup_launches=[o["warm_launches"] for o in outs],
        delivery_matrix_cuda=sum(sum(o["busy"]["launches_per_step"])
                                 for o in outs),
        host_links=links,
        directory_refresh_max_gap_s=[o["directory_max_gap_s"] for o in outs],
        run_s=run_s)
    return line, line["delivery_matrix_cuda"]


async def multihost_binaries(device) -> dict:
    """Phase 11 run 3: a marshal and two ``broker --mesh-shards 2
    --multihost-* --device <device>`` processes, one shard each, a TCP+TLS
    client on each; a broadcast crosses from one broker to the other and
    a direct crosses back, no broker link forms, and both brokers exit 0
    on SIGTERM with their exit lines."""
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.discovery.embedded import Embedded
    from pushcdn_tpu_torch.proto.message import Broadcast, Direct
    from pushcdn_tpu_torch.proto.transport import TcpTls

    label = "multihost binaries"
    tag = f"multihost-bin-{os.getpid()}"
    db = os.path.join(HERE, ".build", f"{tag}.sqlite")
    for suffix in ("", "-wal", "-shm"):
        if os.path.exists(db + suffix):
            os.remove(db + suffix)
    ports = free_ports(8)
    coordinator, marshal = ports[:2]
    kids = Children(tag)
    clients = []
    t_run = time.perf_counter()
    try:
        kids.spawn("marshal", "--discovery-endpoint", db,
                   "--bind-endpoint", f"127.0.0.1:{marshal}",
                   "--user-transport", "tcp+tls")
        metrics = {}
        for rank in (0, 1):
            pub, priv, metrics[rank] = ports[2 + 3 * rank:5 + 3 * rank]
            kids.spawn(f"broker{rank}",
                       "--discovery-endpoint", db,
                       "--public-advertise-endpoint", f"127.0.0.1:{pub}",
                       "--public-bind-endpoint", f"127.0.0.1:{pub}",
                       "--private-advertise-endpoint", f"127.0.0.1:{priv}",
                       "--private-bind-endpoint", f"127.0.0.1:{priv}",
                       "--metrics-bind-endpoint", f"127.0.0.1:{metrics[rank]}",
                       "--user-transport", "tcp+tls",
                       "--heartbeat-interval", "0.2", "--mesh-shards", "2",
                       "--multihost-coordinator", f"127.0.0.1:{coordinator}",
                       "--multihost-process-id", str(rank),
                       "--multihost-num-processes", "2",
                       "--device", str(device), "--device-ring-slots", "64",
                       binary="broker")
        serving = [await kids.wait_for_line(f"broker{r}", "broker serving",
                                            label, timeout=180)
                   for r in (0, 1)]
        startup_s = time.perf_counter() - t_run

        async def users():
            out = []
            for r in (0, 1):
                got = await asyncio.to_thread(http_get, metrics[r], "/metrics")
                out.append(None if got is None
                           else metric(got[1], "cdn_num_users_connected"))
            return out

        async with asyncio.timeout(120):
            for i, seed in enumerate((8101, 8102)):
                c = Client(ClientConfig(
                    marshal_endpoint=f"127.0.0.1:{marshal}",
                    keypair=DEFAULT_SCHEME.generate_keypair(seed=seed),
                    protocol=TcpTls, subscribed_topics={0}))
                clients.append(c)
                await c.ensure_initialized()
                while sorted(await users()) != ([0.0, 1.0] if i == 0
                                                else [1.0, 1.0]):
                    kids.check_alive(label)
                    await asyncio.sleep(0.05)
                await asyncio.sleep(1.0)   # heartbeats carry the load
        alice, bob = clients
        t0 = time.perf_counter()
        await alice.send_broadcast_message([0], b"across processes")
        for c in clients:
            m = await asyncio.wait_for(c.receive_message(), 30)
            check(isinstance(m, Broadcast)
                  and bytes(m.message) == b"across processes",
                  f"{label}: the broadcast went astray")
        broadcast_ms = (time.perf_counter() - t0) * 1e3
        directory = await Embedded.new(db)
        async with asyncio.timeout(60):
            while len(await directory.get_user_slots()) < 2:
                await asyncio.sleep(0.05)
        await directory.close()
        await asyncio.sleep(1.5)   # the brokers' mirrors refresh
        t0 = time.perf_counter()
        await bob.send_direct_message(alice.public_key, b"and back")
        m = await asyncio.wait_for(alice.receive_message(), 30)
        check(isinstance(m, Direct) and bytes(m.message) == b"and back",
              f"{label}: the direct went astray")
        direct_ms = (time.perf_counter() - t0) * 1e3
        links = []
        for r in (0, 1):
            got = await asyncio.to_thread(http_get, metrics[r], "/metrics")
            links.append(metric(got[1], "cdn_num_brokers_connected"))
        check(links == [0.0, 0.0], f"{label}: broker links {links}")
        for c in clients:
            c.close()
        kids.check_alive(label)
        kids.terminate(label)
        done = [log_fields(kids.logs[f"broker{r}"], "device plane exit")
                for r in (0, 1)]
        check(all(x is not None for x in done),
              f"{label}: a broker wrote no exit line")
        launches = [x["launches"]["delivery_matrix_cuda"]
                    - s["launches"]["delivery_matrix_cuda"]
                    for x, s in zip(done, serving)]
        check(all(n > 0 for n in launches),
              f"{label}: a broker launched delivery_matrix_cuda {launches} "
              "times after its warm-up")
        check(all(x["native"] and x["native_egress_steps"] == x["busy_steps"]
                  > 0 for x in done),
              f"{label}: native egress steps of busy steps "
              f"{[(x['native_egress_steps'], x['busy_steps']) for x in done]}"
              f", native loaded {[x['native'] for x in done]}")
        return dict(run=label, processes=2, shards=2,
                    exchange=serving[0]["exchange"],
                    devices=serving[0]["devices"], startup_s=startup_s,
                    broadcast_ms=broadcast_ms, direct_ms=direct_ms,
                    host_links=links, exit_codes=[0, 0, 0],
                    steps=[x["steps"] for x in done],
                    busy_steps=[x["busy_steps"] for x in done],
                    native_egress_steps=[x["native_egress_steps"]
                                         for x in done],
                    messages_routed=[x["messages_routed"] for x in done],
                    delivery_matrix_cuda=launches,
                    warmup_launches=[s["launches"]["delivery_matrix_cuda"]
                                     for s in serving],
                    run_s=time.perf_counter() - t_run)
    finally:
        for c in clients:
            c.close()
        kids.kill()


def phase_multihost(device, shape: dict = MULTIHOST) -> tuple:
    """Phase 11. Returns the lines, the dense launches of the workers'
    main path (the lockstep runs', the broker runs' and the binaries'
    after their warm-ups) and the reference's captured launches at the
    phase's shape."""
    lines = {}
    lock_lines, lock_launches, captured, workers_s = multihost_lockstep(
        device, shape)
    for line in lock_lines:
        emit("multihost", workers_s=workers_s, **line)
    lines["lockstep"] = lock_lines
    broker_line, broker_launches = multihost_brokers(device, shape, 111)
    broker_line["cut"] = ("no run of the same bursts through one process's "
                          "group of 8 shards beside it, for the script's "
                          "time limit")
    emit("multihost", **broker_line)
    lines["brokers"] = broker_line
    bin_line = asyncio.run(multihost_binaries(device))
    emit("multihost", **bin_line)
    lines["binaries"] = bin_line
    launches = (lock_launches + broker_launches
                + sum(bin_line["delivery_matrix_cuda"]))
    return lines, launches, captured


# ---------------------------------------------------------------------------
# phase 12: the native host routines at the slice's shape
# ---------------------------------------------------------------------------


def host_ms(fn, reps: int) -> float:
    """The median of ``reps`` calls of ``fn`` on the host clock, in ms."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def native_burst(rng, n: int, shape: dict):
    """A ``n``-frame burst in the slice's mix as wire frames (90%
    broadcasts on 1-3 topics, 10% directs, payloads up to the base lane's
    slot) with the ring columns ``push_batch`` takes."""
    from pushcdn_tpu_torch.parallel.frames import mask_of_topics
    from pushcdn_tpu_torch.proto.message import (
        KIND_BROADCAST,
        KIND_DIRECT,
        Broadcast,
        Direct,
        serialize,
    )
    frames, kinds, tmasks, dests = [], [], [], []
    for i in range(n):
        body = rng.integers(0, 256, int(rng.integers(16, 1900)),
                            dtype=np.uint8).tobytes()
        if rng.random() < 0.9:
            topics = sorted(set(int(t) for t in rng.integers(
                0, shape["topics"], int(rng.integers(1, 4)))))
            frames.append(serialize(Broadcast(topics, body)))
            kinds.append(KIND_BROADCAST)
            tmasks.append(mask_of_topics(topics, shape["topic_words"]))
            dests.append(-1)
        else:
            frames.append(serialize(Direct(rng.bytes(32), body)))
            kinds.append(KIND_DIRECT)
            tmasks.append(0)
            dests.append(int(rng.integers(0, shape["users"])))
    return frames, kinds, tmasks, dests


def egress_plain(deliver: np.ndarray, lengths, frames) -> dict:
    """The plain per-user egress: ``np.nonzero`` row-major, then each
    delivered frame as its 4-byte big-endian length (the wire's prefix)
    and its bytes. Returns {user: (stream, count)}."""
    users, idx = np.nonzero(deliver)
    enc = [struct.pack(">I", int(n)) + bytes(f[:n])
           for f, n in zip(frames, lengths)]
    cuts = np.flatnonzero(np.diff(users)) + 1
    out = {}
    for us, fs in zip(np.split(users, cuts), np.split(idx, cuts)):
        if len(us):
            out[int(us[0])] = (b"".join([enc[f] for f in fs.tolist()]),
                               len(fs))
    return out


def phase_native(matrices: dict, shape: dict = BROKER) -> dict:
    """Phase 12: each native host routine on the dense kernel's own
    matrices of phase 4 (one per popularity) and a burst of the slice's
    frames, against its plain Python version on the same inputs, and
    both timed on the host clock (median of repeats): ``egress_encode``
    against ``egress_plain`` (streams and per-user counts equal byte for
    byte), ``FrameRing.push_batch`` against its ``_put`` loop (ring
    columns identical), ``FrameEncoder.encode`` and ``FrameScanner.scan``
    against the struct prefix and ``_py_scan_frames`` (round trip to the
    same payloads), and ``pydecode`` against ``decode_frames``'s Python
    loop (equal messages). One ``native`` line per popularity."""
    from pushcdn_tpu_torch import native
    from pushcdn_tpu_torch.parallel.frames import FrameRing
    from pushcdn_tpu_torch.proto import message as msg
    from pushcdn_tpu_torch.proto.transport.base import _py_scan_frames

    rows = {}
    for k, (popularity, deliver) in enumerate(matrices.items()):
        t_run = time.perf_counter()
        label = f"native {popularity}"
        rng = np.random.default_rng(120 + k)
        U, N = deliver.shape
        frames, kinds, tmasks, dests = native_burst(rng, N, shape)

        # the ring packer against the _put loop
        def pack(python: bool):
            ring = FrameRing(slots=N, frame_bytes=shape["frame_bytes"],
                             topic_words=shape["topic_words"])
            if python:
                for i, f in enumerate(frames):
                    ring._put(ring._alloc(), f, kinds[i], tmasks[i], dests[i])
            else:
                check(ring.push_batch(frames, kinds, tmasks, dests) == N,
                      f"{label}: push_batch packed too few frames")
            return ring
        packed, put = pack(False), pack(True)
        for col in ("_bytes", "_kind", "_length", "_topic_mask", "_dest",
                    "_valid"):
            check(np.array_equal(getattr(packed, col), getattr(put, col)),
                  f"{label}: push_batch's {col} differs from the _put loop's")
        pack_ms = host_ms(lambda: pack(False), 5)
        put_ms = host_ms(lambda: pack(True), 3)
        batch = packed.take_batch()

        # the egress encoder against the plain per-user walk
        def encode():
            return native.egress_encode(deliver, batch.length,
                                        [batch.bytes_])
        streams = encode()
        check(streams is not None, f"{label}: egress_encode is unavailable")
        want = egress_plain(deliver, batch.length, batch.bytes_)
        check(streams.users == sorted(want), f"{label}: egress_encode's "
              "users differ from the plain walk's")
        for u in streams.users:
            check(bytes(streams.stream(u)) == want[u][0]
                  and int(streams.msgs[u]) == want[u][1],
                  f"{label}: user {u}'s stream differs from the plain walk's")
        pairs = int(deliver.sum())
        check(streams.total_msgs == pairs, f"{label}: {streams.total_msgs} "
              f"of {pairs} pairs encoded")
        del streams
        encode_ms = host_ms(encode, 5)
        plain_ms = host_ms(
            lambda: egress_plain(deliver, batch.length, batch.bytes_), 3)
        nbytes = sum(len(s) for s, _ in want.values())

        # the wire encoder and scanner, a round trip
        enc = native.FrameEncoder.create(
            capacity=sum(map(len, frames)) + 4 * N)
        stream = bytes(enc.encode(frames))
        check(stream == b"".join(struct.pack(">I", len(f)) + f
                                 for f in frames),
              f"{label}: FrameEncoder's stream differs from the prefixed "
              "frames")
        scanner = native.FrameScanner.create(max_frames=N)
        offs, lens, used, err = scanner.scan(stream, 1 << 20)
        check((offs, lens, used, err) == tuple(_py_scan_frames(stream,
                                                               1 << 20)),
              f"{label}: FrameScanner disagrees with the Python scan")
        check(not err and used == len(stream)
              and [stream[o:o + n] for o, n in zip(offs, lens)] == frames,
              f"{label}: the scan did not give the frames back")
        wire_encode_ms = host_ms(lambda: enc.encode(frames), 5)
        wire_encode_plain_ms = host_ms(lambda: b"".join(
            struct.pack(">I", len(f)) + f for f in frames), 5)
        scan_ms = host_ms(lambda: scanner.scan(stream, 1 << 20), 5)
        scan_plain_ms = host_ms(lambda: _py_scan_frames(stream, 1 << 20), 5)

        # the batch decoder against the Python loop
        fn = native.pydecode()
        check(fn is not None, f"{label}: pydecode is unavailable")

        def decode():
            return fn(stream, offs, lens, 0, msg.Broadcast, msg.Direct,
                      msg.deserialize_owned, 0)

        def decode_plain():
            saved = msg._native_decode, msg._native_decode_tried
            msg._native_decode, msg._native_decode_tried = None, True
            try:
                return msg.decode_frames(stream, offs, lens)
            finally:
                msg._native_decode, msg._native_decode_tried = saved
        got, ref = decode(), decode_plain()
        check(len(got) == len(ref) == N and all(
            type(a) is type(b) and a == b for a, b in zip(got, ref)),
              f"{label}: pydecode's messages differ from the Python loop's")
        decode_ms = host_ms(decode, 5)
        decode_plain_ms = host_ms(decode_plain, 3)
        rows[popularity] = dict(
            popularity=popularity, users=U, frames=N, pairs=pairs,
            egress_bytes=nbytes, matrix_source="phase 4's dense matrix",
            egress_encode_ms=encode_ms, egress_plain_ms=plain_ms,
            push_batch_ms=pack_ms, put_loop_ms=put_ms,
            frame_encode_ms=wire_encode_ms,
            frame_encode_plain_ms=wire_encode_plain_ms,
            scan_ms=scan_ms, scan_plain_ms=scan_plain_ms,
            pydecode_ms=decode_ms, decode_plain_ms=decode_plain_ms,
            equal_to_plain=True, run_s=time.perf_counter() - t_run)
        emit("native", **rows[popularity])
    return rows


# ---------------------------------------------------------------------------
# phase 13: the host routing plane (cut-through) on the card's host
# ---------------------------------------------------------------------------


def chunk_of(frames) -> tuple:
    """One receive chunk of ``frames``: the buffer as the wire carries them
    (a 4-byte big-endian length before each) and each frame's offset and
    length."""
    buf = bytearray()
    offs, lens = [], []
    for f in frames:
        offs.append(len(buf) + 4)
        lens.append(len(f))
        buf += len(f).to_bytes(4, "big") + f
    return bytes(buf), np.asarray(offs, np.int64), np.asarray(lens, np.int64)


def plan_chunk(planner, buf, offs, lens) -> tuple:
    """Plan every frame of one chunk in user-origin mode, resuming after
    capacity stops as the drain does: (calls, peers, frames)."""
    peers, frames = [], []
    pos = calls = 0
    while pos < len(offs):
        consumed, stop, p, f = planner.plan(buf, offs, lens, pos, 0)
        calls += 1
        peers.append(p.copy())
        frames.append(f.copy())
        pos += consumed
        check(consumed > 0 or stop == 0, "route plan made no progress")
        if stop != 2:   # STOP_CAPACITY resumes; a residual stop ends it
            break
    return calls, np.concatenate(peers), np.concatenate(frames)


def phase_route(shape: dict = BROKER, bench: dict = ROUTE) -> dict:
    """Phase 13: the host routing plane that a broker without a device
    plane routes through. ``testing.routebench.forward_rate`` (one
    publisher fanning 512 B broadcasts to 8 subscribed receivers through
    an injected broker) with the plane forced ``native`` against its
    scalar twin ``python``, then again with a herd of 4096 parked users
    and a churner flooding Subscribe / Unsubscribe, the native row once
    with in-place deltas and once rebuilding per change; each row must
    deliver what its python twin delivers, through the path it names.
    Then one ``RoutePlanner.plan`` call, and the whole chunk, over a
    2048-frame burst of phase 8's mix against phase 8's 4096-user table
    (median of repeats on the host clock), its pairs equal to the
    oracle's deliveries. One ``route`` line per row."""
    from pushcdn_tpu_torch.native import routeplan
    from pushcdn_tpu_torch.proto import flowclass
    from pushcdn_tpu_torch.testing.routebench import forward_rate

    check(routeplan.available(), "route_plan did not build")
    plain = {k: v for k, v in bench.items() if k != "parked_users"}
    churn = dict(parked_users=bench["parked_users"], churn=True)
    rows = {}
    for row, impl, kw in (
            ("forward", "python", {}), ("forward", "native", {}),
            ("churn", "python", churn),
            ("churn incremental", "native", dict(churn, incremental=True)),
            ("churn rebuild", "native", dict(churn, incremental=False))):
        label = f"route {row} {impl}"
        t_run = time.perf_counter()
        paths0 = route_frames()
        out = asyncio.run(forward_rate(impl, **plain, **kw))
        paths = route_delta(paths0)
        check(out is not None, f"{label}: no row (route_plan missing)")
        delivered = out["msgs"] * out["receivers"] * len(out["trials"])
        sent = out["msgs"] * len(out["trials"])
        twin = rows.get((row.split()[0], "python"))
        if impl == "python":
            check(paths["cutthrough"] == paths["residual"] == 0,
                  f"{label}: the scalar twin planned {paths}")
        else:
            check(paths["cutthrough"] >= sent * (row != "churn rebuild"),
                  f"{label}: {paths} for {sent} published frames")
            check(delivered == twin["delivered_frames"],
                  f"{label}: delivered {delivered} frames, its python twin "
                  f"{twin['delivered_frames']}")
        summary = out.get("route_summary") or {}
        rows[(row, impl)] = r = dict(
            row=row, impl=impl, receivers=out["receivers"],
            msgs=out["msgs"], trials=len(out["trials"]),
            payload=out["payload"], batch=bench["batch"],
            parked_users=kw.get("parked_users", 0),
            delivered_frames=delivered,
            msgs_per_s_median=out["median"],
            msgs_per_s_trials=out["trials"],
            delivered_msgs_per_s=out["delivered"],
            churn_ops_s=out.get("churn_ops_s"),
            rebuilds=summary.get("rebuilds"),
            deltas_applied=summary.get("deltas_applied"),
            cdn_route_batch_frames=paths,
            over_python=(out["delivered"] / twin["delivered_msgs_per_s"]
                         if twin else None),
            matches_python_twin=True, run_s=time.perf_counter() - t_run)
        emit("route", **r)

    # one plan call and one whole chunk against phase 8's table
    sc = BrokerScenario("uniform", 40, shape)
    burst = sc.burst()
    P, n, base = shape["publishers"], shape["frames"], shape["frame_bytes"]
    frames = [burst.frames[i % P][i // P] for i in range(n)]
    buf, offs, lens = chunk_of(frames)
    U = shape["users"]
    masks = np.stack([routeplan.topic_mask(t) for t in sc.topics])
    planner = routeplan.RoutePlanner.create()
    check(planner.build(U, 0, routeplan.topic_mask(range(shape["topics"])),
                        masks, list(sc.keys), np.arange(U, dtype=np.int32))
          and planner.set_classes(flowclass.active_table()),
          "route plan: the table did not build")
    calls, peers, idx = plan_chunk(planner, buf, offs, lens)
    tails = np.asarray([TAIL.unpack_from(f, len(f) - TAIL.size)[:2]
                        + (len(f) > base,) for f in frames], np.int64)
    low = ((tails[:, 0] * 2 + tails[:, 2]) << 32) | tails[:, 1]
    codes = (peers.astype(np.int64) << 40) | low[idx]
    check(np.array_equal(np.sort(codes), np.sort(burst.codes)),
          f"route plan: {len(codes)} pairs against the oracle's "
          f"{len(burst.codes)} deliveries")
    first = planner.plan(buf, offs, lens, 0, 0)[0]
    reps = 50
    row = dict(row="plan", users=U, topics=shape["topics"], frames=n,
               chunk_bytes=len(buf), pairs=len(codes), matches_oracle=True,
               calls_per_chunk=calls, frames_first_call=first,
               plan_call_ms=host_ms(
                   lambda: planner.plan(buf, offs, lens, 0, 0), reps),
               chunk_ms=host_ms(
                   lambda: plan_chunk(planner, buf, offs, lens), reps),
               reps=reps)
    emit("route", **row)
    rows["plan"] = row
    return rows


# ---------------------------------------------------------------------------
# phase 14: the sharded host data plane (worker shards) on the card's host
# ---------------------------------------------------------------------------

HANDOFF_PATHS = ("ring", "fallback", "shed")


def handoff_counts() -> dict:
    """This process's ``cdn_shard_handoff_records`` and ``_frames`` by
    path so far (ring: the shared-memory ring; fallback: the counted
    relay through the control plane a full ring degrades to; shed: past
    the relay's budget)."""
    from pushcdn_tpu_torch.proto import metrics
    return {f"{what}_{p}": fam.labels(path=p).value
            for what, fam in (("records", metrics.SHARD_HANDOFF_RECORDS),
                              ("frames", metrics.SHARD_HANDOFF_FRAMES))
            for p in HANDOFF_PATHS}


async def sharded_broker_checks(label: str, port: int, text: str,
                                shards: int) -> dict:
    """The checks of a ``--shards`` broker's supervisor endpoints: users
    on every worker (``/debug/topology``, each worker's own beside the
    merged one), the workers' ``shard`` labels, ring handoffs in the merged
    ``/metrics`` and torch absent from every worker. Returns the workers'
    numbers."""
    got = await asyncio.to_thread(http_get, port, "/debug/topology")
    check(got is not None and got[0] == 200,
          f"{label}: the supervisor's /debug/topology did not answer")
    merged = json.loads(got[1])
    per_worker = []
    for s in range(shards):
        own = await asyncio.to_thread(http_get, port + 1 + s,
                                      "/debug/topology")
        check(own is not None and own[0] == 200,
              f"{label}: worker shard {s}'s /debug/topology did not answer")
        per_worker.append(json.loads(own[1])["num_users"])
    check(sorted({u["shard"] for u in merged["users"]}) == list(range(shards))
          and all(per_worker),
          f"{label}: users per worker shard {per_worker}: SO_REUSEPORT did "
          "not spread them")
    check(merged["num_users"] == sum(per_worker),
          f"{label}: the merged topology counts {merged['num_users']} users, "
          f"the workers {per_worker}")
    check(metric(text, "cdn_shard_workers") == shards
          and all(f'shard="{s}"' in text for s in range(shards)),
          f"{label}: the merged /metrics lacks a worker shard's samples")
    handoffs = {f"{what}_{p}": metric_sum(text, f"cdn_shard_handoff_{what}",
                                          path=p)
                for what in ("records", "frames") for p in HANDOFF_PATHS}
    check(handoffs["records_ring"] > 0,
          f"{label}: no record crossed a handoff ring: {handoffs}")
    info = [line for line in text.splitlines()
            if line.startswith("cdn_build_info{")]
    check(len(info) == shards and all('torch="absent"' in i for i in info),
          f"{label}: a worker shard imported torch: {info}")
    return dict(users_per_worker=per_worker, handoffs=handoffs,
                build_info=info)


async def sharded_run(popularity: str, seed: int, shape: dict,
                      num_shards: int) -> dict:
    """One in-process run of phase 14: ``testing.shardharness.run_sharded``
    with ``num_shards`` worker shards on this event loop (real
    shared-memory rings at the binary's default size, the in-process
    control bus), phase 8's users dealt round-robin over the workers
    (user ``uid`` on worker ``uid % num_shards``), one burst of phase 8's
    mix from users 0..63 paced as phase 8 paces it. Checks: every user's
    frames against the oracle, in publisher order per lane; every
    publisher frame planned under ``path=cutthrough``; ring handoffs; no
    shed; every worker's byte pool whole after shutdown."""
    import gc

    from pushcdn_tpu_torch.broker import sharding
    from pushcdn_tpu_torch.proto.topic import TopicSpace
    from pushcdn_tpu_torch.proto.transport.memory import Memory
    from pushcdn_tpu_torch.testing.shardharness import run_sharded

    label = f"shards {num_shards}/{popularity}"
    U, base = shape["users"], shape["frame_bytes"]
    sc = BrokerScenario(popularity, seed, shape)
    burst = sc.burst()
    prev_window = Memory.set_duplex_window(256 * 1024)
    t_run = time.perf_counter()
    try:
        run = await run_sharded(
            [(uid % num_shards, topics) for uid, topics in enumerate(sc.topics)],
            num_shards=num_shards, ring_bytes=sharding.DEFAULT_RING_BYTES,
            topics=TopicSpace.range(shape["topics"]))
        pools = [b.limiter.pool for b in run.brokers]
        try:
            setup_s = time.perf_counter() - t_run
            paths0 = route_frames()
            handoff0 = handoff_counts()
            try:
                got, got_bytes, latency_ns, busy_s = await publish_and_drain(
                    label, [u.remote for u, _s in run.connected_users],
                    [burst], base)
            finally:
                paths = route_delta(paths0)
                after = handoff_counts()
                handoffs = {k: int(after[k] - handoff0[k]) for k in after}
            ring_stats = [rt.stats()["rings"] for rt in run.runtimes]
        finally:
            await run.shutdown()
        for _ in range(50):
            gc.collect()
            if all(p is None or p.available == p.capacity for p in pools):
                break
            await asyncio.sleep(0.02)
        in_use = [0 if p is None else p.capacity - p.available for p in pools]
    finally:
        Memory.set_duplex_window(prev_window)

    want = check_in_process_deliveries(label, got, got_bytes, [burst])
    sent = sum(len(f) for f in burst.frames)
    want_paths = {"cutthrough": sent, "residual": 0, "scalar": 0}
    check(paths == want_paths, f"{label}: the publishers' {sent} frames "
          f"were planned by path {paths}, not {want_paths}")
    check(handoffs["records_ring"] > 0 and handoffs["frames_ring"] > 0,
          f"{label}: no record crossed a handoff ring: {handoffs}")
    check(handoffs["records_shed"] == 0,
          f"{label}: the relay shed {handoffs['records_shed']} records")
    check(not any(in_use), f"{label}: byte pools not whole after shutdown: "
          f"{in_use} bytes in use")
    return dict(
        shards=num_shards, popularity=popularity,
        path="the port's host path (cut-through plane) in worker shards on "
        "one event loop, shared-memory rings",
        users=U, topics=shape["topics"], publishers=shape["publishers"],
        frames_per_burst=shape["frames"], deliveries=len(want),
        matches_oracle=True, fifo_per_publisher_and_lane=True,
        ring_bytes=sharding.DEFAULT_RING_BYTES,
        delivered_msgs_per_s=len(want) / busy_s,
        **percentiles_ms(latency_ns),
        cdn_route_batch_frames=paths, cdn_shard_handoff=handoffs,
        rings=ring_stats, pool_bytes_in_use_after_shutdown=in_use,
        setup_s=setup_s, busy_s=busy_s, run_s=time.perf_counter() - t_run)


def phase_shards(broker_rows: dict, cluster_rows: dict,
                 shape: dict = BROKER, cluster: dict = CLUSTER,
                 runs=((2, "uniform", None), (2, "zipf", 2048))) -> dict:
    """Phase 14: the sharded host data plane. (a) ``runs`` (worker shards,
    popularity, users) in process at phase 8's width on phase 8's seeds,
    each beside phase 8's ``host`` run on the same burst; (b) a marshal
    and ``broker --shards 2`` as processes with phase 9's clients and
    uniform bursts, beside phase 9's plane-less broker; (c) ``--shards 2
    --device-plane`` refused. One ``shards`` line per run. For the
    script's time limit a run of 4 worker shards (``(4, "uniform",
    None)``) is left out, and the zipf run takes 2048 of phase 8's users
    (``users`` not None: another burst than phase 8's, so no ratio to
    it; the cut is named on its line)."""
    rows = {}
    for num_shards, popularity, users in runs:
        seed = 40 + (popularity == "zipf")   # phase 8's seeds
        rows[(num_shards, popularity)] = row = asyncio.run(
            sharded_run(popularity, seed, shape if users is None
                        else dict(shape, users=users), num_shards))
        host = broker_rows.get(("host", popularity))
        if users is not None:
            row["cut"] = (f"{users} of phase 8's {shape['users']} users, "
                          "for the script's time limit")
        elif host is not None:
            row["host_msgs_per_s"] = host["delivered_msgs_per_s"]
            row["over_host"] = (row["delivered_msgs_per_s"]
                                / host["delivered_msgs_per_s"])
        emit("shards", run="in process", **row)
    row = asyncio.run(cluster_run("host", 90, cluster, shards=2))
    host = cluster_rows["host"]
    row["host_msgs_per_s"] = host["delivered_msgs_per_s"]
    row["host_p50_ms"] = host["publish_to_receive_ms_p50"]
    row["host_p99_ms"] = host["publish_to_receive_ms_p99"]
    row["over_host"] = row["delivered_msgs_per_s"] / row["host_msgs_per_s"]
    rows["processes"] = row
    emit("shards", run="processes", **row)
    rows["refusal"] = row = shards_refusal()
    emit("shards", run="refusal", **row)
    return rows


def shards_refusal() -> dict:
    """``broker --shards 2 --device-plane`` must exit non-zero with the
    JAX binary's message, before it starts a worker or touches the card."""
    kids = Children(f"shards-refusal-{os.getpid()}")
    pub, priv = free_ports(2)
    t0 = time.perf_counter()
    try:
        kids.spawn("broker", "--discovery-endpoint",
                   os.path.join(HERE, ".build", "shards-refusal.sqlite"),
                   "--public-advertise-endpoint", f"127.0.0.1:{pub}",
                   "--public-bind-endpoint", f"127.0.0.1:{pub}",
                   "--private-advertise-endpoint", f"127.0.0.1:{priv}",
                   "--private-bind-endpoint", f"127.0.0.1:{priv}",
                   "--shards", "2", "--device-plane")
        try:
            rc = kids.procs["broker"].wait(60)
        except subprocess.TimeoutExpired:
            rc = None
        out = log_tail(kids.logs["broker"])
    finally:
        kids.kill()
    needle = "--shards is a host-data-plane feature"
    check(rc not in (0, None) and needle in out,
          f"shards refusal: exit {rc}:\n{out}")
    check("shard worker" not in out and "broker serving" not in out,
          f"shards refusal: a worker or a plane started:\n{out}")
    return dict(exit_code=rc, message=needle, seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 15: durable topics, admission and re-homing under the dense plane
# ---------------------------------------------------------------------------

# phase 8's broker with 32 of its 256 topics retained; the plane's user
# slots take phase 8's 4096 users plus the 256 late subscribers and the 32
# last-value readers, so every user sits on the plane
DURABLE = dict(BROKER, retained=32, late_users=256, lvc_users=32,
               retain_count=1024)
# the admission run: 1024 user slots, budgets as an operator sets them
ADMISSION = dict(BROKER, users=64, plane_slots=1024, max_user_conns=64,
                 subscribe_rate=20, subscribe_burst=20, shed_ready_s=2,
                 mutations=100)
# the re-homing run: phase 9's binaries, 256 TCP+TLS clients, 16 of them
# publishing one uniform burst
REHOME = dict(CLUSTER, users=256, publishers=16, auth_concurrency=64)


class EnvKnobs:
    """Set environment knobs for the brokers built inside the block (a
    broker reads them once, in ``Broker.new``), and restore them."""

    def __init__(self, **knobs):
        self.knobs = {k: str(v) for k, v in knobs.items()}
        self.saved = {}

    def __enter__(self):
        for k, v in self.knobs.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def tail_of(payload) -> tuple:
    """(publisher, seq) of a smoke payload."""
    pub, seq, _ = TAIL.unpack_from(payload, len(payload) - TAIL.size)
    return pub, seq


def retained_oracle(bursts, retained: int) -> dict:
    """Per retained topic, the (publisher, seq) of every broadcast naming
    it, burst by burst in the order each publisher sends them."""
    want = {t: [] for t in range(retained)}
    for burst in bursts:
        for pub_msgs in burst.messages:
            for direct, target, head in pub_msgs:
                if direct:
                    continue
                for t in target:
                    if t < retained:
                        want[t].append(tail_of(head + bytes(8)))
    return want


def late_burst(burst: Burst, late_topics: list, base: int,
               first_uid: int) -> Burst:
    """``burst`` with the late users (uids ``first_uid``.., each
    subscribed to ``late_topics[i]``) added to its oracle."""
    codes, nbytes = [burst.codes], list(burst.nbytes)
    payload = list(burst.payload_bytes)
    by_topic = {}
    for i, t in enumerate(late_topics):
        by_topic.setdefault(t, []).append(first_uid + i)
    nbytes += [0] * len(late_topics)
    payload += [0] * len(late_topics)
    for frames, msgs in zip(burst.frames, burst.messages):
        for frame, (direct, target, head) in zip(frames, msgs):
            if direct:
                continue
            uids = sorted({u for t in target for u in by_topic.get(t, ())})
            if not uids:
                continue
            pub, seq = tail_of(head + bytes(8))
            lane = int(len(frame) > base)
            code = ((pub * 2 + lane) << 32) | seq
            codes.append((np.asarray(uids, np.int64) << 40) | code)
            for u in uids:
                nbytes[u] += len(frame)
                payload[u] += len(head) + 8
    return Burst(burst.frames, burst.messages, np.concatenate(codes),
                 np.asarray(nbytes, np.int64), np.asarray(payload, np.int64))


async def connect_user(run, key: bytes, topics=()):
    """Inject one more user under ``key``, as ``inject_users`` does."""
    from pushcdn_tpu_torch.broker.tasks.handlers import user_receive_loop
    from pushcdn_tpu_torch.broker.test_harness import TestUser
    from pushcdn_tpu_torch.proto.transport.memory import (
        gen_testing_connection_pair,
    )
    from pushcdn_tpu_torch.proto.util import AbortOnDropHandle
    broker = run.broker
    local, remote = await gen_testing_connection_pair(broker.limiter)
    task = asyncio.create_task(user_receive_loop(broker, key, local))
    broker.connections.add_user(key, local, list(topics),
                                AbortOnDropHandle(task))
    user = TestUser(key, remote)
    run.connected_users.append(user)
    return user


async def recv_frames(remote, n: int, label: str, quiet: float = 0.2):
    """Exactly ``n`` frames from ``remote``, then a quiet window in which
    a duplicate would land."""
    out = []
    try:
        async with asyncio.timeout(60):
            while len(out) < n:
                for raw in await remote.recv_raw_many():
                    out.append(bytes(raw.data))
                    raw.release()
    except TimeoutError:
        raise SmokeFailure(f"{label}: {len(out)} of {n} frames arrived") \
            from None
    try:
        raws = await asyncio.wait_for(remote.recv_raw_many(), quiet)
        extra = len(raws)
    except TimeoutError:
        extra = 0
    check(extra == 0, f"{label}: {extra} frames beyond the {n} expected")
    return out


def check_ring(label: str, durable, t: int, want: list, cap: int) -> None:
    """Ring ``t`` holds the last min(n, cap) of its n retained broadcasts,
    sequence numbers contiguous up to the ring's last, each publisher's
    frames in send order."""
    entries = durable.snapshot(t, 0)
    got = [tail_of(e.payload) for e in entries]
    n = len(want)
    check(len(got) == min(n, cap),
          f"{label}: ring {t} holds {len(got)} of min({n}, {cap})")
    check(set(got) <= set(want) and (n > cap or set(got) == set(want)),
          f"{label}: ring {t} holds frames the oracle did not retain there")
    seqs = [e.seq for e in entries]
    check(seqs == list(range(n - len(got) + 1, n + 1)),
          f"{label}: ring {t}'s sequence numbers are not contiguous to {n}")
    by_pub = {}
    for pub, seq in got:
        by_pub.setdefault(pub, []).append(seq)
    check(all(s == sorted(s) for s in by_pub.values()),
          f"{label}: ring {t} holds a publisher's frames out of order")


async def durable_run(device, shape: dict = DURABLE, seed: int = 40) -> dict:
    """Phase 15 (a): phase 8's dense broker retaining topics 0..31. Burst
    1 from phase 8's uniform seed, late users replaying one retained
    topic each from seq 0, burst 2 live to everyone, then last-value
    reads. Every check of the run, then its numbers."""
    from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
    from pushcdn_tpu_torch.broker.device_plane import DevicePlaneConfig
    from pushcdn_tpu_torch.broker.test_harness import TestRun
    from pushcdn_tpu_torch.ops import delivery_kernel as dk
    from pushcdn_tpu_torch.proto import metrics
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.def_ import testing_run_def
    from pushcdn_tpu_torch.proto.message import (
        SEQ_LAST,
        Retained,
        SubscribeFrom,
        deserialize,
    )
    from pushcdn_tpu_torch.proto.topic import TopicSpace
    from pushcdn_tpu_torch.proto.transport.memory import Memory

    label = "durable retained topics"
    U, base, R = shape["users"], shape["frame_bytes"], shape["retained"]
    late, lvc = shape["late_users"], shape["lvc_users"]
    cap = shape["retain_count"]
    sc = BrokerScenario("uniform", seed, shape)
    burst1 = sc.burst()
    burst2 = sc.burst()
    want = retained_oracle([burst1, burst2], R)
    # worked out from the mix before the run: does any ring evict?
    per_ring = [len(v) for v in want.values()]
    evicts = max(per_ring) > cap
    late_topics = [i % R for i in range(late)]
    plane_cfg = DevicePlaneConfig(
        num_user_slots=U + late + lvc, ring_slots=shape["ring_slots"],
        frame_bytes=base, extra_lanes=(shape["extra_lane"],),
        topic_words=shape["topic_words"], bypass_max_items=0,
        delivery_impl="dense")
    db = os.path.join(HERE, ".build", f"smoke-durable-{os.getpid()}.sqlite")
    prev_window = Memory.set_duplex_window(256 * 1024)
    t_run = time.perf_counter()
    try:
        with EnvKnobs(PUSHCDN_RETAIN_TOPICS=f"0-{R - 1}",
                      PUSHCDN_RETAIN_COUNT=cap):
            broker = await Broker.new(BrokerConfig(
                run_def=testing_run_def(
                    topics=TopicSpace.range(shape["topics"])),
                keypair=DEFAULT_SCHEME.generate_keypair(seed=seed),
                discovery_endpoint=db,
                public_advertise_endpoint="smoke-durable-pub",
                public_bind_endpoint="smoke-durable-pub",
                private_advertise_endpoint="smoke-durable-priv",
                private_bind_endpoint="smoke-durable-priv",
                heartbeat_interval_s=3600, sync_interval_s=3600,
                whitelist_interval_s=3600, device_plane=plane_cfg,
                device=device))
        await broker.start()
        run = TestRun(broker=broker)
        try:
            await run.inject_users(sc.topics)
            plane, durable = broker.device_plane, broker.durable
            check(durable.enabled and sorted(durable.topics) == list(range(R)),
                  f"{label}: the broker retains {sorted(durable.topics)}")
            dk.LAUNCHES = 0
            got1, bytes1, _, busy1 = await publish_and_drain(
                label + " burst 1", [u.remote for u in run.connected_users],
                [burst1], base)
            # the late users: each replays one retained topic from seq 0
            late_users = [await connect_user(run, b"late-%d" % i)
                          for i in range(late)]
            snapshots = {t: [(e.seq, bytes(e.payload))
                             for e in durable.snapshot(t, 0)]
                         for t in range(R)}
            for i, u in enumerate(late_users):
                await u.remote.send_message(
                    SubscribeFrom(topic=late_topics[i], seq=0), flush=True)
            t0 = time.perf_counter()
            replays = await asyncio.gather(*(
                recv_frames(u.remote, len(snapshots[late_topics[i]]),
                            f"{label}: late user {i}'s replay")
                for i, u in enumerate(late_users)))
            replay_s = time.perf_counter() - t0
            for i, frames in enumerate(replays):
                t = late_topics[i]
                msgs = [deserialize(f) for f in frames]
                check(all(isinstance(m, Retained) and m.topic == t
                          for m in msgs),
                      f"{label}: late user {i}'s replay is not topic {t}'s")
                check([(m.seq, bytes(m.payload)) for m in msgs]
                      == snapshots[t],
                      f"{label}: late user {i}'s replay differs from ring {t}")
            # burst 2: live to the 4096 users and the late subscribers
            b2 = late_burst(burst2, late_topics, base, U)
            got2, bytes2, _, busy2 = await publish_and_drain(
                label + " burst 2", [u.remote for u in run.connected_users],
                [b2], base)
            # the last-value readers
            lvc_users = [await connect_user(run, b"lvc-%d" % t)
                         for t in range(lvc)]
            for t, u in enumerate(lvc_users):
                await u.remote.send_message(
                    SubscribeFrom(topic=t % R, seq=SEQ_LAST), flush=True)
            newest = [durable.snapshot(t % R, SEQ_LAST) for t in range(lvc)]
            lasts = await asyncio.gather(*(
                recv_frames(u.remote, len(newest[t]),
                            f"{label}: last value {t}")
                for t, u in enumerate(lvc_users)))
            for t, frames in enumerate(lasts):
                check(len(want[t % R]) == 0 or len(frames) == 1,
                      f"{label}: last_value({t % R}) returned nothing")
                for frame, e in zip(frames, newest[t]):
                    m = deserialize(frame)
                    check(isinstance(m, Retained)
                          and (m.seq, bytes(m.payload))
                          == (e.seq, bytes(e.payload))
                          and e.seq == len(want[t % R]),
                          f"{label}: last_value({t % R}) is not the "
                          "ring's newest")
            launches = dk.LAUNCHES
            for t in range(R):
                check_ring(label, durable, t, want[t], cap)
            stats = durable.stats()
            text = metrics.render_all()
            gauge = sum(float(line.split()[-1]) for line in text.splitlines()
                        if line.startswith("cdn_retention_ring_entries{"))
            check(gauge == sum(stats["ring_entries"].values()),
                  f"{label}: cdn_retention_ring_entries {gauge} != the "
                  f"rings' {sum(stats['ring_entries'].values())}")
            pstats = plane_stats(plane)
        finally:
            await run.shutdown()
    finally:
        Memory.set_duplex_window(prev_window)
        for suffix in ("", "-wal", "-shm"):
            if os.path.exists(db + suffix):
                os.remove(db + suffix)
    want1 = check_in_process_deliveries(label + " burst 1", got1, bytes1,
                                        [burst1])
    want2 = check_in_process_deliveries(label + " burst 2", got2, bytes2,
                                        [b2])
    live = len(want1) + len(want2)
    check(not plane.disabled and plane.delivery_impl == "dense",
          f"{label}: the plane disabled itself or switched impl")
    check(plane.messages_routed == live,
          f"{label}: the plane routed {plane.messages_routed} of {live} "
          "live deliveries; the rest took the host path")
    check(launches > 0, f"{label}: never launched delivery_matrix_cuda")
    check(pstats["native_egress_steps"] == pstats["busy_steps"] > 0,
          f"{label}: {pstats['native_egress_steps']} of "
          f"{pstats['busy_steps']} busy steps egressed natively")
    return dict(
        run="retained topics", users=U, late_users=late, lvc_users=lvc,
        retained_topics=R, retain_count=cap,
        retained_per_ring_max=max(per_ring), retained_total=sum(per_ring),
        any_ring_evicts=evicts, ring_entries=sum(stats["ring_entries"].values()),
        evicted_entries=stats["evicted_entries"],
        replayed_frames=stats["replayed_frames"],
        replay_s=replay_s, deliveries=live, matches_oracle=True,
        delivered_msgs_per_s_burst1=len(want1) / busy1,
        delivered_msgs_per_s_burst2=len(want2) / busy2,
        delivery_matrix_cuda=launches, run_s=time.perf_counter() - t_run,
        **pstats)


async def admission_run(device, shape: dict = ADMISSION) -> dict:
    """Phase 15 (b): a broker with a dense plane of 1024 user slots and
    admission budgets set. A real client over budget is refused before
    authentication; one user's 100 subscribe mutations meet the bucket;
    a broadcast on a shed topic reaches no one while the plane launches;
    ``/readyz`` reads the shed, then recovers."""
    from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
    from pushcdn_tpu_torch.broker.device_plane import DevicePlaneConfig
    from pushcdn_tpu_torch.broker.tasks import listeners
    from pushcdn_tpu_torch.broker.tasks.heartbeat import heartbeat_once
    from pushcdn_tpu_torch.broker.test_harness import TestRun
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.marshal import Marshal, MarshalConfig
    from pushcdn_tpu_torch.ops import delivery_kernel as dk
    from pushcdn_tpu_torch.proto import metrics
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.def_ import testing_run_def
    from pushcdn_tpu_torch.proto.error import Error, ErrorKind
    from pushcdn_tpu_torch.proto.message import (
        AuthenticateResponse,
        Broadcast,
        Subscribe,
        deserialize,
        serialize,
    )
    from pushcdn_tpu_torch.proto.topic import TopicSpace
    from pushcdn_tpu_torch.proto.transport.memory import (
        Memory,
        gen_testing_connection_pair,
    )

    label = "durable admission"
    U = shape["users"]
    rng = np.random.default_rng(1500)
    # the injected users keep to topics 0..99; the storm asks for 100..199
    topics = [sorted({int(t) for t in rng.integers(0, 100, 3)})
              for _ in range(U)]
    storm = [100 + i for i in range(shape["mutations"])]
    plane_cfg = DevicePlaneConfig(
        num_user_slots=shape["plane_slots"], ring_slots=shape["ring_slots"],
        frame_bytes=shape["frame_bytes"], extra_lanes=(shape["extra_lane"],),
        topic_words=shape["topic_words"], bypass_max_items=0,
        delivery_impl="dense")
    db = os.path.join(HERE, ".build", f"smoke-admission-{os.getpid()}.sqlite")
    (mport,) = free_ports(1)
    run_def = testing_run_def(topics=TopicSpace.range(shape["topics"]))
    marshal = None
    t_run = time.perf_counter()
    try:
        with EnvKnobs(PUSHCDN_MAX_CONNS_USER=shape["max_user_conns"],
                      PUSHCDN_SUBSCRIBE_RATE=shape["subscribe_rate"],
                      PUSHCDN_SUBSCRIBE_BURST=shape["subscribe_burst"],
                      PUSHCDN_SHED_READY_S=shape["shed_ready_s"]):
            broker = await Broker.new(BrokerConfig(
                run_def=run_def,
                keypair=DEFAULT_SCHEME.generate_keypair(seed=1500),
                discovery_endpoint=db,
                public_advertise_endpoint="smoke-admission-pub",
                public_bind_endpoint="smoke-admission-pub",
                private_advertise_endpoint="smoke-admission-priv",
                private_bind_endpoint="smoke-admission-priv",
                metrics_bind_endpoint=f"127.0.0.1:{mport}",
                heartbeat_interval_s=3600, sync_interval_s=3600,
                whitelist_interval_s=3600, device_plane=plane_cfg,
                device=device))
        await broker.start()
        await heartbeat_once(broker)
        marshal = await Marshal.new(MarshalConfig(
            run_def=run_def, discovery_endpoint=db,
            bind_endpoint="smoke-admission-marshal"))
        await marshal.start()
        run = TestRun(broker=broker)
        try:
            await run.inject_users(topics)
            adm, plane = broker.admission, broker.device_plane
            # the 65th user: a raw connection gets the typed refusal...
            local, remote = await gen_testing_connection_pair(broker.limiter)

            class Unfinalized:
                async def finalize(self, limiter):
                    return local
            await listeners.handle_user_connection(broker, Unfinalized())
            raw = await asyncio.wait_for(remote.recv_raw(), 5)
            refusal = deserialize(raw.data)
            raw.release()
            remote.close()
            check(isinstance(refusal, AuthenticateResponse)
                  and refusal.permit == 0
                  and refusal.context.startswith("shed:"),
                  f"{label}: the 65th user got {refusal!r}")
            # ...and a real client through the marshal raises it typed
            client = Client(ClientConfig(
                marshal_endpoint="smoke-admission-marshal",
                keypair=DEFAULT_SCHEME.generate_keypair(seed=1565),
                protocol=Memory))
            try:
                await asyncio.wait_for(client._connect_once(), 10)
                client_error = None
            except Error as e:
                client_error = e
            finally:
                client.close()
            check(client_error is not None
                  and client_error.kind == ErrorKind.SHED
                  and "shed:" in str(client_error)
                  and client_error.retry_after_s == shape["shed_ready_s"],
                  f"{label}: the 65th client raised {client_error!r}")
            check(broker.connections.num_users == U,
                  f"{label}: {broker.connections.num_users} users after "
                  "the refusals")
            ready0 = await asyncio.to_thread(http_get, mport, "/readyz")
            # one user's subscribe storm against the bucket
            shed0 = metrics.ROUTE_SHED_SUBSCRIBE.value
            storm_user = run.user(0).remote
            await storm_user.send_raw_many(
                [serialize(Subscribe([t])) for t in storm], flush=True)
            notices = []
            async with asyncio.timeout(30):
                while True:
                    applied = set(broker.connections.user_topics
                                  .get_values_of_key(b"user-0")) & set(storm)
                    shed = metrics.ROUTE_SHED_SUBSCRIBE.value - shed0
                    if len(applied) + shed >= len(storm):
                        break
                    await asyncio.sleep(0.01)
            notices = [deserialize(f) for f in await recv_frames(
                storm_user, int(shed), f"{label}: shed notices")]
            check(all(isinstance(m, AuthenticateResponse) and m.permit == 0
                      and "shed" in m.context for m in notices),
                  f"{label}: a shed notice was not typed")
            check(len(applied) + shed == len(storm)
                  and shed >= len(storm) - shape["subscribe_burst"] - 5,
                  f"{label}: {len(applied)} applied and {shed} shed of "
                  f"{len(storm)}")
            ready1 = await asyncio.to_thread(http_get, mport, "/readyz")
            # a broadcast on a shed topic reaches no one; the plane still
            # steps and launches
            shed_topic = max(set(storm) - applied)
            kept_topic = min(applied)
            dk.LAUNCHES = 0
            routed0 = plane.messages_routed
            await run.user(1).remote.send_message(
                Broadcast([shed_topic], b"nobody"), flush=True)
            await run.user(1).remote.send_message(
                Broadcast([kept_topic], b"storm user"), flush=True)
            (frame,) = await recv_frames(storm_user, 1,
                                         f"{label}: the kept topic")
            check(deserialize(frame).message == b"storm user",
                  f"{label}: the storm user got the shed topic's broadcast")
            for u in run.connected_users[1:]:
                try:
                    raws = await asyncio.wait_for(u.remote.recv_raw_many(),
                                                  0.01)
                except TimeoutError:
                    raws = []
                check(not raws, f"{label}: user {u.public_key} got a "
                      "broadcast nobody asked for")
            launches = dk.LAUNCHES
            routed = plane.messages_routed - routed0
            check(launches > 0, f"{label}: the plane never launched")
            check(routed == 1, f"{label}: the plane routed {routed} "
                  "deliveries of the two broadcasts (1 expected)")
            await asyncio.sleep(shape["shed_ready_s"] + 0.2)
            ready2 = await asyncio.to_thread(http_get, mport, "/readyz")
        finally:
            await run.shutdown()
    finally:
        if marshal is not None:
            await marshal.stop()
        for suffix in ("", "-wal", "-shm"):
            if os.path.exists(db + suffix):
                os.remove(db + suffix)

    def admission_ok(reply):
        check(reply is not None, f"{label}: /readyz did not answer")
        return json.loads(reply[1])["checks"]["admission"]["ok"]
    readiness = [admission_ok(r) for r in (ready0, ready1, ready2)]
    check(readiness == [False, False, True],
          f"{label}: /readyz admission read {readiness} (the refusals, the "
          "storm, then 2 s later)")
    return dict(
        run="admission", users=U, plane_slots=shape["plane_slots"],
        max_user_conns=shape["max_user_conns"],
        subscribe_rate=shape["subscribe_rate"],
        subscribe_burst=shape["subscribe_burst"],
        refusal_context=refusal.context, client_error=client_error.kind.name,
        mutations=len(storm), applied=len(applied), shed=int(shed),
        notices=len(notices), readyz_admission=readiness,
        shed_counts=adm.summary()["shed_counts"],
        delivery_matrix_cuda=launches, run_s=time.perf_counter() - t_run)


async def rehome_run(shape: dict = REHOME, seed: int = 150,
                     device=None) -> dict:
    """Phase 15 (c): a marshal and broker A (``--device-plane``) serve
    256 TCP+TLS clients; broker B starts; A is signaled and re-homes every
    client to B with a pre-issued permit; a uniform burst then reaches
    every client through B's plane; ``GET /drain`` on B finds no target.
    Every check, then its numbers. The brokers run on the binary's
    default device (CUDA) unless ``device`` names another."""
    import signal
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.message import Broadcast, Direct
    from pushcdn_tpu_torch.proto.transport import TcpTls

    label = "durable re-homing"
    U, P = shape["users"], shape["publishers"]
    pairs = [DEFAULT_SCHEME.generate_keypair(seed=seed * 1_000_000 + u)
             for u in range(U)]
    sc = BrokerScenario("uniform", seed, shape,
                        keys=[k.public_key for k in pairs])
    burst = sc.burst()
    tag = f"rehome-{os.getpid()}"
    db = os.path.join(HERE, ".build", f"{tag}.sqlite")
    for suffix in ("", "-wal", "-shm"):
        if os.path.exists(db + suffix):
            os.remove(db + suffix)
    a_pub, a_priv, marshal, a_metrics = free_ports(4)
    common = ("--discovery-endpoint", db, "--user-transport", "tcp+tls",
              "--broker-transport", "tcp", "--device-plane",
              "--heartbeat-interval", "0.5",
              *(["--device", str(device)] if device else []))
    env = {"PUSHCDN_DELIVERY_IMPL": "dense", "PUSHCDN_DRAIN_GRACE_S": "2"}

    def endpoints(pub, priv, metrics_port):
        return ("--public-advertise-endpoint", f"127.0.0.1:{pub}",
                "--public-bind-endpoint", f"127.0.0.1:{pub}",
                "--private-advertise-endpoint", f"127.0.0.1:{priv}",
                "--private-bind-endpoint", f"127.0.0.1:{priv}",
                "--metrics-bind-endpoint", f"127.0.0.1:{metrics_port}")
    kids = Children(tag)
    clients, drains = [], []
    t_run = time.perf_counter()
    try:
        kids.spawn("a", *common, *endpoints(a_pub, a_priv, a_metrics),
                   env=env, binary="broker")
        kids.spawn("marshal", "--discovery-endpoint", db,
                   "--bind-endpoint", f"127.0.0.1:{marshal}",
                   "--user-transport", "tcp+tls")
        await kids.wait_for_line("a", "broker serving", label, timeout=120)
        clients = [Client(ClientConfig(
            marshal_endpoint=f"127.0.0.1:{marshal}", keypair=kp,
            protocol=TcpTls, subscribed_topics=set(topics)))
            for kp, topics in zip(pairs, sc.topics)]
        gate = asyncio.Semaphore(shape["auth_concurrency"])

        async def authenticate(client):
            async with gate:
                await client.ensure_initialized()
        async with asyncio.timeout(120):
            await asyncio.gather(*(authenticate(c) for c in clients))
        # from here on a marshal round trip is counted per client
        dials = [0] * U
        for uid, c in enumerate(clients):
            def counted(orig=c._connect_once, uid=uid):
                dials[uid] += 1
                return orig()
            c._connect_once = counted

        got = [[] for _ in range(U)]
        got_bytes = np.zeros(U, np.int64)
        seen = [0, 0]   # frames, perf_counter ns of the last

        async def drain(uid, client):
            # a client acts on Migrate while it receives
            while True:
                messages = await client.receive_messages()
                now = time.perf_counter_ns()
                for m in messages:
                    pub_, seq, _ = TAIL.unpack_from(
                        m.message, len(m.message) - TAIL.size)
                    got[uid].append((pub_ * 2 << 32) | seq)
                    got_bytes[uid] += len(m.message)
                    seen[0] += 1
                seen[1] = now

        drains = [asyncio.create_task(drain(uid, c))
                  for uid, c in enumerate(clients)]
        # B's ports are picked only now: the clients' 512 connections take
        # their source ports from the same range, and one of them could
        # have taken a port picked before they dialed
        b_pub, b_priv, b_metrics = free_ports(3)
        kids.spawn("b", *common, *endpoints(b_pub, b_priv, b_metrics),
                   env=env, binary="broker")
        b_serving = await kids.wait_for_line("b", "broker serving", label,
                                             timeout=120)
        await asyncio.sleep(1.5)   # B's heartbeats register it
        t0 = time.perf_counter()
        kids.procs["a"].send_signal(signal.SIGTERM)

        async def b_users():
            reply = await asyncio.to_thread(http_get, b_metrics,
                                            "/debug/topology")
            return json.loads(reply[1])["num_users"] \
                if reply and reply[0] == 200 else -1
        try:
            async with asyncio.timeout(60):
                while await b_users() < U:
                    await asyncio.sleep(0.1)
        except TimeoutError:
            raise SmokeFailure(f"{label}: {await b_users()} of {U} users "
                               f"reached B:\n{log_tail(kids.logs['a'])}") \
                from None
        rehome_s = time.perf_counter() - t0
        a_rc = await asyncio.to_thread(kids.procs["a"].wait, 60)
        del kids.procs["a"]   # it exited; B and the marshal serve on
        a_log = log_tail(kids.logs["a"], 1 << 20)
        check(a_rc == 0, f"{label}: broker A exited {a_rc}:\n{a_log[-4000:]}")
        summaries = [line.split("drain re-home: ", 1)[1]
                     for line in a_log.splitlines() if "drain re-home: " in line]
        import ast
        summary = ast.literal_eval(summaries[-1]) if summaries else None
        check(summary is not None and summary["users"] == U
              and summary["signaled"] == U and summary["orphaned"] == 0,
              f"{label}: A's drain re-home read {summary}")
        check(all(len(c.rehome_ms) == 1 for c in clients),
              f"{label}: {sum(len(c.rehome_ms) == 1 for c in clients)} of "
              f"{U} clients completed one migration")
        check(not any(dials), f"{label}: {sum(map(bool, dials))} clients "
              "went back to the marshal instead of using their permit")
        # the burst through B
        async def one(pub_):
            client = clients[pub_]
            for direct, target, head in burst.messages[pub_]:
                body = head + struct.pack("<q", time.perf_counter_ns())
                await client.send_message(
                    Direct(target, body) if direct
                    else Broadcast(target, body))
        t0 = time.perf_counter_ns()
        await asyncio.gather(*(one(p) for p in range(P)))
        try:
            async with asyncio.timeout(120):
                while seen[0] < len(burst.codes):
                    kids.check_alive(label)
                    await asyncio.sleep(0.005)
        except TimeoutError:
            raise SmokeFailure(f"{label}: {seen[0]} of {len(burst.codes)} "
                               "frames arrived through B") from None
        busy_s = (seen[1] - t0) / 1e9
        await asyncio.sleep(0.3)
        scraped = await asyncio.to_thread(http_get, b_metrics, "/metrics")
        check(scraped is not None and scraped[0] == 200,
              f"{label}: B's /metrics did not answer")
        routed = metric(scraped[1], "cdn_device_messages_routed")
        drained = await asyncio.to_thread(http_get, b_metrics, "/drain")
        check(drained is not None and drained[0] == 200,
              f"{label}: B's /drain answered {drained}")
        drained = json.loads(drained[1])
        check(drained["no_target"] and drained["users"] == U,
              f"{label}: B's /drain read {drained}")
        await asyncio.sleep(0.5)
        check(await b_users() == U, f"{label}: B lost users on a /drain "
              "with no target")
        for t in drains:
            t.cancel()
        await asyncio.gather(*drains, return_exceptions=True)
        for c in clients:
            c.close()
        kids.terminate(label)
        b_exit = log_fields(kids.logs["b"], "device plane exit")
    finally:
        for t in drains:
            t.cancel()
        for c in clients:
            c.close()
        kids.kill()
        for suffix in ("", "-wal", "-shm"):
            if os.path.exists(db + suffix):
                os.remove(db + suffix)

    lane_bit = np.int64(1) << 32
    want = np.sort(burst.codes & ~lane_bit)
    have = np.sort(np.concatenate(
        [np.empty(0, np.int64)]
        + [(np.int64(uid) << 40) | np.asarray(c, np.int64)
           for uid, c in enumerate(got)]))
    check(have.shape == want.shape and (have == want).all(),
          f"{label}: the {len(have)} deliveries through B differ from the "
          f"oracle's {len(want)}")
    check(np.array_equal(got_bytes, burst.payload_bytes),
          f"{label}: received payload bytes differ from the oracle's")
    check(routed > 0, f"{label}: B's /metrics shows "
          "cdn_device_messages_routed 0")
    traffic = b_exit["launches"]["delivery_matrix_cuda"] \
        - b_serving["launches"]["delivery_matrix_cuda"]
    check(traffic > 0, f"{label}: B never launched delivery_matrix_cuda "
          "after its warm-up")
    return dict(
        run="re-homing", clients=U, transport="tcp+tls", publishers=P,
        frames=shape["frames"], drain_rehome=summary, rehome_s=rehome_s,
        rehome_ms_median=float(np.median([c.rehome_ms[0] for c in clients])),
        deliveries=len(want), matches_oracle=True,
        delivered_msgs_per_s=len(want) / busy_s, messages_routed=routed,
        b_drain=drained, delivery_matrix_cuda=traffic,
        b_exit={k: b_exit[k] for k in ("steps", "messages_routed",
                                        "launches", "busy_steps",
                                        "native_egress_steps")},
        run_s=time.perf_counter() - t_run)


def phase_durable(device, broker_rows: dict) -> int:
    """Phase 15: (a) retained topics through the plane, beside phase 8's
    dense uniform run on the same first burst; (b) admission under the
    plane; (c) re-homing through the binaries. One ``durable`` line per
    run; returns the dense kernel's launches over the three runs'
    traffic."""
    row = asyncio.run(durable_run(device))
    dense = broker_rows.get(("dense", "uniform"))
    if dense is not None:
        row["phase8_dense_uniform_msgs_per_s"] = dense["delivered_msgs_per_s"]
    emit("durable", **row)
    launches = row["delivery_matrix_cuda"]
    row = asyncio.run(admission_run(device))
    emit("durable", **row)
    launches += row["delivery_matrix_cuda"]
    row = asyncio.run(rehome_run())
    emit("durable", **row)
    return launches + row["delivery_matrix_cuda"]


# ---------------------------------------------------------------------------
# phase 16: the operator's and the measurer's tooling on the card
# ---------------------------------------------------------------------------

# (b): 1024 consensus nodes over two brokers, 8 views; (c): 4 soak packs of
# 255 clients on 8 topics (1020 users and the publisher fill the binary's
# 1024 plane slots), 64 sequenced 512 B broadcasts a topic in 8 waves, and
# storm packs of 128 clients x 250 reconnect cycles (phase 16 runs one of
# the 2 for the script's time limit)
TOOLING = dict(runner_duration=10, nodes=1024, views=8, view_timeout_s=30.0,
               consensus_slots=1024, packs=4, pack_clients=255, topics=8,
               per_topic=64, payload=512, waves=8, wave_gap_s=0.05,
               storm_packs=2, storm_clients=128, storm_cycles=250)

RUNNER_OK = ("OK: end-to-end echo through real processes",
             "readiness pre-bind: 503 not-ready", "trace chain complete",
             "health OK (4 processes", "topology OK", "trace report OK",
             "0 orphaned spans", "drain readiness flip observed")


def runner_run(shape: dict = TOOLING, device=None) -> dict:
    """Phase 16 (a): ``python -m pushcdn_tpu_torch.scripts.local_cluster
    --device-plane`` as the README's quick start runs it (the marshal, two
    brokers with dense planes on the card, the echo client), its span logs
    and each process's log kept under ``.build``. Every OK line of the JAX
    runner's tier-1 test, no FAIL; each broker serving on the card, its
    exit line's launches split into warm-up and traffic."""
    import glob
    import shutil
    label = "tooling runner"
    tmp = os.path.join(HERE, ".build", f"tooling-runner-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    env = dict(os.environ, TMPDIR=tmp)
    argv = [sys.executable, "-m", "pushcdn_tpu_torch.scripts.local_cluster",
            "--device-plane", "--duration", str(shape["runner_duration"]),
            "--base-port", "0", "--trace-log", os.path.join(tmp, "spans")]
    if device is not None:
        argv += ["--device", str(device)]
    t0 = time.perf_counter()
    # its own session, so that a runner past its time is killed with every
    # process it started
    proc = subprocess.Popen(argv, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        import signal
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise SmokeFailure(f"{label}: the runner did not end in 180 s:\n"
                           f"{out[-3000:]}") from None
    run_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"{label}: rc {proc.returncode}:\n{out[-4000:]}")
    for needle in RUNNER_OK:
        check(needle in out, f"{label}: no {needle!r} line:\n{out[-4000:]}")
    check("FAIL" not in out, f"{label}: a FAIL line:\n{out[-4000:]}")
    (logdir,) = glob.glob(os.path.join(tmp, "pushcdn-cluster-*"))
    card = None
    if device is None:
        import torch
        card = torch.cuda.get_device_name(0)
    brokers = {}
    for name in ("broker0", "broker1"):
        path = os.path.join(logdir, f"{name}.log")
        serving = log_fields(path, "broker serving")
        done = log_fields(path, "device plane exit")
        check(serving is not None and done is not None,
              f"{label}: {name} logged no serving or exit line:\n"
              f"{log_tail(path)}")
        check(serving["device"].startswith("cuda")
              and serving.get("card") == card,
              f"{label}: {name} serves its plane on {serving['device']} "
              f"({serving.get('card')}), not on {card}")
        check(not done["disabled"], f"{label}: {name}'s plane disabled "
              "itself")
        warm = serving["launches"]
        brokers[name] = dict(
            device=serving["device"], card=serving.get("card"),
            delivery_impl=serving["delivery_impl"],
            warmup_launches=warm,
            traffic_launches={k: v - warm[k]
                              for k, v in done["launches"].items()},
            steps=done["steps"] - serving["steps"],
            plane_frames=done["plane_frames"],
            messages_routed=done["messages_routed"],
            frames_received=done["route_frames"]["scalar"],
            bypassed_frames=done["route_frames"]["scalar"]
            - done["plane_frames"])
    return dict(run="runner", command=" ".join(argv[1:]), run_s=run_s,
                ok_lines=len(RUNNER_OK), brokers=brokers,
                note="the echo client sends one broadcast and one direct a "
                     "second; a batch of at most 2 items takes the plane's "
                     "depth-1 bypass to the host path, so the warm-up may "
                     "be the planes' only launches",
                delivery_matrix_cuda=sum(
                    b["traffic_launches"]["delivery_matrix_cuda"]
                    for b in brokers.values()),
                ragged_delivery_cuda=sum(
                    b["traffic_launches"]["ragged_delivery_cuda"]
                    for b in brokers.values()))


async def consensus_run(impl: str, shape: dict = TOOLING,
                        device=None) -> dict:
    """Phase 16 (b): ``testing.consensus.run_consensus`` over the port's
    ``Cluster`` of two brokers, each with a plane of ``impl`` on the card
    (``bypass_max_items=0``: every frame, a lone vote too, through the
    kernel), the nodes spread over the brokers by the driver's ``place``
    hook. Every view completes with no timeout, every node receives every
    proposal, every leader holds a quorum, both planes route, the kernel
    launches."""
    from pushcdn_tpu_torch.broker.device_plane import DevicePlaneConfig
    from pushcdn_tpu_torch.ops import delivery_kernel as dk
    from pushcdn_tpu_torch.ops import ragged_delivery as rd
    from pushcdn_tpu_torch.proto import trace as trace_mod
    from pushcdn_tpu_torch.testing import Cluster
    from pushcdn_tpu_torch.testing.consensus import (
        ConsensusConfig,
        percentile,
        run_consensus,
    )

    label = f"tooling consensus {impl}"
    n, views = shape["nodes"], shape["views"]
    cfg = ConsensusConfig(num_nodes=n, num_views=views,
                          view_timeout_s=shape["view_timeout_s"],
                          trace=False)
    trace_mod.set_log_path(None)
    t0 = time.perf_counter()
    cluster = await Cluster(num_brokers=2, device_plane=DevicePlaneConfig(
        num_user_slots=shape["consensus_slots"], bypass_max_items=0,
        delivery_impl=impl), device=device).start()
    try:
        start_s = time.perf_counter() - t0
        before = (dk.LAUNCHES, rd.LAUNCHES)

        async def place(i):
            await cluster.place_on(i % 2)

        t1 = time.perf_counter()
        run = await run_consensus(cluster, cfg, drain_s=10.0, place=place)
        run_s = time.perf_counter() - t1
        launches = (dk.LAUNCHES - before[0], rd.LAUNCHES - before[1])
        planes = [b.device_plane for b in cluster.brokers]
        users = [b.connections.num_users for b in cluster.brokers]
    finally:
        await cluster.stop()
    check(run.completed == views and run.timeouts == 0,
          f"{label}: {run.completed} of {views} views completed, "
          f"{run.timeouts} timed out")
    check(len(run.proposal_delivery_s) == views * n,
          f"{label}: {len(run.proposal_delivery_s)} of {views * n} "
          "proposal deliveries")
    check(all(v.votes >= cfg.effective_quorum() for v in run.views),
          f"{label}: a leader short of quorum: "
          f"{[v.votes for v in run.views]}")
    check(users == [n // 2, n // 2], f"{label}: nodes per broker {users}")
    check(all(p.messages_routed > 0 and not p.disabled
              and p.delivery_impl == impl for p in planes),
          f"{label}: planes routed {[p.messages_routed for p in planes]}, "
          f"disabled {[p.disabled for p in planes]}")
    kernel = launches[0 if impl == "dense" else 1]
    check(kernel > 0, f"{label}: the {impl} kernel never launched")

    def ms(samples, q):
        return percentile(sorted(samples), q) * 1e3

    done = sorted(v.completion_s for v in run.views)
    return dict(
        run="consensus", impl=impl, nodes=n, views=views,
        quorum=cfg.effective_quorum(), brokers=2, nodes_per_broker=users,
        proposal_bytes=cfg.proposal_bytes, vote_bytes=cfg.vote_bytes,
        bypass_max_items=0, start_s=start_s, run_s=run_s,
        completed=run.completed, timeouts=run.timeouts,
        votes_at_completion=[v.votes for v in run.views],
        proposal_deliveries=len(run.proposal_delivery_s),
        vote_deliveries=len(run.vote_delivery_s),
        view_completion_ms_p50=ms(done, 0.50),
        view_completion_ms_p99=ms(done, 0.99),
        proposal_delivery_ms_p99=ms(run.proposal_delivery_s, 0.99),
        vote_delivery_ms_p99=ms(run.vote_delivery_s, 0.99),
        messages_routed=[p.messages_routed for p in planes],
        steps=[p.steps for p in planes],
        delivery_matrix_cuda=launches[0], ragged_delivery_cuda=launches[1])


async def soak_run(label: str, shape: dict, plane: bool,
                   shards: int = 1, device=None, io_impl=None, pump=None,
                   storm_packs=None) -> dict:
    """Phase 16 (c), one deployment: a marshal and a broker (``plane``:
    ``--device-plane`` at the binary's defaults on the card; else
    ``--shards``) as processes on a fresh discovery file, plain TCP users;
    ``packs`` soak packs of ``pack_clients`` clients (``python -m
    pushcdn_tpu_torch.testing.clientpack``), then a publisher here sends
    ``per_topic`` sequenced broadcasts on each topic in ``waves`` waves.
    Every pack ends with no gap, no reorder, no hard reconnect and every
    client's full count. With a plane (on ``device``, the binary's CUDA
    default unless named): its ``/metrics`` routed count and its exit
    line's launches (every busy step egressed through the native
    encoder), then ``storm_packs`` storm packs against it (default
    ``shape["storm_packs"]``; 0: none).

    Phase 17 runs it with ``io_impl`` (``--io-impl`` for the broker and
    the marshal, ``PUSHCDN_IO_IMPL`` for the packs; the publisher here
    stays on asyncio) and ``pump`` (``--pump`` for a plane-less broker):
    with ``uring`` the broker's ``/metrics`` must read the engine in use
    and its io_uring_enter timings; with ``pump`` frames under
    ``cdn_route_batch_frames{path="pump"}``; a plane-less broker on
    asyncio routes under ``path="cutthrough"``."""
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.transport import Tcp
    from pushcdn_tpu_torch.testing.packs import Pack, publish_sequenced

    tag = (f"tooling-{'plane' if plane else f'shards{shards}'}"
           f"-{io_impl or 'default'}-{pump or 'nopump'}-{os.getpid()}")
    db = os.path.join(HERE, ".build", f"{tag}.sqlite")
    for suffix in ("", "-wal", "-shm"):
        if os.path.exists(db + suffix):
            os.remove(db + suffix)
    pub, priv, marshal, marshal_metrics = ports = free_ports(4)
    broker_metrics = metrics_port(shards if shards > 1 else 0, ports)
    kids = Children(tag)
    packs = []
    publisher = None
    row = dict(run="soak", broker="--device-plane" if plane
               else f"--shards {shards}", transport="tcp",
               packs=shape["packs"], clients=shape["packs"]
               * shape["pack_clients"], topics=shape["topics"],
               broadcasts=shape["topics"] * shape["per_topic"],
               payload_bytes=shape["payload"])
    io_args = ["--io-impl", io_impl] if io_impl else []
    if io_impl:
        row.update(io_impl=io_impl, pump=pump or "off")
    try:
        kids.spawn("broker", "--discovery-endpoint", db,
                   "--public-advertise-endpoint", f"127.0.0.1:{pub}",
                   "--public-bind-endpoint", f"127.0.0.1:{pub}",
                   "--private-advertise-endpoint", f"127.0.0.1:{priv}",
                   "--private-bind-endpoint", f"127.0.0.1:{priv}",
                   "--metrics-bind-endpoint", f"127.0.0.1:{broker_metrics}",
                   "--user-transport", "tcp",
                   *(["--device-plane"] if plane
                     else ["--shards", str(shards)]),
                   *(["--device", str(device)] if device else []),
                   *io_args, *(["--pump", pump] if pump else []))
        kids.spawn("marshal", "--discovery-endpoint", db,
                   "--bind-endpoint", f"127.0.0.1:{marshal}",
                   "--metrics-bind-endpoint", f"127.0.0.1:{marshal_metrics}",
                   "--user-transport", "tcp", *io_args)
        serving = await kids.wait_for_line("broker", "broker serving", label,
                                           timeout=180, count=shards)
        try:
            async with asyncio.timeout(60):   # the broker registered
                while (await asyncio.to_thread(http_get, marshal_metrics,
                                               "/readyz") or (0,))[0] != 200:
                    kids.check_alive(label)
                    await asyncio.sleep(0.1)
        except TimeoutError:
            raise SmokeFailure(f"{label}: the marshal was not ready in 60 s:"
                               f"\n{log_tail(kids.logs['marshal'])}") from None
        endpoint = f"127.0.0.1:{marshal}"
        t0 = time.perf_counter()
        for k in range(shape["packs"]):
            packs.append(Pack(
                endpoint, "soak", shape["pack_clients"], 100_000 + 1_000 * k,
                "--report-every-s", "5", "--settle-s", "0.5",
                topics=shape["topics"],
                log_path=os.path.join(HERE, ".build", f"{tag}-pack{k}.log"),
                env={"PUSHCDN_IO_IMPL": io_impl} if io_impl else None))
        for pack in packs:
            await asyncio.to_thread(pack.wait, "ready", 120)
        row["connect_s"] = time.perf_counter() - t0
        publisher = Client(ClientConfig(
            marshal_endpoint=endpoint,
            keypair=DEFAULT_SCHEME.generate_keypair(seed=99_999),
            protocol=Tcp, subscribed_topics=set()))
        async with asyncio.timeout(60):
            await publisher.ensure_initialized()
        kids.check_alive(label)
        want = row["clients"] * shape["per_topic"]
        t0 = time.perf_counter()
        await publish_sequenced(publisher, shape["topics"],
                                shape["per_topic"], shape["payload"],
                                waves=shape["waves"],
                                gap_s=shape["wave_gap_s"])
        row["publish_s"] = time.perf_counter() - t0

        async def delivered() -> int:
            total = 0
            for pack in packs:
                pack.send("mark")
                total += (await asyncio.to_thread(pack.wait, "mark",
                                                  30))["delivered"]
            return total

        try:
            async with asyncio.timeout(60):
                while (got := await delivered()) < want:
                    await asyncio.sleep(0.05)
        except TimeoutError:
            raise SmokeFailure(f"{label}: {got} of {want} deliveries in "
                               "60 s") from None
        busy_s = time.perf_counter() - t0
        for pack in packs:
            pack.send("finish")
        results = [await asyncio.to_thread(pack.wait, "result", 60)
                   for pack in packs]
        for k, r in enumerate(results):
            check(r["gaps"] == 0 and r["reorders"] == 0
                  and r["hard_reconnects"] == 0,
                  f"{label}: pack {k} gaps {r['gaps']}, reorders "
                  f"{r['reorders']}, hard reconnects {r['hard_reconnects']}")
            check(r["unique"] == r["clients"] * shape["per_topic"],
                  f"{label}: pack {k} unique {r['unique']} of "
                  f"{r['clients'] * shape['per_topic']}")
        for pack in packs:
            pack.close()
        row.update(deliveries=want, busy_s=busy_s,
                   delivered_msgs_per_s=want / busy_s,
                   duplicates=sum(r["delivered"] - r["unique"]
                                  for r in results),
                   gaps=0, reorders=0, hard_reconnects=0)
        status, text = await asyncio.to_thread(http_get, broker_metrics,
                                               "/metrics")
        check(status == 200, f"{label}: /metrics answered {status}")
        if io_impl:
            impls = {impl: metric_sum(text, "cdn_io_impl", impl=impl)
                     for impl in ("uring", "asyncio")}
            check(impls[io_impl] == 1 and sum(impls.values()) == 1,
                  f"{label}: /metrics reads cdn_io_impl {impls}")
        if io_impl == "uring":
            enters = metric_sum(text, "cdn_uring_chain_seconds_count",
                                stat="enter")
            check(enters > 0, f"{label}: /metrics shows no io_uring_enter "
                  "timing (cdn_uring_chain_seconds_count)")
            row["io_uring_enters"] = enters
        if io_impl and not plane:
            paths = {path: metric_sum(text, "cdn_route_batch_frames",
                                      path=path)
                     for path in ("pump", "cutthrough", "residual",
                                  "scalar")}
            row["route_frames"] = paths
            if pump == "auto":
                check(paths["pump"] > 0, f"{label}: no frame under "
                      f"cdn_route_batch_frames{{path=\"pump\"}}: {paths}")
            else:
                check(paths["pump"] == 0 and paths["cutthrough"] > 0,
                      f"{label}: frames by path {paths}")
        if plane:
            routed = metric(text, "cdn_device_messages_routed")
            check(routed >= row["broadcasts"], f"{label}: /metrics shows "
                  f"cdn_device_messages_routed {routed}")
            row["messages_routed"] = routed
            n_storm = (shape["storm_packs"] if storm_packs is None
                       else storm_packs)
            if n_storm:
                row["storm"] = await storm(endpoint,
                                           dict(shape, storm_packs=n_storm),
                                           tag)
        kids.terminate(label)
        if plane:
            done = log_fields(kids.logs["broker"], "device plane exit")
            warm = serving["launches"]
            traffic = {k: v - warm[k] for k, v in done["launches"].items()}
            check(traffic["delivery_matrix_cuda"] > 0, f"{label}: the broker "
                  "never launched delivery_matrix_cuda after its warm-up")
            check(not done["disabled"], f"{label}: the plane disabled itself")
            check(done["native_egress_steps"] == done["busy_steps"] > 0,
                  f"{label}: {done['native_egress_steps']} of "
                  f"{done['busy_steps']} busy steps egressed natively")
            row.update(warmup_launches=warm, steps=done["steps"],
                       busy_steps=done["busy_steps"],
                       delivery_matrix_cuda=traffic["delivery_matrix_cuda"],
                       ragged_delivery_cuda=traffic["ragged_delivery_cuda"])
        return row
    finally:
        if publisher is not None:
            publisher.close()
        for pack in packs:
            pack.close(1.0)
        kids.kill()


async def storm(endpoint: str, shape: dict, tag: str) -> dict:
    """Phase 16 (c)'s storm: ``storm_packs`` packs of ``storm_clients``
    clients, ``storm_cycles`` reconnect cycles each; every cycle connects
    or is shed with a typed retry-after, nothing else fails."""
    from pushcdn_tpu_torch.testing.packs import Pack

    packs = [Pack(endpoint, "storm", shape["storm_clients"],
                  200_000 + 1_000 * k, "--storm-connections",
                  str(shape["storm_cycles"]), "--hold-ms", "10",
                  log_path=os.path.join(HERE, ".build",
                                        f"{tag}-storm{k}.log"))
             for k in range(shape["storm_packs"])]
    try:
        results = [await asyncio.to_thread(p.wait, "result", 120)
                   for p in packs]
    finally:
        for p in packs:
            p.close()
    for k, r in enumerate(results):
        check(r["established"] == shape["storm_cycles"],
              f"storm pack {k}: {r['established']} of "
              f"{shape['storm_cycles']} cycles connected")
        check(r["attempts"] - r["established"] == r["sheds"],
              f"storm pack {k}: {r['attempts']} attempts, "
              f"{r['established']} connected, {r['sheds']} shed: another "
              "failure")
    return dict(packs=len(results), clients=shape["storm_clients"],
                cycles=[r["established"] for r in results],
                attempts=[r["attempts"] for r in results],
                sheds=[r["sheds"] for r in results],
                conn_p50_ms=[r["conn_p50_ms"] for r in results],
                conn_p99_ms=[r["conn_p99_ms"] for r in results],
                conns_per_s=[r["conns_per_s"] for r in results])


def phase_tooling(cluster_rows: dict, shape: dict = TOOLING,
                  device=None) -> dict:
    """Phase 16: (a) the runner on the card, (b) the consensus workload
    through each kernel, (c) client packs against a plane broker and
    against ``--shards 2``, beside phase 9's rates. One ``tooling`` line
    per run; returns each kernel's launches over the phase's traffic."""
    # the broker process holds a socket for every pack client
    need = shape["packs"] * shape["pack_clients"] + 256
    limit = raise_fd_limit()
    check(limit >= need, f"tooling: the broker needs {need} open files; "
          f"the hard limit is {limit}")
    launches = {"dense": 0, "ragged": 0}
    seconds = {}

    def add(row):
        launches["dense"] += row.get("delivery_matrix_cuda", 0)
        launches["ragged"] += row.get("ragged_delivery_cuda", 0)

    t = time.perf_counter()
    row = runner_run(shape, device)
    seconds["a"] = time.perf_counter() - t
    add(row)
    emit("tooling", **row)
    t = time.perf_counter()
    for impl in ("dense", "ragged"):
        row = asyncio.run(consensus_run(impl, shape, device))
        add(row)
        emit("tooling", **row)
    seconds["b"] = time.perf_counter() - t
    t = time.perf_counter()
    plane = asyncio.run(soak_run("tooling soak plane", shape, plane=True,
                                 device=device, storm_packs=1))
    plane["cut"] = "a storm of 1 pack, not 2, for the script's time limit"
    add(plane)
    sharded = asyncio.run(soak_run("tooling soak --shards 2", shape,
                                   plane=False, shards=2))
    seconds["c"] = time.perf_counter() - t
    beside = {}
    if "host" in cluster_rows:
        beside["phase9_host_msgs_per_s"] = \
            cluster_rows["host"]["delivered_msgs_per_s"]
    if "dense" in cluster_rows:
        beside["phase9_dense_uniform_msgs_per_s"] = \
            cluster_rows["dense"]["by_popularity"]["uniform"][
                "delivered_msgs_per_s"]
    emit("tooling", **plane, **beside)
    emit("tooling", **sharded, **beside,
         shards2_over_plane_broker=sharded["delivered_msgs_per_s"]
         / plane["delivered_msgs_per_s"])
    emit("tooling", run="phase 16 seconds", **seconds,
         total=sum(seconds.values()))
    check(launches["dense"] > 0, "tooling: delivery_matrix_cuda never "
          "launched on phase 16's traffic")
    check(launches["ragged"] > 0, "tooling: ragged_delivery_cuda never "
          "launched on phase 16's traffic")
    return launches, plane


# ---------------------------------------------------------------------------
# 17. the host I/O engines under the planes
# ---------------------------------------------------------------------------

QUIC_RUN = dict(clients=256, topics=8, per_topic=64, payload=512, waves=8,
                wave_gap_s=0.05, connect_concurrency=64)


def uring_probe() -> str:
    """The port's io_uring probe on this host: ``allowed`` or ``denied:
    <errno name>``. The shim must build, and only a kernel that answers
    ENOSYS or EPERM may deny it; anything else fails the run."""
    import errno
    import platform

    from pushcdn_tpu_torch import native
    from pushcdn_tpu_torch.native import uring as nuring
    check(nuring.loaded(), "io: the io_uring shim did not build: "
          f"{native.build_errors().get('io_uring')}")
    cap = nuring.probe()
    if cap < 0:
        name = nuring.probe_errname()
        check(-cap in (errno.ENOSYS, errno.EPERM),
              f"io: the io_uring probe failed with {name} ({cap})")
        verdict = f"denied: {name}"
    else:
        check(cap & 1, f"io: probe bitmask {cap} lacks the usable bit")
        verdict = "allowed"
    emit("io", io_uring=verdict, probe=cap, kernel=platform.release(),
         zerocopy=nuring.zerocopy_supported())
    return verdict


def quic_payload(seq: int, size: int) -> bytes:
    """A sequenced broadcast that carries its publish time: a 4-byte
    big-endian sequence number, the publisher's ``perf_counter_ns``, then
    padding to ``size``."""
    head = seq.to_bytes(4, "big") + time.perf_counter_ns().to_bytes(8, "big")
    return head + b"\x00" * max(0, size - len(head))


async def quic_run(shape: dict = QUIC_RUN, device=None) -> dict:
    """Phase 17 (c): the ragged plane with its users on QUIC."""
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.message import Broadcast, Direct
    from pushcdn_tpu_torch.proto.transport import Quic

    label = "io quic ragged"
    tag = f"io-quic-{os.getpid()}"
    db = os.path.join(HERE, ".build", f"{tag}.sqlite")
    for suffix in ("", "-wal", "-shm"):
        if os.path.exists(db + suffix):
            os.remove(db + suffix)
    C, T, per = shape["clients"], shape["topics"], shape["per_topic"]
    pub, priv, marshal, marshal_metrics = ports = free_ports(4)
    broker_metrics = metrics_port(0, ports)
    kids = Children(tag)
    clients = []
    publisher = None
    drains = []
    row = dict(run="quic", broker="--device-plane", transport="quic",
               delivery_impl="ragged", clients=C, topics=T,
               broadcasts=T * per, payload_bytes=shape["payload"])
    try:
        kids.spawn("broker", "--discovery-endpoint", db,
                   "--public-advertise-endpoint", f"127.0.0.1:{pub}",
                   "--public-bind-endpoint", f"127.0.0.1:{pub}",
                   "--private-advertise-endpoint", f"127.0.0.1:{priv}",
                   "--private-bind-endpoint", f"127.0.0.1:{priv}",
                   "--metrics-bind-endpoint", f"127.0.0.1:{broker_metrics}",
                   "--user-transport", "quic", "--broker-transport", "tcp",
                   "--device-plane",
                   *(["--device", str(device)] if device else []),
                   env={"PUSHCDN_DELIVERY_IMPL": "ragged"})
        kids.spawn("marshal", "--discovery-endpoint", db,
                   "--bind-endpoint", f"127.0.0.1:{marshal}",
                   "--metrics-bind-endpoint", f"127.0.0.1:{marshal_metrics}",
                   "--user-transport", "quic")
        serving = await kids.wait_for_line("broker", "broker serving", label,
                                           timeout=180)
        try:
            async with asyncio.timeout(60):   # the broker registered
                while (await asyncio.to_thread(http_get, marshal_metrics,
                                               "/readyz") or (0,))[0] != 200:
                    kids.check_alive(label)
                    await asyncio.sleep(0.1)
        except TimeoutError:
            raise SmokeFailure(f"{label}: the marshal was not ready in 60 s:"
                               f"\n{log_tail(kids.logs['marshal'])}") from None
        endpoint = f"127.0.0.1:{marshal}"
        pairs = [DEFAULT_SCHEME.generate_keypair(seed=300_000 + c)
                 for c in range(C)]
        clients = [Client(ClientConfig(
            marshal_endpoint=endpoint, keypair=kp, protocol=Quic,
            subscribed_topics={c % T})) for c, kp in enumerate(pairs)]
        gate = asyncio.Semaphore(shape["connect_concurrency"])

        async def connect(client):
            async with gate:
                await client.ensure_initialized()

        t0 = time.perf_counter()
        try:
            async with asyncio.timeout(120):
                await asyncio.gather(*(connect(c) for c in clients))
        except TimeoutError:
            raise SmokeFailure(f"{label}: the QUIC clients did not all "
                               "connect in 120 s") from None
        row["connect_s"] = time.perf_counter() - t0
        publisher = Client(ClientConfig(
            marshal_endpoint=endpoint,
            keypair=DEFAULT_SCHEME.generate_keypair(seed=399_999),
            protocol=Quic, subscribed_topics=set()))
        async with asyncio.timeout(60):
            await publisher.ensure_initialized()
        kids.check_alive(label)

        seqs = [[] for _ in range(C)]
        lat_ns = []
        directs = [0] * C
        done_at = [0.0]
        want = C * per

        async def drain(c):
            client = clients[c]
            while True:
                for m in await client.receive_messages():
                    now = time.perf_counter_ns()
                    body = bytes(m.message)
                    if isinstance(m, Broadcast):
                        seqs[c].append(int.from_bytes(body[:4], "big"))
                        lat_ns.append(now - int.from_bytes(body[4:12], "big"))
                        if len(lat_ns) == want:
                            done_at[0] = time.perf_counter()
                    elif isinstance(m, Direct) and body == b"barrier":
                        directs[c] += 1

        drains = [asyncio.create_task(drain(c)) for c in range(C)]
        step = per // shape["waves"]
        t0 = time.perf_counter()
        for w in range(shape["waves"]):
            if w:
                await asyncio.sleep(shape["wave_gap_s"])
            for seq in range(w * step, (w + 1) * step):
                for t in range(T):
                    await publisher.send_broadcast_message(
                        [t], quic_payload(seq, shape["payload"]))
        try:
            async with asyncio.timeout(60):
                while len(lat_ns) < want:
                    kids.check_alive(label)
                    await asyncio.sleep(0.02)
        except TimeoutError:
            raise SmokeFailure(f"{label}: {len(lat_ns)} of {want} "
                               "deliveries in 60 s") from None
        busy_s = done_at[0] - t0
        await asyncio.gather(*(
            client.send_direct_message(kp.public_key, b"barrier")
            for client, kp in zip(clients, pairs)))
        try:
            async with asyncio.timeout(30):
                while sum(directs) < C:
                    await asyncio.sleep(0.02)
        except TimeoutError:
            raise SmokeFailure(f"{label}: {sum(directs)} of {C} barrier "
                               "directs came back in 30 s") from None
        for c in range(C):
            check(seqs[c] == list(range(per)),
                  f"{label}: client {c} got {len(seqs[c])} broadcasts, "
                  f"in order: {seqs[c] == sorted(seqs[c])}")
            check(directs[c] == 1, f"{label}: client {c} got "
                  f"{directs[c]} barrier directs")
        status, text = await asyncio.to_thread(http_get, broker_metrics,
                                               "/metrics")
        check(status == 200, f"{label}: /metrics answered {status}")
        routed = metric(text, "cdn_device_messages_routed")
        check(routed >= row["broadcasts"], f"{label}: /metrics shows "
              f"cdn_device_messages_routed {routed}")
        for t in drains:
            t.cancel()
        for client in clients:
            client.close()
        publisher.close()
        kids.terminate(label)
        done = log_fields(kids.logs["broker"], "device plane exit")
        warm = serving["launches"]
        traffic = {k: v - warm[k] for k, v in done["launches"].items()}
        check(traffic["ragged_delivery_cuda"] > 0, f"{label}: the broker "
              "never launched ragged_delivery_cuda after its warm-up")
        check(not done["disabled"], f"{label}: the plane disabled itself")
        row.update(deliveries=want, busy_s=busy_s,
                   delivered_msgs_per_s=want / busy_s,
                   **percentiles_ms(lat_ns), messages_routed=routed,
                   warmup_launches=warm, steps=done["steps"],
                   busy_steps=done["busy_steps"],
                   delivery_matrix_cuda=traffic["delivery_matrix_cuda"],
                   ragged_delivery_cuda=traffic["ragged_delivery_cuda"])
        return row
    finally:
        for t in drains:
            t.cancel()
        if publisher is not None:
            publisher.close()
        for client in clients:
            client.close()
        kids.kill()


def phase_io(plane_row: dict, shape: dict = TOOLING,
             quic: dict = QUIC_RUN, device=None) -> dict:
    """Phase 17: the io_uring probe, then (a) the dense plane over
    io_uring, (b) a plane-less broker over io_uring with the fused pump
    and over asyncio, (c) the ragged plane over QUIC; ``plane_row`` is
    phase 16 (c)'s asyncio plane run, reported beside (a). One ``io`` line
    per run; returns each kernel's launches over the phase's traffic."""
    launches = {"dense": 0, "ragged": 0}
    seconds = {}
    verdict = uring_probe()
    allowed = verdict == "allowed"
    rate = {}
    t = time.perf_counter()
    if allowed:
        a = asyncio.run(soak_run("io soak plane uring", shape, plane=True,
                                 device=device, io_impl="uring",
                                 storm_packs=0))
        launches["dense"] += a["delivery_matrix_cuda"]
        rate["plane_uring"] = a["delivered_msgs_per_s"]
        emit("io", **a, phase16_plane_asyncio_msgs_per_s=plane_row[
            "delivered_msgs_per_s"], uring_over_phase16_asyncio=a[
            "delivered_msgs_per_s"] / plane_row["delivered_msgs_per_s"])
    seconds["a"] = time.perf_counter() - t
    t = time.perf_counter()
    if allowed:
        b = asyncio.run(soak_run("io soak host uring pump", shape,
                                 plane=False, io_impl="uring", pump="auto"))
        rate["host_uring_pump"] = b["delivered_msgs_per_s"]
        emit("io", **b)
    b = asyncio.run(soak_run("io soak host asyncio", shape, plane=False,
                             io_impl="asyncio"))
    rate["host_asyncio"] = b["delivered_msgs_per_s"]
    emit("io", **b)
    seconds["b"] = time.perf_counter() - t
    t = time.perf_counter()
    c = asyncio.run(quic_run(quic, device))
    launches["ragged"] += c["ragged_delivery_cuda"]
    launches["dense"] += c["delivery_matrix_cuda"]
    emit("io", **c)
    seconds["c"] = time.perf_counter() - t
    # phase 16 (c)'s plane broker (asyncio) beside the plane-less one
    ratios = {"phase16_plane_asyncio_over_host_asyncio":
              plane_row["delivered_msgs_per_s"] / rate["host_asyncio"]}
    if "plane_uring" in rate:
        ratios.update({f"plane_uring_over_{k}": rate["plane_uring"] / v
                       for k, v in rate.items() if k != "plane_uring"})
    emit("io", run="phase 17", io_uring=verdict, msgs_per_s=rate, **ratios,
         seconds=seconds, total_s=sum(seconds.values()))
    if allowed:
        check(launches["dense"] > 0, "io: delivery_matrix_cuda never "
              "launched on phase 17's traffic")
    check(launches["ragged"] > 0, "io: ragged_delivery_cuda never launched "
          "on phase 17's traffic")
    return launches


# ---------------------------------------------------------------------------
# 18. the production run definition's shape: BLS keys on both links, broker
# links on TCP, users on TCP+TLS, Redis discovery, dense planes
# ---------------------------------------------------------------------------

# (a): phase 15 (c)'s users (256 TCP+TLS clients, 3 uniform topics of 256,
# 16 publishers, one burst of phase 8's mix) over two plane brokers; the
# marshal's line-table cache holds every user's key (its default of 128
# would evict them all between the two rounds of connects); (b): phase 16
# (b)'s consensus cluster, 2 views
PROD = dict(CLUSTER, users=256, publishers=16, auth_concurrency=64,
            pk_cache=1024, nodes=1024, views=2, view_timeout_s=30.0,
            consensus_slots=1024)
REDIS_SERVERS = ("redis-server", "keydb-server")


def redis_probe() -> tuple:
    """``(server binary or None, verdict)``: Redis discovery runs where the
    ``redis`` package and a ``redis-server`` or ``keydb-server`` on
    ``PATH`` both exist; the verdict names what is missing otherwise."""
    import shutil
    missing = []
    try:
        import redis.asyncio  # noqa: F401
    except ImportError:
        missing.append("no redis package")
    server = next((shutil.which(n) for n in REDIS_SERVERS if shutil.which(n)),
                  None)
    if server is None:
        missing.append("no redis-server or keydb-server on PATH")
    return (None, "absent: " + ", ".join(missing)) if missing \
        else (server, "present")


class RedisServer:
    """A throwaway server on a free loopback port, no persistence, started
    as ``tests/test_redis_discovery.py``'s ``real_redis`` fixture starts
    one; ``url`` once it answers PING."""

    def __init__(self, binary: str):
        import socket
        self.port = free_ports(1)[0]
        self.proc = subprocess.Popen(
            [binary, "--port", str(self.port), "--save", "",
             "--appendonly", "no"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                with socket.create_connection(("127.0.0.1", self.port),
                                              timeout=1) as c:
                    c.sendall(b"PING\r\n")
                    if c.recv(7).startswith(b"+PONG"):
                        break
            except OSError:
                pass
            time.sleep(0.05)
        else:
            self.stop()
            raise SmokeFailure(f"{binary} never answered PING")
        self.url = f"redis://127.0.0.1:{self.port}"

    def stop(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def connect_ms(seconds: list) -> dict:
    ms = np.asarray(seconds) * 1e3
    return dict(p50=float(np.percentile(ms, 50)),
                p99=float(np.percentile(ms, 99)))


async def prod_binaries_run(shape: dict = PROD, seed: int = 180,
                            device=None) -> dict:
    """Phase 18 (a): a marshal and brokers A and B, all ``--scheme
    bls-bn254``, each broker with a dense plane, broker links on TCP and
    users on TCP+TLS, discovery on Redis where the probe found it and on a
    fresh SQLite file otherwise. 256 clients with seeded BLS keys
    authenticate (64 at a time) and the marshal places them; 16 publish one
    uniform burst of phase 8's mix, which every client must receive as the
    oracle says, some of it across the BLS-authenticated A-B link; every
    client then reconnects once. Beside it a plane-less broker given a
    ``redis://`` endpoint must exit non-zero naming the missing package,
    where it is missing. Every check, then its numbers."""
    from pushcdn_tpu_torch.bin.common import spawn_binary
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.crypto.signature import BlsBn254Scheme
    from pushcdn_tpu_torch.proto.message import Broadcast, Direct
    from pushcdn_tpu_torch.proto.transport import TcpTls
    from pushcdn_tpu_torch.proto.util import mnemonic

    label = "prod binaries"
    U, P = shape["users"], shape["publishers"]
    t_run = time.perf_counter()
    pairs = [BlsBn254Scheme.generate_keypair(seed=seed * 1_000_000 + u)
             for u in range(U)]
    keygen_s = time.perf_counter() - t_run
    sc = BrokerScenario("uniform", seed, shape,
                        keys=[k.public_key for k in pairs])
    burst = sc.burst()
    server, redis_verdict = redis_probe()
    tag = f"prod-{os.getpid()}"
    db = os.path.join(HERE, ".build", f"{tag}.sqlite")
    for suffix in ("", "-wal", "-shm"):
        if os.path.exists(db + suffix):
            os.remove(db + suffix)
    redis = RedisServer(server) if server else None
    discovery = redis.url if redis else db
    (a_pub, a_priv, b_pub, b_priv, marshal, m_metrics, a_metrics, b_metrics,
     r_pub, r_priv) = free_ports(10)
    scheme = ("--scheme", "bls-bn254")
    common = ("--discovery-endpoint", discovery, "--user-transport",
              "tcp+tls", "--broker-transport", "tcp", "--device-plane",
              "--heartbeat-interval", "0.5", *scheme,
              *(["--device", str(device)] if device else []))
    env = {"PUSHCDN_DELIVERY_IMPL": "dense"}

    def endpoints(pub, priv, metrics_port=None):
        return ("--public-advertise-endpoint", f"127.0.0.1:{pub}",
                "--public-bind-endpoint", f"127.0.0.1:{pub}",
                "--private-advertise-endpoint", f"127.0.0.1:{priv}",
                "--private-bind-endpoint", f"127.0.0.1:{priv}",
                *(("--metrics-bind-endpoint", f"127.0.0.1:{metrics_port}")
                  if metrics_port else ()))
    kids = Children(tag)
    refusal = None
    clients, drains = [], []
    try:
        kids.spawn("a", *common, *endpoints(a_pub, a_priv, a_metrics),
                   env=env, binary="broker")
        kids.spawn("b", *common, *endpoints(b_pub, b_priv, b_metrics),
                   env=env, binary="broker")
        kids.spawn("marshal", "--discovery-endpoint", discovery,
                   "--bind-endpoint", f"127.0.0.1:{marshal}",
                   "--metrics-bind-endpoint", f"127.0.0.1:{m_metrics}",
                   "--user-transport", "tcp+tls", *scheme,
                   env={"PUSHCDN_BLS_PK_CACHE": str(shape["pk_cache"])})
        if redis is None:
            refusal_log = os.path.join(HERE, ".build", f"{tag}-refusal.log")
            refusal = spawn_binary(
                "broker", "--discovery-endpoint", "redis://127.0.0.1:1",
                *endpoints(r_pub, r_priv), log_path=refusal_log)
        serving = {}
        for name in ("a", "b"):
            serving[name] = await kids.wait_for_line(
                name, "broker serving", label, timeout=120)

        async def topology(port):
            reply = await asyncio.to_thread(http_get, port,
                                            "/debug/topology")
            return json.loads(reply[1]) if reply and reply[0] == 200 \
                else None

        async def wait_for(what: str, pred, timeout: float = 60):
            try:
                async with asyncio.timeout(timeout):
                    while not await pred():
                        kids.check_alive(label)
                        await asyncio.sleep(0.1)
            except TimeoutError:
                raise SmokeFailure(f"{label}: {what} within {timeout} s") \
                    from None

        async def linked():
            topos = [await topology(p) for p in (a_metrics, b_metrics)]
            return all(t and t["num_brokers"] == 1 for t in topos)
        await wait_for("no A-B link", linked)

        async def marshal_ready():
            reply = await asyncio.to_thread(http_get, m_metrics, "/readyz")
            return reply is not None and reply[0] == 200
        await wait_for("the marshal not ready", marshal_ready)

        def make_clients():
            return [Client(ClientConfig(
                marshal_endpoint=f"127.0.0.1:{marshal}", keypair=kp,
                protocol=TcpTls, scheme=BlsBn254Scheme,
                subscribed_topics=set(topics)))
                for kp, topics in zip(pairs, sc.topics)]
        gate = asyncio.Semaphore(shape["auth_concurrency"])

        async def connect_all(batch) -> tuple:
            took = [0.0] * len(batch)

            async def one(i, client):
                async with gate:
                    t = time.perf_counter()
                    await client.ensure_initialized()
                    took[i] = time.perf_counter() - t
            t = time.perf_counter()
            async with asyncio.timeout(180):
                await asyncio.gather(*(one(i, c)
                                       for i, c in enumerate(batch)))
            return time.perf_counter() - t, took

        clients = make_clients()
        cold_s, cold = await connect_all(clients)

        # where the marshal placed each user: the brokers' topologies
        names = {mnemonic(k.public_key): uid for uid, k in enumerate(pairs)}
        check(len(names) == U, f"{label}: user mnemonics collide")
        home = np.full(U, -1, np.int64)

        async def placed():
            for b, port in enumerate((a_metrics, b_metrics)):
                topo = await topology(port)
                for user in (topo or {}).get("users", ()):
                    home[names[user["key"]]] = b
            return (home >= 0).all()
        await wait_for("users missing from the topologies", placed)
        per_broker = [int((home == b).sum()) for b in (0, 1)]
        check(min(per_broker) > 0, f"{label}: users per broker "
              f"{per_broker}: the marshal placed every user on one broker")

        # each broker must hear the other's users' topics over the link
        want_remote = [len({t for uid in np.flatnonzero(home == 1 - b)
                            for t in sc.topics[uid]}) for b in (0, 1)]

        async def interest():
            topos = [await topology(p) for p in (a_metrics, b_metrics)]
            return all(t and t["interest"]["broker_topics"] >= want_remote[b]
                       for b, t in enumerate(topos))
        await wait_for("the brokers' interest not synced", interest)

        got = [[] for _ in range(U)]
        got_bytes = np.zeros(U, np.int64)
        seen = [0, 0]

        async def drain(uid, client):
            while True:
                messages = await client.receive_messages()
                now = time.perf_counter_ns()
                for m in messages:
                    pub_, seq, _ = TAIL.unpack_from(
                        m.message, len(m.message) - TAIL.size)
                    got[uid].append((pub_ * 2 << 32) | seq)
                    got_bytes[uid] += len(m.message)
                    seen[0] += 1
                seen[1] = now
        drains = [asyncio.create_task(drain(uid, c))
                  for uid, c in enumerate(clients)]

        async def one_publisher(pub_):
            client = clients[pub_]
            for direct, target, head in burst.messages[pub_]:
                body = head + struct.pack("<q", time.perf_counter_ns())
                await client.send_message(
                    Direct(target, body) if direct
                    else Broadcast(target, body))
        t0 = time.perf_counter_ns()
        await asyncio.gather(*(one_publisher(p) for p in range(P)))
        try:
            async with asyncio.timeout(120):
                while seen[0] < len(burst.codes):
                    kids.check_alive(label)
                    await asyncio.sleep(0.005)
        except TimeoutError:
            raise SmokeFailure(f"{label}: {seen[0]} of {len(burst.codes)} "
                               "frames arrived") from None
        busy_s = (seen[1] - t0) / 1e9
        await asyncio.sleep(0.3)
        for t in drains:
            t.cancel()
        await asyncio.gather(*drains, return_exceptions=True)
        scraped = {}
        for name, port in (("marshal", m_metrics), ("a", a_metrics),
                           ("b", b_metrics)):
            reply = await asyncio.to_thread(http_get, port, "/metrics")
            check(reply is not None and reply[0] == 200,
                  f"{label}: the {name}'s /metrics did not answer")
            scraped[name] = reply[1]

        # every client reconnects once, through the marshal's warm cache
        for c in clients:
            c.close()
        clients = make_clients()
        warm_s, warm = await connect_all(clients)
        reply = await asyncio.to_thread(http_get, m_metrics, "/metrics")
        check(reply is not None and reply[0] == 200,
              f"{label}: the marshal's /metrics did not answer")
        warm_text = reply[1]
        for c in clients:
            c.close()
        clients = []
        kids.terminate(label)
        exits = {n: log_fields(kids.logs[n], "device plane exit")
                 for n in ("a", "b")}
        if refusal is not None:
            try:
                rc = await asyncio.to_thread(refusal.wait, 60)
            except subprocess.TimeoutExpired:
                rc = None
            refusal_out = log_tail(refusal_log)
    finally:
        for t in drains:
            t.cancel()
        for c in clients:
            c.close()
        kids.kill()
        if refusal is not None and refusal.poll() is None:
            refusal.kill()
            refusal.wait()
        if redis is not None:
            redis.stop()
        for suffix in ("", "-wal", "-shm"):
            if os.path.exists(db + suffix):
                os.remove(db + suffix)

    lane_bit = np.int64(1) << 32
    want = np.sort(burst.codes & ~lane_bit)
    have = np.sort(np.concatenate(
        [np.empty(0, np.int64)]
        + [(np.int64(uid) << 40) | np.asarray(c, np.int64)
           for uid, c in enumerate(got)]))
    check(have.shape == want.shape and (have == want).all(),
          f"{label}: the {len(have)} deliveries differ from the oracle's "
          f"{len(want)}")
    check(np.array_equal(got_bytes, burst.payload_bytes),
          f"{label}: received payload bytes differ from the oracle's")
    receiver = burst.codes >> 40
    publisher = (burst.codes >> 33) & 0x7F
    crossed = int((home[receiver] != home[publisher]).sum())
    check(crossed > 0, f"{label}: no delivery crossed the A-B link")
    m, mw = scraped["marshal"], warm_text
    verify_s = metric_sum(mw, "cdn_native_seconds", kernel="bls_verify")
    cache = {stat: (metric_sum(m, "cdn_bls_pk_cache", stat=stat),
                    metric_sum(mw, "cdn_bls_pk_cache", stat=stat))
             for stat in ("hits", "misses", "evictions", "entries")}
    check(metric_sum(m, "cdn_native_seconds", kernel="bls_verify") > 0,
          f"{label}: the marshal's cdn_native_seconds{{kernel=\"bls_verify\"}}"
          " is 0")
    check(cache["misses"][0] >= U, f"{label}: the marshal's line-table "
          f"misses {cache['misses'][0]} after {U} cold connects")
    check(cache["hits"][1] >= U, f"{label}: the marshal's line-table hits "
          f"{cache['hits'][1]} after {U} reconnects")
    routed = {n: metric(scraped[n], "cdn_device_messages_routed")
              for n in ("a", "b")}
    check(all(v > 0 for v in routed.values()),
          f"{label}: cdn_device_messages_routed {routed}")
    traffic = {}
    for name in ("a", "b"):
        check(exits[name] is not None, f"{label}: broker {name} logged no "
              "exit line")
        traffic[name] = exits[name]["launches"]["delivery_matrix_cuda"] \
            - serving[name]["launches"]["delivery_matrix_cuda"]
        check(traffic[name] > 0, f"{label}: broker {name} never launched "
              "delivery_matrix_cuda after its warm-up")
    refused = None
    if refusal is not None:
        needle = "the 'redis' package is not available"
        check(rc not in (0, None) and needle in refusal_out
              and "not ported" not in refusal_out,
              f"{label}: a broker given redis:// exited {rc}:\n"
              f"{refusal_out[-3000:]}")
        refused = dict(exit_code=rc, message=needle)
    return dict(
        run="binaries", scheme="bls-bn254", discovery="redis" if redis
        else "embedded sqlite", redis=redis_verdict,
        transports={"users": "tcp+tls", "brokers": "tcp"}, clients=U,
        users_per_broker=per_broker, publishers=P, frames=shape["frames"],
        deliveries=len(want), crossed_the_link=crossed, matches_oracle=True,
        delivered_msgs_per_s=len(want) / busy_s, busy_s=busy_s,
        keygen_s=keygen_s, connect_s={"cold": cold_s, "warm": warm_s},
        connect_ms={"cold": connect_ms(cold), "warm": connect_ms(warm)},
        marshal_bls_verify_s=verify_s,
        marshal_pk_cache={k: {"after_cold": v[0], "after_warm": v[1]}
                          for k, v in cache.items()},
        messages_routed=routed, redis_refusal=refused,
        delivery_matrix_cuda=sum(traffic.values()),
        traffic_launches=traffic, run_s=time.perf_counter() - t_run)


class _Connected:
    """A ``Cluster`` whose ``client(seed=...)`` hands out the clients this
    phase already connected, so that the consensus driver runs on them."""

    def __init__(self, cluster, clients: dict):
        self._cluster = cluster
        self._clients = clients

    def client(self, seed: int, topics=(), protocol=None):
        return self._clients[seed]

    def __getattr__(self, name):
        return getattr(self._cluster, name)


async def prod_consensus_run(shape: dict = PROD, device=None) -> dict:
    """Phase 18 (b): ``production_run_def()`` must pick the BLS scheme on
    this host; then phase 16 (b)'s consensus cluster with BLS keys: two
    brokers with 1024-slot dense planes (no bypass), the 1024 nodes
    connected concurrently, half onto each broker, beside one node whose
    signature is forged; the marshal's batching verifier must batch, the
    forged node be refused and every other admitted; then the views. Every
    check, then its numbers."""
    from pushcdn_tpu_torch.broker.device_plane import DevicePlaneConfig
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.ops import delivery_kernel as dk
    from pushcdn_tpu_torch.ops import ragged_delivery as rd
    from pushcdn_tpu_torch.proto import trace as trace_mod
    from pushcdn_tpu_torch.proto.crypto.signature import (
        BlsBn254Scheme,
        KeyPair,
    )
    from pushcdn_tpu_torch.proto.def_ import production_run_def
    from pushcdn_tpu_torch.testing import Cluster
    from pushcdn_tpu_torch.testing.consensus import (
        ConsensusConfig,
        percentile,
        run_consensus,
    )

    label = "prod consensus"
    prod = production_run_def()
    check(prod.user_def.scheme is BlsBn254Scheme
          and prod.broker_def.scheme is BlsBn254Scheme,
          f"{label}: production_run_def() picked {prod.user_def.scheme}: "
          "the BLS library did not build here")
    n, views = shape["nodes"], shape["views"]
    cfg = ConsensusConfig(num_nodes=n, num_views=views,
                          view_timeout_s=shape["view_timeout_s"],
                          trace=False)
    trace_mod.set_log_path(None)
    t0 = time.perf_counter()
    cluster = await Cluster(
        num_brokers=2, scheme=BlsBn254Scheme, device=device,
        device_plane=DevicePlaneConfig(
            num_user_slots=shape["consensus_slots"], bypass_max_items=0,
            delivery_impl="dense")).start()
    clients = {}
    try:
        start_s = time.perf_counter() - t0
        t = time.perf_counter()
        for i in range(n):
            c = cluster.client(seed=cfg.client_seed_base + i,
                               topics=[cfg.topic],
                               protocol=cfg.node_protocol(i))
            c._sampler.every = 0
            clients[cfg.client_seed_base + i] = c
        keygen_s = time.perf_counter() - t
        honest = BlsBn254Scheme.generate_keypair(seed=cfg.client_seed_base
                                                 + n)
        thief = BlsBn254Scheme.generate_keypair(seed=cfg.client_seed_base
                                                + n + 1)
        forged = Client(ClientConfig(
            marshal_endpoint=cluster.marshal_endpoint,
            keypair=KeyPair(public_key=honest.public_key,
                            private_key=thief.private_key),
            protocol=cfg.node_protocol(0), scheme=BlsBn254Scheme,
            subscribed_topics={cfg.topic}))

        async def forged_attempt() -> bool:
            try:
                await asyncio.wait_for(forged._connect_once(), 30)
            except Exception:
                return True
            return False

        nodes = list(clients.values())
        t = time.perf_counter()
        refused = None
        for b in range(2):
            await cluster.place_on(b)
            async with asyncio.timeout(180):
                results = await asyncio.gather(
                    *(c.ensure_initialized() for c in nodes[b::2]),
                    *([forged_attempt()] if b == 0 else []))
            if b == 0:
                refused = results[-1]
        connect_s = time.perf_counter() - t
        bv = cluster.marshal.batch_verifier
        batching = dict(batches=bv.batches, batched_items=bv.batched_items,
                        singles=bv.singles, pk_cache=bv.cache_stats())
        users = [b.connections.num_users for b in cluster.brokers]
        before = (dk.LAUNCHES, rd.LAUNCHES)
        t = time.perf_counter()
        run = await run_consensus(_Connected(cluster, clients), cfg,
                                  drain_s=10.0)
        run_s = time.perf_counter() - t
        launches = (dk.LAUNCHES - before[0], rd.LAUNCHES - before[1])
        planes = [b.device_plane for b in cluster.brokers]
    finally:
        for c in clients.values():
            c.close()
        await cluster.stop()
    check(refused is True, f"{label}: the forged node was admitted")
    check(users == [n // 2, n // 2], f"{label}: nodes per broker {users}")
    check(batching["batches"] > 0
          and batching["batched_items"] > batching["batches"],
          f"{label}: the marshal's batching verifier read {batching}")
    check(run.completed == views and run.timeouts == 0,
          f"{label}: {run.completed} of {views} views completed, "
          f"{run.timeouts} timed out")
    check(len(run.proposal_delivery_s) == views * n,
          f"{label}: {len(run.proposal_delivery_s)} of {views * n} "
          "proposal deliveries")
    quorum = cfg.effective_quorum()
    check(quorum == 2 * n // 3 + 1 and all(v.votes >= quorum
                                           for v in run.views),
          f"{label}: a leader short of a quorum of {quorum}: "
          f"{[v.votes for v in run.views]}")
    check(all(p.messages_routed > 0 and not p.disabled
              and p.delivery_impl == "dense" for p in planes),
          f"{label}: planes routed {[p.messages_routed for p in planes]}")
    check(launches[0] > 0, f"{label}: the dense kernel never launched")

    def ms(samples, q):
        return percentile(sorted(samples), q) * 1e3

    done = sorted(v.completion_s for v in run.views)
    return dict(
        run="consensus", scheme="bls-bn254", impl="dense", nodes=n,
        views=views, quorum=quorum, brokers=2, nodes_per_broker=users,
        bypass_max_items=0, forged_refused=refused,
        batch_verifier=batching,
        mean_batch=batching["batched_items"] / batching["batches"],
        start_s=start_s, keygen_s=keygen_s, connect_s=connect_s,
        run_s=run_s, completed=run.completed, timeouts=run.timeouts,
        votes_at_completion=[v.votes for v in run.views],
        proposal_deliveries=len(run.proposal_delivery_s),
        vote_deliveries=len(run.vote_delivery_s),
        view_completion_ms_p50=ms(done, 0.50),
        view_completion_ms_p99=ms(done, 0.99),
        messages_routed=[p.messages_routed for p in planes],
        delivery_matrix_cuda=launches[0], ragged_delivery_cuda=launches[1])


def phase_prod(shape: dict = PROD, device=None) -> int:
    """Phase 18: (a) the production shape as processes, (b) in process.
    One ``prod`` line per run; returns the dense kernel's launches over the
    phase's traffic."""
    seconds = {}
    t = time.perf_counter()
    a = asyncio.run(prod_binaries_run(shape, device=device))
    emit("prod", **a)
    seconds["a"] = time.perf_counter() - t
    t = time.perf_counter()
    b = asyncio.run(prod_consensus_run(shape, device))
    emit("prod", **b)
    seconds["b"] = time.perf_counter() - t
    emit("prod", run="phase 18 seconds", **seconds,
         total=sum(seconds.values()))
    return a["delivery_matrix_cuda"] + b["delivery_matrix_cuda"]


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def nvidia_smi(query: str, *fmt: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=" + ",".join(("csv", "noheader") + fmt)],
                       capture_output=True, text=True, timeout=60)
    check(r.returncode == 0 and r.stdout.strip(), "nvidia-smi failed")
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    raise_fd_limit()   # before any child process: they inherit it
    sys.path.insert(0, HERE)
    try:
        from pushcdn_tpu_torch.ops import _build
        from pushcdn_tpu_torch.ops import delivery_kernel as dk
        from pushcdn_tpu_torch.ops import ragged_delivery as rd
        from pushcdn_tpu_torch.testing.accel_probe import require_accelerator
    except ImportError as e:
        print(f"chip_smoke: the pushcdn_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    # a wedged card hangs the first CUDA call of a process: probe it in a
    # child first, and end with the probe's reason instead of a hang
    try:
        require_accelerator("chip_smoke")
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # seconds per phase, reported on a line of their own
    laps = {}
    t_lap = [time.perf_counter()]

    def lap(phase: int) -> None:
        now = time.perf_counter()
        laps[phase] = laps.get(phase, 0.0) + now - t_lap[0]
        t_lap[0] = now

    # 1. device
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm", "nounits"))
    peak_ops = int32_peak(sms, clock_mhz * 1e6)
    emit("device", name=kind, count=torch.cuda.device_count(),
         nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], sms=sms, max_sm_clock_mhz=clock_mhz,
         int32_ops_per_s=peak_ops, bytes_per_s=PEAK_BYTES_PER_S)

    lap(1)
    # 2. build (one nvcc per source, started together; the native host
    # routines and the BLS library with g++ beside them)
    from pushcdn_tpu_torch import native
    from pushcdn_tpu_torch.native import bls
    t0 = time.perf_counter()

    def build_native():
        t = time.perf_counter()
        return native.build(), time.perf_counter() - t

    def build_bls():
        t = time.perf_counter()
        return bls.available(), time.perf_counter() - t

    with ThreadPoolExecutor(2) as pool:
        host = pool.submit(build_native)
        pairing = pool.submit(build_bls)
        libs = _build.build()
        kernels_s = time.perf_counter() - t0
        try:
            host_libs, native_s = host.result()
        except RuntimeError as e:
            raise SmokeFailure(str(e)) from None
        bls_ok, bls_s = pairing.result()
    check(bls_ok, f"the BLS library failed to build: {native.build_errors()}")
    check(bls.self_test() == 0, "the BLS library's self-test failed")
    emit("build", seconds=time.perf_counter() - t0, kernels_seconds=kernels_s,
         native_seconds=native_s, bls_seconds=bls_s,
         libraries=[os.path.relpath(p, HERE) for p in libs],
         native_libraries=[os.path.relpath(p, HERE)
                           for p in host_libs.values()],
         bls_library=os.path.relpath(bls.loaded_path(), HERE))

    lap(2)
    # 3. kernels vs plain
    errs = phase_kernels_vs_plain(device)

    lap(3)
    # 4. the slice at full size; the launch counts are this phase's
    dk.LAUNCHES = 0
    rd.LAUNCHES = 0
    ticks = {}
    per_impl = {}
    steps = {}
    captured = {}
    for impl in ("dense", "ragged"):
        before = (dk.LAUNCHES, rd.LAUNCHES)
        ticks[impl] = 0
        for seed, popularity in enumerate(("uniform", "zipf")):
            cap = Capture()
            rows, plane = run_slice(impl, popularity, device, seed, cap)
            ticks[impl] += len(rows)
            captured[(impl, popularity)] = cap.calls
            steps[(impl, popularity)] = rows
            emit("slice", impl=impl, popularity=popularity,
                 users=SLICE["users"], topics=SLICE["topics"],
                 frames_per_tick=SLICE["frames"], ticks=len(rows),
                 pairs_per_tick=[r[-1] for r in rows],
                 matches_oracle=True, steps=plane.steps,
                 ragged_steps=plane.ragged_steps,
                 ragged_fallbacks=plane.ragged_fallbacks)
        per_impl[impl] = (dk.LAUNCHES - before[0], rd.LAUNCHES - before[1])
    launches = {"dense": dk.LAUNCHES, "ragged": rd.LAUNCHES}
    emit("slice_launches", ticks=ticks, delivery_matrix_cuda=launches["dense"],
         ragged_delivery_cuda=launches["ragged"],
         by_impl={k: {"delivery_matrix_cuda": v[0],
                      "ragged_delivery_cuda": v[1]}
                  for k, v in per_impl.items()})
    check(launches["dense"] > 0, "the slice never launched delivery_matrix_cuda")
    check(launches["ragged"] > 0, "the slice never launched ragged_delivery_cuda")

    lap(4)
    # 5. the bench.py shape
    bench_args = phase_bench_shape(device)

    lap(5)
    # 6. the mesh tick; the dense kernel's launch count is this phase's
    folded = [f"cuda:{device.index}"] * MESH["shards"]
    mesh_steps, mesh_captured, mesh_recorded, mesh_per_tick, \
        mesh_launches = phase_mesh(folded)
    launches["dense"] += mesh_launches

    lap(6)
    # 7. times
    timing = {}
    for popularity in ("uniform", "zipf"):
        # the base lane's launch of the dense tick, the walks of the ragged
        args = max(captured[("dense", popularity)]["dense"],
                   key=lambda a: a[2].shape[0])
        U, N = args[0].shape[0], args[2].shape[0]
        timing[("dense", popularity)] = dict(
            kernel="delivery_matrix_cuda", shape="slice",
            popularity=popularity, U=U, N=N, W=dk.mask_words(args[0]),
            **timed(lambda: dk.delivery_matrix_cuda(*args),
                    lambda: dk.delivery_matrix_reference(*args)),
            write_floor_ms=write_floor_ms(U, N, device),
            **bound(*dense_work(*args), peak_ops))
        calls = captured[("ragged", popularity)]["ragged"]
        args = max(calls, key=lambda a: a[1].shape[0])
        timing[("ragged", popularity)] = dict(
            kernel="ragged_delivery_cuda", shape="slice",
            popularity=popularity, U=args[3].shape[0], N=args[6].shape[0],
            W=dk.mask_words(args[4]), pages=args[0].shape[0],
            walk_rows=args[1].shape[0],
            **timed(lambda: rd.ragged_delivery_cuda(*args),
                    lambda: rd.ragged_delivery_reference(*args)),
            **bound(*ragged_work(*args), peak_ops))
    U, N = bench_args[0].shape[0], bench_args[2].shape[0]
    timing[("dense", "bench")] = dict(
        kernel="delivery_matrix_cuda", shape="bench.py", U=U, N=N, W=1,
        **timed(lambda: dk.delivery_matrix_cuda(*bench_args),
                lambda: dk.delivery_matrix_reference(*bench_args)),
        write_floor_ms=write_floor_ms(U, N, device),
        **bound(*dense_work(*bench_args), peak_ops))
    for (impl, shape), t in timing.items():
        own = per_impl[impl][0 if impl == "dense" else 1]
        emit("time", launches_per_tick=1.0 if shape == "bench"
             else own / ticks[impl], **t)
    for (impl, popularity), rows in steps.items():
        r = np.asarray(rows)
        emit("step_time", impl=impl, popularity=popularity,
             stage_ms_median=float(np.median(r[:, 0]) * 1e3),
             host_pack_ms_median=float(np.median(r[:, 1]) * 1e3),
             device_step_ms_median=float(np.median(r[:, 2]) * 1e3),
             pair_extract_ms_median=float(np.median(r[:, 3]) * 1e3),
             pairs_median=float(np.median(r[:, 4])))
    # the dense kernel at the mesh shape: a base-lane launch of the last
    # fused tick (one shard's lane over every shard's gathered frames)
    for popularity in ("uniform", "zipf"):
        args = max(mesh_captured[(popularity, "fused")],
                   key=lambda a: a[2].shape[0])
        U, N = args[0].shape[0], args[2].shape[0]
        emit("time", kernel="delivery_matrix_cuda", shape="mesh",
             popularity=popularity, shards=MESH["shards"], U=U, N=N,
             W=dk.mask_words(args[0]),
             launches_per_tick=mesh_per_tick[(popularity, "fused")],
             **timed(lambda: dk.delivery_matrix_cuda(*args),
                     lambda: dk.delivery_matrix_reference(*args)),
             write_floor_ms=write_floor_ms(U, N, device),
             **bound(*dense_work(*args), peak_ops))
    # the mesh tick: host-clock medians over each run's ticks, and the
    # last tick's exchange and per-shard routing replayed on their
    # recorded inputs under CUDA events
    for (popularity, schedule), rows in mesh_steps.items():
        r = np.asarray(rows, dtype=float)
        rec = mesh_recorded[(popularity, schedule)]
        states, batches, directs, liveness = rec.args
        exchanged = rec.step.exchange(states, batches, directs)
        pack_gather = time_ms(
            lambda: rec.step.exchange(states, batches, directs))
        shard_step = time_ms(
            lambda: rec.step.route(states, exchanged, liveness))
        emit("mesh_step_time", popularity=popularity, schedule=schedule,
             shards=MESH["shards"], devices=folded,
             exchange="device-to-device copies on one card",
             stage_ms_median=float(np.median(r[:, 0]) * 1e3),
             host_snapshot_upload_ms_median=float(np.median(r[:, 1]) * 1e3),
             mesh_step_readback_ms_median=float(np.median(r[:, 2]) * 1e3),
             pair_extract_ms_median=float(np.median(r[:, 3]) * 1e3),
             pack_gather_ms=pack_gather[0],
             pack_gather_wall_ms=pack_gather[1],
             shard_step_ms=shard_step[0], shard_step_wall_ms=shard_step[1],
             pairs_median=float(np.median(r[:, 4])))

    lap(7)
    # 8. the broker; its device runs' launches join the kernel line's
    broker_rows, broker_launches = phase_broker(device)
    launches["dense"] += broker_launches["dense"]
    launches["ragged"] += broker_launches["ragged"]

    lap(8)
    # 9. the cluster as processes; the broker processes' launches over
    # their runs' traffic join the kernel line's
    cluster_rows, cluster_launches = phase_cluster()
    launches["dense"] += cluster_launches["dense"]
    launches["ragged"] += cluster_launches["ragged"]

    lap(9)
    # 10. four broker shards serving users through the mesh group; the
    # group runs' launches join the kernel line's
    _, mesh_broker_launches = phase_mesh_broker(folded)
    launches["dense"] += mesh_broker_launches

    lap(10)
    # 11. the multi-host group: two processes step one global mesh; the
    # worker processes' launches on its main path join the kernel line's
    _, multihost_launches, mh_args = phase_multihost(device)
    launches["dense"] += multihost_launches
    # the dense kernel at the multi-host shape: a base-lane launch of the
    # last tick (one shard's lane over every shard's gathered frames), as
    # the one-process reference captured it on the same inputs
    args = max(mh_args, key=lambda a: a[2].shape[0])
    U, N = args[0].shape[0], args[2].shape[0]
    emit("time", kernel="delivery_matrix_cuda", shape="multihost",
         popularity="uniform", shards=MULTIHOST["shards"],
         processes=MULTIHOST["processes"], U=U, N=N,
         W=dk.mask_words(args[0]),
         launches_per_tick=2 * MULTIHOST["shards"] // MULTIHOST["processes"],
         **timed(lambda: dk.delivery_matrix_cuda(*args),
                 lambda: dk.delivery_matrix_reference(*args)),
         write_floor_ms=write_floor_ms(U, N, device),
         **bound(*dense_work(*args), peak_ops))

    lap(11)
    # 12. the native host routines on phase 4's dense matrices (a base-lane
    # launch of each popularity's run, recomputed by the plain version)
    matrices = {}
    for popularity in ("uniform", "zipf"):
        args = max(captured[("dense", popularity)]["dense"],
                   key=lambda a: a[2].shape[0])
        matrices[popularity] = dk.delivery_matrix_reference(
            *args).cpu().numpy()
    phase_native(matrices)

    lap(12)
    # 13. the host routing plane on the card's host
    phase_route()
    lap(13)
    # 14. the sharded host data plane (worker shards) on the card's host,
    # beside phase 8's and phase 9's plane-less brokers
    phase_shards(broker_rows, cluster_rows)
    lap(14)
    # 15. durable topics, admission and re-homing under the dense plane;
    # the three runs' launches join the kernel line's
    launches["dense"] += phase_durable(device, broker_rows)
    lap(15)
    # 16. the runner, the consensus workload and the client packs on the
    # card; the runner's brokers', the consensus clusters' and the soak
    # broker's launches over their traffic join the kernel line's
    tooling, soak_plane = phase_tooling(cluster_rows)
    launches["dense"] += tooling["dense"]
    launches["ragged"] += tooling["ragged"]
    lap(16)
    # 17. the host I/O engines under the planes: the dense plane over
    # io_uring, the plane-less broker with and without the fused pump, the
    # ragged plane over QUIC; the plane brokers' launches over their
    # traffic join the kernel line's
    io = phase_io(soak_plane)
    launches["dense"] += io["dense"]
    launches["ragged"] += io["ragged"]
    lap(17)
    # 18. the production run definition's shape: BLS keys, TCP broker
    # links, TCP+TLS users, Redis discovery where there is a server, dense
    # planes; the brokers' and the consensus cluster's launches over their
    # traffic join the kernel line's
    launches["dense"] += phase_prod()
    lap(18)
    emit("phase_seconds", **{str(k): v for k, v in sorted(laps.items())},
         total=sum(laps.values()))

    # the kernel line reads the uniform slice tick; the launches are the
    # slice phase's, the mesh phase's MeshGroup runs', the broker's, the
    # broker processes' of the cluster phase, the mesh-broker group runs',
    # the multi-host phase's worker and broker processes', and phases
    # 15-18's
    kernels = []
    for impl, name, source, replaces in (
            ("dense", "delivery_matrix_cuda",
             "pushcdn_tpu_torch/csrc/delivery_matrix.cu",
             "pushcdn_tpu/ops/delivery_kernel.py:85"),
            ("ragged", "ragged_delivery_cuda",
             "pushcdn_tpu_torch/csrc/ragged_delivery.cu",
             "pushcdn_tpu/ops/ragged_delivery.py:471")):
        t = timing[(impl, "uniform")]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[impl],
            "max_abs_err": errs[impl], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
