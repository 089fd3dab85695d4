#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pushcdn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them, and the torch and CUDA versions;
2. build — both kernels from ``pushcdn_tpu_torch/csrc`` with nvcc and,
   beside them, the native host routines from
   ``pushcdn_tpu_torch/native/*.cpp`` with g++ (each one's seconds);
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
   in the slice's mix, every payload ending in (publisher, seq, send
   time), and every user's remote end drains and records what arrives.
   Dense and ragged at uniform (4 bursts) and zipf (2 bursts), then the
   uniform bursts through a broker with no device plane (the port's host
   path on the same machine). Each run must deliver exactly the scalar
   oracle's frames to every user, in publisher order within each lane,
   route every delivery on the plane (``messages_routed``) without
   disabling it, and launch its kernel; a dense run must egress every
   busy step through ``native.egress_encode`` (``native_egress_steps``
   equal to ``busy_steps``); one ``broker`` line per run;
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
   one ``cluster`` line per run;
10. four broker shards serving users through the mesh group — phase 6's
   shape in brokers: a ``MeshBrokerGroup`` on the 4 shards folded onto the
   card (4096 user slots, 512 x 2048 B base-lane slots and the (16384,
   32, 8) lane per shard, 64-slot direct buckets, 8 mask words), 1024
   users injected on each shard's broker over the Memory transport as in
   phase 8, 3 topics each of 256 drawn uniform or zipf(1/rank), 64 of
   them (16 a shard) publishing bursts of 2048 frames in phase 8's mix,
   directs to users on any shard. Runs: (1) the per-array exchange, 3
   uniform bursts, every user moved to zipf topics, 1 zipf burst; (2) the
   fused exchange, 2 uniform bursts, every tick counting one collective;
   (3) on that group, shard 3's broker stopped, 1 uniform burst from the
   survivors' publishers (directs to its users take the host path and
   reach no one); (4) the same four brokers without a group, joined by
   host links, 2 uniform bursts; (5) a small ``MeshCluster`` on the card,
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
   (4032 users, no churn), uniform and zipf, fused and per-array; each
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
   late the pump's window sleep returns, the directory's refreshes);
   beside it the same users and bursts through
   one process's group of 8 shards on the card (reported, not claimed);
   (3) a marshal and two ``broker --mesh-shards 2 --multihost-*
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
   popularity.

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
BROKER = dict(SLICE, publishers=64, bursts={"uniform": 4, "zipf": 2},
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


async def broker_run(impl: str, popularity: str, seed: int, device,
                     shape: dict) -> dict:
    """One run of the broker phase: a broker with a device plane of
    ``impl`` on ``device`` (or none, ``impl="host"``), its users injected
    over the Memory transport, the scenario's bursts published and
    drained; every check of the run, then its numbers."""
    from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
    from pushcdn_tpu_torch.broker.device_plane import DevicePlaneConfig
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
    plane_cfg = None if impl == "host" else DevicePlaneConfig(
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
            got = [[] for _ in range(U)]
            got_bytes = [0] * U
            latency_ns = []
            seen = [0, 0]   # frames received, perf_counter ns of the last

            async def drain(uid, remote):
                box = got[uid]
                while True:
                    raws = await remote.recv_raw_many()
                    now = time.perf_counter_ns()
                    for raw in raws:
                        d = raw.data
                        pub, seq, sent = TAIL.unpack_from(
                            d, len(d) - TAIL.size)
                        box.append(((pub * 2 + (len(d) > base)) << 32) | seq)
                        got_bytes[uid] += len(d)
                        latency_ns.append(now - sent)
                        raw.release()
                    seen[0] += len(raws)
                    seen[1] = now

            drains = [asyncio.create_task(drain(uid, u.remote))
                      for uid, u in enumerate(run.connected_users)]
            dk.LAUNCHES = 0
            rd.LAUNCHES = 0
            busy_s = 0.0
            want_total = 0
            try:
                for frames, _, codes, _, _ in bursts:
                    want_total += len(codes)
                    t0 = time.perf_counter_ns()
                    for pub, pub_frames in enumerate(frames):
                        stamp = struct.pack("<q", time.perf_counter_ns())
                        await run.user(pub).remote.send_raw_many(
                            [f[:-8] + stamp for f in pub_frames])
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
                launches = (dk.LAUNCHES, rd.LAUNCHES)
                for t in drains:
                    t.cancel()
                ends = await asyncio.gather(*drains, return_exceptions=True)
            check(all(isinstance(e, asyncio.CancelledError) for e in ends),
                  f"{label}: a receiver failed: "
                  f"{[e for e in ends if not isinstance(e, asyncio.CancelledError)][:1]}")
            stats = plane_stats(plane)
        finally:
            await run.shutdown()
    finally:
        Memory.set_duplex_window(prev_window)
        if os.path.exists(db):
            os.remove(db)

    # every user's frames against the oracle, and publisher order per lane
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
    lat_ms = np.asarray(latency_ns, np.float64) / 1e6
    return dict(
        impl=impl, popularity=popularity,
        path="device plane" if plane is not None
        else "the port's host path, same machine",
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
    uniform bursts with no device plane. Returns each run's line and the
    kernels' launches over the device runs' traffic; fails unless each
    device run launched its kernel."""
    rows = {}
    for impl, popularity in (("dense", "uniform"), ("dense", "zipf"),
                             ("ragged", "uniform"), ("ragged", "zipf"),
                             ("host", "uniform")):
        # one seed per popularity: every impl takes the same bursts
        seed = 40 + (popularity == "zipf")
        rows[(impl, popularity)] = row = asyncio.run(
            broker_run(impl, popularity, seed, device, shape))
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


def log_fields(path: str, what: str):
    """The JSON of the last ``<what> {...}`` line the broker binary wrote,
    or None."""
    found = None
    for line in log_tail(path, 1 << 20).splitlines():
        at = line.find(what + " {")
        if at >= 0:
            found = json.loads(line[at + len(what) + 1:])
    return found


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
                            timeout: float):
        try:
            async with asyncio.timeout(timeout):
                while (fields := log_fields(self.logs[name], what)) is None:
                    self.check_alive(label)
                    await asyncio.sleep(0.1)
        except TimeoutError:
            raise SmokeFailure(f"{label}: no {what!r} line from the {name} "
                               f"in {timeout} s:\n"
                               f"{log_tail(self.logs[name])}") from None
        return fields

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


def percentiles_ms(latency_ns) -> dict:
    lat = np.asarray(latency_ns, np.float64) / 1e6
    return dict(publish_to_receive_ms_p50=float(np.percentile(lat, 50)),
                publish_to_receive_ms_p99=float(np.percentile(lat, 99)))


async def cluster_run(impl: str, seed: int, shape: dict,
                      device=None) -> dict:
    """One run of phase 9: a marshal and a broker (with a device plane of
    ``impl``, or none for ``impl="host"``) as child processes on a fresh
    discovery file, ``users`` clients authenticating through the marshal
    over TCP+TLS, the uniform bursts, and for a plane run every client's
    subscriptions redrawn zipf through ``Client.subscribe`` and
    ``unsubscribe`` and the zipf bursts. The plane runs on the binary's
    default device (CUDA) unless ``device`` names another. Every check of
    the run, then its numbers."""
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.message import Broadcast, Direct
    from pushcdn_tpu_torch.proto.transport import TcpTls

    label = f"cluster {impl}"
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
    tag = f"cluster-{impl}-{os.getpid()}"
    db = os.path.join(HERE, ".build", f"{tag}.sqlite")
    for suffix in ("", "-wal", "-shm"):
        if os.path.exists(db + suffix):
            os.remove(db + suffix)
    pub, priv, broker_metrics, marshal, marshal_metrics = free_ports(5)
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
                   env={"PUSHCDN_DELIVERY_IMPL": impl} if impl != "host"
                   else None)
        kids.spawn("marshal", "--discovery-endpoint", db,
                   "--bind-endpoint", f"127.0.0.1:{marshal}",
                   "--metrics-bind-endpoint", f"127.0.0.1:{marshal_metrics}",
                   "--user-transport", "tcp+tls")
        # the broker logs this line once its plane has warmed up
        serving = await kids.wait_for_line("broker", "broker serving", label,
                                           timeout=180)
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
        for c in clients:
            c.close()
        kids.terminate(label)
        exit_fields = log_fields(kids.logs["broker"], "device plane exit")
        check(exit_fields is not None,
              f"{label}: the broker logged no exit line:\n"
              f"{log_tail(kids.logs['broker'])}")
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
        check(not any(exit_fields["launches"].values()),
              f"{label}: the host-path broker launched a kernel")
        check(routed_metric == 0 and "messages_routed" not in exit_fields,
              f"{label}: a host-path broker routed on a plane")
    else:
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
    check(exit_fields["native"], f"{label}: the broker's native host "
          "routines did not load")
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
        else "the port's host path, same machine",
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
        routed_share=routed_metric / (len(want) + barriers),
        steps=exit_fields.get("steps"),
        native=exit_fields["native"],
        busy_steps=exit_fields.get("busy_steps"),
        native_egress_steps=exit_fields.get("native_egress_steps"),
        broker_step_ms_median=exit_fields.get("step_ms_median"),
        delivery_matrix_cuda=traffic["delivery_matrix_cuda"],
        ragged_delivery_cuda=traffic["ragged_delivery_cuda"],
        warmup_launches=serving["launches"],
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
                mb, "mesh broker per-array", [("uniform", 3), ("zipf", 1)],
                pubs)
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

        # 4. the same brokers without a group, joined by host links
        t = time.perf_counter()
        mb = MeshBrokers("meshbroker-host-links", shape,
                         BrokerScenario("uniform", seed + 1, shape), devices,
                         group=False)
        await mb.start()
        try:
            since = mb.mark()
            bursts = [mb.sc.burst(pubs) for _ in range(2)]
            dk.LAUNCHES = 0
            busy = await mb.publish("mesh broker host links", bursts, pubs)
            mb.check_oracle("mesh broker host links", bursts, since)
            check(dk.LAUNCHES == 0,
                  "mesh broker host links: the host path launched a kernel")
            deliveries = sum(len(b.codes) for b in bursts)
            rows["host-links"] = dict(
                run="host links, no group", shards=B, users=U,
                topics=shape["topics"], publishers=P,
                bursts={"uniform": 2}, frames_per_burst=shape["frames"],
                deliveries=deliveries, matches_oracle=True,
                fifo_per_publisher_and_lane=True,
                delivered_msgs_per_s=deliveries / busy,
                **percentiles_ms(mb.latency_ns), busy_s=busy,
                host_links=[b.connections.num_brokers for b in mb.brokers],
                routed_share=0.0, delivery_matrix_cuda=0)
        finally:
            await mb.shutdown()
        rows["host-links"]["run_s"] = time.perf_counter() - t
        emit("mesh_broker", **rows["host-links"])
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
    for rank, p in enumerate(procs):
        check(p.returncode == 0, f"{label}: rank {rank} exited with "
              f"{p.returncode}:\n{log_tail(os.path.join(d, f'rank{rank}.log'))}")


def lockstep_scripts(shape: dict) -> list:
    """Phase 11's socket-free runs: per (popularity, schedule) the users
    (phase 6's, no churn) and ticks of a MeshScenario over the global
    mesh, with the scenario to check them by."""
    import pickle
    cfg = dict(num_user_slots=shape["users"], ring_slots=shape["ring_slots"],
               direct_bucket_slots=shape["direct_bucket_slots"],
               frame_bytes=shape["frame_bytes"],
               extra_lanes=(shape["extra_lane"],),
               topic_words=shape["topic_words"])
    runs = []
    for seed, (popularity, fused) in enumerate(
            (p, f) for p in ("uniform", "zipf") for f in (True, False)):
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
            delivery_matrix_cuda=int(rows[:, 7].sum())))
    return lines, launches, captured, workers_s


def multihost_plan(shape: dict, seed: int, db: str):
    """Phase 11 run 2's plan: users ``uid`` on shard ``uid % shards``
    (half the shards in each process), publishers 0..publishers-1, three
    uniform bursts, every user moved to zipf topics, one zipf burst;
    directs go to users of the other process. Returns the plan, the
    bursts, the scenario as it stood before the bursts and the uniform
    topics the zipf move starts from."""
    import copy
    B, U = shape["shards"], shape["users"]
    local = B // shape["processes"]
    sc = BrokerScenario("uniform", seed, shape)
    start = copy.deepcopy(sc)
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
    return plan, bursts, start, pubs


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
    oracle. Returns the run's line, the plan's pieces for the
    one-process comparison and the workers' dense launches."""
    import pickle
    label = "multihost brokers"
    B = shape["shards"]
    local = B // shape["processes"]
    tag = f"multihost-brokers-{os.getpid()}"
    db = os.path.join(HERE, ".build", f"{tag}.sqlite")
    for suffix in ("", "-wal", "-shm"):
        if os.path.exists(db + suffix):
            os.remove(db + suffix)
    plan, bursts, start, pubs = multihost_plan(shape, seed, db)
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
        host_links=links, run_s=run_s)
    return line, (bursts, start, pubs, plan), line["delivery_matrix_cuda"]


async def one_process_comparison(device, shape: dict, pieces) -> dict:
    """The same users and bursts through one process's MeshBrokerGroup on
    every shard folded onto ``device`` (phase 10's harness at phase 11's
    shape, fused exchange); reported beside run 2, never claimed."""
    from pushcdn_tpu_torch.proto.transport.memory import Memory
    bursts, start, pubs, plan = pieces
    label = "multihost comparison: one process"
    B = shape["shards"]
    prev_window = Memory.set_duplex_window(256 * 1024)
    t = time.perf_counter()
    mb = MeshBrokers("multihost-one-process", shape, start, [device] * B,
                     group=True, fused=True)
    try:
        await mb.start()
        since = mb.mark()
        busy, by_pop = 0.0, {}
        for popularity, b in bursts:
            if popularity != mb.sc.popularity:
                old = mb.sc.topics
                mb.sc.popularity = popularity
                mb.sc.topics = plan["topics"][popularity]
                mb.apply_topics(old)
            lat = len(mb.latency_ns)
            span = await mb.publish(label, [b], pubs)
            busy += span
            pop = by_pop.setdefault(popularity, dict(deliveries=0,
                                                     busy_s=0.0, lat=[]))
            pop["deliveries"] += len(b.codes)
            pop["busy_s"] += span
            pop["lat"] += mb.latency_ns[lat:]
        mb.check_oracle(label, [b for _, b in bursts], since)
        deliveries = sum(len(b.codes) for _, b in bursts)
        check(mb.group.messages_routed == deliveries and not mb.group.disabled,
              f"{label}: the group routed {mb.group.messages_routed} of "
              f"{deliveries} deliveries")
        g = mb.group
        check(g.native_egress_steps == g.busy_steps > 0,
              f"{label}: {g.native_egress_steps} of {g.busy_steps} busy "
              "steps egressed through native.egress_encode")
        return dict(run=label, shards=B, devices=[str(device)] * B,
                    deliveries=deliveries, matches_oracle=True,
                    delivered_msgs_per_s=deliveries / busy,
                    by_popularity={
                        p: dict(delivered_msgs_per_s=v["deliveries"]
                                / v["busy_s"], **percentiles_ms(v["lat"]))
                        for p, v in by_pop.items()},
                    **percentiles_ms(mb.latency_ns), busy_s=busy,
                    run_s=time.perf_counter() - t)
    finally:
        await mb.shutdown()
        Memory.set_duplex_window(prev_window)


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
    broker_line, pieces, broker_launches = multihost_brokers(
        device, shape, 111)
    emit("multihost", **broker_line)
    lines["brokers"] = broker_line
    cmp_line = asyncio.run(one_process_comparison(device, shape, pieces))
    emit("multihost", **cmp_line)
    lines["comparison"] = cmp_line
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
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from pushcdn_tpu_torch.ops import _build
        from pushcdn_tpu_torch.ops import delivery_kernel as dk
        from pushcdn_tpu_torch.ops import ragged_delivery as rd
    except ImportError as e:
        print(f"chip_smoke: the pushcdn_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

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

    # 2. build (one nvcc per source, started together; the native host
    # routines with g++ beside them)
    from pushcdn_tpu_torch import native
    t0 = time.perf_counter()

    def build_native():
        t = time.perf_counter()
        return native.build(), time.perf_counter() - t

    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(build_native)
        libs = _build.build()
        kernels_s = time.perf_counter() - t0
        try:
            host_libs, native_s = host.result()
        except RuntimeError as e:
            raise SmokeFailure(str(e)) from None
    emit("build", seconds=time.perf_counter() - t0, kernels_seconds=kernels_s,
         native_seconds=native_s,
         libraries=[os.path.relpath(p, HERE) for p in libs],
         native_libraries=[os.path.relpath(p, HERE)
                           for p in host_libs.values()])

    # 3. kernels vs plain
    errs = phase_kernels_vs_plain(device)

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

    # 5. the bench.py shape
    bench_args = phase_bench_shape(device)

    # 6. the mesh tick; the dense kernel's launch count is this phase's
    folded = [f"cuda:{device.index}"] * MESH["shards"]
    mesh_steps, mesh_captured, mesh_recorded, mesh_per_tick, \
        mesh_launches = phase_mesh(folded)
    launches["dense"] += mesh_launches

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

    # 8. the broker; its device runs' launches join the kernel line's
    _, broker_launches = phase_broker(device)
    launches["dense"] += broker_launches["dense"]
    launches["ragged"] += broker_launches["ragged"]

    # 9. the cluster as processes; the broker processes' launches over
    # their runs' traffic join the kernel line's
    _, cluster_launches = phase_cluster()
    launches["dense"] += cluster_launches["dense"]
    launches["ragged"] += cluster_launches["ragged"]

    # 10. four broker shards serving users through the mesh group; the
    # group runs' launches join the kernel line's
    _, mesh_broker_launches = phase_mesh_broker(folded)
    launches["dense"] += mesh_broker_launches

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

    # 12. the native host routines on phase 4's dense matrices (a base-lane
    # launch of each popularity's run, recomputed by the plain version)
    matrices = {}
    for popularity in ("uniform", "zipf"):
        args = max(captured[("dense", popularity)]["dense"],
                   key=lambda a: a[2].shape[0])
        matrices[popularity] = dk.delivery_matrix_reference(
            *args).cpu().numpy()
    phase_native(matrices)

    # the kernel line reads the uniform slice tick; the launches are the
    # slice phase's, the mesh phase's MeshGroup runs', the broker's, the
    # broker processes' of the cluster phase, the mesh-broker group runs'
    # and the multi-host phase's worker and broker processes
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
