#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pushcdn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them, and the torch and CUDA versions;
2. build — both kernels from ``pushcdn_tpu_torch/csrc`` with nvcc;
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
   disabling it, and launch its kernel; one ``broker`` line per run.

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
# every payload ends in (publisher, seq, send time in perf_counter ns)
TAIL = struct.Struct("<IIq")


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


class BrokerScenario:
    """Seeded subscriptions and bursts for the broker phase, with the
    oracle's own view of who receives what. A delivery is coded
    ``uid << 40 | (publisher * 2 + lane) << 32 | seq``, lane 1 for a frame
    wider than the base lane; ``seq`` rises through the run."""

    def __init__(self, popularity: str, seed: int, shape: dict):
        self.rng = np.random.default_rng(seed)
        self.shape = shape
        self.p = topic_weights(shape["topics"], popularity)
        self.topics = [self.draw(shape["topics_per_user"])
                       for _ in range(shape["users"])]
        by_topic = {}
        for uid, topics in enumerate(self.topics):
            for t in topics:
                by_topic.setdefault(t, []).append(uid)
        self.by_topic = {t: np.asarray(v, np.int64)
                         for t, v in by_topic.items()}
        self.filler = self.rng.integers(0, 256, 1 << 15,
                                        dtype=np.uint8).tobytes()
        self.seq = 0

    def draw(self, k):
        return sorted({int(t) for t in self.rng.choice(
            self.shape["topics"], size=k, p=self.p)})

    def burst(self):
        """One burst of wire frames per publisher (send time 0), frame i
        from publisher i % publishers: broadcasts on one topic (two for a
        tenth of them), directs to any user, ``wide_frames`` frames for
        the wide lane. Returns the frames and the oracle's delivery codes
        and byte totals per user."""
        from pushcdn_tpu_torch.proto.message import (
            Broadcast,
            Direct,
            serialize,
        )
        s, rng = self.shape, self.rng
        n, P, U = s["frames"], s["publishers"], s["users"]
        wide = set(rng.choice(n, s["wide_frames"], replace=False).tolist())
        frames = [[] for _ in range(P)]
        codes = []
        nbytes = np.zeros(U, np.int64)
        for i in range(n):
            pub, seq = i % P, self.seq
            self.seq += 1
            size = int(rng.integers(4096, 16001)) if i in wide \
                else int(rng.integers(16, 513))
            off = int(rng.integers(0, len(self.filler) - size))
            body = self.filler[off:off + size] + TAIL.pack(pub, seq, 0)
            if rng.random() < s["direct_share"]:
                uid = int(rng.integers(U))
                frame = serialize(Direct(b"user-%d" % uid, body))
                uids = np.asarray([uid], np.int64)
            else:
                k = 2 if rng.random() < s["two_topic_share"] else 1
                topics = self.draw(k)
                frame = serialize(Broadcast(topics, body))
                uids = np.unique(np.concatenate(
                    [self.by_topic.get(t, np.empty(0, np.int64))
                     for t in topics]))
            lane = int(len(frame) > s["frame_bytes"])
            frames[pub].append(frame)
            codes.append((uids << 40) | (((pub * 2 + lane) << 32) | seq))
            nbytes[uids] += len(frame)
        return frames, np.concatenate(codes), nbytes


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
                for frames, codes, _ in bursts:
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
    want = np.sort(np.concatenate([c for _, c, _ in bursts]))
    have = np.sort(np.concatenate(
        [np.empty(0, np.int64)]
        + [(np.int64(uid) << 40) | np.asarray(c, np.int64)
           for uid, c in enumerate(got)]))
    check(have.shape == want.shape and (have == want).all(),
          f"{label}: the {len(have)} deliveries differ from the oracle's "
          f"{len(want)}")
    check(np.array_equal(np.asarray(got_bytes),
                         sum(b for _, _, b in bursts)),
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
    (host snapshot, device step, pair extraction, egress), in ms."""
    if plane is None:
        return {}
    r = np.asarray(plane.recent_steps, np.float64).reshape(-1, 6)
    med = (lambda col: float(np.median(r[:, col]) * 1e3)) if len(r) \
        else (lambda col: None)
    return dict(
        steps=plane.steps, messages_routed=plane.messages_routed,
        ragged_steps=plane.ragged_steps,
        ragged_fallbacks=plane.ragged_fallbacks,
        frames_per_step_median=float(np.median(r[:, 4])) if len(r) else None,
        snapshot_ms_median=med(0), device_step_ms_median=med(1),
        pair_extract_ms_median=med(2), egress_ms_median=med(3))


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
        if impl == "ragged":
            check(row["ragged_delivery_cuda"] > 0 and row["ragged_steps"] > 0,
                  f"broker ragged/{popularity} never launched "
                  "ragged_delivery_cuda")
    launches = {"dense": sum(r["delivery_matrix_cuda"] for r in rows.values()),
                "ragged": sum(r["ragged_delivery_cuda"] for r in rows.values())}
    return rows, launches


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

    # 2. build (one nvcc per source, started together)
    t0 = time.perf_counter()
    libs = _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[os.path.relpath(p, HERE) for p in libs])

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

    # the kernel line reads the uniform slice tick; the launches are the
    # slice phase's, the mesh phase's MeshGroup runs' and the broker's
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
