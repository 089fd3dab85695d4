"""The port's CUDA kernels against their plain PyTorch versions, on the
card, and the mesh step with its shards folded onto the card against the
same step on the CPU. Every case needs an NVIDIA GPU and skips without
one.

This file imports nothing of JAX, so it also runs on a machine that has
only PyTorch (there without the repo's conftest, which imports JAX):

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from _torch_trees import stack_rows
from pushcdn_tpu_torch import convert
from pushcdn_tpu_torch.entry import dryrun_multichip
from pushcdn_tpu_torch.ops import delivery_kernel as dk
from pushcdn_tpu_torch.ops import ragged_delivery as rd
from pushcdn_tpu_torch.parallel.frames import (
    DirectBuckets,
    FrameRing,
    split_mask,
)
from pushcdn_tpu_torch.parallel.mesh import make_broker_mesh, shard_rows
from pushcdn_tpu_torch.parallel.router import make_mesh_lane_step
from pushcdn_tpu_torch.proto.message import KIND_BROADCAST, KIND_DIRECT
from pushcdn_tpu_torch.testing import kernel_cases as kc


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _u32(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _to(dev, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(
        a.view(np.int32) if a.dtype == np.uint32 else a)).to(dev)
        for a in arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("U,N,W,all_invalid", [
    (64, 256, 1, False), (37, 301, 8, False), (1000, 999, 3, False),
    (1000, 1000, 1, True), (4096, 2048, 8, False), (5, 3, 2, False)])
def test_delivery_matrix_cuda_matches_plain(U, N, W, all_invalid):
    dev = _cuda()
    rng = np.random.default_rng(U * 7 + N)
    ushape, nshape = ((U,), (N,)) if W == 1 else ((U, W), (N, W))
    kind = rng.choice([0, KIND_BROADCAST, KIND_DIRECT, 9], N).astype(np.int32)
    if all_invalid:
        kind[:] = 0
    args = _to(dev, _u32(rng, ushape), rng.random(U) < 0.7,
               _u32(rng, nshape) & _u32(rng, nshape) & _u32(rng, nshape),
               kind, rng.integers(-3, U + 5, N).astype(np.int32))
    launches = dk.LAUNCHES
    got = dk.delivery_matrix_cuda(*args)
    torch.cuda.synchronize()
    assert dk.LAUNCHES == launches + 1
    assert torch.equal(got, dk.delivery_matrix_reference(*args))
    assert got.any() != all_invalid


@pytest.mark.cuda
@pytest.mark.parametrize("popularity,W,T", [("uniform", 1, 32),
                                            ("zipf", 8, 256)])
def test_ragged_delivery_cuda_matches_plain(popularity, W, T):
    dev = _cuda()
    rng = np.random.default_rng(T)
    U, N = 600, 256
    p = 1.0 / np.arange(1, T + 1) if popularity == "zipf" else np.ones(T)
    p /= p.sum()
    ri = rd.RaggedInterest(T, max_pages=1024)
    masks = np.zeros((U, W), np.uint32)
    for u in range(U):
        m = sum(1 << int(t) for t in set(rng.choice(T, 3, p=p).tolist()))
        ri.set_mask(u, m)
        masks[u] = split_mask(m, W)
    kind = np.where(rng.random(N) < 0.85, KIND_BROADCAST,
                    KIND_DIRECT).astype(np.int32)
    tmask = np.zeros((N, W), np.uint32)
    for n in range(N):
        if kind[n] == KIND_BROADCAST:
            tmask[n] = split_mask(1 << int(rng.choice(T, p=p)), W)
    # direct dests past the user table and negative ones, on purpose
    dest = np.where(kind == KIND_DIRECT, rng.integers(-3, U + 20, N),
                    -1).astype(np.int32)
    valid = rng.random(N) < 0.9
    kz = np.where(valid, kind, 0).astype(np.int32)
    walk = ri.pack(kz, tmask, dest, valid, page_round=64)
    assert not walk.spilled and walk.n_walk < len(walk.walk_page)
    if W == 1:
        masks, tmask = masks[:, 0], tmask[:, 0]
    args = _to(dev, walk.pages, walk.walk_page, walk.walk_frame,
               rng.random(U) < 0.9, masks, tmask, kz, dest)
    launches = rd.LAUNCHES
    out, cnt = rd.ragged_delivery_cuda(*args)
    torch.cuda.synchronize()
    assert rd.LAUNCHES == launches + 1
    r_out, r_cnt = rd.ragged_delivery_reference(*args)
    assert torch.equal(out, r_out) and torch.equal(cnt, r_cnt)
    assert int(cnt.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(kc.DENSE_CASES))
def test_delivery_matrix_cuda_edge_cases(name):
    """Unaligned rows, N = 1 and 64, partial chunks and tiles, frames with
    0..W mask words, users with no or every topic, a direct-only tile."""
    dev = _cuda()
    args = kc.as_torch(kc.dense_case(name), dev)
    got = dk.delivery_matrix_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, dk.delivery_matrix_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("name", kc.RAGGED_CASES)
def test_ragged_delivery_cuda_edge_cases(name):
    """One row, rows off the block and stride multiples, out-of-range walk
    indices (an empty row each), empty pages and candidates past U."""
    dev = _cuda()
    args = kc.as_torch(kc.ragged_case(name), dev)
    out, cnt = rd.ragged_delivery_cuda(*args)
    torch.cuda.synchronize()
    r_out, r_cnt = kc.ragged_oracle(*args)
    assert torch.equal(out, r_out) and torch.equal(cnt, r_cnt)


def _mesh_inputs(n, W, seed):
    """Stacked numpy leaves for an ``n``-shard lane step: conflicting
    claims, an owner past the mesh, two broadcast lanes and direct
    buckets of different fill per source and destination."""
    rng = np.random.default_rng(seed)
    U = 300
    owners = rng.integers(-1, n + 2, (n, U)).astype(np.int32)
    versions = rng.integers(0, 4, (n, U)).astype(np.uint32)
    versions[:, 0] = 0xFFFFFFFF
    ids = rng.integers(-1, n, (n, U)).astype(np.int32)
    mshape = (n, U) if W == 1 else (n, U, W)
    masks = _u32(rng, mshape) & _u32(rng, mshape)
    lanes = []
    for slots, fbytes in ((96, 64), (8, 512)):
        parts = []
        for _ in range(n):
            ring = FrameRing(slots=slots, frame_bytes=fbytes, topic_words=W)
            for _ in range(int(rng.integers(slots // 2, slots + 1))):
                payload = rng.bytes(int(rng.integers(1, fbytes + 1)))
                if rng.random() < 0.8:
                    mask = int.from_bytes(rng.bytes(4 * W), "little") \
                        & int.from_bytes(rng.bytes(4 * W), "little")
                    ring.push_broadcast(payload, mask or 1)
                else:
                    ring.push_direct(payload, int(rng.integers(-2, U + 3)))
            parts.append(ring.take_batch())
        lanes.append(tuple(np.stack([getattr(p, f) for p in parts]) for f in
                           ("bytes_", "kind", "length", "topic_mask", "dest",
                            "valid")))
    buckets = []
    for _ in range(n):
        b = DirectBuckets(n, capacity=6, frame_bytes=64)
        for _ in range(int(rng.integers(0, 6 * n))):
            b.push(int(rng.integers(0, n)), rng.bytes(int(rng.integers(1, 64))),
                   int(rng.integers(-1, U)))
        buckets.append(b.take_batch())
    direct = tuple(np.stack([getattr(b, f) for b in buckets])
                   for f in ("bytes_", "length", "dest", "valid"))
    live = np.ones((n, n), bool)
    live[:, n - 1] = False
    return (owners, versions, ids, masks), lanes, direct, live


def _mesh_step(devices, fused, gather_bytes, inputs):
    state_np, lanes_np, direct_np, live_np = inputs
    mesh = make_broker_mesh(len(devices), devices=devices)
    tree = (convert.router_state_from_numpy(*state_np, device="cpu"),
            tuple(convert.ingress_batch_from_numpy(*b, device="cpu")
                  for b in lanes_np),
            (convert.direct_ingress_from_numpy(*direct_np, device="cpu"),),
            convert.liveness_from_numpy(live_np, device="cpu"))
    states, batches, directs, lives = zip(*shard_rows(mesh, tree))
    step = make_mesh_lane_step(mesh, gather_bytes=gather_bytes, fused=fused)
    return stack_rows(step(states, batches, directs, lives))


@pytest.mark.cuda
@pytest.mark.parametrize("gather_bytes", [True, False])
@pytest.mark.parametrize("W", [1, 8])
@pytest.mark.parametrize("fused", [True, False])
def test_mesh_lane_step_cuda_matches_cpu(fused, W, gather_bytes):
    """Four shards folded onto one card against four CPU shards: the
    dense kernel on every shard's lanes, the plain version on the CPU."""
    _cuda()
    n = 4
    inputs = _mesh_inputs(n, W, seed=W * 2 + fused)
    launches = dk.LAUNCHES
    got = _mesh_step(["cuda:0"] * n, fused, gather_bytes, inputs)
    torch.cuda.synchronize()
    assert dk.LAUNCHES == launches + 2 * n   # one per shard per lane
    want = _mesh_step(["cpu"] * n, fused, gather_bytes, inputs)
    flat_got = [got.evictions, *got.state.crdt, got.state.topic_masks]
    flat_want = [want.evictions, *want.state.crdt, want.state.topic_masks]
    for g, w in zip(got.lanes + got.direct_lanes,
                    want.lanes + want.direct_lanes):
        flat_got += [g.deliver, g.gathered_length]
        flat_want += [w.deliver, w.gathered_length]
        assert (g.gathered_bytes is None) == (w.gathered_bytes is None)
        if g.gathered_bytes is not None:
            flat_got.append(g.gathered_bytes)
            flat_want.append(w.gathered_bytes)
    for g, w in zip(flat_got, flat_want):
        assert torch.equal(g, w)
    assert bool(got.lanes[0].deliver.any())


@pytest.mark.cuda
def test_dryrun_multichip_folded_onto_one_card():
    _cuda()
    counts = dryrun_multichip(4, devices=["cuda:0"] * 4)
    assert counts == dict(base=20, wide=16, direct=4, collectives=1)
