"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every case needs an NVIDIA GPU and skips without one.

This file imports nothing of JAX, so it also runs on a machine that has
only PyTorch (there without the repo's conftest, which imports JAX):

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from pushcdn_tpu_torch.ops import delivery_kernel as dk
from pushcdn_tpu_torch.ops import ragged_delivery as rd
from pushcdn_tpu_torch.parallel.frames import split_mask
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
