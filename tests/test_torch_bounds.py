"""The bounds ``chip_smoke.py`` holds the kernels against, on inputs
counted by hand.

``dense_work`` and ``ragged_work`` count the bytes and 32-bit integer
operations the two delivery functions need for the inputs they are
given (not the most the shapes could need); ``bound`` turns them into
the least time on an H100. The counts are exact integers, so the checks
are equalities.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from pushcdn_tpu_torch.ops.ragged_delivery import PAGE
from pushcdn_tpu_torch.proto.message import KIND_BROADCAST as B
from pushcdn_tpu_torch.proto.message import KIND_DIRECT as D


def _i32(*rows):
    return torch.tensor(np.asarray(rows, np.uint32).view(np.int32))


@pytest.mark.parametrize("sms,clock_hz,want", [
    (132, 1.98e9, 64 * 132 * 1.98e9),   # the H100 SXM at its max clock
    (1, 1e9, 64e9)])
def test_int32_peak(sms, clock_hz, want):
    assert cs.int32_peak(sms, clock_hz) == want


def test_int32_peak_defaults_to_the_h100():
    assert cs.int32_peak() == pytest.approx(16.727e12, rel=1e-4)


@pytest.mark.parametrize("nbytes,ops,by", [
    (3.35e9, 0, "bytes"),               # 1 ms of HBM traffic
    (0, 64e6, "operations"),            # 1 ms at 64e9 operations/s
    (6.7e9, 64e6, "bytes"),             # 2 ms against 1 ms
    (3.35e9, 128e6, "operations")])
def test_bound_takes_the_larger_time(nbytes, ops, by):
    b = cs.bound(nbytes, ops, 64e9)
    assert b["bytes_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert b["ops_ms"] == pytest.approx(ops / 64e9 * 1e3)
    assert b["bound_ms"] == max(b["bytes_ms"], b["ops_ms"])
    assert b["bound_by"] == by


def _dense(case):
    if case == "one word":
        # frame 0: broadcast, 1 word set; frame 1: broadcast, no word;
        # frame 2: direct. One of two users is local.
        return (_i32(1, 3), torch.tensor([True, False]), _i32(1, 0, 2),
                torch.tensor([B, B, D], dtype=torch.int32),
                torch.tensor([0, -1, 1], dtype=torch.int32))
    if case == "eight words":
        # frame 0: broadcast with words 0 and 7 set; frame 1: direct
        return (torch.ones((4, 8), dtype=torch.int32),
                torch.ones(4, dtype=torch.bool),
                _i32([1, 0, 0, 0, 0, 0, 0, 2], [0] * 8),
                torch.tensor([B, D], dtype=torch.int32),
                torch.tensor([-1, 3], dtype=torch.int32))
    # invalid (0) and unknown (9) kinds need no per-user work
    return (torch.ones((3, 2), dtype=torch.int32),
            torch.tensor([True, True, False]),
            torch.ones((2, 2), dtype=torch.int32),
            torch.tensor([0, 9], dtype=torch.int32),
            torch.tensor([0, 1], dtype=torch.int32))


@pytest.mark.parametrize("case,nbytes,ops", [
    # U*N + U*(4W+1) + N*(4W+8);  U*N + local users * (nnz + directs)
    ("one word", 6 + 2 * 5 + 3 * 12, 6 + 1 * (1 + 1)),
    ("eight words", 8 + 4 * 33 + 2 * 40, 8 + 4 * (2 + 1)),
    ("other kinds", 6 + 3 * 9 + 2 * 16, 6)])
def test_dense_work(case, nbytes, ops):
    assert cs.dense_work(*_dense(case)) == (nbytes, ops)


def _pages():
    pages = torch.full((3, PAGE), -1, dtype=torch.int32)
    pages[1, :3] = torch.tensor([0, 1, 5])  # 5 is past U = 4
    pages[2, :2] = torch.tensor([2, 3])
    return pages


def _ragged(case):
    U = 4
    local = torch.ones(U, dtype=torch.bool)
    if case == "one word":
        # rows 0-2 in range, row 3's page is past the table
        return (_pages(), torch.tensor([1, 2, 1, 7], dtype=torch.int32),
                torch.tensor([0, 1, 1, 0], dtype=torch.int32), local,
                torch.ones(U, dtype=torch.int32), _i32(3, 0),
                torch.tensor([B, D], dtype=torch.int32),
                torch.tensor([-1, 2], dtype=torch.int32))
    if case == "eight words":
        return (_pages(), torch.tensor([1, 2], dtype=torch.int32),
                torch.tensor([0, 1], dtype=torch.int32), local,
                torch.ones((U, 8), dtype=torch.int32),
                _i32([1, 0, 0, 0, 0, 0, 0, 1], [0] * 8),
                torch.tensor([B, 0], dtype=torch.int32),
                torch.tensor([-1, -1], dtype=torch.int32))
    # every row out of range: a page of -1, a frame past N
    return (_pages(), torch.tensor([-1, 1], dtype=torch.int32),
            torch.tensor([0, 5], dtype=torch.int32), local,
            torch.ones(U, dtype=torch.int32), _i32(3, 0),
            torch.tensor([B, D], dtype=torch.int32),
            torch.tensor([-1, 2], dtype=torch.int32))


@pytest.mark.parametrize("case,nbytes,ops", [
    # 512 * distinct pages + 8 * Wp + distinct users * (4W + 1)
    # + distinct frames * (4W + 8) + 516 * Wp;
    # 2 * 128 * Wp + sum over in-range candidates of (1 + frame term)
    ("one word", 512 * 2 + 8 * 4 + 4 * 5 + 2 * 12 + 516 * 4,
     256 * 4 + 2 * (1 + 1) + 2 * (1 + 1) + 2 * (1 + 1)),
    ("eight words", 512 * 2 + 8 * 2 + 4 * 33 + 2 * 40 + 516 * 2,
     256 * 2 + 2 * (1 + 2) + 2 * (1 + 0)),
    ("out of range", 8 * 2 + 516 * 2, 256 * 2)])
def test_ragged_work(case, nbytes, ops):
    assert cs.ragged_work(*_ragged(case)) == (nbytes, ops)


def test_ragged_work_counts_only_the_pages_the_walk_visits():
    args = list(_ragged("eight words"))
    bigger = torch.full((300, PAGE), 7, dtype=torch.int32)
    bigger[:3] = args[0]
    base = cs.ragged_work(*args)
    args[0] = bigger
    assert cs.ragged_work(*args) == base


def test_dense_bound_at_the_deployment_shape_is_the_write():
    """4096 users of 3 topics, 2048 frames of 1-2 topics (a tenth direct)
    over 8 mask words: counted for what they need, the operations take
    less time than the 8 MB write at the H100's integer rate."""
    rng = np.random.default_rng(0)
    U, N, W = 4096, 2048, 8
    umask = np.zeros((U, W), np.uint32)
    for u, topics in enumerate(rng.integers(0, 256, (U, 3))):
        for t in topics:
            umask[u, t // 32] |= np.uint32(1 << (t % 32))
    tmask = np.zeros((N, W), np.uint32)
    for n, (a, b) in enumerate(rng.integers(0, 256, (N, 2))):
        tmask[n, a // 32] |= np.uint32(1 << (a % 32))
        if n % 10 == 0:
            tmask[n, b // 32] |= np.uint32(1 << (b % 32))
    kind = np.where(rng.random(N) < 0.9, B, D).astype(np.int32)
    args = (torch.from_numpy(umask.view(np.int32)),
            torch.ones(U, dtype=torch.bool),
            torch.from_numpy(tmask.view(np.int32)), torch.from_numpy(kind),
            torch.from_numpy(rng.integers(0, U, N).astype(np.int32)))
    b = cs.bound(*cs.dense_work(*args), cs.int32_peak())
    assert b["bound_by"] == "bytes"
    assert b["bytes_ms"] == pytest.approx(0.00257, rel=0.01)
    # counting every word of every cell would have made it operations
    all_words = cs.bound(U * N, U * N * (2 * W + 4), cs.int32_peak())
    assert all_words["bound_by"] == "operations"
