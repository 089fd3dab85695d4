"""Seeded edge-case inputs for the two delivery kernels.

Each case is built with numpy from a seed, so the same arrays can go to
the CUDA kernel, its plain PyTorch version and the JAX package's
reference. Masks are uint32 (``as_torch`` turns them into the int32
bit-views the port takes).

- :func:`dense_case` / ``DENSE_CASES``: unaligned rows (N % 16 != 0),
  N = 1 and N = 64, user counts that are not a multiple of the kernel's
  64-user chunk, frame masks with 0, 1, 2 and all W non-zero words,
  users with no topic and with every topic, and a 512-frame tile of
  direct frames only, with dests at -3, -1, U and U + 5;
- :func:`ragged_case` / ``RAGGED_CASES``: a walk of one row, walks that
  are not a multiple of the rows of a block or of a grid stride, rows
  whose page is -1 or past the table or whose frame is past the frame
  table, all-(-1) pages and candidates at or past U;
- :func:`ragged_oracle`: what the ragged kernel must return, from the
  plain version: a row with an out-of-range page or frame index is an
  empty row (all -1, count 0), which the plain version does not accept
  as input.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pushcdn_tpu_torch.ops.ragged_delivery import PAGE, ragged_delivery_reference
from pushcdn_tpu_torch.parallel.frames import split_mask
from pushcdn_tpu_torch.proto.message import KIND_BROADCAST, KIND_DIRECT

# name -> (U, N, W)
DENSE_CASES = {
    "unaligned rows": (100, 301, 8),
    "one frame": (70, 1, 8),
    "wide lane N=64": (4096, 64, 8),
    "partial chunk and tile": (4097, 513, 8),
    "0/1/2/all mask words": (300, 512, 8),
    "no topic and all topics": (130, 600, 8),
    "direct-only tile": (200, 520, 8),
    "three words, N%4 != 0": (65, 1003, 3),
    "one word, tiny": (33, 17, 1),
}

RAGGED_CASES = ("one row", "thirteen rows", "out-of-range rows",
                "empty and past-U pages", "past one grid stride")


def _u32(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _topic_rows(rng, n, W, k):
    """uint32[n, W] masks of ``k`` topics each, drawn uniform over 32*W."""
    out = np.zeros((n, W), np.uint32)
    for i in range(n):
        m = 0
        for t in rng.choice(32 * W, size=k, replace=False):
            m |= 1 << int(t)
        out[i] = split_mask(m, W)
    return out


def _shape(a, W):
    return a[:, 0].copy() if W == 1 else a


def dense_case(name: str, seed: int = 0):
    """``(umask, local, tmask, kind, dest)`` numpy arrays for one named
    case of ``DENSE_CASES``; masks are uint32 [U]/[N] at W = 1, else
    [U, W]/[N, W]."""
    U, N, W = DENSE_CASES[name]
    rng = np.random.default_rng([seed, len(name), U, N])
    umask = _topic_rows(rng, U, W, 3)
    tmask = _topic_rows(rng, N, W, 1)
    two = rng.random(N) < 0.1
    tmask[two] |= _topic_rows(rng, int(two.sum()), W, 1)
    kind = rng.choice([0, KIND_BROADCAST, KIND_BROADCAST, KIND_BROADCAST,
                       KIND_DIRECT, 9], N).astype(np.int32)
    dest = rng.integers(-3, U + 5, N).astype(np.int32)
    local = rng.random(U) < 0.8
    if name == "0/1/2/all mask words":
        for n in range(N):
            words = n % 4 if n % 4 < 3 else W
            row = np.zeros(W, np.uint32)
            for w in rng.choice(W, size=words, replace=False):
                row[w] = _u32(rng, ()) & _u32(rng, ()) | 1
            tmask[n] = row
        kind[:] = np.where(rng.random(N) < 0.9, KIND_BROADCAST, 0)
    elif name == "one frame":
        kind[0] = KIND_BROADCAST
        tmask[0] = umask[1]
        local[1] = True
    elif name == "no topic and all topics":
        umask[0::4] = 0
        umask[1::4] = 0xFFFFFFFF
    elif name == "direct-only tile":
        kind[:512] = KIND_DIRECT
        special = np.array([-3, -1, U, U + 5], np.int32)
        dest[:512] = rng.integers(0, U, 512)
        dest[:512:3] = special[np.arange(len(dest[:512:3])) % 4]
        dest[5] = dest[6]  # two frames to one user
        kind[512:] = KIND_BROADCAST
    return _shape(umask, W), local, _shape(tmask, W), kind, dest


def _ragged_tables(rng, U, N, W, G):
    """User and frame tables plus a page table of G pages over them."""
    umask = _topic_rows(rng, U, W, 3)
    tmask = _topic_rows(rng, N, W, 1)
    kind = rng.choice([KIND_BROADCAST, KIND_BROADCAST, KIND_DIRECT, 0],
                      N).astype(np.int32)
    dest = rng.integers(-3, U + 5, N).astype(np.int32)
    local = rng.random(U) < 0.8
    pages = rng.integers(-1, U + 8, (G, PAGE)).astype(np.int32)
    pages[0] = -1
    # some pages name the direct frames' own dests, so directs deliver
    for g in range(1, G, 3):
        pages[g, :8] = dest[rng.integers(0, N, 8)]
    return pages, local, umask, tmask, kind, dest


def ragged_case(name: str, seed: int = 0):
    """``(pages, walk_page, walk_frame, local, umask, tmask, kind, dest)``
    numpy arrays for one named case of ``RAGGED_CASES``."""
    rng = np.random.default_rng([seed, len(name), 17])
    W = 1 if name == "thirteen rows" else 8
    U, N, G = 600, 300, 40
    pages, local, umask, tmask, kind, dest = _ragged_tables(rng, U, N, W, G)
    Wp = {"one row": 1, "thirteen rows": 13, "out-of-range rows": 77,
          "empty and past-U pages": 64, "past one grid stride": 20001}[name]
    walk_page = rng.integers(0, G, Wp).astype(np.int32)
    walk_frame = rng.integers(0, N, Wp).astype(np.int32)
    if name == "one row":
        walk_page[0] = 1
        kind[walk_frame[0]] = KIND_BROADCAST
        tmask[walk_frame[0]] = 0xFFFFFFFF
    elif name == "out-of-range rows":
        walk_page[::5] = rng.choice([-1, G, G + 7], len(walk_page[::5]))
        walk_frame[2::7] = rng.choice([N, N + 3, -2], len(walk_frame[2::7]))
    elif name == "empty and past-U pages":
        pages[1::2] = -1
        pages[2::4, ::3] = U
        pages[2::4, 1::3] = U + 100
        pages[2::4, 2::3] = -5
    return (pages, walk_page, walk_frame, local, _shape(umask, W),
            _shape(tmask, W), kind, dest)


def as_torch(arrays, device="cpu") -> Tuple[torch.Tensor, ...]:
    """The arrays as the contiguous tensors the port takes (uint32 as
    int32 bit-views)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(
        a.view(np.int32) if a.dtype == np.uint32 else a)).to(device)
        for a in arrays)


def ragged_oracle(pages, walk_page, walk_frame, local, user_masks,
                  frame_tmask, kind, dest):
    """The ragged kernel's contract on torch tensors: the plain version
    for rows whose page and frame indices are in range, an empty row
    (-1 lanes, count 0) for every other row."""
    G, N = pages.shape[0], kind.shape[0]
    ok = ((walk_page >= 0) & (walk_page < G)
          & (walk_frame >= 0) & (walk_frame < N))
    out, counts = ragged_delivery_reference(
        pages, torch.where(ok, walk_page, 0), torch.where(ok, walk_frame, 0),
        local, user_masks, frame_tmask, kind, dest)
    out = torch.where(ok[:, None], out, -1)
    counts = torch.where(ok, counts, 0)
    return out, counts
