"""The yardstick of the delivery kernels: the bytes and 32-bit integer
operations each needs for the inputs it is given, the H100's peaks, and
the least time those allow.

A frozen copy of ``chip_smoke.py``'s ``dense_work``, ``ragged_work``,
``int32_peak`` and ``bound``, with the program's imports replaced by the
constants they read (``PAGE``, the message kinds, the mask-word count).
It imports nothing of the program: a later change to the program cannot
move the yardstick.

Peaks: HBM3 at 3.35 TB/s (NVIDIA's H100 SXM data sheet); 32-bit integer
add, compare, min/max and bitwise logic at 64 results a clock per SM
(the CUDA C++ Programming Guide's throughput table for compute
capability 9.0), times 132 SMs at the card's 1980 MHz maximum SM clock:
16.7e12 a second.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
INT32_OPS_PER_CLOCK_PER_SM = 64
H100_SMS = 132
H100_MAX_SM_CLOCK_HZ = 1.98e9
KIND_DIRECT = 4
KIND_BROADCAST = 5
PAGE = 128


def int32_peak(sms: int = H100_SMS,
               clock_hz: float = H100_MAX_SM_CLOCK_HZ) -> float:
    """32-bit integer operations per second: 64 a clock on each SM."""
    return INT32_OPS_PER_CLOCK_PER_SM * sms * clock_hz


def bound(bytes_moved: int, ops: int, peak_ops: float = None) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the integer rate ``peak_ops``."""
    peak_ops = int32_peak() if peak_ops is None else peak_ops
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / peak_ops * 1e3
    return dict(bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def mask_words(user_masks) -> int:
    return 1 if user_masks.dim() == 1 else user_masks.shape[1]


def dense_work(user_masks, local, frame_tmask, kind, dest):
    """Bytes and integer operations the dense delivery matrix needs for
    these inputs (torch tensors, as the kernel takes them).

    Bytes: each input read once, the bool[U, N] output written once.
    Operations: one per cell for its output byte; for every cell of a
    local user, one per non-zero mask word of a broadcast frame (a LOP3
    folds acc | umask & tmask) and one compare for a direct frame."""
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
