"""The dense delivery matrix: the router's inner loop as one kernel.

Computes, for every (local user u, frame n):

    deliver[u, n] = local[u] & ( broadcast_hit(u, n) | direct_hit(u, n) )
    broadcast_hit = kind[n]==BROADCAST and (user_mask[u] & frame_mask[n]) != 0
    direct_hit    = kind[n]==DIRECT    and dest[n] == u

Invalid slots must be pre-masked by the caller (kind=0). Topic masks are
int32 bit-views of the u32 words, [U]/[N] for one word or [U, W]/[N, W]
for W words (W <= 8 covers the whole u8 topic space).

- :func:`delivery_matrix_cuda` launches the hand-written Hopper kernel
  (``csrc/delivery_matrix.cu``) on CUDA tensors;
- :func:`delivery_matrix_reference` is the plain PyTorch version;
- :func:`delivery_matrix` dispatches on the tensors' device: the plain
  version for CPU tensors, the kernel for CUDA tensors (or it raises).
"""

from __future__ import annotations

import ctypes

import torch

from pushcdn_tpu_torch.ops import _build
from pushcdn_tpu_torch.proto.message import KIND_BROADCAST, KIND_DIRECT

MAX_WORDS = 8

# launches of the CUDA kernel in this process (the count a run reads to
# show that its path went through the kernel)
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_fn = None


def delivery_matrix_reference(user_masks: torch.Tensor, local: torch.Tensor,
                              frame_tmask: torch.Tensor, kind: torch.Tensor,
                              dest: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version. ``local`` is bool[U]; ``kind`` must already
    be 0 on invalid slots. Returns bool[U, N]."""
    U = user_masks.shape[0]
    is_b = kind == KIND_BROADCAST
    is_d = kind == KIND_DIRECT
    if user_masks.dim() == 1:
        bcast = (user_masks[:, None] & frame_tmask[None, :]) != 0
    else:
        bcast = ((user_masks[:, None, :] & frame_tmask[None, :, :]) != 0
                 ).any(dim=-1)
    uidx = torch.arange(U, dtype=torch.int32, device=user_masks.device)
    direct = dest[None, :] == uidx[:, None]
    return ((bcast & is_b[None, :]) | (direct & is_d[None, :])) \
        & local[:, None]


def mask_words(user_masks: torch.Tensor) -> int:
    return 1 if user_masks.dim() == 1 else user_masks.shape[1]


def delivery_matrix_cuda(user_masks: torch.Tensor, local: torch.Tensor,
                         frame_tmask: torch.Tensor, kind: torch.Tensor,
                         dest: torch.Tensor) -> torch.Tensor:
    """The Hopper kernel: per 512-frame tile a topic -> frame bitset
    table, per user row the OR of its topics' bitsets, 16-byte stores.
    Same contract as the plain version; any U and N (the kernel masks
    the ragged edge)."""
    global _fn, LAUNCHES
    U = user_masks.shape[0]
    N = frame_tmask.shape[0]
    W = mask_words(user_masks)
    if not 1 <= W <= MAX_WORDS:
        raise ValueError(f"topic masks may have 1..{MAX_WORDS} words, got {W}")
    wshape = () if user_masks.dim() == 1 else (W,)
    dev = user_masks.device
    _build.check_args(dev, (
        ("user_masks", user_masks, torch.int32, (U,) + wshape),
        ("local", local, torch.bool, (U,)),
        ("frame_tmask", frame_tmask, torch.int32, (N,) + wshape),
        ("kind", kind, torch.int32, (N,)),
        ("dest", dest, torch.int32, (N,))))
    out = torch.empty((U, N), dtype=torch.bool, device=dev)
    if U == 0 or N == 0:
        return out
    if _fn is None:
        _fn = _build.load("delivery_matrix", "delivery_matrix_launch",
                          _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fn(user_masks.data_ptr(), local.data_ptr(), frame_tmask.data_ptr(),
             kind.data_ptr(), dest.data_ptr(), out.data_ptr(), U, N, W,
             dev.index, stream)
    _build.check(rc, "delivery_matrix_cuda")
    LAUNCHES += 1
    return out


def delivery_matrix(user_masks, local, frame_tmask, kind,
                    dest) -> torch.Tensor:
    """Dispatch on the device: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors. There is no fallback between them."""
    dev = user_masks.device.type
    if dev == "cuda":
        return delivery_matrix_cuda(user_masks, local, frame_tmask, kind,
                                    dest)
    if dev == "cpu":
        return delivery_matrix_reference(user_masks, local, frame_tmask,
                                         kind, dest)
    raise ValueError(f"no delivery_matrix for device {user_masks.device}")
