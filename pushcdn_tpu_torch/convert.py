"""Carry router state and ingress batches between numpy and the port.

The JAX package keeps versions and topic masks as uint32; the port keeps
versions as int64 holding u32 values and masks as int32 bit-views of the
u32 words. These helpers take and give the JAX package's dtypes, so a
round trip is bit-exact and outputs compare with ``==``. They take any
leading axes: a mesh's stacked ``[B, ...]`` leaves convert as they are
(``parallel.mesh.shard_rows`` then places row ``i`` on shard ``i``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pushcdn_tpu_torch._device import DeviceLike, resolve_device
from pushcdn_tpu_torch.parallel.crdt import CrdtState
from pushcdn_tpu_torch.parallel.router import (
    DirectIngress,
    IngressBatch,
    RouterState,
)


def _bits_i32(a) -> np.ndarray:
    """uint32 (or int32) words as an int32 bit-view."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a.astype(np.int32, copy=False)


def _bits_u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.int32, copy=False).view(np.uint32)


def _to(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def router_state_from_numpy(owners, versions, identities, topic_masks,
                            device: DeviceLike = None) -> RouterState:
    """The port's ``RouterState`` from the JAX package's leaves (owners
    int32, versions uint32, identities int32, topic_masks uint32[U] or
    [U, W])."""
    dev = resolve_device(device)
    return RouterState(
        crdt=CrdtState(
            owners=_to(np.asarray(owners, np.int32), dev),
            versions=_to(np.asarray(versions).astype(np.int64) & 0xFFFFFFFF,
                         dev),
            identities=_to(np.asarray(identities, np.int32), dev)),
        topic_masks=_to(_bits_i32(topic_masks), dev))


def router_state_to_numpy(state: RouterState
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
    """(owners int32, versions uint32, identities int32, topic_masks
    uint32) — the JAX package's dtypes."""
    return (state.crdt.owners.cpu().numpy(),
            state.crdt.versions.cpu().numpy().astype(np.uint32),
            state.crdt.identities.cpu().numpy(),
            _bits_u32(state.topic_masks))


def ingress_batch_from_numpy(frame_bytes, kind, length, topic_mask, dest,
                             valid, device: DeviceLike = None
                             ) -> IngressBatch:
    """The port's ``IngressBatch`` from the JAX package's leaves."""
    dev = resolve_device(device)
    return IngressBatch(
        frame_bytes=_to(np.asarray(frame_bytes, np.uint8), dev),
        kind=_to(np.asarray(kind, np.int32), dev),
        length=_to(np.asarray(length, np.int32), dev),
        topic_mask=_to(_bits_i32(topic_mask), dev),
        dest=_to(np.asarray(dest, np.int32), dev),
        valid=_to(np.asarray(valid, bool), dev))


def ingress_batch_to_numpy(batch: IngressBatch) -> Tuple[np.ndarray, ...]:
    """(frame_bytes, kind, length, topic_mask uint32, dest, valid)."""
    return (batch.frame_bytes.cpu().numpy(), batch.kind.cpu().numpy(),
            batch.length.cpu().numpy(), _bits_u32(batch.topic_mask),
            batch.dest.cpu().numpy(), batch.valid.cpu().numpy())


def direct_ingress_from_numpy(frame_bytes, length, dest, valid,
                              device: DeviceLike = None) -> DirectIngress:
    """The port's ``DirectIngress`` from the JAX package's leaves."""
    dev = resolve_device(device)
    return DirectIngress(
        frame_bytes=_to(np.asarray(frame_bytes, np.uint8), dev),
        length=_to(np.asarray(length, np.int32), dev),
        dest=_to(np.asarray(dest, np.int32), dev),
        valid=_to(np.asarray(valid, bool), dev))


def liveness_from_numpy(liveness, device: DeviceLike = None
                        ) -> torch.Tensor:
    """The bool liveness matrix ([B, B] on a mesh: row ``i`` is shard
    ``i``'s view of which shards are live)."""
    return _to(np.asarray(liveness, bool), resolve_device(device))
