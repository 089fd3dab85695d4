"""Broker-mesh topology: devices as broker shards.

A ``BrokerMesh`` is the ordered list of devices that hold the broker
shards: shard ``i`` runs its part of every mesh step on ``devices[i]``,
and its position is its mesh index (the owner value in the CRDT).
Membership changes are a liveness mask over this fixed list, never a
new mesh.

By default there is one shard per visible CUDA device. Folding several
shards onto one card is explicit (``devices=["cuda:0"] * 4``), and so is
a mesh on the CPU (``devices=["cpu"] * n``): there is no silent CPU mesh.

Step inputs and outputs on a mesh are per-shard sequences, element ``i``
on shard ``i``'s device; :func:`shard_rows` splits stacked ``[B, ...]``
leaves into that form.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from pushcdn_tpu_torch._device import DeviceLike, resolve_device
from pushcdn_tpu_torch.proto.error import ErrorKind, bail

# the JAX mesh's axis name; the port's mesh has this one axis
BROKER_AXIS = "brokers"


@dataclass(frozen=True)
class BrokerMesh:
    """The broker-shard axis: one device per shard, in mesh order."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct_devices(self) -> List[torch.device]:
        """Each device once, in first-shard order."""
        return list(dict.fromkeys(self.devices))


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` without an index names the current card: pin it, so two
    spellings of one card compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_broker_mesh(num_brokers: Optional[int] = None,
                     devices: Optional[Sequence[DeviceLike]] = None
                     ) -> BrokerMesh:
    """A mesh whose shards are ``devices`` (default: every visible CUDA
    device, which raises without CUDA), cut to the first ``num_brokers``.
    Asking for more shards than devices raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=['cpu'] * n to build "
                "a broker mesh on the CPU")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [_indexed(resolve_device(d)) for d in devices]
    if num_brokers is not None:
        if num_brokers > len(devs):
            bail(ErrorKind.PARSE,
                 f"asked for {num_brokers} broker shards but only "
                 f"{len(devs)} devices are given")
        devs = devs[:num_brokers]
    if not devs:
        bail(ErrorKind.PARSE, "a broker mesh needs at least one device")
    return BrokerMesh(tuple(devs))


def _tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor leaf of nested tuples, lists and
    NamedTuples; ``None`` leaves stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def shard_rows(mesh: BrokerMesh, tree) -> list:
    """Split every leaf's leading broker axis: a list of ``mesh.size``
    trees, tree ``i`` holding row ``i`` of each leaf on shard ``i``'s
    device."""
    return [_tree_map(lambda x, i=i, d=dev: x[i].to(d).contiguous(), tree)
            for i, dev in enumerate(mesh.devices)]
