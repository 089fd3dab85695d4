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

A mesh may span OS processes (``parallel.multihost.pod_broker_mesh``):
then it also holds each shard's process rank, this process's rank and
the ``torch.distributed`` process group the exchange runs over. Shards
are rank-contiguous, and only this process's shards (its *local*
shards) have a device here; a step's inputs and outputs are sequences
over the local shards only. A mesh in one process has no ranks and no
group, and every shard is local.

:class:`MeshDiscovery` answers broker membership from the mesh (and a
liveness mask) with no I/O, and delegates permits and the whitelist to
an :class:`~pushcdn_tpu_torch.proto.discovery.embedded.Embedded` store.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pushcdn_tpu_torch._device import DeviceLike, resolve_device
from pushcdn_tpu_torch.proto.discovery.base import (
    BrokerIdentifier,
    DiscoveryClient,
)
from pushcdn_tpu_torch.proto.discovery.embedded import Embedded
from pushcdn_tpu_torch.proto.error import ErrorKind, bail

# the JAX mesh's axis name; the port's mesh has this one axis
BROKER_AXIS = "brokers"


@dataclass(frozen=True)
class BrokerMesh:
    """The broker-shard axis: one device per shard, in mesh order. On a
    mesh that spans processes, ``ranks[i]`` is shard ``i``'s process,
    ``devices[i]`` is None unless that process is this one (``rank``),
    and ``group`` is the process group of the exchange (``timeout_s``
    bounds each of its collectives)."""

    devices: Tuple[Optional[torch.device], ...]
    ranks: Optional[Tuple[int, ...]] = None
    rank: int = 0
    group: Any = field(default=None, compare=False)
    timeout_s: Optional[float] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None

    @property
    def local_indices(self) -> List[int]:
        """The shards whose device is in this process, in mesh order."""
        if self.ranks is None:
            return list(range(self.size))
        return [i for i, r in enumerate(self.ranks) if r == self.rank]

    @property
    def local_devices(self) -> List[torch.device]:
        return [self.devices[i] for i in self.local_indices]

    def distinct_devices(self) -> List[torch.device]:
        """Each local device once, in first-shard order."""
        return list(dict.fromkeys(d for d in self.devices if d is not None))


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
    """Split every leaf's leading broker axis: one tree per local shard
    (every shard, in one process), the tree of shard ``i`` holding row
    ``i`` of each leaf on shard ``i``'s device."""
    return [_tree_map(lambda x, i=i, d=mesh.devices[i]:
                      x[i].to(d).contiguous(), tree)
            for i in mesh.local_indices]


def broker_identifier_for_device(mesh: BrokerMesh,
                                 index: int) -> BrokerIdentifier:
    """The canonical identity of the broker on shard ``index``.

    The public endpoint carries the mesh index, so the identifiers'
    total order is the mesh order and CRDT tie-breaks agree between the
    host plane and the device plane. The private endpoint names the
    shard's device, as the JAX package's does, when every shard has a
    device of its own; shards folded onto one device (``["cuda:0"] * 4``,
    ``["cpu"] * n``) are named by their mesh index instead, which keeps
    them distinct and equals the JAX names on a mesh of devices
    0..n-1."""
    dev = mesh.devices[index]
    folded = len(mesh.distinct_devices()) < mesh.size
    name = index if folded or dev.index is None else dev.index
    return BrokerIdentifier(
        public_advertise_endpoint=f"mesh{index:04d}:pub",
        private_advertise_endpoint=f"device:{name}")


class MeshDiscovery(DiscoveryClient):
    """Discovery backed by the mesh for membership and an embedded store
    for permits and the whitelist.

    - ``get_other_brokers`` / ``get_with_least_connections``: answered
      from the mesh, the liveness mask and the host-reported load, no
      I/O;
    - ``issue_permit`` / ``validate_permit`` / whitelist: delegated to
      the backing :class:`Embedded` store (durable, shared with the
      marshal).
    """

    def __init__(self, mesh: BrokerMesh, backing: Embedded,
                 identity: Optional[BrokerIdentifier]):
        self.mesh = mesh
        self.backing = backing
        self.identity = identity
        n = mesh.size
        self.live = np.ones(n, dtype=bool)       # liveness mask (host-managed)
        self.load = np.zeros(n, dtype=np.int64)  # host-reported user counts
        if identity is not None and identity not in self._identifiers():
            bail(ErrorKind.PARSE,
                 f"identity {identity} is not a shard of this mesh; use "
                 "broker_identifier_for_device(mesh, i)")

    @classmethod
    async def new(cls, endpoint: str,
                  identity: Optional[BrokerIdentifier] = None,
                  global_permits: bool = False,
                  mesh: Optional[BrokerMesh] = None) -> "MeshDiscovery":
        backing = await Embedded.new(endpoint, identity=identity,
                                     global_permits=global_permits)
        return cls(mesh if mesh is not None else make_broker_mesh(),
                   backing, identity)

    # -- membership from topology ------------------------------------------

    def _identifiers(self) -> List[BrokerIdentifier]:
        return [broker_identifier_for_device(self.mesh, i)
                for i in range(self.mesh.size)]

    def mark_dead(self, index: int) -> None:
        """Mask a shard out of membership and placement."""
        self.live[index] = False

    def mark_live(self, index: int) -> None:
        self.live[index] = True

    async def perform_heartbeat(self, num_connections: int,
                                heartbeat_expiry_s: float) -> None:
        """Load is recorded in-process; mesh membership needs no TTL (a
        device does not silently leave: the host marks it dead)."""
        if self.identity is None:
            bail(ErrorKind.PARSE, "heartbeat requires a broker identity")
        for i, ident in enumerate(self._identifiers()):
            if ident == self.identity:
                self.load[i] = num_connections
                return

    async def get_other_brokers(self) -> List[BrokerIdentifier]:
        return [ident for i, ident in enumerate(self._identifiers())
                if self.live[i] and ident != self.identity]

    async def get_with_least_connections(self) -> BrokerIdentifier:
        live = [(self.load[i], i) for i in range(self.mesh.size)
                if self.live[i]]
        if not live:
            bail(ErrorKind.CONNECTION, "no live broker shards in the mesh")
        _load, i = min(live)
        return broker_identifier_for_device(self.mesh, i)

    # -- durable state: delegate -------------------------------------------

    async def issue_permit(self, for_broker: BrokerIdentifier,
                           expiry_s: float, public_key: bytes) -> int:
        return await self.backing.issue_permit(for_broker, expiry_s,
                                               public_key)

    async def _validate_permit(self, broker: BrokerIdentifier,
                               permit: int) -> Optional[bytes]:
        # the base-class template already range-checked; the backing
        # store's public entry checks again, harmlessly
        return await self.backing.validate_permit(broker, permit)

    async def set_whitelist(self, users: List[bytes]) -> None:
        await self.backing.set_whitelist(users)

    async def check_whitelist(self, user: bytes) -> bool:
        return await self.backing.check_whitelist(user)

    async def close(self) -> None:
        await self.backing.close()
