"""Broker meshes that span OS processes, over ``torch.distributed``.

The counterpart of ``pushcdn_tpu.parallel.multihost``. The reference
scales across machines with per-peer TCP links coordinated by the
discovery registry; here every process joins one ``torch.distributed``
process group and builds the SAME global broker mesh, and the mesh
step's collectives are the inter-broker transport.

Deployment contract:

1. every process calls :func:`initialize` with the same coordinator
   address and its own ``process_id``;
2. every process builds the same global mesh with :func:`pod_broker_mesh`,
   contributing its local devices;
3. each process's brokers attach only to its LOCAL shards
   (:func:`local_shard_indices`): users terminate at the process that
   owns their shard;
4. every process takes part in every step (lockstep): each passes its
   local shards' rows, one collective assembles the global view, and
   each local shard routes on its own device.

Mesh geometry: shards are rank-contiguous (rank 0 holds shards
``0..L-1``, rank 1 the next ``L`` and so on), as JAX's device order is
process-contiguous, so the gather crosses a process boundary once per
process and step (:func:`dcn_crossings`).

Backend: the world group that :func:`initialize` joins is gloo (it runs
the object exchange of :func:`pod_broker_mesh`). The exchange group is
picked by topology in :func:`pod_broker_mesh` and logged: NCCL when every
rank's shards sit on CUDA cards that no other rank uses, gloo otherwise
(on the CPU, and for several ranks on one card, where gloo takes the CUDA
tensors and copies them through host memory itself). The exchange
group's timeout bounds every collective, so a collective with a dead or
stalled peer raises within it.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
from typing import List, Optional, Sequence

import torch

from pushcdn_tpu_torch._device import DeviceLike, resolve_device
from pushcdn_tpu_torch.parallel.mesh import (
    BrokerMesh,
    _indexed,
    make_broker_mesh,
)
from pushcdn_tpu_torch.proto.error import ErrorKind, bail

logger = logging.getLogger("pushcdn.parallel.multihost")

# The world group's timeout: how long a process waits for its peers to
# join, and the bound of the object exchange.
JOIN_TIMEOUT_S = 120.0
# The exchange group's timeout: the bound of every step collective and of
# the stop barrier (MultiHostBrokerGroup.collective_timeout_s).
COLLECTIVE_TIMEOUT_S = 20.0

_ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _dist():
    import torch.distributed as dist
    return dist


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None,
               timeout_s: float = JOIN_TIMEOUT_S) -> None:
    """Join the process group (idempotent). ``coordinator_address`` is
    ``host:port`` (rank 0 serves it) or an init-method URL
    (``tcp://host:port``, ``file:///path``). A bare call joins from the
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE`` environment
    when it is set, and otherwise leaves a one-process world. An explicit
    join that fails raises. ``backend`` is the world group's (gloo by
    default)."""
    dist = _dist()
    if dist.is_initialized():
        return
    given = (coordinator_address, num_processes, process_id)
    if all(x is None for x in given):
        if not all(k in os.environ for k in _ENV_KEYS):
            return   # nothing to join: a one-process world
        init_method = "env://"
    elif any(x is None for x in given):
        bail(ErrorKind.PARSE,
             "a multi-process join needs the coordinator address, the "
             "process count and this process's id")
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    kwargs = {}
    if init_method != "env://":
        kwargs = dict(world_size=int(num_processes), rank=int(process_id))
    dist.init_process_group(
        backend=backend or "gloo", init_method=init_method,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    logger.info("joined the process group: rank %d of %d (%s)",
                dist.get_rank(), dist.get_world_size(),
                dist.get_backend())


def _card_id(dev: torch.device) -> Optional[str]:
    """A name for ``dev``'s physical card that two processes agree on, or
    None for a device that is not a CUDA card."""
    if dev.type != "cuda":
        return None
    props = torch.cuda.get_device_properties(dev)
    uuid = getattr(props, "uuid", None)
    return f"{socket.gethostname()}/{uuid if uuid is not None else dev.index}"


def choose_backend(devices_by_rank: Sequence[Sequence[Optional[str]]]
                   ) -> str:
    """The exchange backend for the ranks' devices (card ids, None for a
    device that is not a CUDA card): NCCL when every shard of every rank
    sits on a CUDA card that no other rank uses and NCCL is built in,
    gloo otherwise."""
    dist = _dist()
    owners = {}
    for rank, cards in enumerate(devices_by_rank):
        for card in cards:
            if card is None:
                return "gloo"
            owners.setdefault(card, set()).add(rank)
    if any(len(r) > 1 for r in owners.values()):
        return "gloo"
    return "nccl" if dist.is_nccl_available() else "gloo"


def pod_broker_mesh(num_brokers: Optional[int] = None,
                    local_devices: Optional[Sequence[DeviceLike]] = None,
                    *, timeout_s: float = COLLECTIVE_TIMEOUT_S) -> BrokerMesh:
    """The GLOBAL broker mesh over every process's devices; every process
    calls it with the same ``num_brokers`` (lockstep). Each process
    contributes ``local_devices`` (default: every visible CUDA card once,
    raising without CUDA; folding is explicit, ``["cuda:0"] * 4`` or
    ``["cpu"] * 4``). In a one-process world it is
    ``make_broker_mesh(num_brokers, local_devices)``.

    ``num_brokers`` may not leave a process without a local shard: that
    process would still have to run every step's collectives. The
    exchange's backend follows the ranks' devices (see the module
    docstring); ``timeout_s`` bounds each of its collectives."""
    if local_devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass local_devices=['cpu'] * n to "
                "build a broker mesh on the CPU")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [_indexed(resolve_device(d)) for d in local_devices]
    if not devs:
        bail(ErrorKind.PARSE, "a process needs at least one local device")
    if process_count() == 1:
        return make_broker_mesh(num_brokers, devices=devs)
    dist = _dist()
    world, me = dist.get_world_size(), dist.get_rank()
    mine = [_card_id(d) for d in devs]
    everyone: list = [None] * world
    dist.all_gather_object(everyone, mine)
    ranks = [r for r, cards in enumerate(everyone) for _ in cards]
    if num_brokers is not None:
        if num_brokers > len(ranks):
            bail(ErrorKind.PARSE,
                 f"asked for {num_brokers} broker shards but the processes "
                 f"give only {len(ranks)} devices")
        ranks = ranks[:num_brokers]
    if len(set(ranks)) != world:
        bail(ErrorKind.PARSE,
             f"num_brokers={num_brokers} covers only {len(set(ranks))} of "
             f"{world} processes; every process needs at least one local "
             "shard")
    backend = choose_backend(
        [everyone[r][:ranks.count(r)] for r in range(world)])
    group = dist.new_group(backend=backend,
                           timeout=datetime.timedelta(seconds=timeout_s))
    local = devs[:ranks.count(me)]
    it = iter(local)
    devices = tuple(next(it) if r == me else None for r in ranks)
    logger.info("pod broker mesh: %d shards over %d processes, local %s, "
                "exchange over %s", len(ranks), world,
                [str(d) for d in local], backend)
    return BrokerMesh(devices, ranks=tuple(ranks), rank=me, group=group,
                      timeout_s=timeout_s)


def local_shard_indices(mesh: BrokerMesh) -> List[int]:
    """Shard indices whose device lives in THIS process: the shards this
    process's brokers may attach to."""
    return mesh.local_indices


def dcn_crossings(mesh: BrokerMesh) -> int:
    """How many times the broker-axis ring crosses a process boundary:
    the gather's cross-process hops per step (diagnostic; minimal when
    each process's shards are contiguous on the axis)."""
    if mesh.ranks is None:
        return 0
    r = list(mesh.ranks)
    return sum(1 for a, b in zip(r, r[1:] + r[:1]) if a != b)


def exchange_transport(mesh: BrokerMesh) -> str:
    """How the mesh's exchange moves rows, in words (for output lines)."""
    if not mesh.spans_processes:
        return "in-process copies"
    backend = _dist().get_backend(mesh.group)
    if any(d.type == "cuda" for d in mesh.distinct_devices()):
        return f"{backend}, CUDA tensors"
    return f"{backend}, CPU tensors"


def all_reduce_flag(mesh: BrokerMesh, flag: bool) -> bool:
    """One tiny collective: whether any process passed ``flag`` True. In
    one process it is ``flag``."""
    if not mesh.spans_processes:
        return bool(flag)
    dist = _dist()
    dev = (mesh.local_devices[0] if dist.get_backend(mesh.group) == "nccl"
           else torch.device("cpu"))
    t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
    dist.all_reduce(t, group=mesh.group)
    return int(t.item()) > 0
