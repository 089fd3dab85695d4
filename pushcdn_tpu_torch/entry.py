"""The port's entry points: the single-chip routing step and its inputs,
and the multi-shard mesh dry run.

``entry()`` returns ``(routing_step_single, (state, batch))`` with the
inputs on ``cuda`` (or on the device the caller names): one broadcast on
topic 0 and one direct frame, against a user table where slot 0 is owned
and subscribed to topic 0. ``fn(*args).deliver`` then holds exactly two
deliveries.

``dryrun_multichip(n)`` runs one fused mesh tick over ``n`` broker
shards and checks its delivery counts exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from pushcdn_tpu_torch._device import DeviceLike, resolve_device
from pushcdn_tpu_torch.convert import (
    direct_ingress_from_numpy,
    ingress_batch_from_numpy,
    liveness_from_numpy,
    router_state_from_numpy,
)
from pushcdn_tpu_torch.parallel.crdt import ABSENT
from pushcdn_tpu_torch.parallel.frames import DirectBuckets, FrameRing
from pushcdn_tpu_torch.parallel.mesh import make_broker_mesh, shard_rows
from pushcdn_tpu_torch.parallel.router import (
    make_mesh_lane_step,
    routing_step_single,
    trace_collectives,
)


def _stack(batches, fields):
    return tuple(np.stack([getattr(b, f) for b in batches]) for f in fields)


_BATCH_FIELDS = ("bytes_", "kind", "length", "topic_mask", "dest", "valid")


def _example_np(U: int, S: int, F: int, num_shards: int = 1):
    """(state leaves, batch leaves) of ``num_shards`` shards as numpy
    arrays stacked on a leading broker axis: shard ``i`` owns slot
    ``i % U``, subscribed to topic 0, and stages a broadcast on topic 0
    and a direct to its own slot."""
    B = num_shards
    owners = np.full((B, U), ABSENT, np.int32)
    versions = np.zeros((B, U), np.uint32)
    ids = np.full((B, U), ABSENT, np.int32)
    masks = np.zeros((B, U), np.uint32)
    rings = []
    for i in range(B):
        owners[i, i % U], versions[i, i % U] = i, 1
        ids[i, i % U], masks[i, i % U] = i, 0b1
        ring = FrameRing(slots=S, frame_bytes=F)
        ring.push_broadcast(b"hello from shard %d" % i, topic_mask=0b1)
        ring.push_direct(b"direct frame", dest_slot=i % U)
        rings.append(ring.take_batch())
    return (owners, versions, ids, masks), _stack(rings, _BATCH_FIELDS)


def entry(device: DeviceLike = None):
    """Returns ``(fn, example_args)`` — the single-chip routing step."""
    dev = resolve_device(device)
    state_np, batch_np = _example_np(U=64, S=128, F=256)
    state = router_state_from_numpy(*(x[0] for x in state_np), device=dev)
    batch = ingress_batch_from_numpy(*(x[0] for x in batch_np), device=dev)
    return routing_step_single, (state, batch)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def dryrun_multichip(n: int, devices=None) -> dict:
    """One fused mesh tick over ``n`` broker shards on ``devices``
    (default: ``n`` CUDA devices, one shard each; raises without them),
    with two broadcast lanes and one direct lane. Checks the exact
    counts: ``n*n + n`` base-lane deliveries (every shard's broadcast at
    every shard's one user, plus each ring-staged direct at its owner),
    ``n*n`` on the wide lane, ``n`` one-hop directs, the same CRDT owners
    on every shard, and ONE counted collective. Returns the counts."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"dryrun_multichip({n}) needs {n} CUDA devices, found "
                f"{have}; pass devices=['cuda:0'] * {n} to fold the shards "
                f"onto one card or devices=['cpu'] * {n} to run on the CPU")
    mesh = make_broker_mesh(n, devices=devices)
    step = make_mesh_lane_step(mesh, fused=True)
    U = max(16, n)  # one distinct owned slot per shard keeps counts exact
    state_np, batch_np = _example_np(U=U, S=8, F=64, num_shards=n)
    # a second, wider lane: one 300-byte broadcast per shard
    wide = []
    for _ in range(n):
        ring = FrameRing(slots=2, frame_bytes=512)
        ring.push_broadcast(b"W" * 300, topic_mask=0b1)
        wide.append(ring.take_batch())
    # the one-hop direct path: shard i sends to the user of shard i+1
    buckets = []
    for i in range(n):
        b = DirectBuckets(n, capacity=4, frame_bytes=64)
        b.push((i + 1) % n, b"one-hop direct %d" % i, dest_slot=(i + 1) % n)
        buckets.append(b.take_batch())
    cpu = torch.device("cpu")
    tree = (router_state_from_numpy(*state_np, device=cpu),
            (ingress_batch_from_numpy(*batch_np, device=cpu),
             ingress_batch_from_numpy(*_stack(wide, _BATCH_FIELDS),
                                      device=cpu)),
            (direct_ingress_from_numpy(
                *_stack(buckets, ("bytes_", "length", "dest", "valid")),
                device=cpu),),
            liveness_from_numpy(np.ones((n, n), bool), device=cpu))
    states, batches, directs, liveness = zip(*shard_rows(mesh, tree))
    before = trace_collectives()
    out = step(states, batches, directs, liveness)
    collectives = trace_collectives() - before
    _check(collectives == 1, f"the fused tick issued {collectives} "
           "collectives")
    counts = dict(
        base=sum(int(r.lanes[0].deliver.sum()) for r in out),
        wide=sum(int(r.lanes[1].deliver.sum()) for r in out),
        direct=sum(int(r.direct_lanes[0].deliver.sum()) for r in out),
        collectives=collectives)
    _check(counts["base"] == n * n + n, f"base lane {counts['base']}")
    _check(counts["wide"] == n * n, f"wide lane {counts['wide']}")
    _check(counts["direct"] == n, f"direct lane {counts['direct']}")
    owners = [r.state.crdt.owners.cpu() for r in out]
    _check(all(torch.equal(owners[0], o) for o in owners),
           "the CRDT did not converge to the same owners on every shard")
    return counts


if __name__ == "__main__":
    fn, args = entry()
    result = fn(*args)
    print("entry(): routing step ran;",
          int(result.deliver.sum().item()), "deliveries")
    print("dryrun_multichip:", dryrun_multichip(torch.cuda.device_count()))
