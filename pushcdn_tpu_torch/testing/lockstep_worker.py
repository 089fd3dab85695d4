"""Worker: one process of a pair that steps a global broker mesh in
lockstep, socket-free.

    python -m pushcdn_tpu_torch.testing.lockstep_worker \\
        --rank R --world 2 --init file:///tmp/rdv <mode> <out_dir> <input>... \\
        [--device cpu]

Both processes join the process group, build the same global mesh of
the inputs' shard count (each offering ceil(shards / world) local
shards folded onto ``--device``, so the last process may hold fewer;
the card unless ``--device`` names another, raising without CUDA) and
run the same steps collectively. Every input has the same shard count.
Modes:

- ``lane``: each input is an ``.npz`` of stacked ``[B, ...]`` step
  inputs (:func:`lane_step_case`). The mesh lane step runs once per
  schedule (fused, then per array) on this process's rows, and each
  local shard's outputs go to ``<out_dir>/rank<R>-<i>-<schedule>.npz``
  for input ``i``.
- ``group``: each input is a pickled script: the shard count, a
  ``MeshGroupConfig``'s fields, the users as ``(key, shard, topics)`` in claim order, and per
  tick each shard's ``(kind, payload, target)`` items. A socket-free
  ``MultiHostBrokerGroup`` claims this process's users (the others'
  slots follow from the static partition, as the discovery directory
  would carry them), stages its shards' items and calls ``step()`` once
  a tick; every tick's deliveries and timings go to
  ``<out_dir>/rank<R>-<i>.pkl``.

The parent compares the outputs with a reference (the JAX package's
step in the tests, an oracle and the one-process group in
``chip_smoke.py``). Exits 0 on success.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import time
import zlib

import numpy as np

from pushcdn_tpu_torch.testing.two_host import worker_args

LANE_FIELDS = ("bytes_", "kind", "length", "topic_mask", "dest", "valid")
DIRECT_FIELDS = ("bytes_", "length", "dest", "valid")


def topic_weights(topics: int, popularity: str) -> np.ndarray:
    """Uniform, or zipf(1/rank) over the topic ids."""
    if popularity == "uniform":
        w = np.ones(topics)
    else:
        w = 1.0 / np.arange(1, topics + 1)
    return w / w.sum()


def lane_step_case(popularity: str, seed: int, shards: int = 8,
                   users_per_shard: int = 8, words: int = 8,
                   topics: int = 256) -> dict:
    """Stacked ``[B, ...]`` inputs of one mesh lane step. Shard ``i``'s
    row claims only slots of its own range (``i * K ...``), so a process
    sees the other process's claims only through the step's merge; each
    row also claims the last slot of the next shard's range with a
    random version, so slots are handed off and evicted. Users hold 3
    topics drawn by ``popularity`` (each shard's first user topic 0 as
    well); two broadcast lanes carry broadcasts on those topics (every
    ring's first on topic 0, which reaches every shard) and directs in
    the ring, and the direct buckets address users on any shard."""
    from pushcdn_tpu_torch.parallel.crdt import ABSENT
    from pushcdn_tpu_torch.parallel.frames import (
        DirectBuckets,
        FrameRing,
        mask_of_topics,
        mask_row_of,
    )
    rng = np.random.default_rng(seed)
    p = topic_weights(topics, popularity)
    B, K = shards, users_per_shard
    U = B * K

    def draw(k):
        return sorted({int(t) for t in rng.choice(topics, size=k, p=p)})

    owners = np.full((B, U), ABSENT, np.int32)
    versions = np.zeros((B, U), np.uint32)
    ids = np.full((B, U), ABSENT, np.int32)
    masks = np.zeros((B, U, words), np.uint32)
    for i in range(B):
        for u in range(i * K, i * K + K - 1):
            owners[i, u], ids[i, u] = i, i
            versions[i, u] = rng.integers(1, 4)
            first = [0] if u == i * K else []
            masks[i, u] = mask_row_of(draw(3) + first, words)
        u = ((i + 1) % B) * K + K - 1
        owners[i, u], ids[i, u] = i, i
        versions[i, u] = rng.integers(1, 4)
        masks[i, u] = mask_row_of(draw(2), words)
    case = {"owners": owners, "versions": versions, "ids": ids,
            "masks": masks}
    for li, (slots, fbytes) in enumerate(((8, 64), (3, 256))):
        parts = []
        for _ in range(B):
            ring = FrameRing(slots=slots, frame_bytes=fbytes,
                             topic_words=words)
            ring.push_broadcast(rng.bytes(int(rng.integers(1, fbytes + 1))),
                                mask_of_topics([0], words))
            for _ in range(int(rng.integers(1, slots))):
                payload = rng.bytes(int(rng.integers(1, fbytes + 1)))
                if rng.random() < 0.8:
                    ring.push_broadcast(
                        payload, mask_of_topics(draw(1 + (rng.random() < .1)),
                                                words))
                else:
                    ring.push_direct(payload, int(rng.integers(-1, U)))
            parts.append(ring.take_batch())
        for f in LANE_FIELDS:
            case[f"lane{li}_{f}"] = np.stack([getattr(b, f) for b in parts])
    parts = []
    for _ in range(B):
        bk = DirectBuckets(B, capacity=3, frame_bytes=64)
        for _ in range(int(rng.integers(0, 3 * B + 1))):
            dst = int(rng.integers(0, B))
            bk.push(dst, rng.bytes(int(rng.integers(1, 64))),
                    int(rng.integers(dst * K, dst * K + K)))
        parts.append(bk.take_batch())
    for f in DIRECT_FIELDS:
        case[f"direct0_{f}"] = np.stack([getattr(d, f) for d in parts])
    return case


def case_trees(case: dict):
    """The case's stacked numpy leaves as (state, lanes, directs)."""
    state = (case["owners"], case["versions"], case["ids"], case["masks"])
    lanes = [tuple(case[f"lane{li}_{f}"] for f in LANE_FIELDS)
             for li in range(2)]
    directs = [tuple(case[f"direct0_{f}"] for f in DIRECT_FIELDS)]
    return state, lanes, directs


def run_lane(mesh, inputs: str, out_dir: str, tag: str) -> None:
    from pushcdn_tpu_torch import convert
    from pushcdn_tpu_torch.parallel import router
    from pushcdn_tpu_torch.parallel.mesh import shard_rows

    case = dict(np.load(inputs))
    state_np, lanes_np, directs_np = case_trees(case)
    tree = (convert.router_state_from_numpy(*state_np, device="cpu"),
            tuple(convert.ingress_batch_from_numpy(*b, device="cpu")
                  for b in lanes_np),
            tuple(convert.direct_ingress_from_numpy(*d, device="cpu")
                  for d in directs_np))
    states, batches, directs = zip(*shard_rows(mesh, tree))
    for fused in (True, False):
        step = router.MeshLaneStep(mesh, fused=fused)
        before = router.trace_collectives()
        out = step(states, batches, directs)
        saved = {"collectives": router.trace_collectives() - before,
                 "shards": np.asarray(mesh.local_indices)}
        for k, r in zip(mesh.local_indices, out):
            for name, lanes in (("lane", r.lanes),
                                ("direct", r.direct_lanes)):
                for li, lane in enumerate(lanes):
                    for f in ("deliver", "gathered_length",
                              "gathered_bytes"):
                        saved[f"{k}_{name}{li}_{f}"] = \
                            getattr(lane, f).cpu().numpy()
            for f, x in zip(("owners", "versions", "ids", "masks"),
                            convert.router_state_to_numpy(r.state)):
                saved[f"{k}_{f}"] = x
            saved[f"{k}_evictions"] = r.evictions.cpu().numpy()
        schedule = "fused" if fused else "per-array"
        np.savez(os.path.join(out_dir, f"{tag}-{schedule}.npz"), **saved)


def run_group(mesh, inputs: str, out_dir: str, tag: str) -> None:
    from pushcdn_tpu_torch.broker.mesh_group import MeshGroup, MeshGroupConfig
    from pushcdn_tpu_torch.broker.multihost_group import MultiHostBrokerGroup
    from pushcdn_tpu_torch.ops import delivery_kernel as dk
    from pushcdn_tpu_torch.parallel.multihost import exchange_transport
    from pushcdn_tpu_torch.parallel.router import exchange_seconds

    with open(inputs, "rb") as f:
        script = pickle.load(f)
    group = MultiHostBrokerGroup(mesh, MeshGroupConfig(**script["config"]))
    K = group.slots_per_shard
    claimed = [0] * mesh.size
    for key, shard, topics in script["users"]:
        slot = shard * K + claimed[shard]
        claimed[shard] += 1
        if shard in group.local_shards:
            group.claim_user(shard, key, topics)
            assert group.slots.slot_of(key) == slot, (key, slot)
        else:
            group._remote_slots[key] = slot   # the directory's mirror
    local_keys = {group.slots.slot_of(k): k for k, s, _ in script["users"]
                  if s in group.local_shards}
    ticks, rows = [], []
    for per_shard in script["ticks"]:
        t0 = time.perf_counter()
        for s in group.local_shards:
            # the socket-free staging API (MeshBrokerGroup's takes
            # messages)
            res = MeshGroup.stage_batch(group, s, per_shard[s])
            assert all(r.name == "STAGED" for r in res), (s, res)
        stage_s = time.perf_counter() - t0
        x0, l0 = exchange_seconds(), dk.LAUNCHES
        out = group.step()
        x1 = exchange_seconds()
        ticks.append([(d.shard, d.lane, d.direct,
                       [local_keys[int(u)] for u in d.users], d.frames,
                       d.length, zlib.crc32(np.ascontiguousarray(d.bytes_)))
                      for d in out])
        rows.append((stage_s, *group.last_step_seconds,
                     group.collectives_last_step,
                     x1["stage"] - x0["stage"],
                     x1["collective"] - x0["collective"],
                     dk.LAUNCHES - l0))
    with open(os.path.join(out_dir, f"{tag}.pkl"), "wb") as f:
        pickle.dump({"ticks": ticks, "rows": rows,
                     "local_shards": group.local_shards,
                     "transport": exchange_transport(mesh)}, f)


def main(argv=None) -> int:
    args = worker_args(argv)
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=("lane", "group"))
    p.add_argument("out_dir")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--device", default=None,
                   help="the local shards' device (default: CUDA)")
    own = p.parse_args(args.rest)

    import torch.distributed as dist

    from pushcdn_tpu_torch._device import resolve_device
    from pushcdn_tpu_torch.parallel.multihost import (
        initialize,
        pod_broker_mesh,
    )
    device = resolve_device(own.device)   # before the join: fail alone
    initialize(args.init, args.world, args.rank)
    if own.mode == "lane":
        shards = len(np.load(own.inputs[0])["owners"])
    else:
        with open(own.inputs[0], "rb") as f:
            shards = pickle.load(f)["shards"]
    mesh = pod_broker_mesh(
        shards, local_devices=[device] * -(-shards // args.world))
    run = run_lane if own.mode == "lane" else run_group
    for i, inputs in enumerate(own.inputs):
        run(mesh, inputs, own.out_dir, f"rank{args.rank}-{i}")
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {args.rank}: LOCKSTEP OK ({own.mode})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
