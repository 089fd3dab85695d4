"""Worker: one process of the two-process deployment
(``testing.two_host``).

    python -m pushcdn_tpu_torch.testing.two_host_worker \\
        --rank R --world 2 --init file:///tmp/rdv <mode> <db> <tmp_dir> \\
        [--watchdog 20] [--device cpu]

Modes:

- ``deploy`` (the twin of ``tests/_multihost_worker.py``): a broadcast
  published by rank 0's client reaches rank 1's client through the mesh
  step alone, a direct from rank 1 crosses back to rank 0 through the
  discovery user-slot directory and rank 0 answers, both brokers hold
  zero host broker links throughout; then rank 0 retires, and the stop
  barrier disables rank 1's group on the same tick, after which its
  staging answers INELIGIBLE. Prints ``rank R: MULTIHOST OK``.
- ``kill`` (the twin of ``_multihost_kill_worker.py``): both ranks prove
  the plane with a cross-process broadcast and write ``ready-<rank>``;
  the parent SIGKILLs rank 1. Rank 0 must fail its group closed
  (disabled, pump ended, the halt logged with its stranded frames), keep
  serving its own client on the host path, and exit. Prints
  ``rank 0: KILL OK``.
- ``stall`` (the twin of ``_multihost_stall_worker.py``): as ``kill``,
  but rank 1 stays alive and wedges its stop barrier for good. Rank 0
  stages a frame while its barrier waits; its watchdog must fail the
  group closed within ``--watchdog`` seconds, the halt log counting that
  stranded frame, and rank 0 serves on and exits. Prints
  ``rank 0: STALL OK``.

The shards sit on ``--device`` (the card unless it names another). The
``kill`` and ``stall`` survivors serve on, which is the CPU's rule: on
the card a failed group takes its brokers down instead.

Each worker exits through ``asyncio.run``'s normal shutdown (a collective
stuck on a dead peer ends within the mesh group's timeout), so the
parent can bound the survivor's exit.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import sys
import threading
import time

from pushcdn_tpu_torch.testing.two_host import worker_args

# deterministic client identities: each process derives the other's key
CLIENT_SEEDS = {"deploy": (61_000, 62_000), "kill": (71_000, 72_000),
                "stall": (73_000, 74_000)}
BROKER_SEEDS = {"deploy": 50, "kill": 80, "stall": 85}


class HaltLog(logging.Handler):
    """Keeps the group's ``multi-host group halted`` lines."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("multi-host group halted"):
            self.lines.append(msg)


def stage_late(group, shard: int):
    """Stage one broadcast straight into the group, as a broker's receive
    loop would; returns the StageResult."""
    from pushcdn_tpu_torch.proto.limiter import Bytes
    from pushcdn_tpu_torch.proto.message import Broadcast, serialize
    late = Broadcast(topics=[0], message=b"late")
    return group.try_stage(shard, late, Bytes(serialize(late)))


async def deploy(node, rank: int) -> None:
    from pushcdn_tpu_torch.broker.staging import StageResult
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.message import Broadcast, Direct

    group, broker, client = node.group, node.broker, node.client
    await node.directory_rendezvous()
    if rank == 0:
        await client.send_broadcast_message([0], b"cross-host hello")
    got = await asyncio.wait_for(client.receive_message(), 30)
    assert isinstance(got, Broadcast), got
    assert bytes(got.message) == b"cross-host hello"
    assert broker.connections.num_brokers == 0   # zero host broker links

    peer = DEFAULT_SCHEME.generate_keypair(
        seed=CLIENT_SEEDS["deploy"][1 - rank]).public_key
    # directs are fire-and-forget: wait until this process's directory
    # mirror holds the peer's slot, or the frame drops as unroutable
    for _ in range(200):
        if group._direct_route_info(bytes(peer)) is not None:
            break
        await asyncio.sleep(0.05)
    else:
        raise AssertionError("peer slot never reached the local mirror")
    if rank == 1:
        await client.send_direct_message(peer, b"direct across hosts")
        got = await asyncio.wait_for(client.receive_message(), 30)
        assert isinstance(got, Direct) and \
            bytes(got.message) == b"ack from host 0", got
    else:
        got = await asyncio.wait_for(client.receive_message(), 30)
        assert isinstance(got, Direct) and \
            bytes(got.message) == b"direct across hosts", got
        await client.send_direct_message(peer, b"ack from host 0")
    assert broker.connections.num_brokers == 0
    assert group.steps > 0 and not group.disabled

    # neither process stops the collective before both saw their last
    # delivery (the directory doubles as the phase barrier)
    await node.publish_marker(b"done-%d" % rank)
    await node.await_markers([b"done-0", b"done-1"])
    if rank == 0:
        await node.stop()   # the stop barrier ends the collective
    else:
        # the peer's retirement stops the collective HERE on the same
        # tick and disables the group, so staging answers INELIGIBLE
        # instead of ACKing frames nothing will drain
        for _ in range(400):
            if group.disabled:
                break
            await asyncio.sleep(0.05)
        assert group.disabled, "peer retirement never disabled the group"
        assert stage_late(group, node.my_shard) == StageResult.INELIGIBLE
        await node.stop()
    print(f"rank {rank}: MULTIHOST OK (steps={group.steps}, "
          f"routed={group.messages_routed}, host_links=0)", flush=True)


async def survive(node, rank: int, mode: str, tmp: str,
                  watchdog_s: float, halts: HaltLog) -> None:
    from pushcdn_tpu_torch.broker.staging import StageResult
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.message import Broadcast, Direct

    group, broker, client = node.group, node.broker, node.client
    await node.directory_rendezvous()
    if rank == 0:
        await client.send_broadcast_message([0], b"pre-fault hello")
    got = await asyncio.wait_for(client.receive_message(), 60)
    assert isinstance(got, Broadcast) and \
        bytes(got.message) == b"pre-fault hello", got
    assert broker.connections.num_brokers == 0
    with open(os.path.join(tmp, f"ready-{rank}"), "w") as f:
        f.write("ready")

    if rank == 1:
        if mode == "stall":
            # the PERMANENT stall: every stop barrier from here on blocks
            # forever. The process stays alive with its sockets open;
            # only the survivor's watchdog can see it.
            stalled = threading.Event()

            def stall_forever(_want_stop):
                stalled.set()
                while True:
                    time.sleep(3600)

            group._collective_stop = stall_forever
            while not stalled.is_set():
                await asyncio.sleep(0.05)
            print("rank 1: STALLED (alive, wedged in the barrier)",
                  flush=True)
        await asyncio.sleep(3600)   # until the parent kills this process
        return

    # ---- rank 0: survive the peer's death or stall -------------------
    t0 = time.monotonic()
    if mode == "stall":
        # the pump now waits in a barrier the peer never enters: a frame
        # staged meanwhile is ACKed STAGED and then stranded
        steps = group.steps
        await asyncio.sleep(2 * group.config.batch_window_s + 0.2)
        while group.steps != steps:
            steps = group.steps
            await asyncio.sleep(2 * group.config.batch_window_s + 0.2)
        assert stage_late(group, node.my_shard) == StageResult.STAGED
    bound = watchdog_s + 10
    while time.monotonic() - t0 < bound and not group.disabled:
        await asyncio.sleep(0.05)
    detect_s = time.monotonic() - t0
    assert group.disabled, f"the peer's fault went unseen for {bound} s"
    print(f"MARK: disabled after {detect_s:.2f} s (watchdog "
          f"{watchdog_s} s)", flush=True)
    # clean halt: the pump task returned (its last barrier is bounded by
    # the same watchdog)
    task = group.pump_task
    for _ in range(int((watchdog_s + 10) / 0.05)):
        if task is None or task.done():
            break
        await asyncio.sleep(0.05)
    assert task is None or task.done(), "pump still running after disable"
    assert halts.lines, "the halt was not logged"
    if mode == "stall":
        assert "with 1 staged frame(s)" in halts.lines[-1], halts.lines
    print(f"MARK: halt logged: {halts.lines[-1]}", flush=True)
    assert stage_late(group, node.my_shard) == StageResult.INELIGIBLE

    # the survivor keeps serving its own client on the host path
    own = DEFAULT_SCHEME.generate_keypair(
        seed=CLIENT_SEEDS[mode][0]).public_key
    await client.send_direct_message(own, b"still served")
    got = await asyncio.wait_for(client.receive_message(), 30)
    assert isinstance(got, Direct) and bytes(got.message) == b"still served"
    await client.send_broadcast_message([0], b"local fanout works")
    got = await asyncio.wait_for(client.receive_message(), 30)
    assert isinstance(got, Broadcast) and \
        bytes(got.message) == b"local fanout works"
    assert broker.connections.num_users == 1
    await node.stop()
    print(f"rank 0: {mode.upper()} OK (detected in {detect_s:.2f} s, "
          f"steps={group.steps}, disabled clean)", flush=True)


async def amain(args, own) -> None:
    from pushcdn_tpu_torch.broker.mesh_group import MeshGroupConfig
    from pushcdn_tpu_torch.testing.two_host import make_two_host_node

    halts = HaltLog()
    logging.getLogger("pushcdn.broker.multihost").addHandler(halts)
    config = MeshGroupConfig(
        num_user_slots=64, ring_slots=8, frame_bytes=1024, extra_lanes=(),
        direct_bucket_slots=4, batch_window_s=0.02)
    node = await make_two_host_node(
        args.rank, own.db, client_seeds=CLIENT_SEEDS[own.mode],
        broker_seed_base=BROKER_SEEDS[own.mode], device=own.device,
        mesh_config=config,
        collective_timeout_s=own.watchdog)
    if own.mode == "deploy":
        await deploy(node, args.rank)
    else:
        await survive(node, args.rank, own.mode, own.tmp, own.watchdog,
                      halts)


def main(argv=None) -> int:
    args = worker_args(argv)
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=("deploy", "kill", "stall"))
    p.add_argument("db")
    p.add_argument("tmp")
    p.add_argument("--watchdog", type=float, default=20.0)
    p.add_argument("--device", default=None,
                   help="the local shards' device (default: CUDA)")
    own = p.parse_args(args.rest)
    logging.basicConfig(level=logging.WARNING, stream=sys.stdout,
                        format="%(asctime)s %(name)s %(message)s")

    from pushcdn_tpu_torch._device import resolve_device
    from pushcdn_tpu_torch.parallel.multihost import initialize
    own.device = resolve_device(own.device)   # before the join: fail alone
    initialize(args.init, args.world, args.rank)
    asyncio.run(amain(args, own))
    return 0


if __name__ == "__main__":
    sys.exit(main())
