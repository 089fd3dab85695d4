"""Worker: one process of a multi-process broker group serving users.

    python -m pushcdn_tpu_torch.testing.burst_worker \\
        --rank R --world 2 --init file:///tmp/rdv <plan.pkl> <out_dir> \\
        [--device cuda:0]

Every process builds the global mesh (its share of the plan's shards
folded onto ``--device``, the card unless it names another, raising
without CUDA), one ``MultiHostBrokerGroup`` over it with the plan's
``MeshGroupConfig`` and a ``Broker`` on each local shard (Memory
transport, no host links), and injects the plan's users of its shards
over the Memory transport as the test harness does (user ``uid`` on
shard ``uid % shards``, key ``keys[uid]``). Then, for each burst of the
plan, in step with the other processes (file barriers in ``out_dir``):
its publishers send their frames (each payload ends in phase 8's tail,
``<IIq``: publisher, sequence, send time in ``perf_counter_ns``, the
time written at send), and it waits until each of its users has
received what the plan expects. A burst on other topics than the last
first moves every local user to them (unsubscribe, then subscribe, at
its broker). After the bursts it measures the idle lockstep tick, stops
its brokers and writes what its users received and how the group ran to
``<out_dir>/rank<R>.pkl``; the parent checks it against its oracle.

The plan (a pickled dict): ``config`` (MeshGroupConfig fields),
``shards``, ``num_topics``, ``db`` (the discovery file every process
shares), ``keys``,
``topics`` ({popularity: per-uid topic lists}), ``first`` (the
popularity users start with), ``frame_bytes`` (the base lane's width,
which sorts deliveries into lanes), and ``bursts``: per burst its
``popularity``, ``frames`` ({publisher uid: wire frames}) and ``expect``
(per-uid delivery counts).
"""

from __future__ import annotations

import argparse
import asyncio
import os
import pickle
import struct
import sys
import time

import numpy as np

from pushcdn_tpu_torch.testing.two_host import worker_args

TAIL = struct.Struct("<IIq")


async def barrier(out_dir: str, name: str, rank: int, world: int,
                  timeout_s: float = 180.0) -> None:
    open(os.path.join(out_dir, f"barrier-{name}-{rank}"), "w").close()
    deadline = time.monotonic() + timeout_s
    while not all(os.path.exists(os.path.join(out_dir, f"barrier-{name}-{r}"))
                  for r in range(world)):
        if time.monotonic() > deadline:
            raise TimeoutError(f"barrier {name!r} not reached in {timeout_s} s")
        await asyncio.sleep(0.005)


async def serve(plan: dict, out_dir: str, rank: int, world: int, mesh) -> dict:
    from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
    from pushcdn_tpu_torch.broker.mesh_group import MeshGroupConfig
    from pushcdn_tpu_torch.broker.multihost_group import MultiHostBrokerGroup
    from pushcdn_tpu_torch.broker.tasks.handlers import user_receive_loop
    from pushcdn_tpu_torch.ops import delivery_kernel as dk
    from pushcdn_tpu_torch.parallel.multihost import exchange_transport
    from pushcdn_tpu_torch.parallel.router import trace_collectives
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.def_ import testing_run_def
    from pushcdn_tpu_torch.proto.discovery.embedded import Embedded
    from pushcdn_tpu_torch.proto.message import KIND_DIRECT
    from pushcdn_tpu_torch.proto.topic import TopicSpace
    from pushcdn_tpu_torch.proto.transport.memory import (
        Memory,
        gen_testing_connection_pair,
    )
    from pushcdn_tpu_torch.proto.util import AbortOnDropHandle

    B, keys = plan["shards"], plan["keys"]
    base = plan["frame_bytes"]
    Memory.set_duplex_window(256 * 1024)   # as phase 8 widens the pipes
    group = MultiHostBrokerGroup(
        mesh, MeshGroupConfig(**plan["config"]),
        discovery=await Embedded.new(plan["db"]), directory_refresh_s=0.25)
    # every step's (collectives, dense launches, end time), appended when
    # it ends, so a window's entries are whole steps
    counts = []
    step = group.step_fn

    def counted(*args):
        before, launched = trace_collectives(), dk.LAUNCHES
        out = step(*args)
        counts.append((trace_collectives() - before, dk.LAUNCHES - launched,
                       time.perf_counter()))
        return out
    group.step_fn = counted

    topics_of = plan["topics"][plan["first"]]
    run_def = testing_run_def(topics=TopicSpace.range(plan["num_topics"]))
    brokers = {}
    for s in group.local_shards:
        ep = f"mh-{os.getpid()}-b{s}"
        b = await Broker.new(BrokerConfig(
            run_def=run_def, keypair=DEFAULT_SCHEME.generate_keypair(seed=90),
            discovery_endpoint=plan["db"],
            public_advertise_endpoint=f"{ep}-pub",
            public_bind_endpoint=f"{ep}-pub",
            private_advertise_endpoint=f"{ep}-priv",
            private_bind_endpoint=f"{ep}-priv",
            heartbeat_interval_s=3600, sync_interval_s=3600,
            whitelist_interval_s=3600, form_mesh=False))
        group.attach(b, s)
        brokers[s] = b
    warm = dk.LAUNCHES
    for b in brokers.values():   # the group warms up once, collectively
        await b.start()
    warm_launches = dk.LAUNCHES - warm

    mine = [uid for uid in range(len(keys)) if uid % B in brokers]
    remotes = {}
    for uid in mine:
        broker = brokers[uid % B]
        local, remote = await gen_testing_connection_pair(broker.limiter)
        task = asyncio.create_task(
            user_receive_loop(broker, keys[uid], local))
        broker.connections.add_user(keys[uid], local, list(topics_of[uid]),
                                    AbortOnDropHandle(task))
        remotes[uid] = remote
    got = {uid: [] for uid in mine}
    got_direct = {uid: [] for uid in mine}
    got_bytes = {uid: 0 for uid in mine}
    latency_ns = []
    last_ns = [0]
    seen = [0]   # frames received by this process's users

    async def drain(uid, remote):
        box, direct = got[uid], got_direct[uid]
        while True:
            raws = await remote.recv_raw_many()
            now = time.perf_counter_ns()
            for raw in raws:
                d = raw.data
                pub, seq, sent = TAIL.unpack_from(d, len(d) - TAIL.size)
                box.append(((pub * 2 + (len(d) > base)) << 32) | seq)
                direct.append(d[0] & 0x7F == KIND_DIRECT)
                got_bytes[uid] += len(d)
                latency_ns.append(now - sent)
                raw.release()
            seen[0] += len(raws)
            last_ns[0] = now

    drains = [asyncio.create_task(drain(uid, r)) for uid, r in remotes.items()]
    # every remote user's slot must be in this process's directory mirror
    # before a direct to it is staged
    n_remote = len(keys) - len(mine)
    async with asyncio.timeout(120):
        while len(group._remote_slots) < n_remote:
            await asyncio.sleep(0.05)
    await barrier(out_dir, "ready", rank, world)

    rows = []
    recent0 = len(group.recent_steps)
    exchange0 = len(group.recent_exchange)
    barrier0 = len(group.recent_barrier)
    routed0, counts0 = group.messages_routed, len(counts)
    busy0, native0 = group.busy_steps, group.native_egress_steps
    current = plan["first"]
    for i, burst in enumerate(plan["bursts"]):
        if burst["popularity"] != current:
            now_topics = plan["topics"][burst["popularity"]]
            for uid in mine:
                conns = brokers[uid % B].connections
                gone = sorted(set(topics_of[uid]) - set(now_topics[uid]))
                if gone:
                    conns.unsubscribe_user_from(keys[uid], gone)
                conns.subscribe_user_to(keys[uid], list(now_topics[uid]))
            topics_of, current = now_topics, burst["popularity"]
        want = seen[0] + int(sum(burst["expect"][uid] for uid in mine))
        lat0 = len(latency_ns)
        await barrier(out_dir, f"burst{i}", rank, world)
        t0 = time.perf_counter_ns()
        for pub, frames in burst["frames"].items():
            if pub in remotes:
                stamp = struct.pack("<q", time.perf_counter_ns())
                await remotes[pub].send_raw_many(
                    [f[:-8] + stamp for f in frames])
        async with asyncio.timeout(300):
            while seen[0] < want:
                await asyncio.sleep(0.002)
        rows.append(dict(start_ns=t0, last_ns=last_ns[0],
                         latency_from=lat0, latency_to=len(latency_ns)))
        await barrier(out_dir, f"burst{i}-done", rank, world)
    await asyncio.sleep(0.2)   # a duplicate or a stray frame lands here
    busy = dict(
        steps=len(counts) - counts0,
        recent_steps=[tuple(s) for s in list(group.recent_steps)[recent0:]],
        exchange=list(group.recent_exchange)[exchange0:],
        barrier=list(group.recent_barrier)[barrier0:],
        collectives=[c for c, _, _ in counts[counts0:]],
        launches_per_step=[n for _, n, _ in counts[counts0:]],
        routed=group.messages_routed - routed0,
        busy_steps=group.busy_steps - busy0,
        native_egress_steps=group.native_egress_steps - native0)
    # the idle lockstep tick: the mean interval between the steps that
    # end in one quiet second
    idle0 = len(counts)
    recent1, exchange1 = len(group.recent_steps), len(group.recent_exchange)
    barrier1, wake1 = len(group.recent_barrier), len(group.recent_wake_lag)
    directory1 = len(group.recent_directory)
    await asyncio.sleep(1.0)
    ends = [t for _, _, t in counts[idle0:]]
    idle = dict(steps=max(len(ends) - 1, 0),
                seconds=ends[-1] - ends[0] if ends else 0.0,
                recent_steps=[tuple(s) for s in
                              list(group.recent_steps)[recent1:]],
                exchange=list(group.recent_exchange)[exchange1:],
                barrier=list(group.recent_barrier)[barrier1:],
                wake_lag=list(group.recent_wake_lag)[wake1:],
                directory=list(group.recent_directory)[directory1:])
    host_links = [b.connections.num_brokers for b in brokers.values()]
    disabled = group.disabled
    for t in drains:
        t.cancel()
    await asyncio.gather(*drains, return_exceptions=True)
    for r in remotes.values():
        r.close()
    await barrier(out_dir, "stop", rank, world)
    for b in brokers.values():
        await b.stop()
    await group.discovery.close()
    return dict(rank=rank, local_shards=group.local_shards, got=got,
                got_direct=got_direct, got_bytes=got_bytes,
                latency_ns=np.asarray(latency_ns, np.int64), bursts=rows,
                busy=busy, idle=idle, host_links=host_links,
                disabled=disabled, warm_launches=warm_launches,
                transport=exchange_transport(mesh),
                batch_window_s=group.config.batch_window_s)


def main(argv=None) -> int:
    args = worker_args(argv)
    p = argparse.ArgumentParser()
    p.add_argument("plan")
    p.add_argument("out_dir")
    p.add_argument("--device", default=None,
                   help="the local shards' device (default: CUDA)")
    own = p.parse_args(args.rest)

    from pushcdn_tpu_torch._device import resolve_device
    from pushcdn_tpu_torch.parallel.multihost import (
        initialize,
        pod_broker_mesh,
    )
    device = resolve_device(own.device)   # before the join: fail alone
    with open(own.plan, "rb") as f:
        plan = pickle.load(f)
    initialize(args.init, args.world, args.rank)
    shards = plan["shards"]
    mesh = pod_broker_mesh(
        shards, local_devices=[device] * -(-shards // args.world))
    out = asyncio.run(serve(plan, own.out_dir, args.rank, args.world, mesh))
    with open(os.path.join(own.out_dir, f"rank{args.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    print(f"rank {args.rank}: BURSTS OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
