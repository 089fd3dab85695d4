"""Broker binary (parity cdn-broker/src/binaries/broker.rs:21-131).

    python -m pushcdn_tpu_torch.bin.broker \
        --discovery-endpoint /tmp/cdn.sqlite \
        --public-advertise-endpoint local_ip:1738 --public-bind-endpoint 0.0.0.0:1738 \
        --private-advertise-endpoint local_ip:1739 --private-bind-endpoint 0.0.0.0:1739 \
        --device-plane

A copy of ``pushcdn_tpu.bin.broker`` for one single-process broker. The
device plane runs on ``--device`` (default: CUDA; the process exits
non-zero without it rather than serve on the CPU unasked), and
``PUSHCDN_DELIVERY_IMPL`` (``auto``, ``dense`` or ``ragged``) picks its
delivery step. On SIGINT/SIGTERM the broker drains and logs one
``device plane exit`` line: the plane's steps, the messages it routed,
its steps' median parts, this process's launches of each kernel, whether
the native host routines loaded (``native``) and how many of its busy
steps egressed through the native encoder (``native_egress_steps`` of
``busy_steps``); ``broker serving`` gives the same after the warm-up.

``--mesh-shards N`` makes the broker a shard of a multi-process mesh
group instead (``broker.multihost_group``): every broker process of the
deployment joins one process group (``--multihost-coordinator``,
``--multihost-process-id``, ``--multihost-num-processes``), builds the
same global mesh of N shards and attaches to a local shard
(``--mesh-shard``, default the first); the inter-broker plane is the
mesh step, so no host broker links form. Each process contributes every
visible CUDA card once, or with ``--device`` its N / processes shards
folded onto that one device.

``--shards N`` (or ``PUSHCDN_SHARDS``) runs one broker identity as N
worker OS processes (worker shards, ``broker.sharding``): this process
becomes their supervisor, which spawns ``python -m
pushcdn_tpu_torch.bin.broker`` once per worker with the hidden
``--shard-index``/``--shard-ipc`` flags, relays interest deltas between
them and serves ``/metrics``, ``/healthz``, ``/readyz`` and
``/debug/topology`` merged over the workers (each worker's own endpoint
sits on the next ports). Worker 0 owns the mesh links; users spread over
the workers through ``SO_REUSEPORT``, or through the supervisor's
fd-handoff acceptor where the platform lacks it (``tcp`` users only).
It is a host data plane feature: with ``--device-plane`` or
``--mesh-shards`` the binary refuses to start, and no process of a
sharded broker imports torch.

The drain signals are installed before the broker starts, so a signal
during the plane's warm-up drains too. A drain leaves discovery and sends
every connected user a ``Migrate`` to the least-loaded live peer, with a
permit issued for it (``broker.rehome``; a ``--shards`` worker re-homes
its own shard's users when the supervisor forwards the signal), and logs
one ``drain re-home`` line. Admission control and the durable topics'
retention rings follow their ``PUSHCDN_MAX_CONNS_*``,
``PUSHCDN_SUBSCRIBE_*``, ``PUSHCDN_SHED_READY_S`` and
``PUSHCDN_RETAIN_*`` knobs. ``--io-impl`` (or ``PUSHCDN_IO_IMPL``) puts
the tcp links on the io_uring engine: ``uring`` insists and fails naming
the kernel's errno where io_uring is denied, ``auto`` demotes to asyncio
with one warning. ``--pump auto`` lets the fused native pump route a
plane-less broker's chunks on that engine. With a device plane, the
plane's egress streams leave through the same engine.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import statistics
import sys

from pushcdn_tpu_torch.bin.common import (
    add_io_impl_flag,
    add_pump_flag,
    apply_io_impl,
    apply_pump,
    drain_grace_s,
    init_logging,
    install_drain_signals,
    keypair_from_seed,
    run_def_from_args,
    tune_gc,
)
from pushcdn_tpu_torch.broker.broker import GIB, Broker, BrokerConfig
from pushcdn_tpu_torch.proto.error import Error

logger = logging.getLogger("pushcdn.broker")

DELIVERY_IMPLS = ("auto", "dense", "ragged")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pushcdn-broker", description=__doc__)
    p.add_argument("--discovery-endpoint", required=True,
                   help="sqlite path or redis:// URL")
    p.add_argument("--public-advertise-endpoint", default="local_ip:1738")
    p.add_argument("--public-bind-endpoint", default="0.0.0.0:1738")
    p.add_argument("--private-advertise-endpoint", default="local_ip:1739")
    p.add_argument("--private-bind-endpoint", default="0.0.0.0:1739")
    p.add_argument("--metrics-bind-endpoint", default=None)
    p.add_argument("--broker-transport", default="tcp")
    p.add_argument("--user-transport", default="tcp+tls")
    p.add_argument("--num-topics", type=int, default=256)
    p.add_argument("--key-seed", type=int, default=0,
                   help="deployment broker key seed (all brokers must match)")
    p.add_argument("--ca-cert-path", default=None)
    p.add_argument("--ca-key-path", default=None)
    p.add_argument("--global-memory-pool-size", type=int, default=GIB,
                   help="bytes (default 1 GiB, parity broker.rs:67-72)")
    p.add_argument("--global-permits", action="store_true")
    p.add_argument("--scheme", default="ed25519",
                   help="signature scheme: ed25519 | bls-bn254")
    p.add_argument("--heartbeat-interval", type=float, default=10.0,
                   help="discovery heartbeat cadence in seconds; chaos "
                        "drills shrink it so a killed broker ages out of "
                        "placement quickly")
    p.add_argument("--membership-ttl", type=float, default=60.0,
                   help="discovery membership TTL in seconds (parity "
                        "heartbeat.rs 60 s)")
    p.add_argument("--sync-interval", type=float, default=10.0,
                   help="mesh anti-entropy cadence in seconds (partial "
                        "user/topic syncs + LedgerSync balance sheets); "
                        "audit drills shrink it so conservation sheets "
                        "propagate quickly")
    # ---- sharded data plane (worker shards) -----------------------------
    p.add_argument("--shards", type=int, default=None,
                   help="shard the data plane across N worker OS "
                        "processes (default: PUSHCDN_SHARDS or 1, one "
                        "process). Shard 0 owns the mesh; users spread "
                        "across workers via SO_REUSEPORT (or parent "
                        "fd-handoff)")
    p.add_argument("--shard-index", type=int, default=None,
                   help=argparse.SUPPRESS)  # internal: worker role
    p.add_argument("--shard-ipc", default=None,
                   help=argparse.SUPPRESS)  # internal: worker IPC spec
    # ---- device data plane ----------------------------------------------
    p.add_argument("--device-plane", action="store_true",
                   help="route eligible messages through the device plane "
                        "(PUSHCDN_DELIVERY_IMPL=auto|dense|ragged picks its "
                        "delivery step)")
    p.add_argument("--device", default=None,
                   help="the plane's torch device (default: cuda; pass cpu "
                        "to run the plain PyTorch step on the CPU)")
    p.add_argument("--device-ring-slots", type=int, default=None,
                   help="staging ring slots per step (default 1024)")
    p.add_argument("--device-frame-bytes", type=int, default=None,
                   help="frame slot bytes (default 2048)")
    p.add_argument("--device-batch-window", type=float, default=None,
                   help="seconds. Single-shard: the coalescing window for "
                        "trickle traffic (bursts and idle arrivals skip "
                        "it; default 1 ms). Mesh group: the lockstep step "
                        "cadence every process ticks at (default 1 ms)")
    # ---- multi-process mesh group (torch.distributed) -----------------
    p.add_argument("--multihost-coordinator", default=None,
                   help="host:port of the process group's rendezvous "
                        "(rank 0 serves it); with --mesh-shards, joins "
                        "the multi-process mesh broker group")
    p.add_argument("--multihost-process-id", type=int, default=None)
    p.add_argument("--multihost-num-processes", type=int, default=None)
    p.add_argument("--mesh-shards", type=int, default=None,
                   help="global broker-mesh shard count; this broker "
                        "attaches to --mesh-shard (default: the first "
                        "local shard)")
    p.add_argument("--mesh-shard", type=int, default=None)
    add_io_impl_flag(p)
    add_pump_flag(p)
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


def delivery_impl_from_env() -> str:
    """``PUSHCDN_DELIVERY_IMPL``, the JAX plane's override, read here in
    the binary: the port's names only (empty means ``auto``)."""
    impl = os.environ.get("PUSHCDN_DELIVERY_IMPL", "") or "auto"
    if impl not in DELIVERY_IMPLS:
        raise SystemExit(f"PUSHCDN_DELIVERY_IMPL={impl!r}; pick from "
                         f"{list(DELIVERY_IMPLS)}")
    return impl


def kernel_launches() -> dict:
    """This process's launches of each kernel so far. A kernel whose
    module never loaded launched nothing, and reading its count must not
    load it: that would import torch into a broker without a plane."""
    out = {}
    for kernel, module in (("delivery_matrix_cuda", "delivery_kernel"),
                           ("ragged_delivery_cuda", "ragged_delivery")):
        mod = sys.modules.get(f"pushcdn_tpu_torch.ops.{module}")
        out[kernel] = mod.LAUNCHES if mod is not None else 0
    return out


def log_plane(what: str, plane) -> None:
    """One line of JSON after ``what``: the plane's counters (for a mesh
    group's shard, the group's), the medians of its recent steps' parts
    in ms, this process's kernel launches, whether the native host
    routines loaded and the steps egressed through their encoder, the
    card's name for a plane on CUDA (``card``), the
    frames the plane's recent steps routed (``plane_frames``) and the
    frames the receive loops took, by route path (``route_frames``; under
    a plane every received frame counts as ``scalar``, staged or not)."""
    from pushcdn_tpu_torch import native
    from pushcdn_tpu_torch.proto import metrics as metrics_mod
    fields = dict(launches=kernel_launches(), native=native.available(),
                  route_frames={p: metrics_mod.ROUTE_FRAMES.labels(
                      path=p).value for p in ("cutthrough", "residual",
                                              "scalar")})
    if plane is not None:
        group = getattr(plane, "group", None)
        owner = plane if group is None else group
        fields.update(steps=plane.steps, messages_routed=plane.messages_routed,
                      disabled=plane.disabled, busy_steps=owner.busy_steps,
                      native_egress_steps=owner.native_egress_steps,
                      plane_frames=sum(st.frames for st in owner.recent_steps))
        if group is None:
            fields.update(delivery_impl=plane.delivery_impl,
                          device=str(plane.device))
            if plane.device.type == "cuda":
                import torch
                fields["card"] = torch.cuda.get_device_name(plane.device)
        else:
            from pushcdn_tpu_torch.parallel.multihost import (
                exchange_transport,
            )
            mesh = group.mesh
            fields.update(shard=plane.shard, mesh_shards=mesh.size,
                          local_shards=mesh.local_indices,
                          devices=[str(d) for d in mesh.local_devices],
                          exchange=exchange_transport(mesh),
                          collectives_last_step=group.collectives_last_step)
        if owner.recent_steps:
            fields["step_ms_median"] = {
                part: statistics.median(getattr(s, part + "_s")
                                        for s in owner.recent_steps) * 1e3
                for part in ("snapshot", "device", "pairs", "egress")}
    logger.info("%s %s", what, json.dumps(fields))


def check_mesh_flags(args: argparse.Namespace) -> None:
    """The JAX binary's rules for the mesh-group flags."""
    if args.device_plane and args.mesh_shards is not None:
        raise SystemExit("--device-plane (single-shard) and --mesh-shards "
                         "(mesh group) are mutually exclusive")
    if args.mesh_shard is not None and args.mesh_shards is None:
        raise SystemExit("--mesh-shard requires --mesh-shards")


def attach_mesh_group(args: argparse.Namespace, broker: Broker) -> None:
    """Join the process group, build the global mesh and attach
    ``broker`` to its shard (``--mesh-shards``)."""
    from pushcdn_tpu_torch.broker.mesh_group import MeshGroupConfig
    from pushcdn_tpu_torch.broker.multihost_group import MultiHostBrokerGroup
    from pushcdn_tpu_torch.parallel import multihost

    try:
        multihost.initialize(args.multihost_coordinator,
                             args.multihost_num_processes,
                             args.multihost_process_id)
    except Error as exc:
        raise SystemExit(f"--multihost-*: {exc}") from None
    local_devices = None
    if args.device is not None:
        processes = multihost.process_count()
        if args.mesh_shards % processes:
            raise SystemExit(f"--mesh-shards {args.mesh_shards} does not "
                             f"split over {processes} processes")
        local_devices = [args.device] * (args.mesh_shards // processes)
    try:
        mesh = multihost.pod_broker_mesh(args.mesh_shards,
                                         local_devices=local_devices)
    except (Error, RuntimeError) as exc:
        raise SystemExit(f"--mesh-shards: {exc}") from None
    group = MultiHostBrokerGroup(mesh, MeshGroupConfig(**plane_overrides(
        args)), discovery=broker.discovery)
    shard = (args.mesh_shard if args.mesh_shard is not None
             else group.local_shards[0])
    if shard not in group.local_shards:
        raise SystemExit(
            f"--mesh-shard {shard} is not local to this process (local "
            f"shards: {group.local_shards}); a non-local attachment would "
            "silently blackhole traffic")
    group.attach(broker, shard)


def plane_overrides(args: argparse.Namespace) -> dict:
    out = {}
    if args.device_ring_slots is not None:
        out["ring_slots"] = args.device_ring_slots
    if args.device_frame_bytes is not None:
        out["frame_bytes"] = args.device_frame_bytes
    if args.device_batch_window is not None:
        out["batch_window_s"] = args.device_batch_window
    return out


def _worker_argv_base() -> list:
    """This process's argv minus the flags the supervisor rewrites per
    worker (--shards; --metrics-bind-endpoint is reassigned per shard)."""
    argv = []
    skip = False
    for a in sys.argv[1:]:
        if skip:
            skip = False
            continue
        if a in ("--shards", "--metrics-bind-endpoint"):
            skip = True
            continue
        if a.startswith("--shards=") or \
                a.startswith("--metrics-bind-endpoint="):
            continue
        argv.append(a)
    return argv


async def run_supervisor(args: argparse.Namespace, shards: int) -> None:
    """Parent of a sharded broker: spawn N workers, relay control-plane
    deltas, aggregate observability, propagate drains."""
    from pushcdn_tpu_torch.broker import sharding

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ["PYTHONPATH"] = (
        repo + os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else repo)
    base = _worker_argv_base()

    def worker_argv(shard: int, spec_json: str, metrics_endpoint):
        argv = [sys.executable, "-m", "pushcdn_tpu_torch.bin.broker", *base,
                "--shard-index", str(shard), "--shard-ipc", spec_json]
        if metrics_endpoint:
            argv += ["--metrics-bind-endpoint", metrics_endpoint]
        return argv

    acceptor = None
    if not sharding.reuseport_available():
        if args.user_transport != "tcp":
            # the handoff acceptor deals RAW TCP fds; a TLS/QUIC user
            # transport would silently answer handshakes in plaintext
            # (or never accept at all) — refuse loudly instead
            raise SystemExit(
                "--shards without SO_REUSEPORT uses the parent fd-handoff "
                "acceptor, which supports only --user-transport tcp "
                f"(got {args.user_transport!r}); use a platform with "
                "SO_REUSEPORT for TLS/QUIC user transports")
        acceptor = args.public_bind_endpoint
    sup = sharding.ShardSupervisor(
        shards, args.metrics_bind_endpoint, worker_argv,
        acceptor_endpoint=acceptor)
    try:
        await sup.start()
    except BaseException:
        # half-started (e.g. parent metrics bind EADDRINUSE after the
        # workers spawned): kill whatever came up and unlink the rings —
        # REUSEPORT workers would otherwise keep serving as orphans
        sup.signal_workers()
        await sup.reap(5.0)
        await sup.stop()
        raise
    drain = asyncio.Event()
    installed = install_drain_signals(drain, on_signal=sup.begin_drain)
    exit_task = asyncio.create_task(sup.wait_any_worker_exit(),
                                    name="shard-reaper")
    drain_task = asyncio.create_task(drain.wait(), name="drain-wait")
    try:
        await asyncio.wait({exit_task, drain_task},
                           return_when=asyncio.FIRST_COMPLETED)
        if installed and drain.is_set():
            # workers flipped not-ready on the forwarded SIGTERM and are
            # serving out the grace window; reap them BEFORE the parent's
            # aggregated endpoint goes away
            await sup.reap(drain_grace_s() + 15.0)
            await sup.stop()
            return
        rc = exit_task.result() if exit_task.done() else 1
        sup.signal_workers()
        await sup.reap(5.0)
        await sup.stop()
        raise SystemExit(rc if rc not in (0, None) else 1)
    finally:
        for t in (exit_task, drain_task):
            t.cancel()


async def amain(args: argparse.Namespace) -> None:
    from pushcdn_tpu_torch.broker import sharding

    shards = sharding.shards_from_env(args.shards)
    if shards > 1 and (args.device_plane or args.mesh_shards is not None):
        raise SystemExit("--shards is a host-data-plane feature; combine "
                         "with --device-plane/--mesh-shards once the "
                         "device plane learns shard-local staging")
    if args.shard_index is None and shards > 1:
        await run_supervisor(args, shards)
        return
    check_mesh_flags(args)
    spec = None
    if args.shard_index is not None:
        if not args.shard_ipc:
            raise SystemExit("--shard-index is internal (spawned by "
                             "--shards); it requires --shard-ipc")
        spec = json.loads(args.shard_ipc)
        # per-worker span log: the workers inherit the parent's
        # PUSHCDN_TRACE_LOG — suffix it so two shards never interleave
        # writes in one JSONL (proto.trace reads the env at import, but
        # lazily opens the file, so adjusting here is race-free)
        trace_path = os.environ.get("PUSHCDN_TRACE_LOG")
        if trace_path:
            from pushcdn_tpu_torch.proto import trace as trace_mod
            root, ext = os.path.splitext(trace_path)
            trace_mod._LOG_PATH = f"{root}-shard{spec['shard']}{ext}"
    run_def = run_def_from_args(args.broker_transport, args.user_transport,
                                args.discovery_endpoint, args.num_topics,
                                args.global_permits, scheme=args.scheme)
    device_plane = None
    if args.device_plane:
        from pushcdn_tpu_torch._device import resolve_device
        from pushcdn_tpu_torch.broker.device_plane import DevicePlaneConfig
        try:
            resolve_device(args.device)
        except RuntimeError as exc:
            raise SystemExit(f"--device-plane: {exc}") from None
        device_plane = DevicePlaneConfig(
            delivery_impl=delivery_impl_from_env(), **plane_overrides(args))
    broker = await Broker.new(BrokerConfig(
        run_def=run_def,
        keypair=keypair_from_seed(args.key_seed, args.scheme),
        discovery_endpoint=args.discovery_endpoint,
        public_advertise_endpoint=args.public_advertise_endpoint,
        public_bind_endpoint=args.public_bind_endpoint,
        private_advertise_endpoint=args.private_advertise_endpoint,
        private_bind_endpoint=args.private_bind_endpoint,
        metrics_bind_endpoint=args.metrics_bind_endpoint,
        ca_cert_path=args.ca_cert_path, ca_key_path=args.ca_key_path,
        global_memory_pool_size=args.global_memory_pool_size,
        heartbeat_interval_s=args.heartbeat_interval,
        membership_ttl_s=args.membership_ttl,
        sync_interval_s=args.sync_interval,
        device_plane=device_plane,
        device=args.device,
        # a mesh group's inter-broker plane is the mesh step
        form_mesh=args.mesh_shards is None,
        # worker-shard role: worker 0 owns the mesh and the control tasks
        shard_index=(spec["shard"] if spec else 0),
        num_shards=(spec["num_shards"] if spec else 1),
        bind_private=(spec is None or spec["shard"] == 0),
        reuse_port=(spec is not None and "accept_fd" not in spec),
        accept_handoff_fd=(spec.get("accept_fd") if spec else None),
    ))
    if spec is not None:
        runtime = sharding.runtime_from_spec(broker, spec)
        runtime.attach()
    if args.mesh_shards is not None:
        attach_mesh_group(args, broker)
    plane = broker.device_plane
    # Graceful drain: SIGINT/SIGTERM flips /readyz to 503 FIRST, re-homes
    # every user to a live peer, keeps serving in-flight traffic for
    # PUSHCDN_DRAIN_GRACE_S, then stops — so a load balancer stops routing
    # before the listeners close. The signals go in BEFORE the broker
    # starts: on the card start() warms the plane up and builds its
    # kernels, and a signal in that window must drain, not kill.
    drain = asyncio.Event()
    installed = install_drain_signals(drain)

    async def serve() -> None:
        # the plane warms up here; on the card a kernel that does not
        # build or launch raises, and the process exits non-zero
        await broker.start()
        log_plane("broker serving", plane)
        await broker.wait_until_failure()

    if not installed:
        await serve()
        return
    run_task = asyncio.create_task(serve(), name="broker-run")
    drain_task = asyncio.create_task(drain.wait(), name="drain-wait")
    try:
        await asyncio.wait({run_task, drain_task},
                           return_when=asyncio.FIRST_COMPLETED)
        if drain.is_set():
            broker.begin_drain("signal")
            # elastic drain: actively re-home every connected user to the
            # surviving brokers before the grace sleep — the UserSync
            # evictions land while we're still serving
            try:
                from pushcdn_tpu_torch.broker import rehome as rehome_mod
                await rehome_mod.rehome_users(broker)
            except Exception as exc:
                logger.warning("drain re-home failed: %r", exc)
            await asyncio.sleep(drain_grace_s())
            run_task.cancel()
            await asyncio.gather(run_task, return_exceptions=True)
            await broker.stop()
            log_plane("device plane exit", plane)
        else:
            await run_task  # re-raise the core-task failure
    finally:
        drain_task.cancel()


def main() -> None:
    args = build_parser().parse_args()
    init_logging(args.verbose)
    apply_io_impl(args)
    apply_pump(args)
    tune_gc()
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
