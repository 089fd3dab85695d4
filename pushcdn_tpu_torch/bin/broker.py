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
its steps' median parts and this process's launches of each kernel
(``broker serving`` gives the same after the warm-up). Not copied yet
(ROADMAP.md, Queue A): ``--shards``, the mesh group (``--mesh-shards``,
``--multihost-*``), the io_uring and pump selectors, and the re-homing of
users on a drain.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import statistics

from pushcdn_tpu_torch.bin.common import (
    drain_grace_s,
    init_logging,
    install_drain_signals,
    keypair_from_seed,
    run_def_from_args,
    tune_gc,
)
from pushcdn_tpu_torch.broker.broker import GIB, Broker, BrokerConfig

logger = logging.getLogger("pushcdn.broker")

DELIVERY_IMPLS = ("auto", "dense", "ragged")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pushcdn-broker", description=__doc__)
    p.add_argument("--discovery-endpoint", required=True,
                   help="sqlite path")
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
                   help="signature scheme: ed25519")
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
                   help="seconds: the coalescing window for trickle "
                        "traffic (bursts and idle arrivals skip it; "
                        "default 1 ms)")
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
    """This process's launches of each kernel so far."""
    from pushcdn_tpu_torch.ops import delivery_kernel, ragged_delivery
    return {"delivery_matrix_cuda": delivery_kernel.LAUNCHES,
            "ragged_delivery_cuda": ragged_delivery.LAUNCHES}


def log_plane(what: str, plane) -> None:
    """One line of JSON after ``what``: the plane's counters, the medians
    of its recent steps' parts in ms, and this process's kernel
    launches."""
    fields = dict(launches=kernel_launches())
    if plane is not None:
        fields.update(steps=plane.steps, messages_routed=plane.messages_routed,
                      delivery_impl=plane.delivery_impl,
                      device=str(plane.device), disabled=plane.disabled)
        if plane.recent_steps:
            fields["step_ms_median"] = {
                part: statistics.median(getattr(s, part + "_s")
                                        for s in plane.recent_steps) * 1e3
                for part in ("snapshot", "device", "pairs", "egress")}
    logger.info("%s %s", what, json.dumps(fields))


async def amain(args: argparse.Namespace) -> None:
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
        overrides = {}
        if args.device_ring_slots is not None:
            overrides["ring_slots"] = args.device_ring_slots
        if args.device_frame_bytes is not None:
            overrides["frame_bytes"] = args.device_frame_bytes
        if args.device_batch_window is not None:
            overrides["batch_window_s"] = args.device_batch_window
        device_plane = DevicePlaneConfig(
            delivery_impl=delivery_impl_from_env(), **overrides)
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
    ))
    # the plane warms up here; on the card a kernel that does not build
    # or launch raises, and the process exits non-zero
    await broker.start()
    plane = broker.device_plane
    log_plane("broker serving", plane)
    # Graceful drain: SIGINT/SIGTERM flips /readyz to 503 FIRST,
    # keeps serving in-flight traffic for PUSHCDN_DRAIN_GRACE_S, then
    # stops — so a load balancer stops routing before the listeners close.
    drain = asyncio.Event()
    if not install_drain_signals(drain):
        await broker.wait_until_failure()
        return
    run_task = asyncio.create_task(broker.wait_until_failure(),
                                   name="broker-run")
    drain_task = asyncio.create_task(drain.wait(), name="drain-wait")
    try:
        await asyncio.wait({run_task, drain_task},
                           return_when=asyncio.FIRST_COMPLETED)
        if drain.is_set():
            broker.begin_drain("signal")
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
    tune_gc()
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
