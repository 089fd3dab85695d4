"""Marshal binary (parity cdn-marshal/src/binaries/marshal.rs:17-86;
default user-facing port 1737)."""

from __future__ import annotations

import argparse
import asyncio

from pushcdn_tpu_torch.bin.common import (
    add_io_impl_flag,
    apply_io_impl,
    drain_grace_s,
    init_logging,
    install_drain_signals,
    run_def_from_args,
    tune_gc,
)
from pushcdn_tpu_torch.marshal import Marshal, MarshalConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pushcdn-marshal", description=__doc__)
    p.add_argument("--discovery-endpoint", required=True)
    p.add_argument("--bind-endpoint", default="0.0.0.0:1737")
    p.add_argument("--metrics-bind-endpoint", default=None)
    p.add_argument("--user-transport", default="tcp+tls")
    p.add_argument("--num-topics", type=int, default=256)
    p.add_argument("--ca-cert-path", default=None)
    p.add_argument("--ca-key-path", default=None)
    p.add_argument("--global-memory-pool-size", type=int,
                   default=1024 * 1024 * 1024)
    p.add_argument("--global-permits", action="store_true")
    p.add_argument("--scheme", default="ed25519",
                   help="signature scheme: ed25519 | bls-bn254")
    add_io_impl_flag(p)
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


async def amain(args: argparse.Namespace) -> None:
    run_def = run_def_from_args("tcp", args.user_transport,
                                args.discovery_endpoint, args.num_topics,
                                args.global_permits, scheme=args.scheme)
    marshal = await Marshal.new(MarshalConfig(
        run_def=run_def,
        discovery_endpoint=args.discovery_endpoint,
        bind_endpoint=args.bind_endpoint,
        metrics_bind_endpoint=args.metrics_bind_endpoint,
        ca_cert_path=args.ca_cert_path, ca_key_path=args.ca_key_path,
        global_memory_pool_size=args.global_memory_pool_size,
    ))
    await marshal.start()
    # Graceful drain: readiness flips false on SIGINT/SIGTERM,
    # the listener stays up for the grace window, then a clean stop.
    drain = asyncio.Event()
    if not install_drain_signals(drain):
        await asyncio.Event().wait()  # serve until KeyboardInterrupt
        return
    await drain.wait()
    marshal.begin_drain("signal")
    await asyncio.sleep(drain_grace_s())
    await marshal.stop()


def main() -> None:
    args = build_parser().parse_args()
    init_logging(args.verbose)
    apply_io_impl(args)
    tune_gc()
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
