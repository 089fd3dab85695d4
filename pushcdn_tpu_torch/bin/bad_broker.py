"""Chaos: broker churn generator (parity
cdn-broker/src/binaries/bad-broker.rs:36-98 — start a new broker every
300 ms and kill the previous one, exercising mesh self-healing).

    python -m pushcdn_tpu_torch.bin.bad_broker --discovery-endpoint DB \
        [--cycles N] [--churn-interval 0.3]

A copy of ``pushcdn_tpu.bin.bad_broker``: its brokers have no device
plane, so the process never imports torch."""

from __future__ import annotations

import argparse
import asyncio
import itertools
import logging

from pushcdn_tpu_torch.bin.common import init_logging, keypair_from_seed, run_def_from_args
from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig

logger = logging.getLogger("pushcdn.bad-broker")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pushcdn-bad-broker", description=__doc__)
    p.add_argument("--discovery-endpoint", required=True)
    p.add_argument("--broker-transport", default="tcp")
    p.add_argument("--user-transport", default="tcp")
    p.add_argument("--base-port", type=int, default=11000)
    p.add_argument("--churn-interval", type=float, default=0.3,
                   help="seconds between churn cycles (parity 300 ms)")
    p.add_argument("--key-seed", type=int, default=0)
    p.add_argument("--cycles", type=int, default=0, help="0 = forever")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


async def amain(args: argparse.Namespace) -> None:
    run_def = run_def_from_args(args.broker_transport, args.user_transport,
                                args.discovery_endpoint, 256)
    previous: Broker | None = None
    prev_task: asyncio.Task | None = None
    for n in itertools.count():
        if args.cycles and n >= args.cycles:
            break
        port = args.base_port + (n % 500) * 2
        broker = await Broker.new(BrokerConfig(
            run_def=run_def, keypair=keypair_from_seed(args.key_seed),
            discovery_endpoint=args.discovery_endpoint,
            public_advertise_endpoint=f"127.0.0.1:{port}",
            public_bind_endpoint=f"127.0.0.1:{port}",
            private_advertise_endpoint=f"127.0.0.1:{port + 1}",
            private_bind_endpoint=f"127.0.0.1:{port + 1}",
            heartbeat_interval_s=0.1,  # churn fast, heal fast
            membership_ttl_s=1.0,
        ))
        task = asyncio.create_task(broker.run_until_failure())
        logger.info("churn %d: broker on ports %d/%d up", n, port, port + 1)
        if previous is not None:
            prev_task.cancel()
            await previous.stop()
            logger.info("churn %d: previous broker killed", n)
        previous, prev_task = broker, task
        await asyncio.sleep(args.churn_interval)
    if previous is not None:
        prev_task.cancel()
        await previous.stop()


def main() -> None:
    args = build_parser().parse_args()
    init_logging(args.verbose)
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
