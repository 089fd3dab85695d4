"""Chaos: connection storm (parity cdn-client/src/binaries/bad-connector.rs:32-73
— a FRESH identity authenticates through the marshal every 200 ms,
hammering permit issuance and broker accept paths).

    python -m pushcdn_tpu_torch.bin.bad_connector --marshal-endpoint HOST:PORT \
        [--cycles N] [--connect-interval 0.2]

A copy of ``pushcdn_tpu.bin.bad_connector``; it never imports torch."""

from __future__ import annotations

import argparse
import asyncio
import itertools
import logging
import secrets

from pushcdn_tpu_torch.bin.common import init_logging, transport_by_name
from pushcdn_tpu_torch.client import Client, ClientConfig
from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME

logger = logging.getLogger("pushcdn.bad-connector")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pushcdn-bad-connector", description=__doc__)
    p.add_argument("--marshal-endpoint", required=True)
    p.add_argument("--transport", default="tcp")
    p.add_argument("--connect-interval", type=float, default=0.2,
                   help="seconds between fresh connections (parity 200 ms)")
    p.add_argument("--cycles", type=int, default=0, help="0 = forever")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


async def amain(args: argparse.Namespace) -> None:
    protocol = transport_by_name(args.transport)
    for n in itertools.count():
        if args.cycles and n >= args.cycles:
            break
        client = Client(ClientConfig(
            marshal_endpoint=args.marshal_endpoint,
            keypair=DEFAULT_SCHEME.generate_keypair(
                seed=secrets.randbits(48)),
            protocol=protocol, subscribed_topics={0},
        ))
        try:
            await asyncio.wait_for(client.ensure_initialized(), 10)
            await client.send_direct_message(client.public_key, b"storm")
            logger.info("storm %d: fresh identity connected", n)
        except Exception as exc:
            logger.warning("storm %d failed: %r", n, exc)
        finally:
            client.close()
        await asyncio.sleep(args.connect_interval)


def main() -> None:
    args = build_parser().parse_args()
    init_logging(args.verbose)
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
