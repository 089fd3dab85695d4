"""Chaos: message firehose (parity cdn-client/src/binaries/bad-sender.rs:34-105
— broadcast large messages in a tight loop; default 9 MB, the reference's
design-envelope size, exercising the byte-pool backpressure).

    python -m pushcdn_tpu_torch.bin.bad_sender --marshal-endpoint HOST:PORT \
        [--cycles N] [--message-size BYTES]

A copy of ``pushcdn_tpu.bin.bad_sender``; it never imports torch."""

from __future__ import annotations

import argparse
import asyncio
import itertools
import logging
import os

from pushcdn_tpu_torch.bin.common import init_logging, keypair_from_seed, transport_by_name
from pushcdn_tpu_torch.client import Client, ClientConfig

logger = logging.getLogger("pushcdn.bad-sender")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pushcdn-bad-sender", description=__doc__)
    p.add_argument("--marshal-endpoint", required=True)
    p.add_argument("--transport", default="tcp")
    p.add_argument("--message-size", type=int, default=9 * 1000 * 1000,
                   help="bytes per broadcast (parity: 9 MB)")
    p.add_argument("--key-seed", type=int, default=None)
    p.add_argument("--cycles", type=int, default=0, help="0 = forever")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


async def amain(args: argparse.Namespace) -> None:
    client = Client(ClientConfig(
        marshal_endpoint=args.marshal_endpoint,
        keypair=keypair_from_seed(args.key_seed),
        protocol=transport_by_name(args.transport),
        subscribed_topics={0},
    ))
    await client.ensure_initialized()
    payload = os.urandom(args.message_size)
    sent = 0
    for n in itertools.count():
        if args.cycles and n >= args.cycles:
            break
        await client.send_broadcast_message([0], payload)
        sent += len(payload)
        if n % 10 == 0:
            logger.info("firehose: %d msgs, %.1f MB total", n + 1, sent / 1e6)


def main() -> None:
    args = build_parser().parse_args()
    init_logging(args.verbose)
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
