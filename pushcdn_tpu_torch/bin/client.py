"""Example client binary (parity cdn-client/src/binaries/client.rs:36-123):
every 5 s, send a direct message to ourselves and a broadcast, and log
everything received.

The port's copy of ``pushcdn_tpu.bin.client``; ``--io-impl`` puts a tcp
client on the io_uring engine."""

from __future__ import annotations

import argparse
import asyncio
import logging

from pushcdn_tpu_torch.bin.common import (
    add_io_impl_flag,
    apply_io_impl,
    init_logging,
    keypair_from_seed,
    scheme_by_name,
    transport_by_name,
)
from pushcdn_tpu_torch.client import Client, ClientConfig
from pushcdn_tpu_torch.proto.error import Error
from pushcdn_tpu_torch.proto.message import Broadcast, Direct

logger = logging.getLogger("pushcdn.client-bin")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pushcdn-client", description=__doc__)
    p.add_argument("--marshal-endpoint", required=True)
    p.add_argument("--transport", default="tcp+tls")
    p.add_argument("--key-seed", type=int, default=None)
    p.add_argument("--topic", type=int, action="append", default=None)
    p.add_argument("--interval", type=float, default=5.0)
    p.add_argument("--direct-to-seed", type=int, default=None,
                   help="send directs to the user whose keypair derives "
                        "from this seed instead of ourselves (two clients "
                        "messaging each other)")
    p.add_argument("--scheme", default="ed25519",
                   help="signature scheme: ed25519 | bls-bn254")
    p.add_argument("--metrics-bind-endpoint", default=None,
                   help="serve /metrics + /healthz + /readyz (readiness = "
                        "live broker link)")
    add_io_impl_flag(p)
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


async def amain(args: argparse.Namespace) -> None:
    topics = args.topic if args.topic is not None else [0]
    client = Client(ClientConfig(
        marshal_endpoint=args.marshal_endpoint,
        keypair=keypair_from_seed(args.key_seed, args.scheme),
        protocol=transport_by_name(args.transport),
        subscribed_topics=set(topics),
        scheme=scheme_by_name(args.scheme),
    ))
    if args.metrics_bind_endpoint:
        from pushcdn_tpu_torch.proto import health as health_mod
        from pushcdn_tpu_torch.proto import metrics as metrics_mod

        def _check_broker_link():
            conn = client._connection
            if conn is not None and not conn.is_closed:
                return True, "broker link up"
            return False, "no live broker connection"

        health_mod.register_readiness("broker-link", _check_broker_link)
        await metrics_mod.serve_metrics(args.metrics_bind_endpoint)
    await client.ensure_initialized()
    logger.info("connected; sending every %.1fs on topics %s",
                args.interval, topics)

    async def receiver():
        # elastic like the library (lib.rs disconnect_on_error): a broker
        # death raises Error(CONNECTION) here, and the next receive call
        # re-dials through the marshal — the process must ride it out, not
        # die when a broker is killed under it
        while True:
            try:
                message = await client.receive_message()
            except Error as exc:
                logger.info("receive failed (%s); reconnecting", exc.kind)
                continue
            if isinstance(message, Direct):
                logger.info("recv direct: %r", bytes(message.message)[:64])
            elif isinstance(message, Broadcast):
                logger.info("recv broadcast %s: %r", message.topics,
                            bytes(message.message)[:64])

    recv_task = asyncio.create_task(receiver())
    direct_target = client.public_key
    if args.direct_to_seed is not None:
        direct_target = keypair_from_seed(args.direct_to_seed,
                                          args.scheme).public_key
    n = 0
    try:
        while True:
            try:
                await client.send_direct_message(direct_target,
                                                 f"echo {n}".encode())
                await client.send_broadcast_message(topics,
                                                    f"hello {n}".encode())
                n += 1
            except Error as exc:
                logger.info("send failed (%s); reconnecting", exc.kind)
            await asyncio.sleep(args.interval)
    finally:
        recv_task.cancel()


def main() -> None:
    args = build_parser().parse_args()
    init_logging(args.verbose)
    apply_io_impl(args)
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
