"""Client-pack worker: many clients in a process of their own.

    python -m pushcdn_tpu_torch.testing.clientpack --marshal-endpoint HOST:PORT \
        --seed-base 1000 [--mode soak|storm] [--clients 100] [--topics 8]

One OS process hosting many REAL clients on a single asyncio loop — a
driver spawns several of these so thousands of TCP connections spread
across process (and fd-budget) boundaries instead of wedging one loop,
and the clients' pace is not the driver's. A copy of
``pushcdn_tpu.testing.clientpack``; like every client process of this
package it never imports torch. Two modes:

- ``soak``: connect N clients, subscribe each to ``seed % topics``, and
  run a receive loop per client. Every broadcast payload carries a
  4-byte big-endian per-topic sequence number; the client library's own
  LIVE gap detector (``Client.gap_detector``, armed via
  ``ClientConfig.seq_extractor``) accounts every arrival as it lands —
  holes opened (``cdn_client_gap_events``), holes healed by late
  arrivals, duplicates — so the parent's wrap-up loss check reads the
  detector's residual instead of diffing delivery logs post-hoc
  (duplicates stay legal, at-least-once). Re-home latencies come from
  ``Client.rehome_ms``; ``--metrics-endpoint`` exposes the gap counters
  on a live /metrics scrape.

- ``storm``: a pool of M clients performs Q full reconnect cycles
  (marshal auth -> broker permit redemption over real TCP) as fast as
  the backoff policy allows — the reconnect storm. Reports
  attempts/sheds and connect-latency percentiles.

Protocol with the parent: JSON lines on stdout (``ready`` once every
client is connected, periodic ``stats``, ``mark``/``result`` replies);
single-word commands on stdin (``mark`` -> snapshot re-home + liveness
state, ``finish`` -> settle, close everything, emit ``result``, exit).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from typing import List, Optional

from pushcdn_tpu_torch.client.client import Client, ClientConfig, backoff_delay
from pushcdn_tpu_torch.proto import metrics as metrics_mod
from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
from pushcdn_tpu_torch.proto.error import Error, ErrorKind
from pushcdn_tpu_torch.proto.message import Broadcast, Direct
from pushcdn_tpu_torch.proto.transport import Tcp


def emit(event: str, **fields) -> None:
    print(json.dumps({"event": event, **fields}), flush=True)


def _pctile(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def _seq(payload) -> int:
    return int.from_bytes(bytes(payload)[:4], "big")


def make_seq_extractor(topic: int):
    """The soak's ``ClientConfig.seq_extractor``: every Broadcast/Direct
    payload opens with a 4-byte big-endian per-topic sequence number;
    control frames carry no sequence."""
    def extract(m):
        if isinstance(m, (Broadcast, Direct)):
            return (topic, _seq(m.message))
        return None
    return extract


class SoakClient:
    """One subscriber: drains deliveries and rides out errors
    elastically. Loss accounting lives in the client library's LIVE
    gap detector — this wrapper only reads it out."""

    def __init__(self, client: Client, topic: int):
        self.client = client
        self.topic = topic
        self.hard_reconnects = 0    # non-migration connection losses

    @property
    def delivered(self) -> int:
        det = self.client.gap_detector
        return det.unique + det.duplicates

    @property
    def unique(self) -> int:
        return self.client.gap_detector.unique

    @property
    def gaps(self) -> int:
        """Residual loss as the live detector sees it RIGHT NOW —
        holes opened and never healed by a late arrival."""
        return self.client.gap_detector.open_gaps

    @property
    def reorders(self) -> int:
        """Healed holes: a frame arrived after a later one (legal for
        at-least-once delivery, but the soak's elastic invariant
        requires zero)."""
        return self.client.gap_detector.healed

    async def run(self, stop: asyncio.Event) -> None:
        while not stop.is_set():
            try:
                # the client's armed gap detector observes every
                # delivery inside receive_messages — nothing to do here
                await self.client.receive_messages()
            except asyncio.CancelledError:
                raise
            except Error:
                # broker loss outside a planned migration: the next
                # receive re-dials through the marshal (with backoff);
                # messages published meanwhile are legitimately missed,
                # so the parent treats hard_reconnects > 0 as tainting
                # the loss figure rather than a harness bug
                self.hard_reconnects += 1
                await asyncio.sleep(backoff_delay(0))
                continue


async def _read_commands(queue: "asyncio.Queue[str]") -> None:
    loop = asyncio.get_running_loop()
    while True:
        line = await loop.run_in_executor(None, sys.stdin.readline)
        if not line:
            await queue.put("finish")  # parent went away
            return
        cmd = line.strip()
        if cmd:
            await queue.put(cmd)
        if cmd == "finish":
            return


def _soak_snapshot(packs: List[SoakClient]) -> dict:
    rehome_ms = sorted(
        ms for p in packs for ms in p.client.rehome_ms)
    live = sum(1 for p in packs
               if p.client._connection is not None
               and not p.client._connection.is_closed)
    return {
        "clients": len(packs),
        "live": live,
        "rehomed": sum(1 for p in packs if p.client.rehome_ms),
        "delivered": sum(p.delivered for p in packs),
        "unique": sum(p.unique for p in packs),
        "gaps": sum(p.gaps for p in packs),
        "reorders": sum(p.reorders for p in packs),
        "hard_reconnects": sum(p.hard_reconnects for p in packs),
        "rehome_ms": rehome_ms,
        # process-wide live counters — the same numbers a /metrics
        # scrape of this worker shows (cdn_client_gap_*)
        "gap_events": metrics_mod.CLIENT_GAP_EVENTS.value,
        "gap_healed": metrics_mod.CLIENT_GAP_HEALED.value,
    }


async def run_soak(args) -> int:
    metrics_server = None
    if args.metrics_endpoint:
        metrics_server = await metrics_mod.serve_metrics(
            args.metrics_endpoint)
    packs: List[SoakClient] = []
    for i in range(args.clients):
        topic = i % args.topics
        client = Client(ClientConfig(
            marshal_endpoint=args.marshal_endpoint,
            keypair=DEFAULT_SCHEME.generate_keypair(seed=args.seed_base + i),
            protocol=Tcp,
            subscribed_topics={topic},
            seq_extractor=make_seq_extractor(topic),
        ))
        packs.append(SoakClient(client, topic))

    sem = asyncio.Semaphore(args.connect_concurrency)

    async def connect(p: SoakClient):
        async with sem:
            await p.client.ensure_initialized()

    await asyncio.gather(*(connect(p) for p in packs))
    emit("ready", clients=len(packs))

    stop = asyncio.Event()
    receivers = [asyncio.create_task(p.run(stop)) for p in packs]
    commands: asyncio.Queue = asyncio.Queue()
    reader = asyncio.create_task(_read_commands(commands))

    last_delivered = 0
    last_t = time.monotonic()
    try:
        while True:
            try:
                cmd = await asyncio.wait_for(commands.get(),
                                             args.report_every_s)
            except asyncio.TimeoutError:
                now = time.monotonic()
                delivered = sum(p.delivered for p in packs)
                emit("stats", delivered=delivered,
                     delivered_per_s=round(
                         (delivered - last_delivered) / (now - last_t), 1),
                     live=sum(1 for p in packs
                              if p.client._connection is not None
                              and not p.client._connection.is_closed))
                last_delivered, last_t = delivered, now
                continue
            if cmd == "mark":
                emit("mark", **_soak_snapshot(packs))
            elif cmd == "finish":
                break
    finally:
        reader.cancel()

    await asyncio.sleep(args.settle_s)   # let in-flight deliveries land
    stop.set()
    for t in receivers:
        t.cancel()
    await asyncio.gather(*receivers, return_exceptions=True)
    snap = _soak_snapshot(packs)
    for p in packs:
        p.client.close()
    if metrics_server is not None:
        metrics_server.close()
    emit("result", mode="soak", **snap)
    return 0


async def run_storm(args) -> int:
    """Q reconnect cycles over a pool of real users: every cycle is the
    full marshal-auth + broker-permit dance on a fresh TCP connection,
    retried under the production backoff policy when shed/refused."""
    clients = [Client(ClientConfig(
        marshal_endpoint=args.marshal_endpoint,
        keypair=DEFAULT_SCHEME.generate_keypair(seed=args.seed_base + i),
        protocol=Tcp,
    )) for i in range(args.clients)]

    established = 0
    attempts = 0
    sheds = 0
    conn_ms: List[float] = []
    quota = args.storm_connections
    next_cycle = 0
    lock = asyncio.Lock()
    t_start = time.monotonic()

    async def one_cycle(client: Client) -> None:
        nonlocal established, attempts, sheds
        attempt = 0
        while True:
            t0 = time.monotonic()
            attempts += 1
            try:
                async with asyncio.timeout(30.0):
                    conn = await client._connect_once()
            except asyncio.CancelledError:
                raise
            except Error as exc:
                if exc.kind == ErrorKind.SHED:
                    sheds += 1
                delay = backoff_delay(attempt,
                                      getattr(exc, "retry_after_s", None))
                attempt += 1
                await asyncio.sleep(delay)
                continue
            except Exception:
                attempt += 1
                await asyncio.sleep(backoff_delay(attempt))
                continue
            conn_ms.append((time.monotonic() - t0) * 1000.0)
            established += 1
            await asyncio.sleep(args.hold_ms / 1000.0)
            conn.close()
            return

    gate = asyncio.Semaphore(args.connect_concurrency)

    async def worker(client: Client) -> None:
        nonlocal next_cycle
        while True:
            async with lock:
                if next_cycle >= quota:
                    return
                next_cycle += 1
            # each pool client reconnects back-to-back, which IS the
            # storm; capping in-flight dials keeps the marshal queue
            # bounded the way real jittered backoff spreads arrivals
            async with gate:
                await one_cycle(client)
            if established % 500 == 0:
                emit("stats", established=established, attempts=attempts,
                     sheds=sheds)

    await asyncio.gather(*(asyncio.create_task(worker(c))
                           for c in clients))
    duration = time.monotonic() - t_start
    conn_ms.sort()
    emit("result", mode="storm", established=established, attempts=attempts,
         sheds=sheds, duration_s=round(duration, 2),
         conns_per_s=round(established / duration, 1) if duration else 0.0,
         conn_p50_ms=round(_pctile(conn_ms, 0.50) or 0.0, 2),
         conn_p99_ms=round(_pctile(conn_ms, 0.99) or 0.0, 2))
    for c in clients:
        c.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="clientpack", description=__doc__)
    p.add_argument("--marshal-endpoint", required=True)
    p.add_argument("--mode", choices=("soak", "storm"), default="soak")
    p.add_argument("--clients", type=int, default=100)
    p.add_argument("--seed-base", type=int, required=True)
    p.add_argument("--topics", type=int, default=8)
    p.add_argument("--connect-concurrency", type=int, default=25)
    p.add_argument("--metrics-endpoint", default="",
                   help="soak mode: serve /metrics here so the live "
                        "cdn_client_gap_* counters are scrapeable")
    p.add_argument("--report-every-s", type=float, default=2.0)
    p.add_argument("--settle-s", type=float, default=2.0)
    p.add_argument("--storm-connections", type=int, default=1000,
                   help="storm mode: total reconnect cycles this worker "
                        "performs across its client pool")
    p.add_argument("--hold-ms", type=float, default=50.0,
                   help="storm mode: how long each established "
                        "connection is held before the next cycle")
    return p


def main() -> None:
    args = build_parser().parse_args()
    runner = run_soak if args.mode == "soak" else run_storm
    try:
        sys.exit(asyncio.run(runner(args)))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
