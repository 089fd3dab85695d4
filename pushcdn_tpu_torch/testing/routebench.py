"""Broker forwarding rate of the host routing plane: the cut-through
plane against its scalar twin.

One injected broker (test harness, Memory transport), one publisher
fanning Broadcast batches to N subscribed receivers, counted at the
receivers' transport drain. The port's copy of
``pushcdn_tpu.testing.routebench``'s ``forward_rate``; its TCP and
stream rows need the io_uring engine, which this package does not have
yet.

    python -m pushcdn_tpu_torch.testing.routebench --route-impl native

prints one JSON line.
"""

from __future__ import annotations

import asyncio
import os
import statistics
import time
from typing import Optional

import numpy as np


async def forward_rate(impl: str, receivers: int = 8, msgs: int = 2_000,
                       trials: int = 3, payload: int = 512,
                       batch: int = 64,
                       trace_every: int = 0,
                       deliver_spans: bool = False,
                       parked_users: int = 0,
                       churn: bool = False,
                       incremental: Optional[bool] = None,
                       client_decode: bool = False
                       ) -> Optional[dict]:
    """Measure broker forwarding msgs/s with the routing plane forced to
    ``impl`` (``auto``/``native``/``python``). Returns ``None`` when
    ``impl == "native"`` but the kernel is unavailable (callers emit a
    skipped row — never a mislabeled A/B), else a dict with the median,
    all trials, and the delivered rate.

    ``trace_every > 0`` stamps every Nth sent frame with a lifecycle-trace
    context (proto.trace wire flag), exactly what a client publishing at
    ``PUSHCDN_TRACE_SAMPLE=N`` produces — the trace-overhead A/B row.
    ``deliver_spans=True`` makes receivers additionally do what a real
    client does with a traced frame: emit the ``delivery`` span (feeding
    ``cdn_e2e_latency_seconds``); the result dict then carries
    ``e2e_lat_s``, the raw publish→delivery latencies, for bench-side
    p50/p99. Kept opt-in because these receivers skip frame decode (a
    real client pays it anyway), so the flag-scan is bench-side cost that
    must not pollute the broker-side trace-overhead A/B.

    The sustained-churn knobs: ``parked_users`` injects
    that many extra users subscribed to an untrafficked topic (a big
    interest table, so a snapshot rebuild has a real O(users) cost);
    ``churn=True`` runs a concurrent churner connection flooding
    Subscribe/Unsubscribe during the measurement (every mutation
    invalidates the snapshot mid-traffic; the result carries
    ``churn_ops_s``); ``incremental`` forces the native maintenance mode
    (True = in-place deltas, False = the rebuild-guard baseline,
    None = leave as configured).

    ``client_decode=True`` drains receivers through the REAL client batch
    decode (``client.decode_received`` — exactly what
    ``Client.receive_messages`` runs, zero-copy payload views included)
    instead of counting raw frames at the transport: the delivered/s
    figure then includes full message decode, the honest application-
    visible rate."""
    from pushcdn_tpu_torch.broker.tasks import cutthrough
    from pushcdn_tpu_torch.broker.test_harness import TestDefinition
    from pushcdn_tpu_torch.native import routeplan
    from pushcdn_tpu_torch.proto import trace as trace_lib
    from pushcdn_tpu_torch.proto.message import Broadcast, serialize
    from pushcdn_tpu_torch.proto.transport.base import FrameChunk
    from pushcdn_tpu_torch.proto.transport.memory import Memory

    if impl == "native" and not routeplan.available():
        return None
    # the global-state restore must survive a failing harness start OR a
    # failing shutdown: callers swallow exceptions, and a leaked forced
    # impl / widened duplex window would distort every later row (and
    # cross-contaminate tests) in the same process
    from pushcdn_tpu_torch.proto.message import Subscribe, Unsubscribe

    prev_impl = cutthrough.ROUTE_IMPL
    prev_inc = cutthrough.ROUTE_INCREMENTAL
    prev_win = Memory.set_duplex_window(256 * 1024)
    try:
        cutthrough.ROUTE_IMPL = impl
        if incremental is not None:
            cutthrough.ROUTE_INCREMENTAL = incremental
        # user 0 = sender, 1..receivers = receivers on topic 0, then the
        # churner (topicless), then the parked herd on topic 1 (table
        # size without fan-out traffic)
        run = await TestDefinition(
            connected_users=[[]] + [[0]] * receivers + [[]]
            + [[1]] * parked_users).run()
        try:
            frame = serialize(Broadcast([0], os.urandom(payload)))
            sender = run.user(0).remote
            churner = run.user(1 + receivers).remote
            sub_frame = serialize(Subscribe([1]))
            unsub_frame = serialize(Unsubscribe([1]))
            churn_ops = 0
            churn_stop = False

            churn_batch = [sub_frame, unsub_frame] * 4

            async def churn_loop():
                # sustained subscribe/unsubscribe churn riding the same
                # broker while forwarding is measured: each op bumps
                # interest_version, so every following plan call pays the
                # maintenance cost under test (delta vs rebuild)
                nonlocal churn_ops
                while not churn_stop:
                    try:
                        await churner.send_raw_many(churn_batch,
                                                    flush=True)
                    except Exception:
                        return
                    churn_ops += len(churn_batch)
                    await asyncio.sleep(0)

            msgs = max(batch, (msgs // batch) * batch)
            e2e_lat_s: list = []

            def _note_delivery(data) -> None:
                # the real client's per-traced-frame work: strip the
                # trace block + emit the delivery span (the e2e SLO seam)
                _, tr = trace_lib.strip_frame(bytes(data))
                if tr is not None:
                    trace_lib.emit("delivery", tr)
                    e2e_lat_s.append(max(time.time_ns() - tr[1], 0) / 1e9)

            async def drain_decoded(conn, n):
                # the client-API drain: recv_frames + the exact decode
                # Client.receive_messages runs (zero-copy views) — every
                # counted message is a decoded Message object
                from pushcdn_tpu_torch.client.client import decode_received
                got = 0
                async with asyncio.timeout(120):
                    while got < n:
                        got += len(decode_received(
                            await conn.recv_frames(n - got)))

            async def drain(conn, n):
                if client_decode:
                    return await drain_decoded(conn, n)
                got = 0
                async with asyncio.timeout(120):
                    while got < n:
                        for item in await conn.recv_frames(n - got):
                            if type(item) is FrameChunk:
                                got += item.remaining
                                if deliver_spans and trace_every:
                                    # vectorized flag scan: one fancy-index
                                    # per chunk, per-frame work only for
                                    # the 1-in-N actually-traced frames (a
                                    # scalar Python loop here costs ~14%
                                    # of the forwarding rate and would
                                    # dominate the A/B it exists to serve)
                                    offs_a = np.asarray(item.offs, np.int64)
                                    firsts = np.frombuffer(
                                        item.buf, np.uint8)[offs_a]
                                    hits = np.nonzero(
                                        firsts & trace_lib.TRACE_FLAG)[0]
                                    for i in hits.tolist():
                                        o = int(offs_a[i])
                                        ln = int(item.lens[i])
                                        _note_delivery(
                                            memoryview(item.buf)[o:o + ln])
                            else:
                                got += 1
                                if deliver_spans and trace_every \
                                        and len(item.data) \
                                        and item.data[0] & trace_lib.TRACE_FLAG:
                                    _note_delivery(item.data)
                            item.release()

            rates = []
            sent = 0
            churn_task = asyncio.create_task(churn_loop()) if churn \
                else None
            churn_t0 = time.perf_counter()
            for _ in range(trials):
                t0 = time.perf_counter()
                drains = [asyncio.create_task(
                    drain(run.user(1 + r).remote, msgs))
                    for r in range(receivers)]
                for _ in range(msgs // batch):
                    if trace_every:
                        # deterministic 1-in-N mix: the exact wire a
                        # sampled publisher produces (stamped fresh per
                        # traced frame — real origins, so the delivery
                        # side's e2e latencies are meaningful)
                        frames = []
                        for _i in range(batch):
                            sent += 1
                            frames.append(
                                trace_lib.stamp_frame(frame,
                                                      trace_lib.new_trace())
                                if sent % trace_every == 0 else frame)
                        await sender.send_raw_many(frames)
                    else:
                        await sender.send_raw_many([frame] * batch)
                    await asyncio.sleep(0)
                await asyncio.gather(*drains)
                rates.append(msgs / (time.perf_counter() - t0))
            churn_dt = time.perf_counter() - churn_t0
            if churn_task is not None:
                churn_stop = True
                await churn_task
            med = statistics.median(rates)
            out = {"median": med, "trials": rates, "msgs": msgs,
                   "receivers": receivers, "payload": payload,
                   "delivered": med * receivers,
                   "e2e_lat_s": e2e_lat_s}
            if churn:
                out["churn_ops"] = churn_ops
                out["churn_ops_s"] = churn_ops / churn_dt if churn_dt \
                    else 0.0
                state = getattr(run.broker, "_route_state", None)
                if state is not None:
                    out["route_summary"] = state.summary()
            return out
        finally:
            await run.shutdown()
    finally:
        cutthrough.ROUTE_IMPL = prev_impl
        cutthrough.ROUTE_INCREMENTAL = prev_inc
        Memory.set_duplex_window(prev_win)


def _main() -> None:
    """Run :func:`forward_rate` once and print its result as one JSON
    line (``null`` for a native row without the library)."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("--route-impl", default="auto",
                    choices=("auto", "native", "python"))
    ap.add_argument("--receivers", type=int, default=8)
    ap.add_argument("--msgs", type=int, default=2000)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--payload", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--parked-users", type=int, default=0)
    ap.add_argument("--churn", action="store_true")
    ap.add_argument("--incremental", choices=("on", "off"), default=None)
    ap.add_argument("--client-decode", action="store_true")
    args = ap.parse_args()
    out = asyncio.run(forward_rate(
        args.route_impl, receivers=args.receivers, msgs=args.msgs,
        trials=args.trials, payload=args.payload, batch=args.batch,
        parked_users=args.parked_users, churn=args.churn,
        incremental=(None if args.incremental is None
                     else args.incremental == "on"),
        client_decode=args.client_decode))
    if out is not None:
        out.pop("e2e_lat_s", None)
    json.dump(out, sys.stdout)
    sys.stdout.write("\n")


if __name__ == "__main__":
    _main()
