"""Broker forwarding rate of the host routing plane: the cut-through
plane against its scalar twin.

One injected broker (test harness, Memory transport), one publisher
fanning Broadcast batches to N subscribed receivers, counted at the
receivers' transport drain. The port's copy of
``pushcdn_tpu.testing.routebench``: ``forward_rate`` over Memory pairs,
``forward_rate_tcp`` over loopback TCP on asyncio or io_uring (with the
fused pump or without it), and ``stream_rate``, the raw byte path.

    python -m pushcdn_tpu_torch.testing.routebench --route-impl native
    python -m pushcdn_tpu_torch.testing.routebench --io-impl uring --pump auto
    python -m pushcdn_tpu_torch.testing.routebench --io-impl uring --stream

each print one JSON line. Run under ``LD_PRELOAD`` of the port's
syscall interposer (``native.syscount.build()`` gives its path), a TCP
row also carries its syscall deltas.
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


async def forward_rate_tcp(io_impl: str, route_impl: str = "auto",
                           receivers: int = 4, msgs: int = 2_000,
                           trials: int = 3, payload: int = 512,
                           batch: int = 64, pump: str = "off",
                           count_transitions: bool = False
                           ) -> Optional[dict]:
    """The :func:`forward_rate` loop with user links over REAL loopback
    TCP — the io-impl (asyncio vs io_uring) A/B seam. ``io_impl`` is
    ``asyncio`` or ``uring``; returns None when ``uring`` is requested
    but the kernel denies io_uring (callers emit a skipped row, never a
    mislabeled one).

    When this process runs under the syscall-attribution preload
    (``native.syscount``), the result carries per-syscall counter deltas
    for the measured section and ``syscalls_per_msg`` — counted write +
    sendto/sendmsg + epoll_wait + io_uring_enter per DELIVERED message.

    ``pump`` controls the fused data-plane pump for this run
    (``off``/``auto``) INDEPENDENTLY of the process environment, so the
    io-impl rows keep measuring the io engine alone and the pump A/B
    flips exactly one variable. ``pump="auto"`` returns None when the
    composition can't engage (the caller emits a skipped row, never an
    unlabeled python-path run sold as a pump run); an engaged run
    carries the route-plane ``pump`` summary (pump-hit vs escalation
    counts) and runs one unmeasured warmup wave first — engagement
    completes at the first TX-idle transition, so without the warmup
    trial 1 would silently measure the residual path.

    ``count_transitions=True`` appends one extra UNMEASURED wave run
    under a ``sys.setprofile`` hook and reports
    ``transitions_per_kmsg`` — Python-interpreter call transitions per
    1k delivered messages across the whole process (broker AND bench
    clients; the hook costs ~3x in rate, which is why it never overlaps
    the timed trials)."""
    from pushcdn_tpu_torch.broker.tasks import cutthrough
    from pushcdn_tpu_torch.broker.test_harness import TestDefinition
    from pushcdn_tpu_torch.native import routeplan, syscount
    from pushcdn_tpu_torch.native import uring as nuring
    from pushcdn_tpu_torch.proto.message import Broadcast, serialize
    from pushcdn_tpu_torch.proto.transport.base import FrameChunk
    from pushcdn_tpu_torch.proto.transport import pump as pump_mod
    from pushcdn_tpu_torch.proto.transport import uring as uring_mod

    if io_impl == "uring" and not nuring.available():
        return None
    if route_impl == "native" and not routeplan.available():
        return None
    if pump != "off" and (io_impl != "uring"
                          or not routeplan.available()):
        return None
    prev_impl = cutthrough.ROUTE_IMPL
    prev_env = os.environ.get("PUSHCDN_IO_IMPL")
    prev_pump = pump_mod.PUMP_IMPL
    try:
        cutthrough.ROUTE_IMPL = route_impl
        uring_mod.set_io_impl(io_impl)
        pump_mod.set_pump_impl(pump)
        run = await TestDefinition(
            connected_users=[[]] + [[0]] * receivers, tcp_users=True).run()
        try:
            frame = serialize(Broadcast([0], os.urandom(payload)))
            sender = run.user(0).remote
            msgs = max(batch, (msgs // batch) * batch)

            async def drain(conn, n):
                got = 0
                async with asyncio.timeout(120):
                    while got < n:
                        for item in await conn.recv_frames(n - got):
                            got += item.remaining \
                                if type(item) is FrameChunk else 1
                            item.release()

            async def wave(n):
                drains = [asyncio.create_task(
                    drain(run.user(1 + r).remote, n))
                    for r in range(receivers)]
                for _ in range(n // batch):
                    await sender.send_raw_many([frame] * batch)
                    await asyncio.sleep(0)
                await asyncio.gather(*drains)

            if pump != "off":
                # unmeasured warmup: pump engagement completes at each
                # receiver stream's first TX-idle transition, which only
                # happens after a wave drains — run one so the timed
                # trials measure the engaged path, not the residual one
                await wave(max(batch, min(msgs, 4 * batch)))
                await asyncio.sleep(0.05)

            rates = []
            counts_before = syscount.snapshot()
            t_all0 = time.perf_counter()
            for _ in range(trials):
                t0 = time.perf_counter()
                await wave(msgs)
                rates.append(msgs / (time.perf_counter() - t0))
            wall_s = time.perf_counter() - t_all0
            counts_after = syscount.snapshot()
            med = statistics.median(rates)
            out = {"median": med, "trials": rates, "msgs": msgs,
                   "receivers": receivers, "payload": payload,
                   "delivered": med * receivers,
                   "io_impl": io_impl, "pump": pump, "wall_s": wall_s}
            if counts_after:
                delta = syscount.delta(counts_before, counts_after)
                delivered_total = trials * msgs * receivers
                data_calls = sum(delta.get(k, 0) for k in (
                    "write", "writev", "send", "sendto", "sendmsg",
                    "epoll_wait", "epoll_pwait", "io_uring_enter"))
                out["syscalls"] = delta
                out["syscalls_per_msg"] = data_calls / delivered_total
            if count_transitions:
                import sys as _sys
                n_calls = [0]

                def _hook(frame_, event, arg, _n=n_calls):
                    if event == "call":
                        _n[0] += 1

                _sys.setprofile(_hook)
                try:
                    await wave(msgs)
                finally:
                    _sys.setprofile(None)
                out["transitions_per_kmsg"] = \
                    n_calls[0] / (msgs * receivers) * 1e3
            state = getattr(run.broker, "_route_state", None)
            ps = getattr(state, "_pump_state", None)
            if ps is not None and not ps.closed:
                out["pump_summary"] = ps.summary()
            if pump != "off" and (ps is None or ps.closed
                                  or not ps.summary()["pump_frames"]):
                # the composition never engaged (or never pumped a
                # frame): a "pump" row from this run would be the
                # residual path mislabeled — refuse to report it
                return None
            return out
        finally:
            await run.shutdown()
    finally:
        cutthrough.ROUTE_IMPL = prev_impl
        pump_mod.set_pump_impl(prev_pump)
        if prev_env is None:
            os.environ.pop("PUSHCDN_IO_IMPL", None)
            uring_mod._resolved = None
        else:
            uring_mod.set_io_impl(prev_env)


async def stream_rate(io_impl: str, total_mb: int = 256,
                      wsize: int = 256 * 1024,
                      trials: int = 3) -> Optional[dict]:
    """Raw data-plane throughput A/B: one loopback connection, one
    producer streaming ``total_mb`` MiB in ``wsize`` writes straight at
    the :class:`RawStream` layer, one consumer draining ``read_some``.
    No broker, no framing — this isolates the byte path itself (where
    the io engine's submission batching and completion coalescing live)
    from the CPython routing work that dominates ``forward_rate_tcp``.
    Returns None when ``uring`` is requested but unavailable."""
    import socket

    from pushcdn_tpu_torch.native import uring as nuring
    from pushcdn_tpu_torch.proto.transport import uring as uring_mod

    if io_impl == "uring" and not nuring.available():
        return None
    total = total_mb * 1024 * 1024
    payload = bytes(wsize)
    loop = asyncio.get_running_loop()
    rates = []
    for _ in range(trials):
        if io_impl == "uring":
            eng = uring_mod.UringEngine.current()
            lst = uring_mod.uring_bind("127.0.0.1", 0)
            accept_t = asyncio.create_task(lst.accept())
            cs = socket.socket()
            cs.setblocking(False)
            await loop.sock_connect(cs, ("127.0.0.1", lst.bound_port))
            cs.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            tx = uring_mod.UringStream(cs, eng)
            rx_s = uring_mod.UringStream((await accept_t)._sock, eng)
        else:
            conn_fut = loop.create_future()
            server = await asyncio.start_server(
                lambda r, w: conn_fut.set_result((r, w)),
                "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            r1, w1 = await asyncio.open_connection("127.0.0.1", port)
            r2, _w2 = await conn_fut

        async def rx_uring():
            got = 0
            while got < total:
                got += len(await rx_s.read_some(1 << 20))

        async def rx_aio():
            got = 0
            while got < total:
                got += len(await r2.read(1 << 20))

        t0 = time.perf_counter()
        rt = asyncio.create_task(
            rx_uring() if io_impl == "uring" else rx_aio())
        sent = 0
        if io_impl == "uring":
            while sent < total:
                await tx.write(payload)
                sent += wsize
        else:
            while sent < total:
                w1.write(payload)
                await w1.drain()
                sent += wsize
        await rt
        rates.append(total / (time.perf_counter() - t0) / 1e6)
        if io_impl == "uring":
            await tx.close()
            await rx_s.close()
            await lst.close()
        else:
            w1.close()
            _w2.close()
            server.close()
            await server.wait_closed()
        await asyncio.sleep(0.02)
    return {"median": statistics.median(rates), "trials": rates,
            "total_mb": total_mb, "write_size": wsize,
            "io_impl": io_impl, "unit": "MB/s"}


def _main() -> None:
    """Run one row and print its result as one JSON line (``null`` for a
    row whose engine or library is unavailable): ``forward_rate`` by
    default, ``forward_rate_tcp`` with ``--io-impl``, ``stream_rate`` with
    ``--io-impl`` and ``--stream``."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("--route-impl", default="auto",
                    choices=("auto", "native", "python"))
    ap.add_argument("--io-impl", default=None, choices=("asyncio", "uring"),
                    help="user links over loopback TCP on this engine")
    ap.add_argument("--pump", default="off", choices=("off", "auto"),
                    help="fused data-plane pump for a TCP run (independent "
                         "of the process environment)")
    ap.add_argument("--transitions", action="store_true",
                    help="append an unmeasured sys.setprofile wave to a "
                         "TCP run and report interpreter transitions per "
                         "kmsg")
    ap.add_argument("--stream", action="store_true",
                    help="run the raw stream-throughput row instead of "
                         "broker forwarding (needs --io-impl)")
    ap.add_argument("--stream-mb", type=int, default=256)
    ap.add_argument("--receivers", type=int, default=None,
                    help="default: 8 over Memory, 4 over TCP")
    ap.add_argument("--msgs", type=int, default=2000)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--payload", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--parked-users", type=int, default=0)
    ap.add_argument("--churn", action="store_true")
    ap.add_argument("--incremental", choices=("on", "off"), default=None)
    ap.add_argument("--client-decode", action="store_true")
    args = ap.parse_args()
    if args.stream:
        if args.io_impl is None:
            ap.error("--stream needs --io-impl")
        out = asyncio.run(stream_rate(
            args.io_impl, total_mb=args.stream_mb, trials=args.trials))
    elif args.io_impl is not None:
        out = asyncio.run(forward_rate_tcp(
            args.io_impl, route_impl=args.route_impl,
            receivers=args.receivers or 4, msgs=args.msgs,
            trials=args.trials, payload=args.payload, batch=args.batch,
            pump=args.pump, count_transitions=args.transitions))
    else:
        out = asyncio.run(forward_rate(
            args.route_impl, receivers=args.receivers or 8, msgs=args.msgs,
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
