"""Runs the program's broker binary for the benchmark.

    python -m cdnbench.broker_launch <run dir> <name> <trace 0|1> \
        [--plant <fault>] -- <broker flags>

It calls ``pushcdn_tpu_torch.bin.broker.main`` with the flags given, as
``python -m pushcdn_tpu_torch.bin.broker`` would, and at exit writes
``<name>-exit.json``: the card, the peak of device memory the process
allocated, and any module of JAX or of the JAX package that the process
holds by then. The program is not changed.

With trace 1 a thread reads ``arm``, ``start`` and ``stop`` on stdin.
``arm`` starts ``torch.profiler`` over CUDA activity during set-up (its
start takes seconds) and writes ``<name>-armed``. ``start`` opens the
window: a marker kernel on the card, and from then on each launch of the
dense delivery kernel (whose launcher is wrapped) keeps its inputs.
``stop`` closes it with a second marker, stops the profiler and writes
``<name>-trace.json``: the window's length, the union of the intervals
in which an operation ran on the device, the device time of each
operation by name, the longest idle gaps, and for the dense kernel its
launches, the bytes and operations each needed (``roofline.py``) and
their device time from the profiler. Nothing of that runs in an untraced
run.

``--plant`` breaks the timed path underneath, for the checks that
``correct`` fails: ``stale`` (every step of the plane routes nothing),
``half`` (the plane routes the first half of each step's frames only),
``alter`` (one byte of every frame the plane routes is changed),
``nolink`` (nothing is forwarded to another broker). ``cost`` changes no
byte and makes the broker dearer instead, for the check that
``broker_cpu_us_per_delivery`` follows the brokers' cost: it burns
``COST_US`` µs of the event loop's thread on the CPU (``cost:<µs>`` another
amount; ``cost:0`` only counts) at every flush of a TCP+TLS stream
(``AsyncioStream.write``/``writev``), and the exit record counts those
flushes by second. The benchmark's own runs never plant anything.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
DENSE_KERNEL = "delivery_matrix_kernel"
MARKER = "spin_kernel"      # torch.cuda._sleep's kernel marks the window
MARK_CYCLES = 1000
NAME_CHARS = 96             # a device operation's name, as reported
# the ``cost`` plant's burn a TLS flush: with 0.48 flushes a delivery in
# hotshot_1k_2b.views_replay (a clean run on the H100's host) it adds
# ~240 us to a delivery's ~250 us of broker CPU
COST_US = 500


class Window:
    """The traced window: the profiler and the dense launches in it."""

    def __init__(self, rundir: str, name: str):
        self.rundir, self.name = rundir, name
        self.active = False
        self.launches = []     # each launch's inputs
        self.prof = None
        self.t_start = self.t_stop = 0.0

    def wrap_dense(self) -> None:
        from pushcdn_tpu_torch.ops import delivery_kernel
        launch = delivery_kernel.delivery_matrix_cuda

        def traced(user_masks, local, frame_tmask, kind, dest):
            if self.active:
                self.launches.append((user_masks, local, frame_tmask, kind,
                                      dest))
            return launch(user_masks, local, frame_tmask, kind, dest)

        delivery_kernel.delivery_matrix_cuda = traced

    def arm(self) -> None:
        """Start the profiler before the window: its start takes seconds
        and holds the interpreter, so it belongs to set-up."""
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        with open(os.path.join(self.rundir, f"{self.name}-armed"), "w"):
            pass

    def start(self) -> None:
        import torch
        torch.cuda._sleep(MARK_CYCLES)   # the window's start on the card
        self.t_start = time.monotonic()
        self.active = True

    def stop(self) -> None:
        import torch
        self.active = False
        self.t_stop = time.monotonic()
        torch.cuda._sleep(MARK_CYCLES)   # the window's end on the card
        torch.cuda.synchronize()
        self.prof.stop()
        path = os.path.join(self.rundir, f"{self.name}-chrome.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
        self.write(summarize(events, self.t_stop - self.t_start,
                             self.dense_launches()))

    def dense_launches(self) -> dict:
        from cdnbench.roofline import bound, dense_work
        nbytes = ops = 0
        bound_s = 0.0
        for args in self.launches:
            b, o = dense_work(*args)
            nbytes += b
            ops += o
            bound_s += bound(b, o)["bound_ms"] / 1e3
        return dict(launches=len(self.launches), bytes=nbytes, ops=ops,
                    bound_s=bound_s)

    def write(self, summary: dict) -> None:
        path = os.path.join(self.rundir, f"{self.name}-trace.json")
        with open(path + ".tmp", "w") as f:
            json.dump(summary, f)
        os.replace(path + ".tmp", path)


def union_length(intervals) -> tuple:
    """``(busy seconds, gaps)`` of ``[(start_us, end_us, name)]``: the
    length of their union, and every gap between its pieces as
    ``(seconds, name of the operation before it)``."""
    busy = 0.0
    gaps = []
    cur_s = cur_e = None
    last = ""
    for s, e, name in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append(((s - cur_e) / 1e6, last))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        if e >= cur_e:
            last = name
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6, gaps


def summarize(events, window_s: float, dense: dict) -> dict:
    """The device operations of one process inside its window: between
    the two marker kernels where the trace holds them (the card's own
    clock), else all of them over the host clock's window."""
    ops = [(float(ev["ts"]), float(ev.get("dur", 0.0)),
            ev.get("name", "?")[:NAME_CHARS])
           for ev in events
           if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS]
    marks = sorted(s for s, d, n in ops if MARKER in n)
    lo, hi = -float("inf"), float("inf")
    if len(marks) >= 2:
        lo, hi = marks[0], marks[-1]
        window_s = (hi - lo) / 1e6
    intervals = []
    by_name = {}
    dense_s = 0.0
    dense_n = 0
    for s, d, name in ops:
        if MARKER in name or s <= lo or s >= hi:
            continue
        intervals.append((s, s + d, name))
        by_name[name] = by_name.get(name, 0.0) + d / 1e6
        if DENSE_KERNEL in name:
            dense_s += d / 1e6
            dense_n += 1
    busy_s, gaps = union_length(intervals)
    gaps.sort(reverse=True)
    return dict(window_s=window_s, busy_s=busy_s, device_ops=len(intervals),
                marked=len(marks) >= 2,
                ops=sorted(([n, s] for n, s in by_name.items()),
                           key=lambda x: -x[1])[:10],
                gaps=[[f"after {n}", s] for s, n in gaps[:10]],
                dense=dict(dense, trace_launches=dense_n,
                           trace_s=dense_s))


def control(window: Window) -> None:
    for line in sys.stdin:
        cmd = line.strip()
        try:
            if cmd == "arm":
                window.arm()
            elif cmd == "start":
                window.start()
            elif cmd == "stop":
                window.stop()
        except Exception as exc:   # the harness reads the reason
            window.write({"error": repr(exc)})


class CostPlant:
    """Burns ``cost_us`` of the calling thread's time on the CPU at each
    flush of a TLS stream, spinning on the monotonic clock, and counts
    those flushes by second of that clock (the harness's window is on the
    same clock). It spins on wall time because the thread CPU clock of the
    H100's host advances in 10 ms ticks, so a spin on it burns a whole
    tick (there 2,000 spins of 200 us on it took 20 s)."""

    def __init__(self, cost_us: float):
        self.cost_us = cost_us
        self.flushes = 0
        self.burned_ns = 0
        self.by_s: dict = {}

    def burn(self) -> None:
        self.flushes += 1
        s = int(time.monotonic())
        self.by_s[s] = self.by_s.get(s, 0) + 1
        start = time.perf_counter_ns()
        end = start + int(self.cost_us * 1e3)
        now = start
        while now < end:
            now = time.perf_counter_ns()
        self.burned_ns += now - start

    def wrap(self, flush):
        async def costly(stream, *args):
            tls = getattr(stream, "_planted_tls", None)
            if tls is None:
                tls = stream.writer.get_extra_info("ssl_object") is not None
                stream._planted_tls = tls
            if tls:
                self.burn()
            return await flush(stream, *args)
        return costly

    def record(self) -> dict:
        return dict(cost_us=self.cost_us, flushes=self.flushes,
                    burned_s=self.burned_ns / 1e9, flushes_by_s=self.by_s)


def plant(fault: str):
    """Break the timed path underneath, or make it dearer (see the
    module's docstring); the ``cost`` plant is returned for its record."""
    from pushcdn_tpu_torch.broker import device_plane
    if fault == "cost" or fault.startswith("cost:"):
        from pushcdn_tpu_torch.proto.transport.base import AsyncioStream
        cost = CostPlant(float(fault[5:]) if ":" in fault else COST_US)
        AsyncioStream.write = cost.wrap(AsyncioStream.write)
        AsyncioStream.writev = cost.wrap(AsyncioStream.writev)
        return cost
    if fault in ("stale", "half", "alter"):
        run_step = device_plane.DevicePlane._run_step

        def broken(self, lane_batches, *args, warmup=False, **kw):
            if not warmup:
                for b in lane_batches:
                    idx = b.valid.nonzero()[0]
                    if not idx.size:
                        continue
                    if fault == "stale":
                        b.valid[:] = False
                    elif fault == "half":
                        b.valid[idx[idx.size // 2:]] = False
                    else:
                        for i in idx:
                            b.bytes_[i, b.length[i] - 1] ^= 1
            return run_step(self, lane_batches, *args, warmup=warmup, **kw)

        device_plane.DevicePlane._run_step = broken
    elif fault == "nolink":
        from pushcdn_tpu_torch.broker.tasks import handlers
        route = handlers.route_broadcast

        def no_link(broker, topics, raw, to_users_only, egress, **kw):
            return route(broker, topics, raw, True, egress, **kw)

        handlers.route_broadcast = no_link
    else:
        raise SystemExit(f"unknown fault {fault!r}")
    return None


def main() -> None:
    rundir, name, trace = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
    rest = sys.argv[4:]
    fault = None
    if rest[:1] == ["--plant"]:
        fault, rest = rest[1], rest[2:]
    if rest[:1] == ["--"]:
        rest = rest[1:]
    from pushcdn_tpu_torch.bin import broker
    planted = plant(fault) if fault else None
    if trace:
        window = Window(rundir, name)
        window.wrap_dense()
        threading.Thread(target=control, args=(window,), daemon=True).start()
    sys.argv = ["pushcdn-broker", *rest]
    code = 0
    try:
        broker.main()
    except SystemExit as exc:
        code = exc.code if isinstance(exc.code, int) else 1
    from cdnbench.common import forbidden_loaded
    out = {"code": code, "forbidden": forbidden_loaded(sys.modules)}
    if planted is not None:
        out["planted"] = planted.record()
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_available() \
            and torch.cuda.is_initialized():
        out.update(card=torch.cuda.get_device_name(0),
                   memory_peak_bytes=torch.cuda.max_memory_allocated(0))
    with open(os.path.join(rundir, f"{name}-exit.json"), "w") as f:
        json.dump(out, f)
    sys.exit(code)


if __name__ == "__main__":
    main()
