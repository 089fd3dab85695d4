"""``broker_cpu_us_per_delivery``: the process-tree CPU samples it reads
(``proctree``), its arithmetic, and the ``cost`` plant that makes the
brokers dearer without changing a byte (``broker_launch --plant cost``),
on hand-made ``/proc`` trees, real processes, a fake stream and a whole
run rehearsed on the CPU."""

import asyncio
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from cdnbench import broker_launch, common, proctree
from cdnbench.e2e import broker_cpu_us_per_delivery as reader

TCK = os.sysconf("SC_CLK_TCK")


def stat_line(pid, ppid, utime, stime, cutime=0, cstime=0, comm="py thon)"):
    # the command's name may hold spaces and ")": fields follow the last
    return (f"{pid} ({comm}) S {ppid} {pid} {pid} 0 -1 4194560 100 0 0 0 "
            f"{utime} {stime} {cutime} {cstime} 20 0 3 0 1234 0 0\n")


def fake_proc(path, procs):
    """A /proc holding ``{pid: (ppid, utime, stime, cutime, cstime)}``."""
    path.mkdir(exist_ok=True)
    for old in path.iterdir():
        (old / "stat").unlink()
        old.rmdir()
    for pid, (ppid, *ticks) in procs.items():
        (path / str(pid)).mkdir()
        (path / str(pid) / "stat").write_text(stat_line(pid, ppid, *ticks))
    (path / "self").mkdir()   # not a pid: skipped
    (path / "self" / "stat").write_text("")


def run_of(trees, matched):
    return SimpleNamespace(broker_trees=trees, matched_in_window=matched)


def test_parse_stat_reads_past_the_command_name():
    st = proctree.parse_stat(stat_line(7, 3, 100, 20, 5, 1))
    assert st == dict(ppid=3, own=120, reaped=6)


def test_the_reader_divides_the_brokers_cpu_by_the_matched_deliveries(
        tmp_path):
    proc = tmp_path / "proc"
    fake_proc(proc, {10: (1, 100, 50, 0, 0), 20: (1, 300, 100, 7, 3),
                     30: (1, 9000, 9000, 0, 0)})     # 30: not a broker
    before = proctree.sample({"broker0": 10, "broker1": 20}, str(proc))
    fake_proc(proc, {10: (1, 100 + 4 * TCK, 50 + TCK, 0, 0),
                     20: (1, 300 + 2 * TCK, 100, 7, 3 + TCK),
                     30: (1, 99000, 99000, 0, 0)})
    after = proctree.sample({"broker0": 10, "broker1": 20}, str(proc))
    trees = {n: (before[n], after[n]) for n in before}
    # broker0 used 5 s, broker1 3 s; 8 s over 4000 deliveries is 2000 µs
    assert reader.read(run_of(trees, 4000)) == pytest.approx(2000.0)
    assert proctree.cpu_s(*trees["broker0"]) == pytest.approx(5.0)


def test_a_descendants_cpu_is_summed_into_its_broker(tmp_path):
    """A grandchild alive at both ends is read in full; a child reaped in
    between comes up through its parent's cutime/cstime less what it had
    used by the first sample; another tree is not counted."""
    proc = tmp_path / "proc"
    fake_proc(proc, {10: (1, 100, 0, 0, 0), 11: (10, 40, 10, 0, 0),
                     12: (11, 5, 5, 0, 0), 13: (10, 30, 0, 0, 0),
                     20: (1, 500, 0, 0, 0), 21: (20, 60, 0, 0, 0)})
    before = proctree.sample({"broker0": 10, "broker1": 20}, str(proc))
    assert set(before["broker0"]) == {10, 11, 12, 13}
    # 12 burns 200 ticks; 13 burns 50 more, exits and is reaped by 10
    fake_proc(proc, {10: (1, 100, 0, 80, 0), 11: (10, 40, 10, 0, 0),
                     12: (11, 205, 5, 0, 0),
                     20: (1, 500, 0, 0, 0), 21: (20, 60, 0, 0, 0)})
    after = proctree.sample({"broker0": 10, "broker1": 20}, str(proc))
    assert proctree.cpu_s(before["broker0"], after["broker0"], 100) \
        == pytest.approx((200 + 50) / 100)
    assert proctree.cpu_s(before["broker1"], after["broker1"], 100) == 0


BURNER = """import os, sys, time, subprocess
if sys.argv[1] == "child":
    open(sys.argv[2] + ".up", "w").close()
    while not os.path.exists(sys.argv[2] + ".go"):
        time.sleep(0.01)
    end = time.thread_time() + 0.4
    while time.thread_time() < end:
        pass
    open(sys.argv[2] + ".done", "w").close()
    time.sleep(60)
else:
    subprocess.Popen([sys.executable, __file__, "child", sys.argv[2]])
    time.sleep(60)
"""


def wait_for(path, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        assert time.monotonic() < deadline, f"no {path}"
        time.sleep(0.01)


def test_a_live_childs_cpu_counts_for_its_parent(tmp_path):
    script = tmp_path / "burner.py"
    script.write_text(BURNER)
    flag = str(tmp_path / "flag")
    p = subprocess.Popen([sys.executable, str(script), "parent", flag],
                         start_new_session=True)
    try:
        wait_for(flag + ".up")
        before = proctree.sample({"root": p.pid})["root"]
        assert len(before) == 2
        open(flag + ".go", "w").close()
        wait_for(flag + ".done")
        after = proctree.sample({"root": p.pid})["root"]
        assert proctree.cpu_s(before, after) >= 0.35
    finally:
        os.killpg(p.pid, 9)
        p.wait(10)


def test_no_matched_delivery_or_no_tree_gives_no_value():
    tree = {10: 100}
    assert reader.read(run_of({"broker0": (tree, {10: 200})}, 0)) is None
    assert reader.read(run_of({"broker0": (tree, None)}, 50)) is None
    assert reader.read(run_of({}, 50)) is None
    assert proctree.sample({"gone": 2 ** 22 + 12345}) == {"gone": None}


class FakeWriter:
    def __init__(self, tls):
        self.tls, self.sent = tls, []

    def get_extra_info(self, key):
        return object() if key == "ssl_object" and self.tls else None

    def write(self, data):
        self.sent.append(bytes(data))

    def writelines(self, bufs):
        self.sent.append(b"".join(bytes(b) for b in bufs))

    async def drain(self):
        pass


def test_the_cost_plant_burns_its_cpu_at_each_tls_flush_and_counts_it():
    from pushcdn_tpu_torch.proto.transport.base import AsyncioStream
    saved = AsyncioStream.write, AsyncioStream.writev
    try:
        cost = broker_launch.plant("cost:2000")
        tls = AsyncioStream(None, FakeWriter(tls=True))
        plain = AsyncioStream(None, FakeWriter(tls=False))

        async def flushes():
            for i in range(5):
                await tls.write(b"a%d" % i)
            await tls.writev([b"b", memoryview(b"c")])
            for _ in range(5):
                await plain.write(b"x")

        t = time.thread_time()
        asyncio.run(flushes())
        spent = time.thread_time() - t
    finally:
        AsyncioStream.write, AsyncioStream.writev = saved
    # the bytes are unchanged; only the TLS stream's 6 flushes cost
    assert tls.writer.sent == [b"a0", b"a1", b"a2", b"a3", b"a4", b"bc"]
    assert plain.writer.sent == [b"x"] * 5
    rec = cost.record()
    assert rec["flushes"] == 6 and sum(rec["flushes_by_s"].values()) == 6
    assert rec["cost_us"] == 2000
    # each flush spins at least its 2000 us; the thread's CPU clock sees
    # all of it unless the scheduler takes the CPU away mid-spin
    assert rec["burned_s"] >= 6 * 2000e-6
    assert spent >= 0.8 * 6 * 2000e-6


def test_the_stated_cost_is_the_default():
    assert broker_launch.CostPlant(broker_launch.COST_US).cost_us > 0


def summary(stderr):
    for line in stderr.splitlines():
        if line.startswith('{"cell"'):
            return json.loads(line)
    raise AssertionError("no summary line:\n" + stderr[-3000:])


def test_a_cpu_rehearsal_under_the_cost_plant_stays_correct():
    """The plant changes no byte: the run is correct, the metric is on
    its line, and the brokers' CPU a delivery holds at least the burn of
    the flushes counted in the window."""
    cell = "pubsub_1k.wide_10k_under"
    p = subprocess.run([sys.executable, "-m", "cdnbench.run", "--workload",
                        cell, "--seed", "2199023255579", "--seconds", "3",
                        "--trace", "0", "--rehearse-cpu", "--rate", "100",
                        "--plant", "cost"], cwd=common.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0
    assert all(v["value"] <= v["limit"] for v in r["checks"].values())
    got = r["metrics"]["broker_cpu_us_per_delivery"]
    assert got["unit"] == "us"
    s = summary(p.stderr)
    planted = s["planted"]
    assert set(planted) == {"broker0"}
    burned_us = sum(b["cost_us"] * b["flushes_in_window"]
                    for b in planted.values())
    assert burned_us > 0
    assert got["value"] >= 0.9 * burned_us / s["matched_in_window"]
