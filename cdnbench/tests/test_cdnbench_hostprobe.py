"""The host probe (``hostprobe.py``) and ``broker_cpu_ref_us_per_delivery``:
the probe runs its units and stops when told, holds nothing of the
program, of torch or of JAX, and the harness keeps the units of the
window; the reader's arithmetic and its None cases, on fake runs; and a
whole run rehearsed on the CPU with the probe and without it."""

import ast
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from cdnbench import common, hostprobe, run as harness
from cdnbench.e2e import broker_cpu_ref_us_per_delivery as reader
from cdnbench.e2e import broker_cpu_us_per_delivery as raw_reader

PROBE = [sys.executable, "-m", "cdnbench.hostprobe"]
HELD = {*common.FORBIDDEN_MODULES, common.PROGRAM, "torch"}
TCK = os.sysconf("SC_CLK_TCK")


def events(stdout):
    return [json.loads(line) for line in stdout.splitlines()]


def test_the_probe_runs_units_and_exits_cleanly_on_stop():
    p = subprocess.Popen(PROBE, cwd=common.ROOT, stdin=subprocess.PIPE,
                         stdout=subprocess.PIPE, text=True)
    try:
        ready = json.loads(p.stdout.readline())
        assert ready["event"] == "ready"
        assert ready["cipher"] == hostprobe.CIPHER == "TLS_AES_256_GCM_SHA384"
        units = [json.loads(p.stdout.readline()) for _ in range(3)]
        p.stdin.write("stop\n")
        p.stdin.flush()
        rest = events(p.stdout.read())
        assert p.wait(30) == 0
    finally:
        p.kill()
        p.wait()
    assert [u["event"] for u in units] == ["unit"] * 3
    ends = [u["end_ns"] for u in units]
    # one unit every 250 ms, each up to a 10 ms tick late
    gaps = [b - a for a, b in zip(ends, ends[1:])]
    assert all(0.2e9 < g < 0.4e9 for g in gaps), gaps
    assert all(len(u["us"]) == len(hostprobe.PARTS) and min(u["us"]) > 0
               for u in units)
    done = rest[-1]
    assert done["event"] == "done" and done["units"] >= 3
    # once it has worked, it holds nothing of the program, torch or JAX
    assert not HELD & set(done["modules"])
    assert {"ssl", "socket", "struct"} <= set(done["modules"])


def test_the_probe_stops_at_the_end_of_its_input_and_holds_nothing_forbidden():
    p = subprocess.run(PROBE, cwd=common.ROOT, input="", capture_output=True,
                       text=True, timeout=60)
    assert p.returncode == 0, p.stderr
    got = events(p.stdout)
    assert [e["event"] for e in got] == ["ready", "done"]
    assert got[-1]["units"] == 0
    assert not HELD & set(got[-1]["modules"])
    assert "ssl" in got[-1]["modules"]


def test_the_probe_imports_only_the_standard_library():
    tree = ast.parse(open(hostprobe.__file__).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= set(sys.stdlib_module_names) | {"__future__"}, names


def test_each_part_does_its_whole_work():
    probe = hostprobe.Probe()
    try:
        assert probe.frames() == hostprobe.FRAMES
        data = probe.tls()
        # 64 KB in four TLS records, each with its header and GCM tag
        assert len(hostprobe.PAYLOAD) < len(data) < len(hostprobe.PAYLOAD) + 256
        assert data[:64] != hostprobe.PAYLOAD[:64]
        assert probe.loopback(data) == len(data)
    finally:
        probe.close()


def bare_run(t0, t_end):
    r = harness.Run.__new__(harness.Run)
    r.t0, r.t_end = t0, t_end
    r.probe_units, r.probe_cpu_s = [], None
    return r


def start_probe(tmp_path, *pre):
    """The harness's probe child; ``pre`` runs in it before the probe."""
    argv = PROBE if not pre else [
        sys.executable, "-c",
        "; ".join([*pre, "from cdnbench import hostprobe",
                   "raise SystemExit(hostprobe.main())"])]
    return harness.Child("probe", argv, str(tmp_path), harness.child_env(),
                         stdout_events=True)


def test_the_harness_keeps_the_units_that_ended_in_the_window(tmp_path):
    kid = start_probe(tmp_path)
    try:
        kid.wait_event("ready", time.monotonic() + 30)
        t0 = time.monotonic_ns() + 300_000_000
        run = bare_run(t0, t0 + 800_000_000)
        time.sleep(1.4)
        harness.stop_probe(run, kid)
    finally:
        kid.kill()
    every = kid.all("unit")
    assert len(every) > len(run.probe_units) >= 2
    assert all(t0 <= u["end_ns"] < run.t_end for u in run.probe_units)
    assert kid.proc.returncode == 0


def test_a_probe_that_holds_torch_fails_the_run(tmp_path):
    kid = start_probe(tmp_path, "import sys, types",
                      "sys.modules['torch'] = types.ModuleType('torch')")
    try:
        kid.wait_event("ready", time.monotonic() + 30)
        with pytest.raises(harness.Failure, match="torch"):
            harness.stop_probe(bare_run(0, 1), kid)
    finally:
        kid.kill()


def test_the_reading_is_the_median_unit_and_each_parts_median():
    r = bare_run(0, 1)
    assert r.probe_reading() is None
    r.probe_units = [{"us": [100.0, 200.0, 300.0]},
                     {"us": [110.0, 190.0, 900.0]},
                     {"us": [90.0, 260.0, 310.0]}]
    r.probe_cpu_s = 0.03
    got = r.probe_reading()
    assert got["units"] == 3
    assert got["p_run_us"] == 660.0               # 600, 1200, 660
    assert got["part_wall_us_median"] == dict(frames=100.0, tls=200.0,
                                              loopback=310.0)
    assert got["cpu_us_per_unit"] == pytest.approx(1e4)
    r.probe_cpu_s = None
    assert r.probe_reading()["cpu_us_per_unit"] is None


def fake_run(spent_s, matched, p_run_us):
    """Broker trees whose CPU over the window is ``spent_s`` seconds in
    all, and a probe reading of ``p_run_us`` (None: no probe)."""
    trees = {"broker0": ({1: 0}, {1: int(spent_s * TCK * 0.25)}),
             "broker1": ({2: 0}, {2: int(spent_s * TCK * 0.75)})}
    reading = None if p_run_us is None else dict(p_run_us=p_run_us)
    return SimpleNamespace(broker_trees=trees, matched_in_window=matched,
                           probe_reading=lambda: reading)


def test_the_reader_scales_the_raw_metric_by_the_reference_over_the_probe():
    # 8 s of the brokers' CPU over 4000 deliveries: 2000 µs raw
    at_ref = fake_run(8.0, 4000, reader.P_REF_US)
    assert raw_reader.read(at_ref) == pytest.approx(2000.0)
    assert reader.read(at_ref) == pytest.approx(2000.0)
    assert reader.read(fake_run(8.0, 4000, reader.P_REF_US / 2)) \
        == pytest.approx(4000.0)


def test_a_probe_twice_as_slow_halves_the_metric():
    # the same CPU read on a host half as fast is half the work
    fast = reader.read(fake_run(8.0, 4000, 3000.0))
    slow = reader.read(fake_run(8.0, 4000, 6000.0))
    assert slow == pytest.approx(fast / 2)


@pytest.mark.parametrize("case", ["no probe", "probe read 0", "no delivery",
                                  "no tree"])
def test_the_reader_gives_none_where_it_has_nothing_to_read(case):
    r = fake_run(8.0, 4000, reader.P_REF_US)
    if case == "no probe":
        r = fake_run(8.0, 4000, None)
    elif case == "probe read 0":
        r = fake_run(8.0, 4000, 0.0)
    elif case == "no delivery":
        r.matched_in_window = 0
    else:
        r.broker_trees["broker1"] = ({2: 0}, None)
    assert reader.read(r) is None


def summary(stderr):
    for line in stderr.splitlines():
        if line.startswith('{"cell"'):
            return json.loads(line)
    raise AssertionError("no summary line:\n" + stderr[-3000:])


@pytest.mark.parametrize("probe", [1, 0])
def test_a_cpu_rehearsal_reads_the_probe_with_it_and_nothing_without(probe):
    """The probe runs beside the brokers and its reading is on the run's
    stderr; a run without it (``--probe 0``, the check of its own cost)
    has none. ``BENCHMARK.json`` lists no metric that reads it."""
    cell = "hotshot_1k_2b.views_replay"
    p = subprocess.run([sys.executable, "-m", "cdnbench.run", "--workload",
                        cell, "--seed", "2199023255581", "--seconds", "3",
                        "--trace", "0", "--rehearse-cpu", "--rate", "2",
                        "--probe", str(probe)], cwd=common.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"]
    assert "broker_cpu_us_per_delivery" not in r["metrics"]
    assert "broker_cpu_ref_us_per_delivery" not in r["metrics"]
    s = summary(p.stderr)
    if not probe:
        assert s["probe"] is None
        assert "probe" not in s["cpu_cores_in_window"]
        return
    reading = s["probe"]
    assert reading["units"] >= 10                  # 4 a second for 3 s
    assert set(reading["part_wall_us_median"]) == set(hostprobe.PARTS)
    assert reading["p_run_us"] >= sum(
        reading["part_wall_us_median"].values()) * 0.5
    assert reading["cpu_us_per_unit"] is not None
    assert "probe" in s["cpu_cores_in_window"]
