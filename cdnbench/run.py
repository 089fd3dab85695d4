"""Runs one cell of the benchmark once and prints one JSON line.

    python3 -m cdnbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a deployment
(``configs/<config>.json``) and a traffic mix (``workloads/<cell>.json``,
whose ``kind`` names the generator ``traffic/<kind>.py``). The run starts
the deployment as users do: a marshal and the deployment's brokers as
processes of the program's binaries (the brokers through
``broker_launch``), and its users as the program's ``Client``s in
``generators`` load-generator processes (``gen.py``), each role on the
cores the deployment's ``cpus`` gives it. It waits until the planes are
warm and every user is connected, opens the window for ``--seconds``,
lets the traffic run, waits for every delivery due, and stops every
process it started. Each process's CPU use over the window is printed on
stderr beside the run's other readings. A host probe (``hostprobe.py``)
runs a fixed unit of work beside the brokers, on their cores, through
set-up and the window, so the run can read how fast the host was.

``correct`` compares every delivery every user received with what the
oracle (``oracle.py``) says each is due, and each check of the traffic's
own. The end-to-end metrics (``--trace 0``) or the per-layer metrics
(``--trace 1``, which also traces each broker's card time) are read by
the modules named after them in ``e2e/`` and ``layers/``.

The run needs a CUDA card, as many as the cell asks for, and the program
beside it; without either it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np

if __package__ in (None, ""):   # run as a script: python3 cdnbench/run.py
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from cdnbench import common, hostprobe, oracle, proctree, traffic  # noqa

LEAD_S = 1.5           # from "go" to the window's start (warm-up inside)
DRAIN_S = 60.0         # the longest wait for deliveries after the window
RUN_LIMIT_S = 330.0    # a run ends well inside its 360 s
QUIET_S = 2.0          # no delivery for this long after the window: done


class Failure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def now_ns() -> int:
    return time.monotonic_ns()


def tail(path: str, n: int = 3000) -> str:
    try:
        with open(path, "rb") as f:
            return f.read().decode(errors="replace")[-n:]
    except OSError:
        return ""


def parse_cpus(spec: str) -> set:
    """``"0-1,4"`` -> ``{0, 1, 4}``."""
    out = set()
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out.update(range(int(lo), int(hi or lo) + 1))
    return out


class Child:
    """One process of the run, in its own session, logging to a file."""

    def __init__(self, name: str, argv: List[str], rundir: str, env: dict,
                 stdout_events: bool = False, cpus: Optional[set] = None):
        self.name = name
        self.log = os.path.join(rundir, f"{name}.log")
        self.events: List[dict] = []
        self._cv = threading.Condition()
        pin = (lambda: os.sched_setaffinity(0, cpus)) if cpus else None
        with open(self.log, "ab") as sink:
            self.proc = subprocess.Popen(
                argv, cwd=common.ROOT, env=env, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE if stdout_events else sink,
                stderr=sink, start_new_session=True, text=True,
                preexec_fn=pin)
        if stdout_events:
            threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            with self._cv:
                self.events.append(ev)
                self._cv.notify_all()

    def send(self, line: str) -> None:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def wait_event(self, event: str, deadline: float) -> dict:
        with self._cv:
            while True:
                for ev in self.events:
                    if ev.get("event") == event:
                        return ev
                if self.proc.poll() is not None:
                    raise Failure(f"{self.name} exited with "
                                  f"{self.proc.returncode} before {event!r}"
                                  f":\n{tail(self.log)}")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise Failure(f"{self.name}: no {event!r} in time:\n"
                                  f"{tail(self.log)}")
                self._cv.wait(min(left, 0.5))

    def last(self, event: str) -> Optional[dict]:
        with self._cv:
            for ev in reversed(self.events):
                if ev.get("event") == event:
                    return ev
        return None

    def all(self, event: str) -> List[dict]:
        with self._cv:
            return [ev for ev in self.events if ev.get("event") == event]

    def log_line(self, what: str) -> Optional[dict]:
        """The JSON of the last ``<what> {...}`` line in the log."""
        found = None
        for line in tail(self.log, 1 << 20).splitlines():
            at = line.find(what + " {")
            if at >= 0:
                try:
                    found = json.loads(line[at + len(what) + 1:])
                except ValueError:
                    pass
        return found

    def alive(self) -> bool:
        return self.proc.poll() is None

    def cpu_s(self) -> Optional[float]:
        """The user and system CPU seconds the process has used, all its
        threads, from /proc; None once it is gone."""
        try:
            with open(f"/proc/{self.proc.pid}/stat") as f:
                own = proctree.parse_stat(f.read())["own"]
        except OSError:
            return None
        return own / os.sysconf("SC_CLK_TCK")

    def wait_exit(self, timeout: float) -> Optional[int]:
        """The exit code once the process ends on its own, or after
        ``stop`` when it does not within ``timeout``."""
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            pass
        return self.stop(5)

    def stop(self, timeout: float) -> Optional[int]:
        """SIGTERM, then SIGKILL after ``timeout``; reaped either way."""
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
            try:
                self.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                pass
        self.kill()
        return self.proc.returncode

    def kill(self) -> None:
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        self.proc.wait()
        for f in (self.proc.stdin, self.proc.stdout):
            try:
                if f is not None:
                    f.close()
            except OSError:
                pass


class Run:
    """One run: what the readers of ``e2e/`` and ``layers/`` read."""

    def __init__(self, cell: str, cfg: dict, wl: dict, seed: int,
                 seconds: float, trace: bool):
        self.cell, self.cfg, self.wl = cell, cfg, wl
        self.seed, self.window_s, self.trace = seed, float(seconds), trace
        self.kind = traffic.kind(wl["kind"])
        self.setup_s = 0.0
        self.t0 = self.t_end = self.t_waited = 0
        self.scrapes: Dict[str, tuple] = {}
        self.traces: Dict[str, dict] = {}
        self.exits: Dict[str, dict] = {}
        self.want = np.empty(0, np.int64)
        self.recv = {}
        self.sends = {}
        self.extra = {}
        self.matched_in_window = 0
        self._lat = None
        self.cpu_cores: Dict[str, float] = {}
        self.broker_trees: Dict[str, tuple] = {}
        self.probe_units: List[dict] = []
        self.probe_cpu_s: Optional[float] = None

    # -- deliveries -------------------------------------------------------

    def load(self, paths: List[str]) -> None:
        parts = [np.load(p) for p in paths]
        cat = lambda k: np.concatenate([p[k] for p in parts])  # noqa: E731
        self.recv = {k: cat("r_" + k) for k in ("code", "ns", "ref")}
        self.sends = {k: cat("s_" + k) for k in ("pub", "seq", "mtype",
                                                 "target", "t0", "t1",
                                                 "ref", "ns")}
        keys = sorted({k[2:] for p in parts for k in p.files
                       if k.startswith("x_")})
        self.extra = {k: np.concatenate([p["x_" + k] for p in parts
                                         if "x_" + k in p.files])
                      for k in keys}

    def judge(self) -> dict:
        s = self.sends
        topics = self.kind.users_topics(self.cfg, self.wl, self.seed)
        self.want = oracle.expected(topics, self.cfg["topics"], s["pub"],
                                    s["seq"], s["target"], s["t0"], s["t1"])
        numbers = oracle.judge(self.want, self.recv["code"])
        numbers.update(self.kind.checks(self.cfg, self.wl, self.seed,
                                        self.window_s, s, self.extra,
                                        rate=self.rate))
        return numbers

    def _first_receipts(self):
        """Clean receipts each once (the first), with their arrival."""
        code, ns = self.recv["code"], self.recv["ns"]
        clean = (code & oracle.CORRUPT) == 0
        code, ns = code[clean], ns[clean]
        uniq, first = np.unique(code, return_index=True)
        return uniq, ns[first]

    def window_numbers(self) -> None:
        """Deliveries matched in the window and every delivery's latency."""
        uniq, arrival = self._first_receipts()
        expected = np.isin(uniq, self.want)
        inside = (arrival >= self.t0) & (arrival < self.t_end)
        self.matched_in_window = int((expected & inside).sum())
        # each due delivery's ref time, from its send
        s = self.sends
        sender = (s["pub"] << oracle.SEQ_BITS) | s["seq"]
        order = np.argsort(sender)
        sender, ref = sender[order], s["ref"][order]
        want_sender = self.want & ((np.int64(1) << 40) - 1)
        idx = np.clip(np.searchsorted(sender, want_sender), 0,
                      max(sender.size - 1, 0))
        want_ref = ref[idx] if sender.size else np.empty(0, np.int64)
        due = (want_ref >= self.t0) & (want_ref < self.t_end)
        pos = np.searchsorted(uniq, self.want)
        pos_c = np.clip(pos, 0, max(uniq.size - 1, 0))
        got = (uniq.size > 0) & (uniq[pos_c] == self.want) \
            if uniq.size else np.zeros(self.want.size, bool)
        done = np.where(got, arrival[pos_c] if uniq.size else 0,
                        self.t_waited)
        self._lat = ((done - want_ref)[due]) / 1e6

    def latencies_ms(self) -> np.ndarray:
        return self._lat

    def views_closed_in_window(self) -> int:
        ns = self.extra.get("quorum_ns", np.empty(0, np.int64))
        return int(((ns >= self.t0) & (ns < self.t_end)).sum())

    def generator_late_ms(self) -> Optional[float]:
        s = self.sends
        inside = (s["ref"] >= self.t0) & (s["ref"] < self.t_end)
        if self.wl.get("loop") != "open" or not inside.any():
            return None
        return common.percentile((s["ns"] - s["ref"])[inside] / 1e6, 0.99)

    def broker_tree_cores(self) -> Dict[str, Optional[float]]:
        """Each broker's process tree's CPU over the window, in cores."""
        out = {}
        for name, (before, after) in self.broker_trees.items():
            spent = proctree.cpu_s(before, after)
            out[name] = None if spent is None else spent / self.window_s
        return out

    def probe_reading(self) -> Optional[dict]:
        """The host probe over the window: its units that ended in it, the
        median of their wall µs (``p_run_us``) and of each part's, and its
        CPU µs a unit from ``/proc`` at the window's ends; None without a
        probe or a unit.

        ``p_run_us`` is a median of wall times, not the CPU a unit: the
        host's CPU clock moves in 10 ms ticks, and a unit of a few ms is
        charged a whole tick or none, so over 15 s windows of the probe
        alone its CPU a unit read 1.05-1.29 times its median wall time
        (PERF.md, section 2)."""
        if not self.probe_units:
            return None
        walls = np.array([u["us"] for u in self.probe_units])
        cpu = self.probe_cpu_s
        return dict(
            units=len(self.probe_units),
            p_run_us=float(np.median(walls.sum(axis=1))),
            part_wall_us_median=dict(zip(
                hostprobe.PARTS, np.median(walls, axis=0).tolist())),
            cpu_us_per_unit=None if cpu is None
            else 1e6 * cpu / len(self.probe_units))

    def planted_in_window(self) -> Dict[str, dict]:
        """A planted cost's flushes inside the window (each second's
        count weighted by its overlap with the window), per broker; empty
        in the benchmark's own runs."""
        lo, hi = self.t0 / 1e9, self.t_end / 1e9
        out = {}
        for name, ex in self.exits.items():
            got = ex.get("planted")
            if not got:
                continue
            n = sum(c * max(0.0, min(int(s) + 1, hi) - max(int(s), lo))
                    for s, c in got["flushes_by_s"].items())
            out[name] = dict(cost_us=got["cost_us"], flushes=got["flushes"],
                             flushes_in_window=n)
        return out

    # -- traces -----------------------------------------------------------

    def trace_window_s(self) -> float:
        ws = [t["window_s"] for t in self.traces.values() if "window_s" in t]
        return float(np.mean(ws)) if ws else self.window_s

    def device_busy_s(self) -> Optional[float]:
        """Seconds the profiler saw an operation on the card, summed over
        the brokers that share it; None where it saw none."""
        if not any(t.get("device_ops") for t in self.traces.values()):
            return None
        return float(sum(t["busy_s"] for t in self.traces.values()))


# ---------------------------------------------------------------------------
# the deployment
# ---------------------------------------------------------------------------


def child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = (common.ROOT + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else common.ROOT)
    env["PYTHONUNBUFFERED"] = "1"
    env.setdefault("USE_FLAX", "0")
    return env


def raise_fd_limit() -> None:
    import resource
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft != hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))


def scrape(port: int) -> list:
    got = common.http_get(port, "/metrics", timeout=30)
    if got is None or got[0] != 200:
        raise Failure(f"the broker on metrics port {port} did not answer "
                      "/metrics")
    return common.parse_metrics(got[1])


def scrape_all(ports: Dict[str, int]) -> Dict[str, list]:
    out: Dict[str, list] = {}
    errors = []

    def one(name, port):
        try:
            out[name] = scrape(port)
        except Failure as exc:
            errors.append(exc)
    threads = [threading.Thread(target=one, args=kv) for kv in ports.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def sleep_until(t_ns: int) -> None:
    left = (t_ns - now_ns()) / 1e9
    if left > 0:
        time.sleep(left)


def cpus_for(run: Run, role: str) -> Optional[set]:
    """The cores the deployment's ``cpus`` gives ``role``, of those this
    process may use; None (no pinning) where it gives none of them."""
    spec = run.cpus.get(role)
    if not spec:
        return None
    return (parse_cpus(spec) & os.sched_getaffinity(0)) or None


def cpu_sample(kids: Dict[str, Child]) -> Dict[str, Optional[float]]:
    return {n: k.cpu_s() for n, k in kids.items()}


def stop_probe(run: Run, kid: Child) -> None:
    """Stops the host probe and keeps its units that ended in the window;
    a probe that held the program, torch or JAX fails the run."""
    kid.send("stop")
    done = kid.wait_event("done", time.monotonic() + 30)
    held = sorted(set(done["modules"]) & {*common.FORBIDDEN_MODULES,
                                          common.PROGRAM, "torch"})
    if held:
        raise Failure(f"the host probe loaded {held}")
    if kid.wait_exit(10) != 0:
        raise Failure(f"the host probe exited with {kid.proc.returncode}:\n"
                      f"{tail(kid.log)}")
    run.probe_units = [ev for ev in kid.all("unit")
                       if run.t0 <= ev["end_ns"] < run.t_end]


def deploy_and_drive(run: Run, args, rundir: str, kids: Dict[str, Child],
                     t_start: float) -> None:
    cfg, env = run.cfg, child_env()
    env.update(cfg.get("env", {}))
    if args.probe:
        kids["probe"] = Child("probe", [sys.executable, "-m",
                                        "cdnbench.hostprobe"], rundir, env,
                              stdout_events=True, cpus=cpus_for(run, "probe"))
    db = os.path.join(rundir, "discovery.sqlite")
    common_flags = ["--discovery-endpoint", db,
                    "--user-transport", cfg["user_transport"],
                    "--scheme", cfg["scheme"]]
    metrics_ports: Dict[str, int] = {}
    for b, spec in enumerate(cfg["brokers"]):
        name = f"broker{b}"
        pub, priv, met = (common.free_port() for _ in range(3))
        metrics_ports[name] = met
        flags = [*common_flags, "--broker-transport", cfg["broker_transport"],
                 "--public-advertise-endpoint", f"127.0.0.1:{pub}",
                 "--public-bind-endpoint", f"127.0.0.1:{pub}",
                 "--private-advertise-endpoint", f"127.0.0.1:{priv}",
                 "--private-bind-endpoint", f"127.0.0.1:{priv}",
                 "--metrics-bind-endpoint", f"127.0.0.1:{met}",
                 *spec.get("flags", [])]
        if spec.get("device_plane"):
            flags.append("--device-plane")
            if args.rehearse_cpu:
                flags += ["--device", "cpu"]
        plant = ["--plant", args.plant] if args.plant else []
        kids[name] = Child(name, [sys.executable, "-m",
                                  "cdnbench.broker_launch", rundir, name,
                                  "1" if run.trace else "0", *plant, "--",
                                  *flags], rundir, env,
                          cpus=cpus_for(run, "brokers"))
    marshal_port, marshal_met = common.free_port(), common.free_port()
    kids["marshal"] = Child("marshal", [
        sys.executable, "-m", "pushcdn_tpu_torch.bin.marshal",
        *common_flags, "--bind-endpoint", f"127.0.0.1:{marshal_port}",
        "--metrics-bind-endpoint", f"127.0.0.1:{marshal_met}",
        *cfg.get("marshal_flags", [])], rundir, env,
        cpus=cpus_for(run, "marshal"))
    gens = []
    users = cfg["users"]
    for g in range(run.generators):
        spec = dict(cell=run.cell, config=run.wl["config"], seed=run.seed,
                    seconds=run.window_s, index=g,
                    uid_lo=g * users // run.generators,
                    uid_hi=(g + 1) * users // run.generators, rundir=rundir,
                    marshal=f"127.0.0.1:{marshal_port}", rate=run.rate)
        path = os.path.join(rundir, f"gen-{g}.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        kid = Child(f"gen{g}", [sys.executable, "-m", "cdnbench.gen", path],
                    rundir, env, stdout_events=True,
                    cpus=cpus_for(run, "generators"))
        kids[kid.name] = kid
        gens.append(kid)

    # the planes warm up (the first run in a checkout builds the kernels)
    deadline = time.monotonic() + 900
    for name in metrics_ports:
        while kids[name].log_line("broker serving") is None:
            for kid in kids.values():
                if not kid.alive():
                    raise Failure(f"{kid.name} exited with "
                                  f"{kid.proc.returncode}:\n{tail(kid.log)}")
            if time.monotonic() > deadline:
                raise Failure(f"{name} did not serve:\n{tail(kids[name].log)}")
            time.sleep(0.1)
    run.serving = {n: kids[n].log_line("broker serving") for n in metrics_ports}
    peers = len(metrics_ports) - 1
    deadline = time.monotonic() + 60
    while True:   # the brokers linked, and the marshal sees them
        topo = [common.http_get(p, "/debug/topology")
                for p in metrics_ports.values()]
        linked = all(t is not None and t[0] == 200
                     and json.loads(t[1]).get("num_brokers") == peers
                     for t in topo)
        ready = (common.http_get(marshal_met, "/readyz") or (0,))[0] == 200
        if linked and ready:
            break
        if time.monotonic() > deadline:
            raise Failure("the brokers did not link, or the marshal was not "
                          f"ready:\n{tail(kids['marshal'].log)}")
        time.sleep(0.1)
    if run.trace:   # the profilers start during set-up
        for name in metrics_ports:
            kids[name].send("arm")
        deadline = time.monotonic() + 180
        for name in metrics_ports:
            armed = os.path.join(rundir, f"{name}-armed")
            while not os.path.exists(armed):
                trace_path = os.path.join(rundir, f"{name}-trace.json")
                if os.path.exists(trace_path) or time.monotonic() > deadline \
                        or not kids[name].alive():
                    raise Failure(f"{name}'s profiler did not start:\n"
                                  f"{tail(trace_path)}{tail(kids[name].log)}")
                time.sleep(0.1)
    deadline = time.monotonic() + 120
    for kid in gens:
        kid.wait_event("keys", deadline)
    for kid in gens:
        kid.send("connect")
    deadline = time.monotonic() + 300
    for kid in gens:
        kid.wait_event("ready", deadline)
    run.connect_s = max(k.last("ready")["connect_s"] for k in gens)
    if args.probe:
        kids["probe"].wait_event("ready", time.monotonic() + 30)

    # the window
    t0 = now_ns() + int(LEAD_S * 1e9)
    t_end = t0 + int(run.window_s * 1e9)
    run.t0, run.t_end = t0, t_end
    for kid in gens:
        kid.send(f"go {t0} {t_end}")
    run.setup_s = time.monotonic() - t_start + LEAD_S
    sleep_until(t0)
    cpu_before = cpu_sample(kids)
    brokers = {n: kids[n].proc.pid for n in metrics_ports}
    trees_before = proctree.sample(brokers)
    before = scrape_all(metrics_ports)
    if run.trace:
        for name in metrics_ports:
            kids[name].send("start")
    sleep_until(t_end)
    cpu_after = cpu_sample(kids)
    trees_after = proctree.sample(brokers)
    run.broker_trees = {n: (trees_before[n], trees_after[n])
                        for n in brokers}
    after = scrape_all(metrics_ports)
    run.cpu_cores = {n: (cpu_after[n] - cpu_before[n]) / run.window_s
                     for n in cpu_before
                     if cpu_before[n] is not None
                     and cpu_after.get(n) is not None}
    if "probe" in run.cpu_cores:
        run.probe_cpu_s = cpu_after["probe"] - cpu_before["probe"]
    if run.trace:
        for name in metrics_ports:
            kids[name].send("stop")
    run.scrapes = {n: (before[n], after[n]) for n in metrics_ports}
    if args.probe:
        stop_probe(run, kids["probe"])

    # every delivery due, or the wait's end
    want = run.expected_total
    limit = min(time.monotonic() + DRAIN_S, t_start + RUN_LIMIT_S - 30)
    last, quiet_since = -1, time.monotonic()
    while time.monotonic() < limit:
        stats = [k.last("stats") or {} for k in gens]
        for k in gens:
            if not k.alive():
                raise Failure(f"{k.name} exited:\n{tail(k.log)}")
        got = sum(s.get("received", 0) for s in stats)
        drives = all(s.get("drive_done", False) for s in stats) \
            if run.wl.get("loop") == "open" else True
        if got != last:
            last, quiet_since = got, time.monotonic()
        if drives and want is not None and got >= want \
                and time.monotonic() - quiet_since > 0.5:
            break
        if drives and want is None and now_ns() > t_end \
                and time.monotonic() - quiet_since > QUIET_S:
            break
        time.sleep(0.1)
    run.t_waited = now_ns()
    for kid in gens:
        kid.send("finish")
    deadline = time.monotonic() + 60
    for kid in gens:
        done = kid.wait_event("done", deadline)
        if done.get("drive_error"):
            log(f"{kid.name}: traffic failed: {done['drive_error']}")
    for kid in gens:   # a generator that loaded JAX exits non-zero
        rc = kid.wait_exit(30)
        if rc != 0:
            raise Failure(f"{kid.name} exited with {rc}:\n{tail(kid.log)}")
    if run.trace:
        deadline = time.monotonic() + 90
        for name in metrics_ports:
            path = os.path.join(rundir, f"{name}-trace.json")
            while not os.path.exists(path):
                if time.monotonic() > deadline or not kids[name].alive():
                    raise Failure(f"{name} wrote no trace:\n"
                                  f"{tail(kids[name].log)}")
                time.sleep(0.1)
            with open(path) as f:
                run.traces[name] = json.load(f)
            if "error" in run.traces[name]:
                raise Failure(f"{name}'s trace failed: "
                              f"{run.traces[name]['error']}")
        if run.device_busy_s() is None:
            raise Failure("the profiler recorded no device operation in "
                          "the window")
    run.exit_lines = {}
    for name in list(metrics_ports) + ["marshal"]:
        rc = kids[name].stop(40)
        if rc not in (0, -signal.SIGTERM):
            log(f"{name} exited with {rc}:\n{tail(kids[name].log)}")
    for name in metrics_ports:
        run.exit_lines[name] = kids[name].log_line("device plane exit")
        path = os.path.join(rundir, f"{name}-exit.json")
        if not os.path.exists(path):
            raise Failure(f"{name} wrote no exit record:\n"
                          f"{tail(kids[name].log)}")
        with open(path) as f:
            run.exits[name] = json.load(f)
        if run.exits[name].get("forbidden"):
            raise Failure(f"{name} loaded {run.exits[name]['forbidden']}")
    run.load([os.path.join(rundir, f"gen-{g}.npz")
              for g in range(run.generators)])


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------


def read_metrics(run: Run, section: str, package: str) -> Dict[str, dict]:
    out = {}
    for m in common.cell_metrics(common.benchmark(), run.cell, section):
        module = importlib.import_module(
            f"cdnbench.{package}.{m['name'].split('.', 1)[0]}")
        value = module.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(run: Run) -> dict:
    ops: Dict[str, float] = {}
    gaps = []
    for name, t in run.traces.items():
        for op, s in t.get("ops", []):
            ops[op] = ops.get(op, 0.0) + s
        gaps += [[f"{name} {label}", s] for label, s in t.get("gaps", [])]
    return dict(device_ops=sorted(([k, v] for k, v in ops.items()),
                                  key=lambda x: -x[1])[:10],
                idle_gaps=sorted(gaps, key=lambda x: -x[1])[:10])


def main(argv=None) -> int:
    t_start = time.monotonic()
    p = argparse.ArgumentParser(prog="cdnbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the knee sweep's offered rate (open loops), not the cell's
    p.add_argument("--rate", type=float, default=None,
                   help=argparse.SUPPRESS)
    # checks of the harness itself: break the timed path underneath
    # (broker_launch --plant), or run the planes on the CPU
    p.add_argument("--plant", default=None, help=argparse.SUPPRESS)
    p.add_argument("--rehearse-cpu", action="store_true",
                   help=argparse.SUPPRESS)
    # a check of the load's own cost: the users split over this many
    # generator processes in place of the deployment's
    p.add_argument("--generators", type=int, default=None,
                   help=argparse.SUPPRESS)
    # a check of the host probe's own cost: the run without it
    p.add_argument("--probe", type=int, choices=(0, 1), default=1,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if importlib.util.find_spec(common.PROGRAM) is None:
        log(f"the program ({common.PROGRAM}) is not beside the benchmark")
        return 2
    bench = common.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells and not os.path.exists(os.path.join(
            common.HERE, "workloads", f"{args.workload}.json")):
        log(f"no cell {args.workload!r}")
        return 2
    # a traffic file that BENCHMARK.json does not list yet runs on one chip
    chips = cells.get(args.workload, {}).get("chips", 1)
    if not args.rehearse_cpu:
        import torch
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"the cell needs {chips} CUDA card(s); this machine has "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
    wl = common.workload(args.workload)
    cfg = common.config(wl["config"])
    run = Run(args.workload, cfg, wl, args.seed, args.seconds,
              bool(args.trace))
    run.rate = args.rate
    run.generators = args.generators or cfg["generators"]
    run.cpus = cfg.get("cpus", {})
    run.expected_total = None
    t_ref = time.monotonic()   # the reference's time is not set-up
    if hasattr(run.kind, "plan"):
        sched = run.kind.plan(cfg, wl, args.seed, args.seconds, args.rate)
        topics = run.kind.users_topics(cfg, wl, args.seed)
        cat = lambda k: np.concatenate([s[k] for s in sched.values()])  # noqa
        run.expected_total = int(oracle.expected(
            topics, cfg["topics"], np.zeros(cat("due").size, np.int64),
            np.arange(cat("due").size), cat("target"), cat("t0"),
            cat("t1")).size)
    t_start += time.monotonic() - t_ref
    raise_fd_limit()
    rundir = tempfile.mkdtemp(prefix="cdnbench-")
    kids: Dict[str, Child] = {}

    def on_term(signum, frame):
        raise SystemExit(128 + signum)
    signal.signal(signal.SIGTERM, on_term)
    try:
        deploy_and_drive(run, args, rundir, kids, t_start)
    except Failure as exc:
        log(f"run failed: {exc}")
        return 1
    finally:
        for kid in kids.values():
            kid.kill()
        shutil.rmtree(rundir, ignore_errors=True)

    numbers = run.judge()
    run.window_numbers()
    limits = {k: 0 for k in numbers}
    correct = all(numbers[k] <= limits[k] for k in numbers)
    attempted = int(run.want.size)
    failed = int(numbers["missing"] + numbers["corrupt"])
    late = run.generator_late_ms()
    p99 = common.percentile(run.latencies_ms(), 0.99) \
        if run.latencies_ms().size else None
    log(json.dumps(dict(
        cell=run.cell, seed=run.seed, deliveries=attempted,
        received=int(run.recv["code"].size), sends=int(run.sends["pub"].size),
        matched_in_window=run.matched_in_window,
        due_in_window=int(run.latencies_ms().size), connect_s=run.connect_s,
        delivery_p99_ms_all=p99, generator_late_p99_ms=late,
        views_closed=run.views_closed_in_window(),
        cpu_cores_in_window=run.cpu_cores, generators=run.generators,
        broker_tree_cores=run.broker_tree_cores(),
        probe=run.probe_reading(),
        planted=run.planted_in_window(),
        serving=run.serving, exit_lines=run.exit_lines)))
    if args.trace:
        metrics = read_metrics(run, "per_layer", "layers")
        log("traces (torch.profiler): "
            + json.dumps({n: {k: v for k, v in t.items()
                              if k not in ("ops", "gaps")}
                          for n, t in run.traces.items()}))
    else:
        metrics = read_metrics(run, "end_to_end", "e2e")
    peaks = [e.get("memory_peak_bytes", 0) for e in run.exits.values()]
    cards = [e["card"] for e in run.exits.values() if "card" in e]
    if args.rehearse_cpu:
        device = dict(platform="cpu", kind="cpu", count=0,
                      memory_peak_bytes=0)
    else:
        import torch
        device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                      count=chips, memory_peak_bytes=int(sum(peaks)))
        if cards and any(c != device["kind"] for c in cards):
            log(f"the brokers ran on {cards}")
    if args.trace:
        device.update(busy_s=run.device_busy_s(),
                      window_s=run.trace_window_s())
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    result = dict(correct=bool(correct), attempted=attempted, failed=failed,
                  metrics=metrics, device=device)
    if args.trace:
        result["breakdown"] = breakdown(run)
    result["checks"] = checks
    bad = common.forbidden_loaded(sys.modules)
    if bad:
        log(f"the harness's process holds {bad}")
        return 4
    for k, v in numbers.items():
        log(f"check {k}: {v} (limit {limits[k]})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
