"""The port's local cluster runner (``python -m
pushcdn_tpu_torch.scripts.local_cluster``) as a subprocess: the twins of
``tests/test_local_cluster.py``'s echo-and-trace, ``--io-impl auto``,
collector and conservation-audit cases, with the same OK lines, plus what
the port's runner adds: ``--device-plane --device cpu`` (the brokers' dense
planes on the CPU, through the same checks), a plane broker without
``--device`` where there is no card (it runs on CUDA, so it dies and the
run fails), and ``--io-impl uring --pump auto``, under which every
component insists on the io_uring engine and both brokers' pumps engage.

The load-shed, sharded-broker, chaos, re-home and replay twins are in
``tests/test_torch_local_cluster_ops.py`` (two files, so that xdist's
``loadfile`` spreads them over two workers).
"""

import glob
import json
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = [sys.executable, "-m", "pushcdn_tpu_torch.scripts.local_cluster"]
# the io knobs another test of the same process may have left set; the
# runner exports its own with --io-impl / --pump
IO_KNOBS = ("PUSHCDN_IO_IMPL", "PUSHCDN_IO_URING", "PUSHCDN_PUMP")


def _loopback_available() -> bool:
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
        return True
    except OSError:
        return False


cluster_test = pytest.mark.skipif(
    not _loopback_available(), reason="no loopback TCP listener available")


def run_runner(*args, timeout=180, tmpdir=None):
    """The runner's rc and its stdout + stderr. ``tmpdir`` becomes its
    TMPDIR, where it keeps each process's log (``pushcdn-cluster-*/``)."""
    env = {k: v for k, v in os.environ.items() if k not in IO_KNOBS}
    if tmpdir is not None:
        env["TMPDIR"] = str(tmpdir)
    proc = subprocess.run([*RUNNER, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout + proc.stderr


def exit_fields(log: str, what: str):
    for line in reversed(log.splitlines()):
        at = line.find(what + " {")
        if at >= 0:
            return json.loads(line[at + len(what) + 1:])
    return None


@cluster_test
def test_local_cluster_end_to_end_echo_and_clean_shutdown(tmp_path):
    trace_dir = str(tmp_path / "spans")
    rc, out = run_runner("--duration", "10", "--base-port", "0",
                         "--trace-log", trace_dir)
    assert rc == 0, f"local_cluster failed:\n{out[-6000:]}"
    assert "OK: end-to-end echo through real processes" in out, out[-6000:]
    # one complete lifecycle span chain (auth + publish -> ingress ->
    # plan -> egress -> delivery on one trace id) from the per-process
    # span logs
    assert "trace chain complete" in out, out[-6000:]
    # readiness false before broker0's listeners bind...
    assert "readiness pre-bind: 503 not-ready" in out, out[-6000:]
    # ...every process (2 brokers, marshal, client) serving /healthz +
    # /readyz with the check schema...
    assert "health OK (4 processes" in out, out[-6000:]
    # ...broker /debug/topology reflecting the actual mesh...
    assert "topology OK" in out, out[-6000:]
    # ...trace_report --strict with zero orphaned spans...
    assert "trace report OK" in out, out[-6000:]
    assert "0 orphaned spans" in out, out[-6000:]
    # ...and readiness flipping false during drain before listeners close
    assert "drain readiness flip observed" in out, out[-6000:]
    assert "FAIL" not in out, out[-6000:]
    # one span log per process that traced a hop (broker1 may have none)
    logs = {os.path.basename(p)
            for p in glob.glob(os.path.join(trace_dir, "*.jsonl"))}
    assert {"client.jsonl", "marshal.jsonl"} <= logs <= {
        "broker0.jsonl", "broker1.jsonl", "client.jsonl",
        "marshal.jsonl"}, logs


def _pump_composes() -> bool:
    """Whether the fused pump can engage on this host: io_uring allowed,
    the route-plan and pump libraries built."""
    from pushcdn_tpu_torch.native import pump as npump
    from pushcdn_tpu_torch.native import routeplan
    from pushcdn_tpu_torch.native import uring as nuring
    return (nuring.available() and routeplan.available()
            and npump.available())


@cluster_test
def test_local_cluster_io_impl_auto(tmp_path):
    """``--io-impl auto --pump auto``: every component resolves the host
    I/O engine (io_uring where the kernel allows it, one warning each
    where it does not), the fused pump engages and pumps real frames (or
    the runner says it skipped the check), the echo completes, and the
    strict trace gate still sees complete chains with zero orphans:
    traced frames escalate off the pump and chain as before."""
    trace_dir = str(tmp_path / "spans")
    rc, out = run_runner("--duration", "10", "--base-port", "0",
                         "--io-impl", "auto", "--pump", "auto",
                         "--trace-log", trace_dir, tmpdir=tmp_path)
    assert rc == 0, f"io-impl cluster failed:\n{out[-6000:]}"
    assert "[cluster] io-impl: auto" in out, out[-6000:]
    assert "[cluster] pump: auto" in out, out[-6000:]
    if _pump_composes():
        assert "pump OK" in out, out[-6000:]
    else:
        assert "pump skipped" in out, out[-6000:]
    assert "OK: end-to-end echo through real processes" in out, out[-6000:]
    assert "trace chain complete" in out, out[-6000:]
    assert "trace report OK" in out, out[-6000:]
    assert "0 orphaned spans" in out, out[-6000:]
    assert "FAIL" not in out, out[-6000:]
    from pushcdn_tpu_torch.native import uring as nuring
    (logdir,) = glob.glob(str(tmp_path / "pushcdn-cluster-*"))
    for name in ("broker0", "broker1", "marshal"):
        text = open(os.path.join(logdir, f"{name}.log")).read()
        assert text.count("demoted to asyncio") == \
            (0 if nuring.available() else 1), (name, text[-2000:])


@cluster_test
def test_local_cluster_io_impl_uring(tmp_path):
    """``--io-impl uring --pump auto`` where the kernel allows io_uring:
    every component insists on the engine (none demotes), both brokers'
    fused pumps engage and pump real frames, and the echo completes."""
    from pushcdn_tpu_torch.native import uring as nuring
    if not nuring.available():
        pytest.skip(f"the kernel denies io_uring ({nuring.probe_errname()})")
    rc, out = run_runner("--duration", "10", "--base-port", "0",
                         "--io-impl", "uring", "--pump", "auto",
                         tmpdir=tmp_path)
    assert rc == 0, f"uring cluster failed:\n{out[-6000:]}"
    assert "[cluster] io-impl: uring" in out, out[-6000:]
    if _pump_composes():
        assert "pump OK" in out, out[-6000:]
    assert "OK: end-to-end echo through real processes" in out, out[-6000:]
    assert "FAIL" not in out, out[-6000:]
    (logdir,) = glob.glob(str(tmp_path / "pushcdn-cluster-*"))
    for name in ("broker0", "broker1", "marshal"):
        text = open(os.path.join(logdir, f"{name}.log")).read()
        assert "demoted to asyncio" not in text, (name, text[-2000:])
        assert "io_uring is unavailable" not in text, (name, text[-2000:])


@cluster_test
def test_local_cluster_collector():
    """``--collector`` drives ``scripts/cdn_top.py --once --record
    --bundle`` over every process's metrics endpoint: the pane covers
    every process, the timeline's headline saw them all up, and the bundle
    holds every process's metrics and each broker's topology. With
    ``--pump auto`` where io_uring is allowed, the bundled broker metrics
    carry non-zero ``cdn_pump_stage_seconds`` samples for all four native
    stages; elsewhere the runner says it skipped that check."""
    rc, out = run_runner("--duration", "10", "--base-port", "0",
                         "--io-impl", "auto", "--pump", "auto",
                         "--collector", timeout=240)
    assert rc == 0, f"collector cluster failed:\n{out[-6000:]}"
    assert "collector OK" in out, out[-6000:]
    if _pump_composes():
        assert "pump stages all nonzero" in out, out[-6000:]
    else:
        assert "pump-stage check skipped" in out, out[-6000:]
    assert "OK: end-to-end echo through real processes" in out, out[-6000:]
    assert "FAIL" not in out, out[-6000:]


@cluster_test
def test_local_cluster_conservation_audit():
    """``--audit``: the clean leg merges both brokers' ledgers to zero
    violations and zero unattributed deficit; the chaos leg SIGKILLs
    broker1 and requires the frames committed toward it attributed to the
    dead peer, then a clean balance after the respawn."""
    rc, out = run_runner("--duration", "25", "--base-port", "0", "--audit",
                         timeout=240)
    assert rc == 0, f"audit cluster failed:\n{out[-6000:]}"
    assert "audit OK (clean): [audit] violations=0 " \
           "unattributed_deficit=0" in out, out[-6000:]
    assert "fully attributed to the dead broker1" in out, out[-6000:]
    assert "audit OK (post-respawn): [audit] violations=0 " \
           "unattributed_deficit=0 attributed_deficit=0" in out, out[-6000:]
    assert "OK: end-to-end echo through real processes" in out, out[-6000:]
    assert "FAIL" not in out, out[-6000:]


@cluster_test
def test_local_cluster_device_plane_on_the_cpu(tmp_path):
    """``--device-plane --device cpu``: both brokers serve with a dense
    plane on the CPU (``--device`` forwarded to each), and the run passes
    every check of the echo run, each broker's exit line counting the
    frames it took and those its plane routed."""
    trace_dir = str(tmp_path / "spans")
    rc, out = run_runner("--duration", "10", "--base-port", "0",
                         "--device-plane", "--device", "cpu",
                         "--trace-log", trace_dir, tmpdir=tmp_path)
    assert rc == 0, f"device-plane cluster failed:\n{out[-6000:]}"
    for needle in ("OK: end-to-end echo through real processes",
                   "trace chain complete", "health OK (4 processes",
                   "topology OK", "trace report OK", "0 orphaned spans",
                   "drain readiness flip observed"):
        assert needle in out, (needle, out[-6000:])
    assert "FAIL" not in out, out[-6000:]
    (logdir,) = glob.glob(str(tmp_path / "pushcdn-cluster-*"))
    for name in ("broker0", "broker1"):
        text = open(os.path.join(logdir, f"{name}.log")).read()
        serving = exit_fields(text, "broker serving")
        done = exit_fields(text, "device plane exit")
        assert serving is not None and done is not None, text[-3000:]
        assert serving["device"] == "cpu" and not done["disabled"]
        assert serving["delivery_impl"] == "dense"
        # every frame the broker took was counted; none was lost
        assert sum(done["route_frames"].values()) >= done["plane_frames"]


@cluster_test
def test_local_cluster_device_plane_needs_a_card_unless_told(tmp_path):
    """Without ``--device`` a plane broker runs on CUDA; where there is
    none it exits non-zero at start, and the runner fails the run rather
    than carry on without it."""
    rc, out = run_runner("--duration", "8", "--base-port", "0",
                         "--device-plane", tmpdir=tmp_path)
    assert rc != 0, out[-6000:]
    assert "FAIL: broker0 died early" in out, out[-6000:]
    assert "OK: end-to-end echo" not in out
    (logdir,) = glob.glob(str(tmp_path / "pushcdn-cluster-*"))
    text = open(os.path.join(logdir, "broker0.log")).read()
    assert "--device-plane" in text and "CUDA" in text, text[-2000:]


def _late_readyz_server(port: int, delay_s: float):
    """A stand-in broker0: its metrics endpoint starts answering
    ``delay_s`` after the call, and then answers ``/readyz`` as a broker
    before its listeners bind does (503, the listeners check failing)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps({"ready": False, "checks": {"listeners": {
                "ok": False, "detail": "not bound yet"}}}).encode()
            self.send_response(503)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    stop = threading.Event()
    box = {}

    def serve():
        if stop.wait(delay_s):
            return
        box["server"] = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        box["server"].serve_forever(poll_interval=0.05)

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()

    def close():
        stop.set()
        while thread.is_alive() and "server" not in box:
            thread.join(0.05)
        if "server" in box:
            box["server"].shutdown()
            box["server"].server_close()
        thread.join()
    return close


def test_plane_broker_startup_window_outlasts_a_slow_first_answer():
    """A ``--device-plane`` broker imports torch and brings CUDA up before
    its metrics endpoint answers, so the runner waits up to 45 s for
    broker0's first ``/readyz`` answer when it starts plane brokers, and
    the JAX runner's 8 s otherwise: a stand-in whose first answer comes
    after 10 s passes the pre-bind check under ``--device-plane`` and
    fails it without. The check itself stands: that answer is a 503 with
    the listeners check failing."""
    from concurrent.futures import ThreadPoolExecutor

    from pushcdn_tpu_torch.scripts import local_cluster as runner

    assert runner.startup_window_s(False) == 8.0
    assert runner.startup_window_s(True) >= 40.0
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    stand_ins = [_late_readyz_server(p, 10.0) for p in ports]
    try:
        with ThreadPoolExecutor(2) as pool:
            plane, plain = pool.map(
                lambda a: runner.check_readiness_before_bind(*a),
                [(ports[0], True), (ports[1], False)])
    finally:
        for close in stand_ins:
            close()
    assert plane is True
    assert plain is False
