"""The port stands alone: it imports neither JAX nor the JAX package,
its entry points run on CUDA unless told otherwise, and its kernels are
built from its own sources with nvcc or not at all."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "pushcdn_tpu_torch"


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "pushcdn_tpu"), \
                f"{path.name}:{node.lineno} imports {name}"


_BLOCKED = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["pushcdn_tpu"] = None
import pushcdn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pushcdn_tpu_torch.__path__,
                                               "pushcdn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from pushcdn_tpu_torch.entry import entry
fn, args = entry(device="cpu")
assert int(fn(*args).deliver.sum()) == 2
from pushcdn_tpu_torch.broker.device_plane import DevicePlane, DevicePlaneConfig
plane = DevicePlane(DevicePlaneConfig(num_user_slots=8, ring_slots=4,
                                      frame_bytes=32, extra_lanes=(),
                                      bypass_max_items=0), device="cpu")
plane.on_user_added(b"u", [1])
plane.stage_frames([(5, b"hi", [1])])
(lane,) = plane.step()
assert lane.users.tolist() == [0]

import asyncio, os, tempfile
from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
from pushcdn_tpu_torch.broker.test_harness import TestRun
from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
from pushcdn_tpu_torch.proto.def_ import testing_run_def
from pushcdn_tpu_torch.proto.message import Broadcast

async def serve():
    broker = await Broker.new(BrokerConfig(
        run_def=testing_run_def(), keypair=DEFAULT_SCHEME.generate_keypair(seed=1),
        discovery_endpoint=os.path.join(tempfile.mkdtemp(), "d.sqlite"),
        public_advertise_endpoint="iso-pub", public_bind_endpoint="iso-pub",
        private_advertise_endpoint="iso-priv", private_bind_endpoint="iso-priv",
        device_plane=DevicePlaneConfig(num_user_slots=8, ring_slots=4,
                                       frame_bytes=64, extra_lanes=(),
                                       bypass_max_items=0),
        device="cpu"))
    await broker.start()
    run = TestRun(broker=broker)
    await run.inject_users([[0], [0]])
    await run.send_message_as(run.user(0), Broadcast([0], b"hi"))
    for u in run.connected_users:
        await run.assert_received(u, Broadcast([0], b"hi"), timeout=5)
    assert broker.device_plane.messages_routed == 2
    await run.shutdown()

asyncio.run(serve())

from pushcdn_tpu_torch.testing import Cluster

async def cluster():
    c = await Cluster(num_brokers=1, device="cpu", device_plane=DevicePlaneConfig(
        num_user_slots=8, ring_slots=4, frame_bytes=64, extra_lanes=(),
        bypass_max_items=0)).start()
    alice = c.client(seed=1, topics=[0])
    await alice.ensure_initialized()
    await alice.send_broadcast_message([0], b"through the marshal")
    got = await asyncio.wait_for(alice.receive_message(), 5)
    assert bytes(got.message) == b"through the marshal"
    assert c.brokers[0].device_plane.messages_routed == 1
    alice.close()
    await c.stop()

asyncio.run(cluster())

from pushcdn_tpu_torch.testing import MeshCluster

async def mesh_cluster():
    c = await MeshCluster(num_shards=2, device="cpu").start()
    alice = await c.place_client(seed=2, shard=0, topics=[0])
    bob = await c.place_client(seed=3, shard=1, topics=[0])
    await alice.send_broadcast_message([0], b"across the shards")
    got = await asyncio.wait_for(bob.receive_message(), 5)
    assert bytes(got.message) == b"across the shards"
    assert [b.connections.num_brokers for b in c.brokers] == [0, 0]
    alice.close()
    bob.close()
    await c.stop()

asyncio.run(mesh_cluster())
assert not any(m == "jax" or m.startswith(("jax.", "pushcdn_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok", len(names))
"""


def test_imports_and_runs_with_jax_and_reference_blocked():
    r = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("ok ")
    assert int(r.stdout.split()[1]) >= 70   # every module was imported


_BINARY = r"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["pushcdn_tpu"] = None
sys.argv = [sys.argv[1], "--help"]
try:
    runpy.run_module(f"pushcdn_tpu_torch.bin.{sys.argv[0]}", run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
assert not any(m == "jax" or m.startswith(("jax.", "pushcdn_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
"""


@pytest.mark.parametrize("name", ["broker", "marshal", "client",
                                  "bad_broker", "bad_connector",
                                  "bad_sender"])
def test_binaries_run_with_jax_and_reference_blocked(name):
    r = subprocess.run([sys.executable, "-c", _BINARY, name], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "usage" in r.stdout


def test_entry_points_raise_without_cuda(monkeypatch):
    from pushcdn_tpu_torch import convert
    from pushcdn_tpu_torch.broker.device_plane import DevicePlane
    from pushcdn_tpu_torch.entry import entry
    from pushcdn_tpu_torch.parallel.crdt import empty_state
    from pushcdn_tpu_torch.parallel.router import empty_router_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros(4, np.int32)
    for call in (entry, lambda: empty_state(4), lambda: empty_router_state(4),
                 DevicePlane,
                 lambda: convert.router_state_from_numpy(
                     z, z.astype(np.uint32), z, z.astype(np.uint32))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the CPU is used when asked for
    assert empty_state(4, device="cpu").owners.device.type == "cpu"


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from pushcdn_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "kernels").exists()


def test_library_path_follows_the_source(monkeypatch, tmp_path):
    """An edited source builds to a new library name (no stale load)."""
    from pushcdn_tpu_torch.ops import _build

    src = tmp_path / "k.cu"
    src.write_text("// one")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    src.write_text("// two")
    assert _build.library_path("k") != first
    assert first.parent == _build.BUILD_DIR
    for name in _build.KERNELS:
        assert (PKG / "csrc" / f"{name}.cu").is_file()


_HOST_ONLY = r"""
import sys
import importlib
importlib.import_module(sys.argv[1])
from pushcdn_tpu_torch.proto import metrics
line = next(row for row in metrics.render_all().splitlines()
            if row.startswith("cdn_build_info{"))
assert "torch" not in sys.modules, sorted(
    m for m in sys.modules if m.startswith("torch"))[:5]
print(line)
"""


@pytest.mark.parametrize("module", [
    "pushcdn_tpu_torch.marshal", "pushcdn_tpu_torch.client",
    "pushcdn_tpu_torch.broker.broker", "pushcdn_tpu_torch.bin.marshal",
    "pushcdn_tpu_torch.bin.client", "pushcdn_tpu_torch.bin.broker",
    "pushcdn_tpu_torch.broker.tasks.cutthrough",
    "pushcdn_tpu_torch.native.routeplan",
    "pushcdn_tpu_torch.testing.routebench",
    "pushcdn_tpu_torch.broker.sharding",
    "pushcdn_tpu_torch.broker.shardring",
    "pushcdn_tpu_torch.testing.shardharness",
    "pushcdn_tpu_torch.broker.admission",
    "pushcdn_tpu_torch.broker.rehome",
    "pushcdn_tpu_torch.broker.retention",
    "pushcdn_tpu_torch.scripts.local_cluster",
    "pushcdn_tpu_torch.testing.clientpack",
    "pushcdn_tpu_torch.testing.packs",
    "pushcdn_tpu_torch.testing.consensus",
    "pushcdn_tpu_torch.testing.provenance",
    "pushcdn_tpu_torch.testing.accel_probe",
    "pushcdn_tpu_torch.bin.bad_broker",
    "pushcdn_tpu_torch.bin.bad_connector",
    "pushcdn_tpu_torch.bin.bad_sender",
    "pushcdn_tpu_torch.native.uring", "pushcdn_tpu_torch.native.pump",
    "pushcdn_tpu_torch.native.syscount",
    "pushcdn_tpu_torch.proto.transport.uring",
    "pushcdn_tpu_torch.proto.transport.pump",
    "pushcdn_tpu_torch.proto.transport.quic",
    "pushcdn_tpu_torch.native.bls",
    "pushcdn_tpu_torch.proto.crypto.batch",
    "pushcdn_tpu_torch.proto.discovery.redis"])
def test_host_only_processes_do_not_import_torch(module):
    """A marshal, a client or a broker without a device plane never
    imports torch, as the JAX package's never imports jax; their
    ``/metrics`` render reports torch as absent and the backend as
    unloaded."""
    r = subprocess.run([sys.executable, "-c", _HOST_ONLY, module], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert 'torch="absent"' in r.stdout and 'backend="unloaded"' in r.stdout


# installed as ``sitecustomize`` ahead of the repo in every process of a
# sharded broker: an import of torch, JAX or the JAX package is logged and
# refused
_IMPORT_TRAP = r"""
import os, sys, traceback

class _Trap:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "jax", "jaxlib", "pushcdn_tpu"):
            with open(os.environ["PUSHCDN_IMPORT_TRAP_LOG"], "a") as f:
                f.write(f"{os.getpid()} imported {name}\n")
                traceback.print_stack(file=f)
            raise ImportError(f"{name} is blocked in this process")
        return None

sys.meta_path.insert(0, _Trap())
with open(os.environ["PUSHCDN_IMPORT_TRAP_LOG"] + ".armed", "a") as f:
    f.write(f"{os.getpid()}\n")
"""


def test_sharded_broker_processes_do_not_import_torch(tmp_path):
    """A ``--shards 2`` supervisor and its two workers, with admission
    budgets and retained topics set, start, serve the merged endpoints
    and exit 0 on SIGTERM (each worker re-homing its users on the drain)
    without any of them importing torch, JAX or the JAX package; each
    worker's ``cdn_build_info`` reads torch as absent and the backend as
    unloaded."""
    import json
    import os
    import signal
    import socket
    import time
    import urllib.request

    from pushcdn_tpu_torch.bin.common import spawn_binary

    trap_dir = tmp_path / "trap"
    trap_dir.mkdir()
    (trap_dir / "sitecustomize.py").write_text(_IMPORT_TRAP)
    log = tmp_path / "imports.log"
    log.write_text("")

    def free_port() -> int:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    pub, priv = free_port(), free_port()
    metrics = free_port()
    proc = spawn_binary(
        "broker", "--discovery-endpoint", str(tmp_path / "d.sqlite"),
        "--public-advertise-endpoint", f"127.0.0.1:{pub}",
        "--public-bind-endpoint", f"127.0.0.1:{pub}",
        "--private-advertise-endpoint", f"127.0.0.1:{priv}",
        "--private-bind-endpoint", f"127.0.0.1:{priv}",
        "--metrics-bind-endpoint", f"127.0.0.1:{metrics}",
        "--user-transport", "tcp", "--shards", "2",
        env_extra={"PYTHONPATH": f"{trap_dir}{os.pathsep}{ROOT}",
                   "PUSHCDN_IMPORT_TRAP_LOG": str(log),
                   # admission, retention and the drain's re-homing run
                   # in every worker too
                   "PUSHCDN_RETAIN_TOPICS": "0-3",
                   "PUSHCDN_MAX_CONNS_USER": "8",
                   "PUSHCDN_SUBSCRIBE_RATE": "10"},
        log_path=tmp_path / "broker.log")

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{metrics}{path}",
                                    timeout=5) as r:
            return r.status, r.read().decode()

    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                status, body = get("/readyz")
                if status == 200 and json.loads(body)["checks"]["workers"][
                        "ok"]:
                    break
            except OSError:
                pass
            assert proc.poll() is None and time.monotonic() < deadline, \
                (tmp_path / "broker.log").read_text()[-3000:]
            time.sleep(0.1)
        _, text = get("/metrics")
        info = [line for line in text.splitlines()
                if line.startswith("cdn_build_info{")]
        assert len(info) == 2, info
        assert all('torch="absent"' in i and 'backend="unloaded"' in i
                   for i in info), info
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(40) == 0, (tmp_path / "broker.log").read_text()[-3000:]
        assert (tmp_path / "broker.log").read_text().count(
            "drain re-home: ") == 2
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    assert log.read_text() == "", log.read_text()[-3000:]
    # the trap was armed in the supervisor and in both workers
    armed = set((tmp_path / "imports.log.armed").read_text().split())
    assert len(armed) >= 3, armed


def test_runner_and_its_processes_do_not_import_torch(tmp_path):
    """The local cluster runner without ``--device-plane``, and every
    process it starts (two brokers, the marshal, the echo client and
    ``scripts/trace_report.py``), runs its whole check list with an import
    trap for torch, JAX and the JAX package armed in each."""
    import os

    trap_dir = tmp_path / "trap"
    trap_dir.mkdir()
    (trap_dir / "sitecustomize.py").write_text(_IMPORT_TRAP)
    log = tmp_path / "imports.log"
    log.write_text("")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PUSHCDN_IO_IMPL", "PUSHCDN_IO_URING", "PUSHCDN_PUMP")}
    env.update(PUSHCDN_IMPORT_TRAP_LOG=str(log),
               PYTHONPATH=f"{trap_dir}{os.pathsep}{ROOT}")
    r = subprocess.run(
        [sys.executable, "-m", "pushcdn_tpu_torch.scripts.local_cluster",
         "--duration", "10", "--base-port", "0",
         "--trace-log", str(tmp_path / "spans")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-4000:]
    assert "OK: end-to-end echo through real processes" in out, out[-4000:]
    assert "trace report OK" in out, out[-4000:]
    assert log.read_text() == "", log.read_text()[-3000:]
    # armed in the runner, 2 brokers, the marshal, the client and the
    # trace report (run until the chain is complete)
    armed = set((tmp_path / "imports.log.armed").read_text().split())
    assert len(armed) >= 6, armed


def test_pumped_uring_brokers_do_not_import_torch(tmp_path):
    """The runner with ``--io-impl uring --pump auto``: both plane-less
    brokers serve on the io_uring engine with the fused pump engaged
    (where the kernel allows io_uring), and no process of the run imports
    torch, JAX or the JAX package."""
    import os

    from pushcdn_tpu_torch.native import pump as npump
    from pushcdn_tpu_torch.native import uring as nuring
    if not (nuring.available() and npump.available()):
        pytest.skip(f"no io_uring here ({nuring.probe_errname()})")
    trap_dir = tmp_path / "trap"
    trap_dir.mkdir()
    (trap_dir / "sitecustomize.py").write_text(_IMPORT_TRAP)
    log = tmp_path / "imports.log"
    log.write_text("")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PUSHCDN_IO_IMPL", "PUSHCDN_IO_URING", "PUSHCDN_PUMP")}
    env.update(PUSHCDN_IMPORT_TRAP_LOG=str(log),
               PYTHONPATH=f"{trap_dir}{os.pathsep}{ROOT}")
    r = subprocess.run(
        [sys.executable, "-m", "pushcdn_tpu_torch.scripts.local_cluster",
         "--duration", "10", "--base-port", "0", "--io-impl", "uring",
         "--pump", "auto"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-4000:]
    assert "pump OK" in out, out[-4000:]
    assert "OK: end-to-end echo through real processes" in out, out[-4000:]
    assert log.read_text() == "", log.read_text()[-3000:]
    armed = set((tmp_path / "imports.log.armed").read_text().split())
    assert len(armed) >= 5, armed


def test_bls_marshal_does_not_import_torch(tmp_path):
    """``marshal --scheme bls-bn254`` with the import trap armed: it builds
    or loads the port's BLS library, verifies two BLS clients through its
    batching verifier and exports the line-table gauges, without
    importing torch, JAX or the JAX package; its ``cdn_build_info`` reads
    torch as absent."""
    import asyncio
    import os
    import signal
    import socket
    import urllib.request

    from pushcdn_tpu_torch.bin.common import spawn_binary
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.crypto.signature import BlsBn254Scheme
    from pushcdn_tpu_torch.proto.transport import Tcp

    trap_dir = tmp_path / "trap"
    trap_dir.mkdir()
    (trap_dir / "sitecustomize.py").write_text(_IMPORT_TRAP)
    log = tmp_path / "imports.log"
    log.write_text("")
    ports = []
    for _ in range(5):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    pub, priv, marshal, metrics, bmetrics = ports
    db = str(tmp_path / "d.sqlite")
    env = {"PYTHONPATH": f"{trap_dir}{os.pathsep}{ROOT}",
           "PUSHCDN_IMPORT_TRAP_LOG": str(log)}
    scheme = ("--scheme", "bls-bn254")
    procs = [spawn_binary(
        "marshal", "--discovery-endpoint", db,
        "--bind-endpoint", f"127.0.0.1:{marshal}", "--user-transport", "tcp",
        "--metrics-bind-endpoint", f"127.0.0.1:{metrics}", *scheme,
        env_extra=env, log_path=tmp_path / "marshal.log"),
        spawn_binary(
        "broker", "--discovery-endpoint", db,
        "--public-advertise-endpoint", f"127.0.0.1:{pub}",
        "--public-bind-endpoint", f"127.0.0.1:{pub}",
        "--private-advertise-endpoint", f"127.0.0.1:{priv}",
        "--private-bind-endpoint", f"127.0.0.1:{priv}",
        "--metrics-bind-endpoint", f"127.0.0.1:{bmetrics}",
        "--user-transport", "tcp", *scheme,
        env_extra=env, log_path=tmp_path / "broker.log")]

    async def connect():
        clients = [Client(ClientConfig(
            marshal_endpoint=f"127.0.0.1:{marshal}",
            keypair=BlsBn254Scheme.generate_keypair(seed=77 + i),
            protocol=Tcp, scheme=BlsBn254Scheme, subscribed_topics={0}))
            for i in range(2)]
        async with asyncio.timeout(60):
            await asyncio.gather(*(c.ensure_initialized() for c in clients))
        for c in clients:
            c.close()

    try:
        asyncio.run(connect())
        text = urllib.request.urlopen(f"http://127.0.0.1:{metrics}/metrics",
                                      timeout=5).read().decode()
        for p in procs:
            p.send_signal(signal.SIGTERM)
        assert [p.wait(30) for p in procs] == [0, 0], \
            (tmp_path / "marshal.log").read_text()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    info = [line for line in text.splitlines()
            if line.startswith("cdn_build_info{")]
    assert info and 'torch="absent"' in info[0], info
    assert 'cdn_bls_pk_cache{stat="misses"} 2' in text, text[-2000:]
    assert log.read_text() == "", log.read_text()[-3000:]
    armed = set((tmp_path / "imports.log.armed").read_text().split())
    assert len(armed) >= 2, armed


_HOST_BROKER = r"""
import asyncio, os, sys, tempfile
from pushcdn_tpu_torch.broker.broker import Broker, BrokerConfig
from pushcdn_tpu_torch.broker.test_harness import TestRun
from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
from pushcdn_tpu_torch.proto.def_ import testing_run_def
from pushcdn_tpu_torch.proto.message import Broadcast

async def serve():
    broker = await Broker.new(BrokerConfig(
        run_def=testing_run_def(), keypair=DEFAULT_SCHEME.generate_keypair(seed=1),
        discovery_endpoint=os.path.join(tempfile.mkdtemp(), "d.sqlite"),
        public_advertise_endpoint="host-pub", public_bind_endpoint="host-pub",
        private_advertise_endpoint="host-priv", private_bind_endpoint="host-priv"))
    await broker.start()
    run = TestRun(broker=broker)
    await run.inject_users([[0], [0]])
    await run.send_message_as(run.user(0), Broadcast([0], b"hi"))
    for u in run.connected_users:
        await run.assert_received(u, Broadcast([0], b"hi"), timeout=5)
    # routed by the cut-through plane (the lone frame by its residual twin)
    assert broker._route_state is not None
    await run.shutdown()

asyncio.run(serve())
from pushcdn_tpu_torch.proto import metrics
assert metrics.ROUTE_RESIDUAL_FRAMES.value + \
    metrics.ROUTE_CUTTHROUGH_FRAMES.value == 1
assert metrics.ROUTE_SCALAR_FRAMES.value == 0
assert "torch" not in sys.modules
print("ok")
"""


_HOST_DURABLE = r"""
import asyncio, os, sys
os.environ["PUSHCDN_RETAIN_TOPICS"] = "0"
os.environ["PUSHCDN_SUBSCRIBE_RATE"] = "0.001"
os.environ["PUSHCDN_SUBSCRIBE_BURST"] = "1"
from pushcdn_tpu_torch.broker import rehome
from pushcdn_tpu_torch.broker.test_harness import TestDefinition
from pushcdn_tpu_torch.proto.message import (
    AuthenticateResponse, Broadcast, Retained, SubscribeFrom, Subscribe,
    deserialize)

async def serve():
    run = await TestDefinition(connected_users=[[0], []]).run()
    await run.send_message_as(run.user(0), Broadcast([0], b"kept"))
    await asyncio.sleep(0.1)
    rx = run.user(1).remote
    await rx.send_message(SubscribeFrom(topic=0, seq=0), flush=True)
    await rx.send_message(Subscribe([1]), flush=True)   # over the bucket
    got = [deserialize((await asyncio.wait_for(rx.recv_raw(), 5)).data)
           for _ in range(2)]
    assert isinstance(got[0], Retained) and bytes(got[0].payload) == b"kept"
    assert isinstance(got[1], AuthenticateResponse) and got[1].permit == 0
    summary = await rehome.rehome_users(run.broker)
    assert summary["no_target"] and summary["users"] == 2, summary
    await run.shutdown()

asyncio.run(serve())
assert "torch" not in sys.modules
print("ok")
"""


def test_host_broker_retains_sheds_and_rehomes_without_torch():
    """A broker without a plane replays a retained topic, sheds a
    subscribe over its bucket and runs the drain's re-homing without
    ever importing torch."""
    r = subprocess.run([sys.executable, "-c", _HOST_DURABLE], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"


def test_host_broker_serves_without_torch():
    """A broker without a plane starts, serves users through the
    cut-through routing plane and stops without ever importing torch."""
    r = subprocess.run([sys.executable, "-c", _HOST_BROKER], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"


_WORKER = r"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["pushcdn_tpu"] = None
sys.argv = [sys.argv[1]] + sys.argv[2:]
try:
    runpy.run_module(sys.argv[0], run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
assert not any(m == "jax" or m.startswith(("jax.", "pushcdn_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("isolated")
"""


def test_two_process_workers_run_with_jax_and_reference_blocked(tmp_path):
    """The multi-process group's workers (modules of the package, shared
    by the tests and ``chip_smoke.py``) run a lockstep step pair with JAX
    and the reference package blocked."""
    from pushcdn_tpu_torch.testing.lockstep_worker import lane_step_case

    np.savez(tmp_path / "case.npz", **lane_step_case("uniform", seed=1))
    module = "pushcdn_tpu_torch.testing.lockstep_worker"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, module, "--rank", str(rank),
         "--init", f"file://{tmp_path}/rendezvous", "lane",
         str(tmp_path), str(tmp_path / "case.npz"), "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-2000:]
        assert f"rank {rank}: LOCKSTEP OK" in out and "isolated" in out
