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
assert not any(m == "jax" or m.startswith(("jax.", "pushcdn_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok", len(names))
"""


def test_imports_and_runs_with_jax_and_reference_blocked():
    r = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("ok ")
    assert int(r.stdout.split()[1]) >= 12   # every module was imported


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
