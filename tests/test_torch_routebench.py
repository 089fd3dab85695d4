"""The port's forwarding bench (``testing.routebench``) held against the
JAX package's at a small size: each row delivers every frame to every
receiver on both packages, through the path its ``impl`` names, and a
``native`` row without the library is None, never a mislabelled scalar
row. The TCP rows (``forward_rate_tcp`` on asyncio and on io_uring, with
the fused pump and without it) and ``stream_rate`` run on both packages
too, and a TCP row run in a child preloaded with the port's syscall
interposer carries its syscall deltas."""

import asyncio
import importlib

import pytest

from _torch_libs import jax_routeplan_available
from pushcdn_tpu_torch.native import routeplan as port_routeplan

pytestmark = pytest.mark.skipif(
    not (jax_routeplan_available() and port_routeplan.available()),
    reason="native route-plan library unavailable (no working g++)")

ROOTS = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}
SMALL = dict(receivers=3, msgs=128, trials=2, payload=64, batch=32)
PATHS = ("cutthrough", "residual", "scalar")


def _paths(root: str) -> dict:
    metrics = importlib.import_module(f"{root}.proto.metrics")
    return {p: metrics.ROUTE_FRAMES.labels(path=p).value for p in PATHS}


def _row(name: str, impl: str, **kw) -> tuple:
    """One forward_rate row and the frames it routed per path."""
    root = ROOTS[name]
    bench = importlib.import_module(f"{root}.testing.routebench")
    before = _paths(root)
    out = asyncio.run(bench.forward_rate(impl, **SMALL, **kw))
    after = _paths(root)
    return out, {p: after[p] - before[p] for p in PATHS}


@pytest.mark.parametrize("impl", ["native", "python"])
def test_forward_rate_delivers_as_jax(impl):
    rows = {name: _row(name, impl) for name in ROOTS}
    sent = SMALL["msgs"] * SMALL["trials"]
    for name, (out, paths) in rows.items():
        assert out["msgs"] == SMALL["msgs"] and len(out["trials"]) == 2
        assert out["receivers"] == SMALL["receivers"]
        assert out["delivered"] == out["median"] * SMALL["receivers"] > 0
        if impl == "native":
            assert paths["scalar"] == 0, (name, paths)
            assert paths["cutthrough"] + paths["residual"] == sent, \
                (name, paths)
        else:
            assert paths["cutthrough"] == paths["residual"] == 0
            assert paths["scalar"] == sent, (name, paths)


@pytest.mark.parametrize("incremental", [True, False],
                         ids=["incremental", "rebuild"])
def test_forward_rate_under_churn(incremental):
    """The churn row: a parked herd enlarges the table, a churner floods
    Subscribe / Unsubscribe, and the route state's summary says which
    maintenance ran."""
    out, _paths_ = _row("port", "native", parked_users=64, churn=True,
                        incremental=incremental)
    assert out["churn_ops"] > 0 and out["churn_ops_s"] > 0
    summary = out["route_summary"]
    assert summary["incremental"] is incremental
    assert summary["snapshot_users"] >= 64 + SMALL["receivers"]
    if incremental:
        assert summary["deltas_applied"] > 0
    else:
        assert summary["rebuilds"].get("incremental_disabled", 0) > 0


def test_native_row_is_none_without_the_library(monkeypatch):
    monkeypatch.setattr(port_routeplan, "_lib", None)
    monkeypatch.setattr(port_routeplan, "_tried", True)
    bench = importlib.import_module("pushcdn_tpu_torch.testing.routebench")
    assert asyncio.run(bench.forward_rate("native", **SMALL)) is None
    # auto still measures, on the scalar loops it then takes
    before = _paths("pushcdn_tpu_torch")
    out = asyncio.run(bench.forward_rate("auto", **SMALL))
    after = _paths("pushcdn_tpu_torch")
    assert out["msgs"] == SMALL["msgs"]
    assert after["cutthrough"] == before["cutthrough"]
    assert after["scalar"] - before["scalar"] == \
        SMALL["msgs"] * SMALL["trials"]


# ---------------------------------------------------------------------------
# the TCP rows: forward_rate_tcp on asyncio and io_uring (with the fused
# pump and without it), stream_rate, and the syscall deltas of a child
# preloaded with the port's interposer
# ---------------------------------------------------------------------------

TCP_SMALL = dict(receivers=3, msgs=128, trials=2, payload=64, batch=32)


def _uring_ok(root: str) -> bool:
    from _torch_libs import jax_uring_loaded
    nuring = importlib.import_module(f"{root}.native.uring")
    if root == ROOTS["jax"] and not jax_uring_loaded():
        return False
    return nuring.available()


def _tcp_row(name: str, io_impl: str, **kw):
    root = ROOTS[name]
    if io_impl == "uring" and not _uring_ok(root):
        pytest.skip(f"io_uring unavailable for {name}")
    bench = importlib.import_module(f"{root}.testing.routebench")
    before = _paths(root)
    pumped = importlib.import_module(f"{root}.proto.metrics") \
        .ROUTE_PUMP_FRAMES
    pumped_before = pumped.value
    out = asyncio.run(bench.forward_rate_tcp(io_impl, route_impl="native",
                                             **TCP_SMALL, **kw))
    after = _paths(root)
    paths = {p: after[p] - before[p] for p in PATHS}
    paths["pump"] = pumped.value - pumped_before
    return out, paths


@pytest.mark.parametrize("io_impl,pump", [("asyncio", "off"),
                                          ("uring", "off"),
                                          ("uring", "auto")])
def test_forward_rate_tcp_delivers_as_jax(io_impl, pump):
    """Every frame reaches every receiver over loopback TCP on both
    packages, through the cut-through plane or, on a pump row, mostly
    through the fused pump (whose summary the row carries)."""
    sent = TCP_SMALL["msgs"] * TCP_SMALL["trials"]
    for name in ROOTS:
        out, paths = _tcp_row(name, io_impl, pump=pump)
        assert out is not None, name
        assert out["io_impl"] == io_impl and out["pump"] == pump
        assert out["msgs"] == TCP_SMALL["msgs"]
        assert len(out["trials"]) == TCP_SMALL["trials"]
        assert out["delivered"] == out["median"] * TCP_SMALL["receivers"] > 0
        assert paths["scalar"] == 0, (name, paths)
        if pump == "auto":
            assert out["pump_summary"]["pump_frames"] > 0, (name, out)
            assert paths["pump"] > 0, (name, paths)
        else:
            assert paths["pump"] == 0, (name, paths)
            # every timed frame went through the plan
            assert paths["cutthrough"] + paths["residual"] >= sent, \
                (name, paths)


@pytest.mark.parametrize("io_impl", ["asyncio", "uring"])
def test_stream_rate_moves_every_byte(io_impl):
    for name, root in ROOTS.items():
        if io_impl == "uring" and not _uring_ok(root):
            pytest.skip(f"io_uring unavailable for {name}")
        bench = importlib.import_module(f"{root}.testing.routebench")
        out = asyncio.run(bench.stream_rate(io_impl, total_mb=4,
                                            wsize=64 * 1024, trials=2))
        assert out["io_impl"] == io_impl and out["unit"] == "MB/s"
        assert out["total_mb"] == 4 and len(out["trials"]) == 2
        assert out["median"] > 0, (name, out)


def _preloaded_child(preload: str, io_impl: str) -> dict:
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, LD_PRELOAD=preload)
    argv = [sys.executable, "-m", "pushcdn_tpu_torch.testing.routebench",
            "--io-impl", io_impl, "--route-impl", "native",
            "--receivers", "3", "--msgs", "128", "--trials", "2",
            "--payload", "64", "--batch", "32"]
    r = subprocess.run(argv, capture_output=True, text=True, timeout=120,
                       env=env, cwd=repo)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("io_impl", ["asyncio", "uring"])
def test_tcp_row_counts_syscalls_under_the_ports_interposer(io_impl):
    """A child preloaded with the port's interposer reports the row's
    syscall deltas; preloaded with the JAX package's, the port reads no
    counters (they are not its library's)."""
    from pushcdn_tpu.native import syscount as jax_syscount
    from pushcdn_tpu_torch.native import syscount

    if io_impl == "uring" and not _uring_ok(ROOTS["port"]):
        pytest.skip("io_uring unavailable")
    lib = syscount.build()
    assert lib is not None, "the port's interposer did not build"
    assert "torch_native" in lib
    out = _preloaded_child(lib, io_impl)
    calls = out["syscalls"]
    assert set(calls) == set(syscount.NAMES)
    assert out["syscalls_per_msg"] > 0
    if io_impl == "uring":
        assert calls["io_uring_enter"] > 0, calls
    else:
        assert calls["io_uring_enter"] == 0, calls
        assert calls["write"] + calls["send"] + calls["sendto"] \
            + calls["sendmsg"] + calls["writev"] > 0, calls
    jax_lib = jax_syscount.build()
    if jax_lib is not None:
        other = _preloaded_child(str(jax_lib), io_impl)
        assert "syscalls" not in other and other["msgs"] == 128
