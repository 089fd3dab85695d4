"""The port's binaries as processes: every one parses ``--help``; the
marshal and ``broker --device-plane --device cpu`` serve a ``Client``
over TCP, a pipelined burst routes on the plane (``/metrics`` shows
``cdn_device_messages_routed`` > 0, the twin of
``tests/test_binaries.py::test_broker_binary_device_plane_end_to_end``)
and both exit 0 on SIGTERM, the broker with its exit line; and the
broker refuses what it cannot serve: a plane on CUDA where there is none,
and delivery impls, schemes and discovery stores the port lacks."""

import asyncio
import json
import os
import signal
import socket
import subprocess
import urllib.request

import pytest

from pushcdn_tpu_torch.bin.common import spawn_binary

BINARIES = ("broker", "marshal", "client")


def _free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _broker_args(db: str, pub: int, priv: int, *extra: str) -> list:
    return ["--discovery-endpoint", db,
            "--public-advertise-endpoint", f"127.0.0.1:{pub}",
            "--public-bind-endpoint", f"127.0.0.1:{pub}",
            "--private-advertise-endpoint", f"127.0.0.1:{priv}",
            "--private-bind-endpoint", f"127.0.0.1:{priv}", *extra]


def _exit_fields(log: str, what: str):
    for line in reversed(log.splitlines()):
        at = line.find(what + " {")
        if at >= 0:
            return json.loads(line[at + len(what) + 1:])
    return None


@pytest.mark.parametrize("name", BINARIES)
def test_every_port_binary_parses_help(name):
    p = spawn_binary(name, "--help")
    out, _ = p.communicate(timeout=60)
    assert p.returncode == 0, f"{name} --help failed:\n{out}"
    assert "usage" in out.lower() and "pushcdn" in out, out[:200]


async def test_broker_binary_device_plane_end_to_end(tmp_path):
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.transport import Tcp

    db = str(tmp_path / "cdn.sqlite")
    pub, priv, metrics, marshal = _free_ports(4)
    logs = {name: tmp_path / f"{name}.log" for name in ("broker", "marshal")}
    procs = {
        "broker": spawn_binary(
            "broker", *_broker_args(
                db, pub, priv, "--metrics-bind-endpoint",
                f"127.0.0.1:{metrics}", "--user-transport", "tcp",
                "--device-plane", "--device", "cpu",
                "--device-ring-slots", "64"),
            log_path=logs["broker"]),
        "marshal": spawn_binary(
            "marshal", "--discovery-endpoint", db,
            "--bind-endpoint", f"127.0.0.1:{marshal}",
            "--user-transport", "tcp", log_path=logs["marshal"]),
    }
    try:
        client = Client(ClientConfig(
            marshal_endpoint=f"127.0.0.1:{marshal}",
            keypair=DEFAULT_SCHEME.generate_keypair(seed=4242),
            protocol=Tcp, subscribed_topics={0}))
        async with asyncio.timeout(45):   # cold start + registration
            await client.ensure_initialized()
        routed = 0.0
        async with asyncio.timeout(60):
            # a pipelined burst beats the idle bypass and rides the plane
            while routed == 0:
                await asyncio.gather(*(
                    client.send_broadcast_message([0], b"cli burst %d" % i)
                    for i in range(16)))
                got = 0
                while got < 16:
                    got += len(await client.receive_messages(16 - got))
                text = await asyncio.to_thread(
                    lambda: urllib.request.urlopen(
                        f"http://127.0.0.1:{metrics}/metrics",
                        timeout=5).read().decode())
                routed = next((float(line.split()[-1])
                               for line in text.splitlines()
                               if line.startswith(
                                   "cdn_device_messages_routed ")), 0.0)
        client.close()
        assert all(p.poll() is None for p in procs.values()), \
            "a binary died during the test"
        for p in procs.values():
            p.send_signal(signal.SIGTERM)
        rcs = {n: await asyncio.to_thread(p.wait, 30)
               for n, p in procs.items()}
        assert rcs == {"broker": 0, "marshal": 0}, \
            {n: logs[n].read_text()[-2000:] for n in procs}
        serving = _exit_fields(logs["broker"].read_text(), "broker serving")
        done = _exit_fields(logs["broker"].read_text(), "device plane exit")
        assert serving["device"] == "cpu" and serving["steps"] == 0
        assert done["messages_routed"] == routed > 0
        assert done["steps"] > 0 and done["delivery_impl"] == "dense"
        assert not done["disabled"]
        # nothing launches a CUDA kernel on the CPU
        assert done["launches"] == {"delivery_matrix_cuda": 0,
                                    "ragged_delivery_cuda": 0}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()


@pytest.mark.parametrize("args,env,needle", [
    # a plane with CUDA hidden and no --device cpu
    (("--device-plane",), {"CUDA_VISIBLE_DEVICES": ""},
     "CUDA is not available"),
    (("--device-plane", "--device", "cpu"),
     {"PUSHCDN_DELIVERY_IMPL": "pallas"}, "PUSHCDN_DELIVERY_IMPL='pallas'"),
    (("--scheme", "bls-bn254"), {}, "ROADMAP"),
    (("--user-transport", "quic"), {}, "unknown transport"),
], ids=["cuda-hidden", "pallas", "bls", "quic"])
def test_broker_binary_refuses_what_it_cannot_serve(tmp_path, args, env,
                                                     needle):
    pub, priv = _free_ports(2)
    p = spawn_binary("broker", *_broker_args(str(tmp_path / "d.sqlite"),
                                             pub, priv, *args),
                     env_extra=env)
    try:
        out, _ = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode not in (0, None), out[-2000:]
    assert needle in out, out[-2000:]
    assert "broker serving" not in out


def test_redis_discovery_is_refused():
    p = spawn_binary("marshal", "--discovery-endpoint", "redis://127.0.0.1:1")
    out, _ = p.communicate(timeout=60)
    assert p.returncode not in (0, None) and "ROADMAP" in out, out[-2000:]


def test_spawned_binaries_are_the_ports():
    """``spawn_binary`` starts ``pushcdn_tpu_torch.bin.<name>``, never the
    JAX package's."""
    p = spawn_binary("client", "--help")
    try:
        p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.args[1:3] == ["-m", "pushcdn_tpu_torch.bin.client"]
    assert os.path.basename(p.args[0]).startswith("python")
