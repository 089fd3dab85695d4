"""The port's client packs (``python -m pushcdn_tpu_torch.testing.clientpack``)
against the port's marshal and broker processes, and beside the JAX
package's packs against the JAX binaries.

A soak of 2 packs x 16 clients takes sequenced broadcasts from a publisher
in the test: every pack's ``result`` reads zero gaps, zero reorders, zero
hard reconnects and every client's full ``unique`` count; the same soak
through the JAX package's clientpack and binaries gives the same result,
key for key. A storm pack's reconnect cycles each connect or are shed
with a typed retry-after. The packs' percentile and sequence extractor
equal JAX's on seeded inputs.
"""

import asyncio
import importlib
import os
import signal
import socket
from types import SimpleNamespace

import numpy as np
import pytest

from pushcdn_tpu.testing import clientpack as jax_clientpack
from pushcdn_tpu_torch.testing import clientpack
from pushcdn_tpu_torch.testing.packs import Pack, publish_sequenced

ROOTS = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}
TOPICS = 4
PER_TOPIC = 16


@pytest.fixture(autouse=True)
def _asyncio_io(monkeypatch):
    """The processes here run on asyncio, whatever io knobs another test of
    this process left in the environment."""
    monkeypatch.setenv("PUSHCDN_IO_IMPL", "asyncio")
    monkeypatch.delenv("PUSHCDN_IO_URING", raising=False)
    monkeypatch.delenv("PUSHCDN_PUMP", raising=False)


def _pkg(name: str) -> SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{ROOTS[name]}.{path}")

    return SimpleNamespace(
        name=name, module=f"{ROOTS[name]}.testing.clientpack",
        common=mod("bin.common"), client=mod("client.client"),
        signature=mod("proto.crypto.signature"),
        transport=mod("proto.transport"))


def _free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


async def _deployment(p, tmp_path):
    """A marshal and a broker (plain TCP users) of package ``p`` as
    processes; returns (procs, marshal endpoint, a connected client with
    no topics) once a client gets through to the broker."""
    db = str(tmp_path / f"{p.name}.sqlite")
    pub, priv, marshal = _free_ports(3)
    procs = {
        "broker": p.common.spawn_binary(
            "broker", "--discovery-endpoint", db,
            "--public-advertise-endpoint", f"127.0.0.1:{pub}",
            "--public-bind-endpoint", f"127.0.0.1:{pub}",
            "--private-advertise-endpoint", f"127.0.0.1:{priv}",
            "--private-bind-endpoint", f"127.0.0.1:{priv}",
            "--user-transport", "tcp",
            env_extra={"JAX_PLATFORMS": "cpu"},
            log_path=tmp_path / f"{p.name}-broker.log"),
        "marshal": p.common.spawn_binary(
            "marshal", "--discovery-endpoint", db,
            "--bind-endpoint", f"127.0.0.1:{marshal}",
            "--user-transport", "tcp",
            log_path=tmp_path / f"{p.name}-marshal.log"),
    }
    # the broker is registered once a client gets through the marshal
    probe = _publisher(p, f"127.0.0.1:{marshal}", seed=31_000)
    async with asyncio.timeout(60):
        while True:
            try:
                async with asyncio.timeout(5):
                    await probe.ensure_initialized()
                break
            except Exception:
                for name, proc in procs.items():
                    assert proc.poll() is None, (
                        name, (tmp_path / f"{p.name}-{name}.log")
                        .read_text()[-3000:])
                probe.close()
                probe = _publisher(p, f"127.0.0.1:{marshal}", seed=31_000)
                await asyncio.sleep(0.2)
    return procs, f"127.0.0.1:{marshal}", probe


def _publisher(p, marshal: str, seed: int):
    return p.client.Client(p.client.ClientConfig(
        marshal_endpoint=marshal,
        keypair=p.signature.DEFAULT_SCHEME.generate_keypair(seed=seed),
        protocol=p.transport.Tcp, subscribed_topics=set()))


def _stop(procs: dict, tmp_path, name: str) -> None:
    for proc in procs.values():
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
    for which, proc in procs.items():
        try:
            rc = proc.wait(30)
        except Exception:
            proc.kill()
            rc = proc.wait()
        assert rc == 0, (tmp_path / f"{name}-{which}.log").read_text()[-3000:]


async def _soak(p, tmp_path, packs: int = 2, clients: int = 16) -> list:
    """``packs`` soak packs of ``clients`` clients on ``TOPICS`` topics
    against package ``p``'s processes; ``PER_TOPIC`` sequenced broadcasts a
    topic from a publisher here. Returns each pack's ``result``."""
    procs, marshal, publisher = await _deployment(p, tmp_path)
    running = []
    try:
        for k in range(packs):
            running.append(Pack(
                marshal, "soak", clients, 50_000 + 1_000 * k,
                "--report-every-s", "1", "--settle-s", "1",
                topics=TOPICS, module=p.module,
                log_path=tmp_path / f"{p.name}-pack{k}.log"))
        for pack in running:
            ready = await asyncio.to_thread(pack.wait, "ready", 90)
            assert ready["clients"] == clients
        await asyncio.sleep(0.5)   # the last subscriptions land
        sent = await publish_sequenced(publisher, TOPICS, PER_TOPIC, 512,
                                       waves=4, gap_s=0.05)
        assert sent == TOPICS * PER_TOPIC
        results = []
        for pack in running:
            pack.send("mark")
            mark = await asyncio.to_thread(pack.wait, "mark", 30)
            assert mark["clients"] == clients
            pack.send("finish")
            results.append(await asyncio.to_thread(pack.wait, "result", 60))
        for pack in running:
            assert await asyncio.to_thread(pack.close) == 0
        return results
    finally:
        publisher.close()
        for pack in running:
            pack.close(1.0)
        _stop(procs, tmp_path, p.name)


def _check_soak(results: list, clients: int = 16) -> None:
    for r in results:
        assert r["mode"] == "soak" and r["clients"] == clients, r
        assert r["gaps"] == 0 and r["reorders"] == 0, r
        assert r["hard_reconnects"] == 0 and r["rehomed"] == 0, r
        # every client takes its topic's PER_TOPIC broadcasts, once
        assert r["unique"] == r["delivered"] == clients * PER_TOPIC, r


async def test_soak_two_packs_against_the_port_processes(tmp_path):
    _check_soak(await _soak(_pkg("port"), tmp_path))


async def test_soak_result_matches_the_jax_packs(tmp_path):
    """The same soak through the JAX package's clientpack and binaries
    gives the same ``result`` lines, key for key and count for count."""
    got = {name: await _soak(_pkg(name), tmp_path, packs=1)
           for name in ("jax", "port")}
    _check_soak(got["port"])
    assert got["port"] == got["jax"]


async def test_storm_cycles_connect_or_are_shed(tmp_path):
    """50 reconnect cycles over a pool of 10 clients: each either
    connects or is shed with a typed retry-after, nothing else fails."""
    p = _pkg("port")
    procs, marshal, publisher = await _deployment(p, tmp_path)
    try:
        pack = Pack(marshal, "storm", 10, 70_000, "--storm-connections",
                    "50", "--hold-ms", "10", module=p.module,
                    log_path=tmp_path / "storm.log")
        r = await asyncio.to_thread(pack.wait, "result", 90)
        assert await asyncio.to_thread(pack.close) == 0
    finally:
        publisher.close()
        _stop(procs, tmp_path, p.name)
    assert r["mode"] == "storm" and r["established"] == 50, r
    assert r["attempts"] - r["established"] == r["sheds"], r
    assert 0 < r["conn_p50_ms"] <= r["conn_p99_ms"], r


@pytest.mark.parametrize("seed", range(4))
def test_pctile_and_seq_extractor_match_jax(seed):
    rng = np.random.default_rng(8200 + seed)
    vals = sorted(rng.random(int(rng.integers(0, 300))).tolist())
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert clientpack._pctile(vals, q) == jax_clientpack._pctile(vals, q)
    port_msg = importlib.import_module("pushcdn_tpu_torch.proto.message")
    jax_msg = importlib.import_module("pushcdn_tpu.proto.message")
    topic = int(rng.integers(0, 256))
    ours = clientpack.make_seq_extractor(topic)
    theirs = jax_clientpack.make_seq_extractor(topic)
    for _ in range(32):
        payload = bytes(rng.integers(0, 256, int(rng.integers(4, 64)),
                                     dtype=np.uint8))
        assert ours(port_msg.Broadcast([topic], payload)) == \
            theirs(jax_msg.Broadcast([topic], payload)) == \
            (topic, int.from_bytes(payload[:4], "big"))
        assert ours(port_msg.Direct(b"k", payload)) == \
            theirs(jax_msg.Direct(b"k", payload))
    assert ours(port_msg.Subscribe([topic])) is None
    assert theirs(jax_msg.Subscribe([topic])) is None


def test_pack_module_is_a_copy_of_jax():
    """The pack's protocol words and flags are JAX's."""
    ours = clientpack.build_parser()
    theirs = jax_clientpack.build_parser()
    assert sorted(a.dest for a in ours._actions) == \
        sorted(a.dest for a in theirs._actions)
    assert os.path.basename(clientpack.__file__) == "clientpack.py"
