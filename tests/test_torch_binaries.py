"""The port's binaries as processes: every one parses ``--help``; the
marshal and ``broker --device-plane --device cpu`` serve a ``Client``
over TCP, a pipelined burst routes on the plane (``/metrics`` shows
``cdn_device_messages_routed`` > 0, the twin of
``tests/test_binaries.py::test_broker_binary_device_plane_end_to_end``)
and both exit 0 on SIGTERM, the broker with its exit line; two broker
processes joined by ``--mesh-shards 2 --multihost-*`` serve a client
each, a broadcast crossing from one to the other and a direct crossing
back with no host broker link; a marshal and broker serve a client over
each of ``tcp``, ``tcp+tls`` and ``quic``; the io knobs select the
io_uring engine as the JAX binaries do (and, under a kernel that denies
io_uring, an explicit ``uring`` exits naming the errno); and the broker
refuses what it cannot serve: a plane on CUDA where there is none,
delivery impls, schemes and transports it does not know, a ``redis://``
store without the ``redis`` package, and the mesh-group flags the JAX
binary refuses; a BLS marshal and plane broker serve BLS clients over
TCP+TLS (the production run definition's shape); and the three chaos
binaries (``bad_broker``, ``bad_connector``, ``bad_sender``) each run a
few cycles against a marshal and broker."""

import asyncio
import json
import os
import signal
import socket
import subprocess
import urllib.error
import urllib.request

import pytest

from pushcdn_tpu_torch.bin.common import spawn_binary

BINARIES = ("broker", "marshal", "client", "bad_broker", "bad_connector",
            "bad_sender")


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
    # an unknown scheme; both of the reference's are offered
    (("--scheme", "bls-bn255"), {}, "pick from ['bls-bn254', 'ed25519']"),
    (("--user-transport", "sctp"), {}, "unknown transport"),
    (("--device-plane", "--mesh-shards", "2", "--device", "cpu"), {},
     "mutually exclusive"),
    (("--mesh-shard", "1"), {}, "--mesh-shard requires --mesh-shards"),
    # one process owns both shards of a 2-shard mesh: shard 5 is no one's
    (("--mesh-shards", "2", "--mesh-shard", "5", "--device", "cpu"), {},
     "is not local"),
    (("--mesh-shards", "2"), {"CUDA_VISIBLE_DEVICES": ""},
     "CUDA is not available"),
    (("--mesh-shards", "2", "--device", "cpu", "--multihost-coordinator",
      "127.0.0.1:1"), {}, "the process count"),
], ids=["cuda-hidden", "pallas", "bls", "unknown-transport",
         "plane-and-mesh",
        "shard-without-mesh", "non-local-shard", "mesh-cuda-hidden",
        "partial-multihost"])
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


def _have_redis_package() -> bool:
    try:
        import redis.asyncio  # noqa: F401
        return True
    except ImportError:
        return False


def test_redis_discovery_is_refused(tmp_path):
    """A ``redis://`` endpoint selects Redis discovery on the marshal and
    the broker; where the ``redis`` package is absent each exits non-zero
    with the JAX package's message (and where it is present, nothing
    answers on port 1), never with a "not ported" one."""
    pub, priv = _free_ports(2)
    for args in (("marshal", "--discovery-endpoint", "redis://127.0.0.1:1"),
                 ("broker", *_broker_args("redis://127.0.0.1:1", pub, priv))):
        p = spawn_binary(*args)
        out, _ = p.communicate(timeout=60)
        assert p.returncode not in (0, None), out[-2000:]
        assert "not ported" not in out and "ROADMAP" not in out, out[-2000:]
        if not _have_redis_package():
            assert "the 'redis' package is not available" in out, \
                out[-2000:]


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


async def test_multihost_broker_binaries_end_to_end(tmp_path):
    """A marshal and two ``broker --mesh-shards 2 --multihost-* --device
    cpu`` processes, one shard each: a client on each broker, a broadcast
    from one reaching the other through the mesh step, a direct crossing
    back through the user-slot directory, no host broker link on either
    side; both brokers exit 0 on SIGTERM with their exit lines."""
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.discovery.embedded import Embedded
    from pushcdn_tpu_torch.proto.message import Broadcast, Direct
    from pushcdn_tpu_torch.proto.transport import Tcp

    db = str(tmp_path / "cdn.sqlite")
    ports = _free_ports(8)
    coordinator, marshal = ports[:2]
    logs = {n: tmp_path / f"{n}.log" for n in ("marshal", "b0", "b1")}
    procs = {"marshal": spawn_binary(
        "marshal", "--discovery-endpoint", db,
        "--bind-endpoint", f"127.0.0.1:{marshal}", "--user-transport", "tcp",
        log_path=logs["marshal"])}
    metrics = {}
    for rank in (0, 1):
        pub, priv, metrics[rank] = ports[2 + 3 * rank:5 + 3 * rank]
        procs[f"b{rank}"] = spawn_binary(
            "broker", *_broker_args(
                db, pub, priv, "--metrics-bind-endpoint",
                f"127.0.0.1:{metrics[rank]}", "--user-transport", "tcp",
                "--heartbeat-interval", "0.2", "--mesh-shards", "2",
                "--multihost-coordinator", f"127.0.0.1:{coordinator}",
                "--multihost-process-id", str(rank),
                "--multihost-num-processes", "2", "--device", "cpu",
                "--device-ring-slots", "16", "--device-batch-window", "0.01"),
            log_path=logs[f"b{rank}"])

    async def gauge(rank, name):
        text = await asyncio.to_thread(
            lambda: urllib.request.urlopen(
                f"http://127.0.0.1:{metrics[rank]}/metrics",
                timeout=5).read().decode())
        return next(float(line.split()[-1]) for line in text.splitlines()
                    if line.startswith(name + " "))

    async def users():
        out = []
        for rank in (0, 1):
            try:
                out.append(await gauge(rank, "cdn_num_users_connected"))
            except OSError:
                out.append(None)
        return out

    clients = []
    try:
        for i, seed in enumerate((7101, 7102)):
            c = Client(ClientConfig(
                marshal_endpoint=f"127.0.0.1:{marshal}",
                keypair=DEFAULT_SCHEME.generate_keypair(seed=seed),
                protocol=Tcp, subscribed_topics={0}))
            async with asyncio.timeout(45):   # cold start + registration
                await c.ensure_initialized()
                # the marshal places by load: the next client goes to the
                # other broker once this one's heartbeat counts its user
                while sorted(await users()) != ([0.0, 1.0] if i == 0
                                                else [1.0, 1.0]):
                    await asyncio.sleep(0.05)
            await asyncio.sleep(1.0)   # 5 heartbeats carry the load
            clients.append(c)
        alice, bob = clients
        await alice.send_broadcast_message([0], b"across processes")
        for c in clients:
            m = await asyncio.wait_for(c.receive_message(), 20)
            assert isinstance(m, Broadcast) and \
                bytes(m.message) == b"across processes"
        # directs need the recipient's slot in the sender's directory
        # mirror: wait for both entries, then for the mirrors' refresh
        directory = await Embedded.new(db)
        async with asyncio.timeout(20):
            while len(await directory.get_user_slots()) < 2:
                await asyncio.sleep(0.05)
        await directory.close()
        await asyncio.sleep(1.5)
        await bob.send_direct_message(alice.public_key, b"and back")
        m = await asyncio.wait_for(alice.receive_message(), 20)
        assert isinstance(m, Direct) and bytes(m.message) == b"and back"
        assert [await gauge(r, "cdn_num_brokers_connected")
                for r in (0, 1)] == [0.0, 0.0]
        for c in clients:
            c.close()
        assert all(p.poll() is None for p in procs.values()), \
            "a binary died during the test"
        for p in procs.values():
            p.send_signal(signal.SIGTERM)
        rcs = {n: await asyncio.to_thread(p.wait, 30)
               for n, p in procs.items()}
        assert rcs == {"marshal": 0, "b0": 0, "b1": 0}, \
            {n: logs[n].read_text()[-2000:] for n in procs}
        for rank in (0, 1):
            text = logs[f"b{rank}"].read_text()
            serving = _exit_fields(text, "broker serving")
            done = _exit_fields(text, "device plane exit")
            assert serving["mesh_shards"] == 2
            assert serving["local_shards"] == [rank] == [serving["shard"]]
            assert serving["exchange"] == "gloo, CPU tensors"
            assert done["steps"] > 0 and done["messages_routed"] >= 1
            assert done["launches"] == {"delivery_matrix_cuda": 0,
                                        "ragged_delivery_cuda": 0}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()


# ---------------------------------------------------------------------------
# --shards: one broker identity as N worker processes (worker shards)
# ---------------------------------------------------------------------------

def _get(port: int, path: str) -> tuple:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


async def _sharded_broker_end_to_end(tmp_path, handoff: bool) -> None:
    """A marshal and ``broker --shards 2`` without a plane: two clients on
    different workers exchange a broadcast and a direct; the supervisor's
    ``/metrics`` carries both workers' ``shard`` labels and the ring
    records; every process exits 0 on SIGTERM."""
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.message import Broadcast, Direct
    from pushcdn_tpu_torch.proto.transport import Tcp, TcpTls
    from pushcdn_tpu_torch.proto.util import mnemonic

    db = str(tmp_path / "cdn.sqlite")
    # the workers' own endpoints sit on the supervisor's metrics port + 1
    # and + 2: take three ports in a row
    pub, priv, marshal = _free_ports(3)
    metrics = _free_ports(1)[0]
    while not all(_port_free(metrics + k) for k in (1, 2)):
        metrics = _free_ports(1)[0]
    transport, protocol = ("tcp", Tcp) if handoff else ("tcp+tls", TcpTls)
    env = {"PUSHCDN_SHARD_ACCEPT": "handoff"} if handoff else {}
    logs = {n: tmp_path / f"{n}.log" for n in ("broker", "marshal")}
    procs = {
        "broker": spawn_binary(
            "broker", *_broker_args(
                db, pub, priv, "--metrics-bind-endpoint",
                f"127.0.0.1:{metrics}", "--user-transport", transport,
                "--shards", "2"),
            env_extra=env, log_path=logs["broker"]),
        "marshal": spawn_binary(
            "marshal", "--discovery-endpoint", db,
            "--bind-endpoint", f"127.0.0.1:{marshal}",
            "--user-transport", transport, log_path=logs["marshal"]),
    }

    async def topology():
        status, body = await asyncio.to_thread(_get, metrics,
                                               "/debug/topology")
        return json.loads(body) if status == 200 else None

    async def shard_of(client):
        want = mnemonic(client.public_key)
        async with asyncio.timeout(20):
            while True:
                topo = await topology()
                for u in (topo or {}).get("users", []):
                    if u["key"] == want:
                        return u["shard"]
                await asyncio.sleep(0.05)

    clients, placed = [], {}
    try:
        for seed in range(9100, 9120):   # bounded retries for a spread
            c = Client(ClientConfig(
                marshal_endpoint=f"127.0.0.1:{marshal}",
                keypair=DEFAULT_SCHEME.generate_keypair(seed=seed),
                protocol=protocol, subscribed_topics={0}))
            async with asyncio.timeout(45):   # cold start + registration
                await c.ensure_initialized()
            shard = await shard_of(c)
            if shard in placed:
                c.close()
                continue
            placed[shard] = c
            clients.append(c)
            if len(placed) == 2:
                break
        assert sorted(placed) == [0, 1], \
            f"no client landed on the second worker: {sorted(placed)}"
        alice, bob = placed[0], placed[1]
        await bob.send_broadcast_message([0], b"across workers")
        for c in clients:
            m = await asyncio.wait_for(c.receive_message(), 20)
            assert isinstance(m, Broadcast) and \
                bytes(m.message) == b"across workers"
        await bob.send_direct_message(alice.public_key, b"and back")
        m = await asyncio.wait_for(alice.receive_message(), 20)
        assert isinstance(m, Direct) and bytes(m.message) == b"and back"
        status, text = await asyncio.to_thread(_get, metrics, "/metrics")
        assert status == 200
        assert 'shard="0"' in text and 'shard="1"' in text
        assert "cdn_shard_workers 2" in text
        ring = sum(float(line.split()[-1]) for line in text.splitlines()
                   if line.startswith("cdn_shard_handoff_records{")
                   and 'path="ring"' in line)
        assert ring >= 2, "the broadcast and the direct crossed no ring"
        # host-only workers: torch never loads
        info = [line for line in text.splitlines()
                if line.startswith("cdn_build_info{")]
        assert len(info) == 2 and all('torch="absent"' in i for i in info)
        status, body = await asyncio.to_thread(_get, metrics, "/readyz")
        assert status == 200, body
        assert {"shard0:listeners", "shard1:listeners"} <= \
            set(json.loads(body)["checks"])
        for c in clients:
            c.close()
        assert all(p.poll() is None for p in procs.values()), \
            "a binary died during the test"
        for p in procs.values():
            p.send_signal(signal.SIGTERM)
        rcs = {n: await asyncio.to_thread(p.wait, 40)
               for n, p in procs.items()}
        assert rcs == {"broker": 0, "marshal": 0}, \
            {n: logs[n].read_text()[-3000:] for n in procs}
        # each worker drained and logged its exit line before the
        # supervisor reaped it
        assert logs["broker"].read_text().count("device plane exit {") == 2
    finally:
        for c in clients:
            c.close()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()


def _port_free(port: int) -> bool:
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", port))
        return True
    except OSError:
        return False
    finally:
        s.close()


async def test_sharded_broker_binary_end_to_end(tmp_path):
    """``--shards 2`` with users spread by ``SO_REUSEPORT`` over TCP+TLS."""
    await _sharded_broker_end_to_end(tmp_path, handoff=False)


async def test_sharded_broker_binary_fd_handoff(tmp_path):
    """The same with ``reuseport_available`` False in the supervisor
    (``PUSHCDN_SHARD_ACCEPT=handoff``): it binds the user port once and
    deals accepted sockets to the workers over ``SCM_RIGHTS``."""
    await _sharded_broker_end_to_end(tmp_path, handoff=True)


@pytest.mark.parametrize("args,env,needle", [
    (("--shards", "2", "--device-plane", "--device", "cpu"), {},
     "--shards is a host-data-plane feature"),
    (("--shards", "2", "--mesh-shards", "2", "--device", "cpu"), {},
     "--shards is a host-data-plane feature"),
    (("--shards", "2"), {"PUSHCDN_SHARD_ACCEPT": "handoff"},
     "supports only --user-transport tcp"),
], ids=["plane", "mesh-group", "handoff-tls"])
def test_sharded_broker_binary_refusals(tmp_path, args, env, needle):
    """The JAX binary's refusals, word for word: ``--shards`` with a
    device plane or a mesh group, and the fd-handoff acceptor with any
    user transport but ``tcp``; no worker ever starts."""
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
    assert "shard worker" not in out and "broker serving" not in out


# ---------------------------------------------------------------------------
# the drain: signals before start, re-homing, GET /drain, the io knobs
# ---------------------------------------------------------------------------

_HELD_START = '''
import asyncio
import sys

from pushcdn_tpu_torch.broker import device_plane


async def _held_start(self):
    print("plane start held", file=sys.stderr, flush=True)
    await asyncio.sleep(120)


device_plane.DevicePlane.start = _held_start
'''


async def _wait_for_line(path, needle: str, proc, timeout: float = 60):
    async with asyncio.timeout(timeout):
        while needle not in (path.read_text() if path.exists() else ""):
            assert proc.poll() is None, path.read_text()[-3000:]
            await asyncio.sleep(0.05)


async def test_drain_signal_during_held_start_drains(tmp_path):
    """A SIGTERM while the broker's start is held (its plane's warm-up,
    the window where the card builds its kernels) drains: the broker logs
    the re-home and its exit line and exits 0, instead of dying by the
    signal."""
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(_HELD_START)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pub, priv = _free_ports(2)
    log = tmp_path / "broker.log"
    proc = spawn_binary(
        "broker", *_broker_args(str(tmp_path / "d.sqlite"), pub, priv,
                                "--device-plane", "--device", "cpu"),
        env_extra={"PYTHONPATH": repo + os.pathsep + str(hook)},
        log_path=log)
    try:
        await _wait_for_line(log, "plane start held", proc)
        proc.send_signal(signal.SIGTERM)
        rc = await asyncio.to_thread(proc.wait, 30)
        text = log.read_text()
        assert rc == 0, text[-3000:]
        assert "drain re-home: {'users': 0" in text, text[-3000:]
        exit_line = _exit_fields(text, "device plane exit")
        assert exit_line["steps"] == 0, text[-3000:]
        assert "broker serving" not in text
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def _uring_allowed() -> bool:
    from pushcdn_tpu_torch.native import uring
    return uring.available()


async def _scrape(port: int) -> str:
    def get():
        return urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=5).read().decode()
    return await asyncio.to_thread(get)


def _io_impl_series(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line.startswith("cdn_io_impl{"):
            impl = line.split('impl="', 1)[1].split('"', 1)[0]
            out[impl] = float(line.split()[-1])
    return out


async def _serve_with_io_knobs(tmp_path, name, env, hook=None):
    """Start ``name`` (broker or marshal) with its users on tcp and the
    given io knobs; returns (rc, log text, cdn_io_impl series) — rc None
    for a process that served until SIGTERM and then exited 0."""
    db = str(tmp_path / "d.sqlite")
    metrics = _free_ports(1)[0]
    if name == "broker":
        pub, priv = _free_ports(2)
        args = _broker_args(db, pub, priv, "--user-transport", "tcp",
                            "--metrics-bind-endpoint",
                            f"127.0.0.1:{metrics}")
    else:
        args = ["--discovery-endpoint", db, "--bind-endpoint",
                f"127.0.0.1:{_free_ports(1)[0]}", "--user-transport", "tcp",
                "--metrics-bind-endpoint", f"127.0.0.1:{metrics}"]
    env = dict(env)
    if hook is not None:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = repo + os.pathsep + str(hook)
    log = tmp_path / f"{name}.log"
    proc = spawn_binary(name, *args, env_extra=env, log_path=log)
    try:
        series = None
        async with asyncio.timeout(60):
            while proc.poll() is None:
                try:
                    series = _io_impl_series(await _scrape(metrics))
                except (OSError, urllib.error.URLError):
                    series = None
                if series:
                    break
                await asyncio.sleep(0.2)
        if proc.poll() is not None:
            return proc.wait(), log.read_text(), series
        proc.send_signal(signal.SIGTERM)
        rc = await asyncio.to_thread(proc.wait, 30)
        text = log.read_text()
        assert rc == 0, text[-2000:]
        return None, text, series
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


@pytest.mark.parametrize("name,env", [
    ("broker", {"PUSHCDN_IO_IMPL": "uring"}),
    ("marshal", {"PUSHCDN_IO_IMPL": "uring"}),
    ("broker", {"PUSHCDN_IO_URING": "1"}),
    ("marshal", {"PUSHCDN_IO_IMPL": "auto"}),
    ("broker", {"PUSHCDN_IO_URING": "auto"}),
    ("marshal", {"PUSHCDN_IO_IMPL": "asyncio"}),
], ids=["uring-broker", "uring-marshal", "legacy-uring-broker",
        "auto-marshal", "legacy-auto-broker", "asyncio-marshal"])
async def test_io_knobs_are_answered(tmp_path, name, env):
    """The io knobs as the JAX package's binaries answer them: an explicit
    (or legacy) ``uring`` engages the io_uring engine
    (``cdn_io_impl{impl="uring"}``), ``auto`` engages it where the kernel
    allows io_uring and demotes with one warning elsewhere, ``asyncio``
    stays on asyncio and says nothing."""
    want = "asyncio" if "asyncio" in env.values() else "uring"
    if want == "uring" and not _uring_allowed():
        if "auto" not in env.values():
            pytest.skip("the kernel denies io_uring: the explicit case "
                        "is the denial test's")
        want = "asyncio"
    rc, text, series = await _serve_with_io_knobs(tmp_path, name, env)
    assert rc is None, text[-2000:]
    assert series == {want: 1.0}, (series, text[-2000:])
    assert text.count("demoted to asyncio") == \
        (1 if want == "asyncio" and "auto" in env.values() else 0), text


_DENY_URING = """
import errno
from pushcdn_tpu_torch.native import uring
uring._probe_result = -errno.ENOSYS
"""


@pytest.mark.parametrize("name,env,refused", [
    ("broker", {"PUSHCDN_IO_IMPL": "uring"}, True),
    ("marshal", {"PUSHCDN_IO_URING": "1"}, True),
    ("broker", {"PUSHCDN_IO_IMPL": "auto"}, False),
], ids=["uring-broker", "legacy-uring-marshal", "auto-broker"])
async def test_io_knobs_under_a_kernel_that_denies_io_uring(
        tmp_path, name, env, refused):
    """With the probe answering ENOSYS (a ``sitecustomize`` sets it in
    the child), an explicit ``uring`` exits non-zero naming the errno and
    never serves, and ``auto`` serves on asyncio after one warning."""
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(_DENY_URING)
    rc, text, series = await _serve_with_io_knobs(tmp_path, name, env,
                                                  hook=hook)
    if refused:
        assert rc not in (0, None), text[-2000:]
        assert "ENOSYS" in text and "io_uring is unavailable" in text, \
            text[-2000:]
        return
    assert rc is None, text[-2000:]
    assert series == {"asyncio": 1.0}, (series, text[-2000:])
    assert text.count("demoted to asyncio") == 1, text
    assert "ENOSYS" in text


@pytest.mark.parametrize("transport", ["tcp", "tcp+tls", "quic"])
async def test_binaries_serve_a_client_over(tmp_path, transport):
    """A marshal and a broker, both on ``--user-transport`` as given,
    serve a client of the same transport: a direct to itself and a
    broadcast come back; both exit 0 on SIGTERM."""
    from pushcdn_tpu_torch.bin.common import TRANSPORTS
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME

    db = str(tmp_path / "cdn.sqlite")
    pub, priv, marshal = _free_ports(3)
    logs = {n: tmp_path / f"{n}.log" for n in ("broker", "marshal")}
    procs = {
        "broker": spawn_binary(
            "broker", *_broker_args(db, pub, priv, "--user-transport",
                                    transport), log_path=logs["broker"]),
        "marshal": spawn_binary(
            "marshal", "--discovery-endpoint", db,
            "--bind-endpoint", f"127.0.0.1:{marshal}",
            "--user-transport", transport, log_path=logs["marshal"]),
    }
    try:
        keypair = DEFAULT_SCHEME.generate_keypair(seed=9700)
        client = Client(ClientConfig(
            marshal_endpoint=f"127.0.0.1:{marshal}", keypair=keypair,
            protocol=TRANSPORTS[transport], subscribed_topics={3}))
        async with asyncio.timeout(45):
            await client.ensure_initialized()
            await client.send_direct_message(keypair.public_key, b"self")
            await client.send_broadcast_message([3], b"all")
            got = []
            while len(got) < 2:
                got += await client.receive_messages()
        # (a delivery may carry a trace block: TracedDirect and the like)
        assert sorted(bytes(m.message) for m in got) == [b"all", b"self"]
        client.close()
        for p in procs.values():
            p.send_signal(signal.SIGTERM)
        rcs = {n: await asyncio.to_thread(p.wait, 30)
               for n, p in procs.items()}
        assert rcs == {"broker": 0, "marshal": 0}, \
            {n: logs[n].read_text()[-2000:] for n in procs}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()


async def test_binaries_serve_bls_clients_through_a_dense_plane(tmp_path):
    """The production run definition's shape as processes: a marshal and a
    broker with ``--scheme bls-bn254``, users on TCP+TLS, the broker link
    on TCP and a dense plane (on the CPU here). Two BLS clients get a
    direct and a broadcast back; the marshal's ``/metrics`` counts its BLS
    verifications and line-table misses; both exit 0 on SIGTERM."""
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.crypto.signature import BlsBn254Scheme
    from pushcdn_tpu_torch.proto.transport import TcpTls

    db = str(tmp_path / "cdn.sqlite")
    pub, priv, marshal, metrics = _free_ports(4)
    logs = {n: tmp_path / f"{n}.log" for n in ("broker", "marshal")}
    scheme = ("--scheme", "bls-bn254")
    procs = {
        "broker": spawn_binary(
            "broker", *_broker_args(
                db, pub, priv, "--user-transport", "tcp+tls",
                "--broker-transport", "tcp", "--device-plane", "--device",
                "cpu", "--device-ring-slots", "64", *scheme),
            log_path=logs["broker"]),
        "marshal": spawn_binary(
            "marshal", "--discovery-endpoint", db,
            "--bind-endpoint", f"127.0.0.1:{marshal}",
            "--metrics-bind-endpoint", f"127.0.0.1:{metrics}",
            "--user-transport", "tcp+tls", *scheme,
            log_path=logs["marshal"]),
    }
    try:
        clients = [Client(ClientConfig(
            marshal_endpoint=f"127.0.0.1:{marshal}",
            keypair=BlsBn254Scheme.generate_keypair(seed=9800 + i),
            protocol=TcpTls, scheme=BlsBn254Scheme, subscribed_topics={3}))
            for i in range(2)]
        async with asyncio.timeout(60):
            await asyncio.gather(*(c.ensure_initialized() for c in clients))
            await clients[0].send_direct_message(clients[1].public_key,
                                                 b"to you")
            await clients[1].send_broadcast_message([3], b"all")
            got = [[], []]
            while len(got[0]) < 1 or len(got[1]) < 2:
                for i, c in enumerate(clients):
                    if len(got[i]) < 2 - (i == 0):
                        got[i] += await asyncio.wait_for(
                            c.receive_messages(), 10)
        assert [sorted(bytes(m.message) for m in g) for g in got] \
            == [[b"all"], [b"all", b"to you"]]
        text = await _scrape(metrics)
        series = {line.split()[0]: float(line.split()[-1])
                  for line in text.splitlines()
                  if line.startswith(("cdn_native_seconds{",
                                      "cdn_bls_pk_cache{"))}
        assert series.get('cdn_native_seconds{kernel="bls_verify"}', 0) > 0
        assert series.get('cdn_bls_pk_cache{stat="misses"}', 0) >= 2, series
        for c in clients:
            c.close()
        for p in procs.values():
            p.send_signal(signal.SIGTERM)
        rcs = {n: await asyncio.to_thread(p.wait, 30)
               for n, p in procs.items()}
        assert rcs == {"broker": 0, "marshal": 0}, \
            {n: logs[n].read_text()[-2000:] for n in procs}
        done = _exit_fields(logs["broker"].read_text(), "device plane exit")
        assert done is not None and done["delivery_impl"] == "dense"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()


def _drain_summaries(text: str) -> list:
    import ast
    return [ast.literal_eval(line.split("drain re-home: ", 1)[1])
            for line in text.splitlines() if "drain re-home: " in line]


async def _collect(client, box: list) -> None:
    """Receive forever into ``box``: a client acts on ``Migrate`` while it
    receives."""
    try:
        while True:
            box.extend(await client.receive_messages())
    except asyncio.CancelledError:
        raise
    except Exception:
        return


async def _rehome_run(tmp_path, shards: int) -> None:
    """A marshal and broker A (``--shards`` as given) serve four clients;
    broker B starts; A is signaled and re-homes every client to B, which
    then delivers a broadcast to all of them, replays its retained topic,
    and answers ``GET /drain`` with nowhere to send its users."""
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.message import Broadcast, Retained
    from pushcdn_tpu_torch.proto.transport import Tcp

    db = str(tmp_path / "cdn.sqlite")
    a_pub, a_priv, b_pub, b_priv, marshal, b_metrics = _free_ports(6)
    env = {"PUSHCDN_RETAIN_TOPICS": "0", "PUSHCDN_DRAIN_GRACE_S": "1",
           "PUSHCDN_SHARD_ACCEPT": "handoff"}
    common = ("--user-transport", "tcp", "--heartbeat-interval", "0.3")
    logs = {n: tmp_path / f"{n}.log" for n in ("a", "b", "marshal")}
    a_args = _broker_args(db, a_pub, a_priv, *common)
    if shards > 1:
        a_args += ["--shards", str(shards)]
    procs = {
        "marshal": spawn_binary(
            "marshal", "--discovery-endpoint", db,
            "--bind-endpoint", f"127.0.0.1:{marshal}",
            "--user-transport", "tcp", log_path=logs["marshal"]),
        "a": spawn_binary("broker", *a_args, env_extra=env,
                          log_path=logs["a"]),
    }
    clients, boxes, tasks = [], [], []
    try:
        for seed in range(9300, 9304):
            c = Client(ClientConfig(
                marshal_endpoint=f"127.0.0.1:{marshal}",
                keypair=DEFAULT_SCHEME.generate_keypair(seed=seed),
                protocol=Tcp, subscribed_topics={0}))
            async with asyncio.timeout(45):
                await c.ensure_initialized()
            clients.append(c)
            boxes.append([])
            tasks.append(asyncio.create_task(_collect(c, boxes[-1])))
        procs["b"] = spawn_binary(
            "broker", *_broker_args(
                db, b_pub, b_priv, *common, "--metrics-bind-endpoint",
                f"127.0.0.1:{b_metrics}"),
            env_extra=env, log_path=logs["b"])
        await _wait_for_line(logs["b"], "broker serving", procs["b"])
        await asyncio.sleep(1.0)  # B's heartbeat registers it
        procs["a"].send_signal(signal.SIGTERM)
        rc = await asyncio.to_thread(procs["a"].wait, 40)
        a_text = logs["a"].read_text()
        assert rc == 0, a_text[-3000:]
        summaries = _drain_summaries(a_text)
        assert len(summaries) == shards, a_text[-3000:]
        assert sum(s["users"] for s in summaries) == 4
        assert sum(s["signaled"] for s in summaries) == 4
        assert sum(s["orphaned"] for s in summaries) == 0
        if shards > 1:
            assert all(s["users"] > 0 for s in summaries), summaries

        async def b_users():
            status, body = await asyncio.to_thread(_get, b_metrics,
                                                   "/debug/topology")
            return json.loads(body)["num_users"] if status == 200 else -1
        async with asyncio.timeout(20):
            while await b_users() != 4:
                await asyncio.sleep(0.1)
        for i in range(3):
            await clients[0].send_broadcast_message([0], b"on b %d" % i)
        async with asyncio.timeout(20):
            while not all(sum(isinstance(m, Broadcast) for m in box) >= 3
                          for box in boxes):
                await asyncio.sleep(0.05)
        for box in boxes:
            assert [bytes(m.message) for m in box
                    if isinstance(m, Broadcast)] == [b"on b 0", b"on b 1",
                                                     b"on b 2"]
        # B retains topic 0: a replay subscribe gets the three back
        await clients[1].subscribe_from(0, 0)
        async with asyncio.timeout(20):
            while sum(isinstance(m, Retained) for m in boxes[1]) < 3:
                await asyncio.sleep(0.05)
        assert [(m.seq, bytes(m.payload)) for m in boxes[1]
                if isinstance(m, Retained)] == [
            (1, b"on b 0"), (2, b"on b 1"), (3, b"on b 2")]
        # B is the last broker: GET /drain finds no target, users stay
        status, body = await asyncio.to_thread(_get, b_metrics, "/drain")
        assert status == 200, body
        drained = json.loads(body)
        assert drained["no_target"] and drained["users"] == 4, drained
        assert await b_users() == 4
        status, _ = await asyncio.to_thread(_get, b_metrics, "/readyz")
        assert status == 503
        for t in tasks:
            t.cancel()
        for c in clients:
            c.close()
        for n in ("b", "marshal"):
            procs[n].send_signal(signal.SIGTERM)
        rcs = {n: await asyncio.to_thread(procs[n].wait, 30)
               for n in ("b", "marshal")}
        assert rcs == {"b": 0, "marshal": 0}, \
            {n: logs[n].read_text()[-2000:] for n in rcs}
    finally:
        for t in tasks:
            t.cancel()
        for c in clients:
            c.close()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()


async def test_sigterm_rehomes_clients_to_the_other_broker(tmp_path):
    """Two broker processes and a marshal: a SIGTERM to the one holding
    every client re-homes them all to the other (``Migrate`` with a
    pre-issued permit), which then delivers to them, replays its retained
    topic (``PUSHCDN_RETAIN_TOPICS``) and answers ``GET /drain``."""
    await _rehome_run(tmp_path, shards=1)


async def test_sharded_broker_rehomes_the_users_of_every_worker(tmp_path):
    """The same with broker A as ``--shards 2`` (the fd-handoff acceptor
    deals the clients over both workers): the supervisor forwards the
    signal and each worker re-homes its own users."""
    await _rehome_run(tmp_path, shards=2)


def _free_run(n: int) -> int:
    """A base port with ``n`` consecutive free ports above it."""
    for _ in range(200):
        (base,) = _free_ports(1)
        if base + n >= 65536:
            continue
        socks = []
        try:
            for off in range(n):
                sock = socket.socket()
                socks.append(sock)
                sock.bind(("127.0.0.1", base + off))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    raise RuntimeError("no run of free ports")


@pytest.mark.parametrize("name", ["bad_broker", "bad_connector",
                                  "bad_sender"])
async def test_chaos_binary_runs_against_a_deployment(tmp_path, name,
                                                     monkeypatch):
    """A marshal and a broker serve; the chaos binary runs 3 cycles
    against them and exits 0: ``bad_broker`` starts three brokers on the
    deployment's discovery file, each killing the one before;
    ``bad_connector`` authenticates three fresh identities; ``bad_sender``
    broadcasts three 4 KB messages."""
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME
    from pushcdn_tpu_torch.proto.transport import Tcp

    # whatever io knobs another test of this process left set
    monkeypatch.setenv("PUSHCDN_IO_IMPL", "asyncio")
    monkeypatch.delenv("PUSHCDN_IO_URING", raising=False)
    db = str(tmp_path / "cdn.sqlite")
    pub, priv, marshal = _free_ports(3)
    logs = {n: tmp_path / f"{n}.log" for n in ("broker", "marshal", name)}
    procs = {
        "broker": spawn_binary(
            "broker", *_broker_args(db, pub, priv, "--user-transport", "tcp"),
            log_path=logs["broker"]),
        "marshal": spawn_binary(
            "marshal", "--discovery-endpoint", db,
            "--bind-endpoint", f"127.0.0.1:{marshal}",
            "--user-transport", "tcp", log_path=logs["marshal"]),
    }
    try:
        await _wait_for_line(logs["broker"], "broker serving",
                             procs["broker"])
        # the broker is registered once a client gets through the marshal
        probe = Client(ClientConfig(
            marshal_endpoint=f"127.0.0.1:{marshal}",
            keypair=DEFAULT_SCHEME.generate_keypair(seed=9400),
            protocol=Tcp, subscribed_topics={0}))
        async with asyncio.timeout(45):
            await probe.ensure_initialized()
        if name == "bad_broker":
            args = ["--discovery-endpoint", db, "--cycles", "3",
                    "--churn-interval", "0.3",
                    "--base-port", str(_free_run(6))]
        else:
            args = ["--marshal-endpoint", f"127.0.0.1:{marshal}",
                    "--cycles", "3"]
            if name == "bad_connector":
                args += ["--connect-interval", "0.05"]
            else:
                args += ["--message-size", "4096"]
        proc = spawn_binary(name, *args, log_path=logs[name])
        rc = await asyncio.to_thread(proc.wait, 60)
        text = logs[name].read_text()
        assert rc == 0, text[-3000:]
        if name == "bad_broker":
            import re
            ups = re.findall(r"churn (\d+): broker on ports \d+/\d+ up", text)
            assert ups == ["0", "1", "2"], text[-3000:]
            assert text.count("previous broker killed") == 2, text[-3000:]
        elif name == "bad_connector":
            assert text.count("fresh identity connected") == 3, text[-3000:]
            assert "failed" not in text, text[-3000:]
        else:
            assert "firehose: 1 msgs" in text, text[-3000:]
            # the probe, subscribed to topic 0, takes the three broadcasts
            got = 0
            async with asyncio.timeout(20):
                while got < 3:
                    got += len(await probe.receive_messages())
        probe.close()
        for n in ("broker", "marshal"):
            procs[n].send_signal(signal.SIGTERM)
        rcs = {n: await asyncio.to_thread(procs[n].wait, 30)
               for n in ("broker", "marshal")}
        assert rcs == {"broker": 0, "marshal": 0}, \
            {n: logs[n].read_text()[-2000:] for n in rcs}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
