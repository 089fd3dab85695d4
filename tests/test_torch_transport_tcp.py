"""The port's TCP, TCP+TLS and TLS-stream transports held against the JAX
package's on the loopback.

Both packages bind a listener, connect to it and send the same seeded
messages both ways, one at a time and pipelined; every frame that
arrives must equal the JAX package's and what was sent, byte for byte.
"""

import asyncio
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ("jax", "port")


def _pkg(name: str) -> SimpleNamespace:
    root = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}[name]

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    transport = mod("proto.transport")
    return SimpleNamespace(
        name=name, msg=mod("proto.message"), error=mod("proto.error"),
        base=mod("proto.transport.base"), tls=mod("proto.crypto.tls"),
        tls_stream=mod("proto.transport.tls_stream"),
        protocols={"tcp": transport.Tcp, "tcp+tls": transport.TcpTls})


def _messages(p, seed: int):
    """Seeded messages of every size class, up to 96 KB."""
    rng = np.random.default_rng(seed)
    m = p.msg
    out = []
    for _ in range(int(rng.integers(30, 80))):
        size = int(rng.choice([rng.integers(0, 64), rng.integers(64, 4096),
                               rng.integers(4096, 96 * 1024)],
                              p=[0.4, 0.5, 0.1]))
        body = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        if rng.random() < 0.5:
            out.append(m.Broadcast([int(t) for t in rng.integers(0, 256, 3)],
                                   body))
        else:
            out.append(m.Direct(bytes(rng.integers(0, 256, 32,
                                                   dtype=np.uint8)), body))
    return out


async def _exchange(p, a, b, seed: int):
    """Send the seeded messages a -> b one by one, then b -> a as one
    pipelined batch; returns the frames each side received."""
    msgs = _messages(p, seed)
    got_b, got_a = [], []
    for msg in msgs:
        await a.send_message(msg, flush=True)
        got_b.append(p.msg.serialize(await b.recv_message()))
    await b.send_raw_many([p.msg.serialize(x) for x in msgs], flush=True)
    while len(got_a) < len(msgs):
        for raw in await a.recv_raw_many():
            got_a.append(bytes(raw.data))
            raw.release()
    return got_b, got_a


async def _over_protocol(p, protocol: str, seed: int):
    proto = p.protocols[protocol]
    listener = await proto.bind("127.0.0.1:0")
    a = b = None
    try:
        dial = asyncio.ensure_future(
            proto.connect(f"127.0.0.1:{listener.bound_port}"))
        b = await (await listener.accept()).finalize()
        a = await dial
        return await _exchange(p, a, b, seed)
    finally:
        for conn in (a, b):
            if conn is not None:
                conn.close()
        await listener.close()


@pytest.mark.parametrize("protocol", ["tcp", "tcp+tls"])
@pytest.mark.parametrize("seed", range(2))
async def test_protocol_carries_what_the_jax_one_carries(protocol, seed):
    out = {}
    async with asyncio.timeout(60):
        for name in PACKAGES:
            out[name] = await _over_protocol(_pkg(name), protocol, seed)
    sent = [_pkg("port").msg.serialize(m) for m in _messages(_pkg("port"),
                                                              seed)]
    assert out["port"] == out["jax"] == (sent, sent)


async def _over_tls_stream(p, seed: int):
    """A TLS stream over a plain asyncio socket pair, each end wrapped
    in a ``Connection``."""
    accepted = asyncio.get_running_loop().create_future()

    async def on_client(reader, writer):
        accepted.set_result(p.base.AsyncioStream(reader, writer))

    server = await asyncio.start_server(on_client, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    a = b = None
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        ctx, hostname = p.tls.client_context_for(True, "127.0.0.1")
        client_side = asyncio.ensure_future(p.tls_stream.TlsStream.wrap_client(
            p.base.AsyncioStream(reader, writer), ctx, hostname))
        server_stream = await p.tls_stream.TlsStream.wrap_server(
            await accepted, p.tls.local_certificate().server_context())
        a = p.base.Connection(await client_side)
        b = p.base.Connection(server_stream)
        return await _exchange(p, a, b, seed)
    finally:
        for conn in (a, b):
            if conn is not None:
                conn.close()
        server.close()
        await server.wait_closed()


@pytest.mark.parametrize("seed", range(2))
async def test_tls_stream_carries_what_the_jax_one_carries(seed):
    out = {}
    async with asyncio.timeout(60):
        for name in PACKAGES:
            out[name] = await _over_tls_stream(_pkg(name), seed)
    sent = [_pkg("port").msg.serialize(m) for m in _messages(_pkg("port"),
                                                              seed)]
    assert out["port"] == out["jax"] == (sent, sent)


@pytest.mark.parametrize("protocol", ["tcp", "tcp+tls"])
async def test_connect_to_a_closed_port_is_a_typed_error(protocol):
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    kinds = {}
    async with asyncio.timeout(30):
        for name in PACKAGES:
            p = _pkg(name)
            with pytest.raises(p.error.Error) as ei:
                await p.protocols[protocol].connect(f"127.0.0.1:{port}")
            kinds[name] = ei.value.kind.name
    assert kinds["port"] == kinds["jax"] == "CONNECTION"
