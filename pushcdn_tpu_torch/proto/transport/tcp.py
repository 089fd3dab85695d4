"""Plain TCP transport.

Capability parity with cdn-proto/src/connection/protocols/tcp.rs:37-173:
TCP_NODELAY on both sides, 5 s connect timeout, u32 length-delimited frames
(framing lives in transport.base).

The port's copy of ``pushcdn_tpu.proto.transport.tcp``: with
``PUSHCDN_IO_IMPL=uring`` (or ``auto`` where the kernel allows it) the
byte path runs on the io_uring engine of ``transport.uring``.
"""

from __future__ import annotations

import asyncio
import socket

from pushcdn_tpu_torch.proto.error import Error, ErrorKind, bail
from pushcdn_tpu_torch.proto.limiter import Limiter, NO_LIMIT
from pushcdn_tpu_torch.proto.error import parse_endpoint
from pushcdn_tpu_torch.proto.transport.base import (
    CONNECT_TIMEOUT_S,
    AsyncioStream,
    Connection,
    Listener,
    Protocol,
    UnfinalizedConnection,
)


def _set_nodelay(writer: asyncio.StreamWriter) -> None:
    sock = writer.get_extra_info("socket")
    if sock is not None:
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass


class _TcpUnfinalized(UnfinalizedConnection):
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._reader, self._writer = reader, writer

    async def finalize(self, limiter: Limiter = NO_LIMIT) -> Connection:
        _set_nodelay(self._writer)
        return Connection(AsyncioStream(self._reader, self._writer), limiter,
                          label="tcp")


class TcpListener(Listener):
    def __init__(self):
        self._accept_q: "asyncio.Queue" = asyncio.Queue()
        self._server: asyncio.AbstractServer = None
        self._closed = False
        self.bound_port: int = 0

    async def _on_client(self, reader, writer):
        await self._accept_q.put(_TcpUnfinalized(reader, writer))

    async def accept(self) -> UnfinalizedConnection:
        if self._closed:
            bail(ErrorKind.CONNECTION, "listener closed")
        item = await self._accept_q.get()
        if item is None:  # close() sentinel
            bail(ErrorKind.CONNECTION, "listener closed")
        return item

    async def close(self) -> None:
        self._closed = True
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self._accept_q.put_nowait(None)  # wake any blocked accept()


def _uring_selected() -> bool:
    """True when the resolved io impl is the io_uring data plane. Imported
    lazily so the asyncio-only path never touches the native shim."""
    import os
    if os.environ.get("PUSHCDN_IO_IMPL", "") == "" \
            and os.environ.get("PUSHCDN_IO_URING", "") == "":
        return False  # default impl: skip the probe entirely
    from pushcdn_tpu_torch.proto.transport import uring as uring_mod
    return uring_mod.resolve_io_impl() == "uring"


class Tcp(Protocol):
    name = "tcp"

    @classmethod
    async def connect(cls, endpoint: str, use_local_authority: bool = True,
                      limiter: Limiter = NO_LIMIT) -> Connection:
        host, port = parse_endpoint(endpoint)
        if _uring_selected():
            from pushcdn_tpu_torch.proto.transport import uring as uring_mod
            try:
                async with asyncio.timeout(CONNECT_TIMEOUT_S):
                    return await uring_mod.uring_connect(
                        host, port, limiter, label=f"tcp:{endpoint}")
            except (OSError, asyncio.TimeoutError) as exc:
                bail(ErrorKind.CONNECTION,
                     f"tcp connect to {endpoint} failed", exc)
        try:
            async with asyncio.timeout(CONNECT_TIMEOUT_S):
                reader, writer = await asyncio.open_connection(host, port)
        except (OSError, asyncio.TimeoutError) as exc:
            bail(ErrorKind.CONNECTION, f"tcp connect to {endpoint} failed", exc)
        _set_nodelay(writer)
        return Connection(AsyncioStream(reader, writer), limiter,
                          label=f"tcp:{endpoint}")

    @classmethod
    async def bind(cls, endpoint: str, certificate=None,
                   reuse_port: bool = False) -> Listener:
        host, port = parse_endpoint(endpoint)
        if _uring_selected():
            from pushcdn_tpu_torch.proto.transport import uring as uring_mod
            try:
                return uring_mod.uring_bind(host, port,
                                            reuse_port=reuse_port)
            except OSError as exc:
                bail(ErrorKind.CONNECTION,
                     f"tcp bind to {endpoint} failed", exc)
        listener = TcpListener()
        try:
            server = await asyncio.start_server(
                listener._on_client, host, port,
                **({"reuse_port": True} if reuse_port else {}))
        except (OSError, ValueError) as exc:
            bail(ErrorKind.CONNECTION, f"tcp bind to {endpoint} failed", exc)
        listener._server = server
        listener.bound_port = server.sockets[0].getsockname()[1]
        return listener
