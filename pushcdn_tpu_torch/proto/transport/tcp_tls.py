"""TLS-over-TCP transport (the production user-facing edge).

Capability parity with cdn-proto/src/connection/protocols/tcp_tls.rs:44-254:
server presents a leaf cert derived from the local (or production) CA with
SAN ``pushcdn``; clients verify against that CA; no mutual TLS (user
authentication is the signed-timestamp handshake at L4, not client certs).

The port's copy of ``pushcdn_tpu.proto.transport.tcp_tls``. TLS runs on
the asyncio engine whatever ``PUSHCDN_IO_IMPL`` says, and says so once.
"""

from __future__ import annotations

import asyncio
import socket
import ssl

from pushcdn_tpu_torch.proto.crypto.tls import (
    Certificate,
    client_context_for,
    local_certificate,
)
from pushcdn_tpu_torch.proto.error import ErrorKind, bail, parse_endpoint
from pushcdn_tpu_torch.proto.limiter import Limiter, NO_LIMIT
from pushcdn_tpu_torch.proto.transport.base import (
    CONNECT_TIMEOUT_S,
    AsyncioStream,
    Connection,
    Listener,
    Protocol,
    UnfinalizedConnection,
)


class _TlsUnfinalized(UnfinalizedConnection):
    def __init__(self, reader, writer):
        self._reader, self._writer = reader, writer

    async def finalize(self, limiter: Limiter = NO_LIMIT) -> Connection:
        # TLS handshake already completed by asyncio's start_server(ssl=...);
        # the accept loop stays cheap because asyncio performs the handshake
        # before invoking the client callback.
        sock = self._writer.get_extra_info("socket")
        if sock is not None:
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
        return Connection(AsyncioStream(self._reader, self._writer), limiter,
                          label="tcp+tls")


class TcpTlsListener(Listener):
    def __init__(self):
        self._accept_q: "asyncio.Queue" = asyncio.Queue()
        self._server: asyncio.AbstractServer = None
        self._closed = False
        self.bound_port: int = 0

    async def _on_client(self, reader, writer):
        await self._accept_q.put(_TlsUnfinalized(reader, writer))

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


def _note_io_impl() -> None:
    """TLS always runs on the asyncio stream pair (Python's ssl module owns
    the record layer, so there is no plaintext fd for io_uring to drive).
    When the process selected the uring data plane, log the fallback ONCE
    instead of silently ignoring the knob — honest labeling over silence."""
    import os
    if os.environ.get("PUSHCDN_IO_IMPL") or os.environ.get("PUSHCDN_IO_URING"):
        from pushcdn_tpu_torch.proto.transport import uring as uring_mod
        uring_mod.warn_tls_fallback_once()


class TcpTls(Protocol):
    name = "tcp+tls"

    @classmethod
    async def connect(cls, endpoint: str, use_local_authority: bool = True,
                      limiter: Limiter = NO_LIMIT) -> Connection:
        _note_io_impl()
        host, port = parse_endpoint(endpoint)
        ctx, server_hostname = client_context_for(use_local_authority, host)
        try:
            async with asyncio.timeout(CONNECT_TIMEOUT_S):
                reader, writer = await asyncio.open_connection(
                    host, port, ssl=ctx, server_hostname=server_hostname)
        except (OSError, ssl.SSLError, asyncio.TimeoutError) as exc:
            bail(ErrorKind.CONNECTION, f"tls connect to {endpoint} failed", exc)
        return Connection(AsyncioStream(reader, writer), limiter,
                          label=f"tcp+tls:{endpoint}")

    @classmethod
    async def bind(cls, endpoint: str,
                   certificate: "Certificate | None" = None,
                   reuse_port: bool = False) -> Listener:
        _note_io_impl()
        host, port = parse_endpoint(endpoint)
        if certificate is None:
            certificate = local_certificate()
        listener = TcpTlsListener()
        try:
            server = await asyncio.start_server(
                listener._on_client, host, port,
                ssl=certificate.server_context(),
                **({"reuse_port": True} if reuse_port else {}))
        except (OSError, ssl.SSLError, ValueError) as exc:
            bail(ErrorKind.CONNECTION, f"tls bind to {endpoint} failed", exc)
        listener._server = server
        listener.bound_port = server.sockets[0].getsockname()[1]
        return listener
