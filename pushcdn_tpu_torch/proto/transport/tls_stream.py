"""TLS 1.3 over any :class:`RawStream` via ``ssl.MemoryBIO``.

Real QUIC runs the TLS 1.3 handshake over its reliable crypto streams
(RFC 9001); the QUIC-class transport mirrors that: the userspace ARQ
provides the reliable ordered byte stream, and this wrapper runs the
actual TLS state machine on top, reusing the same CA/leaf plumbing as
the TcpTls edge (parity with the reference's quinn configuration,
cdn-proto/src/connection/protocols/quic.rs:37-146, where rustls secures
the stream against the pinned CA).

The wrapper is transport-generic: anything exposing ``RawStream``
(read_some/write/close/abort) can be secured with it.
"""

from __future__ import annotations

import asyncio
import ssl
from typing import Optional

from pushcdn_tpu_torch.proto.transport.base import RawStream

_CHUNK = 256 * 1024


class TlsStream(RawStream):
    """A ``RawStream`` carrying TLS records over an inner ``RawStream``."""

    def __init__(self, inner: RawStream, ssl_object: ssl.SSLObject,
                 incoming: ssl.MemoryBIO, outgoing: ssl.MemoryBIO):
        self._inner = inner
        self._obj = ssl_object
        self._incoming = incoming
        self._outgoing = outgoing
        # Serializes ciphertext egress: the reader task can emit records
        # too (KeyUpdate replies), and an inner.write blocked on transport
        # backpressure must not interleave with another task's bytes
        # mid-record.
        self._pump_lock = asyncio.Lock()

    # -- construction --------------------------------------------------------

    @classmethod
    async def wrap_client(cls, inner: RawStream, context: ssl.SSLContext,
                          server_hostname: str) -> "TlsStream":
        incoming, outgoing = ssl.MemoryBIO(), ssl.MemoryBIO()
        obj = context.wrap_bio(incoming, outgoing, server_side=False,
                               server_hostname=server_hostname)
        self = cls(inner, obj, incoming, outgoing)
        await self._handshake()
        return self

    @classmethod
    async def wrap_server(cls, inner: RawStream,
                          context: ssl.SSLContext) -> "TlsStream":
        incoming, outgoing = ssl.MemoryBIO(), ssl.MemoryBIO()
        obj = context.wrap_bio(incoming, outgoing, server_side=True)
        self = cls(inner, obj, incoming, outgoing)
        await self._handshake()
        return self

    async def _handshake(self) -> None:
        while True:
            try:
                self._obj.do_handshake()
                await self._pump_out()
                return
            except ssl.SSLWantReadError:
                await self._pump_out()
                chunk = await self._inner.read_some(_CHUNK)
                self._incoming.write(chunk)
            except ssl.SSLWantWriteError:  # pragma: no cover - MemoryBIO
                await self._pump_out()     # is unbounded; defensive only

    async def _pump_out(self) -> None:
        async with self._pump_lock:
            data = self._outgoing.read()
            if data:
                await self._inner.write(data)

    # -- RawStream interface -------------------------------------------------

    async def read_some(self, max_n: int) -> bytes:
        out = bytearray()
        while True:
            # drain every decrypted record available up to max_n in one
            # call — SSLObject.read is one SSL_read (<= one ~16 KiB
            # record), and returning per-record would defeat the
            # Connection reader's bulk-chunk batch parsing
            try:
                while len(out) < max_n:
                    data = self._obj.read(max_n - len(out))
                    if not data:
                        break
                    out += data
            except ssl.SSLWantReadError:
                pass
            except ssl.SSLZeroReturnError:
                # clean TLS close_notify from the peer
                if out:
                    return bytes(out)
                raise asyncio.IncompleteReadError(b"", 1)
            # OpenSSL can queue records while reading (e.g. the mandatory
            # reply to a peer KeyUpdate, RFC 8446 §4.6.3); a read-mostly
            # connection must still transmit them
            if self._outgoing.pending:
                await self._pump_out()
            if out:
                return bytes(out)
            # ARQ-level EOF propagates as IncompleteReadError from the
            # inner read — exactly what Connection's reader expects
            chunk = await self._inner.read_some(_CHUNK)
            self._incoming.write(chunk)

    async def read_exactly(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            buf += await self.read_some(n - len(buf))
        return bytes(buf)

    async def write(self, data) -> None:
        # SSLObject.write takes any buffer-protocol object and the writer
        # loop awaits this flush before reusing its buffer — no copy needed
        view = memoryview(data)
        total = len(view)
        written = 0
        while written < total:
            # SSLObject.write fragments into <=16 KiB records in the BIO;
            # bound each burst so the ciphertext pump interleaves with
            # encryption instead of buffering the whole payload
            n = self._obj.write(view[written:written + _CHUNK])
            written += n
            await self._pump_out()

    async def close(self) -> None:
        try:
            self._obj.unwrap()  # queue close_notify
        except (ssl.SSLWantReadError, ssl.SSLError, OSError):
            pass
        try:
            await self._pump_out()
        except Exception:
            pass
        await self._inner.close()

    def abort(self) -> None:
        self._inner.abort()
