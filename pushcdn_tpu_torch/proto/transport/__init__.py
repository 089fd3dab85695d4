"""Transport protocols (reference layer L0).

Every transport reduces to an async byte-stream pair behind the uniform
:class:`~pushcdn_tpu_torch.proto.transport.base.Connection` handle (parity
cdn-proto/src/connection/protocols/mod.rs:85-306). Implementations:

- ``memory`` — in-process duplex streams behind a global registry (test
  infra; parity protocols/memory.rs)
- ``tcp`` — plain TCP with TCP_NODELAY (parity protocols/tcp.rs)
- ``tcp_tls`` — TLS over TCP with the local/prod CA scheme (parity
  protocols/tcp_tls.rs)
- ``quic`` — QUIC-class reliable stream over UDP: handshake, single
  bootstrapped bidirectional stream, ACK/retransmit loss recovery, 5 s
  keep-alive, 3 s graceful finish (parity protocols/quic.rs)

``tcp`` runs on the asyncio engine or, with ``PUSHCDN_IO_IMPL=uring`` (or
``auto`` where the kernel allows it), on the io_uring engine of
``uring``; the fused native pump of ``pump`` rides that engine.

The device data plane's inter-broker "transport" is NOT one of these: broker
↔ broker fan-out on the device is a collective between shards (see
pushcdn_tpu_torch.parallel) while these host transports carry the user edge.
"""

from pushcdn_tpu_torch.proto.transport.base import (  # noqa: F401
    Connection,
    Listener,
    Protocol,
    UnfinalizedConnection,
)
from pushcdn_tpu_torch.proto.transport.memory import Memory  # noqa: F401
from pushcdn_tpu_torch.proto.transport.quic import Quic  # noqa: F401
from pushcdn_tpu_torch.proto.transport.tcp import Tcp  # noqa: F401
from pushcdn_tpu_torch.proto.transport.tcp_tls import TcpTls  # noqa: F401
