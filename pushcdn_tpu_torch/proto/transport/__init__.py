"""Transport protocols (reference layer L0).

Every transport reduces to an async byte-stream pair behind the uniform
:class:`~pushcdn_tpu_torch.proto.transport.base.Connection` handle (parity
cdn-proto/src/connection/protocols/mod.rs:85-306). Implementations:

- ``memory`` — in-process duplex streams behind a global registry (test
  infra; parity protocols/memory.rs)

The TCP, TCP+TLS, QUIC and io_uring transports of ``pushcdn_tpu.proto
.transport`` are not copied yet.

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
