"""Shared protocol layer: wire format, the memory transport, limiter,
crypto, broker auth, discovery, config registry.

The port's copy of ``pushcdn_tpu.proto``: the wire format, the Memory,
TCP, TCP+TLS and QUIC transports, the io_uring engine and the fused
native pump, user and marshal auth with Ed25519 or BLS-over-BN254 keys
and the batching verifier, the embedded (SQLite) and Redis discovery
stores.
"""

MAX_MESSAGE_SIZE = (2**32 - 1) // 8
"""Maximum wire message size in bytes (512 MiB-ish).

Parity: reference caps messages at ``u32::MAX / 8``
(cdn-proto/src/lib.rs:23-25).
"""
