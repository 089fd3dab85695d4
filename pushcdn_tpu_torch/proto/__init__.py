"""Shared protocol layer: wire format, the memory transport, limiter,
crypto, broker auth, discovery, config registry.

A copy of ``pushcdn_tpu.proto`` cut to the single-broker data path over
the Memory transport; the TCP, TLS, QUIC and io_uring transports, user
and marshal auth, and Redis discovery are not copied yet.
"""

MAX_MESSAGE_SIZE = (2**32 - 1) // 8
"""Maximum wire message size in bytes (512 MiB-ish).

Parity: reference caps messages at ``u32::MAX / 8``
(cdn-proto/src/lib.rs:23-25).
"""
