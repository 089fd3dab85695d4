"""Marshal server: accept, verify, hand out a permit, soft-close.

Capability parity with cdn-marshal/src/lib.rs:80-180 + handlers.rs:19-38:
bind the user-facing listener, accept-loop, and for each connection run
``MarshalAuth::verify_user`` under a 5 s timeout then soft-close. The
marshal is stateless (all state lives in discovery) and horizontally
scalable.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Optional

from pushcdn_tpu_torch.proto import health as health_mod
from pushcdn_tpu_torch.proto import metrics as metrics_mod
from pushcdn_tpu_torch.proto.auth import marshal as marshal_auth
from pushcdn_tpu_torch.proto.crypto.tls import Certificate, generate_cert_from_ca, load_ca
from pushcdn_tpu_torch.proto.def_ import RunDef
from pushcdn_tpu_torch.proto.error import Error
from pushcdn_tpu_torch.proto.limiter import Limiter

logger = logging.getLogger("pushcdn.marshal")


@dataclass
class MarshalConfig:
    """Parity with the marshal Config (cdn-marshal/src/lib.rs:30-76)."""

    run_def: RunDef
    discovery_endpoint: str
    bind_endpoint: str  # default port 1737 in the reference binary
    metrics_bind_endpoint: Optional[str] = None
    ca_cert_path: Optional[str] = None
    ca_key_path: Optional[str] = None
    global_memory_pool_size: int = 1024 * 1024 * 1024
    auth_timeout_s: float = 5.0
    # /readyz discovery check: re-probe the store at most this often
    discovery_probe_ttl_s: float = 5.0


class Marshal:
    def __init__(self, config: MarshalConfig):
        self.config = config
        self.run_def = config.run_def
        self.discovery = None
        self.listener = None
        self.limiter: Limiter = None
        self.certificate: Optional[Certificate] = None
        self._accept_task: Optional[asyncio.Task] = None
        self._metrics_server = None
        # /readyz state: cached discovery probe
        self._discovery_probe: tuple = (False, "not probed yet")
        self._discovery_probe_at: Optional[float] = None
        # amortize concurrent pairing checks under connection storms
        # (no-op pass-through for schemes without verify_batch)
        from pushcdn_tpu_torch.proto.crypto.batch import BatchVerifier
        self.batch_verifier = BatchVerifier(config.run_def.user_def.scheme)

    @classmethod
    async def new(cls, config: MarshalConfig) -> "Marshal":
        self = cls(config)
        self.discovery = await self.run_def.discovery.new(
            config.discovery_endpoint, identity=None,
            global_permits=self.run_def.global_permits)
        ca_cert, ca_key = load_ca(config.ca_cert_path, config.ca_key_path)
        self.certificate = generate_cert_from_ca(ca_cert, ca_key)
        self.limiter = Limiter(global_pool_bytes=config.global_memory_pool_size)
        if config.metrics_bind_endpoint:
            # the marshal is the process doing BLS verifications, so it
            # exports the pk line-table cache counters alongside the core
            # gauges (the hook only PEEKS at an already-loaded library:
            # for non-BLS schemes the native lib never loads and the
            # gauges stay zero — no compile can fire inside /metrics).
            # Endpoint first, listener second: /readyz is probe-able (and
            # false) before the marshal can actually accept.
            metrics_mod.register_bls_pk_cache_metrics()
            self._metrics_server = await metrics_mod.serve_metrics(
                config.metrics_bind_endpoint)
            health_mod.register_readiness("listener", self._check_listener)
            health_mod.register_readiness("discovery", self._check_discovery)
        self.listener = await self.run_def.user_def.protocol.bind(
            config.bind_endpoint, certificate=self.certificate)
        logger.info("marshal listening on %s", config.bind_endpoint)
        return self

    # -- readiness ------------------------------------------------

    def _check_listener(self):
        if self.listener is None:
            return False, "listener not bound yet"
        return True, f"listening on {self.config.bind_endpoint}"

    async def _check_discovery(self):
        now = time.monotonic()
        if (self._discovery_probe_at is not None
                and now - self._discovery_probe_at
                < self.config.discovery_probe_ttl_s):
            return self._discovery_probe
        try:
            async with asyncio.timeout(2.0):
                brokers = await self.discovery.get_other_brokers()
            self._discovery_probe = (
                len(brokers) > 0,
                f"ok ({len(brokers)} brokers registered)" if brokers
                else "no live brokers to hand users to")
        except Exception as exc:
            self._discovery_probe = (False, f"probe failed: {exc!r}")
        self._discovery_probe_at = now
        return self._discovery_probe

    def begin_drain(self, reason: str = "shutdown") -> None:
        """Flip /readyz to 503 before the listener closes."""
        health_mod.set_draining(reason)

    async def start(self) -> None:
        self._accept_task = asyncio.create_task(self._accept_loop(),
                                                name="marshal-accept")

    async def _accept_loop(self) -> None:
        while True:
            unfinalized = await self.listener.accept()
            asyncio.create_task(self._handle_connection(unfinalized))

    async def _handle_connection(self, unfinalized) -> None:
        """Parity handlers.rs:21-37: finalize → verify (5 s) → soft-close."""
        connection = None
        try:
            connection = await unfinalized.finalize(self.limiter)
            async with asyncio.timeout(self.config.auth_timeout_s):
                public_key, permit = await marshal_auth.verify_user(
                    connection, self.discovery,
                    self.run_def.user_def.scheme,
                    verifier=self.batch_verifier)
            await connection.soft_close()
        except (Error, asyncio.TimeoutError) as exc:
            logger.info("marshal auth failed: %r", exc)
            if connection is not None:
                # routine under storms: recorded, not dumped
                connection.flightrec.record("auth-fail", repr(exc))
                connection.close()
        except asyncio.CancelledError:
            if connection is not None:
                connection.close()
            raise

    async def stop(self) -> None:
        if self._metrics_server is not None:
            self.begin_drain("marshal stop")  # before the listener closes
        if self._accept_task is not None:
            self._accept_task.cancel()
            try:
                await self._accept_task
            except (asyncio.CancelledError, Exception):
                pass
        if self.listener is not None:
            await self.listener.close()
        if self.discovery is not None:
            await self.discovery.close()
        if self._metrics_server is not None:
            self._metrics_server.close()
            await self._metrics_server.wait_closed()
            self._metrics_server = None
            for name in ("listener", "discovery"):
                health_mod.unregister(name)
            health_mod.clear_draining()
        logger.info("marshal stopped")
