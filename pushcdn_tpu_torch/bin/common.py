"""Shared CLI plumbing: logging init (JSON opt-in via env, parity with the
reference's RUST_LOG_FORMAT=json switch, cdn-broker/src/binaries/broker.rs:80-91),
transport/scheme lookup by name, seeded keys.

The port's copy of ``pushcdn_tpu.bin.common``: the transports are
``memory``, ``tcp``, ``tcp+tls`` and ``quic``, the schemes ``ed25519`` and
``bls-bn254``, and discovery is Redis for a ``redis://`` endpoint and the
embedded SQLite file otherwise. ``--io-impl`` and ``--pump`` select the
io_uring engine and the fused native pump as the reference's flags do.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal as signal_mod
import sys
from typing import Optional, Type

from pushcdn_tpu_torch.proto.crypto.signature import (
    BlsBn254Scheme,
    Ed25519Scheme,
    KeyPair,
    SignatureScheme,
)
from pushcdn_tpu_torch.proto.def_ import RunDef, ConnectionDef
from pushcdn_tpu_torch.proto.discovery.embedded import Embedded
from pushcdn_tpu_torch.proto.discovery.redis import Redis
from pushcdn_tpu_torch.proto.topic import TopicSpace
from pushcdn_tpu_torch.proto.transport import Memory, Tcp, TcpTls
from pushcdn_tpu_torch.proto.transport.base import Protocol
from pushcdn_tpu_torch.proto.transport.quic import Quic

TRANSPORTS = {"tcp": Tcp, "tcp+tls": TcpTls, "quic": Quic, "memory": Memory}
SCHEMES = {"ed25519": Ed25519Scheme, "bls-bn254": BlsBn254Scheme}


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        return json.dumps({
            "ts": self.formatTime(record),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        })


def tune_gc(threshold0: int = 50_000) -> None:
    """Server-style GC tuning for the message hot path: the router
    allocates ~20 small objects per delivery, and CPython's default gen-0
    threshold (700) turns that into thousands of collections per second —
    with the periodic gen-2 passes scanning the whole (torch-sized) heap.
    Raise the thresholds and freeze the post-startup heap so steady-state
    collections only walk the young, message-sized garbage. Call once
    after bootstrap (binaries and benches do)."""
    import gc
    gc.collect()
    gc.freeze()
    gc.set_threshold(threshold0, 50, 100)


def init_logging(verbosity: int = 0) -> None:
    """Env-driven log format: ``PUSHCDN_LOG_FORMAT=json`` switches to
    structured JSON lines (reference: RUST_LOG_FORMAT=json)."""
    level = [logging.INFO, logging.DEBUG][min(verbosity, 1)]
    handler = logging.StreamHandler(sys.stderr)
    if os.environ.get("PUSHCDN_LOG_FORMAT") == "json":
        handler.setFormatter(_JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)-5s %(name)s: %(message)s"))
    logging.basicConfig(level=level, handlers=[handler], force=True)


def add_io_impl_flag(p) -> None:
    """The host data-plane selector, shared by every binary: ``auto``
    probes the kernel once and demotes honestly, ``uring`` insists (and
    fails fast when denied), ``asyncio`` is the default this round."""
    from pushcdn_tpu_torch.proto.transport.uring import IO_IMPLS
    p.add_argument("--io-impl", choices=IO_IMPLS, default=None,
                   help="host I/O engine for tcp links: auto (io_uring "
                        "when the kernel allows, else asyncio), uring "
                        "(insist), asyncio (default; also inherited via "
                        "PUSHCDN_IO_IMPL)")


def apply_io_impl(args) -> None:
    """Write the selection into PUSHCDN_IO_IMPL so THIS process and its
    children (shard workers, spawned helpers) resolve the same plane."""
    if getattr(args, "io_impl", None):
        from pushcdn_tpu_torch.proto.transport.uring import set_io_impl
        set_io_impl(args.io_impl)


def add_pump_flag(p) -> None:
    """The fused data-plane pump selector (broker-side):
    ``auto`` engages the native recv→plan→send pump whenever BOTH the
    io_uring engine and the native route planner are live (demoting
    loudly once otherwise), ``off`` disables it unconditionally."""
    p.add_argument("--pump", choices=("auto", "off"), default=None,
                   help="fused native data-plane pump: auto (engage when "
                        "io_uring + the native planner are both live), "
                        "off (always per-chunk Python routing; also "
                        "inherited via PUSHCDN_PUMP)")


def apply_pump(args) -> None:
    """Write the selection into PUSHCDN_PUMP so shard workers inherit
    the same composition decision."""
    if getattr(args, "pump", None):
        from pushcdn_tpu_torch.proto.transport.pump import set_pump_impl
        os.environ["PUSHCDN_PUMP"] = args.pump
        set_pump_impl(args.pump)


def drain_grace_s() -> float:
    """How long a binary keeps serving (with /readyz already 503) between
    receiving SIGINT/SIGTERM and tearing its listeners down —
    ``PUSHCDN_DRAIN_GRACE_S`` seconds, default 0 (immediate)."""
    raw = os.environ.get("PUSHCDN_DRAIN_GRACE_S", "").strip()
    if not raw:
        return 0.0
    try:
        return max(float(raw), 0.0)
    except ValueError:
        return 0.0


def install_drain_signals(event: asyncio.Event, on_signal=None) -> bool:
    """Route SIGINT/SIGTERM to ``event.set()`` instead of
    KeyboardInterrupt, so the server binaries can drain gracefully:
    readiness flips false first, listeners close after the grace window.
    Returns False where signal handlers are unavailable (non-main thread,
    Windows proactor) — callers keep the KeyboardInterrupt fallback.

    ``on_signal`` (optional) runs in the handler alongside the latch —
    the sharded broker's parent uses it to PROPAGATE the drain: readiness
    flips false on every worker shard first (the callback forwards
    SIGTERM), the workers serve out ``PUSHCDN_DRAIN_GRACE_S``, and the
    parent reaps them before its own listeners close."""
    loop = asyncio.get_running_loop()

    def _fire() -> None:
        event.set()
        if on_signal is not None:
            try:
                on_signal()
            except Exception:
                pass

    installed = False
    for sig in (signal_mod.SIGINT, signal_mod.SIGTERM):
        try:
            loop.add_signal_handler(sig, _fire)
            installed = True
        except (NotImplementedError, RuntimeError, ValueError):
            pass
    return installed


def transport_by_name(name: str) -> Type[Protocol]:
    try:
        return TRANSPORTS[name]
    except KeyError:
        raise SystemExit(
            f"unknown transport {name!r}; pick from {sorted(TRANSPORTS)}")


def scheme_by_name(name: str) -> Type[SignatureScheme]:
    try:
        scheme = SCHEMES[name]
    except KeyError:
        raise SystemExit(f"unknown scheme {name!r}; pick from {sorted(SCHEMES)}")
    if scheme is BlsBn254Scheme and not BlsBn254Scheme.available():
        raise SystemExit("bls-bn254 requested but the native BLS library "
                         "failed to compile on this host")
    return scheme


def run_def_from_args(broker_transport: str, user_transport: str,
                      discovery_endpoint: str, num_topics: int,
                      global_permits: bool = False,
                      scheme: str = "ed25519") -> RunDef:
    discovery = Redis if discovery_endpoint.startswith("redis://") else Embedded
    sig = scheme_by_name(scheme)
    return RunDef(
        broker_def=ConnectionDef(protocol=transport_by_name(broker_transport),
                                 scheme=sig),
        user_def=ConnectionDef(protocol=transport_by_name(user_transport),
                               scheme=sig),
        discovery=discovery,
        topics=TopicSpace.range(num_topics),
        global_permits=global_permits,
    )


def keypair_from_seed(seed: Optional[int],
                      scheme: str = "ed25519") -> KeyPair:
    return scheme_by_name(scheme).generate_keypair(seed=seed)


def spawn_binary(name: str, *args: str, env_extra=None, capture=True,
                 log_path=None):
    """Launch ``pushcdn_tpu_torch.bin.<name>`` as a child process with the
    repo prepended to PYTHONPATH (setdefault breaks under any preexisting
    PYTHONPATH, e.g. an accelerator site dir) — the one spawner
    ``chip_smoke.py`` and the binary tests share.

    ``capture=False`` sends the child's output to /dev/null instead of a
    pipe — REQUIRED for spawners that never drain the pipe: a chatty
    child blocks forever once the 64 KiB pipe buffer fills. ``log_path`` redirects
    output to a file instead: the pipe-wedge fix that still preserves
    crash output for postmortems (overrides ``capture``)."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = (repo + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else repo)
    if env_extra:
        env.update(env_extra)
    argv = [sys.executable, "-m", f"pushcdn_tpu_torch.bin.{name}", *args]
    if log_path is not None:
        with open(log_path, "ab") as sink_file:
            return subprocess.Popen(argv, env=env, stdout=sink_file,
                                    stderr=subprocess.STDOUT)
    sink = subprocess.PIPE if capture else subprocess.DEVNULL
    return subprocess.Popen(
        argv, env=env, stdout=sink,
        stderr=subprocess.STDOUT if capture else subprocess.DEVNULL,
        text=capture)
