"""Run configuration: explicit wiring of scheme × transport × discovery ×
topic space × message hooks.

Capability parity with cdn-proto/src/def.rs:31-168. The reference does this
with compile-time trait generics (``RunDef``/``ConnectionDef``) and cargo
features; here it is plain config objects — everything the reference selects
at compile time is selected by constructing one of these (SURVEY.md §7:
"everything it does with trait generics becomes a small typed registry").
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Optional, Type

from pushcdn_tpu_torch.proto.crypto.signature import DEFAULT_SCHEME, SignatureScheme
from pushcdn_tpu_torch.proto.discovery.base import DiscoveryClient
from pushcdn_tpu_torch.proto.discovery.embedded import Embedded
from pushcdn_tpu_torch.proto.discovery.redis import Redis
from pushcdn_tpu_torch.proto.message import Message
from pushcdn_tpu_torch.proto.topic import TEST_TOPIC_SPACE, TopicSpace
from pushcdn_tpu_torch.proto.transport.base import Protocol
from pushcdn_tpu_torch.proto.transport.memory import Memory
from pushcdn_tpu_torch.proto.transport.tcp import Tcp
from pushcdn_tpu_torch.proto.transport.tcp_tls import TcpTls


class HookResult(enum.Enum):
    """What a message hook decided (parity ``HookResult``, def.rs:70-97)."""

    PROCESS = "process"        # route normally
    SKIP = "skip"              # drop silently
    DISCONNECT = "disconnect"  # drop and kick the sender


# hook(sender_id, message) -> HookResult; sender_id is the user public key
# or broker identity string (parity MessageHookDef's identifier).
MessageHook = Callable[[object, Message], HookResult]


def no_hook(_sender, _message) -> HookResult:
    return HookResult.PROCESS


@dataclass
class ConnectionDef:
    """One edge's wiring: transport × signature scheme × hook
    (parity def.rs:62-66)."""

    protocol: Type[Protocol]
    scheme: Type[SignatureScheme] = DEFAULT_SCHEME
    hook: MessageHook = no_hook


@dataclass
class RunDef:
    """A full deployment definition (parity def.rs:54-59): how brokers talk
    to each other, how users talk to brokers, which discovery store, which
    topic space, and feature flags that were cargo features in the
    reference."""

    broker_def: ConnectionDef
    user_def: ConnectionDef
    discovery: Type[DiscoveryClient]
    topics: TopicSpace = field(default_factory=lambda: TEST_TOPIC_SPACE)
    # reference cargo features, now runtime flags:
    global_permits: bool = False        # permits valid at any broker
    strong_consistency: bool = True     # push syncs immediately on user join
                                        # (broker default feature)


def production_run_def(topics: Optional[TopicSpace] = None) -> RunDef:
    """Parity ``ProductionRunDef`` (def.rs:101-136): BLS-over-BN254 keys,
    broker↔broker plain TCP, user↔broker TCP+TLS, Redis/KeyDB discovery.
    Falls back to Ed25519 if the native BLS library can't compile on this
    host (the seam keeps callers agnostic)."""
    from pushcdn_tpu_torch.proto.crypto.signature import BlsBn254Scheme
    scheme = BlsBn254Scheme if BlsBn254Scheme.available() else DEFAULT_SCHEME
    return RunDef(
        broker_def=ConnectionDef(protocol=Tcp, scheme=scheme),
        user_def=ConnectionDef(protocol=TcpTls, scheme=scheme),
        discovery=Redis,
        topics=topics or TopicSpace.range(256),
    )


def testing_run_def(broker_protocol: Type[Protocol] = Memory,
                    user_protocol: Type[Protocol] = Memory,
                    topics: Optional[TopicSpace] = None,
                    scheme: Type[SignatureScheme] = DEFAULT_SCHEME) -> RunDef:
    """Parity ``TestingRunDef<B,U>`` (def.rs:140-159): generic transports +
    Embedded (SQLite) discovery."""
    return RunDef(
        broker_def=ConnectionDef(protocol=broker_protocol, scheme=scheme),
        user_def=ConnectionDef(protocol=user_protocol, scheme=scheme),
        discovery=Embedded,
        topics=topics or TEST_TOPIC_SPACE,
    )
