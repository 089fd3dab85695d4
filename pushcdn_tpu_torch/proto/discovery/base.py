"""Discovery interface + broker identity.

Capability parity with cdn-proto/src/discovery/mod.rs:28-129:

- ``DiscoveryClient``: new / perform_heartbeat / get_with_least_connections
  / get_other_brokers / issue_permit / validate_permit / set_whitelist /
  check_whitelist.
- ``BrokerIdentifier`` = {public_advertise_endpoint,
  private_advertise_endpoint}, string-encoded ``"pub/priv"`` and **totally
  ordered** so it can double as the CRDT conflict identity.

TPU-native note (SURVEY.md §2e): on a TPU pod the broker *mesh* topology is
static — ``get_other_brokers`` for device-resident broker shards is answered
from mesh coordinates (pushcdn_tpu_torch.parallel.mesh) rather than a registry;
the registry remains the durable store for permits + whitelist and for
host-level (multi-pod / edge) membership.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import List, Optional

from pushcdn_tpu_torch.proto.error import ErrorKind, bail


# Permit value space: 0 = failure, 1 = bare ack, real permits are drawn
# from randbits(62) + 2 by every issuer (embedded + redis). The wire
# field is a u64, so validators MUST range-check before touching storage
# — SQLite INTEGER is signed 64-bit and a hostile permit >= 2^63 would
# otherwise surface as OverflowError instead of a clean rejection
# (found by tests/test_fuzz_auth.py).
PERMIT_MIN = 2
PERMIT_MAX = (1 << 62) + 1


def permit_in_range(permit: int) -> bool:
    return PERMIT_MIN <= permit <= PERMIT_MAX



@dataclass(frozen=True, order=True)
class BrokerIdentifier:
    """Identity = the two endpoints a broker advertises.

    ``public_advertise_endpoint`` is for users, ``private_advertise_endpoint``
    for peer brokers. The derived total order (lexicographic over the pair)
    is load-bearing: it is the CRDT conflict tie-breaker AND the pairwise
    dial-dedup rule (only dial peers ≥ self, heartbeat.rs:69-73).
    """

    public_advertise_endpoint: str
    private_advertise_endpoint: str

    def __str__(self) -> str:
        return f"{self.public_advertise_endpoint}/{self.private_advertise_endpoint}"

    @classmethod
    def from_string(cls, s: str) -> "BrokerIdentifier":
        pub, sep, priv = s.partition("/")
        if not sep:
            bail(ErrorKind.PARSE, f"malformed broker identifier {s!r}")
        return cls(pub, priv)


class DiscoveryClient(abc.ABC):
    """The membership/permits/whitelist store interface (discovery/mod.rs:28-76).

    Implementations: :class:`~pushcdn_tpu_torch.proto.discovery.embedded.Embedded`
    (SQLite; local/testing) and
    :class:`~pushcdn_tpu_torch.proto.discovery.redis.Redis` (KeyDB; production,
    gated on a redis client being available).
    """

    @classmethod
    @abc.abstractmethod
    async def new(cls, endpoint: str,
                  identity: Optional[BrokerIdentifier] = None) -> "DiscoveryClient":
        """Connect to the store at ``endpoint``; brokers pass their identity,
        marshals/clients pass None."""

    @abc.abstractmethod
    async def perform_heartbeat(self, num_connections: int,
                                heartbeat_expiry_s: float) -> None:
        """Publish liveness + load; membership ages out after the expiry
        (60 s TTL in the reference, heartbeat.rs:37-50)."""

    async def deregister(self) -> None:
        """Remove this broker's membership row immediately (ISSUE 12 drain):
        a draining broker must leave placement rotation NOW, not after its
        heartbeat TTL ages out. Permits/whitelist are untouched — the row
        would re-appear on the next heartbeat, so drainers also stop
        heartbeating. Default: no-op for identity-less clients."""

    @abc.abstractmethod
    async def get_other_brokers(self) -> List[BrokerIdentifier]:
        """All live brokers except self."""

    @abc.abstractmethod
    async def get_with_least_connections(self) -> BrokerIdentifier:
        """The least-loaded live broker; load = connections + outstanding
        permits (redis.rs:139-167)."""

    @abc.abstractmethod
    async def issue_permit(self, for_broker: BrokerIdentifier,
                           expiry_s: float, public_key: bytes) -> int:
        """Create a single-use permit (>1) bound to ``for_broker`` with a
        TTL (30 s in the reference, auth/marshal.rs:121-135)."""

    async def validate_permit(self, broker: BrokerIdentifier,
                              permit: int) -> Optional[bytes]:
        """Redeem-and-delete (GETDEL semantics): returns the public key the
        permit was issued to, or None if invalid/expired/foreign.

        Template method: the range check runs HERE so no backend can skip
        it — an out-of-space wire permit must never reach storage (see
        ``permit_in_range``). Backends implement ``_validate_permit``."""
        if not permit_in_range(permit):
            return None
        return await self._validate_permit(broker, permit)

    @abc.abstractmethod
    async def _validate_permit(self, broker: BrokerIdentifier,
                               permit: int) -> Optional[bytes]:
        ...

    @abc.abstractmethod
    async def set_whitelist(self, users: List[bytes]) -> None: ...

    # -- user-slot directory (multi-host device planes) --------------------
    # The single-host mesh group keeps pk -> device-slot in process memory;
    # across hosts the mapping must rendezvous somewhere, and discovery is
    # already the cross-host registry (the reference moves the same facts in
    # its UserSync gossip, cdn-broker/src/tasks/broker/sync.rs). Backends
    # without a directory inherit the empty default: remote directs then
    # fall back to the host path.

    async def publish_user_slots(self, entries, ttl_s: float) -> None:
        """Publish this host's ``{public_key: slot}`` claims with a TTL;
        re-published every directory refresh (heartbeat-style)."""

    async def get_user_slots(self):
        """Return ``{public_key: (slot, published_ts)}`` for every live
        claim. Default: no directory."""
        return {}

    async def drop_user_slots(self, keys: List[bytes]) -> None:
        """Remove claims for departed users."""


    @abc.abstractmethod
    async def check_whitelist(self, user: bytes) -> bool:
        """True if ``user`` may connect; an EMPTY whitelist admits everyone
        (matching the reference's default-open posture for local runs)."""

    async def close(self) -> None:  # optional override
        return None
