"""Redis/KeyDB discovery: the production membership store.

Capability parity with cdn-proto/src/discovery/redis.rs:38-327: atomic
heartbeat pipeline (set-membership + per-member expiry + load value),
least-connections scan including outstanding permit counts, GETDEL permit
redemption, whitelist set.

Gated: this environment ships no redis client library (and installing is
disallowed), so the import is lazy — ``Redis.new`` raises a clear error
when the ``redis`` package is missing, and the implementation below runs
unmodified once it is present. Note the reference actually requires KeyDB
(for ``EXPIREMEMBER``, redis.rs:94); we instead store one key per broker
with a plain TTL, which works on stock Redis as well.

Keys:
    broker:{identifier}      -> num_connections     (TTL = heartbeat expiry)
    permit:{permit}          -> broker|public_key   (TTL = permit expiry)
    whitelist                -> set of public keys
"""

from __future__ import annotations

import secrets
from typing import List, Optional

from pushcdn_tpu_torch.proto.discovery.base import BrokerIdentifier, DiscoveryClient
from pushcdn_tpu_torch.proto.error import ErrorKind, bail

_PREFIX_BROKER = "broker:"
_PREFIX_PERMIT = "permit:"
_KEY_WHITELIST = "whitelist"
_PREFIX_USLOT = "uslot:"


class Redis(DiscoveryClient):
    def __init__(self, client, identity: Optional[BrokerIdentifier],
                 global_permits: bool = False):
        self._client = client
        self.identity = identity
        self.global_permits = global_permits

    @classmethod
    async def new(cls, endpoint: str,
                  identity: Optional[BrokerIdentifier] = None,
                  global_permits: bool = False) -> "Redis":
        try:
            import redis.asyncio as aioredis  # lazy: not in this image
        except ImportError as exc:
            bail(ErrorKind.CONNECTION,
                 "the 'redis' package is not available in this environment; "
                 "use Embedded (SQLite) discovery instead", exc)
        client = aioredis.from_url(endpoint, decode_responses=False)
        return cls(client, identity, global_permits)

    async def perform_heartbeat(self, num_connections: int,
                                heartbeat_expiry_s: float) -> None:
        if self.identity is None:
            bail(ErrorKind.PARSE, "heartbeat requires a broker identity")
        # atomic pipeline (parity redis.rs:86-112)
        pipe = self._client.pipeline(transaction=True)
        pipe.set(f"{_PREFIX_BROKER}{self.identity}", num_connections,
                 ex=int(heartbeat_expiry_s))
        await pipe.execute()

    async def deregister(self) -> None:
        if self.identity is None:
            return
        await self._client.delete(f"{_PREFIX_BROKER}{self.identity}")

    async def get_other_brokers(self) -> List[BrokerIdentifier]:
        me = f"{_PREFIX_BROKER}{self.identity}" if self.identity else None
        out = []
        async for key in self._client.scan_iter(match=f"{_PREFIX_BROKER}*"):
            k = key.decode() if isinstance(key, bytes) else key
            if k != me:
                out.append(BrokerIdentifier.from_string(k[len(_PREFIX_BROKER):]))
        return out

    async def get_with_least_connections(self) -> BrokerIdentifier:
        best, best_load = None, None
        async for key in self._client.scan_iter(match=f"{_PREFIX_BROKER}*"):
            k = key.decode() if isinstance(key, bytes) else key
            ident = k[len(_PREFIX_BROKER):]
            raw = await self._client.get(key)
            conns = int(raw or 0)
            # outstanding permits count toward load (redis.rs:139-167)
            permits = 0
            async for pkey in self._client.scan_iter(match=f"{_PREFIX_PERMIT}*"):
                val = await self._client.get(pkey)
                if val is not None and val.split(b"|", 1)[0].decode() == ident:
                    permits += 1
            load = conns + permits
            if best_load is None or (load, ident) < (best_load, best):
                best, best_load = ident, load
        if best is None:
            bail(ErrorKind.CONNECTION, "no live brokers in discovery")
        return BrokerIdentifier.from_string(best)

    async def issue_permit(self, for_broker: BrokerIdentifier,
                           expiry_s: float, public_key: bytes) -> int:
        while True:
            permit = secrets.randbits(62) + 2
            ok = await self._client.set(
                f"{_PREFIX_PERMIT}{permit}",
                str(for_broker).encode() + b"|" + bytes(public_key),
                ex=int(expiry_s), nx=True)
            if ok:
                return permit

    async def _validate_permit(self, broker: BrokerIdentifier,
                               permit: int) -> Optional[bytes]:
        # range-checked by the base-class template method
        raw = await self._client.getdel(f"{_PREFIX_PERMIT}{permit}")
        if raw is None:
            return None
        issued_for, _, public_key = raw.partition(b"|")
        if not self.global_permits and issued_for.decode() != str(broker):
            return None
        return bytes(public_key)

    async def set_whitelist(self, users: List[bytes]) -> None:
        pipe = self._client.pipeline(transaction=True)
        pipe.delete(_KEY_WHITELIST)
        if users:
            pipe.sadd(_KEY_WHITELIST, *[bytes(u) for u in users])
        await pipe.execute()

    async def check_whitelist(self, user: bytes) -> bool:
        if await self._client.scard(_KEY_WHITELIST) == 0:
            return True
        return bool(await self._client.sismember(_KEY_WHITELIST, bytes(user)))

    # -- user-slot directory (multi-host device planes) ---------------------

    async def publish_user_slots(self, entries, ttl_s: float) -> None:
        # newest claim wins (read-compare-write; the tiny race window is
        # closed by the next refresh, since the loser's claim ts never
        # grows while the winner's republication carries the newer one)
        names = {f"{_PREFIX_USLOT}{bytes(pk).hex()}": (pk, v)
                 for pk, v in entries.items()}
        current = await self._client.mget(list(names)) if names else []
        pipe = self._client.pipeline(transaction=True)
        for (key, (pk, (slot, ts))), raw in zip(names.items(), current):
            if raw is not None:
                v = raw.decode() if isinstance(raw, bytes) else raw
                if float(v.split(":", 1)[1]) > float(ts):
                    continue  # a newer claim exists elsewhere
            pipe.set(key, f"{int(slot)}:{float(ts)}", ex=max(1, int(ttl_s)))
        await pipe.execute()

    async def get_user_slots(self):
        names = []
        async for key in self._client.scan_iter(match=f"{_PREFIX_USLOT}*"):
            names.append(key.decode() if isinstance(key, bytes) else key)
        if not names:
            return {}
        out = {}
        # one MGET for the lot: the directory refresh runs on every host
        # every ~0.5 s, so per-key round trips would dominate Redis load
        values = await self._client.mget(names)
        for k, raw in zip(names, values):
            if raw is None:
                continue
            v = raw.decode() if isinstance(raw, bytes) else raw
            slot_s, ts_s = v.split(":", 1)
            out[bytes.fromhex(k[len(_PREFIX_USLOT):])] = (int(slot_s),
                                                          float(ts_s))
        return out

    async def drop_user_slots(self, keys) -> None:
        if keys:
            await self._client.delete(
                *(f"{_PREFIX_USLOT}{bytes(k).hex()}" for k in keys))

    async def close(self) -> None:
        await self._client.aclose()
