"""The port's Redis discovery (``pushcdn_tpu_torch.proto.discovery.redis``)
held against ``tests/test_redis_discovery.py``: its eight cases through the
port's own copy of the in-memory fake client (the real ``redis`` package
is not a dependency of the repo), one differential case
that runs the same seeded operation sequence against both packages'
``Redis`` over two fakes and compares them result for result, the
refusal without the package, and the four live-server cases, which skip
where there is no redis-compatible server and client package, as the JAX
package's do."""

import fnmatch
import random

import pytest

from pushcdn_tpu_torch.proto.discovery.base import BrokerIdentifier
from pushcdn_tpu_torch.proto.discovery.redis import Redis
from pushcdn_tpu_torch.proto.error import Error


class FakeRedis:
    """The subset of redis.asyncio the discovery client uses, with a
    manually-advanced clock for TTL behavior."""

    def __init__(self):
        self.kv = {}        # key -> (value_bytes, expires_at | None)
        self.sets = {}      # key -> set[bytes]
        self.now = 0.0

    def advance(self, seconds: float) -> None:
        self.now += seconds

    def _live(self, key):
        ent = self.kv.get(key)
        if ent is None:
            return None
        value, exp = ent
        if exp is not None and self.now >= exp:
            del self.kv[key]
            return None
        return value

    # -- commands ----------------------------------------------------------
    async def set(self, key, value, ex=None, nx=False):
        if nx and self._live(key) is not None:
            return None
        if isinstance(value, int):
            value = str(value).encode()
        elif isinstance(value, str):
            value = value.encode()
        self.kv[key] = (value, self.now + ex if ex is not None else None)
        return True

    async def get(self, key):
        return self._live(key)

    async def getdel(self, key):
        value = self._live(key)
        self.kv.pop(key, None)
        return value

    async def delete(self, *keys):
        for k in keys:
            self.kv.pop(k, None)
            self.sets.pop(k, None)

    async def sadd(self, key, *members):
        self.sets.setdefault(key, set()).update(members)

    async def scard(self, key):
        return len(self.sets.get(key, ()))

    async def sismember(self, key, member):
        return member in self.sets.get(key, set())

    async def mget(self, keys):
        return [self._live(k) for k in keys]

    async def scan_iter(self, match="*"):
        for key in list(self.kv):
            if self._live(key) is not None and fnmatch.fnmatch(key, match):
                yield key

    def pipeline(self, transaction=False):
        return FakePipeline(self)

    async def aclose(self):
        pass


class FakePipeline:
    def __init__(self, fake):
        self.fake = fake
        self.ops = []

    def __getattr__(self, name):
        def queue(*args, **kwargs):
            self.ops.append((name, args, kwargs))
            return self
        return queue

    async def execute(self):
        out = []
        for name, args, kwargs in self.ops:
            out.append(await getattr(self.fake, name)(*args, **kwargs))
        return out


B1 = BrokerIdentifier("b1-pub", "b1-priv")
B2 = BrokerIdentifier("b2-pub", "b2-priv")


def make(fake, ident, global_permits=False):
    return Redis(fake, ident, global_permits=global_permits)


async def test_heartbeat_membership_and_ttl():
    fake = FakeRedis()
    r1, r2 = make(fake, B1), make(fake, B2)
    await r1.perform_heartbeat(3, heartbeat_expiry_s=60)
    await r2.perform_heartbeat(5, heartbeat_expiry_s=60)
    others = await r1.get_other_brokers()
    assert others == [B2]
    # TTL: a broker that stops heartbeating ages out (redis.rs:93-99)
    fake.advance(61)
    await r1.perform_heartbeat(3, heartbeat_expiry_s=60)
    assert await r1.get_other_brokers() == []


async def test_least_connections_counts_permits():
    fake = FakeRedis()
    r1, r2 = make(fake, B1), make(fake, B2)
    await r1.perform_heartbeat(2, 60)
    await r2.perform_heartbeat(1, 60)
    marshal = make(fake, None)
    assert await marshal.get_with_least_connections() == B2
    # two outstanding permits for b2 outweigh b1's one extra connection
    await marshal.issue_permit(B2, 30, b"user-a")
    await marshal.issue_permit(B2, 30, b"user-b")
    assert await marshal.get_with_least_connections() == B1


async def test_permit_single_use_and_scoping():
    fake = FakeRedis()
    marshal = make(fake, None)
    permit = await marshal.issue_permit(B1, 30, b"alice")
    assert permit > 1  # 0/1 are reserved response codes (message.rs:338)
    broker = make(fake, B1)
    # wrong broker: rejected (and consumed — GETDEL semantics)
    p2 = await marshal.issue_permit(B1, 30, b"bob")
    assert await broker.validate_permit(B2, p2) is None
    # right broker: returns the public key, single-use
    assert await broker.validate_permit(B1, permit) == b"alice"
    assert await broker.validate_permit(B1, permit) is None


async def test_global_permits_flag():
    fake = FakeRedis()
    marshal = make(fake, None)
    permit = await marshal.issue_permit(B1, 30, b"carol")
    broker = make(fake, B2, global_permits=True)
    # with global permits any broker may redeem (discovery/redis.rs:219-226)
    assert await broker.validate_permit(B2, permit) == b"carol"


async def test_permit_expiry():
    fake = FakeRedis()
    marshal = make(fake, None)
    permit = await marshal.issue_permit(B1, 30, b"dave")
    fake.advance(31)
    broker = make(fake, B1)
    assert await broker.validate_permit(B1, permit) is None


async def test_whitelist():
    fake = FakeRedis()
    r = make(fake, None)
    # empty whitelist admits everyone
    assert await r.check_whitelist(b"anyone")
    await r.set_whitelist([b"alice", b"bob"])
    assert await r.check_whitelist(b"alice")
    assert not await r.check_whitelist(b"mallory")
    # replacing the list drops old entries atomically
    await r.set_whitelist([b"carol"])
    assert not await r.check_whitelist(b"alice")
    assert await r.check_whitelist(b"carol")


async def test_no_brokers_is_an_error():
    fake = FakeRedis()
    marshal = make(fake, None)
    with pytest.raises(Error):
        await marshal.get_with_least_connections()


async def test_user_slot_directory_roundtrip_and_newest_wins():
    """The multi-host user-slot directory over Redis: publish/read/drop,
    TTL aging, and the newest-claim-wins conflict rule (a loser host's
    TTL republication must not overwrite the winner's newer claim)."""
    fake = FakeRedis()
    d = make(fake, None)
    await d.publish_user_slots({b"alice": (3, 100.0)}, ttl_s=30)
    assert await d.get_user_slots() == {b"alice": (3, 100.0)}

    # stale republication (older ts) loses; newer claim wins
    await d.publish_user_slots({b"alice": (9, 50.0)}, ttl_s=30)
    assert (await d.get_user_slots())[b"alice"] == (3, 100.0)
    await d.publish_user_slots({b"alice": (7, 200.0)}, ttl_s=30)
    assert (await d.get_user_slots())[b"alice"] == (7, 200.0)

    # TTL expiry ages claims out like broker heartbeats
    fake.advance(31)
    assert await d.get_user_slots() == {}

    # explicit drop on release
    await d.publish_user_slots({b"bob": (1, 1.0), b"carol": (2, 2.0)},
                               ttl_s=30)
    await d.drop_user_slots([b"bob"])
    assert await d.get_user_slots() == {b"carol": (2, 2.0)}


# ---------------------------------------------------------------------------
# the two packages against each other, and the port's refusal
# ---------------------------------------------------------------------------


def _ops(rng: random.Random, n: int) -> list:
    """A seeded sequence of discovery operations over three brokers, a
    marshal and five users: heartbeats with TTLs, clock advances,
    membership and placement reads, permits issued, redeemed (at the
    right broker, a wrong one, twice, or made up), whitelist changes and
    the user-slot directory."""
    users = [b"user-%d" % i for i in range(5)]
    ops = []
    for _ in range(n):
        kind = rng.choice(["heartbeat", "heartbeat", "advance", "others",
                           "least", "issue", "issue", "redeem", "redeem",
                           "bogus", "whitelist", "check", "publish", "slots",
                           "drop", "deregister"])
        b = rng.randrange(3)
        if kind == "heartbeat":
            ops.append((kind, b, rng.randrange(10), rng.choice([5, 30, 60])))
        elif kind == "advance":
            ops.append((kind, rng.choice([1, 4, 10, 31])))
        elif kind in ("others", "deregister"):
            ops.append((kind, b))
        elif kind == "issue":
            ops.append((kind, b, rng.choice([5, 30]), rng.choice(users)))
        elif kind == "redeem":
            ops.append((kind, b, rng.randrange(1 << 16)))
        elif kind == "whitelist":
            ops.append((kind, rng.sample(users, rng.randrange(3))))
        elif kind in ("check", "drop"):
            ops.append((kind, rng.sample(users, rng.randrange(1, 3))))
        elif kind == "publish":
            ops.append((kind, {u: (rng.randrange(64), float(rng.randrange(100)))
                               for u in rng.sample(users, 2)},
                        rng.choice([5, 30])))
        else:
            ops.append((kind,))
    return ops


async def _replay(redis_mod, ident_cls, error_cls, ops, seed: int) -> list:
    """Run ``ops`` on one package's ``Redis`` over a fresh fake; every
    result, or the error it raised, in order."""
    import types
    fake = FakeRedis()
    # the permit numbers, drawn from a seeded generator on both sides
    rng = random.Random(seed)
    orig = redis_mod.secrets
    redis_mod.secrets = types.SimpleNamespace(randbits=rng.getrandbits)
    brokers = [ident_cls(f"b{i}-pub", f"b{i}-priv") for i in range(3)]
    clients = [redis_mod.Redis(fake, b) for b in brokers]
    marshal = redis_mod.Redis(fake, None)
    issued = []
    out = []
    try:
        for op in ops:
            kind = op[0]
            try:
                if kind == "heartbeat":
                    r = await clients[op[1]].perform_heartbeat(op[2], op[3])
                elif kind == "advance":
                    r = fake.advance(op[1])
                elif kind == "others":
                    r = sorted(map(str, await clients[op[1]]
                                   .get_other_brokers()))
                elif kind == "least":
                    r = str(await marshal.get_with_least_connections())
                elif kind == "issue":
                    r = await marshal.issue_permit(brokers[op[1]], op[2],
                                                   op[3])
                    issued.append(r)
                elif kind == "redeem":
                    permit = issued[op[2] % len(issued)] if issued else 7
                    r = await clients[op[1]].validate_permit(brokers[op[1]],
                                                             permit)
                elif kind == "bogus":
                    r = await clients[0].validate_permit(brokers[0], 5)
                elif kind == "whitelist":
                    r = await marshal.set_whitelist(op[1])
                elif kind == "check":
                    r = [await marshal.check_whitelist(u) for u in op[1]]
                elif kind == "publish":
                    r = await marshal.publish_user_slots(op[1], op[2])
                elif kind == "slots":
                    r = sorted((await marshal.get_user_slots()).items())
                elif kind == "drop":
                    r = await marshal.drop_user_slots(op[1])
                else:
                    r = await clients[op[1]].deregister()
            except error_cls as exc:
                r = ("error", str(exc))
            out.append((kind, r))
    finally:
        redis_mod.secrets = orig
    return out


@pytest.mark.parametrize("seed", [3, 11, 2024])
async def test_same_operations_same_results_as_the_jax_package(seed):
    from pushcdn_tpu.proto.discovery import base as jbase
    from pushcdn_tpu.proto.discovery import redis as jredis
    from pushcdn_tpu.proto.error import Error as JaxError
    from pushcdn_tpu_torch.proto.discovery import base as tbase
    from pushcdn_tpu_torch.proto.discovery import redis as tredis

    ops = _ops(random.Random(seed), 300)
    jax_out = await _replay(jredis, jbase.BrokerIdentifier, JaxError, ops,
                            seed)
    port_out = await _replay(tredis, tbase.BrokerIdentifier, Error, ops,
                             seed)
    assert port_out == jax_out
    kinds = {k for k, r in port_out if r is not None}
    # the sequence reached every read, and permits were redeemed
    assert {"others", "least", "issue", "redeem", "check", "slots"} <= kinds
    assert any(k == "redeem" and isinstance(r, bytes) for k, r in port_out)


async def test_new_without_the_package_names_it(monkeypatch):
    """Without the ``redis`` package ``Redis.new`` refuses with the JAX
    package's message, which the binaries print for a ``redis://``
    endpoint."""
    import sys
    monkeypatch.setitem(sys.modules, "redis", None)
    monkeypatch.setitem(sys.modules, "redis.asyncio", None)
    with pytest.raises(Error, match="'redis' package is not available"):
        await Redis.new("redis://127.0.0.1:1")


# ---------------------------------------------------------------------------
# Real-server tier: the full discovery contract against an ACTUAL
# redis-compatible server — TTL expiry via real time, GETDEL single-use
# atomicity, least-connections with live permits. Skipped where there is
# no server binary or no redis client package, as the JAX package's tier
# is; it runs unmodified wherever both exist.
# Parity target: cdn-proto/src/discovery/redis.rs:86-167.
# ---------------------------------------------------------------------------

def _find_redis_server():
    import shutil
    for name in ("redis-server", "valkey-server", "keydb-server"):
        path = shutil.which(name)
        if path:
            return path
    return None


def _have_redis_client():
    try:
        import redis.asyncio  # noqa: F401
        return True
    except ImportError:
        return False


_SERVER = _find_redis_server()
needs_real_redis = pytest.mark.skipif(
    _SERVER is None or not _have_redis_client(),
    reason="real-server tier: no redis-compatible server binary and/or "
           "no 'redis' client package; "
           "runs unmodified where both exist")


@pytest.fixture
def real_redis():
    """Spawn a throwaway real server on a free port, yield its URL.
    Synchronous on purpose: the repo's conftest runs async TESTS without
    pytest-asyncio, so fixtures must not be async generators."""
    import socket
    import subprocess
    import time as _time
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [_SERVER, "--port", str(port), "--save", "", "--appendonly", "no"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = _time.time() + 10
        while _time.time() < deadline:
            try:
                with socket.create_connection(("127.0.0.1", port),
                                              timeout=1) as c:
                    c.sendall(b"PING\r\n")
                    if c.recv(7).startswith(b"+PONG"):
                        break
            except OSError:
                pass
            _time.sleep(0.05)
        else:
            raise RuntimeError("redis-server never became ready")
        yield f"redis://127.0.0.1:{port}"
    finally:
        proc.terminate()
        proc.wait(timeout=10)


@needs_real_redis
async def test_real_server_heartbeat_ttl_expiry(real_redis):
    """Membership expires by the SERVER's clock, not ours: a broker that
    stops heartbeating vanishes after its TTL."""
    import asyncio
    d = await Redis.new(real_redis, identity=B1)
    try:
        await d.perform_heartbeat(3, heartbeat_expiry_s=1.0)
        others = await Redis.new(real_redis, identity=B2)
        await others.perform_heartbeat(5, heartbeat_expiry_s=30.0)
        assert {str(b) for b in await d.get_other_brokers()} | {str(B1)} \
            >= {str(B1), str(B2)}
        await asyncio.sleep(1.5)  # B1's TTL lapses on the server
        alive = {str(b) for b in await others.get_other_brokers()}
        assert str(B1) not in alive
        await others.close()
    finally:
        await d.close()


@needs_real_redis
async def test_real_server_permit_getdel_single_use(real_redis):
    """GETDEL atomicity: N concurrent redemptions of one permit yield
    exactly one winner."""
    import asyncio
    d = await Redis.new(real_redis, identity=B1)
    try:
        await d.perform_heartbeat(0, heartbeat_expiry_s=30.0)
        permit = await d.issue_permit(B1, 30.0, b"alice")
        results = await asyncio.gather(*(
            d.validate_permit(B1, permit) for _ in range(8)))
        winners = [r for r in results if r == b"alice"]
        assert len(winners) == 1, results
        assert all(r is None for r in results if r != b"alice")
    finally:
        await d.close()


@needs_real_redis
async def test_real_server_least_connections_with_live_permits(real_redis):
    """Outstanding permits count toward load, so the marshal spreads
    storms across brokers before connections even land."""
    d1 = await Redis.new(real_redis, identity=B1)
    d2 = await Redis.new(real_redis, identity=B2)
    try:
        await d1.perform_heartbeat(2, heartbeat_expiry_s=30.0)
        await d2.perform_heartbeat(2, heartbeat_expiry_s=30.0)
        # load equal: 3 permits against B1 must tip selection to B2
        for i in range(3):
            await d1.issue_permit(B1, 30.0, b"user%d" % i)
        chosen = await d1.get_with_least_connections()
        assert str(chosen) == str(B2)
    finally:
        await d1.close()
        await d2.close()


@needs_real_redis
async def test_real_server_permit_ttl_expiry(real_redis):
    """An unredeemed permit lapses by the server's clock."""
    import asyncio
    d = await Redis.new(real_redis, identity=B1)
    try:
        await d.perform_heartbeat(0, heartbeat_expiry_s=30.0)
        permit = await d.issue_permit(B1, 1.0, b"bob")
        await asyncio.sleep(1.5)
        assert await d.validate_permit(B1, permit) is None
    finally:
        await d.close()
