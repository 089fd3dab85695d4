"""The port's reconnect-storm resilience held against the JAX package's.

Every case of ``tests/test_client_backoff.py`` runs on both packages with
the same seeds: the full-jitter exponential backoff (the same draws from
the same ``random`` seed), the typed ``Error(SHED)`` retry-after hint that
floors it, a broker over its connection budget refusing a second client
with that hint (the port's admission control), the reconnect loop's
attempts, and the SQLite discovery store's bounded retry past a held
write lock. The port's record must equal JAX's.
"""

import asyncio
import importlib
import random
import sqlite3
from types import SimpleNamespace

import pytest

ROOTS = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}


def _pkg(name: str) -> SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{ROOTS[name]}.{path}")

    return SimpleNamespace(
        name=name, client_mod=mod("client.client"),
        user_auth=mod("proto.auth.user"), sig=mod("proto.crypto.signature"),
        emb=mod("proto.discovery.embedded"),
        discovery=mod("proto.discovery.base"), error=mod("proto.error"),
        memory=mod("proto.transport.memory"), cluster=mod("testing.cluster"))


PACKAGES = {name: _pkg(name) for name in ROOTS}


def _both(record) -> object:
    out = {name: record(p) for name, p in PACKAGES.items()}
    assert out["port"] == out["jax"], out
    return out["port"]


async def _both_async(record, *args) -> object:
    out = {}
    for name, p in PACKAGES.items():
        async with asyncio.timeout(50):
            out[name] = await record(p, *args)
    assert out["port"] == out["jax"], out
    return out["port"]


# ---------------------------------------------------------------------------
# the backoff policy itself
# ---------------------------------------------------------------------------

def test_backoff_is_full_jitter():
    base, cap = 0.25, 30.0

    def record(p):
        random.seed(1207)
        return [[p.client_mod.backoff_delay(attempt, base_s=base, cap_s=cap)
                 for _ in range(200)] for attempt in range(12)]
    for attempt, draws in enumerate(_both(record)):
        ceiling = min(cap, base * (2 ** attempt))
        assert all(0.0 <= d <= ceiling for d in draws)
        # FULL jitter: the whole [0, ceiling) range is drawn from
        assert min(draws) < 0.2 * ceiling
        assert max(draws) > 0.8 * ceiling


def test_backoff_caps_growth():
    def record(p):
        random.seed(7)
        return [p.client_mod.backoff_delay(attempt, base_s=0.25, cap_s=3.0)
                for attempt in (20, 40, 63)]
    assert all(d <= 3.0 for d in _both(record))


def test_backoff_retry_after_is_a_floor():
    def record(p):
        random.seed(3)
        # attempt 0 draws from [0, 0.25); a 5 s server hint must dominate
        floored = [p.client_mod.backoff_delay(0, retry_after_s=5.0)
                   for _ in range(50)]
        random.seed(3)
        # a hint SMALLER than the draw never truncates the jitter
        small = [p.client_mod.backoff_delay(8, retry_after_s=0.001)
                 for _ in range(50)]
        return floored, small
    floored, small = _both(record)
    assert all(d >= 5.0 for d in floored)
    assert max(small) > 1.0


# ---------------------------------------------------------------------------
# the typed hint, end to end
# ---------------------------------------------------------------------------

def test_retry_after_hint_parsing():
    def record(p):
        hint = p.error.retry_after_hint
        return [hint("shed: budget reached; retry-after=5"),
                hint("shed: x; retry-after=2.75 more"),
                hint("shed: no hint here"), hint("retry-after=abc")]
    assert _both(record) == [5.0, 2.75, None, None]


def test_shed_error_carries_retry_after():
    def record(p):
        e = p.error.Error(p.error.ErrorKind.SHED,
                          "broker shed the connection: shed: user "
                          "connection budget 1 reached; retry-after=5")
        # only SHED is a server pacing signal
        e2 = p.error.Error(p.error.ErrorKind.AUTHENTICATION,
                           "nope; retry-after=5")
        return [e.retry_after_s, e2.retry_after_s]
    assert _both(record) == [5.0, None]


def test_bail_rejection_types_sheds():
    def record(p):
        out = []
        for who, context in (("broker", "shed: user connection budget 1 "
                                        "reached; retry-after=5"),
                             ("marshal", "bad signature")):
            with pytest.raises(p.error.Error) as ei:
                p.user_auth._bail_rejection(who, context)
            out.append([ei.value.kind.name, ei.value.retry_after_s])
        return out
    assert _both(record) == [["SHED", 5.0], ["AUTHENTICATION", None]]


async def _connect_shed(p) -> list:
    cluster = await p.cluster.Cluster(
        num_brokers=1, **({"device": "cpu"} if p.name == "port" else {})
    ).start()
    try:
        first = cluster.client(seed=83_000)
        await asyncio.wait_for(first.ensure_initialized(), 10.0)
        second = cluster.client(seed=83_001)
        with pytest.raises(p.error.Error) as ei:
            await asyncio.wait_for(second._connect_once(), 10.0)
        first.close()
        second.close()
        return [ei.value.kind.name, ei.value.retry_after_s,
                cluster.brokers[0].admission.summary()["shed_counts"]]
    finally:
        await cluster.stop()


async def test_connect_shed_surfaces_typed_retry_after(monkeypatch):
    """A broker over its connection budget refuses at connect time with
    ``Error(SHED)`` carrying the readiness window as the retry hint."""
    monkeypatch.setenv("PUSHCDN_MAX_CONNS_USER", "1")
    monkeypatch.setenv("PUSHCDN_SHED_READY_S", "3")
    assert await _both_async(_connect_shed) == [
        "SHED", 3.0, {"user_conn": 1}]


async def _reconnect_attempts(p, monkeypatch) -> list:
    delays = []

    def fake_backoff(attempt, retry_after_s=None, **kw):
        delays.append((attempt, retry_after_s))
        return 0.0
    monkeypatch.setattr(p.client_mod, "backoff_delay", fake_backoff)
    c = p.client_mod.Client(p.client_mod.ClientConfig(
        marshal_endpoint="nowhere-no-listener",
        keypair=p.sig.DEFAULT_SCHEME.generate_keypair(seed=83_002),
        protocol=p.memory.Memory))
    task = asyncio.ensure_future(c._get_connection())
    while len(delays) < 4:
        await asyncio.sleep(0.01)
    task.cancel()
    with pytest.raises(asyncio.CancelledError):
        await task
    return [a for a, _ in delays[:4]]


async def test_reconnect_loop_uses_backoff(monkeypatch):
    """The reconnect loop feeds (attempt, server hint) into the policy:
    attempts count up."""
    assert await _both_async(_reconnect_attempts, monkeypatch) == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# SQLite discovery: bounded retry past a write lock
# ---------------------------------------------------------------------------

def _identity(p, i=0):
    return p.discovery.BrokerIdentifier(f"lock-pub-{i}", f"lock-priv-{i}")


async def _retries_past_lock(p, tmp_path, monkeypatch) -> list:
    monkeypatch.setattr(p.emb, "BUSY_TIMEOUT_MS", 25)
    monkeypatch.setattr(p.emb, "LOCKED_RETRY_SCHEDULE", (0.05, 0.1, 0.2))
    db = str(tmp_path / f"{p.name}-held.sqlite")
    disc = await p.emb.Embedded.new(db, identity=_identity(p))
    locker = sqlite3.connect(db)
    try:
        locker.execute("BEGIN IMMEDIATE")  # hold the write lock

        async def release_soon():
            await asyncio.sleep(0.15)  # past busy_timeout + first retries
            locker.execute("COMMIT")

        releaser = asyncio.ensure_future(release_soon())
        await disc.perform_heartbeat(3, 60.0)  # must NOT raise
        await releaser
        return await disc.get_other_brokers()
    finally:
        locker.close()
        await disc.close()


async def test_embedded_retries_past_held_write_lock(tmp_path, monkeypatch):
    assert await _both_async(_retries_past_lock, tmp_path, monkeypatch) == []


async def _lock_exhaustion(p, tmp_path, monkeypatch) -> list:
    monkeypatch.setattr(p.emb, "BUSY_TIMEOUT_MS", 10)
    monkeypatch.setattr(p.emb, "LOCKED_RETRY_SCHEDULE", (0.02, 0.04))
    db = str(tmp_path / f"{p.name}-exhausted.sqlite")
    disc = await p.emb.Embedded.new(db, identity=_identity(p, 1))
    locker = sqlite3.connect(db)
    try:
        locker.execute("BEGIN IMMEDIATE")
        with pytest.raises(p.error.Error) as ei:
            await disc.perform_heartbeat(1, 60.0)
        locker.execute("ROLLBACK")
        return [ei.value.kind.name,
                "discovery store busy" in ei.value.message]
    finally:
        locker.close()
        await disc.close()


async def test_embedded_lock_exhaustion_is_typed(tmp_path, monkeypatch):
    """A lock held past the whole schedule surfaces as the typed
    ``Error(CONNECTION)``, never a raw ``sqlite3.OperationalError``."""
    assert await _both_async(_lock_exhaustion, tmp_path, monkeypatch) == [
        "CONNECTION", True]


async def _deregister(p, tmp_path) -> list:
    db = str(tmp_path / f"{p.name}-dereg.sqlite")
    a = await p.emb.Embedded.new(db, identity=_identity(p, 0))
    b = await p.emb.Embedded.new(db, identity=_identity(p, 1))
    try:
        await a.perform_heartbeat(0, 60.0)
        await b.perform_heartbeat(5, 60.0)
        before = str(await a.get_with_least_connections())
        await a.deregister()
        await a.deregister()  # idempotent
        return [before, await b.get_other_brokers(),
                str(await b.get_with_least_connections())]
    finally:
        await a.close()
        await b.close()


async def test_deregister_removes_broker_row(tmp_path):
    """Drain step 1: a deregistered broker leaves placement immediately
    and idempotently (every shard worker calls it)."""
    assert await _both_async(_deregister, tmp_path) == [
        str(_identity(PACKAGES["port"], 0)), [],
        str(_identity(PACKAGES["port"], 1))]
