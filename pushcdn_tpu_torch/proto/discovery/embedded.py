"""Embedded discovery: SQLite-backed membership/permits/whitelist.

Capability parity with cdn-proto/src/discovery/embedded.rs:39-423 (+ schema
in cdn-proto/local_db/migrations.sql): same semantics as the Redis/KeyDB
implementation with explicit expiry pruning — ``brokers`` rows age out after
their heartbeat TTL, permits after theirs; whitelist is a plain key set and
an EMPTY whitelist admits everyone.

Used for local runs and single-process integration tests: every actor opens
the same SQLite file, which stands in for KeyDB exactly the way the Memory
transport stands in for the network (SURVEY.md §4).

Operations are synchronous sqlite3 under the hood (they are local,
microsecond-scale, and infrequent: heartbeats every 10 s, auth handshakes);
the async interface is kept so the Redis implementation can be truly async.
"""

from __future__ import annotations

import asyncio
import secrets
import sqlite3
import time
from typing import List, Optional

from pushcdn_tpu_torch.proto.discovery.base import BrokerIdentifier, DiscoveryClient
from pushcdn_tpu_torch.proto.error import ErrorKind, bail

# Cross-process write contention policy (ISSUE 12): sqlite raises
# OperationalError('database is locked') when another process holds the
# write lock past busy_timeout. Writes retry on this bounded schedule
# before surfacing a TYPED Error(CONNECTION) — never the raw sqlite3
# exception. Total budget (~0.75 s + busy_timeout per attempt) stays well
# under the 8 s chaos-outage hold, so a genuine discovery outage still
# fails loudly (heartbeat task-died events, admissions refused) instead
# of hanging. Tests shrink both knobs to keep the slow path fast.
LOCKED_RETRY_SCHEDULE = (0.05, 0.1, 0.2, 0.4)
BUSY_TIMEOUT_MS = 5000


def _is_locked(exc: sqlite3.OperationalError) -> bool:
    msg = str(exc).lower()
    return "locked" in msg or "busy" in msg


async def _locked_retry(op, what: str):
    """Run the synchronous sqlite write ``op`` with bounded backoff on
    lock contention; other OperationalErrors propagate unchanged."""
    for delay in LOCKED_RETRY_SCHEDULE:
        try:
            return op()
        except sqlite3.OperationalError as exc:
            if not _is_locked(exc):
                raise
        await asyncio.sleep(delay)
    try:
        return op()
    except sqlite3.OperationalError as exc:
        if not _is_locked(exc):
            raise
        bail(ErrorKind.CONNECTION, f"discovery store busy: {what}", exc)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS brokers (
    identifier TEXT PRIMARY KEY,
    num_connections INTEGER NOT NULL DEFAULT 0,
    expiry REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS permits (
    permit INTEGER PRIMARY KEY,
    broker TEXT NOT NULL,
    public_key BLOB NOT NULL,
    expiry REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS whitelist (
    public_key BLOB PRIMARY KEY
);
CREATE TABLE IF NOT EXISTS user_slots (
    public_key BLOB PRIMARY KEY,
    slot INTEGER NOT NULL,
    ts REAL NOT NULL,
    expiry REAL NOT NULL
);
"""


class Embedded(DiscoveryClient):
    """SQLite discovery client (parity ``Embedded``, embedded.rs:39-423)."""

    def __init__(self, path: str, identity: Optional[BrokerIdentifier],
                 global_permits: bool = False):
        self.path = path
        self.identity = identity
        # global_permits: permits redeemable at any broker (the reference's
        # `global-permits` cargo feature, threaded through discovery/auth)
        self.global_permits = global_permits
        # autocommit: every statement is its own WAL transaction, so no
        # connection can hold the cross-process write lock between event-
        # loop turns (python's legacy implicit transactions did, and a
        # second process then hits 'database is locked' past busy_timeout)
        self._db = sqlite3.connect(path, check_same_thread=False,
                                   isolation_level=None)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute(f"PRAGMA busy_timeout={int(BUSY_TIMEOUT_MS)}")
        # Permits/heartbeats are ephemeral (30-60 s TTLs): losing the tail
        # of the WAL on power loss only forces reconnects, so skip the
        # per-commit fsync — it was most of the auth handshake's floor
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.executescript(_SCHEMA)
        self._db.commit()

    @classmethod
    async def new(cls, endpoint: str,
                  identity: Optional[BrokerIdentifier] = None,
                  global_permits: bool = False) -> "Embedded":
        """``endpoint`` is a filesystem path (or ":memory:" for throwaway)."""
        try:
            return cls(endpoint, identity, global_permits)
        except sqlite3.Error as exc:
            bail(ErrorKind.FILE, f"cannot open embedded discovery at {endpoint}", exc)

    # -- membership ---------------------------------------------------------

    def _prune(self) -> None:
        now = time.time()
        self._db.execute("DELETE FROM brokers WHERE expiry < ?", (now,))
        self._db.execute("DELETE FROM permits WHERE expiry < ?", (now,))
        self._db.commit()

    async def perform_heartbeat(self, num_connections: int,
                                heartbeat_expiry_s: float) -> None:
        if self.identity is None:
            bail(ErrorKind.PARSE, "heartbeat requires a broker identity")

        def write():
            self._db.execute(
                "INSERT INTO brokers (identifier, num_connections, expiry) "
                "VALUES (?, ?, ?) ON CONFLICT(identifier) DO UPDATE SET "
                "num_connections=excluded.num_connections, expiry=excluded.expiry",
                (str(self.identity), num_connections,
                 time.time() + heartbeat_expiry_s))
            self._db.commit()
        await _locked_retry(write, "heartbeat")

    async def deregister(self) -> None:
        if self.identity is None:
            return

        def write():
            self._db.execute("DELETE FROM brokers WHERE identifier = ?",
                             (str(self.identity),))
            self._db.commit()
        await _locked_retry(write, "deregister")

    async def get_other_brokers(self) -> List[BrokerIdentifier]:
        await _locked_retry(self._prune, "prune")
        me = str(self.identity) if self.identity else None
        rows = self._db.execute(
            "SELECT identifier FROM brokers").fetchall()
        return [BrokerIdentifier.from_string(r[0]) for r in rows
                if r[0] != me]

    async def get_with_least_connections(self) -> BrokerIdentifier:
        """Load = live connections + outstanding permits (parity
        redis.rs:139-167)."""
        await _locked_retry(self._prune, "prune")
        rows = self._db.execute(
            "SELECT b.identifier, b.num_connections + "
            " (SELECT COUNT(*) FROM permits p WHERE p.broker = b.identifier) "
            "FROM brokers b ORDER BY 2 ASC, b.identifier ASC").fetchall()
        if not rows:
            bail(ErrorKind.CONNECTION, "no live brokers in discovery")
        return BrokerIdentifier.from_string(rows[0][0])

    # -- permits ------------------------------------------------------------

    async def issue_permit(self, for_broker: BrokerIdentifier,
                           expiry_s: float, public_key: bytes) -> int:
        # permit semantics: 0=fail, 1=ack, >1=real permit (message.rs:338-341)
        while True:
            permit = secrets.randbits(62) + 2

            def write():
                self._db.execute(
                    "INSERT INTO permits (permit, broker, public_key, expiry) "
                    "VALUES (?, ?, ?, ?)",
                    (permit, str(for_broker), bytes(public_key),
                     time.time() + expiry_s))
                self._db.commit()
            try:
                await _locked_retry(write, "issue_permit")
                return permit
            except sqlite3.IntegrityError:
                continue  # permit collision: retry

    async def _validate_permit(self, broker: BrokerIdentifier,
                               permit: int) -> Optional[bytes]:
        """Redeem-and-delete (GETDEL parity, redis permit redemption);
        range-checked by the base-class template method."""
        await _locked_retry(self._prune, "prune")
        row = self._db.execute(
            "SELECT broker, public_key FROM permits WHERE permit = ?",
            (permit,)).fetchone()
        if row is None:
            return None
        if not self.global_permits and row[0] != str(broker):
            return None  # issued for a different broker

        def write():
            self._db.execute("DELETE FROM permits WHERE permit = ?", (permit,))
            self._db.commit()
        await _locked_retry(write, "validate_permit")
        return bytes(row[1])

    # -- whitelist ----------------------------------------------------------

    async def set_whitelist(self, users: List[bytes]) -> None:
        # the one compound write that must stay atomic under autocommit: a
        # reader between the DELETE and the INSERTs would see an empty
        # whitelist (= admit everyone)
        def write():
            self._db.execute("BEGIN IMMEDIATE")
            try:
                self._db.execute("DELETE FROM whitelist")
                self._db.executemany(
                    "INSERT OR IGNORE INTO whitelist (public_key) VALUES (?)",
                    [(bytes(u),) for u in users])
                self._db.execute("COMMIT")
            except BaseException:
                self._db.execute("ROLLBACK")
                raise
        await _locked_retry(write, "set_whitelist")
        # The whitelist is DURABLE access control (an empty table admits
        # everyone) — force the WAL to disk so synchronous=NORMAL's
        # skipped fsync (fine for ephemeral permits/heartbeats) can't
        # fail-open the broker after a power loss.
        self._db.execute("PRAGMA wal_checkpoint(TRUNCATE)")

    async def check_whitelist(self, user: bytes) -> bool:
        n = self._db.execute("SELECT COUNT(*) FROM whitelist").fetchone()[0]
        if n == 0:
            return True  # empty whitelist admits everyone
        row = self._db.execute(
            "SELECT 1 FROM whitelist WHERE public_key = ?",
            (bytes(user),)).fetchone()
        return row is not None

    # -- user-slot directory (multi-host device planes) ---------------------

    async def publish_user_slots(self, entries, ttl_s: float) -> None:
        now = time.time()
        # newest claim wins: a loser host's TTL re-publication must not
        # overwrite the winning host's newer claim (claim ts is fixed at
        # claim time; refreshes carry the same ts and still bump expiry)
        self._db.executemany(
            "INSERT INTO user_slots (public_key, slot, ts, expiry) "
            "VALUES (?, ?, ?, ?) ON CONFLICT(public_key) DO UPDATE SET "
            "slot=excluded.slot, ts=excluded.ts, expiry=excluded.expiry "
            "WHERE excluded.ts >= user_slots.ts",
            [(bytes(pk), int(slot), float(ts), now + ttl_s)
             for pk, (slot, ts) in entries.items()])

    async def get_user_slots(self):
        now = time.time()
        self._db.execute("DELETE FROM user_slots WHERE expiry < ?", (now,))
        rows = self._db.execute(
            "SELECT public_key, slot, ts FROM user_slots").fetchall()
        return {bytes(r[0]): (int(r[1]), float(r[2])) for r in rows}

    async def drop_user_slots(self, keys) -> None:
        self._db.executemany("DELETE FROM user_slots WHERE public_key = ?",
                             [(bytes(k),) for k in keys])

    async def close(self) -> None:
        self._db.close()
