"""Small utilities: stable 64-bit hash, human-readable mnemonics, task guards.

Capability parity with cdn-proto/src/util.rs:13-40 (``hash``, ``mnemonic``,
``AbortOnDropHandle``).
"""

from __future__ import annotations

import asyncio
import hashlib
from typing import Union

_ADJECTIVES = (
    "amber", "brisk", "calm", "dapper", "eager", "fuzzy", "gentle", "humble",
    "ivory", "jolly", "keen", "lively", "mellow", "noble", "opal", "plucky",
    "quiet", "rustic", "spry", "tidy", "umber", "vivid", "witty", "xenial",
    "young", "zesty", "bold", "crisp", "deft", "earnest", "frank", "glad",
)

_NOUNS = (
    "aspen", "brook", "cedar", "dune", "ember", "fjord", "glade", "harbor",
    "inlet", "juniper", "knoll", "lagoon", "meadow", "nimbus", "orchard",
    "prairie", "quartz", "ridge", "summit", "thicket", "upland", "vale",
    "willow", "yonder", "zephyr", "basin", "cliff", "delta", "eddy", "falls",
    "grove", "heath",
)


def stable_hash64(data: Union[bytes, bytearray, memoryview, str]) -> int:
    """Deterministic 64-bit hash of ``data`` (stable across processes).

    Python's builtin ``hash`` is salted per-process, so we use blake2b.
    Parity: cdn-proto/src/util.rs `hash` (a 64-bit content hash used for
    mnemonic ids and routing-table keys).
    """
    if isinstance(data, str):
        data = data.encode("utf-8")
    return int.from_bytes(hashlib.blake2b(bytes(data), digest_size=8).digest(), "little")


def mnemonic(data: Union[bytes, bytearray, memoryview, str, int]) -> str:
    """Human-readable id like ``"brisk-lagoon-1f"`` for logs.

    Parity: cdn-proto/src/util.rs `mnemonic` — the reference logs connect /
    disconnect events with mnemonic'd public keys.
    """
    h = data if isinstance(data, int) else stable_hash64(data)
    adj = _ADJECTIVES[h & 31]
    noun = _NOUNS[(h >> 5) & 31]
    tail = (h >> 10) & 0xFF
    return f"{adj}-{noun}-{tail:02x}"


class AbortOnDropHandle:
    """Holds an asyncio task and cancels it on :meth:`abort` or GC.

    Parity: cdn-proto/src/util.rs `AbortOnDropHandle` — per-connection
    receive loops are aborted when their owning connection is removed.
    """

    def __init__(self, task: asyncio.Task):
        self._task = task

    def abort(self) -> None:
        if not self._task.done():
            self._task.cancel()

    @property
    def task(self) -> asyncio.Task:
        return self._task

    def __del__(self) -> None:  # best-effort; explicit abort() is the norm
        try:
            self.abort()
        except Exception:
            pass
