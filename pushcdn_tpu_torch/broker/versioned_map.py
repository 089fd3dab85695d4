"""``VersionedMap`` — the eventually-consistent map underlying all routing
state, plus its wire codec.

Capability parity with cdn-broker/src/connections/versioned_map.rs:28-269:

- per-key ``u64`` version, bumped on every local modification;
- removals are **tombstones** (a versioned ``None``) so deletes propagate;
- local modifications are tracked so :meth:`diff` emits only deltas
  (versioned_map.rs:168-194);
- :meth:`merge` is last-writer-wins by version with ties broken by a
  **totally ordered conflict identity** (the modifying party), and returns
  the set of keys whose value actually changed so callers can evict
  (versioned_map.rs:201-269 — "user connected elsewhere" kicks);
- ``remove_if_equals`` / ``remove_by_value_no_modify`` for cleanup paths.

The wire codec replaces the reference's rkyv archives (sync payloads nested
inside the Message envelope, tasks/broker/sync.rs:24-40) with a compact
tag-length-value encoding of (key, version, identity, value) records.

TPU twin: ``pushcdn_tpu_torch.parallel.crdt`` vectorizes exactly this merge —
per-key ``argmax`` over the (version, identity) pair — and is property-
tested for equivalence against this class.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable, Dict, Generic, Hashable, List, Optional, Set, Tuple, TypeVar

from pushcdn_tpu_torch.proto.error import ErrorKind, bail

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")
C = TypeVar("C")  # conflict identity; must be totally ordered

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")


# --- generic scalar codec for keys/values/identities -----------------------
# Supports the types routing state actually uses: bytes (user public keys),
# str (broker identifiers), int (topics / subscription status), None
# (tombstones), and flat tuples of those.

_T_NONE, _T_INT, _T_BYTES, _T_STR, _T_TUPLE = 0, 1, 2, 3, 4


# Nesting bound for tuple values, enforced on BOTH sides: the analog of
# capnp's traversal limit (the reference's envelope format caps recursion
# depth by construction). Decode-side it stops a hostile peer's
# nested-tuple bomb from escaping as RecursionError; encode-side it fails
# fast with Error(SERIALIZE) so an over-nested local value can't ship a
# payload every peer would reject as malformed.
_MAX_VALUE_DEPTH = 32


def encode_value(v, out: bytearray, depth: int = 0) -> None:
    if depth >= _MAX_VALUE_DEPTH and isinstance(v, tuple):
        # symmetric with the decode-side traversal limit: fail fast at the
        # write site with Error(SERIALIZE) instead of shipping a payload
        # every peer would reject (and disconnect us) as malformed
        bail(ErrorKind.SERIALIZE,
             "versioned-map value nesting exceeds traversal limit")
    if v is None:
        out.append(_T_NONE)
    elif isinstance(v, bool):
        bail(ErrorKind.SERIALIZE, "bool not supported in versioned-map codec")
    elif isinstance(v, int):
        if not 0 <= v <= 0xFFFFFFFFFFFFFFFF:
            bail(ErrorKind.SERIALIZE,
                 f"int {v} out of u64 range in versioned-map codec")
        out.append(_T_INT)
        out += _U64.pack(v)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        out.append(_T_BYTES)
        out += _U32.pack(len(b))
        out += b
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out.append(_T_STR)
        out += _U32.pack(len(b))
        out += b
    elif isinstance(v, tuple):
        out.append(_T_TUPLE)
        out += _U32.pack(len(v))
        for item in v:
            encode_value(item, out, depth + 1)
    else:
        bail(ErrorKind.SERIALIZE,
             f"type {type(v).__name__} not supported in versioned-map codec")


def decode_value(view: memoryview, off: int,
                 depth: int = 0) -> Tuple[object, int]:
    tag = view[off]
    off += 1
    if tag == _T_NONE:
        return None, off
    if tag == _T_INT:
        (v,) = _U64.unpack_from(view, off)
        return v, off + 8
    if tag in (_T_BYTES, _T_STR):
        (n,) = _U32.unpack_from(view, off)
        off += 4
        raw = bytes(view[off:off + n])
        if len(raw) != n:
            bail(ErrorKind.DESERIALIZE, "truncated scalar in versioned-map codec")
        return (raw if tag == _T_BYTES else raw.decode("utf-8")), off + n
    if tag == _T_TUPLE:
        if depth >= _MAX_VALUE_DEPTH:
            bail(ErrorKind.DESERIALIZE,
                 "versioned-map value nesting exceeds traversal limit")
        (n,) = _U32.unpack_from(view, off)
        off += 4
        items = []
        for _ in range(n):
            item, off = decode_value(view, off, depth + 1)
            items.append(item)
        return tuple(items), off
    bail(ErrorKind.DESERIALIZE, f"unknown scalar tag {tag} in versioned-map codec")


@dataclass
class VersionedValue(Generic[V, C]):
    """One entry: ``value is None`` ⇒ tombstone (versioned_map.rs
    `VersionedValue`)."""

    value: Optional[V]
    version: int
    identity: C  # who made this modification (conflict tie-breaker)

    def dominates(self, other: "VersionedValue") -> bool:
        """Last-writer-wins by version; ties broken by ordered identity."""
        if self.version != other.version:
            return self.version > other.version
        return self.identity > other.identity


class VersionedMap(Generic[K, V, C]):
    """The CRDT map. Not thread-safe by itself — the broker guards all
    routing state behind one lock (parity: single
    ``parking_lot::RwLock<Connections>``, cdn-broker/src/lib.rs:98)."""

    def __init__(self, local_identity: C):
        self.local_identity = local_identity
        self._entries: Dict[K, VersionedValue[V, C]] = {}
        self._modified: Set[K] = set()

    # -- local modification (bumps version, tracks for diff) ----------------

    def insert(self, key: K, value: V) -> None:
        prev = self._entries.get(key)
        version = (prev.version + 1) if prev is not None else 1
        self._entries[key] = VersionedValue(value, version, self.local_identity)
        self._modified.add(key)

    def remove(self, key: K) -> Optional[V]:
        """Tombstone ``key`` (propagates); returns the removed value."""
        prev = self._entries.get(key)
        if prev is None or prev.value is None:
            return None
        self._entries[key] = VersionedValue(None, prev.version + 1,
                                            self.local_identity)
        self._modified.add(key)
        return prev.value

    def remove_if_equals(self, key: K, value: V) -> bool:
        """Remove only if the live value equals ``value`` — used when
        cleaning up our own claim without clobbering a newer one
        (versioned_map.rs `remove_if_equals`)."""
        prev = self._entries.get(key)
        if prev is not None and prev.value == value:
            self.remove(key)
            return True
        return False

    def remove_by_value_no_modify(self, value: V) -> List[K]:
        """Drop every entry whose value equals ``value`` WITHOUT tombstoning
        or marking modified — forgetting a dead peer's claims locally while
        letting the authoritative owner re-assert (versioned_map.rs
        `remove_by_value_no_modify`)."""
        doomed = [k for k, vv in self._entries.items() if vv.value == value]
        for k in doomed:
            del self._entries[k]
            self._modified.discard(k)
        return doomed

    # -- reads --------------------------------------------------------------

    def get(self, key: K) -> Optional[V]:
        vv = self._entries.get(key)
        return None if vv is None else vv.value

    def keys(self) -> List[K]:
        return [k for k, vv in self._entries.items() if vv.value is not None]

    def items(self) -> List[Tuple[K, V]]:
        return [(k, vv.value) for k, vv in self._entries.items()
                if vv.value is not None]

    def __len__(self) -> int:
        return sum(1 for vv in self._entries.values() if vv.value is not None)

    def __contains__(self, key: K) -> bool:
        return self.get(key) is not None

    # -- sync ---------------------------------------------------------------

    def diff(self) -> Dict[K, VersionedValue[V, C]]:
        """Entries modified locally since the previous diff; clears the
        tracking set (versioned_map.rs:168-194)."""
        out = {k: self._entries[k] for k in self._modified if k in self._entries}
        self._modified.clear()
        return out

    def full(self) -> Dict[K, VersionedValue[V, C]]:
        """Everything, tombstones included — sent when a broker (re)connects
        (full sync, tasks/broker/handler.rs:98-117)."""
        return dict(self._entries)

    def merge(self, incoming: Dict[K, VersionedValue[V, C]]) -> List[Tuple[K, Optional[V], Optional[V]]]:
        """Apply a remote delta. Returns ``(key, old_value, new_value)`` for
        every key whose *live value* changed, so the caller can react (the
        broker evicts local users whose DirectMap owner moved elsewhere,
        connections/mod.rs:154-162)."""
        changed: List[Tuple[K, Optional[V], Optional[V]]] = []
        for key, vv in incoming.items():
            local = self._entries.get(key)
            if local is None or vv.dominates(local):
                self._entries[key] = vv
                old = None if local is None else local.value
                if old != vv.value:
                    changed.append((key, old, vv.value))
        return changed

    def purge_tombstones(self) -> int:
        """Compact: drop tombstoned entries (the reference's purge test,
        versioned_map.rs:272-377). Safe between stable syncs; a peer that
        re-sends an older live entry will be re-tombstoned by whichever
        replica still knows better."""
        doomed = [k for k, vv in self._entries.items() if vv.value is None]
        for k in doomed:
            del self._entries[k]
            self._modified.discard(k)
        return len(doomed)

    # -- wire codec (replaces rkyv; parity sync.rs:24-40) -------------------

    @staticmethod
    def serialize_entries(entries: Dict[K, VersionedValue[V, C]]) -> bytes:
        out = bytearray()
        out += _U32.pack(len(entries))
        for k, vv in entries.items():
            encode_value(k, out)
            out += _U64.pack(vv.version)
            encode_value(vv.identity, out)
            encode_value(vv.value, out)
        return bytes(out)

    @staticmethod
    def deserialize_entries(payload) -> Dict[K, VersionedValue[V, C]]:
        """Raises ``Error(DESERIALIZE)`` on any truncated/malformed payload
        so the broker receive loop's disconnect-the-peer policy applies."""
        try:
            view = memoryview(payload)
            (n,) = _U32.unpack_from(view, 0)
            off = 4
            out: Dict[K, VersionedValue] = {}
            for _ in range(n):
                k, off = decode_value(view, off)
                (version,) = _U64.unpack_from(view, off)
                off += 8
                identity, off = decode_value(view, off)
                value, off = decode_value(view, off)
                out[k] = VersionedValue(value, version, identity)
            return out
        except (struct.error, IndexError, UnicodeDecodeError) as exc:
            bail(ErrorKind.DESERIALIZE, "malformed versioned-map payload", exc)
