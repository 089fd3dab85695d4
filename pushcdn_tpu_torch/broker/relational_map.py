"""``RelationalMap`` — a bidirectional multimap key ⇄ topics for O(1)-ish
interest lookups.

Capability parity with cdn-broker/src/connections/broadcast/relational_map.rs:14-116:
forward index (key → topic set) and inverse index (topic → key set) kept in
lockstep; used both for local users and for peer brokers.

TPU twin: on-device this is the per-connection topic **bitmask tensor**
(connections × topic-bits), where "who is interested in topic t" is a
vectorized mask test instead of a hash lookup (pushcdn_tpu_torch.parallel).
"""

from __future__ import annotations

from typing import Dict, Generic, Hashable, Iterable, List, Set, TypeVar

K = TypeVar("K", bound=Hashable)
T = TypeVar("T", bound=Hashable)


class RelationalMap(Generic[K, T]):
    def __init__(self):
        self._forward: Dict[K, Set[T]] = {}
        self._inverse: Dict[T, Set[K]] = {}

    def associate_key_with_values(self, key: K, values: Iterable[T]) -> None:
        fwd = self._forward.setdefault(key, set())
        for v in values:
            fwd.add(v)
            self._inverse.setdefault(v, set()).add(key)

    def dissociate_key_from_values(self, key: K, values: Iterable[T]) -> None:
        fwd = self._forward.get(key)
        if fwd is None:
            return
        for v in values:
            fwd.discard(v)
            inv = self._inverse.get(v)
            if inv is not None:
                inv.discard(key)
                if not inv:
                    del self._inverse[v]
        if not fwd:
            del self._forward[key]

    def remove_key(self, key: K) -> Set[T]:
        """Drop ``key`` entirely; returns the values it was associated with."""
        fwd = self._forward.pop(key, set())
        for v in fwd:
            inv = self._inverse.get(v)
            if inv is not None:
                inv.discard(key)
                if not inv:
                    del self._inverse[v]
        return fwd

    def get_values_of_key(self, key: K) -> Set[T]:
        return set(self._forward.get(key, ()))

    def get_keys_by_value(self, value: T) -> Set[K]:
        return set(self._inverse.get(value, ()))

    def get_keys_by_values(self, values: Iterable[T]) -> Set[K]:
        """Union of interested keys over ``values`` (the broadcast interest
        query, connections/mod.rs:94-124)."""
        out: Set[K] = set()
        for v in values:
            out |= self._inverse.get(v, set())
        return out

    def keys(self) -> List[K]:
        return list(self._forward.keys())

    def values(self) -> List[T]:
        """All values with ≥1 associated key — O(distinct values), straight
        off the inverse index (used for 'which topics have local interest')."""
        return list(self._inverse.keys())

    def __contains__(self, key: K) -> bool:
        return key in self._forward

    def __len__(self) -> int:
        return len(self._forward)

    def check_invariants(self) -> bool:
        """Test hook: forward and inverse indexes agree exactly (parity with
        the invariant tests at relational_map.rs:119-347)."""
        for k, vs in self._forward.items():
            for v in vs:
                if k not in self._inverse.get(v, set()):
                    return False
        for v, ks in self._inverse.items():
            if not ks:
                return False
            for k in ks:
                if v not in self._forward.get(k, set()):
                    return False
        return True
