"""Topic validation / pruning.

Capability parity with the reference's ``Topic`` trait (``prune()``
validation, cdn-proto/src/def.rs:31-51) and the ``TestTopic { Global=0,
DA=1 }`` example (def.rs:23-28). Topics are small ints on the wire
(``u8``, message.rs:26); a ``TopicSpace`` defines which values are valid.

On-device, a topic set is a bitmask over the topic space (one u32/u64 lane
per connection) — see pushcdn_tpu_torch.parallel.frames.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterable, List, Sequence


class TestTopic(enum.IntEnum):
    """The test topic space (parity def.rs:23-28)."""

    GLOBAL = 0
    DA = 1


class BoundedTopicMemo:
    """Bounded memo for pure functions of a topic tuple: only
    deployment-sized keys (<=16 topics) are retained — the wire allows
    65535 topics per message, and caching adversarial unique tuples
    would grow a memo into GiBs — and the table clears wholesale at
    4096 entries. One policy, shared by TopicSpace.prune and the device
    planes' TopicMaskCache."""

    __slots__ = ("_memo",)

    MAX_KEY_TOPICS = 16
    MAX_ENTRIES = 4096

    def __init__(self):
        self._memo = {}

    def get(self, topics, compute):
        """Return compute(key) memoized; ``key`` is the tuple form."""
        key = topics if type(topics) is tuple else tuple(topics)
        hit = self._memo.get(key)
        if hit is None:
            hit = compute(key)
            if len(key) <= self.MAX_KEY_TOPICS:
                if len(self._memo) >= self.MAX_ENTRIES:
                    self._memo.clear()
                self._memo[key] = hit
        return hit

    def __len__(self):
        return len(self._memo)


@dataclass(frozen=True)
class TopicSpace:
    """The set of valid topic values for a deployment.

    ``prune`` mirrors def.rs:37-51: strip unknown values, dedupe, and report
    whether anything was removed — the broker disconnects users that sent
    *only* invalid topics (tasks/user/handler.rs topic pruning).
    """

    valid: frozenset[int]

    def __post_init__(self):
        # prune() runs once per received broadcast on every broker, and
        # deployments publish a handful of distinct topic sets — memoize
        object.__setattr__(self, "_prune_memo", BoundedTopicMemo())

    @classmethod
    def from_enum(cls, topic_enum) -> "TopicSpace":
        return cls(frozenset(int(t) for t in topic_enum))

    @classmethod
    def range(cls, n: int) -> "TopicSpace":
        """Topic space 0..n-1 (bitmask-friendly; n ≤ 256)."""
        return cls(frozenset(range(n)))

    def prune(self, topics: Sequence[int]) -> tuple[tuple, bool]:
        """Return (valid-deduped-topics, had_invalid). The topic
        sequence comes back as an immutable TUPLE: results are shared by
        the memo, and a tuple makes that structurally safe."""
        def compute(key):
            seen = set()
            out: List[int] = []
            had_invalid = False
            for t in key:
                t = int(t)
                if t not in self.valid:
                    had_invalid = True
                    continue
                if t not in seen:
                    seen.add(t)
                    out.append(t)
            return tuple(out), had_invalid

        return self._prune_memo.get(topics, compute)

    def bitmask(self, topics: Iterable[int]) -> int:
        """Pack a topic set into an int bitmask (device representation)."""
        mask = 0
        for t in topics:
            mask |= 1 << int(t)
        return mask


class TopicNamespace:
    """Hierarchical names over the integer topic space (durable topics,
    ISSUE 14): ``consensus.view.3`` binds to one wire-level u8 topic, and
    a wildcard pattern (``consensus.view.*``) compiles to the set of
    bound topics it covers.

    Wildcards never reach the route planes: a wildcard subscription is
    resolved here into plain per-topic interest-mask updates, and a
    *watch* keeps it live — every later :meth:`bind` / :meth:`unbind`
    fires the watch callbacks, so the union is maintained incrementally
    (the same shape as RaggedInterest page maintenance). The native
    route-plan kernel and the scalar/sharded twins only ever see the
    compiled mask.

    Pattern grammar: dot-separated segments; ``*`` matches exactly one
    segment, except a FINAL ``*`` which matches one or more trailing
    segments (so ``consensus.view.*`` covers ``consensus.view.3`` and
    ``consensus.view.3.retry``).
    """

    __slots__ = ("space", "_by_name", "_by_topic", "_watches", "_next_watch")

    def __init__(self, space: TopicSpace | None = None):
        self.space = space
        self._by_name: dict[str, int] = {}
        self._by_topic: dict[int, str] = {}
        # watch id -> (pattern segments, on_add, on_remove)
        self._watches: dict[int, tuple] = {}
        self._next_watch = 0

    # -- binding --------------------------------------------------------

    def bind(self, name: str, topic: int | None = None) -> int:
        """Bind ``name`` to ``topic`` (auto-allocates the smallest free
        valid topic when omitted). Idempotent for an identical re-bind;
        a conflicting re-bind raises ``ValueError``. Fires matching
        watches' ``on_add(name, topic)``."""
        if not name or name != name.strip("."):
            raise ValueError(f"invalid topic name {name!r}")
        bound = self._by_name.get(name)
        if bound is not None:
            if topic is not None and topic != bound:
                raise ValueError(
                    f"{name!r} already bound to topic {bound}, not {topic}")
            return bound
        if topic is None:
            universe = (sorted(self.space.valid) if self.space is not None
                        else range(256))
            for cand in universe:
                if cand not in self._by_topic:
                    topic = cand
                    break
            else:
                raise ValueError("topic space exhausted")
        else:
            if self.space is not None and topic not in self.space.valid:
                raise ValueError(f"topic {topic} outside the topic space")
            other = self._by_topic.get(topic)
            if other is not None:
                raise ValueError(f"topic {topic} already bound to {other!r}")
        self._by_name[name] = topic
        self._by_topic[topic] = name
        segs = name.split(".")
        for pat, on_add, _ in list(self._watches.values()):
            if on_add is not None and self._segs_match(pat, segs):
                on_add(name, topic)
        return topic

    def unbind(self, name: str) -> None:
        """Drop a binding; fires matching watches' ``on_remove``."""
        topic = self._by_name.pop(name, None)
        if topic is None:
            return
        del self._by_topic[topic]
        segs = name.split(".")
        for pat, _, on_remove in list(self._watches.values()):
            if on_remove is not None and self._segs_match(pat, segs):
                on_remove(name, topic)

    def topic_of(self, name: str):
        return self._by_name.get(name)

    def name_of(self, topic: int):
        return self._by_topic.get(topic)

    def bindings(self) -> dict[str, int]:
        return dict(self._by_name)

    # -- wildcard compilation -------------------------------------------

    @staticmethod
    def _segs_match(pat: list, segs: list) -> bool:
        np = len(pat)
        if np == 0:
            return False
        tail_glob = pat[-1] == "*"
        if tail_glob:
            if len(segs) < np:           # final * eats one-or-more
                return False
        elif len(segs) != np:
            return False
        for p, s in zip(pat[:-1] if tail_glob else pat, segs):
            if p != "*" and p != s:
                return False
        return True

    def match(self, pattern: str) -> tuple:
        """Compile ``pattern`` to the sorted tuple of bound topics it
        covers right now (a plain name is its own 1-element pattern)."""
        pat = pattern.split(".")
        return tuple(sorted(
            t for n, t in self._by_name.items()
            if self._segs_match(pat, n.split("."))))

    # -- live watches ---------------------------------------------------

    def watch(self, pattern: str, on_add=None, on_remove=None) -> int:
        """Register callbacks fired on every future bind/unbind matching
        ``pattern``; returns a handle for :meth:`unwatch`."""
        self._next_watch += 1
        self._watches[self._next_watch] = (pattern.split("."),
                                           on_add, on_remove)
        return self._next_watch

    def unwatch(self, handle: int) -> None:
        self._watches.pop(handle, None)


TEST_TOPIC_SPACE = TopicSpace.from_enum(TestTopic)
