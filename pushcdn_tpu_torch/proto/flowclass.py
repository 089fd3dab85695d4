"""Flow-class taxonomy for per-class accounting (ISSUE 19).

Every frame the data plane moves belongs to one of four classes —
the measurement substrate ROADMAP item 4's per-class egress lanes
schedule over:

    0  control    broker/protocol traffic (auth, subscribe, sync)
    1  consensus  latency-critical application topics
    2  live       default pub/sub fan-out (Direct is always live)
    3  bulk       retention replay / catch-up floods

Topics map to classes by NAME through the :class:`TopicNamespace`
hierarchy (``consensus.*`` -> consensus, ``bulk.*`` -> bulk, ...), and
the resolved map compiles to a flat u8[256] table the native route-plan
kernel indexes per frame (class of a Broadcast = class of its FIRST
topic byte). Python senders resolve through the same table so the
scalar and pumped paths account identically.

The taxonomy is deployment config, not routing state: the compiled
table survives route-snapshot rebuilds, and a topic with no opinion
defaults to ``live``.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np

CONTROL = 0
CONSENSUS = 1
LIVE = 2
BULK = 3

N_CLASSES = 4
CLASS_NAMES: Tuple[str, ...] = ("control", "consensus", "live", "bulk")

# consumed-but-delivered-nowhere marker in per-frame class arrays
# (pruned-empty broadcast / unknown-recipient drop) — mirrors
# route_plan.cpp's out_class contract
CLASS_NONE = 255

# namespace prefixes that imply a class; first match wins, checked
# against the first dot-separated segment of the topic's bound name
_PREFIX_CLASSES = (
    ("control", CONTROL),
    ("consensus", CONSENSUS),
    ("bulk", BULK),
    ("replay", BULK),
)


def class_name(cls: int) -> str:
    return CLASS_NAMES[cls] if 0 <= cls < N_CLASSES else "none"


def class_of_name(name: Optional[str]) -> int:
    """Class implied by a hierarchical topic name (``live`` default)."""
    if name:
        head = name.split(".", 1)[0]
        for prefix, cls in _PREFIX_CLASSES:
            if head == prefix:
                return cls
    return LIVE


def compile_table(namespace=None, overrides=None) -> np.ndarray:
    """Compile the u8[256] topic -> class table the native planner and
    the Python senders share.

    ``namespace`` is a :class:`~pushcdn_tpu_torch.proto.topic.TopicNamespace``
    (or None); every bound name contributes via :func:`class_of_name`.
    ``overrides`` maps raw topic ints to classes and wins over the
    namespace. Unmentioned topics are ``live``.
    """
    table = np.full(256, LIVE, np.uint8)
    if namespace is not None:
        for name, topic in namespace.bindings().items():
            if 0 <= topic <= 255:
                table[topic] = class_of_name(name)
    if overrides:
        for topic, cls in overrides.items():
            topic = int(topic)
            if 0 <= topic <= 255 and 0 <= int(cls) < N_CLASSES:
                table[topic] = int(cls)
    return table


_DEFAULT_TABLE = compile_table()

# process-wide active table: installed by the broker when it compiles
# its namespace, read by the scalar send paths. A flat module global —
# the hot paths index it with a single getitem.
_active_table: np.ndarray = _DEFAULT_TABLE


def install_table(table: np.ndarray) -> None:
    """Publish the active topic -> class table (u8[256])."""
    global _active_table
    table = np.ascontiguousarray(table, np.uint8)
    if table.shape == (256,):
        _active_table = table


def active_table() -> np.ndarray:
    return _active_table


def class_of_topics(topics) -> int:
    """Class of a Broadcast: its FIRST topic's class (``live`` when the
    topic list is empty) — the same rule route_plan.cpp applies."""
    for t in topics:
        t = int(t)
        if 0 <= t <= 255:
            return int(_active_table[t])
        break
    return LIVE


def frame_class(data) -> int:
    """Class of ONE serialized frame from its wire bytes — the shared
    sender/receiver rule the per-link conservation ledger tables use
    (ISSUE 20), so both ends of a mesh link classify identically:
    Broadcast → class of its first topic byte, Direct → ``live``, every
    other kind (auth / subscribe / sync / retained / control) →
    ``control``. Mirrors :func:`class_of_topics` and route_plan.cpp."""
    n = len(data)
    if not n:
        return CONTROL
    kind = data[0]
    if kind == 4 or kind == 0x84:        # Direct (plain / traced)
        return LIVE
    if kind == 5:                        # Broadcast: <u16 ntopics> topics
        if n >= 4 and (data[1] or data[2]):
            return int(_active_table[data[3]])
        return LIVE
    if kind == 0x85:                     # traced Broadcast (rare, sampled)
        try:
            from pushcdn_tpu_torch.proto.message import unpack_trace
            _tr, off = unpack_trace(memoryview(data), 1)
            if n >= off + 3 and (data[off] or data[off + 1]):
                return int(_active_table[data[off + 2]])
        except Exception:
            pass
        return LIVE
    return CONTROL


def bincount_classes(classes: np.ndarray, lens=None):
    """(frames[4], bytes[4]) over a per-frame class array (u8; values
    >= N_CLASSES — e.g. CLASS_NONE — are excluded). ``lens`` adds 4
    bytes of length header per frame, matching the wire accounting."""
    classes = np.asarray(classes)
    keep = classes < N_CLASSES
    kept = classes[keep]
    frames = np.bincount(kept, minlength=N_CLASSES)[:N_CLASSES]
    if lens is None:
        return frames, None
    weights = np.asarray(lens)[keep] + 4
    nbytes = np.bincount(kept, weights=weights,
                         minlength=N_CLASSES)[:N_CLASSES]
    return frames, nbytes.astype(np.int64)
