"""Per-connection / per-task flight recorder: the last N structured events
before something died.

The transports and broker maps already log *that* a connection failed; what
the operator cannot see is what happened in the seconds BEFORE — was the
peer backpressured, mid-auth, waiting on a pool permit, replaying a sync?
Every :class:`pushcdn_tpu_torch.proto.transport.base.Connection` (and the
supervised background tasks) carries a :class:`FlightRecorder`: a
fixed-size ``collections.deque`` ring of ``(t_monotonic, event, detail)``
tuples — appends never allocate beyond the tuple itself and old events
fall off the far end, so the hot path pays one deque append per *event*
(connect/auth/subscribe/sync/backpressure/limiter-wait/error), never per
frame.

Dump policy: events marked ``abnormal`` arm the recorder; an armed
recorder's trail is written to the diagnostics log (``pushcdn.flightrec``)
when the owner tears the connection down (``maybe_dump``). A clean close
never logs. All live recorders are also readable on demand via
``GET /debug/flightrec`` on the metrics endpoint
(:func:`pushcdn_tpu_torch.proto.metrics.serve_metrics`).
"""

from __future__ import annotations

import collections
import logging
import time
import weakref
from typing import Optional

logger = logging.getLogger("pushcdn.flightrec")

DEFAULT_EVENTS = 64

# every live recorder, for the /debug/flightrec dump; weak so an abandoned
# connection's recorder disappears with it
_LIVE: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()


class FlightRecorder:
    """Fixed-size ring of structured events attached to one connection or
    task. Not thread-safe by design: the owner's event loop is the only
    writer (deque appends are atomic enough for the /debug reader)."""

    __slots__ = ("label", "abnormal", "_dumped", "_events", "__weakref__")

    def __init__(self, label: str, capacity: int = DEFAULT_EVENTS):
        self.label = label
        self.abnormal = False
        self._dumped = False
        self._events: collections.deque = collections.deque(maxlen=capacity)
        _LIVE.add(self)

    def record(self, event: str, detail="", abnormal: bool = False) -> None:
        """Append one event. ``detail`` is kept as-is (formatted only at
        dump time). ``abnormal=True`` arms the recorder: the next
        :meth:`maybe_dump` writes the whole trail to the log."""
        if abnormal:
            self.abnormal = True
        self._events.append((time.monotonic(), event, detail))

    def __len__(self) -> int:
        return len(self._events)

    def trail(self, max_events: Optional[int] = None) -> str:
        """The formatted trail: one line per event, age-relative.
        ``max_events`` keeps only the most recent N (the interesting end
        of the ring)."""
        now = time.monotonic()
        events = list(self._events)
        dropped = 0
        if max_events is not None and len(events) > max_events:
            dropped = len(events) - max_events
            events = events[-max_events:] if max_events > 0 else []
        lines = [f"flight recorder [{self.label}] "
                 f"({len(self._events)} events"
                 + (f", showing last {len(events)}" if dropped else "")
                 + ")"]
        for t, event, detail in events:
            if isinstance(detail, str):
                d = f"  {detail}" if detail else ""
            else:
                d = f"  {detail!r}"
            lines.append(f"  -{now - t:9.3f}s  {event}{d}")
        return "\n".join(lines)

    def dump(self, reason: str = "") -> None:
        """Unconditionally write the trail to the diagnostics log."""
        self._dumped = True
        logger.warning("abnormal disconnect%s:\n%s",
                       f" ({reason})" if reason else "", self.trail())

    def maybe_dump(self, reason: str = "") -> bool:
        """Dump the trail iff an abnormal event armed the recorder —
        AT MOST ONCE per recorder: a failed send poisons the connection
        (which dumps) and then removes the peer (which would dump the
        near-identical trail again). Disarms either way. Returns whether
        a dump happened."""
        if not self.abnormal:
            return False
        self.abnormal = False
        if self._dumped:
            return False
        self.dump(reason)
        return True


DEFAULT_RENDER_LIMIT = 10_000


def render_all(limit: Optional[int] = None) -> str:
    """Every live recorder's trail — the ``/debug/flightrec`` body.

    ``limit`` caps the TOTAL number of events rendered (default 10000,
    overridable via the endpoint's ``?limit=`` query): a broker holding
    tens of thousands of connections must not build an unbounded response
    body inside its event loop."""
    if limit is None:
        limit = DEFAULT_RENDER_LIMIT
    recs = sorted(_LIVE, key=lambda r: r.label)
    if not recs:
        return "0 flight recorders\n"
    out = [f"{len(recs)} flight recorders (event limit {limit})", ""]
    budget = max(limit, 0)
    shown = 0
    for r in recs:
        if budget <= 0:
            out.append(f"... truncated: {len(recs) - shown} more "
                       f"recorders past the {limit}-event limit "
                       "(raise ?limit=)")
            break
        out.append(r.trail(max_events=budget))
        budget -= min(len(r), budget)
        shown += 1
    return "\n".join(out) + "\n"


_task_recorder: Optional[FlightRecorder] = None


def task_recorder() -> FlightRecorder:
    """The per-process recorder shared by supervised background tasks
    (restarts and deaths are rare, global events — they don't need a ring
    per task)."""
    global _task_recorder
    if _task_recorder is None:
        _task_recorder = FlightRecorder("supervised-tasks", capacity=128)
    return _task_recorder
