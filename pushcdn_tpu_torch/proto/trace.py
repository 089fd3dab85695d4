"""Sampled message-lifecycle tracing: where a message spends its time,
client publish → marshal auth → broker ingress → route plan → egress →
receiver delivery.

A *trace* is ``(trace_id, origin_ns)`` — a u64 id plus the wall-clock
nanosecond timestamp of the segment's origin. It rides the wire inside the
frame's kind byte: hot frames (Direct/Broadcast) and the marshal auth
frame may set the high bit (:data:`TRACE_FLAG`) of the kind tag, followed
by a fixed 16-byte ``<u64 trace_id, u64 origin_ns>`` block inserted right
after the kind byte. Untraced frames are byte-identical to the pre-trace
wire (the flag bit was reserved/always-zero: kind tags are 1-9), so they
pay **zero** bytes and zero decode work — every hot-path dispatch tests
the exact kind value and never sees a flagged frame.

Sampling is deterministic and client-side: every ``PUSHCDN_TRACE_SAMPLE``-th
published message is stamped (default 1024, i.e. 1/1024; ``0`` disables
tracing entirely). The first publish after a (re)connect reuses the
connection's trace id, which the marshal-auth span also carries — so one
cluster run always yields at least one COMPLETE chain
(auth → publish → ingress → plan → egress → delivery) under any sampling
rate.

Span emission is a histogram observe per hop
(``cdn_trace_hop_seconds{hop=...}``, latency measured from the trace
origin) plus an in-process ring (:data:`recent`) and an optional JSONL
log (``PUSHCDN_TRACE_LOG=/path/file.jsonl``) for cross-process chain
assembly. Traced frames cross the broker's cut-through plane on the
*instrumented scalar path*: the native header scan stops at the flag bit
(route_plan.cpp, same mechanism as the control-frame stop) so the rest of
the chunk keeps the batch path — the overhead of tracing is confined to
the sampled frames by construction.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Optional, Tuple

from pushcdn_tpu_torch.proto import metrics as metrics_mod
# the wire-level flag bit lives with the codec (single source of truth):
# kind-tag high bit = "a 16-byte trace block follows the kind byte". Legal
# on Direct/Broadcast (decoded by proto.message) and the marshal auth
# frame (handled here at the frame level); everything else treats a
# flagged kind as unknown (disconnect), exactly like a pre-trace node.
from pushcdn_tpu_torch.proto.message import (TRACE_BLOCK, TRACE_FLAG,
                                       pack_trace, unpack_trace)

KIND_MASK = 0x7F

TRACE_BLOCK_BYTES = TRACE_BLOCK.size  # 16 (<u64 trace_id, u64 origin_ns>)

# The lifecycle hops, in chain order.
HOPS = ("publish", "auth", "ingress", "plan", "egress", "delivery")

# (trace_id, origin_ns) or (trace_id, origin_ns, view): consensus-shaped
# workloads tag the u32 view number so per-view SLOs are derivable from
# the span log (see proto.message.TRACE_VIEW_FLAG for the wire encoding).
Trace = Tuple[int, ...]


def _env_sample() -> int:
    raw = os.environ.get("PUSHCDN_TRACE_SAMPLE", "").strip()
    if not raw:
        return 1024
    try:
        return max(int(raw), 0)
    except ValueError:
        return 1024


SAMPLE_EVERY = _env_sample()
ENABLED = SAMPLE_EVERY > 0

HOP_LATENCY = metrics_mod.TRACE_HOP_LATENCY
_HOP_CHILDREN = {hop: HOP_LATENCY.labels(hop=hop) for hop in HOPS}

# Last spans emitted IN THIS PROCESS: (hop, trace_id, origin_ns, t_ns,
# detail). Tests and debug tooling read this; cross-process chains use the
# JSONL log.
recent: collections.deque = collections.deque(maxlen=512)

_LOG_PATH = os.environ.get("PUSHCDN_TRACE_LOG") or None
_log_file = None


def set_log_path(path: Optional[str]) -> Optional[str]:
    """Redirect (or disable, with ``None``) the JSONL span log at runtime;
    returns the previous path. ``PUSHCDN_TRACE_LOG`` seeds the initial
    value at import; in-process drivers (testing.consensus) use this to
    capture spans without re-importing."""
    global _LOG_PATH, _log_file
    prev = _LOG_PATH
    if _log_file is not None:
        try:
            _log_file.close()
        except Exception:
            pass
        _log_file = None
    _LOG_PATH = path
    return prev


def _log(record: dict) -> None:
    global _log_file, _LOG_PATH
    if _log_file is None:
        try:
            _log_file = open(_LOG_PATH, "a", buffering=1)
        except OSError:
            _LOG_PATH = None  # never retry a broken path per span
            return
    try:
        _log_file.write(json.dumps(record, separators=(",", ":")) + "\n")
    except Exception:
        pass


def emit(hop: str, trace: Trace, detail: str = "") -> None:
    """Record one span: per-hop latency histogram + recent ring (+ JSONL
    when ``PUSHCDN_TRACE_LOG`` is set). ``trace`` is the carried
    ``(trace_id, origin_ns)`` or ``(trace_id, origin_ns, view)``; latency
    is wall-clock now minus origin (cross-process on one machine; clock
    skew applies across machines)."""
    tid, origin = trace[0], trace[1]
    view = trace[2] if len(trace) > 2 else None
    now = time.time_ns()
    lat = (now - origin) / 1e9
    if lat < 0.0:
        lat = 0.0
    child = _HOP_CHILDREN.get(hop)
    (child if child is not None
     else HOP_LATENCY.labels(hop=hop)).observe(lat)
    if hop == "delivery":
        # the SLO histogram: publish→delivery as the receiver saw it, with
        # an OpenMetrics exemplar pinning the bucket to this trace id
        metrics_mod.E2E_LATENCY.observe(
            lat, exemplar={"trace_id": f"{tid:016x}"})
    recent.append((hop, tid, origin, now, detail))
    if _LOG_PATH:
        record = {"hop": hop, "trace_id": tid, "origin_ns": origin,
                  "t_ns": now, "lat_s": round(lat, 9), "detail": detail}
        if view is not None:
            record["view"] = view
        _log(record)


def new_trace(view: Optional[int] = None) -> Trace:
    """A fresh trace context originating NOW, optionally view-tagged."""
    if view is None:
        return (_next_id(), time.time_ns())
    return (_next_id(), time.time_ns(), view)


_id_state = (os.getpid() << 40) ^ (time.time_ns() & 0xFFFFFFFFFF)


def _next_id() -> int:
    # splitmix64 step over a per-process seed: unique-enough u64 ids with
    # no coordination, cheap, and never 0
    global _id_state
    _id_state = (_id_state + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = _id_state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    z = z ^ (z >> 31)
    return z or 1


class Sampler:
    """Deterministic 1-in-N publish sampler (one per client). ``pending``
    is the connection trace id: the first sampled decision after a
    (re)connect is forced and reuses that id, chaining the auth span to a
    message lifecycle. ``view``, when set (consensus workloads), tags every
    sampled trace with the current view number."""

    __slots__ = ("every", "_n", "pending", "view")

    def __init__(self, every: int = SAMPLE_EVERY):
        self.every = every
        self._n = 0
        self.pending: Optional[int] = None
        self.view: Optional[int] = None

    def next_trace(self) -> Optional[Trace]:
        if self.every <= 0:
            return None
        if self.pending is not None:
            tid, self.pending = self.pending, None
            if self.view is None:
                return (tid, time.time_ns())
            return (tid, time.time_ns(), self.view)
        self._n += 1
        if self._n % self.every:
            return None
        return new_trace(self.view)


# -- frame-level stamp/strip (for frames whose decoded type carries no
#    trace seat, e.g. the marshal auth handshake) -----------------------


def stamp_frame(frame: bytes, trace: Trace) -> bytes:
    """Set the trace flag on a serialized frame: flagged kind byte + the
    16- or 20-byte (view-tagged) trace block + the original remainder."""
    return bytes((frame[0] | TRACE_FLAG,)) + pack_trace(trace) + frame[1:]


def strip_frame(frame) -> Tuple[bytes, Optional[Trace]]:
    """Inverse of :meth:`stamp_frame`: returns ``(plain_frame, trace)``
    with ``trace=None`` (and the input untouched) for unflagged frames."""
    if len(frame) < 1 + TRACE_BLOCK_BYTES or not frame[0] & TRACE_FLAG:
        return (frame if isinstance(frame, bytes) else bytes(frame)), None
    trace, off = unpack_trace(frame, 1)
    return bytes((frame[0] & KIND_MASK,)) + bytes(frame[off:]), trace
