"""Shared device-pump machinery:

- the adaptive coalescing gate (step immediately on bursts-after-idle and
  saturated pipelines; wait one window for a steady sub-threshold
  trickle),
- the user-table slice mark (round the slot high-water up to a bucket so
  delivery matrices, their device-to-host copies and the egress scans
  pay for the actual population),
- the revision-keyed device-state cache (steady state uploads no user
  table),
- the per-plane topic-list → mask memo,
- the egress of a step: its delivery matrices encoded into per-user wire
  streams by the native engine (``native.egress_encode``), or, where the
  library is absent on the CPU and for the ragged step's pairs, the
  delivered frames walked from the step's host snapshot.
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Optional

from pushcdn_tpu_torch import native
from pushcdn_tpu_torch.parallel.frames import mask_of_topics
from pushcdn_tpu_torch.proto import metrics as metrics_mod

# user-table slice granularity
U_ROUND = 64


def effective_users(high_water: int, capacity: int,
                    round_to: int = U_ROUND) -> int:
    """Slice mark for the user table: ``high_water`` rounded up to a
    bucket, clamped to capacity, at least one bucket."""
    return min(capacity, max(round_to,
                             -(-high_water // round_to) * round_to))


class CoalesceGate:
    """The latency/step-efficiency knob as one decision point.

    A step fires immediately when staged traffic reaches
    ``coalesce_min_frames`` OR when the pump has been idle (a burst after
    quiet pays no window at all); a steady trickle below the threshold
    waits one ``batch_window_s`` to amortise step dispatch.
    """

    __slots__ = ("batch_window_s", "coalesce_min_frames", "last_step_t")

    def __init__(self, batch_window_s: float, coalesce_min_frames: int):
        self.batch_window_s = batch_window_s
        self.coalesce_min_frames = coalesce_min_frames
        self.last_step_t = -1e9

    def wait_s(self, staged: int, now: float) -> float:
        """Seconds to coalesce before stepping (0 = step now)."""
        if staged and staged < self.coalesce_min_frames and \
                now - self.last_step_t < 4 * self.batch_window_s:
            return self.batch_window_s
        return 0.0

    def stepped(self, now: float) -> None:
        self.last_step_t = now


class RevCache:
    """Revision-keyed single-entry cache for device-resident state: the
    builder runs only when the revision moved (mirror mutations bump it),
    so unchanged user tables cost no upload per step."""

    __slots__ = ("_rev", "_value")

    def __init__(self):
        self._rev: Optional[int] = None
        self._value: Any = None

    def get(self, rev: Optional[int], build: Callable[[], Any]) -> Any:
        """Return the cached value when ``rev`` matches; otherwise build,
        and cache iff ``rev`` is not None (a throwaway state passes None
        so it never masks the first real upload)."""
        if rev is not None and rev == self._rev and self._value is not None:
            return self._value
        value = build()
        if rev is not None:
            self._rev = rev
            self._value = value
        return value


class TopicMaskCache:
    """Per-plane memo of topic-list -> (mask, any_out_of_range). Only
    deployment-sized keys (<= 16 topics) are kept — the wire allows 65535
    topics per message, and caching adversarial unique tuples would grow
    without bound — and the table clears wholesale at 4096 entries."""

    __slots__ = ("words", "_memo")

    MAX_KEY_TOPICS = 16
    MAX_ENTRIES = 4096

    def __init__(self, topic_words: int):
        self.words = topic_words
        self._memo: dict = {}

    def resolve(self, topics):
        key = topics if type(topics) is tuple else tuple(topics)
        hit = self._memo.get(key)
        if hit is None:
            limit = 32 * self.words
            hit = (mask_of_topics(key, self.words),
                   any(int(t) >= limit for t in key))
            if len(key) <= self.MAX_KEY_TOPICS:
                if len(self._memo) >= self.MAX_ENTRIES:
                    self._memo.clear()
                self._memo[key] = hit
        return hit


def egress_snapshot_frames(broker, slots, users, frames, length,
                           bytes_) -> int:
    """Queue delivered frames to ``broker``'s users, non-blocking: pair
    ``i`` sends row ``frames[i]`` of the host snapshot ``bytes_`` (its
    first ``length[frames[i]]`` bytes) to user slot ``users[i]`` of
    ``slots``, pairs grouped per user. One ``Bytes`` per frame is shared
    by its receivers and released after the walk. Returns the number of
    frames queued."""
    from pushcdn_tpu_torch.broker.tasks.senders import egress_delivery_rows
    from pushcdn_tpu_torch.proto.limiter import Bytes
    cache: dict = {}

    def frame_of(f: int) -> Bytes:
        raw = cache.get(f)
        if raw is None:
            raw = cache[f] = Bytes(bytes_[f, :length[f]].tobytes())
        return raw

    try:
        return egress_delivery_rows(broker, slots, users, frames, frame_of)
    finally:
        for raw in cache.values():
            raw.release()


class EncodedEgress(NamedTuple):
    """One delivery matrix of a step, encoded: ``streams`` holds the
    per-user wire streams (``native.EgressStreams``) for the users of
    shard ``shard`` (0 on a single-shard plane)."""

    shard: int
    streams: Any


def require_native_egress(what: str) -> None:
    """A plane on the card egresses through the native engine or not at
    all: raise, naming ``what``, when the library did not build or
    load."""
    if not native.available():
        raise RuntimeError(
            f"{what} on the card requires the native egress engine, which "
            f"did not build or load: {native.build_errors()}")


def encode_egress(deliver, lengths, blocks, strict: bool):
    """Encode one delivery matrix (bool[U, N]) into per-user wire streams
    with ``native.egress_encode``; frame ``n`` is row ``n % rows`` of
    ``blocks[n // rows]`` and ``lengths[n]`` bytes long. The call is timed
    into ``cdn_native_seconds{kernel="egress_encode"}``. Returns None when
    the library is absent, and raises instead when ``strict`` (a plane on
    the card)."""
    t0 = time.perf_counter()
    streams = native.egress_encode(deliver, lengths, blocks)
    metrics_mod.NATIVE_EGRESS_SECONDS.inc(time.perf_counter() - t0)
    if streams is None and strict:
        require_native_egress("a device plane's egress")
        raise RuntimeError("native.egress_encode answered None")
    return streams


def egress_job(broker, slots, job) -> int:
    """Queue one egress job of a step to ``broker``'s users: an
    :class:`EncodedEgress` as one pre-framed stream per user
    (``senders.egress_streams``), a job of pairs (``users``, ``frames``,
    ``length``, ``bytes_``) through :func:`egress_snapshot_frames`.
    Returns the number of frames queued."""
    if isinstance(job, EncodedEgress):
        from pushcdn_tpu_torch.broker.tasks.senders import egress_streams
        return egress_streams(broker, slots, job.streams)
    return egress_snapshot_frames(broker, slots, job.users, job.frames,
                                  job.length, job.bytes_)
