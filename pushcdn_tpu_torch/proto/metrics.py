"""Metrics: Prometheus-style text exposition over HTTP + core gauges.

Capability parity with cdn-proto/src/metrics.rs:18-78 (warp `/metrics`
endpoint, 30 s running-latency gauge computed from histogram deltas) and
cdn-proto/src/connection/metrics.rs:12-28 (BYTES_SENT / BYTES_RECV gauges,
LATENCY histogram of permit-allocation lifetime).

Dependency-free: a tiny registry + asyncio HTTP server producing the
Prometheus text format. Metrics are always collected (cheap int adds); the
endpoint is opt-in per binary, matching the reference's `metrics` feature.

Label support (ISSUE 4 registry upgrade): every metric type takes an
optional ``labels=(...)`` tuple of label NAMES; ``m.labels(name=value)``
returns (creating on first use) a child series that renders as
``name{label="value"} v`` and exposes the same mutator API — call sites
hold the child and pay a plain attribute call per update, exactly like
before. A labeled Counter also renders a bare total line (own value + the
children's sum) so pre-label dashboards keep working.

Thread-safety: mutators (``inc``/``set``/``observe``) and child creation
take one process-wide lock — native-code callers and bench threads observe
from off-loop threads, and an unlocked ``Histogram.observe`` loses updates
in its sum/bucket read-modify-write. The lock is uncontended in steady
state (hot paths update per *batch*, not per frame) and a render takes it
per-metric, so a scrape racing live updates sees each metric atomically.
"""

from __future__ import annotations

import asyncio
import logging
import os
import re
import sys
import threading
import time
from typing import Dict, List, Optional

_LOCK = threading.Lock()


def _escape_label(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


class _LabeledMixin:
    """Shared child-series machinery. ``self._label_names`` is the declared
    label-name tuple (empty = unlabeled); ``self._labels`` is this series'
    own rendered ``k="v"`` pair string (children only)."""

    def _init_labels(self, labels) -> None:
        self._label_names = tuple(labels)
        self._labels = ""
        self._children: Dict[tuple, "_LabeledMixin"] = {}

    def labels(self, **kv):
        """The child series for these label values (create on first use).
        Raises ``KeyError`` on a label name that was not declared."""
        try:
            key = tuple(str(kv[n]) for n in self._label_names)
        except KeyError:
            raise KeyError(f"{self.name}: labels() requires exactly "
                           f"{self._label_names}, got {tuple(kv)}") from None
        if len(kv) != len(self._label_names):
            raise KeyError(f"{self.name}: labels() requires exactly "
                           f"{self._label_names}, got {tuple(kv)}")
        child = self._children.get(key)
        if child is None:
            with _LOCK:
                child = self._children.get(key)
                if child is None:
                    child = self._new_child()
                    child._labels = ",".join(
                        f'{n}="{_escape_label(v)}"'
                        for n, v in zip(self._label_names, key))
                    self._children[key] = child
        return child

    def _sorted_children(self):
        return [self._children[k] for k in sorted(self._children)]


class Counter(_LabeledMixin):
    """Monotonic counter (exposed as prometheus counter)."""

    def __init__(self, name: str, help_: str, labels=()):
        self.name = name
        self.help = help_
        self.value = 0
        self._init_labels(labels)
        _REGISTRY[name] = self

    def _new_child(self) -> "Counter":
        child = Counter.__new__(Counter)
        child.name, child.help, child.value = self.name, self.help, 0
        child._init_labels(())
        return child

    def inc(self, n: int = 1) -> None:
        with _LOCK:
            self.value += n

    def render(self, openmetrics: bool = False) -> str:
        # OpenMetrics mandates the _total suffix on counter SAMPLES (the
        # family name in TYPE/HELP stays bare); a strict OM parser —
        # Prometheus negotiates OM by default — rejects the whole scrape
        # otherwise. Plain 0.0.4 scrapes keep the historical bare names.
        suffix = "_total" if openmetrics else ""
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} counter"]
        with _LOCK:
            total = self.value
            for child in self._sorted_children():
                total += child.value
                out.append(f"{self.name}{suffix}{{{child._labels}}}"
                           f" {child.value}")
            out.append(f"{self.name}{suffix} {total}")
        return "\n".join(out) + "\n"


def inc_each(counters, amounts) -> None:
    """Add ``amounts`` to ``counters`` pairwise under one take of the lock:
    a batch of one caller's counters (a pump iteration's phases)."""
    with _LOCK:
        for counter, n in zip(counters, amounts):
            counter.value += n


class Gauge(_LabeledMixin):
    """Settable gauge."""

    def __init__(self, name: str, help_: str, labels=()):
        self.name = name
        self.help = help_
        self.value = 0.0
        self._init_labels(labels)
        _REGISTRY[name] = self

    def _new_child(self) -> "Gauge":
        child = Gauge.__new__(Gauge)
        child.name, child.help, child.value = self.name, self.help, 0.0
        child._init_labels(())
        return child

    def set(self, v: float) -> None:
        with _LOCK:
            self.value = v

    def inc(self, n: float = 1) -> None:
        with _LOCK:
            self.value += n

    def dec(self, n: float = 1) -> None:
        with _LOCK:
            self.value -= n

    def render(self) -> str:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        with _LOCK:
            for child in self._sorted_children():
                out.append(f"{self.name}{{{child._labels}}} {child.value}")
            if not self._label_names:
                out.append(f"{self.name} {self.value}")
            elif not self._children:
                # labeled gauge with no series yet: render nothing (a bare
                # 0 under set-semantics would be a lie)
                pass
        return "\n".join(out) + "\n"


class Histogram(_LabeledMixin):
    """Fixed-bucket histogram (seconds).

    Optional OpenMetrics exemplars: ``observe(v, exemplar={...})`` pins the
    given label dict (e.g. ``{"trace_id": "ab12..."}``) to the bucket the
    sample landed in; an OpenMetrics-negotiated scrape renders each
    bucket's most recent exemplar as ``# {trace_id="..."} value ts`` so a
    dashboard can jump from a latency bucket straight to the trace that
    populated it."""

    DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)

    def __init__(self, name: str, help_: str, buckets=DEFAULT_BUCKETS,
                 labels=()):
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.total = 0
        self.exemplars: List[Optional[tuple]] = [None] * (len(self.buckets) + 1)
        self._init_labels(labels)
        _REGISTRY[name] = self

    def _new_child(self) -> "Histogram":
        child = Histogram.__new__(Histogram)
        child.name, child.help = self.name, self.help
        child.buckets = self.buckets
        child.counts = [0] * (len(self.buckets) + 1)
        child.sum = 0.0
        child.total = 0
        child.exemplars = [None] * (len(self.buckets) + 1)
        child._init_labels(())
        return child

    def observe(self, v: float, exemplar: Optional[dict] = None) -> None:
        # The whole update is one critical section: sum/total/bucket are a
        # multi-step read-modify-write, and off-loop observers (native-code
        # callers, bench threads) would otherwise lose samples against the
        # event loop's updates.
        if exemplar is not None:
            exemplar = ("{" + ",".join(
                f'{k}="{_escape_label(val)}"'
                for k, val in exemplar.items()) + "}", v, time.time())
        with _LOCK:
            self.sum += v
            self.total += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    if exemplar is not None:
                        self.exemplars[i] = exemplar
                    return
            self.counts[-1] += 1
            if exemplar is not None:
                self.exemplars[-1] = exemplar

    def _render_series(self, out: List[str], labels: str,
                       exemplars: bool = False) -> None:
        sep = f"{labels}," if labels else ""
        cum = 0
        for i, (b, c) in enumerate(zip(self.buckets, self.counts)):
            cum += c
            line = f'{self.name}_bucket{{{sep}le="{b}"}} {cum}'
            ex = self.exemplars[i] if exemplars else None
            if ex is not None:
                line += f" # {ex[0]} {ex[1]} {ex[2]:.3f}"
            out.append(line)
        line = f'{self.name}_bucket{{{sep}le="+Inf"}} {self.total}'
        ex = self.exemplars[-1] if exemplars else None
        if ex is not None:
            line += f" # {ex[0]} {ex[1]} {ex[2]:.3f}"
        out.append(line)
        tail = f"{{{labels}}}" if labels else ""
        out.append(f"{self.name}_sum{tail} {self.sum}")
        out.append(f"{self.name}_count{tail} {self.total}")

    def render(self, exemplars: bool = False) -> str:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with _LOCK:
            for child in self._sorted_children():
                child._render_series(out, child._labels, exemplars)
            if not self._label_names:
                self._render_series(out, "", exemplars)
        return "\n".join(out) + "\n"


_REGISTRY: Dict[str, object] = {}
_BACKGROUND_TASKS: List[asyncio.Task] = []  # keep refs so GC can't kill them

# Core connection metrics (parity connection/metrics.rs:13-28, incremented
# by the transport layer at frame write/read). Labeled per transport — the
# connection caches its child at construction, so the hot path still pays
# one plain ``inc`` per flush.
BYTES_SENT = Counter("cdn_bytes_sent", "Total bytes written to peers",
                     labels=("transport",))
BYTES_RECV = Counter("cdn_bytes_received", "Total bytes read from peers",
                     labels=("transport",))
# The synchronous part of a stream write (over TCP+TLS, where asyncio's
# SSL transport encrypts and hands the bytes to the socket), per
# transport as BYTES_SENT: the connection hands its child to its stream,
# which adds one stamp pair per flush; the drain's wait is not counted.
STREAM_WRITE_SECONDS = Counter(
    "cdn_stream_write_seconds",
    "Cumulative seconds inside stream writes before the drain: the copy "
    "and the transport's write (TLS encryption included)",
    labels=("transport",))
LATENCY = Histogram("cdn_message_latency_seconds",
                    "Permit-allocation lifetime: receive -> last fan-out send")
RUNNING_LATENCY = Gauge("cdn_running_latency_seconds",
                        "30s running average message latency")


def observe_message_latency(seconds: float) -> None:
    LATENCY.observe(seconds)


# Cut-through routing plane (broker/tasks/cutthrough.py): one native plan
# call routes a whole FrameChunk without per-frame Python. The histogram
# buckets are FRAME COUNTS per plan call, not seconds. The three per-path
# frame counters are one labeled family; the module attributes below are
# the cached children, so call sites stay `ROUTE_*_FRAMES.inc(n)`.
ROUTE_BATCH_SIZE = Histogram(
    "cdn_route_batch_size_frames",
    "Frames covered by one cut-through route-plan call",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096))
ROUTE_FRAMES = Counter(
    "cdn_route_batch_frames",
    "Frames routed, by path: cutthrough = native plan (no per-frame "
    "Python), residual = handed to the scalar path by the plan (control/"
    "traced/malformed frames, depth-1 singles), scalar = routed entirely "
    "by the scalar receive loops",
    labels=("path",))
ROUTE_CUTTHROUGH_FRAMES = ROUTE_FRAMES.labels(path="cutthrough")
ROUTE_RESIDUAL_FRAMES = ROUTE_FRAMES.labels(path="residual")
ROUTE_SCALAR_FRAMES = ROUTE_FRAMES.labels(path="scalar")
# path=pump: the fused native pump planned AND sent the batch's hot
# frames (linked send SQEs prepped in C — zero Python per frame); a
# batch where every pair escalated still counts under path=cutthrough
ROUTE_PUMP_FRAMES = ROUTE_FRAMES.labels(path="pump")
PUMP_ESCALATIONS = Counter(
    "cdn_pump_escalations",
    "Frames (or whole batches, reason=control) the fused data-plane "
    "pump handed back to the Python path, by reason: unengaged = peer "
    "has no native slot (engagement is requested and happens at its "
    "next idle), fenced = a Python writer queue owns the peer's "
    "ordering right now, peer_error = a previous pumped chain errored, "
    "peer_error_event = a chain error disengaged a peer, chunk_slots = "
    "all native chunk-lease slots busy, control = a control/traced/"
    "malformed frame stopped the batch (scalar semantics), capacity = "
    "native peer table full at engagement",
    labels=("reason",))
ROUTE_TABLE_REBUILDS = Counter(
    "cdn_route_table_rebuilds",
    "Cut-through snapshot FULL rebuilds, by reason: first_build = cold "
    "start, version_gap = the delta log was trimmed past this snapshot's "
    "cursor, delta_overflow = more pending deltas than a rebuild costs, "
    "compaction = lazy-deletion garbage crossed the purge threshold, "
    "growth = peer slot capacity exhausted, retry = previous build "
    "failed allocation, incremental_disabled = the rebuild-per-"
    "invalidation baseline (PUSHCDN_ROUTE_INCREMENTAL=0)",
    labels=("reason",))
ROUTE_DELTAS_APPLIED = Counter(
    "cdn_route_deltas_applied",
    "Typed route deltas applied IN PLACE to the cut-through snapshot "
    "(the incremental alternative to a full rebuild, ISSUE 7)")
ROUTE_DELTA_APPLY_SECONDS = Histogram(
    "cdn_route_delta_apply_seconds",
    "Latency of one batched in-place delta application (Connections "
    "route-log suffix -> native table), O(delta) by construction",
    buckets=(1e-6, 5e-6, 1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.05, 0.5))

# Admission control / overload shedding (ISSUE 7): work REFUSED to keep
# the event loop alive, by tier. Every shed also records a flight-recorder
# event and flips the broker's /readyz "admission" check for
# PUSHCDN_SHED_READY_S so the load balancer steers away.
ROUTE_SHED = Counter(
    "cdn_route_shed_total",
    "Load-shed decisions by tier: user_conn / broker_conn = connection "
    "budget exceeded (PUSHCDN_MAX_CONNS_*), subscribe = per-connection "
    "subscribe/unsubscribe token bucket exhausted "
    "(PUSHCDN_SUBSCRIBE_RATE)",
    labels=("tier",))
ROUTE_SHED_USER_CONN = ROUTE_SHED.labels(tier="user_conn")
ROUTE_SHED_BROKER_CONN = ROUTE_SHED.labels(tier="broker_conn")
ROUTE_SHED_SUBSCRIBE = ROUTE_SHED.labels(tier="subscribe")

# Sharded data plane (broker/sharding.py): cross-shard handoff accounting.
# path=ring is the zero-copy shared-memory fast path; path=fallback is the
# counted drop-to-control-plane relay a full ring degrades to (the drain
# never blocks on a slow sibling).
SHARD_HANDOFF_RECORDS = Counter(
    "cdn_shard_handoff_records",
    "Cross-shard handoff records by path (ring = shared-memory, "
    "fallback = control-plane relay after ring-full)",
    labels=("path",))
SHARD_HANDOFF_RING = SHARD_HANDOFF_RECORDS.labels(path="ring")
SHARD_HANDOFF_FALLBACK = SHARD_HANDOFF_RECORDS.labels(path="fallback")
SHARD_HANDOFF_SHED = SHARD_HANDOFF_RECORDS.labels(path="shed")
SHARD_HANDOFF_FRAMES = Counter(
    "cdn_shard_handoff_frames",
    "Frames carried by cross-shard handoff records", labels=("path",))
SHARD_HANDOFF_FRAMES_RING = SHARD_HANDOFF_FRAMES.labels(path="ring")
SHARD_HANDOFF_FRAMES_FALLBACK = SHARD_HANDOFF_FRAMES.labels(path="fallback")
SHARD_HANDOFF_FRAMES_SHED = SHARD_HANDOFF_FRAMES.labels(path="shed")
SHARD_RING_TORN = Counter(
    "cdn_shard_ring_torn_reads",
    "Cross-shard ring drains that backed off on a torn/uncommitted record")
SHARD_RING_POISONED = Counter(
    "cdn_shard_ring_poisoned",
    "Inbound rings abandoned because a record never committed (producer "
    "died mid-push or slot corruption); traffic falls back to the relay")
SHARD_DELTAS_APPLIED = Counter(
    "cdn_shard_deltas_applied",
    "Control-plane interest deltas applied from sibling shards")

# Egress fan-out accounting by peer type (EgressBatch.flush / the
# cut-through _send_plan increment batch-wise).
EGRESS_FRAMES = Counter(
    "cdn_egress_frames",
    "Frames handed to connection writers, by destination peer type",
    labels=("peer",))
EGRESS_FRAMES_USER = EGRESS_FRAMES.labels(peer="user")
EGRESS_FRAMES_BROKER = EGRESS_FRAMES.labels(peer="broker")

# Writer-queue depth across live connections (refreshed at render by a
# pre-render hook over the transport layer's connection registry) and
# event-loop lag (sampled by a supervised background task).
WRITER_QUEUE_DEPTH = Gauge(
    "cdn_writer_queue_depth",
    "Entries waiting in connection send queues (stat=sum|max across "
    "live connections)",
    labels=("stat",))
EVENT_LOOP_LAG = Gauge(
    "cdn_event_loop_lag_seconds",
    "How late the event loop ran a sleep(0.25) wakeup (scheduling lag)")

# Global memory-pool occupancy (refreshed at render from the limiter's
# live-pool registry).
POOL_BYTES = Gauge(
    "cdn_pool_bytes",
    "Global byte-pool permit accounting across live pools "
    "(state=in_use|capacity)",
    labels=("state",))

# -- per-class flow accounting (ISSUE 19) -----------------------------------
# Classes come from proto/flowclass.py (0=control 1=consensus 2=live
# 3=bulk). dir=out counts fan-out deliveries (one per (frame, peer)
# pair, stamped BEFORE the connection lookup so the scalar, cut-through
# and pumped paths count identically); dir=in counts consumed ingress
# frames. Both the Python writer and the native pump feed the same
# families, so the split stays comparable across engagement changes.
_CLASS_NAMES = ("control", "consensus", "live", "bulk")
CLASS_FRAMES = Counter(
    "cdn_class_frames",
    "Frames moved per flow class (dir=in consumed ingress, dir=out "
    "fan-out deliveries; taxonomy per proto/flowclass.py)",
    labels=("class", "dir"))
CLASS_BYTES = Counter(
    "cdn_class_bytes",
    "Wire bytes (payload + 4-byte length header) per flow class",
    labels=("class", "dir"))
CLASS_FRAMES_OUT = tuple(CLASS_FRAMES.labels(**{"class": c, "dir": "out"})
                         for c in _CLASS_NAMES)
CLASS_FRAMES_IN = tuple(CLASS_FRAMES.labels(**{"class": c, "dir": "in"})
                        for c in _CLASS_NAMES)
CLASS_BYTES_OUT = tuple(CLASS_BYTES.labels(**{"class": c, "dir": "out"})
                        for c in _CLASS_NAMES)
CLASS_BYTES_IN = tuple(CLASS_BYTES.labels(**{"class": c, "dir": "in"})
                       for c in _CLASS_NAMES)

WRITER_QUEUE_DELAY = Histogram(
    "cdn_writer_queue_delay_seconds",
    "Head-of-line delay per flow class: writer-queue enqueue -> the "
    "writer loop dequeuing the entry (the ROADMAP item-4 scheduling "
    "input; inline fast-path sends never queue and are not observed)",
    buckets=(1e-6, 1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.2,
             0.3, 0.5, 0.75, 1.0, 2.0, 5.0),
    labels=("class",))
WRITER_QUEUE_DELAY_CLS = tuple(WRITER_QUEUE_DELAY.labels(**{"class": c})
                               for c in _CLASS_NAMES)

# Per-peer writer-queue depth: the top-K deepest connections by label,
# refreshed at render. The rest fold into peer="other"; the family's
# cardinality is capped like the task profiler's (a runaway connection
# churn must not bloat every scrape forever).
WRITER_QUEUE_DEPTH_PEER = Gauge(
    "cdn_writer_queue_depth_peer",
    "Send-queue depth of the deepest live connections (top-K by depth; "
    "the rest aggregate under peer=\"other\")",
    labels=("peer",))

# Retention / replay observability (ISSUE 19 tentpole 3): refreshed at
# render by broker/retention.py's pre-render hook over live stores.
RETENTION_RING_BYTES = Gauge(
    "cdn_retention_ring_bytes",
    "Payload bytes resident in durable-topic retention rings",
    labels=("topic",))
RETENTION_RING_ENTRIES = Gauge(
    "cdn_retention_ring_entries",
    "Entries resident in durable-topic retention rings",
    labels=("topic",))
RETENTION_EVICTIONS = Counter(
    "cdn_retention_evictions",
    "Retention-ring evictions by reason (bytes = per-topic byte budget, "
    "entries = per-topic entry budget, age = max-age expiry)",
    labels=("reason",))
REPLAY_LAG = Gauge(
    "cdn_replay_lag_entries",
    "Entries between a replaying subscriber's cursor and the retention "
    "ring head (top-K laggards; the rest aggregate under "
    "subscriber=\"other\")",
    labels=("subscriber",))


# -- native shm telemetry (ISSUE 19 tentpole 1) -----------------------------
# The uring engine + fused pump accumulate log2-ns histograms into a
# lock-free shared block written from C (zero hot-path Python). A
# pre-render hook (registered by proto/transport/uring.py) snapshots it
# and pushes the aggregate here; these classes only RENDER.

# rendered bucket window: fold sub-256ns into the first bucket's
# cumulative count, stop explicit buckets at ~1100s (the remainder only
# shows in +Inf) — a fixed layout so scrapes compare across processes
_TM_LO_BUCKET = 8
_TM_HI_BUCKET = 40


class _NativeLog2Histogram:
    """Prometheus histogram family rendered from a native log2-ns
    telemetry snapshot. ``update`` replaces a label's series wholesale
    (the native block is the source of truth; values are monotonic
    because closing engines fold their final snapshot into a carry)."""

    def __init__(self, name: str, help_: str, label: str):
        self.name = name
        self.help = help_
        self.label = label
        self.series: Dict[str, dict] = {}
        _REGISTRY[name] = self

    def update(self, value: str, hist: dict) -> None:
        self.series[value] = hist

    def render(self) -> str:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        for val in sorted(self.series):
            h = self.series[val]
            lab = f'{self.label}="{_escape_label(val)}"'
            cum = 0
            for k, c in enumerate(h["buckets"]):
                cum += c
                if k < _TM_LO_BUCKET or k > _TM_HI_BUCKET:
                    continue
                le = float(1 << k) / 1e9
                out.append(f'{self.name}_bucket{{{lab},le="{le:.9g}"}} '
                           f'{cum}')
            out.append(f'{self.name}_bucket{{{lab},le="+Inf"}} '
                       f'{h["count"]}')
            out.append(f'{self.name}_sum{{{lab}}} {h["sum_ns"] / 1e9}')
            out.append(f'{self.name}_count{{{lab}}} {h["count"]}')
        return "\n".join(out) + "\n"


PUMP_STAGE_SECONDS = _NativeLog2Histogram(
    "cdn_pump_stage_seconds",
    "Native pump stage latency stamped from C with CLOCK_MONOTONIC "
    "(stage=plan: recv-CQE -> route-plan done; submit: plan -> SQE "
    "staged; wire: SQE submit -> send-CQE; total: recv-CQE -> "
    "send-CQE)", "stage")
URING_CHAIN_SECONDS = _NativeLog2Histogram(
    "cdn_uring_chain_seconds",
    "io_uring engine timing (stat=enter: one io_uring_enter syscall "
    "wall time; chain: pumped linked-chain submit -> quiesce)", "stat")
PUMP_CLASS_DELAY_SECONDS = _NativeLog2Histogram(
    "cdn_pump_class_delay_seconds",
    "Pumped per-frame recv -> send-CQE delay by flow class", "class")

# last folded native class totals (the pumped counters are monotonic
# aggregates: live engines + closed-engine carry; fold only the delta)
_native_class_last: Dict[tuple, int] = {}


def update_native_telemetry(totals: Optional[dict]) -> None:
    """Publish one aggregated native telemetry snapshot (the output of
    ``native.uring.parse_telemetry`` summed over live engines plus the
    closed-engine carry). Called by the transport's pre-render hook;
    histograms are replaced, pumped class counters fold by delta into
    the shared cdn_class_* families (dir=out)."""
    if not totals:
        return
    for stage, h in totals["stage"].items():
        PUMP_STAGE_SECONDS.update(stage, h)
    for stat, h in totals["chain"].items():
        URING_CHAIN_SECONDS.update(stat, h)
    for cls, h in totals["class_delay"].items():
        PUMP_CLASS_DELAY_SECONDS.update(cls, h)
    # lazy: ledger.py imports this module for its metric families
    from pushcdn_tpu_torch.proto import ledger as ledger_mod
    for i, cls in enumerate(_CLASS_NAMES):
        for kind, child_row, series in (
                ("frames", CLASS_FRAMES_OUT, totals["class_frames"]),
                ("bytes", CLASS_BYTES_OUT, totals["class_bytes"])):
            cur = int(series.get(cls, 0))
            last = _native_class_last.get((kind, cls), 0)
            if cur > last:
                child_row[i].inc(cur - last)
            _native_class_last[(kind, cls)] = max(cur, last)
        # conservation fold (ISSUE 20): a pumped frame's queued credit and
        # terminal fate land in the SAME delta (delivered = class_frames,
        # dropped = fate_drop_frames), so pump in-flight is invisible to
        # the identity by construction and the balance sheet never shows
        # a transient pumped deficit.
        delivered = 0
        cur = int(totals["class_frames"].get(cls, 0))
        last = _native_class_last.get(("ledger_frames", cls), 0)
        if cur > last:
            delivered = cur - last
        _native_class_last[("ledger_frames", cls)] = max(cur, last)
        dropped = 0
        cur = int(totals.get("class_drop_frames", {}).get(cls, 0))
        last = _native_class_last.get(("ledger_drops", cls), 0)
        if cur > last:
            dropped = cur - last
        _native_class_last[("ledger_drops", cls)] = max(cur, last)
        if delivered or dropped:
            ledger_mod.note_queued(i, delivered + dropped)
            if delivered:
                ledger_mod.record_fate("delivered", "pumped", i, delivered)
            if dropped:
                ledger_mod.record_fate("dropped", "pump_peer_poison", i,
                                       dropped)


# Callables run before every render: components whose counters move on
# hot paths (device-plane steps) register a refresh here instead of
# pushing gauge updates from their pump loops.
PRE_RENDER_HOOKS: list = []

# BLS per-public-key Miller line-table cache (native/bls_bn254.cpp): the
# auth hot path's amortization state. One labeled gauge family (not
# counters, because the native library owns the monotonic values and a
# cache clear legitimately zeroes them); module attributes are the cached
# children so existing call sites keep working.
BLS_PK_CACHE = Gauge("cdn_bls_pk_cache",
                     "BLS verify line-table cache state "
                     "(stat=hits|misses|evictions|entries|bytes)",
                     labels=("stat",))
BLS_PK_CACHE_HITS = BLS_PK_CACHE.labels(stat="hits")
BLS_PK_CACHE_MISSES = BLS_PK_CACHE.labels(stat="misses")
BLS_PK_CACHE_EVICTIONS = BLS_PK_CACHE.labels(stat="evictions")
BLS_PK_CACHE_ENTRIES = BLS_PK_CACHE.labels(stat="entries")
BLS_PK_CACHE_BYTES = BLS_PK_CACHE.labels(stat="bytes")

# Client-side live gap detector (ISSUE 20): the subscriber's view of
# the frame-fate ledger. A gap EVENT is a sequence hole opening in a
# stream the client follows (frames skipped past); a HEAL is a late
# arrival filling a tracked hole (an at-least-once redelivery or
# reorder — legal). Outstanding loss as the client sees it is
# events - healed; wrap-up loss checks read these live counters
# instead of post-hoc log diffing. Duplicates never touch either.
CLIENT_GAP_EVENTS = Counter(
    "cdn_client_gap_events",
    "Delivery-sequence holes opened in streams this client follows "
    "(frames skipped past; late arrivals may still heal them)")
CLIENT_GAP_HEALED = Counter(
    "cdn_client_gap_healed",
    "Previously-open delivery gaps filled by a late arrival "
    "(at-least-once redelivery or reorder — legal)")

# Message-lifecycle tracing (proto/trace.py): per-hop latency from the
# traced message's origin. Defined here (not in trace.py) so every
# /metrics endpoint exposes the family even before the first span.
TRACE_HOP_LATENCY = Histogram(
    "cdn_trace_hop_seconds",
    "Time from a traced message's origin to each lifecycle hop "
    "(hop=publish|auth|ingress|plan|egress|delivery)",
    labels=("hop",))

# End-to-end SLO histogram (ISSUE 5): recorded at DELIVERY from the traced
# message's carried origin_ns — the publish→delivery latency an end user
# experienced, with OpenMetrics exemplars pinning each bucket to the trace
# id that last landed there (scrape with Accept: application/openmetrics-
# text to see them; plain scrapes omit exemplars for strict 0.0.4 parsers).
E2E_LATENCY = Histogram(
    "cdn_e2e_latency_seconds",
    "End-to-end publish->delivery latency of traced messages, recorded at "
    "delivery from the carried origin timestamp (single-machine clocks; "
    "cross-machine skew applies)",
    buckets=(5e-4, 1e-3, 2.5e-3, 5e-3, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0))

# Monotonic-clock accounting around the native seams we own: one
# perf_counter pair per *batch-level* call (route plan per chunk, egress
# encode per fan-out batch and per delivery matrix of a device step, BLS
# verify per handshake), so a scrape answers "is the loop hot in planning,
# egress, or auth" without a debugger.
NATIVE_SECONDS = Counter(
    "cdn_native_seconds",
    "Cumulative wall-clock seconds inside instrumented native seams "
    "(kernel=route_plan|egress_encode|bls_verify)",
    labels=("kernel",))
NATIVE_PLAN_SECONDS = NATIVE_SECONDS.labels(kernel="route_plan")
NATIVE_EGRESS_SECONDS = NATIVE_SECONDS.labels(kernel="egress_encode")
NATIVE_BLS_SECONDS = NATIVE_SECONDS.labels(kernel="bls_verify")

# Per-task sampling profiler (ISSUE 5): every tick the profiler walks
# asyncio.all_tasks() and attributes one sample per live task to its task
# FAMILY (the task name with trailing ids/counters stripped, so every
# "user-receive" connection task lands in one series). samples x interval
# ~= task-alive wall-clock seconds; comparing families across scrapes
# shows where the loop's task population grows or leaks.
TASK_SAMPLES = Counter(
    "cdn_task_samples",
    "Sampling profiler: one sample per live asyncio task per tick, "
    "labeled by task family (samples x PUSHCDN_PROFILE_INTERVAL "
    "~= task-alive seconds)",
    labels=("task",))

# Build/runtime identity: one constant-1 series whose labels carry the
# package version, torch version, and the ACTUAL backend/device kind —
# so a plane that fell to the CPU is visible on every scrape.
BUILD_INFO = Gauge("cdn_build_info",
                   "Build/runtime identity (value is always 1)",
                   labels=("version", "torch", "backend", "device_kind",
                           "native"))


# Host I/O engine identity: which data-plane impl this process resolved
# (--io-impl auto can honestly demote to asyncio when the kernel denies
# io_uring — the label is set at resolution time, value always 1)
IO_IMPL = Gauge("cdn_io_impl",
                "Resolved host I/O data-plane impl (value is always 1)",
                labels=("impl",))


_build_info_last: tuple = ()


def _refresh_build_info() -> None:
    """(Re)probe cdn_build_info at every render — CUDA can initialize
    AFTER the first scrape (a broker warms its device plane up in
    ``start``), and a frozen 'uninitialized' label would defeat the
    point. The stale series drops to 0 and the current one reads 1.
    Never *imports* torch nor *initializes* CUDA: a host-only process
    (marshal, client, a broker without a plane) reports torch=absent and
    backend=unloaded; a CPU-only torch reports backend=cpu, a CUDA build
    reports uninitialized until the process's own work brought CUDA
    up. ``native`` says whether the native host routines loaded
    (``loaded``, ``failed``, ``untried``, or ``unloaded`` before the
    module is imported), read without building them."""
    global _build_info_last
    import pushcdn_tpu_torch
    torch_mod = sys.modules.get("torch")
    torch_v = (getattr(torch_mod, "__version__", "absent")
               if torch_mod else "absent")
    backend = "unloaded"
    device_kind = "unknown"
    if torch_mod is not None:
        backend = "cpu"
        try:
            if torch_mod.version.cuda is not None:
                backend = "uninitialized"
                # peek, never provoke
                if torch_mod.cuda.is_initialized():
                    backend = "cuda"
                    device_kind = torch_mod.cuda.get_device_name(
                        torch_mod.cuda.current_device())
        except Exception:
            backend = "error"
    native_mod = sys.modules.get("pushcdn_tpu_torch.native")
    native = native_mod.state() if native_mod is not None else "unloaded"
    current = (pushcdn_tpu_torch.__version__, str(torch_v), backend,
               device_kind, native)
    if current == _build_info_last:
        return
    if _build_info_last:
        BUILD_INFO.labels(version=_build_info_last[0],
                          torch=_build_info_last[1],
                          backend=_build_info_last[2],
                          device_kind=_build_info_last[3],
                          native=_build_info_last[4]).set(0)
    BUILD_INFO.labels(version=current[0], torch=current[1],
                      backend=current[2], device_kind=current[3],
                      native=current[4]).set(1)
    _build_info_last = current


def _refresh_bls_pk_cache() -> None:
    from pushcdn_tpu_torch.native import bls
    # peek, never provoke: pk_cache_stats() would lazily COMPILE the
    # native library (a multi-second synchronous g++ run) and this hook
    # runs inside the asyncio /metrics handler — a process that never
    # verified a BLS signature keeps the gauges at zero instead
    if not bls.loaded():
        return
    stats = bls.pk_cache_stats()
    if stats is None:  # native library unavailable: gauges stay zero
        return
    BLS_PK_CACHE_HITS.set(stats["hits"])
    BLS_PK_CACHE_MISSES.set(stats["misses"])
    BLS_PK_CACHE_EVICTIONS.set(stats["evictions"])
    BLS_PK_CACHE_ENTRIES.set(stats["entries"])
    BLS_PK_CACHE_BYTES.set(stats["bytes"])


def register_bls_pk_cache_metrics() -> None:
    """Idempotent: pull the native cache counters into the gauges on
    every render. Registered by processes that actually verify BLS
    signatures (the marshal; brokers via their auth path) — a process
    that never loads the native library keeps the hook a no-op."""
    if _refresh_bls_pk_cache not in PRE_RENDER_HOOKS:
        PRE_RENDER_HOOKS.append(_refresh_bls_pk_cache)


_TOP_K_QUEUE_PEERS = 8
_MAX_PEER_SERIES = 64  # created-children cap, like the task profiler's
_peer_depth_live: set = set()


def _refresh_writer_queues() -> None:
    """Sum/max of send-queue depths across live connections (the transport
    layer keeps a weak registry), plus the top-K deepest peers by label —
    the head-of-line victim is invisible in an aggregate. Lazy module
    lookup: a process that never created a connection reports zeros
    without importing the transport."""
    global _peer_depth_live
    base = sys.modules.get("pushcdn_tpu_torch.proto.transport.base")
    total = depth_max = 0
    depths = []
    if base is not None:
        for conn in list(base.LIVE_CONNECTIONS):
            try:
                d = conn._send_q.qsize()
            except Exception:
                continue
            total += d
            if d > depth_max:
                depth_max = d
            if d > 0:
                depths.append((d, getattr(conn, "label", "?")))
    WRITER_QUEUE_DEPTH.labels(stat="sum").set(total)
    WRITER_QUEUE_DEPTH.labels(stat="max").set(depth_max)
    depths.sort(key=lambda t: (-t[0], t[1]))
    live = set()
    other = 0
    for rank, (d, label) in enumerate(depths):
        # bounded cardinality: only top-K rank a series, and a label that
        # would grow the family past the cap folds into "other" too
        if rank >= _TOP_K_QUEUE_PEERS or (
                (label,) not in WRITER_QUEUE_DEPTH_PEER._children
                and len(WRITER_QUEUE_DEPTH_PEER._children)
                >= _MAX_PEER_SERIES):
            other += d
            continue
        WRITER_QUEUE_DEPTH_PEER.labels(peer=label).set(d)
        live.add(label)
    WRITER_QUEUE_DEPTH_PEER.labels(peer="other").set(other)
    live.add("other")
    for stale in _peer_depth_live - live:
        WRITER_QUEUE_DEPTH_PEER.labels(peer=stale).set(0)
    _peer_depth_live = live


def _refresh_pools() -> None:
    """Global byte-pool occupancy across live pools (limiter registry)."""
    limiter_mod = sys.modules.get("pushcdn_tpu_torch.proto.limiter")
    in_use = capacity = 0
    if limiter_mod is not None:
        for pool in list(limiter_mod.LIVE_POOLS):
            capacity += pool.capacity
            in_use += pool.capacity - pool.available
    POOL_BYTES.labels(state="in_use").set(in_use)
    POOL_BYTES.labels(state="capacity").set(capacity)


PRE_RENDER_HOOKS.append(_refresh_build_info)
PRE_RENDER_HOOKS.append(_refresh_writer_queues)
PRE_RENDER_HOOKS.append(_refresh_pools)


_hook_failures: set = set()


def render_all(openmetrics: bool = False) -> str:
    for hook in list(PRE_RENDER_HOOKS):
        try:
            hook()
        except Exception:
            # a broken hook must not take down /metrics, but a silently
            # frozen gauge is an operator trap — log each hook ONCE
            if id(hook) not in _hook_failures:
                _hook_failures.add(id(hook))
                logging.getLogger("pushcdn.metrics").exception(
                    "metrics pre-render hook %r failed; its gauges are "
                    "stale from here on", hook)
    parts = []
    for m in list(_REGISTRY.values()):
        if openmetrics and isinstance(m, Histogram):
            parts.append(m.render(exemplars=True))
        elif openmetrics and isinstance(m, Counter):
            parts.append(m.render(openmetrics=True))
        else:
            parts.append(m.render())
    if openmetrics:
        parts.append("# EOF\n")
    return "".join(parts)


def render_tasks() -> str:
    """One line per live asyncio task: name, state, and where it is
    suspended — the poor man's tokio-console (`GET /tasks`)."""
    lines = []
    for task in sorted(asyncio.all_tasks(), key=lambda t: t.get_name()):
        # Task.cancelling is 3.11+; 3.10 images just report pending
        _cancelling = getattr(task, "cancelling", None)
        state = "done" if task.done() else (
            "cancelling" if _cancelling is not None and _cancelling()
            else "pending")
        where = ""
        if not task.done():
            stack = task.get_stack(limit=1)
            if stack:
                frame = stack[-1]
                where = f" @ {frame.f_code.co_filename.rsplit('/', 1)[-1]}:{frame.f_lineno}"
        lines.append(f"{task.get_name()}  [{state}]{where}")
    return f"{len(lines)} tasks\n" + "\n".join(lines) + "\n"


def supervised(factory, name: str, restart_delay_s: float = 1.0):
    """Run ``await factory()`` forever, logging + restarting on exception
    instead of letting the task die silently for the rest of the process
    lifetime (the pre-ISSUE-4 fate of ``_running_latency_calculator``).
    Each death is recorded in the process flight recorder so the trail
    shows up in ``/debug/flightrec`` and the diagnostics log."""
    from pushcdn_tpu_torch.proto import flightrec

    async def _runner():
        rec = flightrec.task_recorder()
        while True:
            try:
                await factory()
                rec.record("task-exited", name)
                logging.getLogger("pushcdn.metrics").warning(
                    "supervised task %r returned; restarting", name)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                rec.record("task-died", f"{name}: {exc!r}", abnormal=True)
                logging.getLogger("pushcdn.metrics").exception(
                    "supervised task %r died; restarting in %.1fs",
                    name, restart_delay_s)
            await asyncio.sleep(restart_delay_s)

    return _runner()


async def _running_latency_calculator(interval_s: float = 30.0) -> None:
    """Recompute RUNNING_LATENCY from histogram deltas every ``interval_s``
    (parity metrics.rs:43-78)."""
    prev_sum, prev_total = LATENCY.sum, LATENCY.total
    while True:
        await asyncio.sleep(interval_s)
        ds, dn = LATENCY.sum - prev_sum, LATENCY.total - prev_total
        RUNNING_LATENCY.set(ds / dn if dn else 0.0)
        prev_sum, prev_total = LATENCY.sum, LATENCY.total


_loop_lag_peak = 0.0


def _refresh_loop_lag() -> None:
    """Publish the PEAK lag since the last scrape, then reset. A plain
    last-sample gauge would be overwritten by the next on-time wakeup
    ~interval later, hiding every stall shorter than the scrape interval
    — exactly the incidents the metric exists to surface."""
    global _loop_lag_peak
    EVENT_LOOP_LAG.set(_loop_lag_peak)
    _loop_lag_peak = 0.0


PRE_RENDER_HOOKS.append(_refresh_loop_lag)


# most recent single sample, never reset by a scrape — what /healthz
# reads (a loop so wedged the sampler can't run can't answer /healthz
# either, so the probe's own timeout covers total stalls)
_loop_lag_last = 0.0


async def _loop_lag_sampler(interval_s: float = 0.25) -> None:
    """Sample event-loop scheduling lag: how late a sleep() wakeup ran.
    A loop hogged by a long synchronous section (native call, giant
    decode) shows up here before it shows up as user-visible latency.
    Samples accumulate as a max; the pre-render hook publishes-and-resets
    per scrape."""
    global _loop_lag_peak, _loop_lag_last
    loop = asyncio.get_running_loop()
    while True:
        t0 = loop.time()
        await asyncio.sleep(interval_s)
        lag = loop.time() - t0 - interval_s
        _loop_lag_last = lag
        if lag > _loop_lag_peak:
            _loop_lag_peak = lag


# ---------------------------------------------------------------------------
# per-task sampling profiler (ISSUE 5)
# ---------------------------------------------------------------------------

def profile_interval_s() -> float:
    """Profiler tick from ``PUSHCDN_PROFILE_INTERVAL`` (seconds; default
    0.25, ``0`` disables the sampler entirely)."""
    raw = os.environ.get("PUSHCDN_PROFILE_INTERVAL", "").strip()
    if not raw:
        return 0.25
    try:
        return max(float(raw), 0.0)
    except ValueError:
        return 0.25


# "user-receive-7f3a" / "Task-12" / "dial-0x7f.." → one family each;
# iteratively strip trailing counters and hex-ish ids
_FAMILY_STRIP = re.compile(r"[-_.:]?(?:0x)?[0-9a-fA-F]{4,}$|[-_.:]?\d+$")
_MAX_TASK_FAMILIES = 64

_family_children: Dict[str, Counter] = {}


def _task_family(name: str) -> str:
    while True:
        stripped = _FAMILY_STRIP.sub("", name)
        if stripped == name:
            break
        name = stripped
    return name or "anonymous"


def _family_child(family: str) -> Counter:
    child = _family_children.get(family)
    if child is None:
        # bounded cardinality: past the cap, new families fold into
        # "other" (a runaway label set would bloat every scrape forever)
        if len(_family_children) >= _MAX_TASK_FAMILIES \
                and family != "other":
            return _family_child("other")
        child = TASK_SAMPLES.labels(task=family)
        _family_children[family] = child
    return child


async def _task_profiler(interval_s: Optional[float] = None) -> None:
    """The sampling profiler task: each tick attributes one sample per
    live asyncio task to its family. Cost per tick is one all_tasks()
    snapshot + a dict count — at the default 0.25 s interval this is
    noise even with thousands of connection tasks (A/B'd in
    benches/route_bench.py under the 2% forwarding budget)."""
    if interval_s is None:
        interval_s = profile_interval_s()
    if interval_s <= 0:
        # disabled (PUSHCDN_PROFILE_INTERVAL=0): park instead of
        # busy-looping on sleep(0) — direct spawners (benches) and a
        # supervised() wrapper both stay quiet
        await asyncio.Event().wait()
        return
    name_cache: Dict[str, str] = {}
    while True:
        await asyncio.sleep(interval_s)
        counts: Dict[str, int] = {}
        for task in asyncio.all_tasks():
            if task.done():
                continue
            name = task.get_name()
            # unnamed tasks ("Task-<n>") are the dominant population on a
            # loaded broker and every name is unique — a cache keyed on
            # the full name would thrash, and running the regex per task
            # per tick is exactly the loop stall this profiler hunts
            if name.startswith("Task-") and name[5:].isdigit():
                family = "Task"
            else:
                family = name_cache.get(name)
                if family is None:
                    if len(name_cache) > 4 * _MAX_TASK_FAMILIES:
                        name_cache.clear()  # renamed-task churn bound
                    family = name_cache[name] = _task_family(name)
            counts[family] = counts.get(family, 0) + 1
        for family, n in counts.items():
            _family_child(family).inc(n)


# ---------------------------------------------------------------------------
# HTTP endpoint: parsed request line + route table (ISSUE 5)
# ---------------------------------------------------------------------------

# Extra debug routes registered by components (the broker's
# /debug/topology). A provider is ``fn(params) -> dict`` (rendered as
# JSON) or ``-> (status, content_type, body_str)``; it may be async.
DEBUG_ROUTES: Dict[str, object] = {}


def register_debug_route(path: str, provider) -> None:
    DEBUG_ROUTES[path] = provider


def unregister_debug_route(path: str) -> None:
    DEBUG_ROUTES.pop(path, None)


def _check_loop_lag():
    """Built-in liveness: the most recent loop-lag sample under threshold
    (``PUSHCDN_HEALTH_LAG_MAX`` seconds, default 2.0). A loop so wedged
    the sampler can't run at all can't answer /healthz either — the
    probe's own timeout covers that case."""
    try:
        limit = float(os.environ.get("PUSHCDN_HEALTH_LAG_MAX", "") or 2.0)
    except ValueError:
        limit = 2.0
    lag = _loop_lag_last
    return lag < limit, f"last loop-lag sample {lag * 1e3:.1f}ms (limit {limit:.1f}s)"


def _check_samplers():
    """Built-in liveness: the supervised background samplers are alive
    (supervised() restarts them on death, so a done task here means the
    supervisor itself died). Only THIS loop's tasks count — a leftover
    set from a torn-down loop (in-process restarts, tests) is pruned by
    the next serve_metrics, not a liveness failure."""
    loop = asyncio.get_running_loop()
    mine = [t for t in _BACKGROUND_TASKS if t.get_loop() is loop]
    dead = [t.get_name() for t in mine if t.done()]
    if dead:
        return False, f"dead: {','.join(dead)}"
    return True, f"{len(mine)} supervised samplers running"


def _parse_qs(query: str) -> Dict[str, str]:
    params: Dict[str, str] = {}
    for part in query.split("&"):
        if not part:
            continue
        k, _, v = part.partition("=")
        params[k] = v
    return params


async def serve_metrics(bind_endpoint: str) -> asyncio.AbstractServer:
    """Serve the observability endpoints over a parsed, routed HTTP/1.1
    GET surface (the pre-ISSUE-5 substring dispatch served the flightrec
    body to any request merely *containing* ``/debug/flightrec``, e.g. in
    a query string):

    - ``GET /metrics`` — Prometheus text (parity metrics.rs:18-39); with
      ``Accept: application/openmetrics-text`` the body carries bucket
      exemplars (trace ids on ``cdn_e2e_latency_seconds``) and ``# EOF``.
    - ``GET /healthz`` / ``GET /readyz`` — liveness/readiness JSON
      (:mod:`pushcdn_tpu_torch.proto.health`); 503 when a check fails or the
      process is draining. Never initializes CUDA.
    - ``GET /tasks`` — asyncio task dump (the poor man's tokio-console).
    - ``GET /debug/flightrec[?limit=N]`` — live flight-recorder trails,
      capped at N events total (default 10000).
    - ``GET /debug/...`` — component-registered routes (broker:
      ``/debug/topology``, ``/debug/plane_steps``).

    Non-GET methods get 405, unknown paths 404, a garbled request line
    400. Returns the server; also spawns the supervised background
    samplers (running-latency calculator, event-loop-lag sampler, task
    profiler) and registers the built-in liveness checks.
    """
    from pushcdn_tpu_torch.proto import flightrec, health
    from pushcdn_tpu_torch.proto.error import parse_endpoint
    host, port = parse_endpoint(bind_endpoint)

    def _resp(status: int, body: bytes,
              content_type: str = "text/plain",
              extra_headers: str = "") -> bytes:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  405: "Method Not Allowed",
                  503: "Service Unavailable"}.get(status, "OK")
        return (f"HTTP/1.1 {status} {reason}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"{extra_headers}\r\n".encode() + body)

    async def _route(method: str, path: str, params: Dict[str, str],
                     headers: Dict[str, str]) -> bytes:
        if method != "GET":
            return _resp(405, b"only GET is supported\n",
                         extra_headers="Allow: GET\r\n")
        if path == "/metrics":
            om = "openmetrics" in headers.get("accept", "")
            return _resp(200, render_all(openmetrics=om).encode(),
                         "application/openmetrics-text; version=1.0.0; "
                         "charset=utf-8" if om
                         else "text/plain; version=0.0.4")
        if path == "/healthz":
            status, body = await health.render_healthz()
            return _resp(status, body.encode(), "application/json")
        if path == "/readyz":
            status, body = await health.render_readyz()
            return _resp(status, body.encode(), "application/json")
        if path == "/tasks":
            # async-runtime introspection (the reference wires
            # tokio-console behind tokio_unstable; here a plain dump of
            # every live asyncio task: name, state, current frame)
            return _resp(200, render_tasks().encode())
        if path == "/debug/flightrec":
            try:
                limit = int(params.get("limit", ""))
            except ValueError:
                limit = None
            return _resp(200, flightrec.render_all(limit=limit).encode())
        provider = DEBUG_ROUTES.get(path)
        if provider is not None:
            result = provider(params)
            if asyncio.iscoroutine(result):
                result = await result
            if isinstance(result, dict):
                import json as json_mod
                return _resp(200, (json_mod.dumps(result) + "\n").encode(),
                             "application/json")
            status, content_type, body = result
            return _resp(status, body.encode(), content_type)
        return _resp(404, b"not found\n")

    async def handler(reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            request = await reader.readline()
            headers: Dict[str, str] = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, sep, v = line.partition(b":")
                if sep:
                    headers[k.strip().decode("latin1").lower()] = \
                        v.strip().decode("latin1")
            parts = request.split()
            if len(parts) < 2:
                writer.write(_resp(400, b"bad request line\n"))
            else:
                method = parts[0].decode("latin1")
                target = parts[1].decode("latin1")
                path, _, query = target.partition("?")
                writer.write(await _route(method, path, _parse_qs(query),
                                          headers))
            await writer.drain()
        except Exception:
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    server = await asyncio.start_server(handler, host, port)
    health.register_liveness("loop-lag", _check_loop_lag)
    health.register_liveness("samplers", _check_samplers)
    # prune samplers from dead/foreign event loops (in-process restarts,
    # test suites) so the live loop gets its own set
    loop = asyncio.get_running_loop()
    _BACKGROUND_TASKS[:] = [t for t in _BACKGROUND_TASKS
                            if not t.done() and t.get_loop() is loop]
    if not _BACKGROUND_TASKS:  # exactly one sampler set per process
        _BACKGROUND_TASKS.append(asyncio.create_task(
            supervised(_running_latency_calculator, "running-latency"),
            name="metrics-running-latency"))
        _BACKGROUND_TASKS.append(asyncio.create_task(
            supervised(_loop_lag_sampler, "loop-lag"),
            name="metrics-loop-lag"))
        if profile_interval_s() > 0:
            _BACKGROUND_TASKS.append(asyncio.create_task(
                supervised(_task_profiler, "task-profiler"),
                name="metrics-task-profiler"))
    return server
