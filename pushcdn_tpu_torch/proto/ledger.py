"""Frame-fate conservation ledger (ISSUE 20 tentpole).

Every frame instance the data plane takes responsibility for is accounted
from ingress to exactly one terminal **fate**:

- ``delivered`` — written toward a local user (host writer dequeue, or a
  pumped send-CQE counted in C and folded in by delta);
- ``relayed``  — written toward a peer broker or handed to a sibling
  shard's ring (the frame is now the next hop's responsibility);
- ``dropped``  — any counted loss, labeled with a ``reason`` from the
  closed taxonomy below.

The taxonomy is CLOSED: :func:`record_fate` refuses a ``(fate, reason)``
pair not present in :data:`TAXONOMY`, and the exhaustiveness test
(tests/test_ledger.py) greps the tree so every instrumented call site
uses a registered reason and every registered reason has a call site —
a new drop path cannot ship uncounted.

Conservation identity (the audited invariant): over the writer-queue
plane,

    queued == delivered + relayed + queue_drops + in_queue

where ``queued`` is counted at successful send-queue insert (real frame
counts ride every writer entry stamp), the fates are counted at dequeue /
drain, and ``in_queue`` is *derived* (queued − fates). The auditor
cross-checks the derived value against an actual walk of every live
connection's send queue; a mismatch that persists across two quiescent
ticks (no counter moved in between, so it cannot be in-flight skew) is a
conservation violation: it increments ``cdn_conservation_violations``,
records a flight-recorder event, and flips the ``/readyz``
``conservation`` check for ``PUSHCDN_CONSERVATION_READY_S``.

Pumped frames never enter a Python writer queue: the native telemetry
fold (metrics.update_native_telemetry) credits ``queued`` and the
terminal fate (``delivered/pumped`` or ``dropped/pump_peer_poison``) in
the same delta, so the identity holds with the pump's in-flight window
invisible by construction (bounded by PUMP_CHAIN_MAX × peers).

Per-link conservation: routing decisions toward a broker peer bump the
monotone ``(peer, class)`` ``link_sent`` table (decision time is where
the per-frame class is exact and both ends classify identically), and
the receive loops bump ``link_recv`` per upstream with the same
frame-derived rule (Broadcast → topic class, Direct → live, any other
kind → control). Sheets are exchanged mesh-wide as
``LedgerSync`` (wire kind 13) over the existing sync task — no per-frame
wire overhead — so each hop exports ``cdn_link_deficit{peer,class}``
against its upstream's claim, and ``scripts/cdn_top.py --audit`` merges
every process's ``/debug/ledger`` into one cluster balance sheet.

Loss-budget SLOs: :class:`SloEngine` turns the ledger's loss counters
into multi-window burn rates (``cdn_slo_burn_rate{slo,window}``) —
burn > 1 means the class is spending its error budget faster than the
window allows. Knobs: ``PUSHCDN_SLO_WINDOWS`` (seconds, comma list),
``PUSHCDN_SLO_LOSS_BUDGET`` (+ per-class ``_CONTROL``/``_CONSENSUS``/
``_LIVE``/``_BULK`` overrides), ``PUSHCDN_SLO_DELIVERY_P99_MS``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Tuple

from pushcdn_tpu_torch.proto import metrics as metrics_mod

logger = logging.getLogger("pushcdn.ledger")

# class axis: the four flowclass classes + "none" (a frame with no route:
# the plan writes class 255, bincount excludes it — the ledger still
# gives the instance a fate)
CLASS_LABELS = ("control", "consensus", "live", "bulk", "none")
NCLS = len(CLASS_LABELS)
IDX_NONE = 4


def class_index(cls: int) -> int:
    """Map a wire/plan class value to the ledger's class axis (255 and
    anything out of range → "none")."""
    return cls if 0 <= cls < 4 else IDX_NONE


# -- the closed fate taxonomy ------------------------------------------------
# (fate, reason) -> (in conservation identity?, description). The identity
# column marks fates counted against writer-queue `queued`; decision-time
# and off-path fates (retained copies, malformed ingress) sit outside it.
TAXONOMY: Dict[Tuple[str, str], Tuple[bool, str]] = {
    ("delivered", "egress"): (True, "writer dequeue toward a local user"),
    ("delivered", "pumped"): (True, "native pump send-CQE (C fold)"),
    ("relayed", "mesh"): (True, "writer dequeue toward a peer broker"),
    ("relayed", "shard_ring"): (False, "handed to a sibling shard's ring"),
    ("dropped", "writer_teardown"): (True, "send queue drained at close"),
    ("dropped", "conn_poisoned"): (True, "send queue drained on I/O error"),
    ("dropped", "send_failed"): (True, "failure-is-removal drain"),
    ("dropped", "parting_expiry"): (True, "parting-grace chase expired"),
    ("dropped", "pump_peer_poison"): (True, "pumped runs abandoned in C"),
    ("dropped", "admission_shed"): (False, "admission plane refused work"),
    ("dropped", "relay_shed"): (False, "shard relay budget exceeded"),
    ("dropped", "no_route"): (False, "Direct with unknown/stale recipient"),
    ("dropped", "no_interest"): (False, "Broadcast with zero recipients"),
    ("dropped", "malformed"): (False, "undecodable ingress frame"),
    ("dropped", "retention_evict"): (False, "retained copy evicted"),
}

# fates summed against `queued` in the conservation identity
IDENTITY_FATES = frozenset(k for k, (in_id, _) in TAXONOMY.items() if in_id)

# dropped reasons that count as LOSS for the SLO loss budget (benign
# fates — nobody wanted the frame, or it never decoded, or it was a
# retained *copy* — don't burn budget)
LOSS_REASONS = frozenset(
    r for (f, r) in TAXONOMY if f == "dropped"
    and r not in ("no_interest", "malformed", "retention_evict"))

FRAME_FATE = metrics_mod.Counter(
    "cdn_frame_fate",
    "Terminal fate of every frame instance the data plane took "
    "responsibility for (closed taxonomy; see proto/ledger.py)",
    labels=("fate", "reason", "class"))

CONSERVATION_VIOLATIONS = metrics_mod.Counter(
    "cdn_conservation_violations",
    "Audited conservation failures: frames vanished from the writer "
    "plane with no counted fate (quiescent ledger mismatch)")

LINK_DEFICIT = metrics_mod.Gauge(
    "cdn_link_deficit",
    "Frames an upstream broker claims it sent us minus frames we "
    "counted received from it (>0 past the in-flight window = loss on "
    "the link)",
    labels=("peer", "class"))

SLO_BURN = metrics_mod.Gauge(
    "cdn_slo_burn_rate",
    "Error-budget burn rate per SLO and window (>1 = burning faster "
    "than the budget allows; loss_<class> = frame loss vs "
    "PUSHCDN_SLO_LOSS_BUDGET, delivery_p99_<class> = writer-queue p99 "
    "vs PUSHCDN_SLO_DELIVERY_P99_MS)",
    labels=("slo", "window"))


class Ledger:
    """Process-local balance sheet. Event-loop-thread writers only (the
    native pump's counters arrive via the single-threaded telemetry
    fold); plain int math — the hot cost is one dict lookup + adds per
    writer ENTRY (a whole batch), never per frame."""

    def __init__(self) -> None:
        self.enabled = os.environ.get("PUSHCDN_LEDGER", "1") != "0"
        # incarnation epoch: a respawned broker reuses its canonical
        # identifier, so per-link counters are meaningful only within one
        # (sender incarnation, receiver incarnation) pair — the sheet
        # carries this stamp and note_peer_sheet resets a link's tables
        # when the peer's epoch changes
        self.boot = time.time()
        self.queued = [0] * NCLS           # writer-queue inserts
        self.ingress = [0] * NCLS          # frames accepted from peers
        # (fate, reason) -> per-class counts
        self.fates: Dict[Tuple[str, str], List[int]] = {}
        # monotone per-link tables: peer identifier -> per-class counts
        self.link_sent: Dict[str, List[int]] = {}
        self.link_recv: Dict[str, List[int]] = {}
        # peers' LedgerSync sheets: identifier -> dict snapshot, and the
        # boot epoch each sheet last carried (see ``boot`` above)
        self.peer_sheets: Dict[str, dict] = {}
        self._peer_boots: Dict[str, float] = {}
        # cached cdn_frame_fate children
        self._fate_children: Dict[Tuple[str, str, int], object] = {}
        # auditor state
        self.my_ident = ""              # set when the auditor starts
        self.violations = 0
        self.last_violation_at: Optional[float] = None
        self._last_totals: Optional[tuple] = None
        self._last_mismatch = False

    # -- recording ----------------------------------------------------------

    def note_queued(self, cls: int, n: int = 1) -> None:
        if n:
            self.queued[class_index(cls)] += n

    def note_ingress(self, cls: int, n: int = 1,
                     peer: Optional[str] = None) -> None:
        if not n:
            return
        i = class_index(cls)
        self.ingress[i] += n
        if peer is not None:
            row = self.link_recv.get(peer)
            if row is None:
                row = self.link_recv[peer] = [0] * NCLS
            row[i] += n

    def record_fate(self, fate: str, reason: str, cls: int,
                    n: int = 1) -> None:
        if not n:
            return
        key = (fate, reason)
        if key not in TAXONOMY:
            raise ValueError(f"unregistered frame fate {key!r} — add it to "
                             "proto.ledger.TAXONOMY")
        i = class_index(cls)
        row = self.fates.get(key)
        if row is None:
            row = self.fates[key] = [0] * NCLS
        row[i] += n
        child = self._fate_children.get((fate, reason, i))
        if child is None:
            child = FRAME_FATE.labels(**{"fate": fate, "reason": reason,
                                         "class": CLASS_LABELS[i]})
            self._fate_children[(fate, reason, i)] = child
        child.inc(n)

    def note_link_sent(self, peer: str, cls: int, n: int = 1) -> None:
        """Monotone per-link sent table, counted at the routing decision
        (where the per-frame class is exact) — in a teardown-free run
        this equals the peer's ``link_recv`` from us once in-flight
        drains; on link death the residual deficit is exactly the frames
        the teardown drop fates + the wire swallowed (what cdn_top
        --audit attributes to the dead peer)."""
        if not n:
            return
        row = self.link_sent.get(peer)
        if row is None:
            row = self.link_sent[peer] = [0] * NCLS
        row[class_index(cls)] += n

    # -- balance sheet ------------------------------------------------------

    def identity_fate_totals(self) -> List[int]:
        out = [0] * NCLS
        for key in IDENTITY_FATES:
            row = self.fates.get(key)
            if row is not None:
                for i, v in enumerate(row):
                    out[i] += v
        return out

    def derived_in_queue(self) -> List[int]:
        fates = self.identity_fate_totals()
        return [q - f for q, f in zip(self.queued, fates)]

    def walk_live_queues(self) -> int:
        """Actual frames sitting in live connections' send queues right
        now (the stamp's real-frame count; event-loop context only)."""
        from pushcdn_tpu_torch.proto.transport import base as base_mod
        total = 0
        for conn in list(base_mod.LIVE_CONNECTIONS):
            try:
                for item in list(conn._send_q._queue):
                    if isinstance(item, tuple) and len(item) > 2 \
                            and item[2] is not None:
                        total += item[2][4]
            except Exception:
                continue
        return total

    def check_conservation(self,
                           in_queue_actual: Optional[int] = None) -> dict:
        """One auditor tick. Returns the balance sheet; flags (and
        counts) a violation per the quiescence rule documented in the
        module docstring."""
        if in_queue_actual is None:
            in_queue_actual = self.walk_live_queues()
        derived = self.derived_in_queue()
        total_derived = sum(derived)
        totals = (tuple(self.queued),
                  tuple(sorted((k, tuple(v))
                               for k, v in self.fates.items())))
        # BOTH mismatch shapes (derived != actual walk, or a negative
        # derived balance) are gated on quiescence: live traffic
        # legitimately interleaves enqueue/dequeue accounting within a
        # tick, so only a discrepancy that survives two consecutive
        # ticks with no counter movement in between is a violation.
        mismatch = (total_derived != in_queue_actual
                    or any(d < 0 for d in derived))
        quiescent = totals == self._last_totals
        violation = mismatch and quiescent and self._last_mismatch
        self._last_totals = totals
        self._last_mismatch = mismatch and quiescent
        if violation:
            self.violations += 1
            self.last_violation_at = time.monotonic()
            CONSERVATION_VIOLATIONS.inc()
            detail = (f"queued={sum(self.queued)} "
                      f"fates={sum(self.identity_fate_totals())} "
                      f"derived_in_queue={total_derived} "
                      f"actual_in_queue={in_queue_actual}")
            from pushcdn_tpu_torch.proto import flightrec
            flightrec.task_recorder().record("conservation-violation",
                                             detail, abnormal=True)
            logger.warning("conservation violation: %s", detail)
        return {
            "derived_in_queue": derived,
            "in_queue_actual": in_queue_actual,
            "violation": violation,
        }

    def conservation_check(self):
        """/readyz check: unready while a violation is recent."""
        window = float(os.environ.get("PUSHCDN_CONSERVATION_READY_S",
                                      "120") or 120)
        if self.last_violation_at is None:
            return True, f"balanced ({self.violations} violations ever)"
        age = time.monotonic() - self.last_violation_at
        if age < window:
            return False, (f"conservation violation {age:.0f}s ago "
                           f"({self.violations} total)")
        return True, f"last violation {age:.0f}s ago"

    # -- mesh exchange ------------------------------------------------------

    def sheet(self, ident: str = "") -> dict:
        """This process's exchangeable balance sheet (LedgerSync payload
        and the /debug/ledger body's ``local`` section)."""
        return {
            "ident": ident,
            "ts": time.time(),
            "boot": self.boot,
            "queued": dict(zip(CLASS_LABELS, self.queued)),
            "ingress": dict(zip(CLASS_LABELS, self.ingress)),
            "fates": {f"{fate}/{reason}": dict(zip(CLASS_LABELS, row))
                      for (fate, reason), row in sorted(self.fates.items())},
            "in_queue_derived": dict(zip(CLASS_LABELS,
                                         self.derived_in_queue())),
            "link_sent": {p: dict(zip(CLASS_LABELS, row))
                          for p, row in sorted(self.link_sent.items())},
            "link_recv": {p: dict(zip(CLASS_LABELS, row))
                          for p, row in sorted(self.link_recv.items())},
            "violations": self.violations,
        }

    def reset_link(self, ident: str) -> None:
        """A (re)formed mesh link starts a fresh conservation epoch for
        ``ident``: per-link tables compare counters from ONE link
        incarnation at both ends, so a previous connection's residual
        (already audited — and attributed — while the link was down) must
        not bleed into the new link's balance. Clearing the remembered
        boot epoch keeps this composable with :meth:`note_peer_sheet`'s
        restart detection (the next sheet re-anchors, no double reset)."""
        self.link_sent.pop(ident, None)
        self.link_recv.pop(ident, None)
        self.peer_sheets.pop(ident, None)
        self._peer_boots.pop(ident, None)

    def note_peer_sheet(self, ident: str, sheet: dict) -> None:
        if not isinstance(sheet, dict):
            return
        boot = sheet.get("boot")
        last = self._peer_boots.get(ident)
        if isinstance(boot, (int, float)):
            if last is not None and boot != last:
                # the peer restarted under the same identifier: our
                # sent/recv counters toward the DEAD incarnation don't
                # balance against the fresh one's zeroed tables — start
                # a new conservation epoch for this link (the residual
                # was auditable, and attributed, while the peer was down)
                self.link_sent.pop(ident, None)
                self.link_recv.pop(ident, None)
                logger.info("ledger: peer %s restarted (epoch %.3f -> "
                            "%.3f); link tables reset", ident, last, boot)
            self._peer_boots[ident] = boot
        self.peer_sheets[ident] = sheet

    def update_link_deficits(self, my_ident: str) -> None:
        """Export cdn_link_deficit from each upstream's claim: what peer
        P says it sent us minus what we counted received from P."""
        for peer, sheet in self.peer_sheets.items():
            claimed = sheet.get("link_sent", {}).get(my_ident)
            if claimed is None:
                continue
            got = self.link_recv.get(peer, [0] * NCLS)
            for i, label in enumerate(CLASS_LABELS):
                d = int(claimed.get(label, 0)) - got[i]
                if d or label in claimed:
                    LINK_DEFICIT.labels(peer=peer,
                                        **{"class": label}).set(d)


LEDGER = Ledger()


# module-level fast paths (what the transport/routing hot sites call)
def note_queued(cls: int, n: int = 1) -> None:
    if LEDGER.enabled:
        LEDGER.note_queued(cls, n)


def note_ingress(cls: int, n: int = 1, peer: Optional[str] = None) -> None:
    if LEDGER.enabled:
        LEDGER.note_ingress(cls, n, peer)


def record_fate(fate: str, reason: str, cls: int, n: int = 1) -> None:
    if LEDGER.enabled:
        LEDGER.record_fate(fate, reason, cls, n)


def note_link_sent(peer: str, cls: int, n: int = 1) -> None:
    if LEDGER.enabled:
        LEDGER.note_link_sent(peer, cls, n)


def reset_link(peer: str) -> None:
    if LEDGER.enabled:
        LEDGER.reset_link(peer)


def on_dequeued(cls: int, n: int, peer: Optional[str] = None) -> None:
    """Writer dequeue: the frame(s) are being written — delivered toward
    a user, or relayed toward a peer broker (``peer`` set)."""
    if not LEDGER.enabled or not n:
        return
    if peer is not None:
        LEDGER.record_fate("relayed", "mesh", cls, n)
    else:
        LEDGER.record_fate("delivered", "egress", cls, n)


def on_transit(cls: int, n: int = 1, peer: Optional[str] = None) -> None:
    """Inline write path: queued and dequeued in one synchronous step."""
    if LEDGER.enabled and n:
        LEDGER.note_queued(cls, n)
        on_dequeued(cls, n, peer)


def reset_for_tests() -> None:
    global LEDGER
    LEDGER = Ledger()


# -- SLO burn-rate engine ----------------------------------------------------

def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class SloEngine:
    """Multi-window burn rates over the ledger's loss counters (and,
    when targeted, the writer-queue delay p99). Ticked by the auditor;
    ``now`` is injectable for the seeded tests."""

    def __init__(self, ledger: Optional[Ledger] = None) -> None:
        self.ledger = ledger if ledger is not None else LEDGER
        raw = os.environ.get("PUSHCDN_SLO_WINDOWS", "") or "60,300"
        self.windows: List[float] = []
        for part in raw.split(","):
            part = part.strip()
            if part:
                try:
                    self.windows.append(float(part))
                except ValueError:
                    pass
        if not self.windows:
            self.windows = [60.0, 300.0]
        base = _env_float("PUSHCDN_SLO_LOSS_BUDGET", 1e-3)
        self.loss_budget = [
            _env_float(f"PUSHCDN_SLO_LOSS_BUDGET_{label.upper()}", base)
            for label in CLASS_LABELS[:4]]
        # 0 disables the delivery-p99 SLO
        self.p99_target_s = _env_float("PUSHCDN_SLO_DELIVERY_P99_MS",
                                       0.0) / 1e3
        self._samples: List[tuple] = []   # (t, attempts[4], losses[4], hist)

    def _loss_counts(self) -> List[int]:
        out = [0] * 4
        for (fate, reason), row in self.ledger.fates.items():
            if fate == "dropped" and reason in LOSS_REASONS:
                for i in range(4):
                    out[i] += row[i]
        return out

    def _attempt_counts(self) -> List[int]:
        """Delivery attempts = terminal fates inside the loss universe
        (delivered + relayed + counted losses)."""
        out = self._loss_counts()
        for (fate, _reason), row in self.ledger.fates.items():
            if fate in ("delivered", "relayed"):
                for i in range(4):
                    out[i] += row[i]
        return out

    @staticmethod
    def _hist_snapshot() -> list:
        out = []
        for child in metrics_mod.WRITER_QUEUE_DELAY_CLS:
            out.append((tuple(child.counts), child.total, child.buckets))
        return out

    @staticmethod
    def _p99_of_delta(before, after) -> Optional[float]:
        (c0, t0, buckets), (c1, t1, _) = before, after
        n = t1 - t0
        if n <= 0:
            return None
        target = 0.99 * n
        cum = 0
        for i, b in enumerate(buckets):
            cum += c1[i] - c0[i]
            if cum >= target:
                return b
        return buckets[-1] * 2  # +Inf bucket: beyond the last bound

    def tick(self, now: Optional[float] = None) -> None:
        if now is None:
            now = time.monotonic()
        sample = (now, self._attempt_counts(), self._loss_counts(),
                  self._hist_snapshot())
        self._samples.append(sample)
        horizon = now - max(self.windows) - 1.0
        while len(self._samples) > 2 and self._samples[1][0] <= horizon:
            self._samples.pop(0)
        for w in self.windows:
            # oldest sample inside the window (fall back to the oldest
            # held — short uptimes still burn against what we have)
            base = self._samples[0]
            for s in self._samples:
                if s[0] >= now - w:
                    base = s
                    break
            wl = f"{int(w)}s"
            for i, label in enumerate(CLASS_LABELS[:4]):
                attempts = sample[1][i] - base[1][i]
                losses = sample[2][i] - base[2][i]
                rate = (losses / attempts) if attempts > 0 else 0.0
                burn = rate / self.loss_budget[i] \
                    if self.loss_budget[i] > 0 else 0.0
                SLO_BURN.labels(slo=f"loss_{label}", window=wl).set(burn)
                if self.p99_target_s > 0:
                    p99 = self._p99_of_delta(base[3][i], sample[3][i])
                    burn99 = (p99 / self.p99_target_s) if p99 else 0.0
                    SLO_BURN.labels(slo=f"delivery_p99_{label}",
                                    window=wl).set(burn99)


# -- the supervised auditor task ---------------------------------------------

async def run_auditor(interval_s: Optional[float] = None,
                      my_ident: str = "") -> None:
    """Continuous conservation auditor + SLO engine tick (spawned via
    metrics.supervised by the broker)."""
    import asyncio
    if interval_s is None:
        interval_s = _env_float("PUSHCDN_AUDIT_INTERVAL_S", 1.0)
    if my_ident:
        LEDGER.my_ident = my_ident
    engine = SloEngine()
    while True:
        await asyncio.sleep(interval_s)
        LEDGER.check_conservation()
        engine.tick()
        if my_ident:
            LEDGER.update_link_deficits(my_ident)


def ledger_route(params: dict) -> dict:
    """``GET /debug/ledger``: this process's sheet + the peers' sheets it
    has heard over LedgerSync (cdn_top --audit merges these)."""
    ident = params.get("ident", [""])
    ident = ident[0] if isinstance(ident, list) else str(ident)
    return {
        "local": LEDGER.sheet(ident or LEDGER.my_ident),
        "peers": LEDGER.peer_sheets,
        "conservation": {
            "violations": LEDGER.violations,
            "in_queue_derived": sum(LEDGER.derived_in_queue()),
        },
    }
