"""Admission control & overload shedding.

The incremental route plane makes the control path O(delta), but a
million-user box still needs a policy for the work it should NOT accept:
past the configured budgets the broker REFUSES cheaply instead of letting
the event loop collapse under connection or subscribe storms. Three tiers:

- **per-tier connection budgets** — ``PUSHCDN_MAX_CONNS_USER`` /
  ``PUSHCDN_MAX_CONNS_BROKER`` cap live connections per worker process
  (0 = unlimited, the default). A user over budget is refused BEFORE the
  auth handshake (no BLS verify, no discovery round-trip spent on a
  connection we won't keep) with a typed ``AuthenticateResponse(permit=0,
  context="shed: ...")`` — the client library surfaces it as
  ``Error(AUTHENTICATION)`` and re-load-balances through the marshal. An
  over-budget peer broker link is closed (the dialer's heartbeat retries).
- **subscribe-rate limiting** — a per-connection token bucket
  (``PUSHCDN_SUBSCRIBE_RATE`` tokens/s, burst ``PUSHCDN_SUBSCRIBE_BURST``)
  over Subscribe/Unsubscribe frames. An over-rate mutation is DROPPED
  (not applied, sender stays connected) and the client is told with a
  typed shed notice riding the normal egress path — never a silent drop;
  the client library raises ``Error(SHED)``.
- **surfacing** — every shed increments ``cdn_route_shed_total{tier=...}``,
  records a ``load-shed`` flight-recorder event (visible at
  ``/debug/flightrec`` and in abnormal-teardown dumps), and flips the
  broker's ``/readyz`` ``admission`` check false for
  ``PUSHCDN_SHED_READY_S`` seconds (default 5) so the load balancer
  steers new work away while the box recovers. Degrade, never collapse.

The port's copy of ``pushcdn_tpu.broker.admission``: the budgets, the
bucket and the readiness window are the reference's, knob for knob.
"""

from __future__ import annotations

import logging
import os
import time
from typing import TYPE_CHECKING, Optional, Tuple

from pushcdn_tpu_torch.proto import flightrec
from pushcdn_tpu_torch.proto import flowclass
from pushcdn_tpu_torch.proto import ledger as ledger_mod
from pushcdn_tpu_torch.proto import metrics as metrics_mod
from pushcdn_tpu_torch.proto.limiter import Bytes
from pushcdn_tpu_torch.proto.message import AuthenticateResponse, serialize

if TYPE_CHECKING:
    from pushcdn_tpu_torch.broker.broker import Broker

logger = logging.getLogger("pushcdn.broker")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("ignoring malformed %s=%r", name, raw)
        return default


def _env_int(name: str, default: int) -> int:
    return int(_env_float(name, float(default)))


# pre-serialized typed shed notice for the hot (subscribe) tier — permit=0
# marks refusal, context says why; the client maps it to Error(SHED)
_SUBSCRIBE_SHED_CONTEXT = ("shed: subscribe rate exceeded "
                           "(PUSHCDN_SUBSCRIBE_RATE)")
_SUBSCRIBE_SHED_FRAME = serialize(
    AuthenticateResponse(permit=0, context=_SUBSCRIBE_SHED_CONTEXT))


class AdmissionControl:
    """Per-broker admission policy. Synchronous and allocation-free on the
    allow path (one monotonic read + float math per rate check)."""

    __slots__ = ("broker", "max_user_conns", "max_broker_conns",
                 "subscribe_rate", "subscribe_burst", "ready_window_s",
                 "last_shed", "shed_counts")

    def __init__(self, broker: "Broker"):
        self.broker = broker
        self.max_user_conns = _env_int("PUSHCDN_MAX_CONNS_USER", 0)
        self.max_broker_conns = _env_int("PUSHCDN_MAX_CONNS_BROKER", 0)
        self.subscribe_rate = _env_float("PUSHCDN_SUBSCRIBE_RATE", 0.0)
        burst_default = max(8.0, 4 * self.subscribe_rate)
        self.subscribe_burst = _env_float("PUSHCDN_SUBSCRIBE_BURST",
                                          burst_default)
        self.ready_window_s = _env_float("PUSHCDN_SHED_READY_S", 5.0)
        self.last_shed: dict = {}    # tier -> monotonic ts of last shed
        self.shed_counts: dict = {}  # tier -> total (topology summary)

    @property
    def enabled(self) -> bool:
        return (self.max_user_conns > 0 or self.max_broker_conns > 0
                or self.subscribe_rate > 0)

    # -- connection budgets ---------------------------------------------------

    def admit_user(self) -> Optional[str]:
        """None = admit; else the shed reason (typed back to the client).
        Budgets are per worker process — a ``--shards N`` box multiplies
        them by N."""
        if self.max_user_conns <= 0:
            return None
        if self.broker.connections.num_users < self.max_user_conns:
            return None
        # retry-after rides the context as a typed hint: the
        # readiness window is exactly how long the balancer steers away,
        # so it is the honest earliest-useful-retry estimate
        reason = (f"shed: user connection budget {self.max_user_conns} "
                  f"reached (PUSHCDN_MAX_CONNS_USER); "
                  f"retry-after={self.ready_window_s:g}")
        self._note_shed("user_conn", reason, None,
                        metrics_mod.ROUTE_SHED_USER_CONN)
        return reason

    def admit_broker(self) -> Optional[str]:
        if self.max_broker_conns <= 0:
            return None
        if self.broker.connections.num_brokers < self.max_broker_conns:
            return None
        reason = (f"shed: broker link budget {self.max_broker_conns} "
                  f"reached (PUSHCDN_MAX_CONNS_BROKER); "
                  f"retry-after={self.ready_window_s:g}")
        self._note_shed("broker_conn", reason, None,
                        metrics_mod.ROUTE_SHED_BROKER_CONN)
        return reason

    # -- subscribe-rate token bucket -----------------------------------------

    def allow_subscribe(self, conn) -> bool:
        """One token per Subscribe/Unsubscribe frame from ``conn``; False
        means drop-and-notify (the caller queues the typed shed notice)."""
        rate = self.subscribe_rate
        if rate <= 0 or conn is None:
            return True
        now = time.monotonic()
        bucket = getattr(conn, "_sub_bucket", None)
        if bucket is None:
            conn._sub_bucket = [self.subscribe_burst - 1.0, now]
            return True
        tokens = min(self.subscribe_burst,
                     bucket[0] + (now - bucket[1]) * rate)
        bucket[1] = now
        if tokens < 1.0:
            bucket[0] = tokens
            return False
        bucket[0] = tokens - 1.0
        return True

    def shed_subscribe(self, sender_key, conn, egress) -> None:
        """Drop an over-rate subscription mutation: count it, arm the
        recorder, and queue the typed notice back to the sender through
        the normal egress path (ordered with its other deliveries — a
        shed is never a silent drop)."""
        self._note_shed("subscribe", _SUBSCRIBE_SHED_CONTEXT, conn,
                        metrics_mod.ROUTE_SHED_SUBSCRIBE)
        # the shed mutation frame's terminal fate (control class)
        ledger_mod.record_fate("dropped", "admission_shed",
                               flowclass.CONTROL)
        if egress is not None and sender_key is not None:
            raw = Bytes(_SUBSCRIBE_SHED_FRAME)
            try:
                egress.to_user(sender_key, raw)
            finally:
                raw.release()

    # -- surfacing ------------------------------------------------------------

    def _note_shed(self, tier: str, detail: str, conn, counter) -> None:
        counter.inc()
        self.last_shed[tier] = time.monotonic()
        self.shed_counts[tier] = self.shed_counts.get(tier, 0) + 1
        rec = getattr(conn, "flightrec", None) if conn is not None \
            else flightrec.task_recorder()
        if rec is not None:
            rec.record("load-shed", detail, abnormal=True)

    def readiness_check(self) -> Tuple[bool, str]:
        """The /readyz ``admission`` check: not ready while shedding is
        recent — the load balancer steers away until the box has served
        ``ready_window_s`` without refusing work."""
        if not self.enabled:
            return True, "admission control disabled (no budgets set)"
        now = time.monotonic()
        recent = sorted(tier for tier, ts in self.last_shed.items()
                        if now - ts < self.ready_window_s)
        if recent:
            return False, f"load shedding active ({', '.join(recent)})"
        return True, "no recent load shed"

    def summary(self) -> dict:
        """Operator-facing state for ``/debug/topology``."""
        now = time.monotonic()
        return {
            "enabled": self.enabled,
            "max_user_conns": self.max_user_conns,
            "max_broker_conns": self.max_broker_conns,
            "subscribe_rate": self.subscribe_rate,
            "subscribe_burst": self.subscribe_burst,
            "shed_counts": dict(self.shed_counts),
            "last_shed_ago_s": {
                tier: round(now - ts, 3)
                for tier, ts in self.last_shed.items()},
        }
