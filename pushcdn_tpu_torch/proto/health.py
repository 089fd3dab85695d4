"""Liveness / readiness plane: ``GET /healthz`` and ``GET /readyz``.

Push-CDN's premise is a *centrally tracked* topology — operators (and the
load balancer in front of a marshal fleet) need a machine-readable answer
to "is this process healthy" and "should it receive traffic" that is
cheaper and stricter than scraping /metrics and eyeballing gauges.

Two registries of named checks:

- **liveness** (``/healthz``): "is the event loop making progress" — the
  built-in checks cover loop lag (the supervised sampler's most recent
  wakeup ran on time) and the supervised background samplers being alive.
  A failing liveness check means restart-me; the HTTP 200/503 split is
  what a container runtime probes.
- **readiness** (``/readyz``): "can this process do its job right now" —
  components register their own checks (broker: listeners bound, discovery
  reachable, mesh formed-or-intentionally-solo; marshal: listener +
  discovery; client binary: broker link up). Readiness additionally gates
  on the process-wide **drain latch**: :func:`set_draining` flips /readyz
  to 503 *before* listeners close, so a load balancer stops routing to a
  broker while its in-flight traffic still drains.

Every readiness TRANSITION is recorded in the process flight recorder
(``ready-flip`` event, with the failing checks' names) so a post-mortem
``/debug/flightrec`` trail shows *why* a process left rotation, not just
that it did.

Checks are callables returning ``bool`` or ``(bool, detail)``; they may be
coroutines (the readiness evaluation is awaited by the HTTP handler — the
broker's discovery probe uses this for its cached-TTL active probe). A
check that raises reports unhealthy with the exception text, never takes
the endpoint down.

**This module never initializes CUDA** (same rule as ``cdn_build_info``):
a /healthz probe against a broker that never touched an accelerator must
not pay a multi-second backend bring-up.
"""

from __future__ import annotations

import inspect
import json
import time
from typing import Callable, Dict, Optional, Tuple

# name -> callable() -> bool | (bool, detail) | awaitable of either
LIVENESS: Dict[str, Callable] = {}
READINESS: Dict[str, Callable] = {}

# process-wide drain latch: a non-None reason forces /readyz to 503
# regardless of the registered checks (set BEFORE listeners close)
_draining: Optional[str] = None

# last readiness verdict (overall bool, sorted failing-check names) — a
# flip of EITHER records a ready-flip event, so a change of *reason*
# while staying not-ready still shows up in the trail
_last_state: Optional[tuple] = None


def register_liveness(name: str, fn: Callable) -> None:
    LIVENESS[name] = fn


def register_readiness(name: str, fn: Callable) -> None:
    READINESS[name] = fn


def unregister(name: str) -> None:
    LIVENESS.pop(name, None)
    READINESS.pop(name, None)


def draining() -> Optional[str]:
    return _draining


def set_draining(reason: str = "shutdown") -> None:
    """Flip readiness to false process-wide (the drain latch). Records the
    ``ready-flip`` flight-recorder event immediately — not at the next
    /readyz scrape — so the trail timestamps the moment the process left
    rotation even if nobody probes it again."""
    global _draining, _last_state
    if _draining is not None:
        return
    _draining = reason
    state = (False, ("draining",))
    if _last_state != state:
        _last_state = state
        _record_flip(False, [f"draining: {reason}"], abnormal=False)


def clear_draining() -> None:
    """Re-enter rotation (tests; aborted shutdowns)."""
    global _draining
    _draining = None


def _record_flip(ready: bool, failing, abnormal: bool) -> None:
    from pushcdn_tpu_torch.proto import flightrec
    detail = "ready" if ready else f"NOT ready ({'; '.join(failing)})"
    flightrec.task_recorder().record("ready-flip", detail, abnormal=abnormal)


async def _run_checks(checks: Dict[str, Callable]) -> Dict[str, Tuple[bool, str]]:
    out: Dict[str, Tuple[bool, str]] = {}
    for name, fn in list(checks.items()):
        try:
            res = fn()
            if inspect.isawaitable(res):
                res = await res
        except Exception as exc:  # a broken check reports, never crashes
            res = (False, f"check raised: {exc!r}")
        if isinstance(res, tuple):
            ok, detail = bool(res[0]), str(res[1])
        else:
            ok, detail = bool(res), ""
        out[name] = (ok, detail)
    return out


def _body(ok: bool, checks: Dict[str, Tuple[bool, str]],
          extra: Optional[dict] = None) -> str:
    doc = {
        "status": "ok" if ok else "unhealthy",
        "checks": {name: {"ok": c_ok, "detail": detail}
                   for name, (c_ok, detail) in sorted(checks.items())},
        "ts": time.time(),
    }
    if extra:
        doc.update(extra)
    return json.dumps(doc, separators=(",", ":")) + "\n"


async def render_healthz() -> Tuple[int, str]:
    """Evaluate liveness: (http_status, json_body)."""
    checks = await _run_checks(LIVENESS)
    ok = all(c_ok for c_ok, _ in checks.values())
    return (200 if ok else 503), _body(ok, checks)


async def render_readyz() -> Tuple[int, str]:
    """Evaluate readiness: (http_status, json_body). Detects transitions
    — of the overall verdict OR of the failing-check set — and records
    them as flight-recorder ``ready-flip`` events."""
    global _last_state
    checks = await _run_checks(READINESS)
    if _draining is not None:
        checks = dict(checks)
        checks["draining"] = (False, _draining)
    failing_names = tuple(sorted(
        name for name, (c_ok, _d) in checks.items() if not c_ok))
    failing = [f"{name}: {checks[name][1]}" if checks[name][1] else name
               for name in failing_names]
    ready = not failing_names
    state = (ready, failing_names)
    if state != _last_state:
        # an unexpected check failure is abnormal (arms the recorder so the
        # trail hits the diagnostics log); an intentional drain is not
        _record_flip(ready, failing,
                     abnormal=not ready and failing_names != ("draining",))
        _last_state = state
    return (200 if ready else 503), _body(
        ready, checks, extra={"draining": _draining is not None})


def reset_for_tests() -> None:
    """Drop all registrations + latches (test isolation)."""
    global _draining, _last_state
    LIVENESS.clear()
    READINESS.clear()
    _draining = None
    _last_state = None
