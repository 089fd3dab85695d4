"""Out-of-process accelerator reachability probe.

A wedged card or driver can hang the first CUDA call of a process, and an
in-process hang cannot be timed out. A caller therefore probes in a
SUBPROCESS before it touches the card in-process, and stops with the
probe's reason instead of hanging the run.

The CUDA twin of ``pushcdn_tpu.testing.accel_probe``: the probe is
``torch.zeros(1, device="cuda").cpu()``. The JAX module's
``force_cpu_if_unreachable`` (switch the process to the CPU when the card
is unreachable) has no twin: this package never carries on on the CPU
unasked, so :func:`require_accelerator` raises instead. The module itself
never imports torch.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
from typing import Tuple

_PROBE = 'import torch; torch.zeros(1, device="cuda").cpu()'

_MEMO: "Tuple[bool, str] | None" = None


def accelerator_reachable(timeout_s: float = 120.0,
                          use_cache: bool = True) -> Tuple[bool, str]:
    """Return ``(ok, reason)``; ``reason`` is empty when reachable.

    The result is memoized per process (``use_cache=False`` re-probes):
    the probe costs a full torch-import subprocess — and the whole
    timeout when the card is wedged — so callers that consult it more than
    once pay once.

    The probe runs in its own session so that on timeout the WHOLE
    process group is killed — a wedged runtime can fork helpers that
    inherit the output pipes, and killing only the direct child would
    leave ``communicate()`` blocked on pipe EOF forever (the exact hang
    this probe exists to prevent). It never raises.
    """
    global _MEMO
    if use_cache and _MEMO is not None:
        return _MEMO
    proc = None
    try:
        proc = subprocess.Popen(
            [sys.executable, "-c", _PROBE],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            start_new_session=True)
        _, stderr = proc.communicate(timeout=timeout_s)
        if proc.returncode == 0:
            result = True, ""
        else:
            tail = stderr.decode(errors="replace").strip().splitlines()
            result = False, ("probe exited %d: %s"
                             % (proc.returncode,
                                tail[-1] if tail else ""))[:300]
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            try:
                proc.kill()  # fall back to the direct child
            except OSError:
                pass  # this path must degrade to a report, never raise
        try:
            proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            # Unkillable child (e.g. stuck in uninterruptible IO on the
            # device fd): report rather than hang — the zombie is leaked
            # deliberately, the alternative is blocking forever.
            pass
        result = False, (f"probe timed out after {timeout_s:.0f}s "
                         "(wedged card or driver?)")
    except (subprocess.SubprocessError, OSError) as exc:
        result = False, f"probe failed to launch: {exc!r}"[:300]
    _MEMO = result
    return result


def require_accelerator(label: str, timeout_s: float = 120.0) -> None:
    """Probe once (memoized) and raise ``RuntimeError`` naming ``label``
    and the probe's reason when the card is unreachable. Call it before
    anything in the process touches CUDA."""
    ok, why = accelerator_reachable(timeout_s)
    if not ok:
        raise RuntimeError(f"{label}: CUDA device unreachable ({why})")
