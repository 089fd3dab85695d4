"""Device plane (``broker/device_plane.py``, the pump): the share of the
window in which the pump waited for the interpreter, in %: the loop's
lateness in waking the pump once a frame was staged (``wake``), the
worker thread's start (``handoff``) and the loop's resumption after the
step (``resume``).

Source: 100 x the rise of ``cdn_plane_pump_seconds`` over the phases
``wake``, ``handoff`` and ``resume`` between the scrapes at the
window's two ends, summed over the brokers, over the window's seconds.
None when no phase of the family moved."""

from cdnbench.common import metric_sum

NAME = "cdn_plane_pump_seconds"
PHASES = ("wake", "handoff", "resume")


def read(run):
    wait = moved = 0.0
    for before, after in run.scrapes.values():
        for phase in PHASES:
            wait += (metric_sum(after, NAME, phase=phase)
                     - metric_sum(before, NAME, phase=phase))
        moved += metric_sum(after, NAME) - metric_sum(before, NAME)
    if moved <= 0:
        return None
    return 100.0 * wait / run.window_s
