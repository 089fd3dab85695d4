"""Routing step (``parallel/router.py`` in the plane's worker thread):
the host-clock time of a step's device phase, in ms a step: the state
build, uploads, the CRDT fold, the kernel's launch and the readbacks, to
set beside the kernel's device time.

Source: 1000 x the rise of ``cdn_plane_pump_seconds{phase="device"}``
over the rise of ``cdn_device_steps``, between the scrapes at the
window's two ends, summed over the brokers. None when either did not
move."""

from cdnbench.common import metric_sum


def read(run):
    device = steps = 0.0
    for before, after in run.scrapes.values():
        device += (metric_sum(after, "cdn_plane_pump_seconds",
                              phase="device")
                   - metric_sum(before, "cdn_plane_pump_seconds",
                                phase="device"))
        steps += (metric_sum(after, "cdn_device_steps")
                  - metric_sum(before, "cdn_device_steps"))
    if device <= 0 or steps <= 0:
        return None
    return 1000.0 * device / steps
