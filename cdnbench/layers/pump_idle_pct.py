"""Device plane (``broker/device_plane.py``, the pump): the share of the
window in which the plane's pump had nothing staged, in %.

Source: 100 x the rise of ``cdn_plane_pump_seconds{phase="idle"}``
between the scrapes at the window's two ends, summed over the brokers,
over the window's seconds; 0 where the pump never waited for a frame.
The pump adds the phases up to a step's snapshot when it takes it and
the rest when the step ends, and a scrape adds an idle phase still
open, so each end of the window is off by at most the step in flight.
None when no phase of the family moved (a program without it, or no
step)."""

from cdnbench.common import metric_sum

NAME = "cdn_plane_pump_seconds"


def read(run):
    idle = moved = 0.0
    for before, after in run.scrapes.values():
        idle += (metric_sum(after, NAME, phase="idle")
                 - metric_sum(before, NAME, phase="idle"))
        moved += metric_sum(after, NAME) - metric_sum(before, NAME)
    if moved <= 0:
        return None
    return 100.0 * idle / run.window_s
