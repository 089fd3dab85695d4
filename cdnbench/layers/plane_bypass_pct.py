"""Device plane (``broker/device_plane.py``, staging): the share of the
frames offered to the plane's staging that the idle bypass sent to the
host path, of those it bypassed or staged, in %.

Source: 100 x the rise of ``cdn_plane_stage_frames{result="bypass"}``
over the rise of it plus ``{result="staged"}``, between the scrapes at
the window's two ends, summed over the brokers. Frames the plane cannot
take (``ineligible``) and refused attempts (``full``) are left out. None
when neither moved."""

from cdnbench.common import metric_sum


def read(run):
    bypass = staged = 0.0
    for before, after in run.scrapes.values():
        bypass += (metric_sum(after, "cdn_plane_stage_frames",
                              result="bypass")
                   - metric_sum(before, "cdn_plane_stage_frames",
                                result="bypass"))
        staged += (metric_sum(after, "cdn_plane_stage_frames",
                              result="staged")
                   - metric_sum(before, "cdn_plane_stage_frames",
                                result="staged"))
    if bypass + staged <= 0:
        return None
    return 100.0 * bypass / (bypass + staged)
