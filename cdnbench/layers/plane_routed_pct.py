"""Device plane (``broker/device_plane.py``): the share of the users'
deliveries in the window that the plane's kernel routed, in %.

Source: 100 x the rise of ``cdn_device_messages_routed`` over the rise of
it plus ``cdn_egress_frames{peer="user"}``, between the scrapes at the
window's two ends, summed over the brokers. The plane's egress does not
count in ``cdn_egress_frames``; the depth-1 bypass and the host path
do."""

from cdnbench.common import metric_sum


def read(run):
    routed = user = 0.0
    for before, after in run.scrapes.values():
        routed += (metric_sum(after, "cdn_device_messages_routed")
                   - metric_sum(before, "cdn_device_messages_routed"))
        user += (metric_sum(after, "cdn_egress_frames", peer="user")
                 - metric_sum(before, "cdn_egress_frames", peer="user"))
    if routed + user <= 0:
        return None
    return 100.0 * routed / (routed + user)
