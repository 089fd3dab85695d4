"""The median publish-to-receive latency of the deliveries due in the
window (see ``Run.latencies_ms``)."""

from cdnbench.common import percentile


def read(run):
    lat = run.latencies_ms()
    return percentile(lat, 0.50) if lat.size else None
