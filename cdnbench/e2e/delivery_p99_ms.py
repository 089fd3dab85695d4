"""The 99th percentile of publish-to-receive latency of every delivery
due in the window: in an open loop timed from when the publish was due,
in a closed one from when it was sent; a delivery missing at the end
counts as late as the whole wait for it (``Run.latencies_ms``)."""

from cdnbench.common import percentile


def read(run):
    lat = run.latencies_ms()
    return percentile(lat, 0.99) if lat.size else None
