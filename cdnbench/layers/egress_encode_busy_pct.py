"""Native egress (``native/framing.cpp`` ``egress_encode`` through
``broker/pump_common.py``): the share of the window the brokers spent
encoding delivery matrices into wire streams, in %.

Source: 100 x the rise of ``cdn_native_seconds{kernel="egress_encode"}``
between the scrapes at the window's two ends, summed over the brokers,
over the window's seconds. None when no encode ran."""

from cdnbench.common import metric_sum


def read(run):
    spent = 0.0
    for before, after in run.scrapes.values():
        spent += (metric_sum(after, "cdn_native_seconds",
                             kernel="egress_encode")
                  - metric_sum(before, "cdn_native_seconds",
                               kernel="egress_encode"))
    if spent <= 0:
        return None
    return 100.0 * spent / run.window_s
