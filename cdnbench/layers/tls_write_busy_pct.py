"""Broker transport and tasks (``proto/transport/base.py``
``AsyncioStream`` under ``proto/transport/tcp_tls.py``): the share of
the window the brokers spent in TLS writes, in %: the copy and asyncio's
SSL transport encrypting and handing the bytes to the socket, on the
broker's interpreter; the drain's wait is not counted.

Source: 100 x the rise of ``cdn_stream_write_seconds{transport="tcp+tls"}``
between the scrapes at the window's two ends, summed over the brokers,
over the window's seconds. None when it did not move."""

from cdnbench.common import metric_sum


def read(run):
    spent = 0.0
    for before, after in run.scrapes.values():
        spent += (metric_sum(after, "cdn_stream_write_seconds",
                             transport="tcp+tls")
                  - metric_sum(before, "cdn_stream_write_seconds",
                               transport="tcp+tls"))
    if spent <= 0:
        return None
    return 100.0 * spent / run.window_s
