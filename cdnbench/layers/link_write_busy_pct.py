"""Broker link (``proto/transport/base.py`` ``AsyncioStream`` under
``proto/transport/tcp.py``, the brokers' link transport): the share of
the window the busier broker spent in plain-TCP stream writes, in %: the
copy and the transport's write of the frames it forwards to its peer;
the drain's wait is not counted.

Source: 100 x the rise of ``cdn_stream_write_seconds{transport="tcp"}``
between the scrapes at the window's two ends, the larger of the
brokers', over the window's seconds. The users' streams are TCP+TLS and
count under their own transport, so on a broker only the link writes
here. None when no broker's moved."""

from cdnbench.common import metric_sum

NAME = "cdn_stream_write_seconds"


def read(run):
    spent = [metric_sum(after, NAME, transport="tcp")
             - metric_sum(before, NAME, transport="tcp")
             for before, after in run.scrapes.values()]
    if not spent or max(spent) <= 0:
        return None
    return 100.0 * max(spent) / run.window_s
