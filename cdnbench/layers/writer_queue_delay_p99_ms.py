"""Broker transport and tasks (``proto/transport/tcp_tls.py``,
``broker/tasks/senders.py``): the 99th percentile of the head-of-line
delay of the brokers' writer queues over the window, in ms.

Source: each broker's ``cdn_writer_queue_delay_seconds`` histogram (every
class), the difference between the scrapes at the window's two ends,
summed over the brokers, interpolated inside its bucket as Prometheus's
``histogram_quantile`` does. Sends that take the inline fast path never
queue and are not observed."""

from cdnbench.common import histogram_buckets, histogram_quantile

NAME = "cdn_writer_queue_delay_seconds"


def read(run):
    total = {}
    for before, after in run.scrapes.values():
        b0 = histogram_buckets(before, NAME)
        for le, c in histogram_buckets(after, NAME).items():
            total[le] = total.get(le, 0.0) + c - b0.get(le, 0.0)
    q = histogram_quantile(0.99, total)
    return None if q is None else q * 1e3
