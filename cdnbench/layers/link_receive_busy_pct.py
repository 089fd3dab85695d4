"""Broker link (``broker/tasks/handlers.py`` ``broker_receive_loop``): the
share of the window the busier broker spent on the batches its peers
sent it, from a batch's arrival to its egress flush (deserialize, hook,
route, stage), in %.

Source: 100 x the rise of ``cdn_link_receive_seconds`` between the
scrapes at the window's two ends, the larger of the brokers', over the
window's seconds. None when no broker's moved (a program without the
counter, or no link)."""

from cdnbench.common import metric_sum

NAME = "cdn_link_receive_seconds"


def read(run):
    spent = [metric_sum(after, NAME) - metric_sum(before, NAME)
             for before, after in run.scrapes.values()]
    if not spent or max(spent) <= 0:
        return None
    return 100.0 * max(spent) / run.window_s
