"""The whole path, publish to receive: the 99th percentile of latency of
every delivery due in the window, as ``e2e/delivery_p99_ms`` reads it (a
delivery missing at the end counts as late as the whole wait). Per layer
where the tail spreads too widely between runs on the card's host to hold
an end-to-end bound."""

from cdnbench.e2e.delivery_p99_ms import read  # noqa: F401
