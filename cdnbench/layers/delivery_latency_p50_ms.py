"""The whole path, publish to receive: the median latency of every
delivery due in the window, as ``e2e/delivery_p50_ms`` reads it. Per
layer where the tail spreads too widely between runs on the card's host
to hold an end-to-end bound."""

from cdnbench.e2e.delivery_p50_ms import read  # noqa: F401
