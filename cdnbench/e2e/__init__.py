"""The end-to-end metrics, one module each, found by the metric's name.

Each module's ``read(run)`` takes the finished run (``run.Run``: the
window, the deliveries and their latencies, the set-up time) and returns
the metric's value, or None where the run has nothing to read.
"""
