"""The per-layer metrics' readers, one module per metric family, found by
the part of the metric's name before its first dot (the suffix names the
end-to-end metric it moves in its cell).

Each module's ``read(run)`` takes the finished traced run (``run.Run``:
each broker's ``/metrics`` scraped at the window's two ends, and each
broker's trace summary from ``broker_launch``) and returns the metric's
value, or None when it finds nothing to read; the harness then leaves the
metric out of the line.
"""
