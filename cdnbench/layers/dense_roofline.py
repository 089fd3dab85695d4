"""Kernels (``csrc/delivery_matrix.cu`` through
``ops/delivery_kernel.py``): the dense delivery kernel's share of its
roofline over the window's launches, in %.

Source: the least time each launch's own inputs allow
(``roofline.dense_work`` and ``bound``: bytes at 3.35 TB/s or 32-bit
integer operations at 16.7e12 a second), recorded by the broker
launcher's wrapper in traced runs, summed over every broker, over the
launches' device time from ``torch.profiler``. A mean bound per launch
over a mean time per launch, so a launch at an edge of the window that
one side counts and the other misses moves nothing. None where either
side has no launch."""


def read(run):
    launches = bound_s = trace_n = trace_s = 0
    for t in run.traces.values():
        d = t.get("dense") or {}
        launches += d.get("launches", 0)
        bound_s += d.get("bound_s", 0.0)
        trace_n += d.get("trace_launches", 0)
        trace_s += d.get("trace_s", 0.0)
    if not launches or not trace_n or trace_s <= 0:
        return None
    return 100.0 * (bound_s / launches) / (trace_s / trace_n)
