"""Device (the H100 under the broker processes): the share of the window
in which no operation ran on the card, in %.

Source: ``torch.profiler`` over CUDA activity in each broker process
(kernels, copies and memsets): 100 x (1 - the union of their device
intervals / the window), the busy seconds summed over the brokers that
share the card. None where the profiler saw no device operation (the
harness then fails a traced run)."""


def read(run):
    busy = run.device_busy_s()
    if busy is None:
        return None
    return 100.0 * (1.0 - busy / run.trace_window_s())
