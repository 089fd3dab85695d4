"""Deliveries received in the window that the oracle expects, each once,
over the window's seconds (host clock)."""


def read(run):
    return run.matched_in_window / run.window_s
