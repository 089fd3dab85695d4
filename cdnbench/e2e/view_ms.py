"""The window's milliseconds over the HotShot views closed in it (a view
closes when its next leader holds its quorum of votes)."""


def read(run):
    closed = run.views_closed_in_window()
    return run.window_s * 1e3 / closed if closed else None
