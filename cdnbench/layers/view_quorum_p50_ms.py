"""The consensus round (``cdnbench/traffic/views_replay.py``): the median,
over the views due in the window, of the time from a view's due time to
its quorum at its next leader, in ms.

Source: the host clock of the leaders' generator processes, which record
the moment a view's distinct votes reach the quorum (``x_quorum_view``,
``x_quorum_ns``), less the view's due time on the schedule. None where
the traffic has no view schedule or no view due in the window closed."""

from cdnbench.common import percentile


def read(run):
    rate = run.rate if run.rate is not None else run.wl.get("views_per_s")
    view = run.extra.get("quorum_view")
    if rate is None or view is None or not view.size:
        return None
    from cdnbench.traffic import views_replay
    _, end = views_replay.view_range(rate, run.window_s)
    inside = (view >= 0) & (view < end)
    if not inside.any():
        return None
    due = run.t0 + views_replay.view_due_ns(view[inside], rate)
    return percentile((run.extra["quorum_ns"][inside] - due) / 1e6, 0.50)
