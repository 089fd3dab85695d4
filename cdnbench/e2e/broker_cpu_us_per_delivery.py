"""The brokers' CPU time over the window, in µs, per delivery matched in
the window (the count ``delivered_msgs_per_s`` divides).

Source: the harness's own reading of ``/proc`` (``proctree``) at the
window's two ends, each broker's whole process tree, user and system
time, summed over the brokers; never the program's counters. The
marshal and the load generators are not counted (their CPU is printed
on stderr as ``cpu_cores_in_window``). None where a broker's tree could
not be read at both ends or nothing was matched."""

from cdnbench.proctree import cpu_s


def read(run):
    if not run.matched_in_window or not run.broker_trees:
        return None
    spent = [cpu_s(before, after) for before, after in
             run.broker_trees.values()]
    if None in spent:
        return None
    return 1e6 * sum(spent) / run.matched_in_window
