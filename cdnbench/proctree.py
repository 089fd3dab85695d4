"""CPU time of a process and every process below it, from ``/proc``.

A sample holds, for each process of the tree at one moment, its user and
system CPU ticks together with those of the children it has reaped
(``utime + stime + cutime + cstime`` of ``/proc/<pid>/stat``). Between
two samples the tree used their difference of sums: a descendant alive
at both ends is read in full, one reaped in between comes up through its
parent's ``cutime`` and ``cstime``, and what it had used by the first
sample is taken off with it. A descendant whose parent died and left it
to a reaper outside the tree is lost from the second sum.

Imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

PROC = "/proc"

# fields of /proc/<pid>/stat after the ")" that ends the command's name
PPID, UTIME, STIME, CUTIME, CSTIME = 1, 11, 12, 13, 14


def parse_stat(text: str) -> dict:
    """``ppid`` and the CPU ticks (own, and of reaped children) of one
    ``/proc/<pid>/stat`` line."""
    f = text.rpartition(")")[2].split()
    return dict(ppid=int(f[PPID]), own=int(f[UTIME]) + int(f[STIME]),
                reaped=int(f[CUTIME]) + int(f[CSTIME]))


def read_stats(proc: str = PROC) -> Dict[int, dict]:
    """Every process's parsed stat, by pid."""
    out = {}
    for entry in os.listdir(proc):
        if not entry.isdigit():
            continue
        try:
            with open(os.path.join(proc, entry, "stat")) as f:
                out[int(entry)] = parse_stat(f.read())
        except (OSError, ValueError, IndexError):
            continue   # gone between the listing and the read
    return out


def sample(roots: Dict[str, int], proc: str = PROC
           ) -> Dict[str, Optional[Dict[int, int]]]:
    """For each named root pid, ``{pid: ticks}`` of it and each of its
    descendants; None for a root that is gone."""
    stats = read_stats(proc)
    children: Dict[int, list] = {}
    for pid, st in stats.items():
        children.setdefault(st["ppid"], []).append(pid)
    out: Dict[str, Optional[Dict[int, int]]] = {}
    for name, root in roots.items():
        if root not in stats:
            out[name] = None
            continue
        tree, todo = {}, [root]
        while todo:
            pid = todo.pop()
            if pid in tree:
                continue
            tree[pid] = stats[pid]["own"] + stats[pid]["reaped"]
            todo += children.get(pid, [])
        out[name] = tree
    return out


def cpu_s(before: Optional[Dict[int, int]], after: Optional[Dict[int, int]],
          clk_tck: Optional[int] = None) -> Optional[float]:
    """CPU seconds the tree used between two samples of it; None where
    either is missing."""
    if before is None or after is None:
        return None
    tck = clk_tck or os.sysconf("SC_CLK_TCK")
    return (sum(after.values()) - sum(before.values())) / tck
