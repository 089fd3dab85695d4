"""The plain reference: who should receive what, and the comparison that
decides ``correct``.

Imports numpy alone: nothing of JAX, of the JAX package or of the program.
It is handed the users' topics and the messages the load generators sent
(the benchmark's own records, made from the seed), works out every
delivery each user should receive, and judges the deliveries the users
got: as a multiset, and in per-publisher order.

A delivery is coded ``receiver << 40 | publisher << 28 | sequence``
(``traffic.code``). A broadcast on topics ``T`` is due once to every user
subscribed to any topic of ``T``, its publisher included; a direct once to
its target.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

SEQ_BITS = 28
CORRUPT = np.int64(1) << 62
CHUNK = 4096


def expected(topics: Sequence[Sequence[int]], num_topics: int,
             pub, seq, target, t0, t1) -> np.ndarray:
    """Every delivery due for these sends, as sorted codes. ``target`` is
    a direct's receiver (-1 for a broadcast); ``t0``/``t1`` a broadcast's
    topics (-1 for none)."""
    users = len(topics)
    member = np.zeros((num_topics + 1, users), dtype=bool)  # row -1: none
    for u, ts in enumerate(topics):
        member[list(ts), u] = True
    pub, seq, target, t0, t1 = (np.asarray(a, np.int64)
                                for a in (pub, seq, target, t0, t1))
    sender = (pub << SEQ_BITS) | seq
    out: List[np.ndarray] = []
    direct = target >= 0
    out.append((target[direct] << 40) | sender[direct])
    b = np.flatnonzero(~direct)
    for lo in range(0, b.size, CHUNK):
        idx = b[lo:lo + CHUNK]
        hit = member[t0[idx]] | member[t1[idx]]
        rows, users_hit = np.nonzero(hit)
        out.append((users_hit.astype(np.int64) << 40) | sender[idx][rows])
    return np.sort(np.concatenate(out)) if out else np.empty(0, np.int64)


def multiset_diff(want: np.ndarray, got: np.ndarray):
    """``(missing, extra)``: the codes of ``want`` not matched in ``got``
    and those of ``got`` beyond ``want``, each with multiplicity."""
    wv, wc = np.unique(want, return_counts=True)
    gv, gc = np.unique(got, return_counts=True)
    allv = np.union1d(wv, gv)
    w = np.zeros(allv.size, np.int64)
    g = np.zeros(allv.size, np.int64)
    w[np.searchsorted(allv, wv)] = wc
    g[np.searchsorted(allv, gv)] = gc
    return (np.repeat(allv, np.clip(w - g, 0, None)),
            np.repeat(allv, np.clip(g - w, 0, None)))


def out_of_order(codes: np.ndarray) -> int:
    """Deliveries that did not arrive after the one before them from the
    same publisher at the same receiver. ``codes`` are in arrival order
    for each receiver (the records of different receivers may
    interleave)."""
    codes = np.asarray(codes, np.int64)
    if codes.size < 2:
        return 0
    stream = codes >> SEQ_BITS           # receiver and publisher
    seq = codes & ((1 << SEQ_BITS) - 1)
    order = np.argsort(stream, kind="stable")
    s, q = stream[order], seq[order]
    same = s[1:] == s[:-1]
    return int((same & (q[1:] <= q[:-1])).sum())


def judge(want: np.ndarray, got: np.ndarray) -> Dict[str, int]:
    """The numbers ``correct`` compares, each against the limit 0:
    deliveries missing, deliveries extra (a duplicate, or one to a user
    not due it), deliveries out of per-publisher order, and deliveries
    whose bytes differ from what was sent (flagged ``CORRUPT`` by the
    receiver; such a delivery matches nothing, so it is missing too)."""
    got = np.asarray(got, np.int64)
    bad = (got & CORRUPT) != 0
    missing, extra = multiset_diff(want, got[~bad])
    return dict(missing=int(missing.size), extra=int(extra.size),
                out_of_order=out_of_order(got & ~CORRUPT),
                corrupt=int(bad.sum()))
