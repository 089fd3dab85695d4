"""Open-loop replay of HotShot views on a fixed schedule, whether or not
the system keeps up.

View ``v`` is due at ``t0 + v / views_per_s``; the views due in the
second before the window (negative ``v``) are warm-up. Its leader, node
``v mod N`` (round robin), broadcasts a ``proposal_bytes`` proposal on
the global topic and a ``da_bytes`` DA proposal on the DA topic at the
due time; every node sends a ``vote_bytes`` vote, direct to the leader
of ``v + 1``, at a time drawn uniform over ``vote_delay_ms`` after the
due time. Voting follows the schedule, not the proposal's arrival.
Every node subscribes to the global topic, and the ``da_committee``
nodes to the DA topic as well.

The work is the same for every seed, as ``pubsub``'s: the committee and
every vote's delay are drawn once, from a fixed seed, for consensus
node indices; the nodes are dealt round robin over the generators'
shares of the users (so the leaders, and the votes they collect, rotate
over the generator processes), and the seed relabels the users within
each share (``traffic.users_relabel``). A frame's sequence number is its
rank among its node's frames in sending order, and the plan maps it to
its view, so any number of views fits in a window. Every frame is timed
from when it was due. The frames, deliveries and quorums are worked out
by ``cdnbench/views_reference.py``.

A leader's process records, for each view whose votes reached the
quorum there, the view and the time of its quorum (``x_quorum_view``,
``x_quorum_ns``).
"""

from __future__ import annotations

import asyncio
import math
import time

import numpy as np

from cdnbench import traffic, views_reference

HOOK_TYPES = (traffic.VOTE,)
WARMUP_S = 1.0   # the warm-up views are due in the second before t0
_VIEW_OFFSET = 1 << 20   # keeps a warm-up view's stream index positive


def view_range(rate: float, seconds: float) -> tuple:
    """``(first, end)``: the views of a run, warm-up included; those due in
    the window are ``0 .. end - 1``."""
    return -int(math.floor(rate * WARMUP_S)), int(math.ceil(rate * seconds))


def view_due_ns(views, rate: float) -> np.ndarray:
    """Each view's due time in ns from the window's start."""
    return np.rint(np.asarray(views, np.float64) * 1e9 / rate).astype(
        np.int64)


def _uid_of(cfg: dict, seed: int) -> np.ndarray:
    """``uid_of[node]``: the seed's uid of consensus node ``node``. Nodes
    are dealt round robin over the generators' shares of the users, then
    the seed relabels the users within each share."""
    users, gens = cfg["users"], cfg["generators"]
    share = users // gens
    node = np.arange(users)
    dealt = np.where(node < share * gens, (node % gens) * share + node // gens,
                     node)
    owner = traffic.users_relabel(users, gens, seed)
    uid_of_owner = np.empty_like(owner)
    uid_of_owner[owner] = np.arange(users)
    return uid_of_owner[dealt]


def committee(cfg: dict, wl: dict, seed: int) -> np.ndarray:
    """The DA committee's uids: nodes drawn once, relabelled by the seed."""
    nodes = traffic.rng(traffic.STRUCTURE, 5).choice(
        cfg["users"], wl["da_committee"], replace=False)
    return np.sort(_uid_of(cfg, seed)[nodes])


def users_topics(cfg: dict, wl: dict, seed: int):
    da = set(committee(cfg, wl, seed).tolist())
    return [[wl["global_topic"], wl["da_topic"]] if u in da
            else [wl["global_topic"]] for u in range(cfg["users"])]


def _rate(wl: dict, rate) -> float:
    return float(wl["views_per_s"] if rate is None else rate)


def frames(cfg: dict, wl: dict, seed: int, seconds: float,
           rate: float = None) -> dict:
    """Every frame of the run, by ``views_reference.frames``, in uids."""
    rate = _rate(wl, rate)
    lo, hi = view_range(rate, seconds)
    views = np.arange(lo, hi, dtype=np.int64)
    n = cfg["users"]
    uid_of = _uid_of(cfg, seed)
    lead = uid_of[np.arange(lo, hi + 1) % n]
    d_lo, d_hi = wl["vote_delay_ms"]
    delay = np.stack([
        traffic.rng(traffic.STRUCTURE, 6, int(v) + _VIEW_OFFSET).integers(
            int(d_lo * 1e6), int(d_hi * 1e6) + 1, n)
        for v in views]) if views.size else np.empty((0, n), np.int64)
    due = view_due_ns(views, rate)
    vote_due = np.empty_like(delay)
    vote_due[:, uid_of] = due[:, None] + delay   # node order -> uid order
    return views_reference.frames(
        views, due, lead, vote_due,
        (wl["proposal_bytes"], wl["da_bytes"], wl["vote_bytes"]),
        wl["global_topic"], wl["da_topic"])


def plan(cfg: dict, wl: dict, seed: int, seconds: float,
         rate: float = None) -> dict:
    """Every node's frames in sending order (a frame's index is its
    sequence number): ``due`` in ns from the window's start (negative for
    the warm-up), ``target`` (uid of a vote, -1 for a broadcast),
    ``t0``/``t1`` (topics, -1 for none), ``size``, ``mtype`` and
    ``view``."""
    f = frames(cfg, wl, seed, seconds, rate)
    p = f["pub"]
    starts = np.flatnonzero(np.r_[True, p[1:] != p[:-1]])
    ends = np.r_[starts[1:], p.size]
    keys = ("due", "target", "t0", "t1", "size", "mtype", "view")
    return {int(p[a]): {k: f[k][a:b] for k in keys}
            for a, b in zip(starts, ends)}


class _State:
    def __init__(self, vote_view: dict, quorum: int):
        self.vote_view = vote_view   # (pub << SEQ_BITS | seq) -> view
        self.quorum = quorum
        self.votes = {}              # view -> voters seen at its leader
        self.quorum_view = []
        self.quorum_ns = []

    def vote(self, pub: int, seq: int, now_ns: int) -> None:
        view = self.vote_view.get((pub << traffic.SEQ_BITS) | seq)
        if view is None:
            return
        voters = self.votes.setdefault(view, set())
        if pub in voters:
            return
        voters.add(pub)
        if len(voters) == self.quorum:
            self.quorum_view.append(view)
            self.quorum_ns.append(now_ns)


async def drive(gen) -> None:
    """Each of this process's nodes sends its frames, each at its due time
    or, when late, at once."""
    sched = plan(gen.cfg, gen.wl, gen.seed, gen.seconds, gen.spec.get("rate"))
    mine = [u for u in sched if u in gen.clients]
    f_pub, f_seq, f_view = [], [], []
    for u, s in sched.items():
        local = np.isin(s["target"], mine)
        if local.any():
            f_pub.append(np.full(int(local.sum()), u, np.int64))
            f_seq.append(np.flatnonzero(local))
            f_view.append(s["view"][local])
    vote_view = {}
    if f_pub:
        codes = (np.concatenate(f_pub) << traffic.SEQ_BITS) | np.concatenate(
            f_seq)
        vote_view = dict(zip(codes.tolist(), np.concatenate(f_view).tolist()))
    st = _State(vote_view, gen.wl["quorum"])
    for early in getattr(gen, "early_votes", ()):
        st.vote(*early)
    gen.state = st
    gen.extra["quorum_view"] = st.quorum_view
    gen.extra["quorum_ns"] = st.quorum_ns

    async def node(u: int) -> None:
        s = sched[u]
        target, t0, mtype, size = (s["target"].tolist(), s["t0"].tolist(),
                                   s["mtype"].tolist(), s["size"].tolist())
        for i, due in enumerate((s["due"] + gen.t0).tolist()):
            wait = due - time.monotonic_ns()
            if wait > 0:
                await asyncio.sleep(wait / 1e9)
            await gen.send(u, mtype[i], size[i], due, target=target[i],
                           topics=() if target[i] >= 0 else (t0[i],))

    await asyncio.gather(*(node(u) for u in mine))


def on_message(gen, uid: int, mtype: int, pub: int, seq: int,
               ref_ns: int) -> None:
    """At a leader: count each distinct voter of the view the vote is for,
    and record the view's quorum when the count reaches it. A vote that
    arrives before this process has made its plan waits for it."""
    st = getattr(gen, "state", None)
    if st is None:
        if not hasattr(gen, "early_votes"):
            gen.early_votes = []
        gen.early_votes.append((pub, seq, time.monotonic_ns()))
        return
    st.vote(pub, seq, time.monotonic_ns())


def checks(cfg: dict, wl: dict, seed: int, seconds: float, sends: dict,
           extra: dict, rate: float = None) -> dict:
    """The schedule against what was sent: every frame planned went out,
    once, as planned (``unsent``, ``unplanned``, limits 0); and every view
    due in the window whose votes reach the quorum by the reference
    reached it at its next leader (``unclosed_views``, limit 0)."""
    f = frames(cfg, wl, seed, seconds, rate)
    want_u = np.unique(traffic.code(0, f["pub"], f["seq"]))
    have = traffic.code(0, sends["pub"], sends["seq"])
    have_u, counts = np.unique(have, return_counts=True)
    q = views_reference.quorums(f, wl["quorum"])
    due = q["view"][(q["view"] >= 0) & q["closed"]]
    closed = np.unique(extra.get("quorum_view", np.empty(0, np.int64)))
    return dict(unsent=int(np.setdiff1d(want_u, have_u).size),
                unplanned=int(np.setdiff1d(have_u, want_u).size
                              + (counts - 1).sum()),
                unclosed_views=int(np.setdiff1d(due, closed).size))
