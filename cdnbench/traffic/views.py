"""Closed-loop HotShot views.

Every node subscribes to the Global topic, and a committee of
``da_committee`` nodes drawn from the seed to the DA topic as well. View
``v`` is led by node ``v mod N``: the leader broadcasts a proposal on
Global and a DA proposal on DA; every node that receives the proposal
sends a vote, direct to the next view's leader; that leader closes view
``v`` once it holds ``quorum`` distinct votes and has seen the proposal
itself, and proposes view ``v + 1`` at once, as long as the window is
open. View 0 is proposed at the window's start. A message is timed from
when it was sent.

A leader's process records, for each view it closed, the view and the
time of its quorum (``x_quorum_view``, ``x_quorum_ns``).
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from cdnbench import traffic

HOOK_TYPES = (traffic.PROPOSAL, traffic.VOTE)


def committee(cfg: dict, wl: dict, seed: int) -> np.ndarray:
    return np.sort(traffic.rng(seed, 4).choice(cfg["users"],
                                               wl["da_committee"],
                                               replace=False))


def users_topics(cfg: dict, wl: dict, seed: int):
    da = set(committee(cfg, wl, seed).tolist())
    return [[wl["global_topic"], wl["da_topic"]] if u in da
            else [wl["global_topic"]] for u in range(cfg["users"])]


class _State:
    def __init__(self):
        self.votes = {}        # view -> set of voters (at its next leader)
        self.seen = set()      # views whose proposal a local leader saw
        self.proposed = set()  # views proposed from this process
        self.quorum_view = []
        self.quorum_ns = []
        self.tasks = set()


def _spawn(gen, coro) -> None:
    t = asyncio.ensure_future(coro)
    gen.state.tasks.add(t)
    t.add_done_callback(gen.state.tasks.discard)


async def _propose(gen, view: int) -> None:
    wl = gen.wl
    leader = view % gen.cfg["users"]
    gen.state.proposed.add(view)
    now = time.monotonic_ns()
    await gen.send(leader, traffic.PROPOSAL, wl["proposal_bytes"], now,
                   topics=(wl["global_topic"],))
    await gen.send(leader, traffic.DA, wl["da_bytes"], now,
                   topics=(wl["da_topic"],))


def _maybe_close(gen, view: int) -> None:
    """At the leader of ``view + 1``: close ``view`` on a quorum once the
    proposal was seen here, and propose the next view."""
    st = gen.state
    votes = st.votes.get(view)
    if (votes is None or len(votes) < gen.wl["quorum"]
            or view not in st.seen or view + 1 in st.proposed):
        return
    st.quorum_view.append(view)
    st.quorum_ns.append(time.monotonic_ns())
    st.proposed.add(view + 1)
    if time.monotonic_ns() < gen.t_end:
        _spawn(gen, _propose(gen, view + 1))


def on_message(gen, uid: int, mtype: int, pub: int, seq: int,
               ref_ns: int) -> None:
    n = gen.cfg["users"]
    st = gen.state
    if mtype == traffic.PROPOSAL:
        # a proposal's view is its leader's index: a window holds fewer
        # than n views, so a node leads one view at most
        view = pub
        if (view + 1) % n == uid:
            st.seen.add(view)
        _spawn(gen, gen.send(uid, traffic.VOTE, gen.wl["vote_bytes"],
                             time.monotonic_ns(), target=(view + 1) % n))
        if (view + 1) % n == uid:
            _maybe_close(gen, view)
    elif mtype == traffic.VOTE:
        view = (uid - 1) % n
        # the votes this leader collects are for the one view before its
        # own; a window holds fewer than n views
        st.votes.setdefault(view, set()).add(pub)
        _maybe_close(gen, view)


async def drive(gen) -> None:
    gen.state = _State()
    gen.extra["quorum_view"] = gen.state.quorum_view
    gen.extra["quorum_ns"] = gen.state.quorum_ns
    if 0 in gen.clients:
        wait = gen.t0 - time.monotonic_ns()
        if wait > 0:
            await asyncio.sleep(wait / 1e9)
        await _propose(gen, 0)
    await asyncio.Event().wait()


def proposals(sends: dict, wl: dict) -> np.ndarray:
    """The views proposed: a proposal's publisher is its view."""
    return np.sort(sends["pub"][sends["mtype"] == traffic.PROPOSAL])


def checks(cfg: dict, wl: dict, seed: int, seconds: float, sends: dict,
           extra: dict, rate: float = None) -> dict:
    """Every view proposed closed on its quorum (``unclosed_views``, limit
    0), and views were proposed one after another from 0, each once
    (``bad_proposals``, limit 0)."""
    views = proposals(sends, wl)
    closed = set(extra.get("quorum_view", np.empty(0, np.int64)).tolist())
    bad = (int((views != np.arange(views.size)).sum())
           + int(views.size >= cfg["users"])) if views.size else 1
    return dict(unclosed_views=int(sum(1 for v in views.tolist()
                                       if v not in closed)),
                bad_proposals=bad)
