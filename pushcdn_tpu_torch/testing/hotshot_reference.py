"""The plain reference of a HotShot view replay: the frames a schedule
sends, every delivery they are due, each view's votes at its next leader
and whether they reach the quorum, and the frames that must cross the
link between brokers.

Imports numpy alone and nothing else of the port (nor JAX, nor the JAX
package): a broker does no arithmetic that torch would do, so the
reference is plain Python. The benchmark keeps a copy of its own,
``cdnbench/views_reference.py``; the two agree on seeded schedules
(``tests/test_torch_hotshot_replay.py``).

A view ``views[i]`` is led by ``leader[i]``: at ``view_due_ns[i]`` it
broadcasts a proposal on the global topic and a DA proposal on the DA
topic, and every node ``u`` sends a vote, direct to ``leader[i + 1]``
(the next view's leader), at ``vote_due_ns[i, u]``. A node's frames go
out in order of their due times (a proposal before its DA proposal,
both before a vote due at the same instant), and a frame's sequence
number is its rank in that order, so per-publisher order on the wire is
sequence order. A delivery is coded ``receiver << 40 | publisher << 28 |
sequence``. Departures from HotShot: votes are replayed on the schedule,
not sent when the proposal arrives; no view timeouts or view sync; no
certificate is checked.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

PROPOSAL, DA, VOTE = 2, 3, 4     # message types, as the payload codes them
SEQ_BITS = 28
DIRECT, BROADCAST = 0, 1         # the kinds a link frame is counted by


def frames(views, view_due_ns, leader, vote_due_ns, sizes,
           global_topic: int, da_topic: int) -> Dict[str, np.ndarray]:
    """Every frame of the schedule, grouped by publisher and in sending
    order within each: ``pub``, ``seq``, ``mtype``, ``view``, ``target``
    (the receiver of a vote, -1 for a broadcast), ``t0``/``t1`` (topics,
    -1 for none), ``due`` (ns) and ``size`` (bytes). ``leader`` has one
    entry more than ``views``: the leader of the view after the last,
    whom the last view's votes go to. ``sizes`` is (proposal, DA, vote)."""
    views = np.asarray(views, np.int64)
    view_due_ns = np.asarray(view_due_ns, np.int64)
    leader = np.asarray(leader, np.int64)
    vote_due_ns = np.asarray(vote_due_ns, np.int64)
    nv, nodes = vote_due_ns.shape
    assert views.size == nv == view_due_ns.size and leader.size == nv + 1
    voters = np.tile(np.arange(nodes, dtype=np.int64), nv)
    vote_view = np.repeat(np.arange(nv), nodes)
    pub = np.concatenate([leader[:nv], leader[:nv], voters])
    mtype = np.concatenate([np.full(nv, PROPOSAL), np.full(nv, DA),
                            np.full(voters.size, VOTE)]).astype(np.int64)
    view = np.concatenate([views, views, views[vote_view]])
    target = np.concatenate([np.full(2 * nv, -1, np.int64),
                             leader[1:][vote_view]])
    t0 = np.concatenate([np.full(nv, global_topic), np.full(nv, da_topic),
                         np.full(voters.size, -1)]).astype(np.int64)
    due = np.concatenate([view_due_ns, view_due_ns, vote_due_ns.ravel()])
    size = np.asarray(sizes, np.int64)[mtype - PROPOSAL]
    # by publisher, then due time, then type (proposal, DA, vote)
    order = np.lexsort((mtype, due, pub))
    out = dict(pub=pub, mtype=mtype, view=view, target=target, t0=t0,
               t1=np.full(pub.size, -1, np.int64), due=due, size=size)
    out = {k: v[order] for k, v in out.items()}
    p = out["pub"]
    starts = np.flatnonzero(np.r_[True, p[1:] != p[:-1]])
    counts = np.diff(np.r_[starts, p.size])
    out["seq"] = np.arange(p.size) - np.repeat(starts, counts)
    return out


def _members(topics: Sequence[Sequence[int]], num_topics: int) -> np.ndarray:
    """``[num_topics + 1, users]``: who is subscribed to each topic; the
    last row, topic -1, holds no one."""
    member = np.zeros((num_topics + 1, len(topics)), bool)
    for u, ts in enumerate(topics):
        member[list(ts), u] = True
    return member


def deliveries(f: Dict[str, np.ndarray], topics: Sequence[Sequence[int]],
               num_topics: int) -> np.ndarray:
    """Every delivery due, as sorted codes: a broadcast once to each node
    subscribed to one of its topics (its publisher too), a vote once to
    its target."""
    member = _members(topics, num_topics)
    sender = (f["pub"] << SEQ_BITS) | f["seq"]
    out = []
    direct = f["target"] >= 0
    out.append((f["target"][direct] << 40) | sender[direct])
    for i in np.flatnonzero(~direct):
        users = np.flatnonzero(member[f["t0"][i]] | member[f["t1"][i]])
        out.append((users.astype(np.int64) << 40) | sender[i])
    return np.sort(np.concatenate(out))


def quorums(f: Dict[str, np.ndarray], quorum: int) -> Dict[str, np.ndarray]:
    """Per view of the schedule: ``view``, ``leader`` (of the next view,
    who collects its votes), ``votes`` (distinct voters) and ``closed``
    (at least ``quorum`` of them)."""
    vote = f["mtype"] == VOTE
    view, target, pub = f["view"][vote], f["target"][vote], f["pub"][vote]
    views, first = np.unique(view, return_index=True)
    leader = target[first]
    width = int(pub.max()) + 1 if pub.size else 1
    pairs = np.unique((view - views.min(initial=0)) * width + pub)
    votes = np.zeros(views.size, np.int64)
    np.add.at(votes, np.searchsorted(
        views, pairs // width + views.min(initial=0)), 1)
    return dict(view=views, leader=leader, votes=votes,
                closed=votes >= quorum)


def crossings(f: Dict[str, np.ndarray], topics: Sequence[Sequence[int]],
              num_topics: int, broker_of, num_brokers: int) -> np.ndarray:
    """``[from, to, kind]``: the frames that cross from one broker to
    another, by kind (``DIRECT``, ``BROADCAST``). A broadcast crosses once
    to every other broker that holds a node subscribed to one of its
    topics; a vote crosses once when its voter and its target sit on
    different brokers."""
    broker_of = np.asarray(broker_of, np.int64)
    member = _members(topics, num_topics)
    held = np.zeros((num_topics + 1, num_brokers), bool)  # topic, broker
    for b in range(num_brokers):
        held[:, b] = member[:, broker_of == b].any(axis=1)
    out = np.zeros((num_brokers, num_brokers, 2), np.int64)
    src = broker_of[f["pub"]]
    direct = f["target"] >= 0
    dst = broker_of[f["target"][direct]]
    np.add.at(out, (src[direct], dst, DIRECT), 1)
    for i in np.flatnonzero(~direct):
        to = held[f["t0"][i]] | held[f["t1"][i]]
        to[src[i]] = False
        out[src[i], to, BROADCAST] += 1
    for b in range(num_brokers):
        out[b, b] = 0
    return out
