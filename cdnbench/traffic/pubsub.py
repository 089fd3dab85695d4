"""Open-loop publish/subscribe: a fixed set of publishers, each sending on
a schedule drawn from the seed, whether or not the system keeps up.

Every user subscribes to ``topics_per_user`` topics by the workload's
``popularity``. The work is the same for every seed: the subscriptions
and every publisher's schedule are drawn once, and the seed relabels
users (within each generator's share) and topics, so that every seed
offers the same messages to the same numbers of receivers, in another
order. Publisher ``p`` sends exactly ``round(rate * seconds /
publishers)`` messages due in the window, at times drawn uniform over it
and sorted (a Poisson process given its count, so every seed offers the
same number of messages), plus ``warmup_per_publisher`` messages due in
the second before the window. Each message is a direct to a uniform user
with probability ``direct_share``, else a broadcast on one topic (two
with probability ``two_topic_share``) drawn by the same popularity as the
subscriptions; its payload size is drawn by ``traffic.sizes``. A message
is timed from when it was due: a late generator makes it later.
"""

from __future__ import annotations

import asyncio

import numpy as np

from cdnbench import traffic

WARMUP_S = 1.0   # the warm-up messages are due in the second before t0


def users_topics(cfg: dict, wl: dict, seed: int):
    subs, _ = traffic.subscriptions(cfg["users"], cfg["topics"],
                                    cfg["topics_per_user"], wl["popularity"],
                                    seed, blocks=cfg["generators"])
    return subs


def _uid_of(cfg: dict, seed: int) -> np.ndarray:
    """``uid_of[user of the seed-independent draw]``: the seed's uid."""
    owner = traffic.users_relabel(cfg["users"], cfg["generators"], seed)
    uid_of = np.empty_like(owner)
    uid_of[owner] = np.arange(owner.size)
    return uid_of


def _publishers(cfg: dict, wl: dict) -> np.ndarray:
    """The publishers of the seed-independent draw: the same number from
    each generator's share of the users."""
    g = traffic.rng(traffic.STRUCTURE, 2)
    per_gen = wl["publishers"] // cfg["generators"]
    share = cfg["users"] // cfg["generators"]
    return np.sort(np.concatenate([
        k * share + g.choice(share, per_gen, replace=False)
        for k in range(cfg["generators"])]))


def publishers(cfg: dict, wl: dict, seed: int) -> np.ndarray:
    """The publishers' uids."""
    return np.sort(_uid_of(cfg, seed)[_publishers(cfg, wl)])


def plan(cfg: dict, wl: dict, seed: int, seconds: float,
         rate: float = None) -> dict:
    """Every message of the run, publisher by publisher, in sending order
    (so a message's index is its sequence number): ``due`` in ns from the
    window's start (negative for the warm-up), ``target`` (uid of a
    direct, -1 for a broadcast), ``t0``/``t1`` (topics, -1 for none) and
    ``size``. Every schedule is drawn once, the same for every seed; the
    seed relabels its users and topics as it does the subscriptions'."""
    rate = wl["rate_msgs_per_s"] if rate is None else rate
    pubs = _publishers(cfg, wl)
    uid_of = _uid_of(cfg, seed)
    perm = traffic.topics_relabel(cfg["topics"], seed)
    weights = traffic.topic_weights(cfg["topics"], wl["popularity"])
    per_pub = int(round(rate * seconds / len(pubs)))
    warm = int(wl.get("warmup_per_publisher", 0))
    out = {}
    for p in pubs:
        g = traffic.rng(traffic.STRUCTURE, 3, int(p))
        n = warm + per_pub
        due = np.concatenate([
            np.sort(g.uniform(-WARMUP_S, 0.0, warm)),
            np.sort(g.uniform(0.0, seconds, per_pub))])
        direct = g.random(n) < wl["direct_share"]
        target = np.where(direct, uid_of[g.integers(0, cfg["users"], n)], -1)
        two = g.random(n) < wl["two_topic_share"]
        t0 = g.choice(cfg["topics"], n, p=weights)
        t1 = g.choice(cfg["topics"], n, p=weights)
        t1 = np.where(two & (t1 != t0), perm[t1], -1)
        out[int(uid_of[p])] = dict(
            due=(due * 1e9).astype(np.int64),
            target=target.astype(np.int64),
            t0=np.where(direct, -1, perm[t0]).astype(np.int64),
            t1=np.where(direct, -1, t1).astype(np.int64),
            size=traffic.sizes(g, n, wl))
    return out


async def drive(gen) -> None:
    """Each of this process's publishers sends its schedule, each message
    at its due time or, when late, at once."""
    import time
    sched = plan(gen.cfg, gen.wl, gen.seed, gen.seconds,
                 gen.spec.get("rate"))
    mine = [p for p in sched if p in gen.clients]

    async def publish(p: int) -> None:
        s = sched[p]
        target, t0, t1, size = (s["target"].tolist(), s["t0"].tolist(),
                                s["t1"].tolist(), s["size"].tolist())
        for i, due in enumerate((s["due"] + gen.t0).tolist()):
            wait = due - time.monotonic_ns()
            if wait > 0:
                await asyncio.sleep(wait / 1e9)
            topics = () if target[i] >= 0 else (
                (t0[i],) if t1[i] < 0 else (t0[i], t1[i]))
            await gen.send(p, traffic.DATA, size[i], due, target=target[i],
                           topics=topics)

    await asyncio.gather(*(publish(p) for p in mine))


def checks(cfg: dict, wl: dict, seed: int, seconds: float, sends: dict,
           extra: dict, rate: float = None) -> dict:
    """The schedule against what was sent: every message planned went
    out, once, as planned (``unsent`` and ``unplanned``, limits 0)."""
    sched = plan(cfg, wl, seed, seconds, rate)
    want = np.concatenate([
        traffic.code(0, p, np.arange(len(s["due"]))) for p, s in sched.items()])
    have = traffic.code(0, sends["pub"], sends["seq"])
    want_u = np.unique(want)
    have_u, counts = np.unique(have, return_counts=True)
    return dict(unsent=int(np.setdiff1d(want_u, have_u).size),
                unplanned=int(np.setdiff1d(have_u, want_u).size
                              + (counts - 1).sum()))
