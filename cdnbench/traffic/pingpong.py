"""Closed-loop direct ping-pong between ``pairs`` pairs of users, the rest
connected and idle.

Every user subscribes to ``topics_per_user`` topics by ``popularity``,
as the deployment's users do, and sends nothing. The pairs are drawn from
the seed, each from two different generator processes. At the window's
start the first of each pair sends a ``payload_bytes`` direct to the
second; whoever receives one answers at once while the window is open.
A message is timed from when it was sent.
"""

from __future__ import annotations

import time

import numpy as np

from cdnbench import traffic

HOOK_TYPES = (traffic.PING,)


def users_topics(cfg: dict, wl: dict, seed: int):
    subs, _ = traffic.subscriptions(cfg["users"], cfg["topics"],
                                    cfg["topics_per_user"], wl["popularity"],
                                    seed)
    return subs


def pairs(cfg: dict, wl: dict, seed: int) -> np.ndarray:
    """``[pairs, 2]`` uids; the two of a pair sit in different
    generators."""
    g = traffic.rng(seed, 5)
    share = cfg["users"] // cfg["generators"]
    out = []
    for _ in range(wl["pairs"]):
        a, b = g.choice(cfg["generators"], 2, replace=False)
        out.append((a * share + g.integers(share), b * share + g.integers(share)))
    return np.asarray(out, np.int64)


def on_message(gen, uid: int, mtype: int, pub: int, seq: int,
               ref_ns: int) -> None:
    now = time.monotonic_ns()
    if now < gen.t_end:
        gen.spawn(gen.send(uid, traffic.PING, gen.wl["payload_bytes"], now,
                           target=pub))


async def drive(gen) -> None:
    import asyncio
    tasks = set()

    def spawn(coro):
        t = asyncio.ensure_future(coro)
        tasks.add(t)
        t.add_done_callback(tasks.discard)
    gen.spawn = spawn
    wait = gen.t0 - time.monotonic_ns()
    if wait > 0:
        await asyncio.sleep(wait / 1e9)
    for a, b in pairs(gen.cfg, gen.wl, gen.seed).tolist():
        if a in gen.clients:
            await gen.send(a, traffic.PING, gen.wl["payload_bytes"],
                           time.monotonic_ns(), target=b)
    await asyncio.Event().wait()


def checks(cfg: dict, wl: dict, seed: int, seconds: float, sends: dict,
           extra: dict, rate: float = None) -> dict:
    """Only the pairs sent (``stray_senders``, limit 0)."""
    allowed = set(pairs(cfg, wl, seed).ravel().tolist())
    return dict(stray_senders=int(sum(1 for p in np.unique(sends["pub"])
                                      if int(p) not in allowed)))
