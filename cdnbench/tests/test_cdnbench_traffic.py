"""The traffic is the same work for every seed: the subscriptions and the
schedules are drawn once, and the seed only relabels users and topics."""

import numpy as np
import pytest

from cdnbench import common, oracle, traffic
from cdnbench.traffic import pubsub

SEEDS = (1, 77, 4294967311, 9700000101)


def deliveries(cell, seed, seconds=10.0):
    wl = common.workload(cell)
    cfg = common.config(wl["config"])
    sched = pubsub.plan(cfg, wl, seed, seconds)
    pub = np.concatenate([np.full(len(s["due"]), p) for p, s in sched.items()])
    seq = np.concatenate([np.arange(len(s["due"])) for s in sched.values()])
    cat = lambda k: np.concatenate([s[k] for s in sched.values()])  # noqa
    want = oracle.expected(pubsub.users_topics(cfg, wl, seed), cfg["topics"],
                           pub, seq, cat("target"), cat("t0"), cat("t1"))
    return cfg, wl, sched, want


@pytest.mark.parametrize("cell", ["pubsub_1k.wide_10k_under",
                                  "pubsub_1k.zipf_small"])
def test_every_seed_offers_the_same_work(cell):
    runs = [deliveries(cell, s) for s in SEEDS]
    cfg, wl = runs[0][0], runs[0][1]
    sizes = {tuple(np.sort(np.concatenate([s["size"] for s in r[2].values()])))
             for r in runs}
    dues = {tuple(np.sort(np.concatenate([s["due"] for s in r[2].values()])))
            for r in runs}
    per_receiver = {tuple(np.sort(np.bincount(r[3] >> 40,
                                              minlength=cfg["users"])))
                    for r in runs}
    assert len({r[3].size for r in runs}) == 1
    assert len(sizes) == 1 and len(dues) == 1 and len(per_receiver) == 1
    # and yet the seeds differ: other publishers, topics and receivers
    assert len({tuple(sorted(r[2])) for r in runs}) == len(SEEDS)
    assert len({r[3].tobytes() for r in runs}) == len(SEEDS)
    share = cfg["users"] // cfg["generators"]
    for r in runs:
        assert np.all(np.bincount(np.asarray(sorted(r[2])) // share)
                      == wl["publishers"] // cfg["generators"])


def test_the_relabelling_keeps_each_generators_share():
    owner = traffic.users_relabel(1024, 4, 9700000101)
    assert sorted(owner) == list(range(1024))
    assert np.all(owner // 256 == np.arange(1024) // 256)
    assert np.any(owner != np.arange(1024))
