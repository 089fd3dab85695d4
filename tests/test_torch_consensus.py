"""The port's consensus workload (``pushcdn_tpu_torch.testing.consensus``)
held against the JAX package's.

The twins of ``tests/test_consensus.py``'s six cases run on the port's
``Cluster``. Then the two packages side by side: the payload codecs, the
quorum and the zipf geography byte for byte and value for value on
seeded inputs; the same seeded ``ConsensusConfig`` (plain Memory links,
and zipf-shaped lossy ones) through both packages' clusters, each view's
leader, completion, timeout and final vote set compared; the same with a
device plane on every broker (``bypass_max_items=0``, so every proposal
and vote goes through the plane's step; dense and ragged) on the CPU in
both packages. Last, the twin of ``tests/test_local_cluster.py::
test_consensus_bench_quick_smoke`` (``benches/consensus_bench.py`` is not
ported): a traced 4-node, 4-view run whose span log passes
``scripts/trace_report.py --strict`` with zero orphans.
"""

import asyncio
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from pushcdn_tpu.broker.device_plane import DevicePlaneConfig as JaxPlaneConfig
from pushcdn_tpu.proto import trace as jax_trace
from pushcdn_tpu.testing import consensus as jax_consensus
from pushcdn_tpu.testing.cluster import Cluster as JaxCluster
from pushcdn_tpu_torch.broker.device_plane import DevicePlaneConfig
from pushcdn_tpu_torch.proto import trace as trace_mod
from pushcdn_tpu_torch.testing import consensus
from pushcdn_tpu_torch.testing.cluster import Cluster
from pushcdn_tpu_torch.testing.consensus import (
    ConsensusConfig,
    ConsensusDriver,
    encode_proposal,
    encode_vote,
    percentile,
    run_consensus,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the twins of tests/test_consensus.py
# ---------------------------------------------------------------------------


def test_config_zipf_latency_tail():
    cfg = ConsensusConfig(num_nodes=8, base_latency_s=0.01,
                          tail_latency_s=0.08, zipf_alpha=1.0)
    lats = [cfg.node_latency_s(i) for i in range(8)]
    # node 0 carries the full tail; the tail decays monotonically to base
    assert lats[0] == 0.09
    assert all(a >= b for a, b in zip(lats, lats[1:]))
    assert abs(lats[-1] - 0.02) < 1e-9
    # unshaped config keeps the plain Memory protocol (no pump tasks)
    from pushcdn_tpu_torch.proto.transport.memory import Memory
    assert ConsensusConfig().node_protocol(0) is Memory
    assert cfg.node_protocol(0) is not Memory


def test_quorum_default_is_two_thirds_plus_one():
    assert ConsensusConfig(num_nodes=4).effective_quorum() == 3
    assert ConsensusConfig(num_nodes=10).effective_quorum() == 7
    assert ConsensusConfig(num_nodes=3, quorum=5).effective_quorum() == 3
    # the card's run: 1024 nodes need 683 votes
    assert ConsensusConfig(num_nodes=1024).effective_quorum() == 683


def test_payload_codecs_are_sized_and_parseable():
    p = encode_proposal(7, 256)
    assert len(p) == 256 and p[:1] == b"P"
    v = encode_vote(7, 3, 64)
    assert len(v) == 64 and v[:1] == b"V"
    assert percentile([], 0.5) is None
    assert percentile([1.0, 2.0, 3.0, 4.0], 0.5) == 2.0


async def test_consensus_views_complete_clean(tmp_path):
    log = str(tmp_path / "spans.jsonl")
    prev = trace_mod.set_log_path(log)
    cluster = await Cluster(num_brokers=1).start()
    try:
        run = await run_consensus(cluster, ConsensusConfig(
            num_nodes=4, num_views=3, view_timeout_s=10.0, seed=1))
        assert run.completed == 3 and run.timeouts == 0
        assert run.proposals_sent == 3
        # quorum is 3 of 4: at least quorum votes counted per view
        assert all(v.votes >= 3 for v in run.views)
        pct = run.completion_percentiles()
        assert pct["p50"] is not None and pct["p50"] > 0
    finally:
        await cluster.stop()
        trace_mod.set_log_path(prev)
    # the span log carries the view tag on every consensus hop
    views = set()
    for line in open(log):
        rec = json.loads(line)
        if "view" in rec:
            views.add(rec["view"])
    assert views == {0, 1, 2}


async def test_consensus_zipf_tail_slows_but_does_not_stall(tmp_path):
    prev = trace_mod.set_log_path(None)
    cluster = await Cluster(num_brokers=1).start()
    try:
        run = await run_consensus(cluster, ConsensusConfig(
            num_nodes=4, num_views=2, view_timeout_s=10.0,
            base_latency_s=0.002, tail_latency_s=0.03, loss=0.2,
            rto_s=0.01, seed=9))
        assert run.completed == 2
        # quorum formation waits on real shaped links: completion can't
        # be faster than the base one-way latency
        assert min(v.completion_s for v in run.views) >= 0.002
    finally:
        await cluster.stop()
        trace_mod.set_log_path(prev)


async def test_leader_rotates_per_view():
    cluster = await Cluster(num_brokers=1).start()
    try:
        driver = ConsensusDriver(cluster, ConsensusConfig(num_nodes=3,
                                                          num_views=4))
        assert [driver.leader_of(v) for v in range(4)] == [0, 1, 2, 0]
    finally:
        await cluster.stop()


# ---------------------------------------------------------------------------
# both packages on the same seeded inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_codecs_quorum_and_geography_match_jax(seed):
    rng = np.random.default_rng(9100 + seed)
    for _ in range(64):
        view = int(rng.integers(0, 2**32))
        node = int(rng.integers(0, 2**16))
        size = int(rng.integers(0, 600))
        assert encode_proposal(view, size) == \
            jax_consensus.encode_proposal(view, size)
        assert encode_vote(view, node, size) == \
            jax_consensus.encode_vote(view, node, size)
    samples = sorted(rng.random(int(rng.integers(1, 200))).tolist())
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert percentile(samples, q) == jax_consensus.percentile(samples, q)
    kw = dict(num_nodes=int(rng.integers(1, 2000)),
              base_latency_s=float(rng.random() * 0.01),
              tail_latency_s=float(rng.random() * 0.1),
              zipf_alpha=float(0.5 + rng.random()))
    if rng.random() < 0.5:
        kw["quorum"] = int(rng.integers(1, 3000))
    ours, theirs = ConsensusConfig(**kw), jax_consensus.ConsensusConfig(**kw)
    assert ours.effective_quorum() == theirs.effective_quorum()
    for i in range(0, kw["num_nodes"], max(1, kw["num_nodes"] // 16)):
        assert ours.node_latency_s(i) == theirs.node_latency_s(i)


async def _outcomes(mod, cluster, cfg, place=None) -> list:
    """One run through ``mod``'s driver, drained as ``run_consensus``
    drains it, then per view: (leader, completed, timed out, the leader's
    final vote set). Each view's vote count at completion is at least the
    quorum."""
    driver = mod.ConsensusDriver(cluster, cfg)
    if place is not None:
        driver.place = place
    await driver.start()
    try:
        result = await driver.run()
        want = result.proposals_sent * cfg.num_nodes
        async with asyncio.timeout(20):
            while (len(result.proposal_delivery_s) < want
                   or len(result.vote_delivery_s) < want):
                await asyncio.sleep(0.02)
        for v in result.views:
            if v.completed_ns is not None:
                assert v.votes >= cfg.effective_quorum(), v
        return [(v.view, v.leader, v.completed_ns is not None, v.timed_out,
                 sorted(driver._votes[v.view])) for v in result.views]
    finally:
        await driver.stop()


SHAPES = {
    "unshaped": dict(num_nodes=8, num_views=5, seed=3),
    "zipf": dict(num_nodes=6, num_views=4, seed=5, base_latency_s=0.002,
                 tail_latency_s=0.02, loss=0.1, rto_s=0.01),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
async def test_views_match_jax(shape):
    kw = dict(SHAPES[shape], view_timeout_s=15.0, trace=False)
    got = {}
    for name, mod, make in (
            ("jax", jax_consensus, lambda: JaxCluster(num_brokers=2)),
            ("port", consensus, lambda: Cluster(num_brokers=2))):
        cluster = await make().start()
        try:
            got[name] = await _outcomes(mod, cluster, mod.ConsensusConfig(
                **kw))
        finally:
            await cluster.stop()
    assert got["port"] == got["jax"]
    n = kw["num_nodes"]
    assert [o[1] for o in got["port"]] == [v % n
                                           for v in range(kw["num_views"])]
    assert all(o[2] and not o[3] and o[4] == list(range(n))
               for o in got["port"])


@pytest.mark.parametrize("impl", ["dense", "ragged"])
async def test_views_through_cpu_planes_match_jax(impl):
    """Every proposal and vote through a plane's step on the CPU: one
    broker in each package, and the port's two brokers with the nodes
    spread over them by the driver's ``place`` hook (the shape of the
    smoke's phase 16 (b)); the same outcomes in all three runs, and every
    plane routed."""
    kw = dict(num_nodes=6, num_views=3, seed=11, view_timeout_s=15.0,
              trace=False)
    plane = dict(num_user_slots=64, ring_slots=64, frame_bytes=512,
                 extra_lanes=(), bypass_max_items=0, delivery_impl=impl)
    got, routed = {}, {}
    for name, mod, make in (
            ("jax", jax_consensus, lambda: JaxCluster(
                num_brokers=1, device_plane=JaxPlaneConfig(**plane))),
            ("port", consensus, lambda: Cluster(
                num_brokers=1, device_plane=DevicePlaneConfig(**plane),
                device="cpu")),
            ("port, 2 brokers", consensus, lambda: Cluster(
                num_brokers=2, device_plane=DevicePlaneConfig(**plane),
                device="cpu"))):
        cluster = await make().start()
        try:
            place = None
            if len(cluster.brokers) > 1:
                async def place(i, cluster=cluster):
                    await cluster.place_on(i % 2)
            got[name] = await _outcomes(mod, cluster, mod.ConsensusConfig(
                **kw), place=place)
            planes = [b.device_plane for b in cluster.brokers]
            routed[name] = [p.messages_routed for p in planes]
            assert all(p.delivery_impl == impl and not p.disabled
                       for p in planes), name
            assert all(b.connections.num_users == kw["num_nodes"]
                       // len(planes) for b in cluster.brokers), name
        finally:
            await cluster.stop()
    assert got["port"] == got["jax"] == got["port, 2 brokers"]
    assert all(o[2] and not o[3] for o in got["port"])
    # every broker's plane routed proposals and votes, in both packages
    assert all(r > 0 for rs in routed.values() for r in rs), routed


async def test_traced_quick_run_passes_the_strict_trace_report(tmp_path):
    """A traced 4-node, 4-view run on the port leaves a span log that
    ``scripts/trace_report.py --strict`` accepts: complete chains, zero
    orphaned spans, per-view rows."""
    log = tmp_path / "spans.jsonl"
    prev = trace_mod.set_log_path(str(log))
    prev_jax = jax_trace.set_log_path(None)
    cluster = await Cluster(num_brokers=1).start()
    try:
        run = await run_consensus(cluster, ConsensusConfig(
            num_nodes=4, num_views=4, view_timeout_s=10.0, seed=2))
    finally:
        await cluster.stop()
        trace_mod.set_log_path(prev)
        jax_trace.set_log_path(prev_jax)
    assert run.completed == run.proposals_sent == 4 and run.timeouts == 0
    assert run.completion_percentiles()["p99"] > 0
    assert run.delivery_percentiles()["p99"] > 0
    r = await asyncio.to_thread(
        subprocess.run,
        [sys.executable, os.path.join(ROOT, "scripts", "trace_report.py"),
         "--strict", "--json", str(log)],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    report = json.loads(r.stdout)
    assert report["orphaned_spans"] == 0
    assert report["complete_chains"] > 0
