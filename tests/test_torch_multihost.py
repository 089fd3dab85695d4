"""The port's multi-process broker mesh against the JAX package's.

``pod_broker_mesh`` in one process is the twin of
``tests/test_multihost.py::test_single_host_owns_all_shards``. The
two-process lane step is the twin of ``tests/_spmd_worker.py``: two
gloo processes with 4 CPU shards each (``python -m
pushcdn_tpu_torch.testing.lockstep_worker``) step the global 8-shard
mesh once per schedule on the same seeded inputs that
``pushcdn_tpu.parallel.router.make_mesh_lane_step`` takes on the
8-device virtual CPU mesh (``tests/conftest.py``). Every local shard's
delivery matrices, gathered frames, merged CRDT rows and evictions must
be bit-identical to JAX's (tolerance 0), under both schedules and both
popularities, and on a 7-shard mesh whose second process holds one
shard fewer; claims seeded only on the other process's shards must
converge; a fused tick counts one collective, a per-array tick as many
as JAX's per-array step issues. The workers run on the card unless
given ``--device``.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from pushcdn_tpu.parallel import router as jr
from pushcdn_tpu.parallel.crdt import CrdtState as JCrdtState
from pushcdn_tpu.parallel.mesh import make_broker_mesh as jax_mesh
from pushcdn_tpu.parallel.multihost import dcn_crossings as jax_dcn
from pushcdn_tpu.parallel.multihost import (
    local_shard_indices as jax_local_shards,
)
from pushcdn_tpu.parallel.multihost import pod_broker_mesh as jax_pod_mesh
from pushcdn_tpu_torch.parallel import multihost as tmh
from pushcdn_tpu_torch.parallel.mesh import make_broker_mesh
from pushcdn_tpu_torch.proto.error import Error
from pushcdn_tpu_torch.testing.lockstep_worker import (
    case_trees,
    lane_step_case,
)
from pushcdn_tpu_torch.testing.two_host import spawn_worker_pair

# (popularity, shards): 4 shards a process, then 4 and 3
CASES = {"uniform": ("uniform", 8), "zipf": ("zipf", 8),
         "uniform-7-shards": ("uniform", 7)}
SCHEDULES = ("fused", "per-array")
K = 8   # user slots per shard in lane_step_case
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_single_host_owns_all_shards():
    tmh.initialize()   # nothing to join: a one-process world
    assert tmh.process_count() == 1
    mesh = tmh.pod_broker_mesh(8, local_devices=["cpu"] * 8)
    jmesh = jax_pod_mesh(8)
    assert tmh.local_shard_indices(mesh) == jax_local_shards(jmesh) \
        == list(range(8))
    assert tmh.dcn_crossings(mesh) == jax_dcn(jmesh) == 0
    assert mesh.size == jmesh.devices.size == 8
    assert not mesh.spans_processes and mesh.group is None
    # one process: the plain mesh, unchanged
    assert mesh == make_broker_mesh(8, devices=["cpu"] * 8)


def test_partial_explicit_join_raises():
    with pytest.raises(Error, match="coordinator address"):
        tmh.initialize("127.0.0.1:1", None, 0)


@pytest.mark.parametrize("cards,want", [
    ([["h/a"], ["h/b"]], "nccl"),           # a card per rank
    ([["h/a", "h/b"], ["h/c"]], "nccl"),    # several cards, none shared
    ([["h/a"], ["h/a"]], "gloo"),           # two ranks on one card
    ([["h/a", "h/a"], ["h/b"]], "nccl"),    # one rank folds its card
    ([[None], [None]], "gloo"),             # the CPU
    ([["h/a"], [None]], "gloo"),
])
def test_backend_follows_topology(cards, want, monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    assert tmh.choose_backend(cards) == want
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    assert tmh.choose_backend(cards) == "gloo"


@pytest.fixture(scope="module")
def lane_runs(tmp_path_factory):
    """Every case, each stepped by its own pair of processes (started
    together), under both schedules."""
    runs = {}
    procs = []
    for seed, (name, (popularity, shards)) in enumerate(CASES.items()):
        d = tmp_path_factory.mktemp(f"lane-{name}")
        case = lane_step_case(popularity, seed=70 + seed, shards=shards)
        np.savez(d / "case.npz", **case)
        runs[name] = (case, d)
        procs.append(spawn_worker_pair(
            "pushcdn_tpu_torch.testing.lockstep_worker",
            f"file://{d}/rendezvous",
            ["lane", str(d), str(d / "case.npz"), "--device", "cpu"],
            log_dir=str(d)))
    try:
        for pair in procs:
            for p in pair:
                p.wait(timeout=50)
    finally:
        for pair in procs:
            for p in pair:
                if p.poll() is None:
                    p.kill()
    for case, d in runs.values():
        for rank in (0, 1):
            log = (d / f"rank{rank}.log").read_text()
            assert f"rank {rank}: LOCKSTEP OK" in log, log[-3000:]
    return runs


def _jax_step(case, fused):
    state, lanes, directs = case_trees(case)
    jstate = jr.RouterState(JCrdtState(*(jnp.asarray(x) for x in state[:3])),
                            jnp.asarray(state[3]))
    return jr.make_mesh_lane_step(jax_mesh(len(state[0])), gather_bytes=True,
                                  fused=fused)(
        jstate, tuple(jr.IngressBatch(*map(jnp.asarray, b)) for b in lanes),
        tuple(jr.DirectIngress(*map(jnp.asarray, d)) for d in directs), None)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", CASES)
def test_two_process_lane_step_matches_jax(lane_runs, name, schedule):
    case, d = lane_runs[name]
    n = CASES[name][1]
    j = _jax_step(case, fused=schedule == "fused")
    seen = []
    for rank in (0, 1):
        got = dict(np.load(d / f"rank{rank}-0-{schedule}.npz"))
        shards = got["shards"].tolist()
        assert shards == list(range(4 * rank, min(4 * rank + 4, n)))
        seen += shards
        # fused: one collective; per array: 4 state rows, 6 per broadcast
        # lane and 4 per direct lane, as the JAX per-array step issues
        assert int(got["collectives"]) == (1 if schedule == "fused"
                                           else 4 + 2 * 6 + 4)
        for k in shards:
            for name, lanes in (("lane", j.lanes),
                                ("direct", j.direct_lanes)):
                for li, lane in enumerate(lanes):
                    for f in ("deliver", "gathered_length",
                              "gathered_bytes"):
                        np.testing.assert_array_equal(
                            np.asarray(getattr(lane, f))[k],
                            got[f"{k}_{name}{li}_{f}"])
            want = (j.state.crdt.owners, j.state.crdt.versions,
                    j.state.crdt.identities, j.state.topic_masks)
            for f, w in zip(("owners", "versions", "ids", "masks"), want):
                np.testing.assert_array_equal(np.asarray(w)[k],
                                              got[f"{k}_{f}"])
            np.testing.assert_array_equal(np.asarray(j.evictions)[k],
                                          got[f"{k}_evictions"])
            # claims seeded only on the other process's rows converged
            merged = got[f"{k}_owners"]
            for i in range(n):
                assert merged[i * K] == i
            # frames from the other process's shards reach this shard
            other = range(4, n) if rank == 0 else range(4)
            S = case["lane0_valid"].shape[1]
            dm = got[f"{k}_lane0_deliver"]
            assert any(dm[:, s * S:(s + 1) * S].any() for s in other)
    assert sorted(seen) == list(range(n))



@pytest.mark.parametrize("module", ["lockstep_worker", "burst_worker",
                                    "two_host_worker"])
def test_workers_run_on_the_card_unless_asked(module, tmp_path):
    """A worker given no ``--device`` runs on CUDA: with CUDA hidden it
    exits non-zero, naming CUDA, before it joins its peer."""
    args = {"lockstep_worker": ["lane", str(tmp_path), "case.npz"],
            "burst_worker": ["plan.pkl", str(tmp_path)],
            "two_host_worker": ["deploy", "d.sqlite", str(tmp_path)]}
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    out = subprocess.run(
        [sys.executable, "-m", f"pushcdn_tpu_torch.testing.{module}",
         "--rank", "0", "--world", "2",
         "--init", f"file://{tmp_path}/rendezvous", *args[module]],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr, out.stderr[-2000:]
