"""Seeded inputs shared by the port's tests and ``chip_smoke.py``, and
the in-process whole-system fixtures (``Cluster``: a marshal and N
brokers on one discovery file; ``MeshCluster``: a marshal and the N
broker shards of one mesh group); the two-process deployment
(``two_host``) and the worker modules that run one process of a pair
(``lockstep_worker``, ``two_host_worker``, ``burst_worker``); the
in-process worker-shard harness (``shardharness.run_sharded``); the
consensus workload (``consensus``: ``ConsensusConfig``, ``run_consensus``),
the client-pack worker (``clientpack``), run provenance (``provenance``)
and the out-of-process card probe (``accel_probe``)."""

from pushcdn_tpu_torch.testing.cluster import (  # noqa: F401
    Cluster,
    wait_mesh_interest,
    wait_until,
)
from pushcdn_tpu_torch.testing.consensus import (  # noqa: F401
    ConsensusConfig,
    ConsensusDriver,
    ConsensusRun,
    run_consensus,
)

__all__ = ["Cluster", "ConsensusConfig", "ConsensusDriver", "ConsensusRun",
           "MeshCluster", "TwoHostNode", "make_two_host_node",
           "spawn_worker_pair", "wait_mesh_interest", "wait_until"]


def __getattr__(name):
    # lazy: the mesh cluster and the two-process deployment import torch,
    # the host-only Cluster does not
    if name == "MeshCluster":
        from pushcdn_tpu_torch.testing.mesh_cluster import MeshCluster
        return MeshCluster
    if name in ("TwoHostNode", "make_two_host_node", "spawn_worker_pair"):
        from pushcdn_tpu_torch.testing import two_host
        return getattr(two_host, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
