"""Seeded inputs shared by the port's tests and ``chip_smoke.py``, and
the in-process whole-system fixtures (``Cluster``: a marshal and N
brokers on one discovery file; ``MeshCluster``: a marshal and the N
broker shards of one mesh group)."""

from pushcdn_tpu_torch.testing.cluster import (  # noqa: F401
    Cluster,
    wait_mesh_interest,
    wait_until,
)

__all__ = ["Cluster", "MeshCluster", "wait_mesh_interest", "wait_until"]


def __getattr__(name):
    # lazy: the mesh cluster imports torch, the host-only Cluster does not
    if name == "MeshCluster":
        from pushcdn_tpu_torch.testing.mesh_cluster import MeshCluster
        return MeshCluster
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
