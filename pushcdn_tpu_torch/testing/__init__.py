"""Seeded inputs shared by the port's tests and ``chip_smoke.py``, and
the in-process whole-system fixture (``Cluster``: a marshal and N brokers
on one discovery file)."""

from pushcdn_tpu_torch.testing.cluster import (  # noqa: F401
    Cluster,
    wait_mesh_interest,
    wait_until,
)

__all__ = ["Cluster", "wait_mesh_interest", "wait_until"]
