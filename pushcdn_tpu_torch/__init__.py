"""pushcdn_tpu_torch: the device routing plane in PyTorch and CUDA.

The counterpart of ``pushcdn_tpu``'s device data plane, written for an
NVIDIA Hopper card. It keeps the JAX package's module layout and names:

- ``parallel.frames``  — fixed-shape frame rings and the user-slot table
- ``parallel.crdt``    — the versioned-map CRDT fold over user ownership
- ``parallel.mesh``    — the broker mesh: one device per broker shard
- ``parallel.router``  — the routing step (dense and ragged), and the
  multi-shard mesh step with its collective count
- ``ops.delivery_kernel`` / ``ops.ragged_delivery`` — the two delivery
  kernels, hand-written CUDA C++ for ``sm_90a`` (``csrc/``), each beside
  its plain PyTorch version
- ``broker.device_plane`` — a socket-free ``DevicePlane``: staging, host
  mirrors, one ``step()`` that returns per-user ``(user, frame)`` pairs
- ``broker.mesh_group`` — a socket-free ``MeshGroup``: N broker shards in
  one process, one mesh step per tick, per-shard pairs

The package imports torch and numpy only: nothing of JAX and nothing of
``pushcdn_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; they never fall back to the CPU on their own.
"""

from pushcdn_tpu_torch._device import resolve_device  # noqa: F401

__version__ = "0.1.0"
