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
- ``broker.device_plane`` — the ``DevicePlane``: staging, host mirrors,
  the step, and under a broker the asyncio pump with its egress and host
  fallback; socket-free, one ``step()`` returns ``(user, frame)`` pairs
- ``broker.mesh_group`` — a socket-free ``MeshGroup``: N broker shards in
  one process, one mesh step per tick, per-shard pairs
- ``broker.broker``, ``broker.tasks``, ``broker.test_harness`` and
  ``proto`` — the single-broker host data path over the Memory
  transport, copied from the JAX package (``native`` stands in for its
  C++ host routines and answers None, so they run in Python)

The package imports torch and numpy only: nothing of JAX and nothing of
``pushcdn_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; they never fall back to the CPU on their own.
"""

from pushcdn_tpu_torch._device import resolve_device  # noqa: F401

__version__ = "0.1.0"
