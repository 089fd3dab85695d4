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
  one process, one mesh step per tick, per-shard pairs; and the
  ``MeshBrokerGroup`` whose shards are brokers
- ``parallel.multihost`` and ``broker.multihost_group`` — a mesh that
  spans OS processes over ``torch.distributed``, and the
  ``MultiHostBrokerGroup`` every process steps in lockstep (its workers
  and the two-process deployment in ``testing.two_host``)
- ``broker.broker``, ``broker.tasks``, ``broker.test_harness`` and
  ``proto`` — the single-broker host data path over the Memory, TCP,
  TCP+TLS and QUIC transports, TCP on asyncio or on the io_uring engine
  (``proto.transport.uring``) with the fused native pump
  (``proto.transport.pump``), copied from the JAX package
- ``native`` — the port's own copies of the JAX package's C++ host
  routines (ring packer, wire scanner and encoder, the planes' egress
  encoder, the batch decoder), built with ``g++`` at first use; and
  ``native.routeplan``, the cut-through route plan's binding,
  ``native.uring`` (the io_uring shim), ``native.pump`` (the fused pump,
  built from the port's ``pump.cpp`` with the two sources it includes)
  and ``native.syscount`` (the ``LD_PRELOAD`` syscall interposer)
- ``broker.tasks.cutthrough`` — the cut-through routing plane: a broker
  without a device plane routes whole received chunks with one
  ``RoutePlanner.plan`` call against its incrementally kept route table
  (``RouteState``), as the JAX package's does by default
  (``PUSHCDN_ROUTE_CUTTHROUGH``); ``testing.routebench`` measures it
  against the scalar loops
- ``marshal``, ``client``, ``testing.cluster`` and ``bin`` — the marshal,
  the elastic client, the in-process cluster and the ``broker``,
  ``marshal`` and ``client`` binaries, copied the same way

The package imports torch and numpy only (``native``, ``routeplan``
among it, and the host-only processes not even torch): nothing of JAX
and nothing of ``pushcdn_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; they never fall back to the CPU on their own.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: a host-only process (marshal, client, a broker without a
    # plane) must not pay torch's import
    if name == "resolve_device":
        from pushcdn_tpu_torch._device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
