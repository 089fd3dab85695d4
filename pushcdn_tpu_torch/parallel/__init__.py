"""The device data plane: frame rings, the CRDT fold and the router.

- ``frames``  — message frames packed into fixed-shape host rings
- ``crdt``    — the vectorised versioned-map merge (the DirectMap twin)
- ``mesh``    — the broker mesh: one device per broker shard
- ``multihost`` — a mesh that spans OS processes (``torch.distributed``)
- ``router``  — the routing step, dense and ragged, on one shard or on
  every shard of a mesh (per-array or fused exchange)
"""
