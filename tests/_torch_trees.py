"""Test helper for the port's mesh step: stack per-shard outputs back
into the JAX package's ``[B, ...]`` layout. Imports nothing of JAX."""

from typing import Sequence

import torch


def stack_rows(trees: Sequence):
    """The inverse of ``pushcdn_tpu_torch.parallel.mesh.shard_rows``: one
    tree whose leaves stack the shards' rows on the CPU."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack([t.cpu() for t in trees])
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(stack_rows(col) for col in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(stack_rows(col) for col in zip(*trees))
    raise TypeError(f"not a tensor tree: {type(first).__name__}")
