"""Shared staging types for the device planes (dependency-light so the
receive loops import them without the device plane)."""

import enum

from pushcdn_tpu_torch.proto.message import (
    KIND_BROADCAST,
    KIND_DIRECT,
    Broadcast,
    Direct,
)


class StageResult(enum.Enum):
    """Outcome of try_stage — FULL is backpressure (retry), INELIGIBLE is
    a host-path message (don't)."""

    STAGED = "staged"
    INELIGIBLE = "ineligible"
    FULL = "full"


def frame_item(message, raw):
    """A decoded message and its wire frame as a ``(kind, payload,
    target)`` staging item: the topic list of a broadcast, the recipient
    of a direct; another kind stages as kind 0, which is INELIGIBLE."""
    if isinstance(message, Broadcast):
        return KIND_BROADCAST, raw.data, message.topics
    if isinstance(message, Direct):
        return KIND_DIRECT, raw.data, message.recipient
    return 0, raw.data, None
