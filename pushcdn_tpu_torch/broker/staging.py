"""Shared staging types for the device planes (dependency-light so the
receive loops import them without the device plane)."""

import enum


class StageResult(enum.Enum):
    """Outcome of try_stage — FULL is backpressure (retry), INELIGIBLE is
    a host-path message (don't)."""

    STAGED = "staged"
    INELIGIBLE = "ineligible"
    FULL = "full"
