"""The host routines that ``pushcdn_tpu.native`` builds from C++, none of
which the port has copied yet.

Each name below answers what the JAX package's module answers when its
library did not build: ``None``. Every caller in the port therefore takes
its existing Python branch: the transport's reader scans frames in
Python (``transport.base._py_scan_frames``), its writer length-prefixes
each frame itself, ``message.decode_frames`` runs its Python loop, and
``senders.pre_encode_frames`` hands batches to ``send_raw_many_nowait``.
The device plane's egress walks its delivery pairs in Python
(``senders.egress_delivery_rows``) and never asks for ``egress_encode``.

These are host routines, not kernels on the card. The C++ sources they
stand for are ``native/framing.cpp`` (``FrameScanner``, ``FrameEncoder``,
``shared_encoder``, ``egress_encode`` and its egress buffer pool) and
``native/pydecode.cpp`` (``pydecode``).
"""

from __future__ import annotations

from typing import Optional


class FrameScanner:
    """Stands for the native frame-boundary scanner."""

    @classmethod
    def create(cls, max_frames: int = 8192) -> Optional["FrameScanner"]:
        return None


class FrameEncoder:
    """Stands for the native batch length-prefix encoder."""

    @classmethod
    def create(cls, capacity: int = 256 * 1024) -> Optional["FrameEncoder"]:
        return None


def shared_encoder() -> Optional[FrameEncoder]:
    return None


def pydecode():
    """The native batch decoder: none, so ``decode_frames`` runs its
    Python loop."""
    return None


def egress_encode(deliver, lengths, frames):
    """The native egress engine: none, so a device plane's egress walks
    its pairs in Python."""
    return None
