"""Binding for the LD_PRELOAD syscall-attribution interposer
(``syscount.cpp`` beside this file; the port's own copy of
``pushcdn_tpu.native.syscount``).

The bench parent builds the library and re-execs the measurement child
with ``LD_PRELOAD`` set; inside the child, :func:`snapshot` reads the
interposer's counters through ctypes (dlopen of an already-preloaded DSO
returns the same mapping, so the counters are the live ones). A process
without the preload reports :func:`active` False and the bench emits a
skipped row instead of a zero-syscall lie.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional

from pushcdn_tpu_torch.native import _build_lib, library_path

NAME = "syscount"
FLAGS = ("-ldl",)

# index order must match the C_* enum in syscount.cpp
NAMES = ("write", "writev", "send", "sendto", "sendmsg",
         "read", "recv", "recvfrom", "recvmsg",
         "epoll_wait", "epoll_pwait", "io_uring_enter")

_lib = None
_lib_tried = False


def build() -> Optional[str]:
    """Compile (or reuse) the interposer; returns its path or None.
    Called by the bench PARENT, before spawning the preloaded child."""
    return _build_lib(NAME, loader=lambda p: p, extra_flags=FLAGS)


def _load():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    path = str(library_path(NAME, FLAGS))
    if path not in os.environ.get("LD_PRELOAD", "").split(":"):
        return None  # not preloaded, or another package's interposer
    try:
        lib = ctypes.CDLL(path)
        lib.pcu_syscount.restype = ctypes.c_ulonglong
        lib.pcu_syscount.argtypes = [ctypes.c_int]
        lib.pcu_syscount_n.restype = ctypes.c_int
        if lib.pcu_syscount_n() != len(NAMES):
            return None
        _lib = lib
    except OSError:
        return None
    return _lib


def active() -> bool:
    """True when this process runs under the interposer preload."""
    return _load() is not None


def snapshot() -> Dict[str, int]:
    """Current per-syscall counters (empty dict when not preloaded)."""
    lib = _load()
    if lib is None:
        return {}
    return {name: int(lib.pcu_syscount(i)) for i, name in enumerate(NAMES)}


def delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: after.get(k, 0) - before.get(k, 0) for k in NAMES}
