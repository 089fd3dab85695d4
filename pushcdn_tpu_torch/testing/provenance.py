"""Host and build provenance for measurement rows.

A row is only comparable with another when it says where it ran: a
regression caused by moving from a 16-core runner to a 1-core container
must be readable as such. Every measurement section therefore stamps this
dict.

A copy of ``pushcdn_tpu.testing.provenance`` without the ``jax`` field,
and with ``torch``, ``cuda`` and ``gpu`` in its place. None of them imports
torch: a client pack or a broker without a plane stamps its rows without
loading it.
"""

from __future__ import annotations

import importlib.metadata
import os
import platform
import re
import subprocess
import sys
from typing import Optional


def git_sha(repo_root: str = None) -> str:
    """Current commit (short), or "unknown" outside a git checkout."""
    root = repo_root or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=root,
            capture_output=True, text=True, timeout=10)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


def _run(argv) -> Optional[str]:
    """A command's stripped stdout, or None when it is absent or fails."""
    try:
        out = subprocess.run(argv, capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0 or not out.stdout.strip():
        return None
    return out.stdout.strip()


def torch_version() -> Optional[str]:
    """The installed torch's version from its package metadata (torch is
    not imported), or None."""
    try:
        return importlib.metadata.version("torch")
    except importlib.metadata.PackageNotFoundError:
        return None


def cuda_version() -> Optional[str]:
    """The CUDA toolkit's version: the CUDA runtime wheel's metadata
    (``nvidia-cuda-runtime*``), else ``nvcc --version``'s release, else
    None."""
    for dist in importlib.metadata.distributions():
        name = (dist.metadata["Name"] or "").lower()
        if name.startswith("nvidia-cuda-runtime"):
            return dist.version
    out = _run(["nvcc", "--version"])
    if out is not None:
        m = re.search(r"release ([0-9.]+)", out)
        if m:
            return m.group(1)
    return None


def gpu() -> Optional[str]:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, or
    None where there is no card."""
    out = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    return out.splitlines()[0] if out else None


def provenance() -> dict:
    """cpus / git sha / python, torch and CUDA versions / the card /
    platform — cheap enough to stamp into every measurement section."""
    return {
        "cpus": os.cpu_count(),
        "git_sha": git_sha(),
        "python": platform.python_version(),
        "torch": torch_version(),
        "cuda": cuda_version(),
        "gpu": gpu(),
        "platform": platform.platform(),
        "argv0": os.path.basename(sys.argv[0]) if sys.argv else None,
    }
