"""What every part of the benchmark shares: where its files are, how a
cell's configuration and traffic are found by name, loopback ports and
HTTP, the Prometheus text the brokers serve, and percentiles.

Imports nothing of the program and nothing of JAX, so the oracle, the
readers and the generators can all use it.
"""

from __future__ import annotations

import json
import math
import os
import socket
from typing import Dict, Iterable, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
PROGRAM = "pushcdn_tpu_torch"

# modules no process of a run may hold, compared by whole top-level name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pushcdn_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(BENCHMARK)


def config(name: str) -> dict:
    """``configs/<name>.json``: one deployment."""
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def workload(name: str) -> dict:
    """``workloads/<name>.json``: one traffic mix; its ``config`` names
    the deployment it runs on."""
    return load_json(os.path.join(HERE, "workloads", f"{name}.json"))


def cell_metrics(bench: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those that list it, and those that list no cell."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]


def forbidden_loaded(modules: Iterable[str]) -> List[str]:
    """The names in ``modules`` whose top-level name, compared whole, is
    JAX's or the JAX package's."""
    return sorted({m for m in modules
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def free_port() -> int:
    """A free loopback port, taken just before the process that binds it
    starts."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(port: int, path: str, timeout: float = 10.0):
    """``(status, body)`` of a GET on the loopback, or None when refused."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    except OSError:
        return None


# ---------------------------------------------------------------------------
# Prometheus text
# ---------------------------------------------------------------------------

Sample = Tuple[str, Dict[str, str], float]


def parse_metrics(text: str) -> List[Sample]:
    """Every sample line of a Prometheus text scrape as
    ``(name, labels, value)``."""
    out = []
    for line in text.splitlines():
        if not line or line[0] == "#":
            continue
        head, _, value = line.rpartition(" ")
        if not head:
            continue
        labels: Dict[str, str] = {}
        name = head
        if "{" in head:
            name, _, rest = head.partition("{")
            rest = rest[:rest.rfind("}")]
            for part in _split_labels(rest):
                k, _, v = part.partition("=")
                labels[k.strip()] = v.strip().strip('"')
        try:
            out.append((name.strip(), labels, float(value)))
        except ValueError:
            continue
    return out


def _split_labels(body: str) -> List[str]:
    parts, cur, quoted = [], [], False
    for ch in body:
        if ch == '"':
            quoted = not quoted
        if ch == "," and not quoted:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return [p for p in parts if p.strip()]


def metric_sum(samples: List[Sample], name: str, **labels) -> float:
    """The sum of ``name``'s samples that carry every label given."""
    return sum(v for n, lab, v in samples
               if n == name and all(lab.get(k) == w
                                    for k, w in labels.items()))


def histogram_buckets(samples: List[Sample], name: str) -> Dict[float, float]:
    """``le`` -> cumulative count of histogram ``name``, summed over every
    other label."""
    out: Dict[float, float] = {}
    for n, lab, v in samples:
        if n == name + "_bucket" and "le" in lab:
            le = math.inf if lab["le"] in ("+Inf", "inf") else float(lab["le"])
            out[le] = out.get(le, 0.0) + v
    return out


def histogram_quantile(q: float, buckets: Dict[float, float]
                       ) -> Optional[float]:
    """The ``q`` quantile of a cumulative histogram, interpolated linearly
    inside its bucket as Prometheus's ``histogram_quantile`` does; None
    without observations. A quantile in the open top bucket reads as the
    largest finite bound."""
    les = sorted(buckets)
    if not les:
        return None
    total = buckets[les[-1]]
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_c = 0.0, 0.0
    for le in les:
        c = buckets[le]
        if c >= rank:
            if math.isinf(le):
                return prev_le
            if c == prev_c:
                return le
            return prev_le + (le - prev_le) * (rank - prev_c) / (c - prev_c)
        prev_le, prev_c = le, c
    return prev_le


def percentile(values, q: float) -> float:
    """The ``q`` quantile (0..1) of ``values`` by the nearest rank."""
    import numpy as np
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        return math.nan
    k = max(0, min(v.size - 1, int(math.ceil(q * v.size)) - 1))
    return float(v[k])
