"""What every load generator shares: the users' keys and topics drawn
from the seed, and the payload every message carries.

A payload opens with a header (message type, publisher, the publisher's
sequence number, the payload's own length, and the time the benchmark
times it from: when it was due in an open loop, when it was sent in a
closed one) and is filled to its length from one fixed pseudo-random
buffer at an offset drawn from (publisher, sequence), so a receiver can
check every byte it got. A delivery is coded ``receiver << 40 |
publisher << 28 | sequence``; a delivery whose bytes do not check out
carries ``CORRUPT`` as well, so it matches nothing the oracle expects.

Each kind of traffic is a module beside this one, found by the name in a
workload file's ``kind``.
"""

from __future__ import annotations

import importlib
import struct

import numpy as np

from cdnbench.oracle import CORRUPT, SEQ_BITS  # noqa: F401 (the code's layout)

HDR = struct.Struct("<BHIIq")  # type, publisher, seq, payload bytes, ref ns
FILL_BYTES = 1 << 17
FILL = np.random.default_rng(0x5EED).integers(
    0, 256, FILL_BYTES, dtype=np.uint8).tobytes()
MAX_PAYLOAD = 1 << 16

# message types
DATA, PROPOSAL, DA, VOTE, PING = 1, 2, 3, 4, 5


def kind(name: str):
    """``traffic/<name>.py``."""
    return importlib.import_module(f"cdnbench.traffic.{name}")


def key_seed(seed: int, uid: int) -> int:
    """User ``uid``'s key seed: 8 bytes unsigned, distinct per (seed, uid)
    for any seed below 2**50."""
    return ((int(seed) & ((1 << 50) - 1)) << 12) | uid


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 63) - 1), *stream])


def code(uid, pub, seq):
    return (np.int64(uid) << 40) | (np.int64(pub) << SEQ_BITS) | np.int64(seq)


def fill_offset(pub: int, seq: int, n: int) -> int:
    return (pub * 7919 + seq * 104729) % (FILL_BYTES - n + 1)


def payload(mtype: int, pub: int, seq: int, size: int, ref_ns: int) -> bytes:
    """A payload of ``size`` bytes (at least the header's)."""
    n = max(size, HDR.size) - HDR.size
    off = fill_offset(pub, seq, n)
    return HDR.pack(mtype, pub, seq, n + HDR.size, ref_ns) + \
        FILL[off:off + n]


def read(body) -> tuple:
    """``(type, publisher, seq, ref_ns, ok)`` of a received payload; ``ok``
    is False when its length or any byte differs from what was sent."""
    mtype, pub, seq, size, ref_ns = HDR.unpack_from(body, 0)
    n = len(body) - HDR.size
    ok = size == len(body) and 0 <= n <= MAX_PAYLOAD
    if ok:
        off = fill_offset(pub, seq, n)
        ok = bytes(body[HDR.size:]) == FILL[off:off + n]
    return mtype, pub, seq, ref_ns, ok


def topic_weights(topics: int, popularity: str) -> np.ndarray:
    """Uniform, or zipf with weight 1/rank."""
    w = (1.0 / np.arange(1, topics + 1) if popularity == "zipf"
         else np.ones(topics))
    return w / w.sum()


STRUCTURE = 0x5EED   # the one draw of the work that every seed relabels


def users_relabel(users: int, blocks: int, seed: int) -> np.ndarray:
    """``owner[uid]``: the user of the seed-independent draw whose part
    user ``uid`` plays. Users are permuted within each of ``blocks`` equal
    shares (a generator's), so every share keeps its publishers; users past
    the last whole share keep their own part."""
    g = rng(seed, 4)
    share = users // blocks
    owner = np.arange(users)
    for k in range(blocks):
        owner[k * share:(k + 1) * share] = k * share + g.permutation(share)
    return owner


def topics_relabel(topics: int, seed: int) -> np.ndarray:
    """``perm[rank]``: the topic id that popularity rank ``rank`` takes."""
    return rng(seed, 1).permutation(topics)


def subscriptions(users: int, topics: int, per_user: int, popularity: str,
                  seed: int, blocks: int = 1):
    """Every user's ``per_user`` distinct topics, drawn by popularity.
    Which ranks each user holds is drawn once, the same for every seed
    (``STRUCTURE``); the seed relabels it: the ranks onto topic ids by a
    permutation, and the users by ``users_relabel`` over ``blocks``
    shares. So every seed gives the same number of users to each rank.
    Returns ``(topics per user, the topics' weights by id)``."""
    g = rng(STRUCTURE, 1)
    w_rank = topic_weights(topics, popularity)
    ranks = [g.choice(topics, per_user, replace=False, p=w_rank)
             for _ in range(users)]
    perm = topics_relabel(topics, seed)
    w = np.empty(topics)
    w[perm] = w_rank
    owner = users_relabel(users, blocks, seed)
    subs = [sorted(int(perm[r]) for r in ranks[owner[u]])
            for u in range(users)]
    return subs, w


def sizes(g: np.random.Generator, n: int, wl: dict) -> np.ndarray:
    """Payload sizes: each one of ``payload_choices`` with equal chance
    where the mix lists them; else log-uniform over ``payload_bytes``,
    with a ``wide_share`` of them uniform over ``wide_payload_bytes``."""
    if "payload_choices" in wl:
        return np.asarray(wl["payload_choices"], np.int64)[
            g.integers(0, len(wl["payload_choices"]), n)]
    lo, hi = wl["payload_bytes"]
    out = np.exp(g.uniform(np.log(lo), np.log(hi + 1), n)).astype(np.int64)
    wide = g.random(n) < wl.get("wide_share", 0.0)
    if wide.any():
        wlo, whi = wl["wide_payload_bytes"]
        out[wide] = g.integers(wlo, whi + 1, int(wide.sum()))
    return np.clip(out, HDR.size, MAX_PAYLOAD)
