"""The oracle against schedules worked by hand, and ``correct`` turned
false by each fault injected into the comparison's input."""

import numpy as np
import pytest

from cdnbench import oracle
from cdnbench.traffic import CORRUPT, code

# four users; topic 0: users 0 and 1, topic 1: users 1 and 2, topic 2: none
TOPICS = [[0], [0, 1], [1], [3]]


def sends(*rows):
    """(pub, seq, target, t0, t1) rows as the oracle's arrays."""
    a = np.asarray(rows, np.int64).reshape(-1, 5)
    return [a[:, i] for i in range(5)]


def test_broadcast_reaches_every_subscriber_once_publisher_included():
    got = oracle.expected(TOPICS, 4, *sends((1, 0, -1, 0, -1)))
    assert got.tolist() == sorted([code(0, 1, 0), code(1, 1, 0)])


def test_two_topics_reach_their_union_once():
    got = oracle.expected(TOPICS, 4, *sends((3, 7, -1, 0, 1)))
    assert got.tolist() == sorted([code(u, 3, 7) for u in (0, 1, 2)])


def test_direct_reaches_its_target_alone():
    got = oracle.expected(TOPICS, 4, *sends((2, 5, 3, -1, -1)))
    assert got.tolist() == [code(3, 2, 5)]


def test_a_topic_nobody_holds_reaches_nobody():
    assert oracle.expected(TOPICS, 4, *sends((0, 0, -1, 2, -1))).size == 0


def test_chunks_agree_with_one_pass(monkeypatch):
    rng = np.random.default_rng(3)
    n = 300
    rows = np.stack([rng.integers(0, 4, n), np.arange(n),
                     np.where(rng.random(n) < 0.2, rng.integers(0, 4, n), -1),
                     rng.integers(0, 4, n), rng.integers(-1, 4, n)], axis=1)
    whole = oracle.expected(TOPICS, 4, *sends(*rows))
    monkeypatch.setattr(oracle, "CHUNK", 7)
    assert np.array_equal(oracle.expected(TOPICS, 4, *sends(*rows)), whole)


def _arrivals():
    """Due: publisher 1 seqs 0..2 to users 0 and 1; a direct 2 -> 3."""
    want = oracle.expected(TOPICS, 4, *sends(
        (1, 0, -1, 0, -1), (1, 1, -1, 0, -1), (1, 2, -1, 0, -1),
        (2, 0, 3, -1, -1)))
    got = [code(0, 1, s) for s in range(3)] + \
        [code(1, 1, s) for s in range(3)] + [code(3, 2, 0)]
    return want, np.asarray(got, np.int64)


def test_the_right_deliveries_pass():
    want, got = _arrivals()
    assert oracle.judge(want, got) == dict(missing=0, extra=0,
                                           out_of_order=0, corrupt=0)


def test_interleaved_receivers_keep_their_own_order():
    want, got = _arrivals()
    mixed = got[[0, 3, 1, 4, 6, 2, 5]]
    assert oracle.judge(want, mixed)["out_of_order"] == 0


@pytest.mark.parametrize("fault,number", [
    ("dropped", "missing"), ("duplicated", "extra"),
    ("reordered", "out_of_order"), ("to a non-subscriber", "extra"),
    ("altered", "corrupt")])
def test_each_fault_turns_correct_false(fault, number):
    want, got = _arrivals()
    if fault == "dropped":
        got = got[1:]
    elif fault == "duplicated":
        got = np.concatenate([got, got[:1]])
    elif fault == "reordered":
        got = got[[1, 0, 2, 3, 4, 5, 6]]
    elif fault == "to a non-subscriber":
        got = np.concatenate([got, [code(2, 1, 0)]])
    else:
        got = got.copy()
        got[0] |= CORRUPT
    numbers = oracle.judge(want, got)
    assert numbers[number] > 0
    assert not all(v <= 0 for v in numbers.values())


def test_an_altered_delivery_is_also_missing():
    want, got = _arrivals()
    got = got.copy()
    got[2] |= CORRUPT
    numbers = oracle.judge(want, got)
    assert numbers["corrupt"] == 1 and numbers["missing"] == 1


def test_multiset_diff_counts_multiplicity():
    missing, extra = oracle.multiset_diff(np.array([1, 1, 2]),
                                          np.array([1, 2, 2, 3]))
    assert missing.tolist() == [1] and extra.tolist() == [2, 3]
