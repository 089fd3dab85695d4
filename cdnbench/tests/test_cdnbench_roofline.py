"""``roofline.py`` against the cases ``tests/test_torch_bounds.py`` counts
by hand for ``chip_smoke.py``'s originals."""

import numpy as np
import pytest
import torch

from cdnbench import roofline as rl

B, D = rl.KIND_BROADCAST, rl.KIND_DIRECT


def _i32(*rows):
    return torch.tensor(np.asarray(rows, np.uint32).view(np.int32))


@pytest.mark.parametrize("sms,clock_hz,want", [
    (132, 1.98e9, 64 * 132 * 1.98e9), (1, 1e9, 64e9)])
def test_int32_peak(sms, clock_hz, want):
    assert rl.int32_peak(sms, clock_hz) == want


def test_int32_peak_defaults_to_the_h100():
    assert rl.int32_peak() == pytest.approx(16.727e12, rel=1e-4)


@pytest.mark.parametrize("nbytes,ops,by", [
    (3.35e9, 0, "bytes"), (0, 64e6, "operations"),
    (6.7e9, 64e6, "bytes"), (3.35e9, 128e6, "operations")])
def test_bound_takes_the_larger_time(nbytes, ops, by):
    b = rl.bound(nbytes, ops, 64e9)
    assert b["bytes_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert b["ops_ms"] == pytest.approx(ops / 64e9 * 1e3)
    assert b["bound_ms"] == max(b["bytes_ms"], b["ops_ms"])
    assert b["bound_by"] == by


def _dense(case):
    if case == "one word":
        return (_i32(1, 3), torch.tensor([True, False]), _i32(1, 0, 2),
                torch.tensor([B, B, D], dtype=torch.int32),
                torch.tensor([0, -1, 1], dtype=torch.int32))
    if case == "eight words":
        return (torch.ones((4, 8), dtype=torch.int32),
                torch.ones(4, dtype=torch.bool),
                _i32([1, 0, 0, 0, 0, 0, 0, 2], [0] * 8),
                torch.tensor([B, D], dtype=torch.int32),
                torch.tensor([-1, 3], dtype=torch.int32))
    return (torch.ones((3, 2), dtype=torch.int32),
            torch.tensor([True, True, False]),
            torch.ones((2, 2), dtype=torch.int32),
            torch.tensor([0, 9], dtype=torch.int32),
            torch.tensor([0, 1], dtype=torch.int32))


@pytest.mark.parametrize("case,nbytes,ops", [
    ("one word", 6 + 2 * 5 + 3 * 12, 6 + 1 * (1 + 1)),
    ("eight words", 8 + 4 * 33 + 2 * 40, 8 + 4 * (2 + 1)),
    ("other kinds", 6 + 3 * 9 + 2 * 16, 6)])
def test_dense_work(case, nbytes, ops):
    assert rl.dense_work(*_dense(case)) == (nbytes, ops)


def _pages():
    pages = torch.full((3, rl.PAGE), -1, dtype=torch.int32)
    pages[1, :3] = torch.tensor([0, 1, 5])
    pages[2, :2] = torch.tensor([2, 3])
    return pages


def _ragged(case):
    U = 4
    local = torch.ones(U, dtype=torch.bool)
    if case == "one word":
        return (_pages(), torch.tensor([1, 2, 1, 7], dtype=torch.int32),
                torch.tensor([0, 1, 1, 0], dtype=torch.int32), local,
                torch.ones(U, dtype=torch.int32), _i32(3, 0),
                torch.tensor([B, D], dtype=torch.int32),
                torch.tensor([-1, 2], dtype=torch.int32))
    if case == "eight words":
        return (_pages(), torch.tensor([1, 2], dtype=torch.int32),
                torch.tensor([0, 1], dtype=torch.int32), local,
                torch.ones((U, 8), dtype=torch.int32),
                _i32([1, 0, 0, 0, 0, 0, 0, 1], [0] * 8),
                torch.tensor([B, 0], dtype=torch.int32),
                torch.tensor([-1, -1], dtype=torch.int32))
    return (_pages(), torch.tensor([-1, 1], dtype=torch.int32),
            torch.tensor([0, 5], dtype=torch.int32), local,
            torch.ones(U, dtype=torch.int32), _i32(3, 0),
            torch.tensor([B, D], dtype=torch.int32),
            torch.tensor([-1, 2], dtype=torch.int32))


@pytest.mark.parametrize("case,nbytes,ops", [
    ("one word", 512 * 2 + 8 * 4 + 4 * 5 + 2 * 12 + 516 * 4,
     256 * 4 + 2 * (1 + 1) + 2 * (1 + 1) + 2 * (1 + 1)),
    ("eight words", 512 * 2 + 8 * 2 + 4 * 33 + 2 * 40 + 516 * 2,
     256 * 2 + 2 * (1 + 2) + 2 * (1 + 0)),
    ("out of range", 8 * 2 + 516 * 2, 256 * 2)])
def test_ragged_work(case, nbytes, ops):
    assert rl.ragged_work(*_ragged(case)) == (nbytes, ops)


def test_the_copy_imports_nothing_of_the_program():
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(rl))
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names} | {n.module for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)}
    assert not any(str(m).split(".")[0].startswith("pushcdn") for m in names)
