"""The cell ``hotshot_1k_2b.views_replay`` end to end on the CPU (the
harness's rehearsal mode: the two brokers' planes run their plain
PyTorch step): a clean run at a load the CPU keeps up with is correct,
and a run with nothing forwarded over the broker link (``nolink``) or
with every plane step routing nothing (``stale``) is not."""

import json
import subprocess
import sys

import pytest

from cdnbench import common

CELL = "hotshot_1k_2b.views_replay"


def run(*args):
    p = subprocess.run([sys.executable, "-m", "cdnbench.run", "--workload",
                        CELL, "--seed", "68719476767", "--seconds", "3",
                        "--trace", "0", "--rehearse-cpu", "--rate", "4",
                        *args], cwd=common.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_clean_cpu_run_is_correct():
    r = run()
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) >= {"missing", "out_of_order", "unsent",
                                "unplanned", "unclosed_views"}
    assert {"setup_s", "delivered_msgs_per_s"} <= set(r["metrics"])


@pytest.mark.parametrize("plant", ["nolink", "stale"])
def test_a_broken_path_is_not_correct(plant):
    r = run("--plant", plant)
    assert not r["correct"] and r["checks"]["missing"]["value"] > 0
