"""Nothing the benchmark runs imports JAX or the JAX package, and the
yardstick (the oracle, the roofline, the readers) imports nothing of the
program either. Names are compared whole by their top-level part: the
port's ``pushcdn_tpu_torch`` begins with the JAX package's name."""

import ast
import os
import subprocess
import sys

import pytest

from cdnbench import common

HERE = common.HERE
YARDSTICK = ("oracle.py", "roofline.py", "common.py")


def sources():
    for root, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py") and "tests" not in root.split(os.sep):
                yield os.path.join(root, f)


def imported(path):
    tree = ast.parse(open(path).read())
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for a in n.names:
                yield a.name
        elif isinstance(n, ast.ImportFrom) and n.module and not n.level:
            yield n.module


@pytest.mark.parametrize("path", sorted(sources()))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert common.forbidden_loaded(imported(path)) == []


@pytest.mark.parametrize("name", YARDSTICK + tuple(
    os.path.join(d, f) for d in ("layers", "e2e")
    for f in sorted(os.listdir(os.path.join(HERE, d))) if f.endswith(".py")))
def test_the_yardstick_imports_nothing_of_the_program(name):
    mods = list(imported(os.path.join(HERE, name)))
    assert not [m for m in mods if m.split(".")[0] == common.PROGRAM]


def test_whole_names_are_compared():
    assert common.forbidden_loaded(["pushcdn_tpu_torch.client",
                                    "jaxtyping", "numpy"]) == []
    assert common.forbidden_loaded(["pushcdn_tpu.ops", "jax.numpy",
                                    "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "pushcdn_tpu.ops"]


def test_loading_the_yardstick_loads_no_program():
    code = ("import sys; import cdnbench.oracle, cdnbench.roofline, "
            "cdnbench.layers.plane_routed_pct, cdnbench.traffic.pubsub, "
            "cdnbench.traffic.views, cdnbench.traffic.pingpong; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'pushcdn_tpu', 'pushcdn_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"


def test_the_program_path_loads_no_jax():
    """What a generator and a broker launcher import."""
    code = ("import sys; import cdnbench.gen, cdnbench.broker_launch; "
            "import pushcdn_tpu_torch.client.client, "
            "pushcdn_tpu_torch.bin.broker, pushcdn_tpu_torch.bin.marshal; "
            "from cdnbench.common import forbidden_loaded; "
            "print(forbidden_loaded(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"
