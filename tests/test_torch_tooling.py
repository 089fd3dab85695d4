"""The port's run provenance and its out-of-process card probe.

``testing.provenance`` keeps the JAX package's keys but ``jax`` and adds
``torch``, ``cuda`` and ``gpu``, none of which loads torch. The probe
(``testing.accel_probe``) is the CUDA twin of JAX's: it reports the card
unreachable on a host without one, memoises the answer, kills the whole
process group of a probe that outlives its timeout, and has no CPU
fallback: ``require_accelerator`` raises instead. ``scripts.smoke_ab``
runs ``chip_smoke.py`` from several trees in turn and times each run."""

import os
import subprocess
import sys
import time

import pytest

from pushcdn_tpu.testing import accel_probe as jax_probe
from pushcdn_tpu.testing import provenance as jax_provenance
from pushcdn_tpu_torch.testing import accel_probe
from pushcdn_tpu_torch.testing import provenance

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_provenance_keys_are_jax_minus_jax_plus_torch_cuda_gpu():
    row = provenance.provenance()
    want = (set(jax_provenance.provenance()) - {"jax"}) | {"torch", "cuda",
                                                           "gpu"}
    assert set(row) == want
    # the fields both packages share read the same on one host
    ref = jax_provenance.provenance()
    for key in ("cpus", "git_sha", "python", "platform", "argv0"):
        assert row[key] == ref[key], key
    assert row["git_sha"] == jax_provenance.git_sha() != ""
    assert row["torch"] == __import__("torch").__version__


_STAMP = r"""
import json, sys
from pushcdn_tpu_torch.testing.provenance import provenance
row = provenance()
assert "torch" not in sys.modules, "provenance imported torch"
print(json.dumps(row))
"""


def test_provenance_never_imports_torch():
    r = subprocess.run([sys.executable, "-c", _STAMP], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    import json
    row = json.loads(r.stdout)
    assert row["torch"] is not None
    # a host without nvidia-smi has no card to name
    import shutil
    if shutil.which("nvidia-smi") is None:
        assert row["gpu"] is None


def test_cuda_version_reads_metadata_then_nvcc(monkeypatch):
    class Dist:
        def __init__(self, name, version):
            self.metadata = {"Name": name}
            self.version = version

    monkeypatch.setattr(provenance.importlib.metadata, "distributions",
                        lambda: [Dist("numpy", "2.0"),
                                 Dist("nvidia-cuda-runtime-cu12", "12.8.90")])
    assert provenance.cuda_version() == "12.8.90"
    monkeypatch.setattr(provenance.importlib.metadata, "distributions",
                        lambda: [])
    monkeypatch.setattr(provenance, "_run", lambda argv: (
        "nvcc: NVIDIA (R) Cuda compiler driver\n"
        "Cuda compilation tools, release 12.8, V12.8.93"))
    assert provenance.cuda_version() == "12.8"
    monkeypatch.setattr(provenance, "_run", lambda argv: None)
    assert provenance.cuda_version() is None
    assert provenance.gpu() is None


@pytest.fixture
def fresh_memo(monkeypatch):
    monkeypatch.setattr(accel_probe, "_MEMO", None)


def test_probe_reports_no_card_here_and_memoises(fresh_memo, monkeypatch):
    ok, why = accel_probe.accelerator_reachable(timeout_s=120)
    assert ok is False
    assert why.startswith("probe exited "), why
    # memoised: a second call does not spawn a probe
    monkeypatch.setattr(accel_probe.subprocess, "Popen",
                        lambda *a, **k: pytest.fail("probed twice"))
    assert accel_probe.accelerator_reachable() == (ok, why)


def test_probe_runs_the_cuda_twin_of_jax_probe():
    assert "torch.zeros(1, device=\"cuda\")" in accel_probe._PROBE
    assert "jax" not in accel_probe._PROBE
    assert "jax.device_put" in jax_probe._PROBE


_SLEEPER = r"""
import os, subprocess, sys, time
child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
with open(sys.argv[1], "w") as f:
    f.write(f"{os.getpid()} {child.pid}")
time.sleep(60)
"""


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except OSError:
        return False
    return state != "Z"


def test_probe_timeout_kills_the_whole_process_group(fresh_memo, monkeypatch,
                                                     tmp_path):
    """A probe that outlives its timeout is killed with every process of
    its session (a helper it forked would otherwise hold the pipes), and
    the call reports instead of raising."""
    pids = tmp_path / "pids"
    script = tmp_path / "sleeper.py"
    script.write_text(_SLEEPER)
    monkeypatch.setattr(accel_probe, "_PROBE",
                        f"import runpy, sys; sys.argv = ['s', {str(pids)!r}]; "
                        f"runpy.run_path({str(script)!r})")
    t0 = time.monotonic()
    ok, why = accel_probe.accelerator_reachable(timeout_s=1.0,
                                                use_cache=False)
    assert time.monotonic() - t0 < 30
    assert ok is False and "timed out after 1s" in why, why
    probe, helper = map(int, pids.read_text().split())
    deadline = time.monotonic() + 10
    while _alive(helper) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _alive(probe)
    assert not _alive(helper), "the probe's helper outlived the timeout"


def test_require_accelerator_raises_with_the_reason(fresh_memo):
    with pytest.raises(RuntimeError, match=r"smoke: CUDA device unreachable "
                                           r"\(probe exited "):
        accel_probe.require_accelerator("smoke")


def test_no_cpu_fallback_in_the_port():
    assert hasattr(jax_probe, "force_cpu_if_unreachable")
    assert not hasattr(accel_probe, "force_cpu_if_unreachable")
    src = open(accel_probe.__file__).read()
    assert "jax_platforms" not in src and 'device="cpu"' not in src


_FAKE_SMOKE = """
import json, sys, time
time.sleep({sleep})
print(json.dumps({{"phase": "phase_seconds", "1": {sleep}}}))
if {rc}:
    print("chip_smoke: FAILED: a check", file=sys.stderr)
    sys.exit({rc})
print(json.dumps({{"ok": True}}))
"""


def test_smoke_ab_runs_each_tree_in_turn_and_times_it(tmp_path):
    trees = {}
    for name, sleep, rc in (("parent", 0.3, 0), ("change", 0.0, 1)):
        d = tmp_path / name
        d.mkdir()
        (d / "chip_smoke.py").write_text(_FAKE_SMOKE.format(sleep=sleep,
                                                            rc=rc))
        trees[name] = d
    out = tmp_path / "ab"
    r = subprocess.run(
        [sys.executable, "-m", "pushcdn_tpu_torch.scripts.smoke_ab",
         f"parent={trees['parent']}", f"change={trees['change']}",
         "--out", str(out)], cwd=ROOT, capture_output=True, text=True,
        timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]
    import json
    rows = [json.loads(line) for line in r.stdout.splitlines()
            if line.startswith('{"run"')]
    assert [(x["run"], x["tree"], x["rc"]) for x in rows] == \
        [(0, "parent", 0), (1, "change", 1)]
    assert rows[0]["command_s"] >= 0.3
    assert '{"ok": true}' in r.stdout and "FAILED: a check" in r.stdout
    assert sorted(p.name for p in out.iterdir()) == [
        "0-parent.err", "0-parent.out", "1-change.err", "1-change.out"]
    bad = subprocess.run(
        [sys.executable, "-m", "pushcdn_tpu_torch.scripts.smoke_ab",
         f"x={tmp_path}"], cwd=ROOT, capture_output=True, text=True,
        timeout=60)
    assert bad.returncode != 0 and "dir holding chip_smoke.py" in bad.stderr
