"""The port's local cluster runner in its operations modes: the twins of
``tests/test_local_cluster.py``'s load-shed, sharded-broker, chaos
broker-kill smoke, re-home and replay cases, and of its full chaos suite
(``slow``, as its original is), with the same OK lines."""

import os

import pytest

from test_torch_local_cluster import cluster_test, run_runner


@cluster_test
def test_local_cluster_load_shed():
    """Forced subscribe-rate overload against a real broker: the shed
    reaches the client as a typed Error, the broker flips /readyz 503 with
    the ``admission`` check failing and records the ``load-shed`` event,
    then recovers once the storm stops."""
    rc, out = run_runner("--duration", "12", "--base-port", "0", "--churn")
    assert rc == 0, f"churn local_cluster failed:\n{out[-6000:]}"
    assert "OK: end-to-end echo through real processes" in out, out[-6000:]
    assert "typed shed Error observed by the client" in out, out[-6000:]
    assert "load shed observed" in out, out[-6000:]
    assert "shed flight-recorder event recorded" in out, out[-6000:]
    assert "load shed recovered" in out, out[-6000:]
    assert "FAIL" not in out, out[-6000:]


@cluster_test
def test_local_cluster_sharded_broker(tmp_path):
    """broker0 as 2 worker processes (fd-handoff accept, so the two
    clients land on different workers): the merged observability plane
    answers for the group, the rings carried cross-shard directs, and the
    strict trace gate sees complete chains through the cross-shard hop."""
    trace_dir = str(tmp_path / "spans")
    rc, out = run_runner("--duration", "25", "--base-port", "0",
                         "--shards", "2", "--trace-log", trace_dir,
                         timeout=240)
    assert rc == 0, f"sharded local_cluster failed:\n{out[-6000:]}"
    assert "OK: end-to-end echo through real processes" in out, out[-6000:]
    assert "health OK (5 processes" in out, out[-6000:]
    assert "topology OK" in out, out[-6000:]
    assert "shard plane OK: 2 workers" in out, out[-6000:]
    assert "trace chain complete" in out, out[-6000:]
    assert "trace report OK" in out, out[-6000:]
    assert "0 orphaned spans" in out, out[-6000:]
    assert "drain readiness flip observed" in out, out[-6000:]
    assert "FAIL" not in out, out[-6000:]
    # each worker wrote its own span log
    logs = set(os.listdir(trace_dir))
    assert {"broker0-shard0.jsonl", "broker0-shard1.jsonl"} <= logs, logs


@cluster_test
def test_local_cluster_chaos_broker_kill_smoke():
    """One chaos event: SIGKILL the broker serving the echo client; the
    client re-balances through the marshal and echoes again, the survivor
    logs the peer's removal, and the respawned victim re-forms the
    mesh."""
    rc, out = run_runner("--duration", "10", "--base-port", "0",
                         "--chaos", "--chaos-events", "broker", timeout=240)
    assert rc == 0, f"chaos local_cluster failed:\n{out[-6000:]}"
    assert "SIGKILL broker" in out, out[-6000:]
    assert "echo resumed after" in out, out[-6000:]
    assert "peer-loss correlation" in out, out[-6000:]
    assert "mesh re-formed after" in out, out[-6000:]
    assert "all chaos events rode out" in out, out[-6000:]
    assert "FAIL" not in out, out[-6000:]


@pytest.mark.slow
@cluster_test
def test_local_cluster_chaos_full_suite():
    """Every scripted chaos event: broker SIGKILL, marshal loss and a
    discovery outage held past the store's busy timeout."""
    rc, out = run_runner("--duration", "20", "--base-port", "0", "--chaos",
                         timeout=400)
    assert rc == 0, f"chaos local_cluster failed:\n{out[-8000:]}"
    assert "echo resumed after" in out, out[-8000:]
    assert "new admissions refused while the marshal is down" in out
    assert "established data plane kept echoing" in out, out[-8000:]
    assert "new admissions refused during the discovery outage" in out
    assert "admissions recovered after the discovery outage" in out
    assert "heartbeat task-died event recorded" in out, out[-8000:]
    assert "all chaos events rode out" in out, out[-8000:]
    assert "FAIL" not in out, out[-8000:]


@cluster_test
def test_local_cluster_rehome(tmp_path):
    """``GET /drain`` on the broker homing the echo client re-homes it to
    the survivor with a typed Migrate frame; the drained broker latches
    503 ``draining`` while serving, the echo flows on the new home, and
    the strict trace gate passes through the migration."""
    trace_dir = str(tmp_path / "spans")
    rc, out = run_runner("--duration", "10", "--base-port", "0",
                         "--rehome", "--trace-log", trace_dir)
    assert rc == 0, f"rehome local_cluster failed:\n{out[-6000:]}"
    assert "rehome drain summary" in out, out[-6000:]
    assert "'orphaned': 0" in out, out[-6000:]
    assert "rehome OK" in out, out[-6000:]
    assert "echo alive on the new home" in out, out[-6000:]
    assert "trace report OK" in out, out[-6000:]
    assert "0 orphaned spans" in out, out[-6000:]
    assert "FAIL" not in out, out[-6000:]


@cluster_test
def test_local_cluster_replay(tmp_path):
    """Durable-topic catch-up through real broker processes: one frame
    live, the subscriber killed, more frames into the ring, then a fresh
    client's ``subscribe_from(topic, 1)`` receives the whole history as an
    in-order ``Retained`` run followed by live delivery."""
    trace_dir = str(tmp_path / "spans")
    rc, out = run_runner("--duration", "10", "--base-port", "0",
                         "--replay", "--trace-log", trace_dir)
    assert rc == 0, f"replay local_cluster failed:\n{out[-6000:]}"
    assert "replay phase 1: live frame delivered" in out, out[-6000:]
    assert "retained frames replayed in order" in out, out[-6000:]
    assert "replay OK: retained 1..5 then live" in out, out[-6000:]
    assert "trace report OK" in out, out[-6000:]
    assert "0 orphaned spans" in out, out[-6000:]
    assert "FAIL" not in out, out[-6000:]
