"""Local cluster runner (parity with the reference's process-compose.yaml:
discovery store + marshal + 2 brokers + an echo client, each a real OS
process over TCP; SQLite stands in for KeyDB).

    python -m pushcdn_tpu_torch.scripts.local_cluster [--duration 30] \
        [--topology] [--device-plane [--device cpu]]

A copy of ``scripts/local_cluster.py`` that spawns this package's
binaries (``pushcdn_tpu_torch.bin.*``). The runner itself never imports
torch; a broker it starts with ``--device-plane`` does, and runs its
plane on ``--device`` (default: CUDA; such a broker exits non-zero where
there is none, and the run fails). ``--device`` is this package's
counterpart of the JAX runner's ``JAX_PLATFORMS``. ``--io-impl`` and
``--pump`` reach every spawned component through ``PUSHCDN_IO_IMPL`` and
``PUSHCDN_PUMP``; with ``--pump auto`` the run checks that the fused pump
engaged and pumped frames wherever the kernel allows io_uring, and says
it skipped the check elsewhere. ``scripts/trace_report.py`` and ``scripts/cdn_top.py`` import
nothing of either package and run as they are.

Beyond the end-to-end echo, the run proves the observability plane end
to end:

- every process serves ``/healthz`` + ``/readyz`` (readiness is observed
  FALSE before broker0's listeners bind, TRUE once the cluster is up, and
  FALSE again during drain — before the listeners close);
- broker ``/debug/topology`` reflects the actual mesh (each broker sees
  the other as its one peer; the client appears as a user exactly once);
- ``scripts/trace_report.py --strict`` over the per-process span logs
  reports per-hop p50/p99 for a complete publish→delivery chain with zero
  orphaned spans (with ``--trace-log``).

``--chaos`` adds scripted failure injection after the baseline checks:
a broker SIGKILL (with ``--shards``, a shard-*worker* SIGKILL that
fail-fasts the whole sharded box), a marshal loss, and a discovery-store
outage — each asserted against its composition invariant (echo rides out
control-plane loss; survivors dump the abnormal-disconnect trail; new
admissions are refused, never silently dropped; everything recovers on
respawn/release).

Exits nonzero if any component dies early, the client fails to echo, or
any observability or chaos check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

from pushcdn_tpu_torch.bin.common import spawn_binary

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# brokers keep serving (readiness already 503) this long after SIGINT —
# the window the drain check probes
DRAIN_GRACE_S = 2.0

# how long broker0's metrics endpoint may take to give its first answer:
# the JAX runner's 8 s, and longer for a ``--device-plane`` broker, which
# imports torch and brings CUDA up before it serves one (a slow card host
# took more than 8 s)
STARTUP_WINDOW_S = 8.0
PLANE_STARTUP_WINDOW_S = 45.0


def startup_window_s(device_plane: bool) -> float:
    return PLANE_STARTUP_WINDOW_S if device_plane else STARTUP_WINDOW_S


def spawn(name: str, *args: str, env_extra=None,
          log_path=None) -> subprocess.Popen:
    """Brokers and the marshal pass ``log_path``: nothing drains their
    pipes while they run (only the client's stdout is read live), and a
    chatty ``--shards`` broker — parent plus workers sharing one fd —
    wedges once the 64 KiB pipe buffer fills; a log file avoids the
    wedge while keeping crash output for the died-early diagnostic."""
    proc = spawn_binary(name, *args, env_extra=env_extra,
                        log_path=log_path)
    print(f"[cluster] {name} up (pid {proc.pid})")
    return proc


def http_get(port: int, path: str, timeout: float = 2.0):
    """(status, body_str) from a process's observability endpoint; None
    when nothing answers (connection refused / timeout)."""
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:  # 4xx/5xx still carry a body
        return exc.code, exc.read().decode()
    except (urllib.error.URLError, OSError, TimeoutError):
        return None


def wait_http(port: int, path: str, wait_s: float = STARTUP_WINDOW_S,
              alive=None):
    """Poll until the endpoint answers at all; returns (status, body).
    Gives up early once ``alive()`` says the process is gone."""
    deadline = time.time() + wait_s
    while time.time() < deadline:
        res = http_get(port, path, timeout=1.0)
        if res is not None:
            return res
        if alive is not None and not alive():
            return None
        time.sleep(0.05)
    return None


def check_readiness_before_bind(port: int, device_plane: bool = False,
                                alive=None) -> bool:
    """broker0 starts its metrics endpoint BEFORE binding listeners (and
    holds the bind for PUSHCDN_BIND_DELAY_S): the first /readyz answer,
    within ``startup_window_s(device_plane)``, must be 503 with the
    listeners check failing."""
    res = wait_http(port, "/readyz", startup_window_s(device_plane), alive)
    if res is None:
        print("[cluster] FAIL: broker0 /readyz never answered during startup")
        return False
    status, body = res
    if status != 503:
        print(f"[cluster] FAIL: pre-bind /readyz was {status}, wanted 503 "
              f"(body {body[:200]})")
        return False
    try:
        doc = json.loads(body)
        # sharded brokers aggregate worker checks as "shardN:listeners";
        # an unreachable worker ("shardN:reachable" false) is the same
        # not-ready-before-bind state observed earlier in startup
        relevant = [c["ok"] for name, c in doc["checks"].items()
                    if name.rsplit(":", 1)[-1] in ("listeners",
                                                   "reachable")]
        listeners_ok = bool(relevant) and all(relevant)
    except (ValueError, KeyError):
        print(f"[cluster] FAIL: pre-bind /readyz body unparseable: {body[:200]}")
        return False
    if listeners_ok:
        print("[cluster] FAIL: pre-bind /readyz 503 but listeners check ok?")
        return False
    print("[cluster] readiness pre-bind: 503 not-ready (listeners unbound) "
          "as expected")
    return True


def check_health(ports: dict) -> bool:
    """/healthz + /readyz on every process: 200s with the check schema."""
    for name, port in ports.items():
        for path in ("/healthz", "/readyz"):
            res = None
            deadline = time.time() + 10.0
            while time.time() < deadline:  # readiness may lag startup
                res = http_get(port, path)
                if res is not None and res[0] == 200:
                    break
                time.sleep(0.2)
            if res is None:
                print(f"[cluster] FAIL: {name} {path} unreachable")
                return False
            status, body = res
            try:
                doc = json.loads(body)
                checks = doc["checks"]
                assert isinstance(checks, dict)
                for c in checks.values():
                    assert isinstance(c["ok"], bool)
                    assert "detail" in c
            except (ValueError, KeyError, AssertionError):
                print(f"[cluster] FAIL: {name} {path} schema drift: "
                      f"{body[:300]}")
                return False
            if status != 200:
                print(f"[cluster] FAIL: {name} {path} = {status} "
                      f"({body[:300]})")
                return False
    print(f"[cluster] health OK ({len(ports)} processes serve "
          "/healthz + /readyz)")
    return True


TOPOLOGY_KEYS = ("identity", "draining", "interest_version", "num_users",
                 "num_brokers", "peers", "users", "interest", "cutthrough")


def fetch_topology(port: int):
    res = http_get(port, "/debug/topology")
    if res is None or res[0] != 200:
        return None
    try:
        return json.loads(res[1])
    except ValueError:
        return None


def check_topology(broker_ports: dict, expected_users: int = 1) -> bool:
    """Each broker's /debug/topology must reflect the real mesh: the other
    broker as its one peer, and every client as a user exactly once."""
    topos = {}
    for name, port in broker_ports.items():
        deadline = time.time() + 10.0
        topo = None
        while time.time() < deadline:
            topo = fetch_topology(port)
            if topo is not None and topo.get("num_brokers", 0) >= 1:
                break
            time.sleep(0.2)
        if topo is None:
            print(f"[cluster] FAIL: {name} /debug/topology unreachable")
            return False
        missing = [k for k in TOPOLOGY_KEYS if k not in topo]
        if missing:
            print(f"[cluster] FAIL: {name} topology schema drift: "
                  f"missing {missing}")
            return False
        topos[name] = topo
    idents = {name: t["identity"] for name, t in topos.items()}
    for name, topo in topos.items():
        peer_ids = [p["id"] for p in topo["peers"]]
        expected = [i for n, i in idents.items() if n != name]
        if sorted(peer_ids) != sorted(expected):
            print(f"[cluster] FAIL: {name} mesh mismatch: peers={peer_ids} "
                  f"expected={expected}")
            return False
    total_users = sum(t["num_users"] for t in topos.values())
    if total_users != expected_users:
        print(f"[cluster] FAIL: expected exactly {expected_users} connected "
              f"user(s) across the mesh, saw {total_users}")
        return False
    print(f"[cluster] topology OK (mesh verified: each broker sees the "
          f"other; {total_users} user(s) connected)")
    return True


def check_pump(broker_ports: dict) -> bool:
    """``--pump auto``: poll each broker's topology until the fused
    data-plane pump reports engaged peers AND natively pumped frames
    (the echo client keeps publishing in the background, so frames keep
    arriving while we poll), or report an honest skip when the
    composition cannot engage on this host — never a silent demotion."""
    deadline = time.time() + 12.0
    engaged = {}
    while time.time() < deadline:
        for name, port in broker_ports.items():
            topo = fetch_topology(port)
            ps = ((topo or {}).get("cutthrough") or {}).get("pump")
            if ps:
                engaged[name] = ps
                if ps.get("pump_frames", 0) > 0:
                    print(f"[cluster] pump OK ({name}: engaged_peers="
                          f"{ps['engaged_peers']}, pump_frames="
                          f"{ps['pump_frames']}, escalated="
                          f"{sum(ps.get('escalations', {}).values())})")
                    return True
        time.sleep(0.3)
    if engaged:
        print(f"[cluster] FAIL: pump engaged but never pumped a frame: "
              f"{engaged}")
        return False
    print("[cluster] pump skipped (composition not engaged on this host: "
          "io_uring or the native route planner unavailable)")
    return True


def check_collector(metrics_ports: dict, broker_ports: dict,
                    logdir: str) -> bool:
    """``--collector``: drive ``scripts/cdn_top.py --once --record
    --bundle`` against the live cluster and verify the one-pane plane
    end to end — the collector reaches every process, the recorded
    timeline carries a reducible headline, and the postmortem bundle
    holds every process's raw metrics plus each broker's topology. When
    the fused pump is live (pumped frames visible in topology), the
    bundled broker metrics must also show nonzero
    ``cdn_pump_stage_seconds`` samples for all four stages; otherwise
    that sub-check skips loudly (never a silent pass on an
    asyncio-demoted host)."""
    record = os.path.join(logdir, "cdn_top_timeline.jsonl")
    bundle_root = os.path.join(logdir, "bundles")
    eps = ",".join(f"{n}=127.0.0.1:{p}" for n, p in metrics_ports.items())
    cmd = [sys.executable, os.path.join(REPO, "scripts", "cdn_top.py"),
           "--endpoints", eps, "--once", "--interval", "1.0",
           "--record", record, "--bundle", bundle_root]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=90)
    except subprocess.TimeoutExpired:
        print("[cluster] FAIL: cdn_top --once --bundle timed out")
        return False
    if proc.returncode != 0:
        print(f"[cluster] FAIL: cdn_top rc={proc.returncode}\n"
              f"{proc.stdout[-1500:]}\n{proc.stderr[-1500:]}")
        return False
    # the rendered pane reached stdout (one line per process at minimum)
    for name in metrics_ports:
        if name not in proc.stdout:
            print(f"[cluster] FAIL: cdn_top pane missing process {name}:\n"
                  f"{proc.stdout[-1500:]}")
            return False
    # recorded timeline: >=1 sample whose headline saw every process up
    try:
        with open(record) as fh:
            samples = [json.loads(ln) for ln in fh if ln.strip()]
    except (OSError, ValueError) as exc:
        print(f"[cluster] FAIL: cdn_top --record unreadable: {exc}")
        return False
    if not samples or samples[-1]["headline"].get("procs_up", 0) \
            != len(metrics_ports):
        print(f"[cluster] FAIL: timeline headline incomplete: "
              f"{samples[-1]['headline'] if samples else 'no samples'}")
        return False
    # bundle: every process's metrics + every broker's topology + manifest
    bundles = sorted(os.path.join(bundle_root, d)
                     for d in os.listdir(bundle_root)
                     if d.startswith("bundle-")) if \
        os.path.isdir(bundle_root) else []
    if not bundles:
        print("[cluster] FAIL: cdn_top --bundle wrote no bundle dir")
        return False
    bdir = bundles[-1]
    missing = [f"{n}.metrics.txt" for n in metrics_ports
               if not os.path.exists(os.path.join(bdir,
                                                  f"{n}.metrics.txt"))]
    missing += [f"{n}.topology.json" for n in broker_ports
                if not os.path.exists(os.path.join(
                    bdir, f"{n}.topology.json"))]
    if not os.path.exists(os.path.join(bdir, "manifest.json")):
        missing.append("manifest.json")
    if missing:
        print(f"[cluster] FAIL: bundle {bdir} missing {missing}")
        return False
    # pump stage telemetry: required exactly when the pump really pumped
    pumped = False
    for name, port in broker_ports.items():
        topo = fetch_topology(port)
        ps = ((topo or {}).get("cutthrough") or {}).get("pump")
        if ps and ps.get("pump_frames", 0) > 0:
            pumped = True
    if pumped:
        stages_seen = set()
        for name in broker_ports:
            with open(os.path.join(bdir, f"{name}.metrics.txt")) as fh:
                text = fh.read()
            for m in re.finditer(
                    r'cdn_pump_stage_seconds_count\{stage="(\w+)"\} '
                    r'(\d+)', text):
                if int(m.group(2)) > 0:
                    stages_seen.add(m.group(1))
        want = {"plan", "submit", "wire", "total"}
        if stages_seen != want:
            print(f"[cluster] FAIL: pump live but bundle shows stage "
                  f"samples only for {sorted(stages_seen)} "
                  f"(want {sorted(want)})")
            return False
        print(f"[cluster] collector OK (bundle {os.path.basename(bdir)}: "
              f"{len(metrics_ports)} metrics + {len(broker_ports)} "
              f"topologies; pump stages all nonzero)")
    else:
        print(f"[cluster] collector OK (bundle {os.path.basename(bdir)}: "
              f"{len(metrics_ports)} metrics + {len(broker_ports)} "
              f"topologies; pump-stage check skipped — pump not engaged "
              f"on this host)")
    return True


def _audit_once(metrics_ports: dict, logdir: str):
    """One ``cdn_top --audit --once`` sweep against the brokers' ledger
    endpoints. Returns ``(rc, output, summary)`` where ``summary`` is the
    machine-readable ``[audit] violations=... unattributed_deficit=...
    attributed_deficit=...`` verdict line."""
    eps = ",".join(f"{n}=127.0.0.1:{p}" for n, p in metrics_ports.items())
    cmd = [sys.executable, os.path.join(REPO, "scripts", "cdn_top.py"),
           "--endpoints", eps, "--audit", "--once",
           "--record", os.path.join(logdir, "audit_timeline.jsonl")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60)
    except subprocess.TimeoutExpired:
        return -1, "cdn_top --audit timed out", ""
    summary = next((ln for ln in proc.stdout.splitlines()
                    if ln.startswith("[audit]")), "")
    return proc.returncode, proc.stdout + proc.stderr, summary


def _audit_until_balanced(metrics_ports: dict, logdir: str, label: str,
                          deadline_s: float = 30.0) -> bool:
    """Re-run the mesh audit until it balances: decision-time link
    counters legitimately lead the receiver's ingress count while frames
    are in flight, so a clean balance is an eventually-quiescent property
    — but one that MUST arrive within the deadline."""
    deadline = time.time() + deadline_s
    while True:
        rc, out, summary = _audit_once(metrics_ports, logdir)
        if rc == 0 and "violations=0" in summary \
                and "unattributed_deficit=0" in summary:
            print(f"[cluster] audit OK ({label}): {summary}")
            return True
        if time.time() >= deadline:
            print(f"[cluster] FAIL: conservation audit ({label}) never "
                  f"balanced (rc={rc}): {summary or '(no verdict line)'}\n"
                  f"{out[-2000:]}")
            return False
        time.sleep(1.0)


def check_audit(metrics_ports: dict, broker_ports: dict,
                logdir: str) -> bool:
    """``--audit`` clean leg: merge every broker's /debug/ledger into one
    cluster balance sheet (scripts/cdn_top.py --audit --once) and require
    zero conservation violations and zero unattributed mesh deficit —
    every frame either reached a terminal fate or is visibly in flight."""
    audit_ports = {k: v for k, v in metrics_ports.items()
                   if k in broker_ports}   # only brokers serve ledgers
    return _audit_until_balanced(audit_ports, logdir, "clean")


def check_audit_chaos(procs, replace_proc, spawn_broker,
                      metrics_ports: dict, broker_ports: dict,
                      logdir: str) -> bool:
    """``--audit`` chaos leg: SIGKILL broker1 mid-stream and prove the
    balance sheet stays honest — every frame the survivor committed
    toward the dead peer shows up as ATTRIBUTED deficit (charged to the
    dead incarnation), never as silent unattributed loss; after the
    respawn, the link-epoch reset returns the mesh to a clean balance."""
    victim = "broker1"
    audit_ports = {k: v for k, v in metrics_ports.items()
                   if k in broker_ports and k != victim}
    proc = _proc_of(procs, victim)
    print(f"[cluster] audit chaos: SIGKILL {victim} mid-stream")
    proc.kill()
    proc.wait(timeout=10)

    ok = True
    # the survivor notices the dead link (EOF => failure-is-removal),
    # drains its queue with counted drop fates, and the merged audit must
    # balance with the dead peer's whole residual attributed to it
    attributed = None
    deadline = time.time() + 30.0
    while True:
        rc, out, summary = _audit_once(audit_ports, logdir)
        m = re.search(r" attributed_deficit=(\d+)", summary)
        if rc == 0 and "violations=0" in summary \
                and "unattributed_deficit=0" in summary and m:
            attributed = int(m.group(1))
            break
        if time.time() >= deadline:
            print(f"[cluster] FAIL: post-kill audit never balanced "
                  f"(rc={rc}): {summary or '(no verdict line)'}\n"
                  f"{out[-2000:]}")
            return False
        time.sleep(1.0)
    if attributed > 0:
        print(f"[cluster] audit chaos: {attributed} undelivered frame(s) "
              f"fully attributed to the dead {victim}")
    else:
        print(f"[cluster] FAIL: {victim}'s link carried no accounted "
              "frames — the attribution leg proved nothing")
        ok = False

    # respawn the victim; the fresh incarnation reuses its canonical
    # identity, so the re-formed link's epoch reset (plus the boot stamp
    # in its first LedgerSync) must converge the mesh back to clean
    replace_proc(victim, spawn_broker(int(victim[-1])))

    def mesh_reformed() -> bool:
        for port in broker_ports.values():
            topo = fetch_topology(port)
            if topo is None or topo.get("num_brokers", 0) != 1:
                return False
        return True

    deadline = time.time() + 60.0
    while time.time() < deadline and not mesh_reformed():
        time.sleep(0.3)
    if not mesh_reformed():
        print(f"[cluster] FAIL: mesh never re-formed after the audit "
              f"chaos {victim} kill")
        return False
    full_ports = {k: v for k, v in metrics_ports.items()
                  if k in broker_ports}
    ok = _audit_until_balanced(full_ports, logdir, "post-respawn") and ok
    return ok


def check_shard_plane(port: int, num_shards: int) -> bool:
    """Sharded broker0: the merged topology must show users spread across
    2+ worker shards and the handoff rings having carried records — the
    proof the cross-shard zero-copy hop ran for real."""
    deadline = time.time() + 15.0
    last = None
    while time.time() < deadline:
        topo = fetch_topology(port)
        if topo is not None:
            last = topo
            shards = topo.get("shards") or {}
            user_shards = {u.get("shard") for u in topo.get("users", [])}
            ring_records = 0
            for stats in shards.values():
                for r in ((stats or {}).get("rings") or {}).get(
                        "in", {}).values():
                    ring_records += r.get("records", 0)
            if len(shards) == num_shards and len(user_shards) >= 2 \
                    and ring_records > 0:
                print(f"[cluster] shard plane OK: {len(shards)} workers, "
                      f"users on shards {sorted(user_shards)}, "
                      f"{ring_records} cross-shard ring records drained")
                return True
        time.sleep(0.3)
    print(f"[cluster] FAIL: shard plane never showed cross-shard traffic "
          f"(last topology: {json.dumps(last)[:600]})")
    return False


def render_merged_topology(broker_ports: dict) -> None:
    """One merged cluster view from every broker's /debug/topology."""
    print("[cluster] ---- merged topology ----")
    for name, port in sorted(broker_ports.items()):
        topo = fetch_topology(port)
        if topo is None:
            print(f"  {name}: <unreachable>")
            continue
        cut = topo.get("cutthrough") or {}
        print(f"  {name} [{topo['identity']}] users={topo['num_users']} "
              f"brokers={topo['num_brokers']} "
              f"interest_v={topo['interest_version']} "
              f"draining={topo['draining']}")
        for p in topo["peers"]:
            print(f"    peer {p['id']}: queue={p['writer_queue_depth']} "
                  f"in-flight={p['bytes_in_flight']}B topics={p['topics']}")
        for u in topo["users"]:
            print(f"    user {u['key']}: topics={u['topics']} "
                  f"queue={u['writer_queue_depth']}")
        if cut:
            print(f"    cut-through: usable={cut.get('usable')} "
                  f"age={cut.get('snapshot_age_s')}s "
                  f"churn-skips={cut.get('churn_guard_skips_left')}")
    print("[cluster] ---- end topology ----")


# readiness stays 503 this long after the last shed (the window the
# --churn check polls; generous so the observation can't race the flip)
SHED_READY_S = 6.0


def check_load_shed(marshal_port: int, broker_ports: dict) -> bool:
    """--churn: force subscribe-rate overload through a real
    broker via the REAL client library and verify the whole shed surface
    — the client's typed ``Error(SHED)``, ``/readyz`` flipping 503 with
    the ``admission`` check failing, the ``load-shed`` flight-recorder
    event, then recovery back to 200 once the storm stops. The churn
    client stays CONNECTED until the flight-recorder check passes (the
    trail lives on its connection's recorder)."""
    import asyncio

    from pushcdn_tpu_torch.bin.common import keypair_from_seed
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.error import Error, ErrorKind
    from pushcdn_tpu_torch.proto.transport.tcp import Tcp

    def admission_failing(body: str) -> bool:
        try:
            doc = json.loads(body)
            return any(name.rsplit(":", 1)[-1] == "admission"
                       and not c["ok"]
                       for name, c in doc.get("checks", {}).items())
        except (ValueError, KeyError, TypeError):
            return False

    async def drive() -> bool:
        client = Client(ClientConfig(
            marshal_endpoint=f"127.0.0.1:{marshal_port}",
            keypair=keypair_from_seed(99),
            protocol=Tcp, subscribed_topics=set()))
        try:
            async with asyncio.timeout(20):
                await client.ensure_initialized()
            shed = False
            for _ in range(60):
                await client.subscribe([1])
                await client.unsubscribe([1])
                try:  # drain any pending shed notice quickly
                    async with asyncio.timeout(0.02):
                        await client.receive_message()
                except (TimeoutError, asyncio.TimeoutError):
                    continue
                except Error as exc:
                    if exc.kind != ErrorKind.SHED:
                        raise
                    shed = True
                    break
            if not shed:
                try:  # notices may still be in flight: one longer read
                    async with asyncio.timeout(3.0):
                        await client.receive_message()
                except (TimeoutError, asyncio.TimeoutError):
                    pass
                except Error as exc:
                    shed = exc.kind == ErrorKind.SHED
            if not shed:
                print("[cluster] FAIL: churn client never received the "
                      "typed Error(shed)")
                return False
            print("[cluster] typed shed Error observed by the client "
                  "(Error kind=shed for over-rate subscribe)")

            shed_broker = None
            deadline = time.time() + SHED_READY_S
            while time.time() < deadline and shed_broker is None:
                for name, port in broker_ports.items():
                    res = http_get(port, "/readyz")
                    if res is not None and res[0] == 503 \
                            and admission_failing(res[1]):
                        shed_broker = (name, port)
                        break
                await asyncio.sleep(0.1)
            if shed_broker is None:
                print("[cluster] FAIL: no broker flipped /readyz on the "
                      "shed")
                return False
            name, port = shed_broker
            print(f"[cluster] load shed observed: {name} /readyz 503 "
                  "(admission check failing)")

            res = http_get(port, "/debug/flightrec?limit=400")
            if res is None or res[0] != 200 or "load-shed" not in res[1]:
                print(f"[cluster] FAIL: {name} /debug/flightrec has no "
                      f"load-shed event ({(res or ('?', ''))[1][:300]})")
                return False
            print(f"[cluster] shed flight-recorder event recorded on "
                  f"{name}")

            deadline = time.time() + SHED_READY_S + 8.0
            while time.time() < deadline:
                res = http_get(port, "/readyz")
                if res is not None and res[0] == 200:
                    print(f"[cluster] load shed recovered: {name} "
                          "/readyz 200 after the storm stopped")
                    return True
                await asyncio.sleep(0.2)
            print(f"[cluster] FAIL: {name} never recovered /readyz 200 "
                  "after the churn stopped")
            return False
        finally:
            client.close()

    return asyncio.run(drive())


def check_replay(marshal_port: int, broker_ports: dict) -> bool:
    """--replay: durable catch-up through REAL processes —
    publish on a retained topic, see one frame live, KILL the subscriber,
    publish more into the ring, then rejoin on a fresh client with
    ``subscribe_from(topic, 1)`` and assert every frame comes back as an
    in-order ``Retained`` run followed by live delivery.

    Retention is broker-local (seqs are per-broker), so the rejoining
    client must land on a broker whose ring is complete: the marshal owns
    placement, so the subscriber and the rejoin client (left unsubscribed
    until it rejoins) are dialled right after the publisher, each with
    fresh seeds until /debug/topology shows co-location with it. The
    replay clients run untraced: a broadcast retained with zero live
    subscribers has no delivery span by design, and the strict
    zero-orphan gate must stay meaningful for the echo traffic."""
    import asyncio

    from pushcdn_tpu_torch.bin.common import keypair_from_seed
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.message import Broadcast, Retained
    from pushcdn_tpu_torch.proto.transport.tcp import Tcp
    from pushcdn_tpu_torch.proto.util import mnemonic

    K = 5
    TOPIC = 1  # the echo client broadcasts on 0; topic 1's ring is ours

    def mk(seed: int) -> Client:
        c = Client(ClientConfig(
            marshal_endpoint=f"127.0.0.1:{marshal_port}",
            keypair=keypair_from_seed(seed), protocol=Tcp,
            subscribed_topics=set()))
        c._sampler.every = 0
        return c

    def home_of(key: bytes):
        wanted = mnemonic(key)
        for name, port in broker_ports.items():
            res = http_get(port, "/debug/topology")
            if res is None or res[0] != 200:
                continue
            try:
                topo = json.loads(res[1])
            except ValueError:
                continue
            if any(u.get("key") == wanted for u in topo.get("users", ())):
                return name
        return None

    async def recv_stream(c: Client, want: int, deadline_s: float):
        out = []
        loop = asyncio.get_running_loop()
        deadline = loop.time() + deadline_s
        while len(out) < want and loop.time() < deadline:
            try:
                async with asyncio.timeout(
                        max(0.05, deadline - loop.time())):
                    msgs = await c.receive_messages()
            except (TimeoutError, asyncio.TimeoutError):
                break
            for m in msgs:
                if isinstance(m, Retained):
                    out.append(("retained", m.seq, bytes(m.payload)))
                elif isinstance(m, Broadcast):
                    out.append(("live", None, bytes(m.message)))
        return out

    def ring_entries(port: int) -> int:
        res = http_get(port, "/metrics")
        if res is None or res[0] != 200:
            return 0
        m = re.search(r'cdn_retention_ring_entries\{topic="%d"\} (\d+)'
                      % TOPIC, res[1])
        return int(m.group(1)) if m else 0

    async def colocated(pub_home, seeds):
        """A connected client on ``pub_home`` (the complete ring), or
        None."""
        for seed in seeds:
            c = mk(seed)
            try:
                async with asyncio.timeout(20):
                    await c.ensure_initialized()
            except (TimeoutError, asyncio.TimeoutError):
                c.close()
                continue
            if pub_home is None or home_of(c.public_key) == pub_home:
                return c
            c.close()
        return None

    async def drive() -> bool:
        pub = mk(96)
        sub = rejoin = None
        try:
            async with asyncio.timeout(20):
                await pub.ensure_initialized()
            # dial the subscriber and the rejoin client (unsubscribed until
            # it rejoins) right after the publisher, each on its broker: the
            # marshal places on the least-loaded broker by the last
            # heartbeats, so fresh seeds land where the first landed until
            # a heartbeat moves the loads, and a dial after the kill can
            # miss the publisher's broker every time
            pub_home = None
            for _ in range(50):
                pub_home = home_of(pub.public_key)
                if pub_home is not None:
                    break
                await asyncio.sleep(0.1)
            sub = await colocated(pub_home, range(97, 110))
            rejoin = await colocated(pub_home, range(110, 123))
            if sub is None or rejoin is None:
                print("[cluster] FAIL: could not co-locate the subscriber "
                      "and the rejoin client with the publisher")
                return False
            await sub.subscribe([TOPIC])
            await asyncio.sleep(0.8)   # the subscription lands
            await pub.send_broadcast_message([TOPIC], b"replay-0")
            first = await recv_stream(sub, 1, 10.0)
            if first != [("live", None, b"replay-0")]:
                print(f"[cluster] FAIL: pre-kill subscriber saw {first!r}")
                return False
            print("[cluster] replay phase 1: live frame delivered, "
                  "killing the subscriber")
            sub.close()
            await asyncio.sleep(0.5)   # the broker reaps the connection
            for i in range(1, K):
                await pub.send_broadcast_message(
                    [TOPIC], f"replay-{i}".encode())
            # the rejoin now follows the publishes at once: wait until the
            # ring holds all K, or a SubscribeFrom could overtake them
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 10.0
            while ring_entries(broker_ports[pub_home]) < K \
                    and loop.time() < deadline:
                await asyncio.sleep(0.05)
            await rejoin.subscribe_from(TOPIC, 1)
            got = await recv_stream(rejoin, K, 15.0)
            want = [("retained", i + 1, f"replay-{i}".encode())
                    for i in range(K)]
            if got != want:
                print(f"[cluster] FAIL: replay stream {got!r} != {want!r}")
                return False
            print(f"[cluster] replay phase 2: {K} retained frames "
                  "replayed in order (seqs 1..%d)" % K)
            await pub.send_broadcast_message([TOPIC], b"replay-live")
            tail = await recv_stream(rejoin, 1, 10.0)
            if tail != [("live", None, b"replay-live")]:
                print(f"[cluster] FAIL: post-replay live frame missing "
                      f"({tail!r})")
                return False
            print("[cluster] replay OK: retained 1..%d then live, "
                  "no gap, no dup" % K)
            return True
        finally:
            for c in (pub, sub, rejoin):
                if c is not None:
                    c.close()

    return asyncio.run(drive())


# ---------------------------------------------------------------------------
# scripted chaos (--chaos): kill real processes mid-run and assert the
# composition invariants — the data plane rides out control-plane loss,
# survivors converge, and every event leaves a flight-recorder trail
# ---------------------------------------------------------------------------


class EchoWatch:
    """Watch the echo client's merged stdout for FRESH lines without
    blocking. Reads the raw fd (the startup loop's buffered reader is
    done by chaos time): anything already pipelined is drained first, so
    a match proves the data plane worked AFTER the chaos event."""

    def __init__(self, proc: subprocess.Popen):
        self.proc = proc
        self.fd = proc.stdout.fileno()

    def _read_chunk(self) -> str:
        import select
        r, _, _ = select.select([self.fd], [], [], 0.25)
        if not r:
            return ""
        try:
            chunk = os.read(self.fd, 65536)
        except OSError:
            return ""
        return chunk.decode(errors="replace")

    def drain(self, settle_s: float = 0.3) -> None:
        deadline = time.time() + settle_s
        while time.time() < deadline:
            self._read_chunk()

    def wait_fresh(self, needle: str, wait_s: float) -> bool:
        buf = ""
        deadline = time.time() + wait_s
        while time.time() < deadline:
            if self.proc.poll() is not None:
                print("[chaos] FAIL: echo client process died")
                return False
            buf += self._read_chunk()
            if needle in buf:
                return True
        return False


def try_connect(marshal_port: int, seed: int, timeout_s: float) -> bool:
    """One in-process client connect attempt through the real marshal —
    the probe for 'can NEW work be admitted right now?'."""
    import asyncio

    from pushcdn_tpu_torch.bin.common import keypair_from_seed
    from pushcdn_tpu_torch.client import Client, ClientConfig
    from pushcdn_tpu_torch.proto.transport.tcp import Tcp

    async def drive() -> bool:
        client = Client(ClientConfig(
            marshal_endpoint=f"127.0.0.1:{marshal_port}",
            keypair=keypair_from_seed(seed),
            protocol=Tcp, subscribed_topics=set()))
        try:
            async with asyncio.timeout(timeout_s):
                await client.ensure_initialized()
            return True
        except Exception:
            return False
        finally:
            client.close()

    return asyncio.run(drive())


def _log_gained(path: str, offset: int, needle: str, wait_s: float) -> bool:
    """True once ``needle`` appears in ``path`` PAST ``offset`` — the
    flight-recorder correlation check (dumps land in the survivor's log
    after the event, never before it)."""
    deadline = time.time() + wait_s
    while time.time() < deadline:
        try:
            with open(path, errors="replace") as fh:
                fh.seek(offset)
                if needle in fh.read():
                    return True
        except OSError:
            pass
        time.sleep(0.3)
    return False


def _log_size(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


def check_chaos(procs: list, replace_proc, spawn_broker, spawn_marshal,
                watch: "EchoWatch", broker_ports: dict, metrics_ports: dict,
                marshal_port: int, db: str, logdir: str, shards: int,
                events=("broker", "marshal", "discovery")) -> bool:
    """Scripted chaos events against the live cluster, each asserted
    against its composition invariant:

    1. **broker SIGKILL** (or, with ``--shards``, SIGKILL of one shard
       *worker*, which fail-fasts the whole sharded box): the elastic
       client re-load-balances through the marshal and echoes again; the
       surviving broker's flight recorder dumps the abnormal peer
       disconnect; the victim respawns and the mesh re-forms.
    2. **marshal loss**: NEW admissions fail, but the established data
       plane keeps echoing (control/data decoupling); the respawned
       marshal admits again.
    3. **discovery outage**: the store's write lock is held hostage, so
       permit minting (and heartbeats) fail — new admissions are refused
       while the outage lasts, heartbeat failures land in the process
       flight recorder (``task-died heartbeat``), and everything recovers
       on release. (The embedded store's writes are synchronous, so
       in-flight echoes can stall with it — the invariant asserted is
       refuse-then-recover, not zero-jitter.)
    """
    ok = True
    if "broker" in events:
        ok = _chaos_broker_kill(procs, replace_proc, spawn_broker, watch,
                                broker_ports, metrics_ports, logdir,
                                shards) and ok
    if "marshal" in events:
        ok = _chaos_marshal_loss(procs, replace_proc, spawn_marshal, watch,
                                 marshal_port) and ok
    if "discovery" in events:
        ok = _chaos_discovery_outage(watch, broker_ports, marshal_port,
                                     db) and ok
    if ok:
        print("[chaos] OK: all chaos events rode out with invariants held")
    return ok


def _proc_of(procs: list, name: str) -> subprocess.Popen:
    return next(p for n, p in procs if n == name)


def _chaos_broker_kill(procs, replace_proc, spawn_broker,
                       watch: "EchoWatch", broker_ports: dict,
                       metrics_ports: dict, logdir: str,
                       shards: int) -> bool:
    ok = True
    if shards > 1:
        victim = "broker0"
        topo = fetch_topology(metrics_ports[victim])
        worker = ((topo or {}).get("shards") or {}).get("1") or {}
        pid = worker.get("pid")
        if not pid:
            print("[chaos] FAIL: no shard-worker pid in broker0 topology")
            return False
        survivor = "broker1"
        surv_log0 = _log_size(os.path.join(logdir, f"{survivor}.log"))
        print(f"[chaos] SIGKILL shard-1 worker (pid {pid}) of {victim}")
        os.kill(pid, signal.SIGKILL)
        # fail-fast supervisor: ANY dead worker takes the whole box down
        proc = _proc_of(procs, victim)
        deadline = time.time() + 20.0
        while time.time() < deadline and proc.poll() is None:
            time.sleep(0.1)
        if proc.poll() is None:
            print("[chaos] FAIL: sharded broker0 survived a dead worker "
                  "(fail-fast supervisor broken)")
            ok = False
    else:
        # kill whichever broker is serving the echo client — the sharpest
        # version of the event (the reconnect path MUST run)
        users = {}
        for name, port in broker_ports.items():
            topo = fetch_topology(port)
            users[name] = (topo or {}).get("num_users", 0)
        victim = max(users, key=lambda n: users[n])
        survivor = next(n for n in broker_ports if n != victim)
        surv_log0 = _log_size(os.path.join(logdir, f"{survivor}.log"))
        print(f"[chaos] SIGKILL {victim} (serving {users[victim]} user(s))")
        watch.drain()
        proc = _proc_of(procs, victim)
        proc.kill()
        proc.wait(timeout=10)

    watch.drain()
    if not watch.wait_fresh("recv direct", 45.0):
        print(f"[chaos] FAIL: client never echoed again after {victim} "
              "was killed")
        ok = False
    else:
        print(f"[chaos] echo resumed after {victim} kill (client "
              "re-load-balanced through the marshal)")
    # a SIGKILLed peer reads as a clean FIN on the survivor (failure-is-
    # removal, sender.rs semantics): the correlation trail is the removal
    # diagnostic ("broker X removed (...); forgot N routed users"), which
    # the connection's flight recorder also carries as a "removed" event
    if not _log_gained(os.path.join(logdir, f"{survivor}.log"), surv_log0,
                       "; forgot", 20.0):
        print(f"[chaos] FAIL: {survivor} never logged the dead peer's "
              "removal")
        ok = False
    else:
        print(f"[chaos] peer-loss correlation: {survivor} recorded the "
              "dead peer's removal")

    # respawn the victim and wait for the mesh to re-form
    idx = int(victim[-1])
    replace_proc(victim, spawn_broker(idx))

    def mesh_reformed() -> bool:
        for port in broker_ports.values():
            topo = fetch_topology(port)
            if topo is None or topo.get("num_brokers", 0) != 1:
                return False
        return True

    deadline = time.time() + 60.0
    while time.time() < deadline and not mesh_reformed():
        time.sleep(0.3)
    if not mesh_reformed():
        print(f"[chaos] FAIL: mesh never re-formed after {victim} respawn")
        ok = False
    else:
        print(f"[chaos] mesh re-formed after {victim} respawn")
    return ok


def _chaos_marshal_loss(procs, replace_proc, spawn_marshal,
                        watch: "EchoWatch", marshal_port: int) -> bool:
    ok = True
    print("[chaos] SIGKILL marshal")
    proc = _proc_of(procs, "marshal")
    proc.kill()
    proc.wait(timeout=10)
    if try_connect(marshal_port, seed=201, timeout_s=4.0):
        print("[chaos] FAIL: a new client connected with the marshal dead")
        ok = False
    else:
        print("[chaos] new admissions refused while the marshal is down")
    watch.drain()
    if not watch.wait_fresh("recv direct", 20.0):
        print("[chaos] FAIL: established data plane stalled during "
              "marshal loss")
        ok = False
    else:
        print("[chaos] established data plane kept echoing through "
              "marshal loss")
    replace_proc("marshal", spawn_marshal())
    if not try_connect(marshal_port, seed=202, timeout_s=25.0):
        print("[chaos] FAIL: new client could not connect after the "
              "marshal respawn")
        ok = False
    else:
        print("[chaos] marshal respawned; new admissions flow again")
    return ok


def _chaos_discovery_outage(watch: "EchoWatch", broker_ports: dict,
                            marshal_port: int, db: str) -> bool:
    import sqlite3

    ok = True
    print("[chaos] discovery outage: holding the store's write lock")
    lock = sqlite3.connect(db, isolation_level=None)
    try:
        lock.execute("PRAGMA busy_timeout=1000")
        lock.execute("BEGIN IMMEDIATE")
        outage_t0 = time.time()
        if try_connect(marshal_port, seed=203, timeout_s=4.0):
            print("[chaos] FAIL: a new client was admitted during the "
                  "discovery outage (permit mint should have failed)")
            ok = False
        else:
            print("[chaos] new admissions refused during the discovery "
                  "outage")
        # hold the lock PAST the store's 5 s busy timeout so at least one
        # broker heartbeat actually fails (a shorter outage just delays
        # the write, and the failure trail would never exist)
        remaining = 8.0 - (time.time() - outage_t0)
        if remaining > 0:
            time.sleep(remaining)
    finally:
        try:
            lock.rollback()
        finally:
            lock.close()
    if not try_connect(marshal_port, seed=204, timeout_s=25.0):
        print("[chaos] FAIL: admissions never recovered after the "
              "discovery outage")
        ok = False
    else:
        print("[chaos] admissions recovered after the discovery outage")
    watch.drain()
    if not watch.wait_fresh("recv direct", 20.0):
        print("[chaos] FAIL: echo never resumed after the discovery outage")
        ok = False
    # heartbeat failures during the outage are supervised-task deaths —
    # the correlation trail lives in the brokers' process flight recorder
    flightrec_seen = False
    deadline = time.time() + 10.0
    while time.time() < deadline and not flightrec_seen:
        for port in broker_ports.values():
            res = http_get(port, "/debug/flightrec?limit=400")
            if res is not None and res[0] == 200 \
                    and "task-died" in res[1] and "heartbeat" in res[1]:
                flightrec_seen = True
                break
        time.sleep(0.3)
    if not flightrec_seen:
        print("[chaos] FAIL: no broker recorded the heartbeat failure in "
              "its flight recorder during the outage")
        ok = False
    else:
        print("[chaos] flight-recorder correlation: heartbeat task-died "
              "event recorded during the outage")
    return ok


def check_rehome(broker_ports: dict, watch: "EchoWatch") -> bool:
    """Operator-triggered elastic drain against REAL brokers.
    ``GET /drain`` on the broker homing the echo client must actively
    re-home every user (typed Migrate frames, make-before-break): the
    user count moves to the surviving broker, the drained broker latches
    /readyz 503 ``draining`` while still serving, and the echo keeps
    flowing on the new home."""
    homes = {}
    for name, port in broker_ports.items():
        topo = fetch_topology(port)
        if topo is None:
            print(f"[cluster] FAIL: {name} topology unreachable pre-rehome")
            return False
        homes[name] = topo["num_users"]
    target = max(homes, key=lambda n: homes[n])
    if homes[target] == 0:
        print("[cluster] FAIL: no broker homes any user pre-rehome")
        return False
    survivor = next(n for n in broker_ports if n != target)
    users_moving = homes[target]
    watch.drain()
    res = http_get(broker_ports[target], "/drain", timeout=30.0)
    if res is None or res[0] != 200:
        print(f"[cluster] FAIL: {target} /drain did not answer: {res}")
        return False
    try:
        summary = json.loads(res[1])
    except ValueError:
        print(f"[cluster] FAIL: /drain body unparseable: {res[1][:200]}")
        return False
    print(f"[cluster] rehome drain summary from {target}: {summary}")
    if summary.get("signaled", 0) < users_moving or summary.get("orphaned"):
        print("[cluster] FAIL: drain signaled too few users or left "
              "orphans")
        return False
    deadline = time.time() + 20.0
    moved = False
    while time.time() < deadline:
        t_old = fetch_topology(broker_ports[target])
        t_new = fetch_topology(broker_ports[survivor])
        if t_old and t_new and t_old["num_users"] == 0 \
                and t_new["num_users"] >= homes[survivor] + users_moving:
            moved = True
            break
        time.sleep(0.2)
    if not moved:
        print(f"[cluster] FAIL: users never moved {target} -> {survivor}")
        return False
    res = http_get(broker_ports[target], "/readyz")
    if res is None or res[0] != 503:
        print(f"[cluster] FAIL: drained {target} still reports ready: {res}")
        return False
    # the data plane survived the migration: a FRESH direct echo arrives
    # through the new home (the client re-homed without a marshal trip)
    if not watch.wait_fresh("recv direct", 15.0):
        print("[cluster] FAIL: echo stalled after re-home")
        return False
    print(f"[cluster] rehome OK: {users_moving} user(s) re-homed "
          f"{target} -> {survivor}, echo alive on the new home")
    return True


def check_drain(name: str, proc: subprocess.Popen, port: int) -> bool:
    """SIGINT the process and verify /readyz flips to 503 (draining)
    BEFORE the listeners close — the process keeps answering through the
    drain grace window."""
    proc.send_signal(signal.SIGINT)
    deadline = time.time() + DRAIN_GRACE_S + 3.0
    while time.time() < deadline:
        res = http_get(port, "/readyz", timeout=0.5)
        if res is None:
            if proc.poll() is not None:
                print(f"[cluster] FAIL: {name} exited before its drain "
                      "readiness flip was observable")
                return False
            time.sleep(0.05)
            continue
        status, body = res
        drain_latched = False
        if status == 503:
            try:
                drain_latched = json.loads(body)["draining"] is True
            except (ValueError, KeyError):
                drain_latched = False
        if drain_latched:
            print(f"[cluster] drain readiness flip observed on {name} "
                  "(503 draining while still serving)")
            proc.wait(timeout=DRAIN_GRACE_S + 10)
            return True
        time.sleep(0.05)
    print(f"[cluster] FAIL: {name} never reported draining on /readyz")
    return False


def run_trace_report(trace_dir: str, wait_s: float = 10.0) -> bool:
    """The CI gate: merge the span logs and require per-hop stats for at
    least one complete chain with zero orphans (retried briefly — the
    broker's last spans land moments after the client prints its echo)."""
    script = os.path.join(REPO, "scripts", "trace_report.py")
    deadline = time.time() + wait_s
    proc = None
    while True:
        proc = subprocess.run(
            [sys.executable, script, "--strict", "--json", trace_dir],
            capture_output=True, text=True, timeout=60)
        if proc.returncode == 0 or time.time() >= deadline:
            break
        time.sleep(0.3)
    if proc.returncode != 0:
        print(f"[cluster] FAIL: trace_report strict gate:\n"
              f"{proc.stdout[-1500:]}\n{proc.stderr[-500:]}")
        return False
    report = json.loads(proc.stdout)
    hops = report["per_hop"]
    print(f"[cluster] trace report OK: {report['complete_chains']} complete "
          f"chain(s), {report['orphaned_spans']} orphaned spans; "
          "per-hop p50/p99 ms: "
          + " ".join(f"{hop}={s['p50_ms']}/{s['p99_ms']}"
                     for hop, s in hops.items()))
    return True


def check_trace_chain(trace_dir: str, wait_s: float = 5.0) -> bool:
    """Assemble the per-process JSONL span logs and verify at least one
    trace id produced the COMPLETE lifecycle chain: auth (marshal) +
    publish → ingress → plan → egress (broker) → delivery (client).
    Retries briefly: the broker's egress span lands microseconds after
    the client prints its echo, and we read the files right then."""
    import glob
    import json as json_mod
    need = {"auth", "publish", "ingress", "plan", "egress", "delivery"}
    deadline = time.time() + wait_s
    hops_by_id: dict = {}
    while True:
        hops_by_id = {}
        for path in glob.glob(os.path.join(trace_dir, "*.jsonl")):
            with open(path) as fh:
                for line in fh:
                    try:
                        rec = json_mod.loads(line)
                    except ValueError:
                        continue
                    hops_by_id.setdefault(rec["trace_id"],
                                          set()).add(rec["hop"])
        for tid, hops in hops_by_id.items():
            if need <= hops:
                print(f"[cluster] trace chain complete: id={tid:x} "
                      f"hops={sorted(hops)}")
                return True
        if time.time() >= deadline:
            break
        time.sleep(0.2)
    print(f"[cluster] FAIL: no complete trace chain "
          f"(saw {[(hex(t), sorted(h)) for t, h in hops_by_id.items()]})")
    return False


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--base-port", type=int, default=21700,
                    help="0 picks a free contiguous range (CI runs that "
                         "must not collide with other suites)")
    ap.add_argument("--device-plane", action="store_true",
                    help="brokers route eligible traffic through their "
                         "device plane (single-shard planes, on --device)")
    ap.add_argument("--device", default=None,
                    help="the planes' torch device, forwarded to every "
                         "broker with --device-plane (default: the broker "
                         "binary's, CUDA; pass cpu for the plain PyTorch "
                         "step on the CPU)")
    ap.add_argument("--topology", action="store_true",
                    help="render one merged cluster view from every "
                         "broker's /debug/topology once the mesh is up")
    ap.add_argument("--trace-log", metavar="DIR", default=None,
                    help="write per-process lifecycle-trace span JSONL "
                         "under DIR, verify one complete span chain, and "
                         "run scripts/trace_report.py --strict over it")
    ap.add_argument("--churn", action="store_true",
                    help="force subscribe-rate overload: brokers "
                         "run with a tiny PUSHCDN_SUBSCRIBE_RATE, a churn "
                         "client drives an over-rate storm, and the run "
                         "verifies the typed shed Error, the /readyz "
                         "admission flip + flight-recorder event, and "
                         "recovery")
    ap.add_argument("--replay", action="store_true",
                    help="durable-topics check: brokers retain "
                         "topic 1; publish, kill the subscriber, rejoin "
                         "with subscribe_from and assert the in-order "
                         "Retained catch-up + live handover")
    ap.add_argument("--rehome", action="store_true",
                    help="elastic drain: GET /drain on the "
                         "broker homing the echo client, verify every "
                         "user is actively re-homed to the survivor via "
                         "typed Migrate frames (topology moves, drained "
                         "broker latches 503 draining, echo keeps "
                         "flowing on the new home)")
    ap.add_argument("--shards", type=int, default=1,
                    help="run broker0 with a sharded data plane (N worker "
                         "processes); spawns a second client so directs "
                         "cross the shard boundary, and asserts the "
                         "handoff rings carried them")
    ap.add_argument("--collector", action="store_true",
                    help="drive scripts/cdn_top.py --once --record "
                         "--bundle against the live cluster and verify "
                         "the pane, timeline, and postmortem bundle")
    ap.add_argument("--audit", action="store_true",
                    help="drive scripts/cdn_top.py --audit --once against "
                         "the live mesh: clean leg requires "
                         "zero conservation violations and zero "
                         "unattributed deficit; a broker-SIGKILL chaos "
                         "leg requires the dead peer's undelivered frames "
                         "fully attributed, then a clean balance again "
                         "after the respawn (forces the scalar data "
                         "plane: PUSHCDN_PUMP=off)")
    ap.add_argument("--chaos", action="store_true",
                    help="scripted chaos events after the baseline checks: "
                         "broker SIGKILL (a shard-worker kill under "
                         "--shards), marshal loss, and a discovery outage "
                         "— each asserted against its composition "
                         "invariant and correlated in the flight recorder")
    ap.add_argument("--io-impl", choices=("auto", "uring", "asyncio"),
                    default=None,
                    help="host I/O engine for every spawned component "
                         "(exported as PUSHCDN_IO_IMPL; auto demotes to "
                         "asyncio with a warning when the kernel denies "
                         "io_uring)")
    ap.add_argument("--pump", choices=("auto", "off"), default=None,
                    help="fused native data-plane pump for every broker "
                         "(exported as PUSHCDN_PUMP; auto engages when "
                         "io_uring + the native planner are both live, "
                         "with an honest skip otherwise)")
    ap.add_argument("--chaos-events", default="broker,marshal,discovery",
                    metavar="LIST",
                    help="comma-separated subset of chaos events to run "
                         "(broker, marshal, discovery); the CI smoke tier "
                         "runs one event to stay fast")
    args = ap.parse_args()

    if args.io_impl:
        # every spawned component inherits the selection (and a --shards
        # broker's workers inherit it transitively)
        os.environ["PUSHCDN_IO_IMPL"] = args.io_impl
        print(f"[cluster] io-impl: {args.io_impl}")

    if args.pump:
        os.environ["PUSHCDN_PUMP"] = args.pump
        print(f"[cluster] pump: {args.pump}")

    if args.audit:
        # pumped frames move below the Python per-link tables (the C
        # counters are fd-keyed, not peer-identity-resolvable yet), so
        # the conservation audit legs pin the scalar data plane
        os.environ["PUSHCDN_PUMP"] = "off"
        if args.pump == "auto":
            print("[cluster] --audit overrides --pump auto: per-link "
                  "ledger tables are scalar-plane only")

    if args.trace_log:
        os.makedirs(args.trace_log, exist_ok=True)

    def trace_env(name: str):
        if not args.trace_log:
            return {}
        return {"PUSHCDN_TRACE_LOG":
                os.path.join(args.trace_log, f"{name}.jsonl")}

    logdir = tempfile.mkdtemp(prefix="pushcdn-cluster-")
    db = os.path.join(logdir, "cdn.sqlite")
    bp = args.base_port
    if bp == 0:
        # pick the range BELOW the kernel's ephemeral floor: a listener
        # inside the ephemeral range races the outgoing-port allocator
        # (EADDRINUSE even with SO_REUSEADDR while a live connection —
        # ours or another suite's — holds the port locally). Below the
        # floor the kernel never hands the ports out, so only another
        # explicit listener can collide; probe every offset the cluster
        # derives (broker pub/priv, marshal, metrics blocks incl.
        # per-shard worker endpoints at parent + 1 + shard) and redraw.
        import random
        import socket
        try:
            with open("/proc/sys/net/ipv4/ip_local_port_range") as fh:
                eph_lo = int(fh.read().split()[0])
        except (OSError, ValueError, IndexError):
            eph_lo = 32768
        hi = max(10_001, min(eph_lo, 65_000) - 200)
        offsets = [*range(0, 4), 50, *range(100, 143)]
        while True:
            candidate = random.randrange(10_000, hi)
            try:
                for off in offsets:
                    with socket.socket() as s:
                        s.setsockopt(socket.SOL_SOCKET,
                                     socket.SO_REUSEADDR, 1)
                        s.bind(("127.0.0.1", candidate + off))
            except OSError:
                continue
            bp = candidate
            break
    # metrics layout: each broker parent gets a 20-port block so its
    # per-shard worker endpoints (parent + 1 + shard) never collide with
    # the next component even when both brokers spawn workers
    metrics_ports = {"broker0": bp + 100, "broker1": bp + 120,
                     "marshal": bp + 140, "client": bp + 141}
    broker_ports = {"broker0": bp + 100, "broker1": bp + 120}
    if args.shards > 1:
        metrics_ports["client2"] = bp + 142
    procs: list[tuple[str, subprocess.Popen]] = []

    def replace_proc(name: str, proc: subprocess.Popen) -> None:
        for idx, (n, _p) in enumerate(procs):
            if n == name:
                procs[idx] = (name, proc)
                return
        procs.append((name, proc))

    def spawn_broker(i: int, first_boot: bool = False) -> subprocess.Popen:
        env = {**trace_env(f"broker{i}"),
               "PUSHCDN_DRAIN_GRACE_S": str(DRAIN_GRACE_S)}
        if args.replay:
            env["PUSHCDN_RETAIN_TOPICS"] = "1"
        if args.churn:
            # tiny per-connection subscribe budget so the churn driver
            # forces shedding quickly; the ready window is generous so
            # the /readyz flip is externally observable
            env.update({"PUSHCDN_SUBSCRIBE_RATE": "2",
                        "PUSHCDN_SUBSCRIBE_BURST": "3",
                        "PUSHCDN_SHED_READY_S": str(SHED_READY_S)})
        shard_flags = []
        if i == 0:
            if first_boot:
                # hold broker0's listener binds open so the not-ready-
                # before-bind state is externally observable (a chaos
                # respawn skips the delay: nothing observes it then)
                env["PUSHCDN_BIND_DELAY_S"] = "1.5"
            if args.shards > 1:
                shard_flags = ["--shards", str(args.shards)]
                # deterministic round-robin accept distribution: the
                # two clients land on DIFFERENT workers, so their
                # directs must cross the shard boundary (this also
                # CI-covers the fd-handoff accept path; SO_REUSEPORT
                # is covered by benches/route_bench.py --shards)
                env["PUSHCDN_SHARD_ACCEPT"] = "handoff"
        chaos_flags = []
        if args.chaos:
            # a SIGKILLed broker must age out of placement fast, or the
            # marshal keeps handing its dead endpoint to the reconnecting
            # client for the full 60 s reference TTL
            chaos_flags = ["--heartbeat-interval", "1",
                           "--membership-ttl", "5"]
        audit_flags = []
        if args.audit:
            # fast anti-entropy so LedgerSync balance sheets (and, after
            # the chaos-leg respawn, the fresh incarnation's boot epoch)
            # propagate inside the audit deadlines; the SIGKILL leg also
            # needs the dead broker aged out of placement quickly
            audit_flags = ["--sync-interval", "2",
                           "--heartbeat-interval", "1",
                           "--membership-ttl", "5"]
        plane_flags = []
        if args.device_plane:
            plane_flags = ["--device-plane"]
            if args.device:
                plane_flags += ["--device", args.device]
        return spawn(
            "broker",
            "--discovery-endpoint", db,
            "--public-advertise-endpoint", f"127.0.0.1:{bp + i * 2}",
            "--public-bind-endpoint", f"127.0.0.1:{bp + i * 2}",
            "--private-advertise-endpoint", f"127.0.0.1:{bp + i * 2 + 1}",
            "--private-bind-endpoint", f"127.0.0.1:{bp + i * 2 + 1}",
            "--user-transport", "tcp",   # plain tcp for the local demo
            "--metrics-bind-endpoint",
            f"127.0.0.1:{metrics_ports[f'broker{i}']}",
            *shard_flags, *chaos_flags, *audit_flags,
            *plane_flags,
            env_extra=env,
            log_path=os.path.join(logdir, f"broker{i}.log"))

    def spawn_marshal() -> subprocess.Popen:
        return spawn(
            "marshal",
            "--discovery-endpoint", db,
            "--bind-endpoint", f"127.0.0.1:{bp + 50}",
            "--metrics-bind-endpoint",
            f"127.0.0.1:{metrics_ports['marshal']}",
            "--user-transport", "tcp",
            env_extra=trace_env("marshal"),
            log_path=os.path.join(logdir, "marshal.log"))

    ok = True
    # chaos mode heartbeats every 1 s, so the marshal's load view is FRESH
    # and it correctly balances client2 onto broker1 — which starves the
    # sharded cross-shard check (it needs both clients on broker0). Spawn
    # broker1 only after both clients are placed: with one broker alive
    # the marshal has no choice, and co-location is deterministic instead
    # of an artifact of stale 10 s load reports.
    late_broker1 = args.chaos and args.shards > 1
    try:
        for i in range(1 if late_broker1 else 2):
            procs.append((f"broker{i}", spawn_broker(i, first_boot=True)))
            if i == 0:
                ok = check_readiness_before_bind(
                    metrics_ports["broker0"], args.device_plane,
                    alive=lambda p=procs[-1][1]: p.poll() is None) and ok
        time.sleep(1.5)  # brokers register + mesh up
        procs.append(("marshal", spawn_marshal()))
        time.sleep(1.0)
        procs.append(("client", spawn(
            "client",
            "--marshal-endpoint", f"127.0.0.1:{bp + 50}",
            "--transport", "tcp",
            "--interval", "1.0", "--key-seed", "7",
            "--metrics-bind-endpoint", f"127.0.0.1:{metrics_ports['client']}",
            env_extra=trace_env("client"))))
        if args.shards > 1:
            time.sleep(1.0)  # client 1 accepts first -> worker 0
            procs.append(("client2", spawn(
                "client",
                "--marshal-endpoint", f"127.0.0.1:{bp + 50}",
                "--transport", "tcp",
                "--interval", "1.0", "--key-seed", "8",
                "--direct-to-seed", "7",  # cross-shard directs to client 1
                "--metrics-bind-endpoint",
                f"127.0.0.1:{metrics_ports['client2']}",
                env_extra=trace_env("client2"))))
        if late_broker1:
            time.sleep(1.0)  # both clients placed on broker0 first
            procs.append(("broker1", spawn_broker(1, first_boot=True)))
            # mesh forms within ~1 s (chaos heartbeat); check_topology polls

        deadline = time.time() + args.duration
        echoed = False
        client = next(p for n, p in procs if n == "client")
        others = [(n, p) for n, p in procs if n != "client"]
        while time.time() < deadline:
            for name, proc in others:
                if proc.poll() is not None:
                    print(f"[cluster] FAIL: {name} died early")
                    if proc.stdout is not None:
                        print(proc.stdout.read()[-2000:])
                    else:
                        log = os.path.join(logdir, f"{name}.log")
                        if os.path.exists(log):
                            with open(log, errors="replace") as f:
                                print(f.read()[-2000:])
                    return 1
            line = client.stdout.readline()
            if line:
                sys.stdout.write(f"[client] {line}")
                if "recv direct" in line:
                    echoed = True
                    break
        if not echoed:
            print("[cluster] FAIL: client never echoed")
            return 1

        # ---- observability plane checks ----
        ok = check_health(metrics_ports) and ok
        ok = check_topology(broker_ports,
                            expected_users=2 if args.shards > 1 else 1) \
            and ok
        if args.pump == "auto":
            # ---- fused data-plane pump: engaged with real
            # pumped frames on a capable kernel, honest skip otherwise
            ok = check_pump(broker_ports) and ok
        if args.rehome:
            # ---- elastic membership: operator /drain actively
            # re-homes the echo client to the surviving broker; runs
            # BEFORE the trace checks so trace_report --strict also
            # covers post-migration delivery chains
            ok = check_rehome(broker_ports, EchoWatch(client)) and ok
        if args.replay:
            # ---- durable topics: retained ring replay +
            # live handover through real processes; BEFORE the trace
            # checks so --strict also covers chains delivered alongside
            ok = check_replay(bp + 50, broker_ports) and ok
        if args.collector:
            # ---- one-pane collector: cdn_top --once --bundle
            # over every live endpoint, with the timeline + bundle +
            # pump-stage-telemetry assertions
            ok = check_collector(metrics_ports, broker_ports, logdir) \
                and ok
        if args.audit:
            # ---- conservation audit, clean leg: the live
            # mesh must merge to zero violations and zero unattributed
            # deficit in cdn_top --audit --once
            ok = check_audit(metrics_ports, broker_ports, logdir) and ok
        if args.shards > 1:
            # ---- sharded data plane: users on 2+ workers and
            # cross-shard directs carried by the handoff rings
            ok = check_shard_plane(metrics_ports["broker0"],
                                   args.shards) and ok
        if args.churn:
            # ---- admission control: forced overload sheds,
            # surfaces typed + /readyz + flightrec, then recovers
            ok = check_load_shed(bp + 50, broker_ports) and ok
        if args.topology:
            render_merged_topology(broker_ports)
        if args.trace_log:
            ok = check_trace_chain(args.trace_log) and ok
            ok = run_trace_report(args.trace_log) and ok
        if args.chaos:
            # ---- scripted chaos: broker SIGKILL / marshal
            # loss / discovery outage, each with its invariant + flight-
            # recorder correlation; runs LAST before drain because it
            # respawns processes the earlier checks assume stable
            ok = check_chaos(procs, replace_proc, spawn_broker,
                             spawn_marshal, EchoWatch(client),
                             broker_ports, metrics_ports, bp + 50,
                             db, logdir, args.shards,
                             events=tuple(
                                 e.strip() for e in
                                 args.chaos_events.split(",") if e.strip()
                             )) and ok
        if args.audit:
            # ---- conservation audit, chaos leg: SIGKILL
            # broker1, require its undelivered frames fully attributed,
            # respawn, require a clean balance again; runs after the
            # other checks because it kills a process they assume stable
            ok = check_audit_chaos(procs, replace_proc, spawn_broker,
                                   metrics_ports, broker_ports, logdir) \
                and ok
        # drain LAST: SIGINT broker1 and watch readiness flip before its
        # listeners close (the client may briefly reconnect after; every
        # earlier check has already run)
        broker1 = next(p for n, p in procs if n == "broker1")
        ok = check_drain("broker1", broker1, metrics_ports["broker1"]) and ok

        if not ok:
            return 1
        print("[cluster] OK: end-to-end echo through real processes")
        return 0
    finally:
        for _name, proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
        # brokers drain for DRAIN_GRACE_S before exiting — give the grace
        # window (plus margin) before escalating, or the "clean shutdown"
        # is actually a SIGKILL mid-drain
        deadline = time.time() + DRAIN_GRACE_S + 2.0
        while time.time() < deadline and any(
                proc.poll() is None for _name, proc in procs):
            time.sleep(0.1)
        for _name, proc in procs:
            if proc.poll() is None:
                proc.kill()


if __name__ == "__main__":
    sys.exit(main())
