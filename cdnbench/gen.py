"""One load-generator process: a share of the deployment's users as the
program's own ``Client``s over its user transport, each with a key drawn
from the seed, subscribed to its topics from the seed.

    python -m cdnbench.gen <spec.json>

The spec names the cell, the seed, the run's directory, the marshal and
the users this process holds. The process talks to the harness in JSON
lines on stdout and words on stdin:

- it draws every user's key and topics, prints ``keys``, and waits for
  ``connect``;
- it connects its users through the marshal and prints ``ready``;
- on ``go <t0_ns> <t_end_ns>`` (CLOCK_MONOTONIC, which every process of
  the host shares) the traffic's ``drive`` runs, and a ``stats`` line
  counts what was sent and received every half second;
- on ``finish`` it stops, writes every send and every delivery to
  ``gen-<index>.npz`` in the run's directory, prints ``done`` and exits.

Every delivery is recorded with the time it arrived and the time its
payload says it is timed from; every send with its publisher, sequence,
target or topics and times. The traffic module's ``on_message`` sees each
delivery of the types it names, for closed loops that answer messages.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import threading
import time
from array import array

from cdnbench import common, traffic
from cdnbench.traffic import CORRUPT, SEQ_BITS, payload, read


def emit(event: str, **fields) -> None:
    print(json.dumps({"event": event, **fields}), flush=True)


def now_ns() -> int:
    return time.monotonic_ns()


class Gen:
    """The state a traffic module drives: clients, keys, topics, and the
    send and delivery records."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.cfg = common.config(spec["config"])
        self.wl = common.workload(spec["cell"])
        self.seed = int(spec["seed"])
        self.seconds = float(spec["seconds"])
        self.index = int(spec["index"])
        self.uids = range(spec["uid_lo"], spec["uid_hi"])
        self.kind = traffic.kind(self.wl["kind"])
        self.t0 = self.t_end = 0
        self.clients = {}
        self.keys = []
        self.topics = []
        self.seq = {}
        self.errors = 0
        self.others = 0
        self.stopping = False
        # deliveries: code, arrival ns, ref ns
        self.r_code, self.r_ns, self.r_ref = array("q"), array("q"), array("q")
        # sends: publisher, seq, type, target uid (-1 broadcast), topics
        # (-1 none), ref ns, send ns
        self.s = {k: array("q") for k in ("pub", "seq", "mtype", "target",
                                          "t0", "t1", "ref", "ns")}
        self.extra = {}   # the traffic's own arrays for the oracle
        self.hook_types = frozenset(getattr(self.kind, "HOOK_TYPES", ()))
        self.on_message = getattr(self.kind, "on_message", None)

    # -- sends ------------------------------------------------------------

    async def send(self, uid: int, mtype: int, size: int, ref_ns: int,
                   target: int = -1, topics=()) -> None:
        """Send one payload from user ``uid``: a direct to user ``target``,
        or a broadcast on ``topics``."""
        from pushcdn_tpu_torch.proto.message import Broadcast, Direct
        seq = self.seq.get(uid, 0)
        self.seq[uid] = seq + 1
        body = payload(mtype, uid, seq, size, ref_ns)
        if target >= 0:
            message = Direct(self.keys[target].public_key, body)
        else:
            message = Broadcast(list(topics), body)
        s = self.s
        s["pub"].append(uid)
        s["seq"].append(seq)
        s["mtype"].append(mtype)
        s["target"].append(target)
        s["t0"].append(topics[0] if len(topics) > 0 else -1)
        s["t1"].append(topics[1] if len(topics) > 1 else -1)
        s["ref"].append(ref_ns)
        s["ns"].append(now_ns())
        await self.clients[uid].send_message(message)

    # -- deliveries -------------------------------------------------------

    async def receive(self, uid: int, client) -> None:
        from pushcdn_tpu_torch.proto.error import Error
        base = uid << 40
        rc, rn, rr = self.r_code, self.r_ns, self.r_ref
        hook, hook_types = self.on_message, self.hook_types
        while not self.stopping:
            try:
                messages = await client.receive_messages()
            except asyncio.CancelledError:
                raise
            except Error:
                # the client re-dials on its next call; what was sent to
                # it meanwhile is missing, and the oracle will say so
                self.errors += 1
                await asyncio.sleep(0.05)
                continue
            t = now_ns()
            for m in messages:
                body = getattr(m, "message", None)
                if body is None or len(body) < traffic.HDR.size:
                    self.others += 1
                    continue
                mtype, pub, seq, ref, ok = read(body)
                c = base | (pub << SEQ_BITS) | seq
                if not ok:
                    c |= int(CORRUPT)
                rc.append(c)
                rn.append(t)
                rr.append(ref)
                if mtype in hook_types:
                    hook(self, uid, mtype, pub, seq, ref)

    def dump(self, path: str) -> None:
        import numpy as np
        arrays = {"r_code": self.r_code, "r_ns": self.r_ns,
                  "r_ref": self.r_ref}
        arrays.update({f"s_{k}": v for k, v in self.s.items()})
        out = {k: np.frombuffer(v, dtype=np.int64) if len(v)
               else np.empty(0, np.int64) for k, v in arrays.items()}
        out.update({f"x_{k}": np.asarray(v, np.int64)
                    for k, v in self.extra.items()})
        tmp = path + ".tmp.npz"
        np.savez(tmp, **out)
        os.replace(tmp, path)


def _stdin_reader(loop, queue) -> None:
    for line in sys.stdin:
        loop.call_soon_threadsafe(queue.put_nowait, line.strip())
    loop.call_soon_threadsafe(queue.put_nowait, "finish")


async def amain(spec: dict) -> int:
    from pushcdn_tpu_torch.client.client import Client, ClientConfig
    from pushcdn_tpu_torch.bin.common import scheme_by_name, transport_by_name

    g = Gen(spec)
    scheme = scheme_by_name(g.cfg["scheme"])
    protocol = transport_by_name(g.cfg["user_transport"])
    g.keys = [scheme.generate_keypair(seed=traffic.key_seed(g.seed, u))
              for u in range(g.cfg["users"])]
    g.topics = g.kind.users_topics(g.cfg, g.wl, g.seed)
    loop = asyncio.get_running_loop()
    commands: asyncio.Queue = asyncio.Queue()
    threading.Thread(target=_stdin_reader, args=(loop, commands),
                     daemon=True).start()
    emit("keys")
    if await commands.get() != "connect":
        return 1
    for u in g.uids:
        g.clients[u] = Client(ClientConfig(
            marshal_endpoint=spec["marshal"], keypair=g.keys[u],
            protocol=protocol, scheme=scheme,
            subscribed_topics=set(g.topics[u])))
    gate = asyncio.Semaphore(g.cfg.get("connect_concurrency", 32))

    async def connect(client):
        async with gate:
            await client.ensure_initialized()

    t = time.perf_counter()
    await asyncio.wait_for(asyncio.gather(
        *(connect(c) for c in g.clients.values())), 240)
    emit("ready", connect_s=time.perf_counter() - t)
    receivers = [asyncio.create_task(g.receive(u, c))
                 for u, c in g.clients.items()]
    cmd = await commands.get()
    if not cmd.startswith("go "):
        return 1
    _, t0, t_end = cmd.split()
    g.t0, g.t_end = int(t0), int(t_end)
    drive = asyncio.create_task(g.kind.drive(g))
    drive_error = None
    while True:
        try:
            cmd = await asyncio.wait_for(commands.get(), 0.5)
        except asyncio.TimeoutError:
            cmd = None
        if drive.done() and drive_error is None and not drive.cancelled() \
                and drive.exception() is not None:
            drive_error = repr(drive.exception())
        emit("stats", received=len(g.r_code), sent=len(g.s["pub"]),
             drive_done=drive.done(), errors=g.errors,
             drive_error=drive_error)
        if cmd == "finish":
            break
    g.stopping = True
    for task in receivers + [drive]:
        task.cancel()
    await asyncio.gather(*receivers, drive, return_exceptions=True)
    g.dump(os.path.join(spec["rundir"], f"gen-{g.index}.npz"))
    for c in g.clients.values():
        c.close()
    emit("done", errors=g.errors, others=g.others, drive_error=drive_error)
    return 0


def main() -> None:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    code = asyncio.run(amain(spec))
    bad = common.forbidden_loaded(sys.modules)
    if bad:
        print(f"generator loaded {bad}", file=sys.stderr)
        code = code or 3
    sys.exit(code)


if __name__ == "__main__":
    main()
