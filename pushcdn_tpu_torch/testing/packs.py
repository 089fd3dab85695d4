"""The parent's side of the client packs (``testing.clientpack``): spawn
a pack process, read its JSON-line events, send it commands, and publish
the sequenced broadcasts a soak checks for gaps.

    pack = Pack(marshal, "soak", clients=255, seed_base=1000, topics=8)
    pack.wait("ready", 60)
    await publish_sequenced(publisher, topics=8, per_topic=64, size=512)
    pack.send("finish")
    result = pack.wait("result", 60)

``chip_smoke.py`` and the tests share it. It imports neither torch nor a
client: the packs are separate processes, and the publisher is whatever
connected ``Client`` the caller passes.
"""

from __future__ import annotations

import asyncio
import json
import os
import queue
import subprocess
import sys
import threading
import time
from typing import Optional

MODULE = "pushcdn_tpu_torch.testing.clientpack"


class Pack:
    """One client-pack process. Its stdout is read by a thread into a
    queue of events (``ready``, ``stats``, ``mark``, ``result``); stderr
    goes to ``log_path`` (or nowhere); ``env`` adds to the environment it
    inherits (``PUSHCDN_IO_IMPL`` puts its clients on io_uring)."""

    def __init__(self, marshal_endpoint: str, mode: str, clients: int,
                 seed_base: int, *extra: str, topics: int = 8,
                 log_path=None, module: str = MODULE, env=None):
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, **(env or {}))
        env["PYTHONPATH"] = (repo + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else repo)
        argv = [sys.executable, "-m", module,
                "--marshal-endpoint", marshal_endpoint, "--mode", mode,
                "--clients", str(clients), "--seed-base", str(seed_base),
                "--topics", str(topics), *extra]
        self._log = open(log_path, "ab") if log_path is not None else None
        self.proc = subprocess.Popen(
            argv, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self._log if self._log is not None
            else subprocess.DEVNULL, text=True)
        self.events: "queue.Queue[dict]" = queue.Queue()
        self.stats: list = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            try:
                event = json.loads(line)
            except ValueError:
                continue   # not one of the pack's JSON lines
            self.events.put(event)
        self.events.put({"event": "exit"})

    def wait(self, event: str, timeout: float) -> dict:
        """The next ``event`` line (``stats`` lines met on the way are
        kept in ``stats``); raises ``TimeoutError``, or ``RuntimeError``
        when the process exits first."""
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"client pack: no {event!r} line in "
                                   f"{timeout:.0f} s")
            try:
                got = self.events.get(timeout=left)
            except queue.Empty:
                continue
            if got.get("event") == event:
                return got
            if got.get("event") == "exit":
                raise RuntimeError(f"client pack exited "
                                   f"({self.proc.wait()}) before {event!r}")
            if got.get("event") == "stats":
                self.stats.append(got)

    def send(self, command: str) -> None:
        self.proc.stdin.write(command + "\n")
        self.proc.stdin.flush()

    def close(self, timeout: float = 10.0) -> Optional[int]:
        """Wait for the process to exit (killing it after ``timeout``);
        returns its exit code."""
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        if self._log is not None:
            self._log.close()
        return rc


def sequenced_payload(seq: int, size: int) -> bytes:
    """A soak broadcast: a 4-byte big-endian per-topic sequence number
    (what ``clientpack.make_seq_extractor`` reads), padded to ``size``."""
    return seq.to_bytes(4, "big") + b"\x00" * max(0, size - 4)


async def publish_sequenced(client, topics: int, per_topic: int, size: int,
                            waves: int = 1, gap_s: float = 0.0) -> int:
    """Send ``per_topic`` sequenced broadcasts on each of ``topics``
    topics in ``waves`` waves, ``gap_s`` apart; each wave sends the next
    ``per_topic / waves`` sequence numbers of every topic. Returns the
    broadcasts sent."""
    step = per_topic // waves
    sent = 0
    for w in range(waves):
        if w and gap_s:
            await asyncio.sleep(gap_s)
        for seq in range(w * step, per_topic if w == waves - 1
                         else (w + 1) * step):
            for t in range(topics):
                await client.send_broadcast_message(
                    [t], sequenced_payload(seq, size))
                sent += 1
    return sent
