"""A fixed unit of host work, run beside the brokers every 250 ms, so a run
can read how fast the host was while it ran.

    python3 -m cdnbench.hostprobe

The card's host runs the same work faster or slower from minute to minute,
in every process at once. The probe's unit holds three parts, each the
kind of work a broker does for a delivery:

- ``frames``: per-frame Python: pack and unpack a 12-byte header with
  ``struct``, look its user up in a dict of 1,024 keys and append to a
  list, ``FRAMES`` times;
- ``tls``: encrypt a fixed 64 KB buffer ``TLS_WRITES`` times through an
  in-process TLS 1.3 client and server over ``MemoryBIO`` (AES-256-GCM,
  the suite the users' connections negotiate) and read the ciphertext out;
- ``loopback``: send that ciphertext ``LOOP_SENDS`` times over a loopback
  TCP connection the probe holds to itself, and receive it.

It talks to the harness in JSON lines on stdout and words on stdin: it
prints ``ready`` once its connections are up, then one ``unit`` line for
each unit it completes (its end on CLOCK_MONOTONIC, which every process of
the host shares, and each part's wall µs); on ``stop`` or the end of its
input it prints ``done`` with the top-level names of every module it holds
and exits. The harness takes the median of the units' wall time over the
window, and reads the probe's CPU from ``/proc``.

Imports only the standard library.
"""

from __future__ import annotations

import json
import os
import random
import select
import socket
import ssl
import struct
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CERT = os.path.join(HERE, "hostprobe_cert.pem")
KEY = os.path.join(HERE, "hostprobe_key.pem")

PERIOD_NS = 250_000_000
# each unit starts up to one 10 ms tick of the host's CPU clock late, drawn
# from a fixed seed, so its start does not keep one phase to the tick
JITTER_NS = 10_000_000
CIPHER = "TLS_AES_256_GCM_SHA384"

# the unit's size, set on the card (NVIDIA H100 80GB HBM3's host) so each
# part takes about 1 ms: each part's median wall time in the benchmark's
# cells there read 0.57-0.60 µs a frame, 29-32 µs a TLS write and 102-110 µs
# a loopback send. The host charges the probe 1.2-1.8 times its units' wall
# time, most where the broker holds its core, so the unit stays small
# enough to keep the probe under 5% of one core there
FRAMES = 1700
TLS_WRITES = 32
LOOP_SENDS = 10

USERS = 1024
HEADER = struct.Struct("<IIi")      # user, sequence, length: 12 bytes
PAYLOAD = bytes(range(256)) * 256   # 64 KB
PARTS = ("frames", "tls", "loopback")


def emit(event: str, **fields) -> None:
    print(json.dumps({"event": event, **fields}), flush=True)


class Probe:
    """The unit's state: the user table, the TLS pair, the loopback pair."""

    def __init__(self):
        self.users = {u: u * 7 for u in range(USERS)}
        self.tls_client, self.tls_out = self._tls_pair()
        self.tx, self.rx = self._loopback_pair()
        self.rbuf = bytearray(1 << 18)

    def _tls_pair(self):
        server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        server_ctx.minimum_version = ssl.TLSVersion.TLSv1_3
        server_ctx.load_cert_chain(CERT, KEY)
        client_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        client_ctx.minimum_version = ssl.TLSVersion.TLSv1_3
        client_ctx.check_hostname = False
        client_ctx.verify_mode = ssl.CERT_NONE
        c_in, c_out, s_in, s_out = (ssl.MemoryBIO() for _ in range(4))
        client = client_ctx.wrap_bio(c_in, c_out)
        server = server_ctx.wrap_bio(s_in, s_out, server_side=True)
        done = set()
        for _ in range(10):
            for side, name in ((client, "c"), (server, "s")):
                if name in done:
                    continue
                try:
                    side.do_handshake()
                    done.add(name)
                except ssl.SSLWantReadError:
                    pass
            s_in.write(c_out.read())
            c_in.write(s_out.read())
            if len(done) == 2:
                break
        else:
            raise RuntimeError("the probe's TLS handshake did not finish")
        suite = client.cipher()[0]
        if suite != CIPHER:
            raise RuntimeError(f"the probe negotiated {suite}, not {CIPHER}")
        return client, c_out

    def _loopback_pair(self):
        with socket.socket() as lsn:
            lsn.bind(("127.0.0.1", 0))
            lsn.listen(1)
            tx = socket.create_connection(lsn.getsockname())
            rx, _ = lsn.accept()
        for s in (tx, rx):
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.setblocking(False)
        return tx, rx

    def close(self) -> None:
        self.tx.close()
        self.rx.close()

    # -- the unit's parts ---------------------------------------------------

    def frames(self) -> int:
        out = []
        users, pack, unpack = self.users, HEADER.pack, HEADER.unpack
        for i in range(FRAMES):
            user, seq, n = unpack(pack(i & (USERS - 1), i, -i))
            out.append((users[user], seq, n))
        return len(out)

    def tls(self) -> bytes:
        for _ in range(TLS_WRITES):
            self.tls_client.write(PAYLOAD)
            data = self.tls_out.read()
        return data

    def loopback(self, data: bytes) -> int:
        n, view = len(data), memoryview(data)
        for _ in range(LOOP_SENDS):
            sent = got = 0
            while got < n:
                if sent < n:
                    try:
                        sent += self.tx.send(view[sent:])
                    except BlockingIOError:
                        pass
                try:
                    k = self.rx.recv_into(self.rbuf)
                except BlockingIOError:
                    select.select([self.rx], [self.tx] if sent < n else [],
                                  [], 1.0)
                    continue
                if k == 0:
                    raise RuntimeError("the probe's loopback closed")
                got += k
        return got

    def unit(self) -> list:
        """Runs one unit; each part's wall µs."""
        t0 = time.perf_counter_ns()
        self.frames()
        t1 = time.perf_counter_ns()
        data = self.tls()
        t2 = time.perf_counter_ns()
        self.loopback(data)
        t3 = time.perf_counter_ns()
        return [(t1 - t0) / 1e3, (t2 - t1) / 1e3, (t3 - t2) / 1e3]


def stopped_before(t_ns: int) -> bool:
    """Waits until ``t_ns`` on CLOCK_MONOTONIC; True as soon as stdin
    says ``stop`` or ends."""
    while True:
        left = (t_ns - time.monotonic_ns()) / 1e9
        if left <= 0:
            return False
        ready, _, _ = select.select([sys.stdin], [], [], left)
        if ready:
            line = sys.stdin.readline()
            if not line or line.strip() == "stop":
                return True


def main() -> int:
    probe = Probe()
    jitter = random.Random(0x9E3779B9)
    units = 0
    try:
        emit("ready", cipher=probe.tls_client.cipher()[0],
             frames=FRAMES, tls_writes=TLS_WRITES, loop_sends=LOOP_SENDS)
        due = time.monotonic_ns()
        while True:
            due += PERIOD_NS
            start = due + jitter.randrange(JITTER_NS)
            if stopped_before(start):
                break
            parts = probe.unit()
            units += 1
            emit("unit", end_ns=time.monotonic_ns(), us=parts)
            due = max(due, time.monotonic_ns() - PERIOD_NS)   # no catch-up
    finally:
        probe.close()
    emit("done", units=units,
         modules=sorted({m.split(".", 1)[0] for m in sys.modules}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
