"""Where the native host routines help and where they cost: one broker
run of ``chip_smoke.py``'s phase 8 (users over the Memory transport,
bursts published and drained, every delivery checked against the
oracle) under three modes, alternated in one process:

- ``native``: every routine of ``pushcdn_tpu_torch.native`` on, as the
  port runs;
- ``no-wire-encoders``: the plane's egress encoder on, but no
  ``FrameEncoder`` (the writers length-prefix in Python and the routing
  loops do not pre-encode fan-out batches);
- ``python``: the library removed, every caller on its Python branch
  (not for a plane on the card, which refuses to warm up without the
  library).

    python -m pushcdn_tpu_torch.testing.native_ab --impl dense --users 4096
    python -m pushcdn_tpu_torch.testing.native_ab --impl host --device cpu \\
        --users 1024

Prints one JSON line per run (the mode, delivered msgs/s, busy seconds,
the step medians, the pipe writes the run made and their mean size),
and with ``--profile`` the busiest functions of each mode's last run
(cProfile, by own time). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import asyncio
import cProfile
import io
import json
import os
import pstats
import sys
from contextlib import contextmanager

MODES = ("native", "no-wire-encoders", "python")


@contextmanager
def mode(name: str):
    """Run the body under ``name``, then restore the library."""
    from pushcdn_tpu_torch import native
    from pushcdn_tpu_torch.proto import message

    native.build()
    saved = {k: getattr(native, k) for k in (
        "_lib", "_tried", "_pydecode_fn", "_pydecode_tried",
        "_shared_encoder", "_shared_encoder_tried")}
    create = native.FrameEncoder.__dict__["create"]
    if name == "no-wire-encoders":
        native.FrameEncoder.create = classmethod(lambda cls, capacity=0: None)
        native._shared_encoder, native._shared_encoder_tried = None, True
    elif name == "python":
        for k in saved:
            setattr(native, k, None if not k.endswith("tried") else True)
    message._native_decode, message._native_decode_tried = None, False
    try:
        yield
    finally:
        native.FrameEncoder.create = create
        for k, v in saved.items():
            setattr(native, k, v)
        message._native_decode, message._native_decode_tried = None, False


def count_writes():
    """Wrap the Memory pipe's write to count writes and bytes."""
    from pushcdn_tpu_torch.proto.transport import memory

    counts = {"writes": 0, "bytes": 0}
    orig = memory._BoundedBuffer.write

    async def write(self, data):
        counts["writes"] += 1
        counts["bytes"] += len(data)
        await orig(self, data)

    memory._BoundedBuffer.write = write
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("dense", "ragged", "host"),
                    default="dense")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--users", type=int, default=4096)
    ap.add_argument("--bursts", type=int, default=2)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke

    shape = dict(chip_smoke.BROKER, users=args.users,
                 bursts={"uniform": args.bursts})
    counts = count_writes()
    modes = MODES if args.impl == "host" or args.device == "cpu" \
        else MODES[:2]
    for rep in range(args.reps):
        for name in modes:
            prof = (cProfile.Profile() if args.profile
                    and rep == args.reps - 1 else None)
            counts.update(writes=0, bytes=0)
            with mode(name):
                if prof is not None:
                    prof.enable()
                row = asyncio.run(chip_smoke.broker_run(
                    args.impl, "uniform", 40, args.device, shape))
                if prof is not None:
                    prof.disable()
            line = dict(mode=name, rep=rep, impl=args.impl,
                        device=args.device, users=args.users,
                        deliveries=row["deliveries"],
                        delivered_msgs_per_s=row["delivered_msgs_per_s"],
                        busy_s=row["busy_s"], pipe_writes=counts["writes"],
                        pipe_write_bytes_mean=counts["bytes"]
                        / max(counts["writes"], 1),
                        **{k: v for k, v in row.items()
                           if k.endswith("_ms_median")
                           or k in ("busy_steps", "native_egress_steps")})
            print(json.dumps(line), flush=True)
            if prof is not None:
                out = io.StringIO()
                pstats.Stats(prof, stream=out).sort_stats(
                    "tottime").print_stats(15)
                print(f"profile {name}:\n{out.getvalue()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
