"""Run ``chip_smoke.py`` from several trees in turn on one machine and time
each run, so that two commits compare on the same host in one call.

    python -m pushcdn_tpu_torch.scripts.smoke_ab parent=.build/parent \
        change=. change=. parent=.build/parent [--out chiprun_out/ab]

Each ``name=dir`` runs ``python3 chip_smoke.py`` with ``dir`` as its
working directory (a checkout unpacked with ``git archive``, or a
directory holding the script alone), one after another, its standard
output and error kept under ``--out`` as ``<i>-<name>.out`` / ``.err``.
For each run it prints one JSON line with the exit code and the command
seconds (the child's wall clock), then the run's ``phase_seconds`` line
and its last line, and the tail of its errors when it failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def run(name: str, cwd: str, out_dir: str, index: int,
        timeout_s: float) -> dict:
    base = os.path.join(out_dir, f"{index}-{name}")
    t = time.perf_counter()
    with open(base + ".out", "w") as out, open(base + ".err", "w") as err:
        try:
            rc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                                stdout=out, stderr=err,
                                timeout=timeout_s).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
    seconds = time.perf_counter() - t
    with open(base + ".out") as f:
        lines = f.read().splitlines()
    with open(base + ".err") as f:
        errors = f.read()
    return dict(run=index, tree=name, cwd=cwd, rc=rc, command_s=seconds,
                stdout_lines=len(lines),
                phase_seconds=next((line for line in lines
                                    if '"phase_seconds"' in line), None),
                last_line=lines[-1] if lines else None,
                errors_tail=errors[-1500:] if rc != 0 else "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="smoke_ab", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("runs", nargs="+", metavar="name=dir")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "ab"))
    ap.add_argument("--timeout", type=float, default=1250.0,
                    help="seconds allowed to each run")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for i, spec in enumerate(args.runs):
        name, sep, cwd = spec.partition("=")
        if not sep or not os.path.isfile(os.path.join(cwd, "chip_smoke.py")):
            ap.error(f"{spec!r}: want name=dir, dir holding chip_smoke.py")
        row = run(name, os.path.abspath(cwd), args.out, i, args.timeout)
        print(json.dumps({k: row[k] for k in ("run", "tree", "rc",
                                              "command_s", "stdout_lines")}),
              flush=True)
        print(row["phase_seconds"], flush=True)
        print(row["last_line"], flush=True)
        if row["errors_tail"]:
            print(row["errors_tail"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
