"""The control of ``correct``: a cell served on the program's own
lower-precision path (complex64 working dtype, its certified FP64 finisher
switched off; ``program.control_config``), which the check has to
fail. The benchmark's own runs never take this path.

    python3 -m port_bench.control --workload <cell> --seconds <s> --seeds <n,n,...>

Runs one window a seed in this process and prints each run's result line,
whose ``checks`` hold the control's readings beside their limits. Exit 0
when no seed's run came out correct (a run that crashes has failed too,
but gives no reading), else 1.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys

from .run import main as run_main


def main(argv=None, root=None, device=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    all_failed = True
    for seed in (int(s) for s in args.seeds.split(",") if s):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = run_main(["--workload", args.workload, "--seed", str(seed),
                           "--seconds", str(args.seconds), "--trace", "0"],
                          root=root, device=device, control=True)
        lines = out.getvalue().strip().splitlines()
        line = json.loads(lines[-1]) if rc == 0 and lines else {"correct": None}
        all_failed = all_failed and line["correct"] is not True
        print(json.dumps({"workload": args.workload, "seed": seed, "rc": rc,
                          "correct": line["correct"], "attempted": line.get("attempted"),
                          "checks": line.get("checks")}), flush=True)
    return 0 if all_failed else 1


if __name__ == "__main__":
    sys.exit(main())
