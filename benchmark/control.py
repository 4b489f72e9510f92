"""Readings of a cell's compared numbers over seeds, for the program, for
a fault planted under it, and for the cell's control (the workload's
"control": the settings that put the program one precision down, e.g.
TF32 on).
The limits in workloads/<name>.json are set from these readings: above
the program's largest, below the control's smallest.

    python3 benchmark/control.py --workload NAME --seeds N [N ...]
        [--control | --fault NAME] [--seconds 8] [--out FILE]

One run of the cell's runner a seed, with a short window; prints one JSON
line a seed (and appends it to --out).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None,
                   help="a fault planted under the timed path (the runners' "
                        "FAULTS), instead of the control")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.cache_dirs()
    cell = harness.load_cell(args.workload)
    harness.require_cards(cell["workload"]["chips"])
    runner = harness.module("runners", cell["traffic"]["runner"])
    program = cell["workload"]["control"] if args.control else None
    for seed in args.seeds:
        out = runner.run(cell, seed=seed, seconds=args.seconds, trace=False,
                         t_process=time.monotonic(), program=program,
                         fault=args.fault)
        rec = {"workload": args.workload, "seed": seed,
               "control": bool(args.control), "fault": args.fault,
               "correct": out["correct"],
               "compared": out["compared"], "card": out.get("card")}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
