"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

With --trace 0 the result carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics. The last line of standard output is one
JSON object (correct, attempted, failed, metrics, device[, breakdown],
compared); the last lines of standard error give each number compared
beside its limit. Exits non-zero, with no result, without the cards the
cell asks for, or when jax, flax or the JAX package is loaded once the
window has closed.
"""
from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.cache_dirs()
    cell = harness.load_cell(args.workload)
    harness.require_cards(cell["workload"]["chips"])
    runner = harness.module("runners", cell["traffic"]["runner"])
    out = runner.run(cell, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), t_process=T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    if args.trace:
        metrics = harness.per_layer(args.workload, out["trace"])
    else:
        metrics = harness.end_to_end(args.workload, out["end_to_end"])
    harness.report_compared(out["compared"])
    print(harness.result_line(out["correct"], out["attempted"], out["failed"],
                              metrics, out["device"], out["compared"],
                              out.get("breakdown") if args.trace else None),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
