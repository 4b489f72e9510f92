"""Compute per-scene median metrics from a results txt.

Counterpart of upstream DEVO's scripts/compute_median_from_resTxt.py:
parses the whitespace-separated per-trial results table the eval harness
writes (header row of column names, one row per trial) and prints the
per-scene medians of every numeric column. No pandas dependency.

The port's own copy of scripts/compute_median_from_restxt.py, on devo_tpu_torch's modules: the
same arguments and outputs.
"""
from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np

NUMERIC_COLS = ["ATE[cm]", "R_rmse[deg]", "MPE[%/m]", "MTE[m]",
                "ATE_int[cm]", "ATE_rpg[cm]", "R_rpe[deg/s]", "t_rpe[cm/s]",
                "t_rpe_perc[%]", "R_rpe[deg/m]"]


def median_from_restxt(path: str):
    with open(path) as f:
        data = f.read().strip()
    rows = [r.split() for r in data.split("\\\n")]
    columns, body = rows[0], rows[1:]
    per_scene = defaultdict(lambda: defaultdict(list))
    for row in body:
        rec = dict(zip(columns, row))
        scene = rec.get("Scene")
        if scene is None:
            continue
        for col in NUMERIC_COLS:
            if col in rec:
                try:
                    per_scene[scene][col].append(float(rec[col]))
                except ValueError:
                    pass
    medians = {s: {c: float(np.median(v)) for c, v in cols.items() if v}
               for s, cols in per_scene.items()}
    return medians


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("infile")
    a = p.parse_args()
    assert os.path.exists(a.infile), f"cannot find {a.infile}"
    meds = median_from_restxt(a.infile)
    print("MEDIAN metrics")
    cols = sorted({c for v in meds.values() for c in v})
    print("Scene".ljust(28) + "  ".join(c.rjust(12) for c in cols))
    for scene in sorted(meds):
        print(scene.ljust(28) + "  ".join(
            f"{meds[scene].get(c, float('nan')):12.4f}" for c in cols))
