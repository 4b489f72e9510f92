"""Evaluate ORB-SLAM3 baseline trajectories against GT.

Counterpart of upstream DEVO's scripts/orb3_eval_eds.py: for each sequence
dir with an ORB3_<calib> subdir (produced by scripts/orb3_pp_eds.py and an
external ORB-SLAM3 run), score every `f_<seq>*.txt` estimate against
`groundtruth_ns.txt` with the same Sim3-aligned ATE the DEVO evals use,
and write per-trial results + trajectory plots.

The port's own copy of scripts/orb3_eval.py, on devo_tpu_torch's modules: the
same arguments and outputs.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import os.path as osp

import numpy as np

from devo_tpu_torch.eval.ate import ate_real, compute_median_results
from devo_tpu_torch.utils.viz import plot_trajectory


def eval_orb3(datadir: str, evaldir: str, orb3home: str = "",
              calibstr: str = "calib0"):
    os.makedirs(evaldir, exist_ok=True)
    summary = {}
    for seqname in sorted(os.listdir(datadir)):
        orb3dir = osp.join(datadir, seqname, f"ORB3_{calibstr}")
        if not osp.isdir(orb3dir):
            continue
        gt = np.loadtxt(osp.join(orb3dir, "groundtruth_ns.txt"),
                        delimiter=",")
        tss_gt_s, traj_gt = gt[:, 0] / 1e9, gt[:, 1:]
        estfiles = sorted(glob.glob(
            osp.join(orb3home or orb3dir, f"f_{seqname}*.txt")))
        if not estfiles:
            print(f"no ORB3 estimates for {seqname}")
            continue
        trial_metrics = []
        for trial, fn in enumerate(estfiles):
            est = np.loadtxt(fn, delimiter=" ")
            tss_est_s, traj_est = est[:, 0] / 1e9, est[:, 1:8]
            # same 1 s association tolerance as the DEVO metric path (evo
            # sync.associate max_diff=1, eval_utils.py:354) — the baseline
            # must be scored on the same pair set to be comparable
            m = ate_real(traj_est.astype(np.float32), tss_est_s,
                         traj_gt.astype(np.float32), tss_gt_s, max_diff=1.0)
            trial_metrics.append(m)
            plot_trajectory(
                osp.join(evaldir, f"{seqname}_trial{trial}.png"),
                traj_est, traj_gt, title=f"{seqname} ATE {m.ate:.2f} cm")
        med, med_ate = compute_median_results(trial_metrics)
        summary[seqname] = dict(ate_cm=med_ate, mpe=med.mpe,
                                r_rmse=med.r_rmse,
                                trials=[m.ate for m in trial_metrics])
        print(f"{seqname}: median ATE {med_ate:.2f} cm over "
              f"{len(trial_metrics)} trials")
    with open(osp.join(evaldir, "orb3_results.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="evaluate ORB-SLAM3 baselines")
    p.add_argument("--datadir", required=True)
    p.add_argument("--evaldir", required=True)
    p.add_argument("--orb3home", default="",
                   help="dir holding f_<seq>*.txt outputs (default: the "
                        "sequence's ORB3_<calib> dir)")
    p.add_argument("--calibstr", default="calib0")
    a = p.parse_args()
    eval_orb3(a.datadir, a.evaldir, a.orb3home, a.calibstr)
