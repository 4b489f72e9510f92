"""Standalone relative-pose-error scorer for TUM-format trajectories.

Counterpart of upstream DEVO's scripts/evaluate_rpe.py: compares an
estimated trajectory against ground truth with RPE (and ATE for reference).

Usage: python -m devo_tpu_torch.scripts.evaluate_rpe --est est.txt --gt gt.txt [--delta 1]

The port's own copy of scripts/evaluate_rpe.py, on devo_tpu_torch's modules: the
same arguments and outputs.
"""
import argparse
import os

import numpy as np

from devo_tpu_torch.eval.ate import ate_real, rpe


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--est", required=True, help="TUM file: t x y z qx qy qz qw")
    p.add_argument("--gt", required=True)
    p.add_argument("--delta", type=int, default=1)
    p.add_argument("--max_diff", type=float, default=0.01)
    args = p.parse_args()

    est = np.loadtxt(args.est, comments="#")
    gt = np.loadtxt(args.gt, comments="#")
    t_rmse, r_rmse = rpe(est[:, 1:8], est[:, 0], gt[:, 1:8], gt[:, 0],
                         delta=args.delta, max_diff=args.max_diff)
    m = ate_real(est[:, 1:8], est[:, 0], gt[:, 1:8], gt[:, 0],
                 max_diff=args.max_diff)
    print(f"RPE trans RMSE: {t_rmse:.6f} m/delta")
    print(f"RPE rot RMSE:   {r_rmse:.4f} deg/delta")
    print(f"ATE RMSE:       {m.ate:.3f} cm (Sim3, scale {m.scale:.4f})")


if __name__ == "__main__":
    main()
