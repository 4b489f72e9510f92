"""Trajectory metrics: ATE / MPE / rotation RMSE with Sim3 alignment.

Self-contained NumPy replacement for the reference's evo +
rpg_trajectory_evaluation stack (upstream DEVO's utils/eval_utils.py:147-166,
281-299, 346-380): Umeyama similarity alignment (with scale, as in evo's
`align --correct_scale`), absolute trajectory error RMSE in cm, mean position
error in %/m of traveled distance, and rotation RMSE in degrees.

Poses are (N, 7) lietorch layout [t, q(xyzw)], camera-to-world, with float
timestamps; estimated and ground-truth trajectories are associated by
nearest timestamp (max_diff like evo's association).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform mapping x -> y.

    x, y: (N, 3). Returns (s, R, t) with y ~ s R x + t. (Umeyama, TPAMI 1991;
    same algorithm evo uses for Sim3 ATE alignment.)
    """
    mx = x.mean(0)
    my = y.mean(0)
    xc = x - mx
    yc = y - my
    cov = yc.T @ xc / x.shape[0]
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_x = (xc**2).sum() / x.shape[0]
        s = float(np.trace(np.diag(d) @ S) / max(var_x, 1e-12))
    else:
        s = 1.0
    t = my - s * R @ mx
    return s, R, t


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def associate(t_est: np.ndarray, t_gt: np.ndarray, max_diff: float = 1.0):
    """Nearest-timestamp association; returns index pairs (est_idx, gt_idx).
    Default tolerance 1 s matches evo's sync.associate_trajectories call in
    the reference metric path (eval_utils.py:296,354); t_gt must be sorted
    (asserted by the GT loaders, as in the reference)."""
    gi = np.searchsorted(t_gt, t_est)
    gi = np.clip(gi, 1, len(t_gt) - 1)
    left = t_gt[gi - 1]
    right = t_gt[gi]
    pick = np.where(np.abs(t_est - left) < np.abs(t_est - right), gi - 1, gi)
    ok = np.abs(t_gt[pick] - t_est) <= max_diff
    return np.nonzero(ok)[0], pick[ok]


@dataclass
class TrajectoryMetrics:
    ate: float          # ATE RMSE [cm], Sim3-aligned
    mpe: float          # mean position error [%/m]
    r_rmse: float       # rotation RMSE [deg]
    scale: float        # alignment scale
    n_pairs: int


def ate_real(
    traj_est: np.ndarray,   # (N, 7) [t, q] c2w
    tss_est: np.ndarray,    # (N,) seconds
    traj_gt: np.ndarray,    # (M, 7)
    tss_gt: np.ndarray,     # (M,) seconds
    max_diff: float = 1.0,
    correct_scale: bool = True,
) -> TrajectoryMetrics:
    ei, gi = associate(tss_est, tss_gt, max_diff)
    if len(ei) < 3:
        return TrajectoryMetrics(float("inf"), float("inf"), float("inf"), 1.0, len(ei))

    p_est = traj_est[ei, :3]
    p_gt = traj_gt[gi, :3]
    s, R, t = umeyama_alignment(p_est, p_gt, with_scale=correct_scale)
    p_al = (s * (R @ p_est.T)).T + t

    err = p_al - p_gt
    ate_m = float(np.sqrt((err**2).sum(-1).mean()))

    # traveled distance for MPE (%/m) as in rpg_trajectory_evaluation
    seg = np.linalg.norm(np.diff(p_gt, axis=0), axis=-1)
    dist = float(seg.sum())
    mpe = 100.0 * float(np.linalg.norm(err, axis=-1).mean()) / max(dist, 1e-9)

    # rotation RMSE after alignment
    R_est = quat_to_rot(traj_est[ei, 3:7])
    R_gt = quat_to_rot(traj_gt[gi, 3:7])
    R_al = R[None] @ R_est
    dR = np.einsum("nij,nkj->nik", R_al, R_gt)  # R_al R_gt^T
    cos = np.clip((np.trace(dR, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    ang = np.degrees(np.arccos(cos))
    r_rmse = float(np.sqrt((ang**2).mean()))

    return TrajectoryMetrics(ate=100.0 * ate_m, mpe=mpe, r_rmse=r_rmse,
                             scale=s, n_pairs=len(ei))


def rpe(
    traj_est: np.ndarray, tss_est: np.ndarray,
    traj_gt: np.ndarray, tss_gt: np.ndarray,
    delta: int = 1, max_diff: float = 0.01,
):
    """Relative pose error over frame-delta pairs (counterpart of the
    reference's scripts/evaluate_rpe.py, TUM-RGBD style): translational RMSE
    [m per delta] and rotational RMSE [deg per delta]."""
    ei, gi = associate(tss_est, tss_gt, max_diff)
    if len(ei) < delta + 2:
        return float("inf"), float("inf")
    Pe = np.tile(np.eye(4), (len(ei), 1, 1))
    Pg = np.tile(np.eye(4), (len(gi), 1, 1))
    Pe[:, :3, :3] = quat_to_rot(traj_est[ei, 3:7])
    Pe[:, :3, 3] = traj_est[ei, :3]
    Pg[:, :3, :3] = quat_to_rot(traj_gt[gi, 3:7])
    Pg[:, :3, 3] = traj_gt[gi, :3]

    def rel(P):
        return np.linalg.inv(P[:-delta]) @ P[delta:]

    E = np.linalg.inv(rel(Pg)) @ rel(Pe)
    t_err = np.linalg.norm(E[:, :3, 3], axis=-1)
    cos = np.clip((np.trace(E[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1)
    r_err = np.degrees(np.arccos(cos))
    return float(np.sqrt((t_err**2).mean())), float(np.sqrt((r_err**2).mean()))


def compute_median_results(results_per_trial):
    """Median-over-trials aggregation (eval_utils.py:418-452). The reported
    ATE is np.median over trials exactly (the reference's only aggregate);
    mpe/r_rmse/scale come from the median-ATE trial (upper-middle for even
    counts), so the returned metrics never disagree with the summary
    tables."""
    from dataclasses import replace
    arr = np.asarray([r.ate for r in results_per_trial])
    order = np.argsort(arr)
    med_ate = float(np.median(arr))
    med = replace(results_per_trial[order[len(order) // 2]], ate=med_ate)
    return med, med_ate


def compute_auc(all_ates_cm) -> float:
    """Reference AUC score over ALL trials of ALL scenes
    (eval_utils.py:423): mean of max(1 - ate, 0) with ate in cm — a trial
    scores 1 at perfect tracking and 0 once its ATE exceeds 1 cm."""
    a = np.asarray(list(all_ates_cm), np.float64)
    if a.size == 0:
        return 0.0
    return float(np.maximum(1.0 - a, 0.0).mean())


def aggregate_results(results_cm, dataset_name: str, outfolder=None):
    """Benchmark-level aggregation mirroring the reference's
    compute_median_results (eval_utils.py:418-450).

    `results_cm`: {scene: [ate_cm per trial]}. Returns a dict with the
    per-scene medians keyed '<dataset>/<scene>', 'AUC' over every raw
    trial, and 'AVG' = mean of scene medians in meters. When `outfolder`
    is given, also writes the reference's ' & '-separated (LaTeX row)
    table of per-trial and median ATEs."""
    out = {f"{dataset_name}/{k}": float(np.median(v))
           for k, v in results_cm.items()}
    all_trials = [x for v in results_cm.values() for x in v]
    out["AUC"] = compute_auc(all_trials)
    scene_medians = [float(np.median(v)) for v in results_cm.values()]
    out["AVG"] = float(np.mean(scene_medians)) / 100.0 if scene_medians \
        else float("nan")

    if outfolder is not None and results_cm:
        import os
        os.makedirs(outfolder, exist_ok=True)
        num_runs = max(len(v) for v in results_cm.values())
        with open(os.path.join(outfolder,
                               f"results_median_{dataset_name}.txt"),
                  "w") as f:
            f.write(" & ".join(results_cm.keys()) + "\n")
            for i in range(num_runs):
                f.write(" & ".join(
                    str(v[i]) if i < len(v) else ""
                    for v in results_cm.values()) + "\n")
            f.write("Medians\n")
            f.write(" & ".join(str(np.median(v))
                               for v in results_cm.values()) + "\n")
    return out
