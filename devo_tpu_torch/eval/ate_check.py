"""Independent ATE implementation for the runtime metric cross-check.

The reference computes ATE twice at eval time — once with evo and once with
rpg_trajectory_evaluation — and asserts they agree to 1e-5
(upstream DEVO's utils/eval_utils.py:358): the metric a paper's claims rest
on should not depend on one implementation's conventions. This module is
that second implementation (the port's own copy of devo_tpu/eval/
ate_check.py): the similarity alignment is
computed with Horn's closed-form quaternion method (eigen-decomposition of
the 4x4 cross-covariance quaternion matrix; Horn, JOSA A 1987) instead of
eval/ate.py's Umeyama SVD, with independently written association and
error code. eval/harness.py cross-asserts the two on every sequence.
"""
from __future__ import annotations

import numpy as np


def _horn_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Similarity transform y ~ s R x + t via Horn's quaternion method.

    x, y: (N, 3). Returns (s, R, t). The optimum is unique for
    non-degenerate point sets, so it must match Umeyama's SVD solution to
    numerical precision — that is the point of the cross-check.
    """
    mx = x.mean(0)
    my = y.mean(0)
    xc = x - mx
    yc = y - my

    S = xc.T @ yc                        # 3x3 cross-covariance * N
    A = S - S.T
    delta = np.array([A[1, 2], A[2, 0], A[0, 1]])
    tr = np.trace(S)
    N = np.empty((4, 4))
    N[0, 0] = tr
    N[0, 1:] = delta
    N[1:, 0] = delta
    N[1:, 1:] = S + S.T - tr * np.eye(3)
    w, V = np.linalg.eigh(N)
    q = V[:, -1]                         # [w, x, y, z], max eigenvalue
    qw, qx, qy, qz = q
    R = np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)],
    ])
    if with_scale:
        # symmetric-free scale: sum(yc . R xc) / sum(|xc|^2) (Horn eq. 41
        # specialized to the one-sided form Umeyama's c uses)
        s = float((yc * (R @ xc.T).T).sum() / (xc * xc).sum())
    else:
        s = 1.0
    t = my - s * (R @ mx)
    return s, R, t


def ate_horn(traj_est: np.ndarray, tss_est: np.ndarray,
             traj_gt: np.ndarray, tss_gt: np.ndarray,
             max_diff: float = 1.0, correct_scale: bool = True) -> float:
    """ATE RMSE [cm] with Horn-quaternion Sim3 alignment; independently
    written counterpart of ate.ate_real's headline number."""
    # association: nearest gt timestamp within max_diff. Same pairing
    # convention as ate.associate (ties toward the right sample) — the
    # INDEPENDENT piece of this cross-check is the alignment algorithm,
    # exactly as evo and rpg_trajectory_evaluation share nearest-neighbor
    # association but solve the alignment separately.
    gi = np.searchsorted(tss_gt, tss_est)
    gi = np.clip(gi, 1, len(tss_gt) - 1)
    left = np.abs(tss_est - tss_gt[gi - 1]) < np.abs(tss_est - tss_gt[gi])
    gi = np.where(left, gi - 1, gi)
    ok = np.abs(tss_gt[gi] - tss_est) <= max_diff
    ei = np.flatnonzero(ok)
    if len(ei) < 3:
        return float("inf")

    p_est = traj_est[ei, :3]
    p_gt = traj_gt[gi[ei], :3]
    s, R, t = _horn_alignment(p_est, p_gt, with_scale=correct_scale)
    err = (s * (R @ p_est.T)).T + t - p_gt
    return 100.0 * float(np.sqrt((err ** 2).sum(-1).mean()))


def cross_check_ate(metrics, traj_est, tss_est, traj_gt, tss_gt,
                    max_diff: float = 1.0, tol: float = 1e-4) -> float:
    """Assert the two independent ATE implementations agree, mirroring
    upstream DEVO's utils/eval_utils.py:358 (evo vs rpg agreement to 1e-5 m
    == 1e-3 cm; we assert relative 1e-4 to be robust across sequence
    scales). Returns the second implementation's value [cm]."""
    ate2 = ate_horn(traj_est, tss_est, traj_gt, tss_gt, max_diff=max_diff)
    a, b = metrics.ate, ate2
    if np.isfinite(a) or np.isfinite(b):
        if not np.isclose(a, b, rtol=tol, atol=1e-3):
            raise AssertionError(
                f"ATE cross-check failed: umeyama={a:.6f} cm vs "
                f"horn={b:.6f} cm (rtol {tol}) — metric implementations "
                "disagree; do not trust either number")
    return ate2
