"""Pose/trajectory utilities.

Counterpart of upstream DEVO's utils/pose_utils.py and transform_utils.py:
quaternion/homogeneous conversions, trajectory interpolation at arbitrary
timestamps (SLERP + lerp), and the rescaling transform for reduced-
resolution runs.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def quat_slerp(q0: np.ndarray, q1: np.ndarray, tau: np.ndarray) -> np.ndarray:
    """Batched SLERP between unit quaternions (xyzw); tau in [0, 1]."""
    d = np.sum(q0 * q1, -1, keepdims=True)
    q1 = np.where(d < 0, -q1, q1)
    d = np.abs(d).clip(0, 1.0)
    theta = np.arccos(d)
    sin_t = np.sin(theta)
    small = sin_t < 1e-6
    w0 = np.where(small, 1.0 - tau, np.sin((1 - tau) * theta) / np.where(small, 1, sin_t))
    w1 = np.where(small, tau, np.sin(tau * theta) / np.where(small, 1, sin_t))
    out = w0 * q0 + w1 * q1
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def interpolate_traj_at_tss(
    tss_traj: np.ndarray, traj: np.ndarray, tss_query: np.ndarray
) -> np.ndarray:
    """Interpolate a (N, 7) [t, q] trajectory at query timestamps
    (pose_utils.py:88). Queries outside the range clamp to the endpoints."""
    tss_query = np.clip(tss_query, tss_traj[0], tss_traj[-1])
    idx = np.searchsorted(tss_traj, tss_query, side="right")
    idx = np.clip(idx, 1, len(tss_traj) - 1)
    t0, t1 = tss_traj[idx - 1], tss_traj[idx]
    tau = ((tss_query - t0) / np.maximum(t1 - t0, 1e-12))[:, None]
    trans = (1 - tau) * traj[idx - 1, :3] + tau * traj[idx, :3]
    quat = quat_slerp(traj[idx - 1, 3:7], traj[idx, 3:7], tau)
    return np.concatenate([trans, quat], -1)


def poses_hom_to_quat(T: np.ndarray) -> np.ndarray:
    """(N, 4, 4) -> (N, 7) [t, q xyzw]."""
    from devo_tpu_torch.eval.ate import quat_to_rot  # noqa: F401 (sibling helpers)

    t = T[:, :3, 3]
    R = T[:, :3, :3]
    # Shepperd's method, vectorized
    m00, m11, m22 = R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]
    tr = m00 + m11 + m22
    q = np.zeros((len(T), 4))
    for i in range(len(T)):
        Ri = R[i]
        if tr[i] > 0:
            s = np.sqrt(tr[i] + 1.0) * 2
            q[i] = [(Ri[2, 1] - Ri[1, 2]) / s, (Ri[0, 2] - Ri[2, 0]) / s,
                    (Ri[1, 0] - Ri[0, 1]) / s, 0.25 * s]
        else:
            k = np.argmax([m00[i], m11[i], m22[i]])
            a, b, c = k, (k + 1) % 3, (k + 2) % 3
            s = np.sqrt(1.0 + Ri[a, a] - Ri[b, b] - Ri[c, c]) * 2
            qv = np.zeros(3)
            qv[a] = 0.25 * s
            qv[b] = (Ri[a, b] + Ri[b, a]) / s
            qv[c] = (Ri[a, c] + Ri[c, a]) / s
            q[i] = [qv[0], qv[1], qv[2], (Ri[c, b] - Ri[b, c]) / s]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([t, q], -1)


def poses_quat_to_hom(poses: np.ndarray) -> np.ndarray:
    """(N, 7) -> (N, 4, 4)."""
    from devo_tpu_torch.eval.ate import quat_to_rot

    T = np.tile(np.eye(4), (len(poses), 1, 1))
    T[:, :3, :3] = quat_to_rot(poses[:, 3:7])
    T[:, :3, 3] = poses[:, :3]
    return T


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """align_corners=False bilinear resize of (..., H, W) (the resize of
    devo_tpu/data/tartan.py, kept here until the training data path is
    ported)."""
    H, W = img.shape[-2:]
    ys = (np.arange(out_h) + 0.5) * H / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * W / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)
    wx = np.clip(xs - x0, 0.0, 1.0)
    a = img[..., y0, :][..., :, x0]
    b = img[..., y0, :][..., :, x1]
    c = img[..., y1, :][..., :, x0]
    e = img[..., y1, :][..., :, x1]
    top = a * (1 - wx) + b * wx
    bot = c * (1 - wx) + e * wx
    return top * (1 - wy[..., :, None]) + bot * wy[..., :, None]


def transform_rescale(scale: float, voxels, disps, poses, intrinsics):
    """Rescale a clip for reduced-resolution runs (transform_utils.py:9-27):
    resizes voxels/disps bilinearly and scales intrinsics; poses unchanged."""
    H, W = voxels.shape[-2:]
    nh, nw = int(round(H * scale)), int(round(W * scale))
    voxels = _bilinear_resize(voxels, nh, nw)
    disps = _bilinear_resize(disps, nh, nw)
    intrinsics = intrinsics * scale
    return voxels, disps, poses, intrinsics
