"""Quaternion utilities (xyzw convention, scalar-last), in PyTorch.

Counterpart of devo_tpu/lie/quaternion.py. All functions broadcast over
leading batch dims; the quaternion lives in the trailing dimension of size 4
as [x, y, z, w].
"""
from __future__ import annotations

import torch

# Small-angle threshold matching the reference (include/common.h: EPS = 1e-6).
EPS = 1e-6


def qmul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2 (xyzw)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def qconj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (inverse for unit quaternions)."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vector(s) v by unit quaternion(s) q:
    uv = 2 q_vec x v;  v' = v + q_w uv + q_vec x uv."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * uv + torch.linalg.cross(qv, uv, dim=-1)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
