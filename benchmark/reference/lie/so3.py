"""SO(3) in PyTorch.

Counterpart of devo_tpu/lie/so3.py (after the reference's Eigen SO3 class,
upstream DEVO's devo/lietorch/include/so3.h): unit quaternions stored as
trailing [x, y, z, w], tangent vectors as trailing 3-vectors, with the same
small-angle Taylor branches (EPS = 1e-6).
"""
from __future__ import annotations

import torch

from .quaternion import (EPS, matrix_to_quat, qconj, qmul, qnormalize, qrot,
                         quat_to_matrix)

__all__ = [
    "exp", "log", "inv", "mul", "act", "act4", "adj", "adjT", "retr",
    "matrix", "from_matrix", "identity", "hat", "left_jacobian",
    "left_jacobian_inverse",
]


def identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def _theta(phi):
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    return theta_sq, torch.sqrt(theta_sq.clamp_min(1e-24))


def exp(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle 3-vector -> unit quaternion (so3.h::Exp)."""
    theta_sq, theta = _theta(phi)
    theta_p4 = theta_sq * theta_sq
    small = theta_sq < EPS
    th = torch.where(small, torch.ones_like(theta), theta)
    imag_t = 0.5 - (1.0 / 48.0) * theta_sq + (1.0 / 3840.0) * theta_p4
    real_t = 1.0 - (1.0 / 8.0) * theta_sq + (1.0 / 384.0) * theta_p4
    imag = torch.where(small, imag_t, torch.sin(0.5 * th) / th)
    real = torch.where(small, real_t, torch.cos(0.5 * th))
    return torch.cat([imag * phi, real], dim=-1)


def log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> axis-angle 3-vector (so3.h::Log), angle in
    (-pi, pi]."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    nv_sq = (qv * qv).sum(-1, keepdim=True)
    nv = torch.sqrt(nv_sq.clamp_min(1e-24))
    small = nv_sq < EPS * EPS
    sign_w = torch.where(qw < 0, -torch.ones_like(qw), torch.ones_like(qw))
    qw_t = torch.where(small, qw, torch.ones_like(qw))
    factor_t = 2.0 / qw_t - (2.0 / 3.0) * nv_sq / (qw_t * qw_t * qw_t)
    factor_e = 2.0 * sign_w * torch.atan2(nv, qw.abs()) / nv
    return torch.where(small, factor_t, factor_e) * qv


def inv(q: torch.Tensor) -> torch.Tensor:
    return qconj(q)


def mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    return qmul(q1, q2)


def act(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return qrot(q, p)


def matrix(q: torch.Tensor) -> torch.Tensor:
    return quat_to_matrix(q)


def from_matrix(R: torch.Tensor) -> torch.Tensor:
    return matrix_to_quat(R)


def act4(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Action on a homogeneous 4-vector: rotate xyz, keep w."""
    return torch.cat([qrot(q, p[..., :3]), p[..., 3:4]], dim=-1)


def adj(q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Adjoint action: Adj_q(a) = R a."""
    return qrot(q, a)


def adjT(q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Transposed adjoint: R^T a."""
    return qrot(qconj(q), a)


def retr(q: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Retraction Exp(phi) * q."""
    return qnormalize(qmul(exp(phi), q))


def hat(phi: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector."""
    x, y, z = phi.unbind(-1)
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(phi.shape[:-1] + (3, 3))


def _eye_like(Phi):
    return torch.eye(3, dtype=Phi.dtype, device=Phi.device).expand(Phi.shape)


def left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(phi)."""
    theta_sq, theta = _theta(phi)
    Phi = hat(phi)
    small = theta_sq < EPS
    ts = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    th = torch.where(small, torch.ones_like(theta), theta)
    coef1 = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(th)) / ts)
    coef2 = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                        (th - torch.sin(th)) / (ts * th))
    return (_eye_like(Phi) + coef1[..., None] * Phi
            + coef2[..., None] * (Phi @ Phi))


def left_jacobian_inverse(phi: torch.Tensor) -> torch.Tensor:
    """Inverse of the SO(3) left Jacobian."""
    theta_sq, theta = _theta(phi)
    Phi = hat(phi)
    small = theta_sq < EPS
    ts = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    th = torch.where(small, torch.ones_like(theta), theta)
    half = 0.5 * th
    coef_t = 1.0 / 12.0 + theta_sq / 720.0
    coef_e = 1.0 / ts - torch.cos(half) / (2.0 * th * torch.sin(half))
    coef = torch.where(small, coef_t, coef_e)
    return _eye_like(Phi) - 0.5 * Phi + coef[..., None] * (Phi @ Phi)
