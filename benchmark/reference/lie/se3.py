"""SE(3) in PyTorch.

Counterpart of devo_tpu/lie/se3.py (after lietorch's SE3). Storage is a
trailing 7-vector [tx, ty, tz, qx, qy, qz, qw]; tangent vectors are trailing
6-vectors [tau(3), phi(3)]. Conventions:

  Exp([tau, phi])  = (J_l(phi) tau, ExpSO3(phi))
  Log(t, q)        = [J_l^{-1}(phi) t, phi]
  retr(X, xi)      = Exp(xi) * X
  Adj              = [[R, hat(t) R], [0, R]]
  act4             = [R p + t w, w]
"""
from __future__ import annotations

import torch

from . import so3
from .quaternion import qconj, qmul, qnormalize, qrot

__all__ = ["exp", "log", "inv", "mul", "act", "act4", "adj", "adjT", "retr",
           "matrix", "from_matrix", "identity", "translation", "rotation",
           "make", "scale"]


def identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    g = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    g[..., 6] = 1.0
    return g


def translation(g: torch.Tensor) -> torch.Tensor:
    return g[..., :3]


def rotation(g: torch.Tensor) -> torch.Tensor:
    return g[..., 3:7]


def make(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.cat([t, q], dim=-1)


def exp(xi: torch.Tensor) -> torch.Tensor:
    tau, phi = xi[..., :3], xi[..., 3:6]
    t = (so3.left_jacobian(phi) @ tau[..., None])[..., 0]
    return torch.cat([t, so3.exp(phi)], dim=-1)


def log(g: torch.Tensor) -> torch.Tensor:
    t, q = g[..., :3], g[..., 3:7]
    phi = so3.log(q)
    tau = (so3.left_jacobian_inverse(phi) @ t[..., None])[..., 0]
    return torch.cat([tau, phi], dim=-1)


def inv(g: torch.Tensor) -> torch.Tensor:
    qi = qconj(g[..., 3:7])
    return torch.cat([-qrot(qi, g[..., :3]), qi], dim=-1)


def mul(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    t1, q1 = g1[..., :3], g1[..., 3:7]
    t2, q2 = g2[..., :3], g2[..., 3:7]
    return torch.cat([t1 + qrot(q1, t2), qmul(q1, q2)], dim=-1)


def act(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Action on 3-points."""
    return qrot(g[..., 3:7], p) + g[..., :3]


def act4(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Action on homogeneous 4-points [X, Y, Z, W]."""
    xyz = qrot(g[..., 3:7], p[..., :3]) + g[..., :3] * p[..., 3:4]
    return torch.cat([xyz, p[..., 3:4]], dim=-1)


def retr(g: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Retraction: Exp(xi) * g, with quaternion renormalization."""
    out = mul(exp(xi), g)
    return torch.cat([out[..., :3], qnormalize(out[..., 3:7])], dim=-1)


def adj(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Adjoint action on tangent vectors: Adj_g a."""
    t, q = g[..., :3], g[..., 3:7]
    at, ar = a[..., :3], a[..., 3:6]
    Rar = qrot(q, ar)
    t, Rar_b = torch.broadcast_tensors(t, Rar)
    top = qrot(q, at) + torch.linalg.cross(t, Rar_b, dim=-1)
    return torch.cat([top, Rar], dim=-1)


def adjT(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Transposed adjoint: out_t = R^T a_t, out_r = R^T a_r - R^T (t x a_t)."""
    t, q = g[..., :3], g[..., 3:7]
    at, ar = a[..., :3], a[..., 3:6]
    qi = qconj(q)
    t, at_b = torch.broadcast_tensors(t, at)
    out_t = qrot(qi, at)
    out_r = qrot(qi, ar) - qrot(qi, torch.linalg.cross(t, at_b, dim=-1))
    return torch.cat([out_t, out_r], dim=-1)


def matrix(g: torch.Tensor) -> torch.Tensor:
    """7-vector -> 4x4 homogeneous transform."""
    top = torch.cat([so3.matrix(g[..., 3:7]), g[..., :3, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def from_matrix(T: torch.Tensor) -> torch.Tensor:
    return make(T[..., :3, 3], so3.from_matrix(T[..., :3, :3]))


def scale(g: torch.Tensor, s) -> torch.Tensor:
    """Scale the translation (Sim3-style trajectory rescaling)."""
    return make(g[..., :3] * s, g[..., 3:7])
