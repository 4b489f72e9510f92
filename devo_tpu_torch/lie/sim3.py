"""Sim(3) (similarity transforms) in PyTorch.

Counterpart of devo_tpu/lie/sim3.py (after lietorch's sim3.h and the calcW /
calcWInv series of rxso3.h). Group element: trailing 8-vector
[tx, ty, tz, qx, qy, qz, qw, s]. Tangent: trailing 7-vector
[tau(3), phi(3), sigma].

  Exp([tau, phi, sigma]) = ( W(phi, sigma) tau, ExpSO3(phi), e^sigma )
  Log(t, q, s)           = [ W^{-1} t, LogSO3(q), log s ]

with W the Sim3 "left Jacobian" series; its small-angle and small-scale
branches use EPS = 1e-6, each branch's denominators guarded so that the
unselected one stays finite under autograd.
"""
from __future__ import annotations

import torch

from . import so3
from .quaternion import EPS, qconj, qmul, qnormalize, qrot

__all__ = ["exp", "log", "inv", "mul", "act", "act4", "matrix", "identity",
           "retr", "adj", "adjT"]


def identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    g = torch.zeros(tuple(shape) + (8,), dtype=dtype, device=device)
    g[..., 6] = 1.0
    g[..., 7] = 1.0
    return g


def _guard(c, x, value):
    """x where c is false, `value` where it is true."""
    return torch.where(c, torch.full_like(x, value), x)


def _combine(A, B, C, phi):
    Phi = so3.hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(Phi.shape)
    return (A[..., None, None] * Phi + B[..., None, None] * (Phi @ Phi)
            + C[..., None, None] * eye)


def _calcW(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W matrix of the Sim3 exponential (rxso3.h::calcW)."""
    theta = torch.sqrt((phi * phi).sum(-1).clamp_min(1e-24))
    sigma = sigma[..., 0]
    scale = torch.exp(sigma)
    small_sigma = sigma.abs() < EPS
    small_theta = theta < EPS
    ss = _guard(small_sigma, sigma, 1.0)
    st = _guard(small_theta, theta, 1.0)
    st2 = st * st

    # sigma ~ 0
    A_ss = torch.where(small_theta, torch.full_like(st, 0.5), (1.0 - torch.cos(st)) / st2)
    B_ss = torch.where(small_theta, torch.full_like(st, 1.0 / 6.0),
                  (st - torch.sin(st)) / (st2 * st))
    C_ss = torch.ones_like(sigma)
    # sigma != 0
    C_s = (scale - 1.0) / ss
    A_st = ((ss - 1.0) * scale + 1.0) / (ss * ss)
    B_st = (scale * 0.5 * ss ** 2 + scale - 1.0 - ss * scale) / (ss ** 3)
    a = scale * torch.sin(st)
    b = scale * torch.cos(st)
    c = st2 + ss * ss
    A_se = (a * ss + (1.0 - b) * st) / (st * c)
    B_se = (C_s - ((b - 1.0) * ss + a * st) / c) / st2

    A = torch.where(small_sigma, A_ss, torch.where(small_theta, A_st, A_se))
    B = torch.where(small_sigma, B_ss, torch.where(small_theta, B_st, B_se))
    C = torch.where(small_sigma, C_ss, C_s)
    return _combine(A, B, C, phi)


def _calcWInv(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Inverse W matrix (rxso3.h::calcWInv)."""
    theta_sq = (phi * phi).sum(-1)
    theta = torch.sqrt(theta_sq.clamp_min(1e-24))
    sigma = sigma[..., 0]
    scale = torch.exp(sigma)
    scale_sq = scale * scale
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    small_sigma = sigma * sigma < EPS
    small_theta = theta_sq < EPS
    ss = _guard(small_sigma, sigma, 1.0)
    st = _guard(small_theta, theta, 1.0)
    st2 = st * st
    sc = _guard(small_sigma, scale, 2.0)          # keeps scale - 1 off 0

    # sigma ~ 0
    c_ss = 1.0 - 0.5 * sigma
    a_ss = torch.full_like(sigma, -0.5)
    b_ss = torch.where(small_theta, torch.full_like(sigma, 1.0 / 12.0),
                  (st * sin_t + 2.0 * cos_t - 2.0)
                  / (2.0 * st2 * _guard(small_theta, cos_t - 1.0, 1.0)))
    # sigma != 0
    scale_cu = scale_sq * sc
    c_s = ss / (sc - 1.0)
    a_st = (-ss * sc + sc - 1.0) / ((sc - 1.0) ** 2)
    b_st = (scale_sq * ss - 2.0 * scale_sq + sc * ss + 2.0 * sc) / (
        2.0 * scale_cu - 6.0 * scale_sq + 6.0 * sc - 2.0)
    s_sin = sc * sin_t
    s_cos = sc * cos_t
    a_se = (st * s_cos - st - ss * s_sin) / (st * (scale_sq - 2.0 * s_cos + 1.0))
    b_se = -sc * (st * s_sin - st * sin_t + ss * s_cos - sc * ss
                  + ss * cos_t - ss) / (
        st2 * (scale_cu - 2.0 * sc * s_cos - scale_sq + 2.0 * s_cos + sc - 1.0))

    a = torch.where(small_sigma, a_ss, torch.where(small_theta, a_st, a_se))
    b = torch.where(small_sigma, b_ss, torch.where(small_theta, b_st, b_se))
    c = torch.where(small_sigma, c_ss, c_s)
    return _combine(a, b, c, phi)


def exp(x: torch.Tensor) -> torch.Tensor:
    tau, phi, sigma = x[..., :3], x[..., 3:6], x[..., 6:7]
    t = (_calcW(phi, sigma) @ tau[..., None])[..., 0]
    return torch.cat([t, so3.exp(phi), torch.exp(sigma)], dim=-1)


def log(g: torch.Tensor) -> torch.Tensor:
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    phi = so3.log(q)
    sigma = torch.log(s)
    tau = (_calcWInv(phi, sigma) @ t[..., None])[..., 0]
    return torch.cat([tau, phi, sigma], dim=-1)


def inv(g: torch.Tensor) -> torch.Tensor:
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    qi = qconj(q)
    return torch.cat([-qrot(qi, t) / s, qi, 1.0 / s], dim=-1)


def mul(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    t1, q1, s1 = g1[..., :3], g1[..., 3:7], g1[..., 7:8]
    t2, q2, s2 = g2[..., :3], g2[..., 3:7], g2[..., 7:8]
    return torch.cat([t1 + s1 * qrot(q1, t2), qmul(q1, q2), s1 * s2], dim=-1)


def act(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    return s * qrot(q, p) + t


def act4(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    xyz = s * qrot(q, p[..., :3]) + t * p[..., 3:4]
    return torch.cat([xyz, p[..., 3:4]], dim=-1)


def matrix(g: torch.Tensor) -> torch.Tensor:
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    top = torch.cat([s[..., None] * so3.matrix(q), t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def retr(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    out = mul(exp(x), g)
    return torch.cat([out[..., :3], qnormalize(out[..., 3:7]), out[..., 7:8]],
                     dim=-1)


def adj(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Adjoint action Adj_g a on a tangent [tau, phi, sigma] (sim3.h:89-105):
    Adj = [[sR, hat(t) R, -t], [0, R, 0], [0, 0, 1]]."""
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    at, ap, as_ = a[..., :3], a[..., 3:6], a[..., 6:7]
    Rap = qrot(q, ap)
    t_b, Rap_b = torch.broadcast_tensors(t, Rap)
    out_t = s * qrot(q, at) + torch.linalg.cross(t_b, Rap_b, dim=-1) - as_ * t
    return torch.cat([out_t, Rap, as_], dim=-1)


def adjT(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Transposed adjoint (sim3.h:107-109): out_tau = s R^T a_tau,
    out_phi = R^T (a_phi - t x a_tau), out_sigma = a_sigma - t . a_tau."""
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    at, ap, as_ = a[..., :3], a[..., 3:6], a[..., 6:7]
    qi = qconj(q)
    t_b, at_b = torch.broadcast_tensors(t, at)
    out_t = s * qrot(qi, at)
    out_p = qrot(qi, ap - torch.linalg.cross(t_b, at_b, dim=-1))
    out_s = as_ - (t * at).sum(-1, keepdim=True)
    return torch.cat([out_t, out_p, out_s], dim=-1)
