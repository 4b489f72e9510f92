"""R x SO(3) (rotation and isotropic scale) in PyTorch.

Counterpart of devo_tpu/lie/rxso3.py (after lietorch's rxso3.h). Group
element: trailing 5-vector [qx, qy, qz, qw, s], a unit quaternion and a
positive scale. Tangent: trailing 4-vector [phi(3), sigma].
"""
from __future__ import annotations

import torch

from . import so3
from .quaternion import qconj, qmul, qnormalize, qrot

__all__ = ["exp", "log", "inv", "mul", "act", "act4", "matrix", "identity",
           "retr", "adj", "adjT"]


def identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    g = torch.zeros(tuple(shape) + (5,), dtype=dtype, device=device)
    g[..., 3] = 1.0
    g[..., 4] = 1.0
    return g


def exp(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([so3.exp(x[..., :3]), torch.exp(x[..., 3:4])], dim=-1)


def log(g: torch.Tensor) -> torch.Tensor:
    return torch.cat([so3.log(g[..., :4]), torch.log(g[..., 4:5])], dim=-1)


def inv(g: torch.Tensor) -> torch.Tensor:
    return torch.cat([qconj(g[..., :4]), 1.0 / g[..., 4:5]], dim=-1)


def mul(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    return torch.cat([qmul(g1[..., :4], g2[..., :4]),
                      g1[..., 4:5] * g2[..., 4:5]], dim=-1)


def act(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return g[..., 4:5] * qrot(g[..., :4], p)


def act4(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Action on a homogeneous 4-vector: sR on xyz, w unchanged."""
    return torch.cat([act(g, p[..., :3]), p[..., 3:4]], dim=-1)


def matrix(g: torch.Tensor) -> torch.Tensor:
    return g[..., 4:5, None] * so3.matrix(g[..., :4])


def retr(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    out = mul(exp(x), g)
    return torch.cat([qnormalize(out[..., :4]), out[..., 4:5]], dim=-1)


def adj(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Adjoint: the rotation rotates phi, sigma is invariant."""
    return torch.cat([qrot(g[..., :4], a[..., :3]), a[..., 3:4]], dim=-1)


def adjT(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.cat([qrot(qconj(g[..., :4]), a[..., :3]), a[..., 3:4]], dim=-1)
