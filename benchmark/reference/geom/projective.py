"""Projective patch geometry in PyTorch (counterpart of
devo_tpu/geom/projective.py, after upstream DEVO's devo/projective_ops.py):
patch back-projection, the SE3 transform between frames, pinhole
projection, the analytic Jacobians (Ji, Jj, Jz) at the patch centre, point
clouds and the induced flow magnitude. Everything is differentiable; the
training forward reprojects through `transform`.

Layouts:
  poses       (N, 7)            world-to-camera SE3 (lietorch layout)
  patches     (M, 3, P, P)      channels [x, y, inverse depth] at feature res
  intrinsics  (N, 4)            [fx, fy, cx, cy] at feature res
  ii, jj, kk  (E,) int64        source frame / target frame / patch index
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.lie import se3

MIN_DEPTH = 0.2  # projective_ops.py:6


class TransformJacobians(NamedTuple):
    Ji: torch.Tensor  # (E, 2, 6) d(proj)/d(pose_i tangent)
    Jj: torch.Tensor  # (E, 2, 6) d(proj)/d(pose_j tangent)
    Jz: torch.Tensor  # (E, 2, 1) d(proj)/d(inverse depth)


def _intr(intrinsics):
    return [intrinsics[..., i, None, None] for i in range(4)]


def iproj(patches: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Back-project patches (..., 3, P, P) to homogeneous points
    (..., P, P, 4) = [xn, yn, 1, d] (projective_ops.py:19-29)."""
    x, y, d = patches[..., 0, :, :], patches[..., 1, :, :], patches[..., 2, :, :]
    fx, fy, cx, cy = _intr(intrinsics)
    return torch.stack([(x - cx) / fx, (y - cy) / fy, torch.ones_like(d), d],
                       dim=-1)


def proj(X: torch.Tensor, intrinsics: torch.Tensor,
         depth: bool = False) -> torch.Tensor:
    """Pinhole projection of (..., P, P, 4) points -> (..., P, P, 2[+1])
    (projective_ops.py:32-50)."""
    fx, fy, cx, cy = _intr(intrinsics)
    d = 1.0 / X[..., 2].clamp_min(0.1)
    x = fx * (d * X[..., 0]) + cx
    y = fy * (d * X[..., 1]) + cy
    return torch.stack([x, y, d] if depth else [x, y], dim=-1)


def relative_poses(poses: torch.Tensor, ii: torch.Tensor,
                   jj: torch.Tensor) -> torch.Tensor:
    """G_ij = pose_j * pose_i^-1 for each edge."""
    return se3.mul(poses[jj], se3.inv(poses[ii]))


def transform(poses, patches, intrinsics, ii, jj, kk, depth: bool = False,
              valid: bool = False, jacobian: bool = False,
              tonly: bool = False):
    """Reproject patch kk from frame ii into frame jj (projective_ops.py:
    53-105). Returns coords (E, P, P, 2[+1]); with `valid` also the mask
    (E,) of a centre in front of MIN_DEPTH; with `jacobian` the coords,
    the mask and the Jacobians at the patch centre. `tonly` keeps the
    translation of G_ij alone."""
    X0 = iproj(patches[kk], intrinsics[ii])               # (E, P, P, 4)
    Gij = relative_poses(poses, ii, jj)                   # (E, 7)
    if tonly:
        ident = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=Gij.dtype,
                             device=Gij.device).expand(Gij.shape[0], 4)
        Gij = torch.cat([Gij[:, :3], ident], dim=-1)
    X1 = se3.act4(Gij[:, None, None, :], X0)              # (E, P, P, 4)
    coords = proj(X1, intrinsics[jj], depth=depth)

    p = X0.shape[-2]
    vmask = (X1[..., p // 2, p // 2, 2] > MIN_DEPTH).to(coords.dtype)
    if jacobian:
        Xc = X1[..., p // 2, p // 2, :]
        X, Y, Z, H = Xc.unbind(-1)
        o = torch.zeros_like(H)
        fx, fy = intrinsics[jj][..., 0], intrinsics[jj][..., 1]
        far = Z.abs() > 0.2
        d = torch.where(far, 1.0 / torch.where(far, Z, torch.ones_like(Z)),
                        torch.zeros_like(Z))
        # d(X1)/d(xi_j) in the homogeneous generator layout
        # (projective_ops.py:83-88), then d(proj)/d(X1) (:90-93)
        Ja = torch.stack([H, o, o, o, Z, -Y,
                          o, H, o, -Z, o, X,
                          o, o, H, Y, -X, o,
                          o, o, o, o, o, o], dim=-1).reshape(Xc.shape[:-1] + (4, 6))
        Jp = torch.stack([fx * d, o, -fx * X * d * d, o,
                          o, fy * d, -fy * Y * d * d, o],
                         dim=-1).reshape(Xc.shape[:-1] + (2, 4))
        Jj = Jp @ Ja                                      # (E, 2, 6)
        Ji = -se3.adjT(Gij[:, None, :], Jj)
        Jz = Jp @ se3.matrix(Gij)[..., :, 3:]             # (E, 2, 1)
        return coords, vmask, TransformJacobians(Ji, Jj, Jz)
    if valid:
        return coords, vmask
    return coords


def point_cloud(poses, patches, intrinsics, ix) -> torch.Tensor:
    """Patches back-projected to the world frame, (M, P, P, 4) homogeneous
    (projective_ops.py:107-109)."""
    X = iproj(patches, intrinsics[ix])
    return se3.act4(se3.inv(poses[ix])[:, None, None, :], X)


def flow_mag(poses, patches, intrinsics, ii, jj, kk, beta: float = 0.3):
    """Blended rotation / translation induced flow magnitude
    (projective_ops.py:111-121)."""
    coords0 = transform(poses, patches, intrinsics, ii, ii, kk)
    coords1 = transform(poses, patches, intrinsics, ii, jj, kk)
    coords2 = transform(poses, patches, intrinsics, ii, jj, kk, tonly=True)
    flow1 = torch.linalg.norm(coords1 - coords0, dim=-1)
    flow2 = torch.linalg.norm(coords2 - coords0, dim=-1)
    return beta * flow1 + (1.0 - beta) * flow2
