"""Edge-wise projective geometry (counterpart of devo_tpu/geom/edgewise.py).

Reprojects patch kk from frame ii into frame jj for every edge, and gives
the analytic center-pixel Jacobians that bundle adjustment needs (the closed
forms of the reference's fused CUDA kernel,
upstream DEVO's devo/fastba/ba_cuda.cu:242-365). Per-edge rows come from
plain indexing; components are (E,) or (E, P*P) tensors.

Patches are the engine's flat (Mp, 3*P*P) table [x(PP), y(PP), d(PP)].
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

MIN_DEPTH = 0.2


def _qrot(q, v):
    """Rotate vectors by quaternions; q = 4-tuple of tensors, v = 3-tuple."""
    qx, qy, qz, qw = q
    vx, vy, vz = v
    ux = 2.0 * (qy * vz - qz * vy)
    uy = 2.0 * (qz * vx - qx * vz)
    uz = 2.0 * (qx * vy - qy * vx)
    return (vx + qw * ux + (qy * uz - qz * uy),
            vy + qw * uy + (qz * ux - qx * uz),
            vz + qw * uz + (qx * uy - qy * ux))


def _rel_pose(gi, gj):
    """G_ij = G_j * G_i^{-1} in components (cf. relSE3, ba_cuda.cu:56-67)."""
    ix, iy, iz, iw = gi[:, 3], gi[:, 4], gi[:, 5], gi[:, 6]
    jx, jy, jz, jw = gj[:, 3], gj[:, 4], gj[:, 5], gj[:, 6]
    qij = (-jw * ix + jx * iw - jy * iz + jz * iy,
           -jw * iy + jy * iw - jz * ix + jx * iz,
           -jw * iz + jz * iw - jx * iy + jy * ix,
           jw * iw + jx * ix + jy * iy + jz * iz)
    rx, ry, rz = _qrot(qij, (gi[:, 0], gi[:, 1], gi[:, 2]))
    return (gj[:, 0] - rx, gj[:, 1] - ry, gj[:, 2] - rz), qij


class EdgeGeometry(NamedTuple):
    coords_x: torch.Tensor   # (E, PP) reprojected x
    coords_y: torch.Tensor   # (E, PP)
    center_x: torch.Tensor   # (E,)
    center_y: torch.Tensor   # (E,)
    valid: torch.Tensor      # (E,) center Z > MIN_DEPTH, as 0/1 float
    Ji: Optional[torch.Tensor] = None   # (E, 2, 6) d(proj)/d(xi_i)
    Jj: Optional[torch.Tensor] = None   # (E, 2, 6) d(proj)/d(xi_j)
    Jz: Optional[torch.Tensor] = None   # (E, 2) d(proj)/d(inverse depth)


def reproject(poses, patches, intrinsics, ii, jj, kk,
              jacobian: bool = False) -> EdgeGeometry:
    """Reproject patches kk from frame ii into jj (pops.transform
    semantics); optionally with the center-pixel Jacobians."""
    PP = patches.shape[-1] // 3
    gi, gj = poses[ii], poses[jj]
    ki, kj = intrinsics[ii], intrinsics[jj]
    pk = patches[kk]
    tij, qij = _rel_pose(gi, gj)

    px, py, pd = pk[:, :PP], pk[:, PP:2 * PP], pk[:, 2 * PP:]
    xn = (px - ki[:, 2:3]) / ki[:, 0:1]
    yn = (py - ki[:, 3:4]) / ki[:, 1:2]
    X, Y, Z = _qrot(tuple(c[:, None] for c in qij), (xn, yn, torch.ones_like(xn)))
    X = X + tij[0][:, None] * pd
    Y = Y + tij[1][:, None] * pd
    Z = Z + tij[2][:, None] * pd

    d = 1.0 / Z.clamp_min(0.1)
    coords_x = kj[:, 0:1] * X * d + kj[:, 2:3]
    coords_y = kj[:, 1:2] * Y * d + kj[:, 3:4]
    c = PP // 2
    Xc, Yc, Zc, Wc = X[:, c], Y[:, c], Z[:, c], pd[:, c]
    valid = (Zc > MIN_DEPTH).to(coords_x.dtype)
    if not jacobian:
        return EdgeGeometry(coords_x, coords_y, coords_x[:, c], coords_y[:, c],
                            valid)

    big = Zc.abs() > 0.2
    dc = torch.where(big, 1.0 / torch.where(big, Zc, torch.ones_like(Zc)),
                     torch.zeros_like(Zc))
    d2 = dc * dc
    o = torch.zeros_like(Zc)
    fx, fy = kj[:, 0], kj[:, 1]
    # d(proj)/d(xi_j) (ba_cuda.cu:290, 330): rows [x-row, y-row]
    Jj = torch.stack([
        torch.stack([fx * Wc * dc, o, -fx * Xc * Wc * d2,
                     -fx * Xc * Yc * d2, fx * (1.0 + Xc * Xc * d2),
                     -fx * Yc * dc], -1),
        torch.stack([o, fy * Wc * dc, -fy * Yc * Wc * d2,
                     fy * (-1.0 - Yc * Yc * d2), fy * Xc * Yc * d2,
                     fy * Xc * dc], -1)], 1)                    # (E, 2, 6)

    # Ji = -AdjT(G_ij) applied per row (projective_ops.py:96):
    # out_t = R^T a_t ; out_r = R^T a_r - R^T (t x a_t)
    qc = tuple(q[:, None] for q in (-qij[0], -qij[1], -qij[2], qij[3]))
    tx, ty, tz = (t[:, None] for t in tij)
    at = Jj[..., 0], Jj[..., 1], Jj[..., 2]
    ar = Jj[..., 3], Jj[..., 4], Jj[..., 5]
    cross = (ty * at[2] - tz * at[1], tz * at[0] - tx * at[2],
             tx * at[1] - ty * at[0])
    ot = _qrot(qc, at)
    orr = _qrot(qc, ar)
    rt = _qrot(qc, cross)
    Ji = -torch.stack([ot[0], ot[1], ot[2], orr[0] - rt[0], orr[1] - rt[1],
                       orr[2] - rt[2]], -1)                     # (E, 2, 6)

    # d(proj)/d(inverse depth): the translation column (ba_cuda.cu:289, 329)
    Jz = torch.stack([fx * (tij[0] * dc - tij[2] * Xc * d2),
                      fy * (tij[1] * dc - tij[2] * Yc * d2)], -1)
    return EdgeGeometry(coords_x, coords_y, coords_x[:, c], coords_y[:, c],
                        valid, Ji, Jj, Jz)


def coords_to_corr_format(geo: EdgeGeometry, P: int) -> torch.Tensor:
    """(E, P, P, 2) [x, y] view for the correlation."""
    E = geo.coords_x.shape[0]
    return torch.stack([geo.coords_x, geo.coords_y], -1).reshape(E, P, P, 2)


def flow_mag_edges(poses, patches, intrinsics, ii, jj, kk,
                   beta: float = 0.5) -> torch.Tensor:
    """Per-edge mean flow magnitude (pops.flow_mag): beta * full flow +
    (1 - beta) * translation-only flow, averaged over patch pixels."""
    g1 = reproject(poses, patches, intrinsics, ii, jj, kk)
    PP = patches.shape[-1] // 3
    ki, kj = intrinsics[ii], intrinsics[jj]
    pk = patches[kk]
    tij, _ = _rel_pose(poses[ii], poses[jj])
    px, py, pd = pk[:, :PP], pk[:, PP:2 * PP], pk[:, 2 * PP:]
    X = (px - ki[:, 2:3]) / ki[:, 0:1] + tij[0][:, None] * pd
    Y = (py - ki[:, 3:4]) / ki[:, 1:2] + tij[1][:, None] * pd
    Z = 1.0 + tij[2][:, None] * pd
    d = 1.0 / Z.clamp_min(0.1)
    tx = kj[:, 0:1] * X * d + kj[:, 2:3]
    ty = kj[:, 1:2] * Y * d + kj[:, 3:4]
    # the reference's coords0 = transform(ii, ii) projects back onto the raw
    # patch coords (px, py)
    f1 = torch.sqrt((g1.coords_x - px) ** 2 + (g1.coords_y - py) ** 2)
    f2 = torch.sqrt((tx - px) ** 2 + (ty - py) ** 2)
    return (beta * f1 + (1 - beta) * f2).mean(-1)
