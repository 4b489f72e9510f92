"""Gauss-Newton bundle adjustment for patch-based VO (counterpart of
devo_tpu/ops/ba.py; the inference path of the reference's fused CUDA BA,
upstream DEVO's devo/fastba/ba_cuda.cu:461-537).

The block Hessian is assembled with segment sums in a fixed order
(ops/segment.py) over the free poses of the window and the active patch
slots, reduced by the Schur complement onto the poses, and solved by
Cholesky. Window bounds (t0, t1,
kbase) are host ints. `run_ba` updates `poses` and `patches` in place: the
tracking step. `gauss_newton_step_diff` solves the same system and returns
new tensors, differentiable end to end (the segment sums carry gradients):
the training step's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.geom import edgewise
from benchmark.reference.lie import se3
from benchmark.reference.ops import segment


class BASystem(NamedTuple):
    B: torch.Tensor  # (6N, 6N)
    E: torch.Tensor  # (6N, M)
    C: torch.Tensor  # (M,)
    v: torch.Tensor  # (6N,)
    u: torch.Tensor  # (M,)


def assemble(Ji, Jj, Jz, r, w, li, lj, pk, n_poses: int,
             n_patches: int) -> BASystem:
    """Ji, Jj (E, 2, 6); Jz, r, w (E, 2); li, lj (E,) local pose index, -1
    if the pose is fixed; pk (E,) local patch slot in [0, n_patches)."""
    n = n_poses
    mi = (li >= 0)[:, None].to(w.dtype)
    mj = (lj >= 0)[:, None].to(w.dtype)
    wi, wj, wij = w * mi, w * mj, w * mi * mj
    li_c, lj_c = li.clamp(0, n - 1), lj.clamp(0, n - 1)

    def outer(wt, A, B):
        return torch.einsum("er,eri,erj->eij", wt, A, B)

    # segment sums in a fixed order (ops/segment.py): the n*n pose blocks and
    # the n rows of v are few segments of thousands of rows each, a one-hot
    # product; the patch sums many short segments, sorted once per index
    Hij = outer(wij, Ji, Jj)
    B = segment.dense_segment_sum(
        torch.cat([outer(wi, Ji, Ji), Hij, Hij.transpose(1, 2),
                   outer(wj, Jj, Jj)]),
        torch.cat([li_c * n + li_c, li_c * n + lj_c, lj_c * n + li_c,
                   lj_c * n + lj_c]), n * n)
    B = B.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n)

    v = segment.dense_segment_sum(
        torch.cat([torch.einsum("er,eri->ei", wi * r, Ji),
                   torch.einsum("er,eri->ei", wj * r, Jj)]),
        torch.cat([li_c, lj_c]), n)

    Eb = segment.segment_sum(
        torch.cat([torch.einsum("er,eri->ei", wi * Jz, Ji),
                   torch.einsum("er,eri->ei", wj * Jz, Jj)]),
        segment.segments(torch.cat([li_c * n_patches + pk,
                                    lj_c * n_patches + pk]), n * n_patches))
    E = Eb.reshape(n, n_patches, 6).permute(0, 2, 1).reshape(6 * n, n_patches)

    Cu = segment.segment_sum(
        torch.stack([(w * Jz * Jz).sum(-1), (w * Jz * r).sum(-1)], -1),
        segment.segments(pk, n_patches))
    C, u = Cu[:, 0], Cu[:, 1]
    return BASystem(B, E, C, v.reshape(-1), u)


def _finite_or_zero(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def schur_solve(sys: BASystem, lmbda: float, ep: float, lm: float,
                structure_only: bool = False):
    """Schur-complement solve (ba_cuda.cu:492-527). Returns (dX (N, 6),
    dZ (M,), ok). When the Cholesky fails, dX is zero but dZ = Q u is still
    applied, as the reference's solver does."""
    B, E, C, v, u = sys
    Q = 1.0 / (C + lmbda)
    if structure_only:
        dZ = _finite_or_zero(Q * u)
        return (torch.zeros((B.shape[0] // 6, 6), dtype=B.dtype, device=B.device),
                dZ, torch.isfinite(dZ).all())
    EQ = E * Q[None, :]
    S = B - EQ @ E.T
    y = v - EQ @ u
    S = S + torch.diag(ep + lm * torch.diagonal(S))
    L, info = torch.linalg.cholesky_ex(S)
    ok = (info == 0) & torch.isfinite(L).all()
    eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    L = torch.where(ok, L, eye)
    dX = torch.cholesky_solve(y[:, None], L)[:, 0]
    dX = torch.where(ok, dX, torch.zeros_like(dX))
    dZ = _finite_or_zero(Q * (u - E.T @ dX))
    return dX.reshape(-1, 6), dZ, ok


def _system(poses, patches, intrinsics, target, weight, ii, jj, kk, mask,
            t0: int, t1: int, kbase: int, window: int, patch_slots: int,
            bounds, max_residual: float):
    """The gated residuals and the block system of one iteration. Returns
    (system, pk_c (E,) local patch slot, clamped, edge_ok (E,) the edges
    that address a slot)."""
    geo = edgewise.reproject(poses, patches, intrinsics, ii, jj, kk,
                             jacobian=True)
    rx = target[:, 0] - geo.center_x
    ry = target[:, 1] - geo.center_y
    in_bounds = ((geo.center_x > bounds[0]) & (geo.center_y > bounds[1])
                 & (geo.center_x < bounds[2]) & (geo.center_y < bounds[3]))
    gate = ((rx * rx + ry * ry < max_residual * max_residual)
            & in_bounds & (geo.valid > 0) & mask)

    def local(f):
        loc = f - t0
        return torch.where((f >= t0) & (f < t1) & (loc < window), loc,
                           torch.full_like(loc, -1))

    pk = kk - kbase
    slot_ok = (pk >= 0) & (pk < patch_slots)
    w = weight * (gate & slot_ok)[:, None].to(weight.dtype)
    pk_c = pk.clamp(0, patch_slots - 1)
    sys = assemble(geo.Ji, geo.Jj, geo.Jz, torch.stack([rx, ry], -1), w,
                   local(ii), local(jj), pk_c, window, patch_slots)
    return sys, pk_c, mask & slot_ok


def _depth_window(patches, kbase: int, patch_slots: int):
    """(first slot, PP) of the active patch slots' window in the flat
    (Mp, 3*P*P) table."""
    return (min(max(kbase, 0), patches.shape[0] - patch_slots),
            patches.shape[-1] // 3)


def gauss_newton_step(poses, patches, intrinsics, target, weight, lmbda,
                      ii, jj, kk, mask, t0: int, t1: int, kbase: int,
                      window: int, patch_slots: int, bounds,
                      max_residual: float, ep: float, lm: float,
                      structure_only: bool = False):
    """One Gauss-Newton iteration over the free poses [t0, t1) (at most
    `window` of them) and the patch slots [kbase, kbase + patch_slots).
    Updates poses and patches in place; returns the solver's ok flag."""
    sys, pk_c, edge_ok = _system(poses, patches, intrinsics, target, weight,
                                 ii, jj, kk, mask, t0, t1, kbase, window,
                                 patch_slots, bounds, max_residual)
    dX, dZ, ok = schur_solve(sys, lmbda, ep, lm, structure_only)

    # pose retraction (ba_cuda.cu:160-188): poses[t0 + i] <- Exp(dX_i) * pose
    nfree = min(max(t1 - t0, 0), window)
    if nfree:
        poses[t0:t0 + nfree] = se3.retr(poses[t0:t0 + nfree], dX[:nfree])

    # depth retraction and the inference clamp (ba_cuda.cu:191-211). The
    # clamp applies to every patch the solve addresses, even one whose edges
    # were all gated.
    kb, PP = _depth_window(patches, kbase, patch_slots)
    d_old = patches[kb:kb + patch_slots, 2 * PP:]
    d_new = d_old + dZ[:, None]
    d_new = torch.where(d_new > 20.0, torch.ones_like(d_new), d_new)
    d_new = d_new.clamp_min(1e-4)
    touched = torch.zeros(patch_slots, dtype=torch.bool, device=dZ.device)
    touched[pk_c[edge_ok]] = True
    patches[kb:kb + patch_slots, 2 * PP:] = torch.where(touched[:, None],
                                                        d_new, d_old)
    return ok


def gauss_newton_step_diff(poses, patches, intrinsics, target, weight, lmbda,
                           ii, jj, kk, mask, t0: int, t1: int, kbase: int,
                           window: int, patch_slots: int, bounds,
                           max_residual: float = 250.0, ep: float = 10.0,
                           lm: float = 1e-4, structure_only: bool = False):
    """The differentiable Gauss-Newton iteration of training (devo/ba.py:
    86-182; devo_tpu's gauss_newton_step with depth_clamp="training", as
    devo_tpu/train/forward.py:213-223 calls it, whose constants are the
    defaults here). It solves the same system as `gauss_newton_step` and
    returns new (poses, patches, ok) with no in-place write, so that
    autograd carries the gradient to target, weight, poses, patches and
    intrinsics. The depths of the whole window are clamped to [1e-3, 10]
    (devo/ba.py:176)."""
    sys, _, _ = _system(poses, patches, intrinsics, target, weight, ii, jj,
                        kk, mask, t0, t1, kbase, window, patch_slots, bounds,
                        max_residual)
    dX, dZ, ok = schur_solve(sys, lmbda, ep, lm, structure_only)

    nfree = min(max(t1 - t0, 0), window)
    if nfree:
        poses = torch.cat([poses[:t0],
                           se3.retr(poses[t0:t0 + nfree], dX[:nfree]),
                           poses[t0 + nfree:]])
    kb, PP = _depth_window(patches, kbase, patch_slots)
    win = patches[kb:kb + patch_slots]
    d_new = (win[:, 2 * PP:] + dZ[:, None]).clamp(1e-3, 10.0)
    patches = torch.cat([patches[:kb],
                         torch.cat([win[:, :2 * PP], d_new], dim=1),
                         patches[kb + patch_slots:]])
    return poses, patches, ok


def run_ba(poses, patches, intrinsics, target, weight, lmbda, ii, jj, kk,
           mask, t0: int, t1: int, kbase: int, window: int, patch_slots: int,
           bounds, iterations: int = 2, structure_only=None,
           max_residual: float = 128.0, ep: float = 1.0, lm: float = 1e-4):
    """Multi-iteration Gauss-Newton BA (ba_cuda.cu:461-537). The reference
    solves structure only when no pose is free (t1 - t0 == 0). Updates
    poses and patches in place and returns them."""
    if structure_only is None:
        structure_only = t1 - t0 == 0
    for _ in range(iterations):
        gauss_newton_step(poses, patches, intrinsics, target, weight, lmbda,
                          ii, jj, kk, mask, t0, t1, kbase, window,
                          patch_slots, bounds, max_residual, ep, lm,
                          structure_only=structure_only)
    return poses, patches
