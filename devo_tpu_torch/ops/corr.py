"""Edge-indexed sparse patch correlation, plain PyTorch (counterpart of
devo_tpu/ops/corr.py, after the reference's cuda_corr,
upstream DEVO's devo/altcorr/correlation_kernel.cu:83-232).

For every edge, the P x P patch feature gmap[kk] is dotted against the 8x8
integer-tap grid around each reprojected pixel in fmap[jj], then bilinearly
blended down to 7x7. The flat output order is [dx(7), dy(7), pi(P), pj(P)]
(+ level for the pyramid), the 2*49*P*P feature of the update operator.

This is the plain version of the CUDA kernel in csrc/corr.cu: the tests hold
it against the JAX package, and the kernel is held against it on the card.
`ops/corr_cuda.corr_pyramid` is the engine's entry point; it calls this
version only for tensors on the CPU.
"""
from __future__ import annotations

import torch

# calls of corr_pyramid, counted so a run can show which path it took
calls = 0


def corr(gmap: torch.Tensor, fmap: torch.Tensor, coords: torch.Tensor,
         kk: torch.Tensor, jj: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """One pyramid level.

    gmap (M, P, P, C) patch features; fmap (N, H, W, C) target frames;
    coords (E, P, P, 2) [x, y] at this level's resolution; kk, jj (E,)
    indices into gmap and fmap. Returns (E, (2r+1)^2 * P*P) f32. Products
    and sums are f32 whatever the feature dtype; one gather per tap keeps
    memory at one (E, P*P, C) slab.
    """
    N, H, W, C = fmap.shape
    E, P = coords.shape[0], coords.shape[1]
    PP = P * P
    D, d = 2 * radius + 2, 2 * radius + 1

    g = gmap[kk].reshape(E, PP, C).float()
    x = coords[..., 0].reshape(E, PP).float()
    y = coords[..., 1].reshape(E, PP).float()
    xf, yf = torch.floor(x), torch.floor(y)
    dx, dy = x - xf, y - yf
    x0, y0 = xf.long(), yf.long()
    flat = fmap.reshape(N * H * W, C)
    base = jj.long()[:, None] * (H * W)

    def tap(di: int, dj: int) -> torch.Tensor:
        iy = y0 + (di - radius)
        ix = x0 + (dj - radius)
        inb = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        idx = base + iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        s = (g * flat[idx].float()).sum(-1)                     # (E, PP)
        return torch.where(inb, s, torch.zeros_like(s))

    grid = [[tap(di, dj) for dj in range(D)] for di in range(D)]
    cols = []
    for djj in range(d):          # x offset outer: flat order [dx][dy][pixel]
        for dii in range(d):
            cols.append((1 - dx) * (1 - dy) * grid[dii][djj]
                        + dx * (1 - dy) * grid[dii][djj + 1]
                        + (1 - dx) * dy * grid[dii + 1][djj]
                        + dx * dy * grid[dii + 1][djj + 1])
    return torch.cat(cols, dim=-1)


def corr_pyramid(gmap: torch.Tensor, pyramid, coords: torch.Tensor,
                 kk: torch.Tensor, jj: torch.Tensor, radius: int = 3,
                 levels=(1, 4)) -> torch.Tensor:
    """Multi-level correlation. coords is at level-1 resolution; each level
    divides it by its stride. Returns (E, L*(2r+1)^2*P*P) f32 ordered
    [dx, dy, pixel, level]."""
    global calls
    calls += 1
    E = coords.shape[0]
    outs = [corr(gmap, fm, coords / lvl, kk, jj, radius)
            for fm, lvl in zip(pyramid, levels)]
    return torch.stack(outs, dim=-1).reshape(E, -1)
