"""Patch extraction (gather + bilinear), counterpart of
devo_tpu/ops/patchify.py (after the reference's cuda_corr.patchify). Feature
maps are channels-last: fmap (N, H, W, C)."""
from __future__ import annotations

import torch


def extract_patches(fmap: torch.Tensor, coords: torch.Tensor,
                    radius: int) -> torch.Tensor:
    """Bilinearly extract (2r+1)x(2r+1) patches at fractional coords.

    fmap (N, H, W, C); coords (N, M, 2) [x, y]. Returns (N, M, 2r+1, 2r+1, C);
    out-of-bounds taps read as 0.
    """
    N, H, W, C = fmap.shape
    M = coords.shape[1]
    D = 2 * radius + 2
    x, y = coords[..., 0], coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0).to(fmap.dtype)[..., None, None, None]
    dy = (y - y0).to(fmap.dtype)[..., None, None, None]
    x0, y0 = x0.long(), y0.long()

    off = torch.arange(D, device=fmap.device) - radius
    iy = (y0[..., None, None] + off[:, None]).expand(N, M, D, D)
    ix = (x0[..., None, None] + off[None, :]).expand(N, M, D, D)
    inb = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    n_idx = torch.arange(N, device=fmap.device)[:, None, None, None]
    grid = fmap[n_idx, iy.clamp(0, H - 1), ix.clamp(0, W - 1)]   # (N,M,D,D,C)
    grid = torch.where(inb[..., None], grid, torch.zeros_like(grid))

    d = 2 * radius + 1
    return ((1 - dy) * (1 - dx) * grid[:, :, :d, :d]
            + (1 - dy) * dx * grid[:, :, :d, 1:]
            + dy * (1 - dx) * grid[:, :, 1:, :d]
            + dy * dx * grid[:, :, 1:, 1:])


def coords_grid_with_index(disps: torch.Tensor) -> torch.Tensor:
    """Per-frame (x, y, disp) grids: (N, H, W) -> (N, H, W, 3)."""
    N, H, W = disps.shape
    x = torch.arange(W, dtype=disps.dtype, device=disps.device)
    y = torch.arange(H, dtype=disps.dtype, device=disps.device)
    xg = x[None, None, :].expand(N, H, W)
    yg = y[None, :, None].expand(N, H, W)
    return torch.stack([xg, yg, disps], dim=-1)
