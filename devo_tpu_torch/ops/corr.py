"""Edge-indexed sparse patch correlation, plain PyTorch (counterpart of
devo_tpu/ops/corr.py, after the reference's cuda_corr,
upstream DEVO's devo/altcorr/correlation_kernel.cu:83-232).

For every edge, the P x P patch feature gmap[kk] is dotted against the 8x8
integer-tap grid around each reprojected pixel in fmap[jj], then bilinearly
blended down to 7x7. The flat output order is [dx(7), dy(7), pi(P), pj(P)]
(+ level for the pyramid), the 2*49*P*P feature of the update operator.

A feature ring may be int8 (`quantize_frame`, one scale per frame): the taps
are then taken over the integer values and the ring slot's scale multiplies
the result, which is exact because the correlation is linear in the frame
features.

These are the plain versions of the CUDA kernels: `corr_pyramid` of
csrc/corr.cu, csrc/corr_pair.cu and csrc/corr_pair2.cu (both levels: the
kernels "mono", "pair" and "pair2" compute one function), `corr_level` of
csrc/corr_level.cu and csrc/corr_level_resident.cu (one level). The tests
hold them against the JAX package, and the kernels are held against them on
the card.
`ops/corr_cuda.corr_pyramid` is the engine's entry point; it calls these
versions only for tensors on the CPU.
"""
from __future__ import annotations

import torch

# calls of corr_pyramid and corr_level, counted so a run can show which path
# it took
calls = 0


def quantize_frame(fmap: torch.Tensor):
    """(..., H, W, C) feature frames -> (q int8 of the same shape, scale f32
    (...)): the per-frame int8 quantisation of the feature rings, s =
    max|f| / 127 (1 for an all-zero frame) and q = clip(round(f / s), -127,
    127). One frame gives a 0-d scale; a whole ring (N, H, W, C) gives (N,)
    scales, each frame on its own."""
    f = fmap.float()
    s = f.abs().amax(dim=(-3, -2, -1)) / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(f / s[..., None, None, None]), -127, 127)
    return q.to(torch.int8), s


def corr(gmap: torch.Tensor, fmap: torch.Tensor, coords: torch.Tensor,
         kk: torch.Tensor, jj: torch.Tensor, radius: int = 3,
         scale: torch.Tensor = None) -> torch.Tensor:
    """One pyramid level.

    gmap (M, P, P, C) patch features; fmap (N, H, W, C) target frames;
    coords (E, P, P, 2) [x, y] at this level's resolution; kk, jj (E,)
    indices into gmap and fmap; scale (N,) f32, one per frame, with an int8
    fmap. Returns (E, (2r+1)^2 * P*P) f32. Products and sums are f32
    whatever the feature dtype; one gather per tap keeps memory at one
    (E, P*P, C) slab.
    """
    if (fmap.dtype == torch.int8) != (scale is not None):
        raise ValueError("an int8 ring, and only an int8 ring, takes a scale")
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
    out = torch.cat(cols, dim=-1)
    if scale is not None:
        out = out * scale.float()[jj.long()][:, None]
    return out


def corr_level(gmap: torch.Tensor, fmap: torch.Tensor, coords: torch.Tensor,
               kk: torch.Tensor, jj: torch.Tensor,
               scale: torch.Tensor = None) -> torch.Tensor:
    """One pyramid level at radius 3, (E, 49*P*P) f32 in [dx, dy, pixel]
    order: the contract of the per-level kernels. coords is already at this
    level's resolution."""
    global calls
    calls += 1
    return corr(gmap, fmap, coords, kk, jj, 3, scale)


def stack_levels(outs) -> torch.Tensor:
    """Per-level (E, F) features -> (E, F*L) in [dx, dy, pixel, level]
    order."""
    return torch.stack(list(outs), dim=-1).flatten(1)


def corr_pyramid(gmap: torch.Tensor, pyramid, coords: torch.Tensor,
                 kk: torch.Tensor, jj: torch.Tensor, radius: int = 3,
                 levels=(1, 4), scales=None) -> torch.Tensor:
    """Multi-level correlation: the plain version of the two-level kernels
    (csrc/corr.cu, csrc/corr_pair.cu, csrc/corr_pair2.cu). coords is at
    level-1 resolution; each level divides it by its stride. scales: per level a (N,) f32 tensor for an
    int8 ring (None for a float ring), or None when no ring is int8.
    Returns (E, L*(2r+1)^2*P*P) f32 ordered [dx, dy, pixel, level]."""
    global calls
    calls += 1
    if scales is None:
        scales = (None,) * len(pyramid)
    return stack_levels([corr(gmap, fm, coords / lvl, kk, jj, radius, sc)
                         for fm, lvl, sc in zip(pyramid, levels, scales)])
