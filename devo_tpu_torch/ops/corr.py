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
csrc/corr.cu, csrc/corr_pair.cu, csrc/corr_pair2.cu, csrc/corr_mono2.cu and
csrc/corr_mono3.cu (both levels: the kernels "mono", "pair", "pair2",
"mono2", "mono4" and "mono3" compute one function), `corr_level` of
csrc/corr_level.cu, csrc/corr_level_pipe.cu and csrc/corr_level_resident.cu
(one level), `corr_level_group` of csrc/corr_group.cu (one level whose
products pass through a bf16 surface, the kernel "g8c": `group_surface`,
the plain version of the kernel's surface instance, then
`extract_blend_group`, the TPU's stage 2, which the kernel fuses and which
runs on the CPU alone). `corr_level` is also the
plain version of csrc/corr_fixed.cu (CORR_IMPL="pallas"), csrc/corr_group8.cu
("g8") and csrc/corr_level_full.cu ("full"), and `corr_level_stage` that of
the latter's stage instances, which time its copy, product and extraction
apart. The tests hold them against the JAX package, and the kernels are held
against them on the card. `ops/corr_cuda.corr_pyramid` is the engine's entry
point; it calls these versions only for tensors on the CPU.

`corr_pyramid_train` is the training correlation: the plain function as an
autograd.Function whose backward keeps a Bernoulli subset of the edges and
gives the coordinates no gradient, on either device.

Two implementation families of the engine are tensor code on either device,
with no kernel: `corr_pyramid_gather` (CORR_IMPL="gather": the coordinates
and the bilinear weights in the features' type) and `corr_pyramid_window`
(CORR_IMPL="window": products over one fixed 16x24 window an edge, taps
clamped into it).
"""
from __future__ import annotations

import torch

from devo_tpu_torch.utils.timing import span

# calls of corr_pyramid, corr_level and group_surface, of extract_blend_group
# and of the two tensor paths, counted so a run can show which path it took
calls = 0
extract_calls = 0
gather_calls = 0
window_calls = 0

GROUP_EDGES = 8       # edges that share one block of surface rows
GROUP_LANES = 16      # lanes of an edge in a surface row (P*P used)
GROUP_ROWS = 144      # rows of a group's surface: window positions


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
    return _corr(gmap, fmap, coords, kk, jj, radius, scale)


def _corr(gmap, fmap, coords, kk, jj, radius=3, scale=None, frac_dtype=None):
    """`corr`, with the fractional parts of the coordinates, the bilinear
    weights, rounded to `frac_dtype` first where it is given."""
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
    if frac_dtype is not None:
        dx, dy = dx.to(frac_dtype).float(), dy.to(frac_dtype).float()
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
    (csrc/corr.cu, csrc/corr_pair.cu, csrc/corr_pair2.cu, csrc/corr_mono2.cu,
    csrc/corr_mono3.cu). coords is at level-1 resolution; each level divides
    it by its stride. scales: per level a (N,) f32 tensor for an int8 ring
    (None for a float ring), or None when no ring is int8.
    Returns (E, L*(2r+1)^2*P*P) f32 ordered [dx, dy, pixel, level]."""
    global calls
    calls += 1
    if scales is None:
        scales = (None,) * len(pyramid)
    return stack_levels([corr(gmap, fm, coords / lvl, kk, jj, radius, sc)
                         for fm, lvl, sc in zip(pyramid, levels, scales)])


def _pyramid(gmap, pyramid, coords, kk, jj, radius, levels):
    """corr_pyramid on float rings, uncounted: the function that
    corr_pyramid_train's forward and backward compute."""
    return stack_levels([corr(gmap, fm, coords / lvl, kk, jj, radius)
                         for fm, lvl in zip(pyramid, levels)])


class _CorrPyramidTrain(torch.autograd.Function):
    """The forward of `_pyramid`; the backward carries the gradient of the
    kept edges alone to gmap and the pyramid, none to the coordinates."""

    @staticmethod
    def forward(ctx, gmap, coords, kk, jj, keep, radius, levels, *pyramid):
        ctx.save_for_backward(gmap, coords, kk, jj, keep, *pyramid)
        ctx.radius, ctx.levels = radius, levels
        return _pyramid(gmap, pyramid, coords, kk, jj, radius, levels)

    @staticmethod
    @span("train.corr.bwd")
    def backward(ctx, grad):
        gmap, coords, kk, jj, keep, *pyramid = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (gmap, *pyramid)]
            out = _pyramid(leaves[0], leaves[1:], coords.detach(), kk, jj,
                           ctx.radius, ctx.levels)
            grads = torch.autograd.grad(
                out, leaves, grad * keep[:, None].to(grad.dtype),
                allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, leaves)]
        return (grads[0], torch.zeros_like(coords), None, None, None, None,
                None, *grads[1:])


def corr_pyramid_train(gmap: torch.Tensor, pyramid, coords: torch.Tensor,
                       kk: torch.Tensor, jj: torch.Tensor,
                       generator: torch.Generator = None,
                       dropout: float = 0.2, radius: int = 3, levels=(1, 4),
                       keep: torch.Tensor = None) -> torch.Tensor:
    """corr_pyramid with the reference's training backward (counterpart of
    devo_tpu/ops/corr.py:230-294; upstream DEVO's
    devo/altcorr/correlation.py:18-30, dropout 0.2 at enet.py:204), on
    float rings, on either device:

      * the forward is corr_pyramid's plain function;
      * the backward keeps a Bernoulli(dropout) subset of the edges: a
        dropped edge adds no gradient to gmap or the pyramid, and the kept
        ones are not rescaled (the expected gradient is dropout x full);
      * the coordinates get a zero gradient (the CUDA backward returns
        None for them).

    The keep mask (E,) bool is drawn as devo_tpu draws it, uniform < dropout,
    from `generator`, or passed in as `keep` (the tests pass devo_tpu's).
    dropout >= 1 keeps every edge, and the coordinate path stays severed."""
    E = coords.shape[0]
    if keep is None:
        if dropout is None or dropout >= 1.0:
            keep = torch.ones(E, dtype=torch.bool, device=coords.device)
        else:
            keep = torch.rand(E, generator=generator,
                              device=coords.device) < dropout
    return _CorrPyramidTrain.apply(gmap, coords, kk, jj, keep, radius,
                                   tuple(levels), *pyramid)


def _group_index(coords: torch.Tensor, cap: int):
    """What both stages of the grouped correlation know of every edge from
    its coordinates alone: the pixels' floors x0, y0 (E, PP) int64, the
    covering window's origin wx0, wy0 and width ww (E, 1), and `wide` (E, 1):
    the window has more than `cap` positions, so the edge's surface rows hold
    its 8x8 taps instead of its window."""
    E, PP = coords.shape[0], coords.shape[1] * coords.shape[2]
    x0 = torch.floor(coords[..., 0].reshape(E, PP).float()).clamp(-1e6, 1e6).long()
    y0 = torch.floor(coords[..., 1].reshape(E, PP).float()).clamp(-1e6, 1e6).long()
    wx0 = x0.amin(1, keepdim=True) - 3
    wy0 = y0.amin(1, keepdim=True) - 3
    ww = x0.amax(1, keepdim=True) - x0.amin(1, keepdim=True) + 8
    wh = y0.amax(1, keepdim=True) - y0.amin(1, keepdim=True) + 8
    return x0, y0, wx0, wy0, ww, ww * wh > cap


def group_surface(gmap: torch.Tensor, fmap: torch.Tensor, coords: torch.Tensor,
                  kk: torch.Tensor, jj: torch.Tensor,
                  cap: int = GROUP_ROWS) -> torch.Tensor:
    """Stage 1 of the grouped correlation, the plain version of
    csrc/corr_group.cu's surface instance: the raw product surface (ceil(E / 8), GROUP_ROWS, 128)
    bf16 of one level, lane 16 * j + p = edge j of the group, pixel p.

    Row r * ww + c of an edge holds bf16(<gmap[kk][p], fmap[jj, wy0 + r, wx0
    + c]>) over the edge's covering window (the union of its pixels' 8x8 tap
    grids: origin the least floor - 3, extent the floors' spread + 8), f32
    sums rounded once to bf16, 0 off the image; an int8 fmap enters as its
    integer values (its scale is applied after extraction). An edge whose
    window has more than `cap` positions holds its taps instead: row
    di * 8 + dj = bf16(<gmap[kk][p], fmap[jj, y0[p] + di - 3, x0[p] + dj -
    3]>). Rows and lanes that `extract_blend_group` does not read are zero
    here and unwritten by the kernel. coords is at this level's resolution.
    """
    global calls
    calls += 1
    N, H, W, C = fmap.shape
    E, P = coords.shape[0], coords.shape[1]
    PP = P * P
    G = -(-E // GROUP_EDGES)
    surf = torch.zeros((G * GROUP_EDGES, GROUP_ROWS, GROUP_LANES),
                       dtype=torch.bfloat16, device=gmap.device)
    if E:
        x0, y0, wx0, wy0, ww, wide = _group_index(coords, cap)
        g = gmap[kk.long()].reshape(E, PP, C).float()
        flat = fmap.reshape(N * H * W, C)
        base = jj.long()[:, None] * (H * W)
        for row in range(GROUP_ROWS):
            # the ring position of this row, per pixel: the window's, or the
            # pixel's own tap for an edge that holds taps
            iy = torch.where(wide, y0 + (row // 8 - 3), wy0 + row // ww)
            ix = torch.where(wide, x0 + (row % 8 - 3), wx0 + row % ww)
            inb = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
            idx = base + iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
            dots = (g * flat[idx].float()).sum(-1)                  # (E, PP)
            surf[:E, row, :PP] = torch.where(inb, dots, torch.zeros_like(dots)
                                             ).to(torch.bfloat16)
    return (surf.reshape(G, GROUP_EDGES, GROUP_ROWS, GROUP_LANES)
            .transpose(1, 2).reshape(G, GROUP_ROWS, GROUP_EDGES * GROUP_LANES)
            .contiguous())


def extract_blend_group(surface: torch.Tensor, coords: torch.Tensor,
                        jj: torch.Tensor, hw, scale: torch.Tensor = None,
                        cap: int = GROUP_ROWS) -> torch.Tensor:
    """Stage 2 of the grouped correlation (counterpart of devo_tpu's
    extract_blend_g8; csrc/corr_group.cu fuses it, so the engine calls it on
    the CPU alone): every pixel's 8x8 taps from the surface of
    `group_surface` or of the kernel's surface instance, 0 off the
    (H, W) = hw image, times the ring slot's scale (int8 rings), blended to
    7x7. Returns
    (E, 49*P*P) f32 in [dx, dy, pixel] order. `cap` is the one stage 1
    was given."""
    global extract_calls
    extract_calls += 1
    H, W = hw
    E, P = coords.shape[0], coords.shape[1]
    PP = P * P
    rows = surface.shape[1]
    x0, y0, wx0, wy0, ww, wide = _group_index(coords, cap)
    x = coords[..., 0].reshape(E, PP, 1, 1).float()
    y = coords[..., 1].reshape(E, PP, 1, 1).float()
    fx, fy = x - torch.floor(x), y - torch.floor(y)
    d = torch.arange(8, device=coords.device)
    iy = (y0[:, :, None, None] + d[:, None] - 3).expand(E, PP, 8, 8)
    ix = (x0[:, :, None, None] + d[None, :] - 3).expand(E, PP, 8, 8)
    inb = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    row = torch.where(wide[:, :, None, None], (d[:, None] * 8 + d[None, :]),
                      (iy - wy0[:, :, None, None]) * ww[:, :, None, None]
                      + (ix - wx0[:, :, None, None]))
    e = torch.arange(E, device=coords.device)[:, None, None, None]
    lane = ((e % GROUP_EDGES) * GROUP_LANES
            + torch.arange(PP, device=coords.device)[None, :, None, None])
    at = ((e // GROUP_EDGES) * rows + row) * (GROUP_EDGES * GROUP_LANES) + lane
    taps = surface.reshape(-1)[at].float()                 # (E, PP, 8, 8)
    taps = torch.where(inb, taps, torch.zeros_like(taps))
    if scale is not None:
        taps = taps * scale.float()[jj.long()][:, None, None, None]
    out = ((1 - fx) * (1 - fy) * taps[:, :, :7, :7]
           + fx * (1 - fy) * taps[:, :, :7, 1:]
           + (1 - fx) * fy * taps[:, :, 1:, :7]
           + fx * fy * taps[:, :, 1:, 1:])                 # (E, PP, dy, dx)
    return out.permute(0, 3, 2, 1).reshape(E, 49 * PP)


def corr_level_group(gmap: torch.Tensor, fmap: torch.Tensor,
                     coords: torch.Tensor, kk: torch.Tensor, jj: torch.Tensor,
                     scale: torch.Tensor = None) -> torch.Tensor:
    """One pyramid level at radius 3 through the bf16 product surface: the
    two stages composed, the plain version of csrc/corr_group.cu ("g8c"). It is
    `corr_level` with every integer tap rounded to bf16 before the scale and
    the blend."""
    if (fmap.dtype == torch.int8) != (scale is not None):
        raise ValueError("an int8 ring, and only an int8 ring, takes a scale")
    surface = group_surface(gmap, fmap, coords, kk, jj)
    return extract_blend_group(surface, coords, jj, fmap.shape[1:3], scale)


def corr_pyramid_gather(gmap: torch.Tensor, pyramid, coords: torch.Tensor,
                        kk: torch.Tensor, jj: torch.Tensor, radius: int = 3,
                        levels=(1, 4)) -> torch.Tensor:
    """The correlation of CORR_IMPL="gather", as devo_tpu's engine calls its
    corr_ops.corr_pyramid (engine.py:414-417, corr.py:61-62): the
    coordinates are cast to the patch features' type before each level
    divides them, and every level's bilinear weights are rounded to its
    ring's type. Under mixed precision both are bf16, a coarser function
    than `corr_pyramid` (level-1 coordinates beyond 128 step by a whole
    pixel); with f32 features it is `corr_pyramid`. Float rings only.
    Tensor code on either device. Returns (E, L*(2r+1)^2*P*P) f32 in
    [dx, dy, pixel, level] order."""
    global gather_calls
    gather_calls += 1
    c = coords.to(gmap.dtype)
    return stack_levels([_corr(gmap, fm, c / lvl, kk, jj, radius,
                               frac_dtype=fm.dtype)
                         for fm, lvl in zip(pyramid, levels)])


WIN, WINX, WPAD = 16, 24, 12    # the fixed window: rows, columns, border
WINDOW_CHUNK = 1024             # edges whose windows are gathered at once


def corr_window(gmap: torch.Tensor, fmap: torch.Tensor, coords: torch.Tensor,
                kk: torch.Tensor, jj: torch.Tensor) -> torch.Tensor:
    """One level of CORR_IMPL="window", devo_tpu's corr_window with
    blend_strips (corr.py:95-202) as tensor code on either device: every
    edge's fixed window against its patch's pixels in one batched product
    (16 rows x 24 columns, zero off the image, placed as devo_tpu places it,
    corr.py:134-141: the origin at the least tap corner, clamped into the
    ring bordered by 12, x aligned down to 8), each pixel's 8x8 taps taken
    from that surface by indexing, blended to 7x7. A pixel whose taps leave
    the window (a patch spread beyond 8 px, or coordinates far off the
    image) has its tap origin clamped into it, as devo_tpu's does: this
    path keeps that clamp, so it is `corr_level` only where every pixel's
    taps lie in the window. Float rings; products and sums f32. coords is at
    this level's resolution. Returns (E, 49*P*P) f32 in [dx, dy, pixel]
    order."""
    N, H, W, C = fmap.shape
    E, P = coords.shape[0], coords.shape[1]
    PP = P * P
    x = coords[..., 0].reshape(E, PP).float()
    y = coords[..., 1].reshape(E, PP).float()
    xf, yf = torch.floor(x), torch.floor(y)
    fx, fy = x - xf, y - yf
    x0, y0 = xf.clamp(-1e6, 1e6).long(), yf.clamp(-1e6, 1e6).long()
    # the window's origin in ring coordinates (negative inside the border)
    wx0 = (x0.amin(1) - 3 + WPAD).clamp(0, W + 2 * WPAD - WINX) // 8 * 8 - WPAD
    wy0 = (y0.amin(1) - 3 + WPAD).clamp(0, H + 2 * WPAD - WIN) - WPAD
    rx = (x0 - 3 - wx0[:, None]).clamp(0, WINX - 9)
    ry = (y0 - 3 - wy0[:, None]).clamp(0, WIN - 8)
    flat = fmap.reshape(N * H * W, C)
    d = torch.arange(8, device=coords.device)
    rows = torch.arange(WIN, device=coords.device)[:, None]
    cols = torch.arange(WINX, device=coords.device)[None, :]
    taps = []
    for a in range(0, E, WINDOW_CHUNK):
        b = min(a + WINDOW_CHUNK, E)
        iy = wy0[a:b, None, None] + rows                    # (e, 16, 1)
        ix = wx0[a:b, None, None] + cols                    # (e, 1, 24)
        inb = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        idx = (jj[a:b].long()[:, None, None] * (H * W)
               + iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1))
        win = torch.where(inb[..., None], flat[idx].float(), 0.0)
        g = gmap[kk[a:b].long()].reshape(b - a, PP, C).float()
        surf = torch.bmm(g, win.reshape(b - a, WIN * WINX, C).transpose(1, 2))
        at = (((ry[a:b, :, None, None] + d[:, None]) * WINX
               + rx[a:b, :, None, None] + d[None, :])
              + torch.arange(PP, device=coords.device)[:, None, None]
              * (WIN * WINX))                                # (e, PP, 8, 8)
        taps.append(surf.reshape(b - a, -1).gather(
            1, at.reshape(b - a, -1)).reshape(b - a, PP, 8, 8))
    taps = torch.cat(taps) if taps else coords.new_zeros((0, PP, 8, 8))
    fyb, fxb = fy[:, :, None, None], fx[:, :, None, None]
    Y = (1 - fyb) * taps[:, :, :7] + fyb * taps[:, :, 1:]   # (E, PP, dy, 8)
    out = (1 - fxb) * Y[..., :7] + fxb * Y[..., 1:]         # (E, PP, dy, dx)
    return out.permute(0, 3, 2, 1).reshape(E, 49 * PP)


def corr_pyramid_window(gmap: torch.Tensor, pyramid, coords: torch.Tensor,
                        kk: torch.Tensor, jj: torch.Tensor,
                        levels=(1, 4)) -> torch.Tensor:
    """The correlation of CORR_IMPL="window": `corr_window` a level, coords
    at level-1 resolution divided by each level's stride. Returns
    (E, L*49*P*P) f32 in [dx, dy, pixel, level] order."""
    global window_calls
    window_calls += 1
    return stack_levels([corr_window(gmap, fm, coords / lvl, kk, jj)
                         for fm, lvl in zip(pyramid, levels)])


STAGES = ("full", "noext", "nomm", "noDMA")


def corr_level_stage(gmap: torch.Tensor, fmap: torch.Tensor,
                     coords: torch.Tensor, kk: torch.Tensor, jj: torch.Tensor,
                     stage: str, cap: int) -> torch.Tensor:
    """What a stage instance of csrc/corr_level_full.cu writes, (E, 49*P*P)
    f32, for a float ring and the window capacity `cap` the kernel was
    launched with. The kernel stages an edge's covering window (the union of
    its pixels' 8x8 tap grids, see `_group_index`) where it has at most
    `cap` positions, else reads that edge's taps from the ring. Stages:

    - "full": the correlation, `corr_level`;
    - "noext" (no extraction): row i of a staged edge is its product
      surface at window position i // P*P (row-major), pixel i % P*P, 0
      beyond the window or off the image; an edge not staged is 0;
    - "nomm" (no product): `corr_level` with pixel p's patch feature
      replaced by the unit vector of channel p % C, so that every tap is one
      ring value;
    - "noDMA" (no copy): a staged edge reads a zeroed window and is 0; an
      edge not staged is `corr_level`.

    Only "full" is a correlation; the others exist to time the kernel's
    stages and are defined here so that the kernel can be held to them."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    if fmap.dtype == torch.int8:
        raise ValueError("the stages take float rings")
    if stage == "full":
        return corr_level(gmap, fmap, coords, kk, jj)
    N, H, W, C = fmap.shape
    E, P = coords.shape[0], coords.shape[1]
    PP = P * P
    x0, y0, wx0, wy0, ww, wide = _group_index(coords, cap)
    if stage == "noDMA":
        return torch.where(wide, corr(gmap, fmap, coords, kk, jj), 0.0)
    if stage == "nomm":
        unit = torch.zeros((1, PP, C), device=gmap.device)
        unit[0, torch.arange(PP), torch.arange(PP) % C] = 1.0
        return corr(unit.reshape(1, P, P, C), fmap, coords,
                    torch.zeros_like(kk), jj)
    wh = y0.amax(1, keepdim=True) - y0.amin(1, keepdim=True) + 8
    g = gmap[kk.long()].reshape(E, PP, C).float()
    flat = fmap.reshape(N * H * W, C)
    at = torch.arange(49, device=gmap.device).expand(E, 49)  # window position
    iy, ix = wy0 + at // ww, wx0 + at % ww
    ok = ((at < ww * wh) & ~wide & (iy >= 0) & (iy < H) & (ix >= 0)
          & (ix < W))
    idx = (jj.long()[:, None] * (H * W) + iy.clamp(0, H - 1) * W
           + ix.clamp(0, W - 1))
    rows = flat[idx]                                       # (E, 49, C)
    out = torch.stack([(g[:, p, None, :] * rows.float()).sum(-1)
                       for p in range(PP)], -1)            # (E, 49, PP)
    return torch.where(ok[..., None], out, 0.0).reshape(E, 49 * PP)
