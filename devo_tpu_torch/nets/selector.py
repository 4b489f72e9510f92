"""Patch selection strategies (counterpart of devo_tpu/nets/selector.py,
after upstream DEVO's devo/selector.py).

All functions take a score map batch (n, h, w) and return integer pixel
coords (x, y), each (n, ppi). Sampling without replacement is Gumbel top-k
and the within-window draw is a Gumbel-max categorical; the Gumbel noise
comes from a `torch.Generator` the caller passes, or is injected through
`noise` (tests hand both packages the same draws).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

KERNEL = 4
GRID = 2


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise from `generator` (-log(-log(u)), u in (0, 1))."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp(torch.finfo(u.dtype).tiny, 1.0)
    return -torch.log(-torch.log(u))


def _pad_amounts(h: int, w: int, use_grid: bool):
    factor = GRID * KERNEL if use_grid else KERNEL
    ph = (factor - h % factor) % factor
    pw = (factor - w % factor) % factor
    return ph // 2, ph - ph // 2, pw // 2, pw - pw // 2


def _pad(scores, use_grid):
    n, h, w = scores.shape
    top, bottom, left, right = _pad_amounts(h, w, use_grid)
    return F.pad(scores, (left, right, top, bottom)), top, left


def _quads(a: torch.Tensor) -> torch.Tensor:
    """(n, h1, w1) -> (n, 4, h2*w2) quadrants [TL, TR, BL, BR]."""
    n, h1, w1 = a.shape
    h2, w2 = h1 // GRID, w1 // GRID
    return torch.stack([a[:, :h2, :w2], a[:, :h2, w2:],
                        a[:, h2:, :w2], a[:, h2:, w2:]], 1).reshape(n, 4, h2 * w2)


def _quad_cells(idx_q, h1, w1, ppi):
    """Quadrant-local top-k indices (n, 4, ppi/4) -> interleaved cell coords
    (n, ppi) in the order selector.py:130 flattens them."""
    n = idx_q.shape[0]
    h2, w2 = h1 // GRID, w1 // GRID
    dx = torch.tensor([0, w2, 0, w2], device=idx_q.device)[None, :, None]
    dy = torch.tensor([0, 0, h2, h2], device=idx_q.device)[None, :, None]
    cell_x = (idx_q % w2 + dx).transpose(1, 2).reshape(n, ppi)
    cell_y = (idx_q // w2 + dy).transpose(1, 2).reshape(n, ppi)
    return cell_x, cell_y


def _window_gather(s_padded, idx_flat):
    """The 4x4 unfold(padding=1) window of each pooled cell: rows
    4cy-1..4cy+2, cols 4cx-1..4cx+2. Returns (n, k, 16)."""
    n, hp, wp = s_padded.shape
    w1 = wp // KERNEL
    cy, cx = idx_flat // w1, idx_flat % w1
    o = torch.arange(KERNEL, device=s_padded.device)
    ry = cy[..., None] * KERNEL - 1 + o.repeat_interleave(KERNEL)[None, None]
    rx = cx[..., None] * KERNEL - 1 + o.repeat(KERNEL)[None, None]
    inb = (ry >= 0) & (ry < hp) & (rx >= 0) & (rx < wp)
    flat = ry.clamp(0, hp - 1) * wp + rx.clamp(0, wp - 1)
    vals = s_padded.reshape(n, -1).gather(1, flat.reshape(n, -1)).reshape(ry.shape)
    return torch.where(inb, vals, torch.zeros_like(vals))


def select_multi(scores: torch.Tensor, ppi: int, generator=None,
                 use_grid: bool = True, noise=None):
    """Avg-pooled multinomial sampling (selector.py:107-150). `noise` =
    (cell Gumbels, offset Gumbels) replaces the draws from `generator`."""
    n, h, w = scores.shape
    s, top, left = _pad(scores, use_grid)
    hp, wp = s.shape[1:]
    h1, w1 = hp // KERNEL, wp // KERNEL
    avg = s.reshape(n, h1, KERNEL, w1, KERNEL).mean((2, 4))

    def draw(i, shape):
        if noise is not None:
            return noise[i].to(s.device)
        return gumbel(shape, generator, s.device)

    if use_grid:
        quads = _quads(avg) + 1e-7
        logw = torch.log(quads.clamp_min(1e-30))
        idx_q = torch.topk(logw + draw(0, quads.shape), ppi // 4, dim=-1).indices
        cell_x, cell_y = _quad_cells(idx_q, h1, w1, ppi)
        idx_full = cell_y * w1 + cell_x
    else:
        wts = avg.reshape(n, -1) + 1e-7
        logw = torch.log(wts.clamp_min(1e-30))
        idx_full = torch.topk(logw + draw(0, wts.shape), ppi, dim=-1).indices
        cell_x, cell_y = idx_full % w1, idx_full // w1

    windows = _window_gather(s, idx_full) + 1e-7                 # (n, ppi, 16)
    off = torch.argmax(torch.log(windows) + draw(1, windows.shape), dim=-1)
    x = KERNEL * cell_x + off % KERNEL
    y = KERNEL * cell_y + off // KERNEL
    return (x - left).clamp(0, w - 1), (y - top).clamp(0, h - 1)


def _block_max(scores, use_grid):
    n, h, w = scores.shape
    s, top, left = _pad(scores, use_grid)
    hp, wp = s.shape[1:]
    h1, w1 = hp // KERNEL, wp // KERNEL
    blocks = s.reshape(n, h1, KERNEL, w1, KERNEL).permute(0, 1, 3, 2, 4)
    blocks = blocks.reshape(n, h1, w1, KERNEL * KERNEL)
    return blocks.amax(-1), blocks.argmax(-1), top, left


def _top_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest entries of each row, in descending
    order, the lower index first among equal values (lax.top_k's order).
    torch.topk leaves the order of equal values to the device; a stable
    sort gives the same picks on every device, as where an event-gradient
    map has cells of equal (zero) gradient."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def select_topk(scores: torch.Tensor, ppi: int, use_grid: bool = True):
    """Pooled top-k sampling (selector.py:152-192)."""
    n, h, w = scores.shape
    max_scores, max_idx, top, left = _block_max(scores, use_grid)
    h1, w1 = max_scores.shape[1:]
    if use_grid:
        idx_q = _top_indices(_quads(max_scores), ppi // 4)
        cell_x, cell_y = _quad_cells(idx_q, h1, w1, ppi)
        idx_full = cell_y * w1 + cell_x
    else:
        idx_full = _top_indices(max_scores.reshape(n, -1), ppi)
        cell_x, cell_y = idx_full % w1, idx_full // w1
    off = max_idx.reshape(n, -1).gather(1, idx_full)
    x = KERNEL * cell_x + off % KERNEL
    y = KERNEL * cell_y + off // KERNEL
    return (x - left).clamp(0, w - 1), (y - top).clamp(0, h - 1)


def select_nms(scores: torch.Tensor, ppi: int, use_grid: bool = False):
    """Pooled NMS sampling (selector.py:194-254): greedy argmax over the
    pooled peaks, each pick suppressing its 4-neighborhood (what IoU 0.4
    does to 3-px boxes)."""
    n, h, w = scores.shape
    sc, max_idx, top, left = _block_max(scores, use_grid)
    h1, w1 = sc.shape[1:]
    dev = scores.device
    gy = torch.arange(h1, device=dev)[None, :, None]
    gx = torch.arange(w1, device=dev)[None, None, :]
    py = (gy * KERNEL + max_idx // KERNEL).reshape(n, -1)
    px = (gx * KERNEL + max_idx % KERNEL).reshape(n, -1)
    sc = sc.clone()
    xs, ys = [], []
    for _ in range(ppi):
        pick = sc.reshape(n, -1).argmax(-1)                       # (n,)
        xs.append(px.gather(1, pick[:, None])[:, 0])
        ys.append(py.gather(1, pick[:, None])[:, 0])
        cy, cx = pick // w1, pick % w1
        dist = (gy - cy[:, None, None]).abs() + (gx - cx[:, None, None]).abs()
        sc = sc.masked_fill(dist <= 1, float("-inf"))
    x = torch.stack(xs, 1)
    y = torch.stack(ys, 1)
    return (x - left).clamp(0, w - 1), (y - top).clamp(0, h - 1)


def gather_scores(scores: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Score values at integer coords."""
    n, h, w = scores.shape
    idx = y.clamp(0, h - 1) * w + x.clamp(0, w - 1)
    return scores.reshape(n, -1).gather(1, idx)


def select_random(n: int, h: int, w: int, ppi: int,
                  generator: torch.Generator, device=None):
    """Uniform random selection in [1, w-2] x [1, h-2] (enet.py:144-147)."""
    x = torch.randint(1, w - 1, (n, ppi), generator=generator, device=device)
    y = torch.randint(1, h - 1, (n, ppi), generator=generator, device=device)
    return x, y


def event_gradient(voxels: torch.Tensor) -> torch.Tensor:
    """Event-gradient selection map (enet.py:115-121): the voxel bins
    summed, the finite-difference gradient magnitude, a 4x4 average pool
    with avg_pool2d's floor semantics (trailing rows and columns dropped).

    voxels (n, H, W, bins) -> (n, (H-1)//4, (W-1)//4). Both sums add in a
    fixed order, bin after bin and a block's pixels row by row, the order
    of devo_tpu's reductions on the CPU, so that the map is its bit for
    bit."""
    v = voxels.float()
    im = v[..., 0]
    for b in range(1, v.shape[-1]):
        im = im + v[..., b]                               # (n, H, W)
    dx = im[:, :-1, 1:] - im[:, :-1, :-1]
    dy = im[:, 1:, :-1] - im[:, :-1, :-1]
    # the square root in f64, rounded once: a correctly rounded f32 root
    # (torch's vectorised f32 root on the CPU is not)
    g = torch.sqrt((dx * dx + dy * dy).double()).float()  # (n, H-1, W-1)
    n, gh, gw = g.shape
    h4, w4 = gh // 4, gw // 4
    blocks = g[:, :h4 * 4, :w4 * 4].reshape(n, h4, 4, w4, 4)
    acc = blocks[:, :, 0, :, 0]
    for k in range(1, 16):
        acc = acc + blocks[:, :, k // 4, :, k % 4]
    return acc / 16.0


def _candidates(candidates, generator, n: int, k: int, x_high: int,
                y_high: int, device):
    """k uniform candidates (x, y), each (n, k), in [0, x_high) x [0,
    y_high): drawn from `generator`, or `candidates` itself, or what the
    callable `candidates(n, k, x_high, y_high)` returns (the trainer's
    draws, which know no map shape)."""
    if candidates is None:
        return tuple(torch.randint(0, hi, (n, k), generator=generator,
                                   device=device) for hi in (x_high, y_high))
    if callable(candidates):
        return candidates(n, k, x_high, y_high)
    return candidates


def _top_candidates(scores, x, y, ppi: int):
    """The ppi candidates of the largest score, in descending order, the
    lower candidate index first among equal scores (lax.top_k's order)."""
    sc = gather_scores(scores, x, y)
    order = _top_indices(sc, ppi)
    return x.gather(1, order), y.gather(1, order), sc.gather(1, order)


def select_3xrandom(weights: torch.Tensor, ppi: int, generator=None,
                    candidates=None):
    """PatchSelector('3xrandom') (selector.py:92-105): 3*ppi uniform
    candidates over the whole map, the ppi of the largest weight kept, +1 on
    the returned coords; the gradient selector's training draw
    (enet.py:135-137). `candidates` = (x, y), each (n, 3*ppi), or a
    callable that returns them (`_candidates`), replaces the draw from
    `generator`."""
    n, h, w = weights.shape
    candidates = _candidates(candidates, generator, n, 3 * ppi, w, h,
                             weights.device)
    x, y, _ = _top_candidates(weights, *candidates, ppi)
    return x + 1, y + 1


def select_training_scorer(scores: torch.Tensor, ppi: int, generator=None,
                           candidates=None):
    """Training-time scorer selection (enet.py:152-164): 3*ppi candidates
    in [0, w-3] x [0, h-3], the ppi highest-scoring kept (the reference
    sorts ascending and takes the tail). Returns the coords (+1) and their
    scores. `candidates` as for select_3xrandom."""
    n, h, w = scores.shape
    candidates = _candidates(candidates, generator, n, 3 * ppi, w - 2, h - 2,
                             scores.device)
    x, y, s = _top_candidates(scores, *candidates, ppi)
    return x + 1, y + 1, s
