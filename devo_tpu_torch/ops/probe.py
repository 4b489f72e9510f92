"""Plain PyTorch versions of the three probe kernels (ops/probe_cuda.py,
csrc/corr_band_ablate.cu, csrc/copy_probe.cu, csrc/corr_frame_probe.cu),
which the TPU-era probe scripts ran as Pallas kernels: the banded window
ablation (scripts/bench_banded_ablate.py), the copy-issue probe
(scripts/probe_desc_wall.py) and the one-frame window product
(scripts/bench_gather.py). The tests and chip_smoke.py hold the kernels
against these; the drivers (devo_tpu_torch/scripts/) take them only for
tensors on the CPU.

What the window kernels compute: an edge's window W is 16 rows x 24 columns
of feature vectors, viewed as (384, C); R = W . g^T (384, 16) f32 against
the edge's 16 patch rows, and S = R viewed as (16, 24, 16). The extraction
reads pixel p's 8x16 strip out[r, 16p + c] = S[ry_p + r, 8 rx_p + c, p] for
the first PP = 9 pixels; a strip that reaches past the window's 16 rows or
24 columns reads 0 there (the TPU kernel read unwritten scratch, which is
undefined).
"""
from __future__ import annotations

import torch

WIN = 16                # window rows
BWIN = 24               # window columns (a band's width)
WR = WIN * BWIN         # window positions, 384
PP = 9                  # pixels a strip is read for
ROWS = 16               # patch rows a window is multiplied with
BE = 64                 # edges of the banded ablation's live gate
PAD = 12                # zero border of the banded layout
STAGGER = 3             # rows between slots of the banded layout
ABLATE_MODES = ("full", "noext", "nomm", "noDMA")
COPY_MODES = ("single", "dual", "quad", "pair", "tall2", "tall4", "tall8",
              "local")
COLR = 1024             # rows of the resident column of the "local" mode


def banded_shape(H: int, W: int, pad: int = PAD):
    """(rows, Hp) of the banded layout of an H x W frame: the flattened rows
    of one slot (stagger included) and the height of a band (devo_tpu's
    ops/corr_pallas.banded_shape)."""
    Hp, Wp = H + 2 * pad, W + 2 * pad
    Wp_b = ((max(Wp - BWIN, 0) + 7) // 8) * 8 + BWIN
    nbx = (Wp_b - BWIN) // 8 + 1
    return nbx * Hp + STAGGER, Hp


def _products(windows: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """R (E, 384, 16) f32 of windows (E, 384, C) and g (E, 16, C)."""
    return torch.einsum("ekc,epc->ekp", windows.float(), g.float())


def extract_strips(R: torch.Tensor, ry: torch.Tensor, rx: torch.Tensor):
    """(E, 8, 16 * PP) f32: out[e, r, 16p + c] = S[e, ry + r, 8 rx + c, p]
    with S = R viewed as (E, 16, 24, 16), 0 where the strip leaves S."""
    E = R.shape[0]
    dev = R.device
    S = R.reshape(E, WIN, BWIN, ROWS)
    rows = ry[:, :PP, None, None].long() + torch.arange(8, device=dev)[:, None]
    cols = 8 * rx[:, :PP, None, None].long() + torch.arange(16, device=dev)
    inside = (rows < WIN) & (cols < BWIN)
    e = torch.arange(E, device=dev)[:, None, None, None]
    p = torch.arange(PP, device=dev)[None, :, None, None]
    val = S[e, rows.clamp(max=WIN - 1), cols.clamp(max=BWIN - 1), p]
    val = torch.where(inside, val, torch.zeros((), device=dev))
    return val.permute(0, 2, 1, 3).reshape(E, 8, 16 * PP)


def band_ablate(nlive, slot, band, y0, g, ry, rx, ring, mode: str = "full"):
    """The banded window ablation (K13, scripts/bench_banded_ablate.py:27):
    nlive (1,) int32; slot, band, y0 (E,) int32; g (E, 16, C) bf16; ry
    (E, 16) int32 in [0, 8); rx (E, 16) int32 in [0, 3); ring (MEM, NBX, Hp,
    24, C) bf16. Edge e's window is ring[slot, band, y0:y0+16]. Returns
    (E, 8, 144) f32:
      full   the strips of S (extract_strips);
      noext  out[e, r, 16p + c] = R[e, 8p + r, c];
      nomm   out[e, r, :] = concat(W[r, :128], W[r, :16]) (C = 128);
      noDMA  0: the product and extraction of a window never copied, which
             the kernel zeroes once.
    Only blocks of BE edges whose first edge lies below nlive are computed;
    the kernel leaves the rows of the others unwritten, and here they are
    0."""
    if mode not in ABLATE_MODES:
        raise ValueError(f"mode must be one of {ABLATE_MODES}, got {mode!r}")
    E = g.shape[0]
    dev = g.device
    out = torch.zeros((E, 8, 16 * PP), dtype=torch.float32, device=dev)
    live = min(E, -(-int(nlive.reshape(-1)[0]) // BE) * BE)
    if live <= 0 or mode == "noDMA":
        return out
    sl, bd, y = slot[:live].long(), band[:live].long(), y0[:live].long()
    yy = y[:, None] + torch.arange(WIN, device=dev)
    W = ring[sl[:, None], bd[:, None], yy].reshape(live, WR, ring.shape[-1])
    if mode == "nomm":
        out[:live] = torch.cat([W[:, :8, :128], W[:, :8, :16]], -1).float()
        return out
    R = _products(W, g[:live])
    if mode == "noext":
        out[:live] = (R[:, :8 * PP].reshape(live, PP, 8, ROWS)
                      .permute(0, 2, 1, 3).reshape(live, 8, 16 * PP))
    else:
        out[:live] = extract_strips(R, ry[:live], rx[:live])
    return out


def frame_windows(fmap, gm, y0, x08, ry, rx8, extract: bool = True):
    """The one-frame window product (K15, scripts/bench_gather.py:75): fmap
    (Hp, Wp, C) bf16; gm (E, 16, C) bf16; y0, x08 (E, 1) int32; ry (E, 16)
    int32 in [0, 9); rx8 (E, 16) int32 in {0, 1}. Edge e's window is
    fmap[y0:y0+16, 8 x08 : 8 x08 + 24]. Returns with `extract` the strips
    (E, 8, 144) f32, else (E, 16, 144) f32 with out[e, y, j] =
    S[e, y, j // 16, j % 16]."""
    E = gm.shape[0]
    dev = gm.device
    yy = y0.long().reshape(E, 1, 1) + torch.arange(WIN, device=dev)[:, None]
    xx = 8 * x08.long().reshape(E, 1, 1) + torch.arange(BWIN, device=dev)
    W = fmap[yy, xx].reshape(E, WR, fmap.shape[-1])
    R = _products(W, gm)
    if extract:
        return extract_strips(R, ry, rx8)
    return R.reshape(E, WIN, BWIN * ROWS)[:, :, :16 * PP].contiguous()


def copy_plan(mode: str):
    """(S, M, NS) of a copy-probe mode, as scripts/probe_desc_wall.py:49-63
    sets them: S slots a copy spans, M windows of WR rows a copy, NS
    independent rings the copies go to in turn."""
    if mode in ("single", "local"):
        return 1, 1, 1
    if mode == "dual":
        return 1, 1, 2
    if mode == "quad":
        return 1, 1, 4
    if mode == "pair":
        return 2, 1, 1
    if mode.startswith("tall") and mode[4:].isdigit() and int(mode[4:]) > 0:
        return 1, int(mode[4:]), 1
    raise ValueError(f"unknown copy mode {mode!r} (one of {COPY_MODES})")


def copy_count(mode: str, nd: int) -> int:
    """Copies a mode makes for nd window-sized descriptors: nd / 2 two-slot
    copies for "pair", nd / M for "tallM", else nd."""
    S, M, _ = copy_plan(mode)
    return nd // (S * M)


def copy_probe(ring, slot, row0, mode: str = "single", colr: int = COLR):
    """The copy-issue probe (K14, scripts/probe_desc_wall.py:75-151): ring
    (MEM, rows, C) int8; slot, row0 (n,) int32, one entry a copy, row0 a
    multiple of 8. Returns (1, C) f32, the sum over copies of the first row
    each copy lands: ring[slot, row0] (+ ring[slot + 1, row0] for "pair",
    whose copies span two slots), or for "local", which copies out of a
    column of `colr` rows of slot 0 held on chip, ring[0, min(row0,
    colr - 392) & ~7]. The values are integers and the sums stay below
    2^24, so every order of addition gives the same result."""
    S, _, _ = copy_plan(mode)
    sl, r0 = slot.long(), row0.long()
    if mode == "local":
        r0 = torch.clamp(r0, max=colr - WR - 8) & ~7
        rows = ring[0, r0]
    else:
        rows = ring[sl, r0]
        if S == 2:
            rows = torch.cat([rows, ring[sl + 1, r0]])
    return rows.float().sum(0, keepdim=True)
