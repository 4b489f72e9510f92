"""The bindings of the three probe kernels, built into ops/corr_cuda's one
library and counted in its `launches` registry:

- `band_ablate_cuda` (csrc/corr_band_ablate.cu, counter "corr_band_ablate"):
  the banded window ablation of scripts/bench_banded_ablate.py;
- `copy_probe_cuda` (csrc/copy_probe.cu, "copy_probe"): the copy-issue
  probe of scripts/probe_desc_wall.py, by cp.async or by bulk copies;
- `frame_probe_cuda` (csrc/corr_frame_probe.cu, "corr_frame_probe"): the
  one-frame window product of scripts/bench_gather.py.

Each takes the plain version (ops/probe.py) for tensors on the CPU and
launches its kernel for tensors on a CUDA device; there is no fallback from
one to the other. The shared memory plans (ring depth, copies in flight)
are checked on either device, so that a mode the card cannot hold is
refused everywhere.
"""
from __future__ import annotations

import torch

from . import corr_cuda as cc
from . import probe as plain

_C = 128                      # channels (bytes of an int8 row) of the probes
WINDOW_MAX_DEPTH = 4          # stages of the window kernels' ring
COPY_MAX_DEPTH = 4            # stages of the copy probe's ring
_COPY_STATIC = 64             # the copy probe's static shared memory (barriers)
_check = cc._check


def _tensors(named: dict, device):
    """Every tensor on `device` and contiguous."""
    for name, t in named.items():
        _check(t.device == device, f"{name} is not on {device}")
        _check(t.is_contiguous(), f"{name} is not contiguous")


def _typed(t, name: str, dtype, shape):
    _check(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    _check(tuple(t.shape) == tuple(shape),
           f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


def window_smem_bytes(depth: int) -> int:
    """Dynamic shared memory of a window-kernel block: `depth` stages of a
    (384, 128) bf16 window, the edge's 16 patch rows and its (384, 16)
    product surface as f32 (csrc/window_probe.cuh)."""
    return depth * plain.WR * _C * 2 + (plain.ROWS * _C + plain.WR * plain.ROWS) * 4


def window_depth() -> int:
    """Stages of the window kernels' ring: as many as a block's shared
    memory holds, at most WINDOW_MAX_DEPTH (two at C = 128)."""
    return max(d for d in range(2, WINDOW_MAX_DEPTH + 1)
               if window_smem_bytes(d) <= cc.SMEM_MAX)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def band_ablate_cuda(nlive, slot, band, y0, g, ry, rx, ring,
                     mode: str = "full") -> torch.Tensor:
    """Launch csrc/corr_band_ablate.cu: nlive (1,) int32 on the device;
    slot, band, y0 (E,) int32; g (E, 16, 128) bf16; ry, rx (E, 16) int32;
    ring (MEM, NBX, Hp, 24, 128) bf16. Returns (E, 8, 144) f32; the rows of
    blocks of BE edges at or past nlive are left unwritten. The plain
    version is ops/probe.band_ablate."""
    if mode not in plain.ABLATE_MODES:
        raise ValueError(f"mode must be one of {plain.ABLATE_MODES}, got {mode!r}")
    if g.device.type == "cpu":
        return plain.band_ablate(nlive, slot, band, y0, g, ry, rx, ring, mode)
    E = g.shape[0]
    _tensors(dict(nlive=nlive, slot=slot, band=band, y0=y0, g=g, ry=ry, rx=rx,
                  ring=ring), g.device)
    _typed(nlive, "nlive", torch.int32, (1,))
    for name, t in (("slot", slot), ("band", band), ("y0", y0)):
        _typed(t, name, torch.int32, (E,))
    _typed(g, "g", torch.bfloat16, (E, plain.ROWS, _C))
    _typed(ry, "ry", torch.int32, (E, plain.ROWS))
    _typed(rx, "rx", torch.int32, (E, plain.ROWS))
    _check(ring.dtype == torch.bfloat16 and ring.ndim == 5
           and tuple(ring.shape[3:]) == (plain.BWIN, _C),
           f"ring must be (MEM, NBX, Hp, {plain.BWIN}, {_C}) bf16, got "
           f"{tuple(ring.shape)} {ring.dtype}")
    _check(ring.shape[2] >= plain.WIN, "a band is shorter than a window")
    for name, t in (("ring", ring), ("g", g)):
        _check(t.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")
    out = torch.empty((E, 8, 16 * plain.PP), dtype=torch.float32, device=g.device)
    if E == 0:
        return out
    code = cc._load().devo_corr_band_ablate(
        nlive.data_ptr(), slot.data_ptr(), band.data_ptr(), y0.data_ptr(),
        g.data_ptr(), ry.data_ptr(), rx.data_ptr(), ring.data_ptr(),
        out.data_ptr(), E, ring.shape[1], ring.shape[2], plain.BE, window_depth(),
        plain.ABLATE_MODES.index(mode), _stream(g))
    cc._launched("corr_band_ablate", code)
    return out


FRAME_RUN = 64                # edges a corr_frame_probe block walks


def frame_probe_cuda(fmap, gm, y0, x08, ry, rx8,
                     extract: bool = True) -> torch.Tensor:
    """Launch csrc/corr_frame_probe.cu: fmap (Hp, Wp, 128) bf16; gm
    (E, 16, 128) bf16; y0, x08 (E, 1) int32; ry, rx8 (E, 16) int32. Returns
    (E, 8, 144) f32 with `extract`, else (E, 16, 144) f32. The plain version
    is ops/probe.frame_windows."""
    if gm.device.type == "cpu":
        return plain.frame_windows(fmap, gm, y0, x08, ry, rx8, extract)
    E = gm.shape[0]
    _tensors(dict(fmap=fmap, gm=gm, y0=y0, x08=x08, ry=ry, rx8=rx8), gm.device)
    _check(fmap.dtype == torch.bfloat16 and fmap.ndim == 3 and fmap.shape[2] == _C
           and fmap.shape[0] >= plain.WIN and fmap.shape[1] >= plain.BWIN,
           f"fmap must be (Hp, Wp, {_C}) bf16 holding a window, got "
           f"{tuple(fmap.shape)} {fmap.dtype}")
    _typed(gm, "gm", torch.bfloat16, (E, plain.ROWS, _C))
    for name, t in (("y0", y0), ("x08", x08)):
        _typed(t, name, torch.int32, (E, 1))
    for name, t in (("ry", ry), ("rx8", rx8)):
        _typed(t, name, torch.int32, (E, plain.ROWS))
    for name, t in (("fmap", fmap), ("gm", gm)):
        _check(t.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")
    out = torch.empty((E, 8 if extract else plain.WIN, 16 * plain.PP),
                      dtype=torch.float32, device=gm.device)
    if E == 0:
        return out
    code = cc._load().devo_corr_frame_probe(
        fmap.data_ptr(), gm.data_ptr(), y0.data_ptr(), x08.data_ptr(),
        ry.data_ptr(), rx8.data_ptr(), out.data_ptr(), E, fmap.shape[1],
        FRAME_RUN, window_depth(), int(extract), _stream(gm))
    cc._launched("corr_frame_probe", code)
    return out


ROUTES = ("cp.async", "bulk")


def copy_smem_bytes(mode: str, depth: int, colr: int = plain.COLR) -> int:
    """Dynamic shared memory of a copy-probe block: `depth` stages of one
    copy, and for "local" the resident column of `colr` rows."""
    S, M, _ = plain.copy_plan(mode)
    return (depth * S * M * plain.WR * _C
            + (colr * _C if mode == "local" else 0))


def copy_depth(mode: str, colr: int = plain.COLR):
    """(stages, rings) of the copy probe in `mode`: as many stages of one
    copy as a block's shared memory holds beside the column of "local", at
    most COPY_MAX_DEPTH, dealt to the mode's rings; every stage is in flight
    at once. Raises ValueError where not one stage a ring fits (tall8: a copy
    of 384 KB)."""
    S, M, ns = plain.copy_plan(mode)
    if mode == "local" and colr < plain.WR + 8:
        raise ValueError(f"local: a column of {colr} rows holds no window")
    room = cc.SMEM_MAX - _COPY_STATIC
    depth = COPY_MAX_DEPTH
    while depth and copy_smem_bytes(mode, depth, colr) > room:
        depth -= 1
    depth -= depth % ns
    if depth < 1:
        raise ValueError(
            f"{mode}: a copy of {S * M * plain.WR * _C} bytes "
            f"({S * M * plain.WR * _C // 1024} KB) times {ns} ring(s) does not "
            f"fit the {room} bytes of shared memory a block can stage")
    return depth, ns


def copy_probe_cuda(ring, slot, row0, mode: str = "single",
                    route: str = "cp.async", blocks: int = 1,
                    colr: int = plain.COLR) -> torch.Tensor:
    """Launch csrc/copy_probe.cu: ring (MEM, rows, 128) int8; slot, row0
    (n,) int32, one entry a copy (row0 a multiple of 8); `blocks` blocks
    take contiguous runs of the copies. Returns (1, 128) f32, exactly the
    plain version's (ops/probe.copy_probe)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    depth, ns = copy_depth(mode, colr)
    if ring.device.type == "cpu":
        return plain.copy_probe(ring, slot, row0, mode, colr)
    S, M, _ = plain.copy_plan(mode)
    n = slot.shape[0]
    _tensors(dict(ring=ring, slot=slot, row0=row0), ring.device)
    _check(ring.dtype == torch.int8 and ring.ndim == 3 and ring.shape[2] == _C,
           f"ring must be (MEM, rows, {_C}) int8, got {tuple(ring.shape)} "
           f"{ring.dtype}")
    _check(ring.shape[1] >= M * plain.WR + 8 and ring.shape[0] >= S,
           "the ring holds no copy")
    if mode == "local":
        _check(ring.shape[1] >= colr, f"the ring has fewer than {colr} rows")
    for name, t in (("slot", slot), ("row0", row0)):
        _typed(t, name, torch.int32, (n,))
    _check(ring.data_ptr() % 16 == 0, "ring is not 16-byte aligned")
    _check(blocks >= 1, "blocks must be at least 1")
    partial = torch.empty((blocks, _C), dtype=torch.float32, device=ring.device)
    out = torch.empty((1, _C), dtype=torch.float32, device=ring.device)
    code = cc._load().devo_copy_probe(
        ring.data_ptr(), slot.data_ptr(), row0.data_ptr(), partial.data_ptr(),
        out.data_ptr(), ring.shape[1] * _C, n, blocks, S, M, ns, depth,
        int(mode == "local"), colr, int(route == "bulk"), _stream(ring))
    cc._launched("copy_probe", code)
    return out
