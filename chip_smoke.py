"""Smoke run of devo_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

1. Prints the card (`nvidia-smi` name and power limit) and the torch / CUDA
   versions.
2. Builds the correlation kernels (csrc/*.cu for sm_90a, one nvcc process a
   file, all at once, then one link) into devo_tpu_torch/_build/ and prints
   ptxas's register report.
3. Kernel phase: every kernel against its plain PyTorch version on the card,
   at the tracking step's shapes (E = 12288 edges, E = 96 for the motion
   probe, a ragged odd E = 5003, E = 0; C = 128, mem = 32, rings of 120x160
   and 30x40, coordinates partly off the image): the six two-level kernels
   (corr_pyramid, corr_pair, corr_pair2, corr_mono2 with and without its
   gathering copy, corr_mono3) on bf16 and on int8 rings, the per-level
   kernels (corr_level, corr_level_pipe, corr_group) on both levels and
   both ring types, the resident level-4 kernel on int8 rings, and the
   per-level kernels that take float rings only (corr_fixed for
   CORR_IMPL="pallas", corr_group8 for "g8", corr_level_full for "full") on
   both levels, on bf16 and f32 rings; corr_level_full's stage instances
   (no extraction, no product, no copy) against their plain versions and
   timed beside it at E = 12288; every kernel
   choice of the entry point against corr_pyramid's kernel (both must floor
   the same coordinates); the kernels with staged windows at a narrow width
   (C = 8) whose int8 feature vectors are too short for the 16-byte copies,
   so that every tap reads the ring directly, and on patches distorted
   beyond the staged window. corr_group's products pass through a bf16
   surface: it is held against its own plain version, which rounds at the
   same place, within one bf16 ulp of the largest product, and against the
   unrounded correlation within half an ulp. Max error against the stated
   tolerance, the median time of each, and the kernel's bound: the least
   time the card could take, the larger of the bytes it must move (the ring
   positions its taps touch, the distinct patch features, coordinates,
   indices, scales and the output, each once; for corr_group also its
   surface, written and read) over 3.35 TB/s and its operations over 989
   TFLOP/s (67 TFLOP/s, the f32 rate outside the tensor cores, on f32
   rings).
   Probe phase: the three probe kernels (ops/probe_cuda.py) against their
   plain versions (ops/probe.py) at their drivers' shapes, each timed beside
   its bound: the banded window ablation (corr_band_ablate, E = 15360 of
   which 6144 live, a 623 MB bf16 band ring) in its four modes and six index
   layouts within TOL on the live blocks, the copy probe (copy_probe, 9600
   window copies of an int8 band ring) in seven modes on both copy routes,
   on one block and one block an SM, exactly, and its refusal of tall8, and
   the one-frame window product (corr_frame_probe, E = 15360) with and
   without extraction within TOL. Then every driver of
   devo_tpu_torch/scripts/ but profile_step runs once through its main(),
   at its full repeat counts or fewer where those would not fit, its output
   under chiprun_out/probes/; each must launch the kernels it names and no
   other, and its launches are those the JSON record counts for the probe
   kernels.
4. Reference phase: the port's DEVO on the card against the same engine on
   the CPU (plain correlation; the CPU tests hold that path against the JAX
   package) at a small f32 size, for unquantised rings on every kernel
   choice and family (CORR_IMPL "pallas", "window", "gather") and for the
   int8 configurations: the same keyframes, culls and edge sets per frame,
   and poses and terminate() output within the stated tolerance.
   Determinism phase: BA's system (ops/ba.assemble) at E = 12288 on the
   card assembled twice from the same inputs, bitwise equal, and timed
   beside the index_add_ sums it replaced; then the i8-mono and bf16-gather
   paths of phase 5, each run twice (48 frames, 12 updates, terminate())
   from a fresh engine with the same seed: the live edge table (ii, jj, kk),
   the patches, the keyframe poses and terminate()'s output compared as
   bytes.
5. Slice phase: the port's DEVO at full width (480x640, 96 patches, mixed
   precision) with seeded random weights over frames of a sliding event
   texture, then 12 update() calls and terminate(), on three paths of 48
   timed frames each, so that their frame rates compare: the bf16 path (the
   two-level kernel on bf16 rings), the default path (int8 rings, the
   two-level kernel), five bf16 paths of the other configurations
   (CORR_IMPL="pallas" on corr_fixed, "g8" on corr_group8, "full" on
   corr_level_full, and "window" and "gather", which launch no kernel and
   take their own tensor path) and, after the eval phase, the quantised
   split path
   (int8 rings, one launch per level, level 4 from the resident ring),
   which then runs 8 more frames under torch.profiler (where the time
   goes, by engine phase). The launch counts are set to 0 just
   before each path and read just after it. Each path must end with a
   finite trajectory with one pose per frame, at least one keyframe cull,
   launches > 0 of the kernels it names and of no other, no plain-correlation
   call, and rings of the type its configuration implies; then its kernels
   (a tensor path: itself on the CPU) are held against the plain versions
   once more on the engine's own final edges and rings.
6. Eval phase: the evaluation entry point at full width.
   devo_tpu_torch.eval.harness.evaluate_sequence with EVAL_CONFIGS["eds"]
   (bf16 rings) and CORR_KERNEL="pair", then with int8 rings and
   CORR_KERNEL="pair2", then with CORR_IMPL="pallas" (bf16 rings,
   corr_fixed): random weights from seed 0, an in-memory iterator
   of 48 frames of the same texture with intrinsics and timestamps, a
   straight-line ground truth, two trials on one cached engine, TUM dumps
   and a results JSON under chiprun_out/. It must hold one engine per
   configuration, as many poses from trial 0 as from a fresh engine, finite
   ATE / MPE / R_rmse that the independent ATE cross-check confirms, the
   artifacts on disk, one launch of the configuration's kernel per
   correlation of the run (two for corr_fixed, one a level) and no
   plain-correlation call. Under random
   weights the ATE says nothing about accuracy.
7. Bench phase: the bench entry point at full width,
   devo_tpu_torch.bench.run: the saturated 12288-edge point with the default
   kernel at the bench's full length (12 windows of 28 frames after the
   warm-up has brought the live edge count to the cap), then with each of
   CORR_KERNEL = split2, g8c, mono2, mono4, mono3 at 4 windows of 28 after
   the same warm-up rule, then the no-cull maximum-load point with the
   default kernel. Each prints the bench's JSON line and must reach its
   operating point, end with a finite pose per frame, and show launches > 0
   of the kernel it names, of no other, and no plain-correlation call. The
   profiled path of phase 5 runs after this one, and after it the
   profile_step driver, last.
8. Prints the kernels' JSON record (all fifteen kernels; the probe kernels'
   launches are their drivers'), the card line, and as its last line
   {"ok": true, "device": {...}}.

With no CUDA device it exits non-zero before any result. Any failed build,
launch or check raises and exits non-zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HT, WD = 480, 640
N_FRAMES = 48                      # timed frames of every path
N_PROFILED = 8                     # then frames under torch.profiler
N_UPDATES = 12
SKIP = 16                          # frames/s leave out initialization and
                                   # the first culls
TOL = dict(atol=1e-3, rtol=1e-4)   # f32 sums of the same products, in
                                   # another order
PEAK_BYTES_S = 3.35e12             # H100 SXM device memory
PEAK_FLOP_S = 989e12               # H100 SXM dense bf16
PEAK_F32_FLOP_S = 67e12            # H100 SXM f32 outside the tensor cores
E_MAIN = 12288

# name -> (source, TPU kernel replaced, kernel function in a profile)
KERNELS = {
    "corr_pyramid": ("devo_tpu_torch/csrc/corr.cu",
                     "devo_tpu/ops/corr_pallas.py:1553", "corr_pyramid_kernel"),
    "corr_level": ("devo_tpu_torch/csrc/corr_level.cu",
                   "devo_tpu/ops/corr_pallas.py:356", "corr_level_kernel"),
    "corr_level_resident": ("devo_tpu_torch/csrc/corr_level_resident.cu",
                            "devo_tpu/ops/corr_pallas.py:1042",
                            "corr_level_resident_kernel"),
    "corr_pair": ("devo_tpu_torch/csrc/corr_pair.cu",
                  "devo_tpu/ops/corr_pallas.py:1225", "corr_pair_kernel"),
    "corr_pair2": ("devo_tpu_torch/csrc/corr_pair2.cu",
                   "devo_tpu/ops/corr_pallas.py:1433", "corr_pair2_kernel"),
    "corr_level_pipe": ("devo_tpu_torch/csrc/corr_level_pipe.cu",
                        "devo_tpu/ops/corr_pallas.py:441",
                        "corr_level_pipe_kernel"),
    "corr_group": ("devo_tpu_torch/csrc/corr_group.cu",
                   "devo_tpu/ops/corr_pallas.py:614", "corr_group_kernel"),
    "corr_mono2": ("devo_tpu_torch/csrc/corr_mono2.cu",
                   "devo_tpu/ops/corr_pallas.py:1618", "corr_mono2_kernel"),
    "corr_mono3": ("devo_tpu_torch/csrc/corr_mono3.cu",
                   "devo_tpu/ops/corr_pallas.py:1736", "corr_mono3_kernel"),
    "corr_fixed": ("devo_tpu_torch/csrc/corr_fixed.cu",
                   "devo_tpu/ops/corr_pallas.py:63", "corr_fixed_kernel"),
    "corr_group8": ("devo_tpu_torch/csrc/corr_group8.cu",
                    "devo_tpu/ops/corr_pallas.py:549", "corr_group8_kernel"),
    "corr_level_full": ("devo_tpu_torch/csrc/corr_level_full.cu",
                        "devo_tpu/ops/corr_pallas.py:289",
                        "corr_level_full_kernel"),
    "corr_band_ablate": ("devo_tpu_torch/csrc/corr_band_ablate.cu",
                         "scripts/bench_banded_ablate.py:27", "window_kernel"),
    "copy_probe": ("devo_tpu_torch/csrc/copy_probe.cu",
                   "scripts/probe_desc_wall.py:110", "copy_probe_kernel"),
    "corr_frame_probe": ("devo_tpu_torch/csrc/corr_frame_probe.cu",
                         "scripts/bench_gather.py:75", "window_kernel"),
}
# the kernels that take float rings only, one level a launch: the entry
# point's (impl, kernel) that reaches each
FLOAT_LEVEL = {"corr_fixed": ("pallas", "mono"), "corr_group8": ("banded", "g8"),
               "corr_level_full": ("banded", "full")}
# the paths of the slice phase: VOConfig overrides and the kernels each must
# launch ("window" and "gather" launch none and take their own tensor path).
# "pallas", "window" and "gather" keep the default CORR_RING_I8, which only
# "banded" reads: their rings must come out bf16. The profiled path runs
# last, so that no path is timed in a process that torch.profiler has
# already traced (its tracing may stay attached and cost the host time at
# every later launch).
PATHS = {
    "bf16-mono": (dict(CORR_RING_I8=False, CORR_KERNEL="mono",
                       CORR_L4_RESIDENT="off"), ("corr_pyramid",)),
    "i8-mono": (dict(CORR_RING_I8=True, CORR_KERNEL="mono",
                     CORR_L4_RESIDENT="off"), ("corr_pyramid",)),
    "bf16-pallas": (dict(CORR_IMPL="pallas"), ("corr_fixed",)),
    "bf16-g8": (dict(CORR_RING_I8=False, CORR_KERNEL="g8"), ("corr_group8",)),
    "bf16-full": (dict(CORR_RING_I8=False, CORR_KERNEL="full"),
                  ("corr_level_full",)),
    "bf16-window": (dict(CORR_IMPL="window"), ()),
    "bf16-gather": (dict(CORR_IMPL="gather"), ()),
    "i8-split-resident": (dict(CORR_RING_I8=True, CORR_KERNEL="split",
                               CORR_L4_RESIDENT="auto"),
                          ("corr_level", "corr_level_resident")),
}
# the counters of ops/corr.py that each family's correlation adds to on the
# card: the tensor paths their own, every kernel none
TENSOR_PATH = {"window": "window_calls", "gather": "gather_calls"}
PROFILED = "i8-split-resident"
# the two configurations of the eval phase, on EVAL_CONFIGS["eds"]: VOConfig
# overrides and the kernel each must launch
EVAL_PATHS = {
    "eval-eds-bf16-pair": (dict(CORR_KERNEL="pair"), "corr_pair"),
    "eval-eds-i8-pair2": (dict(CORR_KERNEL="pair2", CORR_RING_I8=True),
                          "corr_pair2"),
    "eval-eds-bf16-pallas": (dict(CORR_IMPL="pallas"), "corr_fixed"),
}
EVAL_TRIALS = 2
OUT_DIR = "chiprun_out/eval_smoke"
# the runs of the bench phase: VOConfig overrides, whether the run has the
# bench's full length (else 4 windows of 28 frames), the kernel it must
# launch
BENCH_PATHS = {
    "bench-12288-mono": (dict(), True, "corr_pyramid"),
    "bench-12288-split2": (dict(CORR_KERNEL="split2"), False, "corr_level_pipe"),
    "bench-12288-g8c": (dict(CORR_KERNEL="g8c"), False, "corr_group"),
    "bench-12288-mono2": (dict(CORR_KERNEL="mono2"), False, "corr_mono2"),
    "bench-12288-mono4": (dict(CORR_KERNEL="mono4"), False, "corr_mono2"),
    "bench-12288-mono3": (dict(CORR_KERNEL="mono3"), False, "corr_mono3"),
    "bench-maxload-mono": (dict(KEYFRAME_THRESH=-1.0), True, "corr_pyramid"),
}
BENCH_SHORT = dict(n_bench=112, windows=4)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, launches: int = 10, repeats: int = 5) -> float:
    """Median over `repeats` of the mean time of `launches` back-to-back
    calls between two CUDA events (one warm-up call first)."""
    fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def corr_case(E: int, dev, seed: int, C: int = None):
    """Random rings and patch-grid coordinates at the step's shapes (C
    channels, the model's DIM_FNET unless given); patch centers reach 8 px
    past the level-1 image on every side. Returns (gmap, bf16 pyramid, int8
    pyramid, scales, coords, kk, jj)."""
    from devo_tpu_torch.ops.corr import quantize_frame
    from devo_tpu_torch.runtime.config import VOConfig
    cfg = VOConfig()
    g = torch.Generator(device=dev).manual_seed(seed)
    h1, w1, mem, M = HT // 4, WD // 4, cfg.MEM, cfg.M
    C = cfg.DIM_FNET if C is None else C
    bf = torch.bfloat16
    gmap = torch.randn((mem * M, 3, 3, C), generator=g, device=dev).to(bf)
    fmap1 = torch.randn((mem, h1, w1, C), generator=g, device=dev)
    fmap2 = torch.randn((mem, h1 // 4, w1 // 4, C), generator=g, device=dev)
    cx = torch.rand((E, 1, 1), generator=g, device=dev) * (w1 + 16) - 8
    cy = torch.rand((E, 1, 1), generator=g, device=dev) * (h1 + 16) - 8
    off = torch.arange(-1.0, 2.0, device=dev)
    coords = torch.stack([(cx + off[None, None, :]).expand(E, 3, 3),
                          (cy + off[None, :, None]).expand(E, 3, 3)], -1)
    coords = coords + 0.3 * torch.randn(coords.shape, generator=g, device=dev)
    # some coordinates on the integer grid, also after the division by 4
    coords[::11] = torch.round(coords[::11] / 4) * 4
    kk = torch.randint(0, mem * M, (E,), generator=g, device=dev, dtype=torch.int32)
    jj = torch.randint(0, mem, (E,), generator=g, device=dev, dtype=torch.int32)
    (q1, s1), (q2, s2) = quantize_frame(fmap1), quantize_frame(fmap2)
    return (gmap, (fmap1.to(bf), fmap2.to(bf)), (q1, q2), (s1, s2),
            coords.contiguous(), kk, jj)


def level_work(fmap, coords, jj):
    """What one level of the correlation needs of its ring on these inputs:
    (bytes of the distinct ring positions its taps touch, in-bounds taps)."""
    mem, h, w, C = fmap.shape
    E = coords.shape[0]
    d = torch.arange(-3, 5, device=coords.device)
    x0 = torch.floor(coords[..., 0]).reshape(E, -1, 1).clamp(-1e6, 1e6).long()
    y0 = torch.floor(coords[..., 1]).reshape(E, -1, 1).clamp(-1e6, 1e6).long()
    ix = (x0 + d)[:, :, None, :]                     # (E, PP, 1, 8)
    iy = (y0 + d)[:, :, :, None]                     # (E, PP, 8, 1)
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    lin = (jj.long()[:, None, None, None] * (h * w)
           + iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1))
    touched = torch.zeros(mem * h * w, dtype=torch.bool, device=coords.device)
    touched[lin[inb]] = True
    return int(touched.sum()) * C * fmap.element_size(), int(inb.sum())


def surface_bytes(coords):
    """Bytes of corr_group's surface that one level's correlation of these
    coordinates (at the level's resolution) writes and reads back: 32 bytes a
    written row (an edge's window positions, or its 64 taps where the window
    is beyond the surface's rows), and 2 bytes a pixel of them read."""
    from devo_tpu_torch.ops import corr as plain
    _, y0, _, _, ww, wide = plain._group_index(coords, plain.GROUP_ROWS)
    wh = y0.amax(1, keepdim=True) - y0.amin(1, keepdim=True) + 8
    rows = int(torch.where(wide, torch.full_like(ww, 64), ww * wh).sum())
    return rows * (2 * plain.GROUP_LANES + 2 * y0.shape[1])


def bound_ms(gmap, rings, strides, scales, coords, kk, jj, surface=False):
    """The least time the card could take for the correlation of these
    inputs over `rings` (one per level, coords divided by its stride): the
    larger of bytes / 3.35 TB/s and operations / 989 TFLOP/s (bf16 and int8
    rings), 67 TFLOP/s (f32 rings). `surface`: the function also writes and
    reads corr_group's surface. Returns (ms, "bytes" or "operations")."""
    E, P = coords.shape[0], coords.shape[1]
    C = gmap.shape[-1]
    n_out = E * 49 * P * P * len(rings)
    nbytes = (int(torch.unique(kk).numel()) * P * P * C * gmap.element_size()
              + coords.numel() * 4 + kk.numel() * 4 + jj.numel() * 4
              + n_out * 4)
    flops = 8 * n_out                                # the bilinear blend
    for ring, stride, scale in zip(rings, strides, scales):
        ring_bytes, taps = level_work(ring, coords / stride, jj)
        nbytes += ring_bytes + (scale.numel() * 4 if scale is not None else 0)
        if surface:
            nbytes += surface_bytes(coords / stride)
        flops += 2 * C * taps
    peak = PEAK_F32_FLOP_S if rings[0].dtype == torch.float32 else PEAK_FLOP_S
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def variants(case):
    """Every (kernel name, label, kernel call, plain call, bound arguments)
    measured on one case. corr_group's plain version is corr_level_group."""
    from devo_tpu_torch.ops import corr as plain
    from devo_tpu_torch.ops import corr_cuda as cc
    gmap, bf, i8, sc, coords, kk, jj = case
    c4 = coords / 4
    out = []
    for label, pyr, scales in (("bf16", bf, None), ("i8", i8, sc)):
        ss = scales or (None, None)
        out.append(("corr_pyramid", f"both levels {label}",
                    lambda pyr=pyr, scales=scales: cc.corr_pyramid_cuda(
                        gmap, pyr[0], pyr[1], coords, kk, jj, scales=scales),
                    lambda pyr=pyr, scales=scales: plain.corr_pyramid(
                        gmap, pyr, coords, kk, jj, scales=scales),
                    (pyr, (1, 4), ss)))
        for name, what, fn in (
                ("corr_pair", "", cc.corr_pair_cuda),
                ("corr_pair2", "", cc.corr_pair2_cuda),
                ("corr_mono2", " gathered", cc.corr_mono2_cuda),
                ("corr_mono2", " in place",
                 lambda *a, **k: cc.corr_mono2_cuda(*a, concat=False, **k)),
                ("corr_mono3", "", cc.corr_mono3_cuda)):
            out.append((name, f"both levels {label}{what}",
                        lambda fn=fn, pyr=pyr, scales=scales: fn(
                            gmap, pyr[0], pyr[1], coords, kk, jj, scales=scales),
                        lambda pyr=pyr, scales=scales: plain.corr_pyramid(
                            gmap, pyr, coords, kk, jj, scales=scales),
                        (pyr, (1, 4), ss)))
        for n, (lvl, c) in enumerate(((1, coords), (4, c4))):
            out.append(("corr_level", f"level {lvl} {label}",
                        lambda r=pyr[n], c=c, s=ss[n]: cc.corr_level_cuda(
                            gmap, r, c, kk, jj, s),
                        lambda r=pyr[n], c=c, s=ss[n]: plain.corr_level(
                            gmap, r, c, kk, jj, s),
                        ((pyr[n],), (lvl,), (ss[n],))))
            out.append(("corr_level_pipe", f"level {lvl} {label}",
                        lambda r=pyr[n], c=c, s=ss[n]: cc.corr_level_pipe_cuda(
                            gmap, r, c, kk, jj, s),
                        lambda r=pyr[n], c=c, s=ss[n]: plain.corr_level(
                            gmap, r, c, kk, jj, s),
                        ((pyr[n],), (lvl,), (ss[n],))))
            out.append(("corr_group", f"level {lvl} {label}",
                        lambda r=pyr[n], c=c, s=ss[n]: cc.corr_group_cuda(
                            gmap, r, c, kk, jj, s),
                        lambda r=pyr[n], c=c, s=ss[n]: plain.corr_level_group(
                            gmap, r, c, kk, jj, s),
                        ((pyr[n],), (lvl,), (ss[n],))))
    out.append(("corr_level_resident", "level 4 i8",
                lambda: cc.corr_level_resident_cuda(gmap, i8[1], c4, kk, jj, sc[1]),
                lambda: plain.corr_level(gmap, i8[1], c4, kk, jj, sc[1]),
                ((i8[1],), (4,), (sc[1],))))
    # the kernels that take float rings only: bf16, and f32 rings (and patch
    # features) holding the same values
    for label, g, pyr in (("bf16", gmap, bf),
                          ("f32", gmap.float(), tuple(r.float() for r in bf))):
        for n, (lvl, c) in enumerate(((1, coords), (4, c4))):
            for name, fn in (("corr_fixed", cc.corr_fixed_cuda),
                             ("corr_group8", cc.corr_group8_cuda),
                             ("corr_level_full", cc.corr_level_full_cuda)):
                out.append((name, f"level {lvl} {label}",
                            lambda fn=fn, g=g, r=pyr[n], c=c: fn(g, r, c, kk, jj),
                            lambda g=g, r=pyr[n], c=c: plain.corr_level(
                                g, r, c, kk, jj),
                            ((pyr[n],), (lvl,), (None,))))
    return out


# the variant whose numbers stand for a kernel in the JSON record: the one
# the default (int8) configurations run at the step's edge count
REPORTED = {"corr_pyramid": "both levels i8", "corr_level": "level 1 i8",
            "corr_level_resident": "level 4 i8", "corr_pair": "both levels i8",
            "corr_pair2": "both levels i8", "corr_level_pipe": "level 1 i8",
            "corr_group": "level 1 i8", "corr_mono2": "both levels i8 gathered",
            "corr_mono3": "both levels i8", "corr_fixed": "level 1 bf16",
            "corr_group8": "level 1 bf16", "corr_level_full": "level 1 bf16"}
# the kernel choices of the entry point that compute corr_pyramid's function
EXACT = ("pair", "pair2", "mono2", "mono4", "mono3", "split2")


def own_plain(kernel, gmap, pyr, coords, kk, jj, scales):
    """The plain version of the entry point's kernel choice `kernel` on these
    inputs, and the tolerance it is held to: corr_pyramid and TOL, or for
    "g8c" the stacked corr_level_group and one bf16 ulp of the largest
    output (see group_tol)."""
    from devo_tpu_torch.ops import corr as plain
    if kernel != "g8c":
        return plain.corr_pyramid(gmap, pyr, coords, kk, jj, scales=scales), TOL
    ref = plain.stack_levels(
        plain.corr_level_group(gmap, r, coords / lvl, kk, jj, s)
        for r, lvl, s in zip(pyr, (1, 4), scales or (None, None)))
    return ref, group_tol(ref)


def group_tol(want):
    """The tolerance of corr_group against `want`, the result of
    corr_level_group, where both round the same f32 sums to bf16: a sum taken
    in another order may cross a rounding boundary, and the two then lie one
    bf16 ulp apart, at most 2^-7 of the product; the blend is a convex
    combination of taps, so one ulp of the largest tap bounds an output too.
    The largest output stands in for the largest tap (a pixel on the integer
    grid has its taps as outputs), with the f32 noise of TOL on top."""
    return dict(atol=2.0 ** -7 * want.abs().max().item() + TOL["atol"],
                rtol=TOL["rtol"])


def kernel_phase(dev, gpu: str):
    """Returns {kernel name: dict(max_abs_err, ms, plain_ms, bound_ms,
    bound_by, variants)}."""
    from devo_tpu_torch.ops import corr_cuda as cc
    record = {name: dict(max_abs_err=0.0, variants=[]) for name in KERNELS}
    for E, seed in ((E_MAIN, 0), (96, 1), (5003, 2)):
        case = corr_case(E, dev, seed)
        gmap, bf, i8, sc, coords, kk, jj = case
        for name, label, kernel, plain, (rings, strides, scales) in variants(case):
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = group_tol(want) if name == "corr_group" else TOL
            torch.testing.assert_close(got, want, **tol)
            ms = median_ms(kernel)
            plain_ms = median_ms(plain, launches=2, repeats=3)
            # the patch features are read in the rings' float type
            g = gmap.float() if rings[0].dtype == torch.float32 else gmap
            b_ms, b_by = bound_ms(g, rings, strides, scales, coords, kk, jj,
                                  surface=name == "corr_group")
            print(f"{name} [{label}] E={E}: max_abs_err {err:.3e} within atol "
                  f"{tol['atol']:.3g} + rtol {tol['rtol']}; median kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}) [{gpu}]", flush=True)
            rec = record[name]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["variants"].append(dict(label=label, E=E, max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms, bound_ms=b_ms,
                                        bound_by=b_by))
            if E == E_MAIN and label == REPORTED[name]:
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        # the per-level kernels stacked against the two-level kernel: both
        # must floor the same coordinates
        for label, pyr, scales, resident in (("bf16", bf, None, False),
                                             ("i8", i8, sc, False),
                                             ("i8 resident", i8, sc, True)):
            mono = cc.corr_pyramid(gmap, pyr, coords, kk, jj, scales=scales)
            split = cc.corr_pyramid(gmap, pyr, coords, kk, jj, scales=scales,
                                    kernel="split", resident=resident)
            torch.cuda.synchronize()
            torch.testing.assert_close(split, mono, **TOL)
            print(f"split vs mono [{label}] E={E}: max abs diff "
                  f"{(split - mono).abs().max().item():.3e} [{gpu}]", flush=True)
            if resident:
                for kernel in ("split2", "g8c"):
                    group_vs_mono(cc, kernel, True, label, mono, gmap, pyr,
                                  coords, kk, jj, scales, E, gpu)
                continue
            for kernel in EXACT:
                got = cc.corr_pyramid(gmap, pyr, coords, kk, jj, scales=scales,
                                      kernel=kernel)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, mono, **TOL)
                print(f"{kernel} vs mono [{label}] E={E}: max abs diff "
                      f"{(got - mono).abs().max().item():.3e} [{gpu}]",
                      flush=True)
            group_vs_mono(cc, "g8c", False, label, mono, gmap, pyr, coords, kk,
                          jj, scales, E, gpu)
            if scales is None:
                # the float-ring configurations through the entry point
                for impl, kernel in FLOAT_LEVEL.values():
                    got = cc.corr_pyramid(gmap, pyr, coords, kk, jj,
                                          kernel=kernel, impl=impl)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, mono, **TOL)
                    print(f"{impl} {kernel} vs mono [{label}] E={E}: max abs "
                          f"diff {(got - mono).abs().max().item():.3e} [{gpu}]",
                          flush=True)
        if E == E_MAIN:
            group_stages(case, gpu)
            full_stages(case, gpu, record)
    for ring in (torch.bfloat16, torch.int8):
        blocks = cc.pair2_blocks_per_sm(3, 128, torch.bfloat16, ring)
        print(f"corr_pair2 [{ring} rings, C=128]: {blocks} block(s) of 384 "
              f"threads per SM [{gpu}]", flush=True)
        blocks = cc.level_pipe_blocks_per_sm(3, 128, torch.bfloat16, ring)
        print(f"corr_level_pipe [{ring} rings, C=128]: {blocks} block(s) of "
              f"192 threads per SM [{gpu}]", flush=True)
        cap, depth = cc.mono3_plan(3, 128, ring)
        print(f"corr_mono3 [{ring} rings, C=128]: windows of {cap} vectors, a "
              f"ring of {depth} stages, runs of {cc.mono3_run(E_MAIN, dev)} "
              f"edges at E={E_MAIN} [{gpu}]", flush=True)
    empty_case(dev, gpu)
    narrow_case(dev, gpu, record)
    wide_case(dev, gpu, record)
    return record


def group_vs_mono(cc, kernel, resident, label, mono, gmap, pyr, coords, kk, jj,
                  scales, E, gpu):
    """A per-level kernel choice (with or without the resident level 4)
    against corr_pyramid's kernel: "split2" within TOL; "g8c" within the
    bf16 budget, half an ulp a tap, 2^-8 of the largest output."""
    got = cc.corr_pyramid(gmap, pyr, coords, kk, jj, scales=scales,
                          kernel=kernel, resident=resident)
    torch.cuda.synchronize()
    tol = TOL
    if kernel == "g8c":
        tol = dict(atol=2.0 ** -8 * mono.abs().max().item() + TOL["atol"],
                   rtol=TOL["rtol"])
    torch.testing.assert_close(got, mono, **tol)
    print(f"{kernel}{' + resident' if resident else ''} vs mono [{label}] "
          f"E={E}: max abs diff {(got - mono).abs().max().item():.3e} (atol "
          f"{tol['atol']:.3g}) [{gpu}]", flush=True)


def group_stages(case, gpu: str):
    """corr_group's two stages timed apart at the step's edge count: the
    kernel that writes the surface, and the tensor code that reads it."""
    from devo_tpu_torch.ops import corr as plain
    from devo_tpu_torch.ops import corr_cuda as cc
    gmap, bf, i8, sc, coords, kk, jj = case
    for label, ring, scale in (("level 1 bf16", bf[0], None),
                               ("level 1 i8", i8[0], sc[0])):
        surface, cap = cc.group_surface_cuda(gmap, ring, coords, kk, jj, scale)
        k_ms = median_ms(lambda: cc.group_surface_cuda(gmap, ring, coords, kk,
                                                       jj, scale))
        x_ms = median_ms(lambda: plain.extract_blend_group(
            surface, coords, jj, ring.shape[1:3], scale, cap))
        print(f"corr_group [{label}] E={coords.shape[0]}: the kernel (stage 1) "
              f"{k_ms:.4f} ms, extraction and blend (stage 2, tensor code) "
              f"{x_ms:.4f} ms; surface {surface.numel() * 2 / 2**20:.1f} MiB "
              f"[{gpu}]", flush=True)


def full_stages(case, gpu: str, record):
    """corr_level_full's stage instances at the step's edge count, level 1,
    bf16 rings, each against its plain version (ops/corr.corr_level_stage)
    and timed beside the whole kernel: the copy, product and extraction
    apart."""
    from devo_tpu_torch.ops import corr as plain
    from devo_tpu_torch.ops import corr_cuda as cc
    gmap, bf, i8, sc, coords, kk, jj = case
    ring = bf[0]
    cap = cc.full_plan(gmap.shape[1], gmap.shape[-1], ring.dtype)[0]
    rec = record["corr_level_full"]
    rec["stages"] = {}
    for stage in plain.STAGES:
        got = cc.corr_level_full_cuda(gmap, ring, coords, kk, jj, stage=stage)
        want = plain.corr_level_stage(gmap, ring, coords, kk, jj, stage, cap)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **TOL)
        ms = median_ms(lambda stage=stage: cc.corr_level_full_cuda(
            gmap, ring, coords, kk, jj, stage=stage))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["stages"][stage] = dict(ms=ms, max_abs_err=err)
    print(f"corr_level_full stages [level 1 bf16] E={coords.shape[0]}: "
          + ", ".join(f"{k} {v['ms']:.4f} ms (max_abs_err {v['max_abs_err']:.3e})"
                      for k, v in rec["stages"].items())
          + f" [{gpu}]", flush=True)


def empty_case(dev, gpu: str):
    """E = 0: an empty result of the right shape and no launch, on every
    kernel choice and family (int8 rings where the choice takes them)."""
    from devo_tpu_torch.ops import corr_cuda as cc
    gmap, bf, i8, sc, coords, kk, jj = corr_case(8, dev, 4)
    before = dict(cc.launches)
    for impl, kernel in ([("banded", k) for k in cc.KERNELS]
                         + [(impl, "mono") for impl in cc.IMPLS[1:]]):
        floats = impl != "banded" or kernel in cc.FLOAT_ONLY
        pyr, scales = (bf, None) if floats else (i8, sc)
        got = cc.corr_pyramid(gmap, pyr, coords[:0], kk[:0], jj[:0],
                              scales=scales, kernel=kernel, impl=impl)
        if got.shape != (0, 882) or cc.launches != before:
            raise RuntimeError(f"{impl} {kernel} at E=0: {tuple(got.shape)}, "
                               f"launches {cc.launches}")
    print(f"E=0: every kernel choice and family returns (0, 882) and launches "
          f"nothing [{gpu}]", flush=True)


# kernel choice -> the launch counters it runs on
COUNTERS = {"pair": ("corr_pair",), "pair2": ("corr_pair2",),
            "mono2": ("corr_mono2",), "mono4": ("corr_mono2",),
            "mono3": ("corr_mono3",), "split2": ("corr_level_pipe",),
            "g8c": ("corr_group",)}


def narrow_case(dev, gpu: str, record):
    """The kernels with staged windows at C = 8: an int8 feature vector is 8
    bytes, no multiple of the 16-byte copies, so nothing is staged and every
    tap reads the ring directly (corr_group keeps taps in its rows); a bf16
    vector is 16 bytes, the narrowest that is staged."""
    from devo_tpu_torch.ops import corr_cuda as cc
    gmap, bf, i8, sc, coords, kk, jj = corr_case(5003, dev, 3, C=8)
    for label, pyr, scales in (("i8, direct reads", i8, sc),
                               ("bf16, staged", bf, None)):
        held_to_plain(cc, "C=8 " + label, gmap, pyr, coords, kk, jj, scales,
                      record, gpu)
    held_float_to_plain(cc, "C=8", gmap, bf, coords, kk, jj, record, gpu)


def held_float_to_plain(cc, label, gmap, bf, coords, kk, jj, record, gpu):
    """The float-ring kernels (FLOAT_LEVEL) through the entry point on one
    case, on its bf16 rings and on f32 rings of the same values, against
    corr_pyramid."""
    from devo_tpu_torch.ops import corr as plain
    for ring, g, pyr in (("bf16", gmap, bf),
                         ("f32", gmap.float(), tuple(r.float() for r in bf))):
        ref = plain.corr_pyramid(g, pyr, coords, kk, jj)
        for name, (impl, kernel) in FLOAT_LEVEL.items():
            got = cc.corr_pyramid(g, pyr, coords, kk, jj, kernel=kernel,
                                  impl=impl)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            torch.testing.assert_close(got, ref, **TOL)
            record[name]["max_abs_err"] = max(record[name]["max_abs_err"], err)
            print(f"{name} [{label} {ring}] E={coords.shape[0]}: max_abs_err "
                  f"{err:.3e} within atol {TOL['atol']} + rtol {TOL['rtol']} "
                  f"[{gpu}]", flush=True)


def held_to_plain(cc, label, gmap, pyr, coords, kk, jj, scales, record, gpu):
    """Every kernel choice of COUNTERS on one case against its plain version
    (own_plain)."""
    for kernel, names in COUNTERS.items():
        got = cc.corr_pyramid(gmap, pyr, coords, kk, jj, scales=scales,
                              kernel=kernel)
        ref, tol = own_plain(kernel, gmap, pyr, coords, kk, jj, scales)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, **tol)
        for name in names:
            record[name]["max_abs_err"] = max(record[name]["max_abs_err"], err)
        print(f"{kernel} [{label}] E={coords.shape[0]}: max_abs_err {err:.3e} "
              f"within atol {tol['atol']:.3g} + rtol {tol['rtol']} [{gpu}]",
              flush=True)


def wide_case(dev, gpu: str, record):
    """Patches distorted beyond the staged window's capacity (every pixel
    moved 3 px on its own: level-1 windows up to about 20x20 vectors): the
    tap kernels read such a level from the ring, corr_mono3 takes its tap
    buffer, and corr_group keeps the edge's taps in its surface rows."""
    from devo_tpu_torch.ops import corr as plain
    from devo_tpu_torch.ops import corr_cuda as cc
    gmap, bf, i8, sc, coords, kk, jj = corr_case(1001, dev, 5)
    g = torch.Generator(device=dev).manual_seed(6)
    coords = coords + 3.0 * torch.randn(coords.shape, generator=g, device=dev)
    wide = plain._group_index(coords, plain.GROUP_ROWS)[-1]
    if int(wide.sum()) < 100:
        raise RuntimeError(f"wide case: {int(wide.sum())} wide windows")
    for label, pyr, scales in (("wide windows i8", i8, sc),
                               ("wide windows bf16", bf, None)):
        held_to_plain(cc, label, gmap, pyr, coords, kk, jj, scales, record,
                      gpu)
    held_float_to_plain(cc, "wide windows", gmap, bf, coords, kk, jj, record,
                        gpu)


def profile_frames(slam, stream, intr, gpu: str):
    """Run frames under torch.profiler and print where the time goes: the
    device's busy share, each correlation kernel's share of device time,
    kernel launches, and host and device time of each engine phase (the
    devo.* spans)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = len(stream)
    first = slam.counter
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, vox in enumerate(stream):
            slam((first + i) / 30.0, vox, intr)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ka = prof.key_averages()
    # device time = the device's own events (kernels, copies), as the
    # profiler's table totals it; CPU-side ops repeat their kernels' time
    # and the devo.* spans are annotations, not work
    device = [e for e in ka if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    dev_ms = sum(e.self_device_time_total for e in device) / 1e3
    corr_ms = {name: sum(e.self_device_time_total for e in device
                         if fn + "<" in e.key or e.key.endswith(fn)) / 1e3
               for name, (_, _, fn) in KERNELS.items()}

    def count(*names):
        return sum(e.count for e in ka if e.key in names)

    n_launch = count("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx")
    # each one makes the host wait for the device
    n_sync = count("cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize")
    n_copy = count("cudaMemcpyAsync", "cudaMemcpy")
    shares = ", ".join(f"{name} {ms / n:.3f} ms/frame "
                       f"({ms / max(dev_ms, 1e-9):.3f} of device time)"
                       for name, ms in corr_ms.items() if ms > 0)
    print(f"profile: {n} frames under torch.profiler, {wall_ms / n:.2f} ms/frame "
          f"wall; device busy {dev_ms / n:.2f} ms/frame ({dev_ms / wall_ms:.3f} "
          f"of wall); {shares}; per frame {n_launch / n:.0f} kernel launches, "
          f"{n_sync / n:.1f} host syncs, {n_copy / n:.1f} memcpy calls [{gpu}]",
          flush=True)
    for e in sorted((e for e in ka if e.key.startswith("devo.")
                     and e.cpu_time_total > 0), key=lambda e: e.key):
        print(f"  {e.key}: {e.count / n:.2f} calls/frame, host "
              f"{e.cpu_time_total / 1e3 / n:.2f} ms/frame, device "
              f"{e.device_time_total / 1e3 / n:.2f} ms/frame", flush=True)
    if not sum(corr_ms.values()) > 0:
        raise RuntimeError("the profile shows no correlation kernel")


REF_HT, REF_WD, REF_FRAMES = 64, 64, 18
# the configurations of the reference phase: unquantised rings and int8
# rings, on every kernel choice
REFERENCE = {
    "f32 rings": dict(CORR_RING_I8=False),
    "i8-mono": PATHS["i8-mono"][0],
    "i8-split": dict(CORR_RING_I8=True, CORR_KERNEL="split",
                     CORR_L4_RESIDENT="off"),
    "i8-split-resident": PATHS["i8-split-resident"][0],
    "f32 rings pair": dict(CORR_RING_I8=False, CORR_KERNEL="pair"),
    "f32 rings pair2": dict(CORR_RING_I8=False, CORR_KERNEL="pair2"),
    "i8-pair": dict(CORR_RING_I8=True, CORR_KERNEL="pair"),
    "i8-pair2": dict(CORR_RING_I8=True, CORR_KERNEL="pair2"),
    "f32 rings split2": dict(CORR_RING_I8=False, CORR_KERNEL="split2"),
    "f32 rings mono2": dict(CORR_RING_I8=False, CORR_KERNEL="mono2"),
    "f32 rings mono4": dict(CORR_RING_I8=False, CORR_KERNEL="mono4"),
    "f32 rings mono3": dict(CORR_RING_I8=False, CORR_KERNEL="mono3"),
    # the CPU engine takes corr_level_group, which rounds its products to
    # bf16 where the kernel does: the same tolerance holds
    "f32 rings g8c": dict(CORR_RING_I8=False, CORR_KERNEL="g8c"),
    "i8-split2-resident": dict(CORR_RING_I8=True, CORR_KERNEL="split2",
                               CORR_L4_RESIDENT="auto"),
    "i8-mono3": dict(CORR_RING_I8=True, CORR_KERNEL="mono3"),
    "i8-g8c": dict(CORR_RING_I8=True, CORR_KERNEL="g8c"),
    # the other families keep float rings whatever CORR_RING_I8 says
    "f32 rings pallas": dict(CORR_IMPL="pallas"),
    "f32 rings window": dict(CORR_IMPL="window"),
    "f32 rings gather": dict(CORR_IMPL="gather"),
    "f32 rings g8": dict(CORR_RING_I8=False, CORR_KERNEL="g8"),
    "f32 rings full": dict(CORR_RING_I8=False, CORR_KERNEL="full"),
}
# pose atol: float noise compounds over the 12-update initialization and the
# per-frame BA; with int8 rings a feature that rounds the other way on the
# card moves a tap by one step of the ring's scale
REF_TOL = {False: 5e-2, True: 0.1}


def reference_phase(dev, gpu: str, label: str, knobs: dict):
    """The port on the card against the port on the CPU (plain correlation,
    CPU convolutions and sums), which the repo's CPU tests hold against the
    JAX package: a small f32 configuration with deterministic top-k patch
    selection and the same injected depth draws, over frames of a sliding
    texture. Per frame the same keyframe count, cull decision and (kk, jj)
    edge set, poses within REF_TOL; then the same terminate() output."""
    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.ops import corr as corr_plain
    from devo_tpu_torch.ops import corr_cuda
    from devo_tpu_torch.runtime.config import VOConfig
    from devo_tpu_torch.runtime.engine import DEVO, ring_i8
    from devo_tpu_torch.utils.params import random_state_dict

    cfg = VOConfig(BUFFER_SIZE=32, HT=REF_HT, WD=REF_WD, PATCHES_PER_FRAME=4,
                   PATCH_LIFETIME=5, REMOVAL_WINDOW=9, OPTIMIZATION_WINDOW=4,
                   MOTION_PROBE_THRESH=-1.0, MEM=16, DIM_INET=32, DIM_FNET=16,
                   DIM=8, MIXED_PRECISION=False, SCORER_EVAL_MODE="topk",
                   **knobs)
    tol = REF_TOL[ring_i8(cfg)]
    weights = random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS), seed=1)
    rng = np.random.default_rng(1)
    base = rng.standard_normal((REF_HT, 2 * REF_WD, 5)).astype(np.float32)
    base *= rng.random(base.shape) < 0.15
    depths = rng.random((REF_FRAMES, cfg.M, 1)).astype(np.float32)
    intr = np.asarray([80.0, 80.0, REF_WD / 2, REF_HT / 2], np.float32)

    engines = {d.type: DEVO(cfg, weights, ht=REF_HT, wd=REF_WD, device=d)
               for d in (torch.device("cpu"), dev)}
    corr_cuda.reset_launches()
    corr_plain.window_calls = corr_plain.gather_calls = 0
    culls = 0
    for i in range(REF_FRAMES):
        vox = base[:, 3 * i:3 * i + REF_WD]
        for d, slam in engines.items():
            slam._draw_depth = lambda i=i, d=d: torch.from_numpy(depths[i]).to(d)
            slam(i / 30.0, vox, intr)
        ref, got = engines["cpu"], engines[dev.type]
        if (got.n != ref.n or got.aux_log[-1][1].kf_removed
                != ref.aux_log[-1][1].kf_removed):
            raise RuntimeError(f"reference {label} frame {i}: n {got.n} vs "
                               f"{ref.n}, cull {got.aux_log[-1][1].kf_removed} "
                               f"vs {ref.aux_log[-1][1].kf_removed}")
        edges = [set(zip(s.kk.tolist(), s.jj.tolist())) for s in (got, ref)]
        if edges[0] != edges[1]:
            raise RuntimeError(f"reference {label} frame {i}: edge tables differ")
        err = (got.poses[:got.n].cpu() - ref.poses[:ref.n]).abs().max().item()
        if not err <= tol:
            raise RuntimeError(f"reference {label} frame {i}: poses differ by {err}")
        culls += ref.aux_log[-1][1].kf_removed
    for slam in engines.values():
        for _ in range(N_UPDATES):
            slam.update()
    (p_got, t_got), (p_ref, t_ref) = (engines[dev.type].terminate(),
                                      engines["cpu"].terminate())
    err = float(np.abs(p_got - p_ref).max())
    print(f"reference [{label}]: port on {dev.type} vs port on cpu, "
          f"{REF_HT}x{REF_WD}, {REF_FRAMES} frames + {N_UPDATES} updates: same "
          f"keyframes, culls ({culls}) and edge sets; terminate() poses max abs "
          f"diff {err:.3e} (atol {tol}); kernel launches "
          f"{corr_cuda.launches}; resident level 4: "
          f"{engines[dev.type].l4_resident} [{gpu}]", flush=True)
    if not (err <= tol and np.array_equal(t_got, t_ref)
            and np.isfinite(p_got).all()):
        raise RuntimeError(f"reference {label}: terminate() outputs differ")
    if culls < 1:
        raise RuntimeError(f"reference {label}: no keyframe cull happened")
    path = TENSOR_PATH.get(cfg.CORR_IMPL)
    if path is not None:
        # both engines took the tensor path, and the card no kernel
        if any(corr_cuda.launches.values()) or getattr(corr_plain, path) < 1:
            raise RuntimeError(f"reference {label}: expected the {path} path "
                               f"and no kernel: {corr_cuda.launches}")
    elif not any(corr_cuda.launches.values()):
        raise RuntimeError(f"reference {label}: no kernel was launched")


def slice_phase(dev, gpu: str, label: str, n_frames: int, n_profiled: int):
    """One path of PATHS at full width. Returns (launches of each kernel on
    the path, max error of its kernels on the engine's final state)."""
    from devo_tpu_torch.bench import frames
    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.ops import corr as corr_plain
    from devo_tpu_torch.ops import corr_cuda
    from devo_tpu_torch.runtime.config import VOConfig
    from devo_tpu_torch.runtime.engine import DEVO
    from devo_tpu_torch.utils.params import random_state_dict

    knobs, named = PATHS[label]
    # random weights reject every frame at the motion probe (a learned
    # behavior, devo.py:531-534); bench.py disables it the same way
    cfg = VOConfig(MOTION_PROBE_THRESH=-1.0, **knobs)
    weights = random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS), seed=0)
    slam = DEVO(cfg, weights, ht=HT, wd=WD, seed=0, device=dev)
    intr = np.asarray([320.0, 320.0, WD / 2, HT / 2], np.float32)
    stream = list(frames(n_frames + n_profiled))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    corr_cuda.reset_launches()
    corr_plain.calls = corr_plain.window_calls = corr_plain.gather_calls = 0
    frame_s = []
    for i, vox in enumerate(stream[:n_frames]):
        if i == SKIP:
            at_skip = dict(corr_cuda.launches)
        t0 = time.perf_counter()
        slam(i / 30.0, vox, intr)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    per_frame = {k: (v - at_skip[k]) / (n_frames - SKIP)
                 for k, v in corr_cuda.launches.items() if v}
    if n_profiled:
        profile_frames(slam, stream[n_frames:], intr, gpu)
    t0 = time.perf_counter()
    for _ in range(N_UPDATES):
        slam.update()
    poses, tss = slam.terminate()
    torch.cuda.synchronize()
    t_end = time.perf_counter() - t0
    launches, plain_calls = dict(corr_cuda.launches), corr_plain.calls
    paths = {impl: getattr(corr_plain, name) for impl, name in TENSOR_PATH.items()}

    n_all = len(stream)
    culls = sum(bool(aux.kf_removed) for _, aux in slam.aux_log)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    tail = frame_s[SKIP:]
    print(f"slice [{label}]: {HT}x{WD}, CORR_IMPL={slam.cfg.CORR_IMPL!r}, "
          f"CORR_KERNEL={slam.cfg.CORR_KERNEL!r}, rings {slam.fmap1.dtype}, "
          f"resident level 4 {slam.l4_resident}; frames {SKIP}-{n_frames - 1}: "
          f"{len(tail) / sum(tail):.2f} frames/s (median frame "
          f"{1e3 * np.median(tail):.2f} ms), kernel launches per frame "
          f"{per_frame}; first frame "
          f"{1e3 * frame_s[0]:.1f} ms, init frame {1e3 * max(frame_s[:SKIP]):.1f} "
          f"ms; {N_UPDATES} updates + terminate {1e3 * t_end:.1f} ms; after "
          f"{n_all} frames: live edges {slam.n_edges}, keyframes {slam.n}, "
          f"culls {culls}; peak memory {peak_gib:.3f} GiB; kernel launches "
          f"{launches}, plain corr calls {plain_calls}, tensor path calls "
          f"{paths} [{gpu}]", flush=True)
    if poses.shape != (n_all, 7) or tss.shape != (n_all,):
        raise RuntimeError(f"{label}: trajectory shape {poses.shape}, {tss.shape}")
    if not np.isfinite(poses).all():
        raise RuntimeError(f"{label}: trajectory is not finite")
    if culls < 1:
        raise RuntimeError(f"{label}: no keyframe cull happened")
    unnamed = [k for k in launches if k not in named and launches[k]]
    impl = slam.cfg.CORR_IMPL
    if (any(launches[k] < 1 for k in named) or unnamed or plain_calls != 0
            or any(n < 1 if k == impl else n > 0 for k, n in paths.items())):
        raise RuntimeError(f"{label}: the step did not run on its kernels "
                           f"{named} alone: {launches}, {plain_calls} plain "
                           f"calls, tensor paths {paths}")
    if slam.fmap1.dtype != (torch.int8 if knobs.get("CORR_RING_I8", True)
                            and impl == "banded" else torch.bfloat16):
        raise RuntimeError(f"{label}: rings {slam.fmap1.dtype}")

    return launches, engine_state_check(slam, label, gpu)


def engine_state_check(slam, label: str, gpu: str) -> float:
    """The configuration's kernels once more, against the plain version on
    the engine's own edges and rings. Returns the max abs error."""
    from devo_tpu_torch.geom import edgewise
    from devo_tpu_torch.ops import corr as corr_plain
    from devo_tpu_torch.ops import corr_cuda
    cfg = slam.cfg
    geo = edgewise.reproject(slam.poses, slam.patches, slam.intrinsics,
                             slam.ii, slam.jj, slam.kk)
    args = (slam.gmap, (slam.fmap1, slam.fmap2),
            edgewise.coords_to_corr_format(geo, cfg.P),
            (slam.kk % (cfg.M * cfg.MEM)).int(), (slam.jj % cfg.MEM).int())
    scales = (slam.fsc1, slam.fsc2) if slam.ring_i8 else None
    impl = cfg.CORR_IMPL
    if impl in TENSOR_PATH:
        # no kernel: the tensor path on the card against itself on the CPU,
        # on the first edges
        n = min(slam.n_edges, 2048)
        args = (args[0], args[1], *(t[:n] for t in args[2:]))
        got = corr_cuda.corr_pyramid(*args, impl=impl)
        want = corr_cuda.corr_pyramid(
            args[0].cpu(), tuple(r.cpu() for r in args[1]),
            *(t.cpu() for t in args[2:]), impl=impl).to(got.device)
        tol = TOL
    else:
        got = corr_cuda.corr_pyramid(*args, scales=scales,
                                     kernel=cfg.CORR_KERNEL,
                                     resident=slam.l4_resident, impl=impl)
        want, tol = own_plain(cfg.CORR_KERNEL if impl == "banded" else "mono",
                              *args, scales)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **tol)
    print(f"engine state [{label}] E={got.shape[0]}: max_abs_err {err:.3e} "
          f"within atol {tol['atol']:.3g} + rtol {tol['rtol']} [{gpu}]",
          flush=True)
    return err


def bench_phase(dev, gpu: str, label: str):
    """One run of BENCH_PATHS through devo_tpu_torch.bench.run at full width.
    Returns (launches of each kernel over the timed windows, max error of
    the run's kernel against its plain version on the engine's final
    state)."""
    from devo_tpu_torch import bench
    from devo_tpu_torch.ops import corr as corr_plain
    from devo_tpu_torch.ops import corr_cuda

    knobs, full, kernel = BENCH_PATHS[label]
    corr_cuda.reset_launches()
    corr_plain.calls = 0
    t0 = time.perf_counter()
    res = bench.run(knobs, device=dev, **({} if full else BENCH_SHORT))
    wall = time.perf_counter() - t0
    launches, plain_calls = dict(corr_cuda.launches), corr_plain.calls
    poses, slam = res.pop("poses"), res.pop("engine")
    print(f"bench [{label}] ({wall:.1f} s): {json.dumps(res)}", flush=True)
    n = res["frames_before_timing"] + (bench.N_BENCH if full
                                       else BENCH_SHORT["n_bench"])
    if not res["reached"]:
        raise RuntimeError(f"{label}: the run did not reach its operating "
                           f"point: {res['window_end_live_edges']}")
    if poses.shape != (n, 7) or not np.isfinite(poses).all():
        raise RuntimeError(f"{label}: trajectory {poses.shape} is not finite")
    others = [k for k, v in launches.items() if v and k != kernel]
    if launches[kernel] < 1 or others or plain_calls != 0 or res["launches"] != {
            kernel: launches[kernel]}:
        raise RuntimeError(f"{label}: expected launches of {kernel} alone, got "
                           f"{launches} and {plain_calls} plain calls")
    if res["card"] != gpu:
        raise RuntimeError(f"{label}: the bench reports card {res['card']!r}")
    return launches, engine_state_check(slam, label, gpu)


def eval_phase(dev, gpu: str, label: str, engine_cache: dict, stream):
    """One configuration of EVAL_PATHS through evaluate_sequence at full
    width. `stream`: the frames as (bins, H, W) arrays. Returns (launches of
    each kernel during evaluate_sequence, max error of the configuration's
    kernel on the engine's final state)."""
    import os

    from devo_tpu_torch.bench import frames
    from devo_tpu_torch.eval import harness
    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.ops import corr as corr_plain
    from devo_tpu_torch.ops import corr_cuda
    from devo_tpu_torch.runtime.config import EVAL_CONFIGS
    from devo_tpu_torch.utils.params import random_state_dict

    knobs, kernel = EVAL_PATHS[label]
    # random weights reject every frame at the learned motion probe
    cfg = EVAL_CONFIGS["eds"].replace(MOTION_PROBE_THRESH=-1.0, **knobs)
    weights = random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS), seed=0)
    n = len(stream)
    intr = np.asarray([320.0, 320.0, WD / 2, HT / 2], np.float32)
    tss = np.arange(n, dtype=np.float64) / 30.0
    gt = np.zeros((n, 7), np.float32)         # a straight line along x
    gt[:, 0] = 0.01 * np.arange(n)
    gt[:, 6] = 1.0
    yields = []                               # host clock at every frame

    def make_iterator():
        yields.append([])
        for vox, t in zip(stream, tss):
            yields[-1].append(time.perf_counter())
            yield vox, intr, float(t)

    # the frame's copy to the device, as the harness makes it
    copy_ms = median_ms(lambda: harness._on_device(stream[0], dev))

    before = len(engine_cache)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2**30
    corr_cuda.reset_launches()
    corr_plain.calls = 0
    med, results, fps = harness.evaluate_sequence(
        cfg, weights, make_iterator, traj_gt=gt, tss_gt=tss,
        trials=EVAL_TRIALS, ht=HT, wd=WD, max_diff_s=0.01, outdir=OUT_DIR,
        name=label, engine_cache=engine_cache)
    torch.cuda.synchronize()
    launches, plain_calls = dict(corr_cuda.launches), corr_plain.calls
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    if len(engine_cache) != before + 1:
        raise RuntimeError(f"{label}: {len(engine_cache) - before} engines "
                           f"were cached for one configuration")
    slam = next(s for k, s in engine_cache.items() if k[2] == cfg)
    # correlations of one trial: the probe of frames 1-7, 12 updates at
    # initialization (frame 8), one per later frame, 12 final updates; a
    # kernel that takes one level a launch is launched twice for each
    per_trial = 7 + 12 + (n - 8) + N_UPDATES
    want = EVAL_TRIALS * per_trial * (2 if kernel in FLOAT_LEVEL else 1)
    others = [k for k, v in launches.items() if v and k != kernel]
    if launches[kernel] != want or others or plain_calls != 0:
        raise RuntimeError(f"{label}: expected {want} launches of {kernel} "
                           f"alone, got {launches} and {plain_calls} plain "
                           f"calls")
    if not all(np.isfinite([r.ate, r.mpe, r.r_rmse]).all() for r in results):
        raise RuntimeError(f"{label}: metrics are not finite: {results}")
    for trial in range(EVAL_TRIALS):
        dump = np.loadtxt(os.path.join(OUT_DIR, f"{label}_trial{trial}.txt"))
        if dump.shape != (n, 8) or not np.isfinite(dump).all():
            raise RuntimeError(f"{label}: TUM dump of trial {trial} is "
                               f"{dump.shape}")
    with open(os.path.join(OUT_DIR, f"{label}_results.json")) as f:
        blob = json.load(f)
    if (len(blob["trials"]) != EVAL_TRIALS or len(blob["fps"]) != EVAL_TRIALS
            or blob["median"]["ate"] != med.ate):
        raise RuntimeError(f"{label}: results JSON does not match the run")
    edges = slam.n_edges
    err = engine_state_check(slam, label, gpu)

    # the bare slice in the same configuration: a fresh engine with trial
    # 0's seed, called by hand as slice_phase calls it, gives as many poses
    from devo_tpu_torch.runtime.engine import DEVO
    bare = DEVO(cfg, weights, ht=HT, wd=WD, seed=0, device=dev)
    bare_s = []
    for vox, t in zip(frames(n), tss):
        t0 = time.perf_counter()
        bare(float(t), vox, intr)
        torch.cuda.synchronize()
        bare_s.append(time.perf_counter() - t0)
    for _ in range(N_UPDATES):
        bare.update()
    poses, stamps = bare.terminate()
    if poses.shape != (n, 7) or not np.isfinite(poses).all():
        raise RuntimeError(f"{label}: a fresh engine gave {poses.shape} poses")
    bare_tail = bare_s[SKIP:]

    # per trial, from the host clock at every frame the iterator hands out
    tail_fps = [round((n - 1 - SKIP) / (ts[-1] - ts[SKIP]), 2)
                for ts in yields[:EVAL_TRIALS]]
    frame_ms = [round(float(1e3 * np.median(np.diff(ts)[SKIP:])), 2)
                for ts in yields[:EVAL_TRIALS]]
    print(f"eval [{label}]: evaluate_sequence, {HT}x{WD}, rings "
          f"{slam.fmap1.dtype}, CORR_IMPL={cfg.CORR_IMPL!r}, "
          f"CORR_KERNEL={cfg.CORR_KERNEL!r}, {n} frames + "
          f"{N_UPDATES} updates x {EVAL_TRIALS} trials on one engine: "
          f"run_voxel frames/s per trial {[round(f, 2) for f in fps]} (first "
          f"frame, initialization and final updates included); frames "
          f"{SKIP}-{n - 1} per trial {tail_fps} frames/s, median frame "
          f"{frame_ms} ms, of which the host-to-device copy {copy_ms:.3f} ms; "
          f"the bare slice in this configuration (a fresh engine called by "
          f"hand) {len(bare_tail) / sum(bare_tail):.2f} frames/s, median "
          f"frame {1e3 * np.median(bare_tail):.2f} ms; live edges {edges}; "
          f"peak memory {peak_gib:.3f} GiB, of which {held_gib:.3f} GiB "
          f"held by engines cached before; launches {launches}, plain corr "
          f"calls {plain_calls}; ATE {med.ate:.3f} cm, MPE {med.mpe:.3f} %/m, "
          f"R_rmse {med.r_rmse:.3f} deg over {med.n_pairs} pairs, confirmed "
          f"by the independent ATE cross-check (random weights: these say "
          f"nothing about accuracy); artifacts in {OUT_DIR} [{gpu}]",
          flush=True)
    return launches, err


# ---------------------------------------------------------------------------
# Determinism: the port repeats itself bitwise on the card.

DETERMINISM_PATHS = ("i8-mono", "bf16-gather")


def assemble_index_add(Ji, Jj, Jz, r, w, li, lj, pk, n, m):
    """BA's system summed by index_add_ (atomics on the card), as the port
    assembled it before its sums took a fixed order: timed beside
    ops/ba.assemble only, never used by the port."""
    mi = (li >= 0)[:, None].to(w.dtype)
    mj = (lj >= 0)[:, None].to(w.dtype)
    wi, wj, wij = w * mi, w * mj, w * mi * mj
    li, lj = li.clamp(0, n - 1), lj.clamp(0, n - 1)

    def outer(wt, A, B):
        return torch.einsum("er,eri,erj->eij", wt, A, B)

    z = dict(dtype=w.dtype, device=w.device)
    B = torch.zeros((n * n, 6, 6), **z)
    Hij = outer(wij, Ji, Jj)
    B.index_add_(0, li * n + li, outer(wi, Ji, Ji))
    B.index_add_(0, li * n + lj, Hij)
    B.index_add_(0, lj * n + li, Hij.transpose(1, 2))
    B.index_add_(0, lj * n + lj, outer(wj, Jj, Jj))
    v = torch.zeros((n, 6), **z)
    v.index_add_(0, li, torch.einsum("er,eri->ei", wi * r, Ji))
    v.index_add_(0, lj, torch.einsum("er,eri->ei", wj * r, Jj))
    Eb = torch.zeros((n * m, 6), **z)
    Eb.index_add_(0, li * m + pk, torch.einsum("er,eri->ei", wi * Jz, Ji))
    Eb.index_add_(0, lj * m + pk, torch.einsum("er,eri->ei", wj * Jz, Jj))
    C = torch.zeros(m, **z).index_add_(0, pk, (w * Jz * Jz).sum(-1))
    u = torch.zeros(m, **z).index_add_(0, pk, (w * Jz * r).sum(-1))
    return B, v, Eb, C, u


def same_bits(a, b) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def ba_determinism(dev, gpu: str):
    """ops/ba.assemble at E = 12288 on the card, twice from the same
    inputs: bitwise equal; against index_add_ within TOL, and both timed."""
    from devo_tpu_torch.ops import ba
    from devo_tpu_torch.runtime.config import VOConfig
    cfg = VOConfig()
    n, m, E = cfg.ba_window, cfg.patch_slots, E_MAIN
    g = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    args = (randn(E, 2, 6), randn(E, 2, 6), randn(E, 2), randn(E, 2),
            torch.rand((E, 2), generator=g, device=dev),
            torch.randint(-1, n, (E,), generator=g, device=dev),
            torch.randint(-1, n, (E,), generator=g, device=dev),
            torch.randint(0, m, (E,), generator=g, device=dev))
    first, second = ba.assemble(*args, n, m), ba.assemble(*args, n, m)
    torch.cuda.synchronize()
    for name, a, b in zip(first._fields, first, second):
        if not same_bits(a.cpu().numpy(), b.cpu().numpy()):
            raise RuntimeError(f"determinism: BA's {name} differs between two "
                               f"assemblies of the same inputs")
    old = assemble_index_add(*args, n, m)
    B_old = old[0].reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
    errs = [(first.B - B_old).abs().max().item(),
            (first.v - old[1].reshape(-1)).abs().max().item(),
            (first.C - old[3]).abs().max().item(),
            (first.u - old[4]).abs().max().item()]
    for got, want in ((first.B, B_old), (first.C, old[3]), (first.u, old[4])):
        torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-4)
    new_ms = median_ms(lambda: ba.assemble(*args, n, m))
    old_ms = median_ms(lambda: assemble_index_add(*args, n, m))
    print(f"determinism: BA's system at E={E} (n={n} poses, {m} patch slots) "
          f"bitwise equal over two assemblies; max abs diff to the index_add_ "
          f"sums {max(errs):.3e}; fixed-order sums {new_ms:.4f} ms, index_add_ "
          f"{old_ms:.4f} ms an assembly [{gpu}]", flush=True)


def determinism_run(dev, label: str, n_frames: int):
    """One fresh engine on the path `label` over n_frames, N_UPDATES updates
    and terminate(): what must repeat bitwise."""
    from devo_tpu_torch.bench import frames
    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.runtime.config import VOConfig
    from devo_tpu_torch.runtime.engine import DEVO
    from devo_tpu_torch.utils.params import random_state_dict
    cfg = VOConfig(MOTION_PROBE_THRESH=-1.0, **PATHS[label][0])
    weights = random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS), seed=0)
    slam = DEVO(cfg, weights, ht=HT, wd=WD, seed=0, device=dev)
    intr = np.asarray([320.0, 320.0, WD / 2, HT / 2], np.float32)
    for i, vox in enumerate(frames(n_frames)):
        slam(i / 30.0, vox, intr)
    for _ in range(N_UPDATES):
        slam.update()
    state = {name: getattr(slam, name).cpu().numpy()
             for name in ("ii", "jj", "kk", "patches", "poses")}
    poses, tss = slam.terminate()
    state.update(trajectory=poses, timestamps=tss)
    return state, slam.n_edges, slam.n


def determinism_phase(dev, gpu: str):
    """BA's system, then the paths that changed their decisions from run to
    run while their sums went through atomics (DETERMINISM_PATHS), each run
    twice from a fresh engine with the same seed: the edge table (ii, jj,
    kk), the patches, the keyframe poses and terminate()'s output bitwise
    equal."""
    ba_determinism(dev, gpu)
    for label in DETERMINISM_PATHS:
        (a, edges, n), (b, _, _) = (determinism_run(dev, label, N_FRAMES),
                                    determinism_run(dev, label, N_FRAMES))
        differ = [k for k in a if not same_bits(a[k], b[k])]
        if differ:
            raise RuntimeError(f"determinism [{label}]: two runs differ in "
                               f"{differ}")
        print(f"determinism [{label}]: two fresh engines, {N_FRAMES} frames + "
              f"{N_UPDATES} updates + terminate(): {sorted(a)} bitwise equal; "
              f"live edges {edges}, keyframes {n} [{gpu}]", flush=True)


# ---------------------------------------------------------------------------
# The probe kernels and their drivers (devo_tpu_torch/scripts/).

PROBE_E, PROBE_LIVE = 15360, 6144        # the ablation's and the gather's E
PROBE_MEM, PROBE_NBX, PROBE_HP = 32, 22, 144
COPY_ND = 9600
# the variant whose numbers stand for a probe kernel in the JSON record
PROBE_REPORTED = {"corr_band_ablate": "random full",
                  "copy_probe": "single cp.async, one block an SM",
                  "corr_frame_probe": "extract=True"}
OUT_PROBES = "chiprun_out/probes"


def bound_of(nbytes: int, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ablate_bound(ring, slot, band, y0, live: int, mode: str):
    """The least time of the banded ablation on these inputs: the distinct
    ring rows (24 x 128 bf16 each) the live blocks' windows cover, the patch
    rows, offsets and indices of the live edges, the output, each once, and
    the products (none under "nomm"); "noDMA" reads no ring."""
    rows = ((slot[:live].long() * ring.shape[1] + band[:live].long())
            * ring.shape[2] + y0[:live].long())[:, None] + torch.arange(16, device=slot.device)
    window = int(torch.unique(rows).numel()) * 24 * 128 * 2
    g_bytes = live * 16 * 128 * 2
    offsets = live * 16 * 4 * 2
    out = live * 8 * 144 * 4
    ops = 2.0 * live * 384 * 16 * 128
    nbytes = {"full": window + g_bytes + offsets, "noext": window + g_bytes,
              "nomm": window, "noDMA": g_bytes + offsets}[mode]
    return bound_of(nbytes + out + live * 12 + 4, 0.0 if mode == "nomm" else ops)


def copy_bound(ring, slot, row0, mode: str):
    """The least time of the copy probe on these inputs: the distinct ring
    rows its copies read from device memory (for "local" the column's
    rows), the indices and the output, each once."""
    from devo_tpu_torch.ops import probe
    S, M, _ = probe.copy_plan(mode)
    n = slot.shape[0]
    if mode == "local":
        moved = probe.COLR * 128
    else:
        span = torch.arange(M * probe.WR, device=slot.device)
        rows = torch.cat([((slot.long() + s) * ring.shape[1] + row0.long())[:, None]
                          + span for s in range(S)])
        moved = int(torch.unique(rows).numel()) * 128
    return bound_of(moved + n * 8 + 128 * 4, n * S * 128)


def frame_bound(fmap, inputs, extract: bool):
    """The least time of the one-frame window product: the distinct frame
    positions the windows cover, the patch rows, offsets and the output,
    each once, and the products."""
    _, gm, y0, x08, ry, rx8 = inputs
    E = gm.shape[0]
    dev = gm.device
    pos = ((y0.long().reshape(E, 1, 1) + torch.arange(16, device=dev)[:, None])
           * fmap.shape[1] + 8 * x08.long().reshape(E, 1, 1)
           + torch.arange(24, device=dev))
    nbytes = (int(torch.unique(pos).numel()) * 128 * 2 + gm.numel() * 2
              + (y0.numel() + x08.numel() + ry.numel() + rx8.numel()) * 4
              + E * (8 if extract else 16) * 144 * 4)
    return bound_of(nbytes, 2.0 * E * 384 * 16 * 128)


def probe_record(record, name, label, err, ms, plain_ms, bound, gpu, extra=""):
    b_ms, b_by = bound
    print(f"{name} [{label}]: max_abs_err {err:.3e}{extra}; median kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) "
          f"[{gpu}]", flush=True)
    rec = record[name]
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec["variants"].append(dict(label=label, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
    if label == PROBE_REPORTED[name]:
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def probe_phase(dev, gpu: str, record):
    """The three probe kernels against their plain versions (ops/probe.py) on
    the card at their drivers' shapes, timed beside their bounds: the banded
    ablation in every mode and index layout (TOL, on the live blocks), the
    copy probe in every mode and route on one block and on one block an SM
    (exactly), tall8's refusal, and the one-frame window product with and
    without extraction (TOL)."""
    from devo_tpu_torch.ops import probe, probe_cuda
    from devo_tpu_torch.scripts import bench_banded_ablate as ablate
    from devo_tpu_torch.scripts import bench_gather, probe_desc_wall
    for name in PROBE_REPORTED:
        record[name] = dict(max_abs_err=0.0, variants=[])

    ring, g, ry, rx, layouts = ablate.inputs(dev, PROBE_E, PROBE_MEM, PROBE_NBX,
                                             PROBE_HP)
    nlive = torch.tensor([PROBE_LIVE], dtype=torch.int32, device=dev)
    live = -(-PROBE_LIVE // probe.BE) * probe.BE
    for layout, (slot, band, y0) in layouts.items():
        for mode in probe.ABLATE_MODES:
            args = (nlive, slot, band, y0, g, ry, rx, ring, mode)
            got = probe_cuda.band_ablate_cuda(*args)
            want = probe.band_ablate(*args)
            torch.cuda.synchronize()
            # the rows of blocks past nlive are left unwritten
            err = (got[:live] - want[:live]).abs().max().item()
            torch.testing.assert_close(got[:live], want[:live], **TOL)
            probe_record(record, "corr_band_ablate", f"{layout} {mode}", err,
                         median_ms(lambda: probe_cuda.band_ablate_cuda(*args)),
                         median_ms(lambda: probe.band_ablate(*args), 2, 3),
                         ablate_bound(ring, slot, band, y0, live, mode), gpu,
                         f" within atol {TOL['atol']} + rtol {TOL['rtol']} on "
                         f"{live} live rows of {PROBE_E}, output scale "
                         f"{want.abs().max().item():.3g}")
    del ring, g, ry, rx, layouts

    rows = probe.banded_shape(120, 160)[0] * probe.BWIN
    gen = torch.Generator(device=dev).manual_seed(0)
    ring8 = torch.randint(-127, 127, (PROBE_MEM, rows, 128), generator=gen,
                          device=dev, dtype=torch.int8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    for mode in probe_desc_wall.MODES:
        n = probe.copy_count(mode, COPY_ND)
        slot, row0 = probe_desc_wall.offsets(rng, mode, n, PROBE_MEM, rows, dev)
        want = probe.copy_probe(ring8, slot, row0, mode)
        plain_ms = median_ms(lambda: probe.copy_probe(ring8, slot, row0, mode), 2, 3)
        bound = copy_bound(ring8, slot, row0, mode)
        depth, ns = probe_cuda.copy_depth(mode)
        for route in probe_cuda.ROUTES:
            for blocks, what in ((1, "one block"), (sms, "one block an SM")):
                def fn(route=route, blocks=blocks):
                    return probe_cuda.copy_probe_cuda(ring8, slot, row0, mode,
                                                      route, blocks)
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"copy_probe [{mode} {route} {what}] is "
                                       f"not exact: max abs diff "
                                       f"{(got - want).abs().max().item()}")
                probe_record(record, "copy_probe", f"{mode} {route}, {what}",
                             0.0, median_ms(fn), plain_ms, bound, gpu,
                             f" (exact); {n} copies, ring of {depth} stage(s) "
                             f"in {ns} ring(s)")
    try:
        probe_cuda.copy_probe_cuda(ring8, slot[:8], row0[:8], "tall8")
    except ValueError as err:
        print(f"copy_probe [tall8]: refused as it must be: {err} [{gpu}]",
              flush=True)
    else:
        raise RuntimeError("copy_probe [tall8] was not refused")
    del ring8

    inputs = bench_gather.frame_inputs(rng, dev, PROBE_E)
    for extract in (True, False):
        got = probe_cuda.frame_probe_cuda(*inputs, extract=extract)
        want = probe.frame_windows(*inputs, extract=extract)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **TOL)
        probe_record(record, "corr_frame_probe", f"extract={extract}", err,
                     median_ms(lambda: probe_cuda.frame_probe_cuda(*inputs,
                                                                   extract=extract)),
                     median_ms(lambda: probe.frame_windows(*inputs, extract=extract),
                               2, 3),
                     frame_bound(inputs[0], inputs, extract), gpu,
                     f" within atol {TOL['atol']} + rtol {TOL['rtol']}, output "
                     f"scale {want.abs().max().item():.1f}")


# the drivers of devo_tpu_torch/scripts/: arguments (repeats cut where the
# full count would not fit the run) and the kernels each must launch, and no
# other; profile_step runs last of all (PROFILED_DRIVER)
DRIVERS = {
    "bench_banded_ablate": ([], ("corr_band_ablate",)),
    "bench_banded_ablate --drift": (["--drift", "--layouts", "random",
                                     "cyclic"], ("corr_band_ablate",)),
    "probe_desc_wall": (["--nit", "4", "--repeats", "3"], ("copy_probe",)),
    "bench_gather": ([], ("corr_frame_probe",)),
    "bench_banded_tune": ([], ("corr_level_full",)),
    "bench_banded_tune --depth 4 --stage noext": (
        ["--depth", "4", "--stage", "noext", "--repeats", "3"],
        ("corr_level_full",)),
    "bench_pallas": ([], ("corr_fixed",)),
    "bench_pallas2": ([], ("corr_fixed",)),
    "probe_level_split": ([], ("corr_level",)),
    "probe_l4_resident": ([], ("corr_level", "corr_level_resident")),
    "bench_eval_path": (["96", "--warm", "48"], ("corr_pyramid",)),
    "profile_step": ([], ("corr_pyramid",)),
}
PROFILED_DRIVER = "profile_step"


def driver_phase(dev, gpu: str, label: str):
    """One driver of DRIVERS through its main(), its output to
    chiprun_out/probes/. Returns the launches of each kernel in its run."""
    import contextlib
    import importlib
    import os
    from devo_tpu_torch.ops import corr_cuda
    argv, named = DRIVERS[label]
    module = importlib.import_module(f"devo_tpu_torch.scripts.{label.split()[0]}")
    os.makedirs(OUT_PROBES, exist_ok=True)
    path = os.path.join(OUT_PROBES, label.replace(" ", "_").replace("-", "") + ".txt")
    corr_cuda.reset_launches()
    t0 = time.perf_counter()
    with open(path, "w") as f, contextlib.redirect_stdout(f):
        module.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(corr_cuda.launches)
    with open(path) as f:
        tail = f.read().strip().splitlines()[-1]
    print(f"driver [{label}] ({wall:.1f} s, output in {path}): launches "
          f"{ {k: v for k, v in launches.items() if v} }; last line: {tail}",
          flush=True)
    others = [k for k, v in launches.items() if v and k not in named]
    if any(launches[k] < 1 for k in named) or others:
        raise RuntimeError(f"driver {label}: expected launches of {named} "
                           f"alone, got {launches}")
    return launches


def main():
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this smoke run needs the GPU")
    gpu = card()
    print(f"card: {gpu}", flush=True)
    dev = torch.device("cuda")
    # f32 matmuls and convolutions in full f32 (the networks run in bf16
    # under autocast; BA and geometry stay f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from devo_tpu_torch.ops import corr_cuda
    t0 = time.perf_counter()
    lib = corr_cuda.build()
    print(f"built {lib.name} from {[s.name for s in corr_cuda.sources()]} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(lib.with_suffix(".log").read_text().strip(), flush=True)

    record = kernel_phase(dev, gpu)
    by_path = {}
    probe_phase(dev, gpu, record)
    for label in DRIVERS:
        if label != PROFILED_DRIVER:
            by_path[label] = driver_phase(dev, gpu, label)
    for label, knobs in REFERENCE.items():
        reference_phase(dev, gpu, label, knobs)
    determinism_phase(dev, gpu)


    def run_slice(label):
        launches, err = slice_phase(dev, gpu, label, N_FRAMES,
                                    N_PROFILED if label == PROFILED else 0)
        by_path[label] = launches
        for name in PATHS[label][1]:
            record[name]["max_abs_err"] = max(record[name]["max_abs_err"], err)

    for label in PATHS:
        if label != PROFILED:
            run_slice(label)
    engine_cache = {}
    from devo_tpu_torch.bench import frames
    stream = [np.ascontiguousarray(v.transpose(2, 0, 1)) for v in frames(N_FRAMES)]
    for label, (_, name) in EVAL_PATHS.items():
        by_path[label], err = eval_phase(dev, gpu, label, engine_cache, stream)
        record[name]["max_abs_err"] = max(record[name]["max_abs_err"], err)
    del engine_cache, stream
    for label, (_, _, name) in BENCH_PATHS.items():
        by_path[label], err = bench_phase(dev, gpu, label)
        record[name]["max_abs_err"] = max(record[name]["max_abs_err"], err)
    run_slice(PROFILED)              # last: nothing is timed after a profile
    by_path[PROFILED_DRIVER] = driver_phase(dev, gpu, PROFILED_DRIVER)

    kernels = []
    for name, (source, replaces, _) in KERNELS.items():
        rec = record[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(path[name] for path in by_path.values()),
            "launches_by_path": {label: path[name]
                                 for label, path in by_path.items()},
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
            "tolerance": ("exact" if name == "copy_probe" else
                          ("one bf16 ulp of the largest product + "
                           if name == "corr_group" else "")
                          + f"atol {TOL['atol']} + rtol {TOL['rtol']}"),
            "reported_variant": (f"{PROBE_REPORTED[name]}, the driver's point"
                                 if name in PROBE_REPORTED
                                 else f"{REPORTED[name]}, E={E_MAIN}"),
            "variants": rec["variants"],
            **({"stages": rec["stages"]} if "stages" in rec else {})})
        if kernels[-1]["launches"] < 1:
            raise RuntimeError(f"{name} was launched on no path")
    # the order of the port's kernel work: a kernel slower than a PyTorch call
    # for the same function first (none has one), then by the time it loses
    # to its bound over this run's launches
    order = sorted(kernels, key=lambda k: -k["launches"] * (k["ms"] - k["bound_ms"]))
    print("kernels by launches x (ms - bound_ms), this run: " + ", ".join(
        f"{k['name']} {k['launches'] * (k['ms'] - k['bound_ms']):.1f}"
        for k in order), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
