"""Smoke run of devo_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py [--parent DIR]
    python3 chip_smoke.py --reference LABEL[:KEY=VALUE,...] [--reference ...]
        [--more-moves]

The second form builds the kernels and runs the reference phase (4 below)
alone, on the named entries of REFERENCE with VOConfig overrides;
`--more-moves` measures the CPU's spread under REF_MORE_MOVES too.

1. Prints the card (`nvidia-smi` name and power limit) and the torch / CUDA
   versions.
2. Builds the correlation kernels (csrc/*.cu for sm_90a, one nvcc process a
   file, all at once, then one link) into devo_tpu_torch/_build/ and prints
   ptxas's register report.
3. Kernel phase: every kernel against its plain PyTorch version on the
   card, at the tracking step's shapes (E = 12288 edges, E = 96 for the
   motion probe, a ragged odd E = 5003, E = 0; C = 128, mem = 32, rings of
   120x160 and 30x40, coordinates partly off the image): the six two-level
   kernels (corr_pyramid, corr_pair, corr_pair2, corr_mono2 with and
   without its gathering copy, corr_mono3) on bf16 and on int8 rings
   (corr_pyramid, corr_pair, corr_pair2 and corr_mono3 also on f32 patch
   features and rings), the per-level kernels (corr_level,
   corr_level_pipe, corr_group) on both levels and both ring types, the
   resident level-4 kernel on int8 rings with bf16 and f32 patch features,
   and the per-level kernels that
   take float rings only (corr_fixed for CORR_IMPL="pallas", corr_group8
   for "g8", corr_level_full for
   "full") on both levels, on bf16 and f32 rings; corr_level_full's stage
   instances (no extraction, no product, no copy) against their plain
   versions and timed beside it at E = 12288; every kernel
   choice of the entry point against corr_pyramid's kernel (both must floor
   the same coordinates); the kernels with staged windows at a narrow width
   (C = 8) whose int8 feature vectors are too short for the 16-byte copies,
   so that every tap reads the ring directly, and on patches distorted
   beyond the staged window. corr_group rounds every tap to bf16 before
   its scale, as the TPU's bf16 surface did: it is held against its own
   plain version (corr_level_group), which rounds at the same place, within
   one bf16 ulp of the largest product, and against the unrounded
   correlation within half an ulp; its surface instance, which writes the
   TPU kernel's own output and runs on no path, against ops/corr.
   group_surface within one ulp, timed beside a bound that counts the
   surface written and read. Max error against the stated tolerance, the
   median time of each, and the kernel's bound: the least time the card
   could take, the larger of the bytes it must move (the ring positions its
   taps touch, the distinct patch features, coordinates, indices, scales
   and the output, each once) over 3.35 TB/s and its operations over 989
   TFLOP/s (67 TFLOP/s, the f32 rate outside the tensor cores, on f32
   rings). The plans of the tensor-core kernels (corr_pyramid, corr_pair,
   corr_group, corr_level_pipe, corr_group8, corr_level_full, corr_mono2,
   corr_mono3, corr_pair2, corr_fixed):
   windows, stages, pipelines and blocks an SM, planned and by the occupancy
   query. The four structures of the edge pipeline that compute
   corr_pyramid's function (K1: two pipelines, two barriers a step; K5''
   corr_pair: K1's shape, schedule and plan under its own name; K4''
   corr_mono3: one pipeline of 512 threads, one barrier a step; K2''
   corr_pair2: persistent blocks of 256 threads, one barrier a step) by
   their C interfaces in turns at E = 12288 on int8 and bf16 rings,
   corr_pair2 also at two blocks an SM with smaller windows, and again on
   patches put back on an exact grid, whose windows all fit those; and the
   one-level instances in turns at both levels (LEVEL_STRUCTURES): K7''
   corr_level_pipe beside K6'' corr_level (its instance under another
   name, which must give its bits) and K8'' corr_group (the same shape with
   its taps rounded) on int8 rings, and K7'', K6'', K10'' corr_level_full, K9''
   corr_group8 and K8'' on bf16 rings; at level 4 on int8 rings with them
   K11'' corr_level_resident by its C interface on edges already sorted by
   slot and through its wrapper. The resident phase: K11'' on three
   distributions of the edges' ring slots (uniform, all on one slot, the
   10 newest slots), the same bits at two block counts (by its C
   interface) and through its wrapper, and the wrapper's sort and search
   timed apart from the kernel.
   With --parent DIR, a directory holding the parent commit's files of
   PARENT_SOURCES (K14'' copy_probe.cu, K13'' corr_band_ablate.cu and K15''
   corr_frame_probe.cu with their header window_probe.cuh, the kernels that
   include corr_mma.cuh beside them, and the headers corr_pipe.cuh,
   corr_common.cuh, corr_mma.cuh, from `git archive` of the parent), those
   are built into a library of their own and timed against this tree's in
   turns (parent, this tree, this tree, parent), each by its C interface
   (parent_ab): at E = 12288 corr_pyramid, corr_pair, corr_group,
   corr_level_pipe, corr_level and (bf16 rings) corr_group8 and
   corr_level_full at both levels (and corr_level, corr_level_full at
   level 1 on f32 rings), corr_mono2 gathered and in place, corr_mono3 and
   corr_pair2 on int8 and bf16 rings, and corr_level_resident at level 4
   on int8 rings, at this tree's plans, whose output must be the parent's
   bit for bit; in the probe phase, on its inputs, corr_band_ablate in
   every mode on the `random` layout and corr_frame_probe with and without
   extraction, at this tree's plan and edge order, to the parent's bits,
   and copy_probe in five modes on both copy routes at one block an SM and
   in `single` on one block, whose output must be the parent's exactly.
   Probe phase: the three probe kernels (ops/probe_cuda.py) against their
   plain versions (ops/probe.py) at their drivers' shapes, each timed beside
   its bound. First the window kernels' plan (ops/probe_cuda.window_plan)
   against their own shared-memory and occupancy queries in every mode,
   then their bits at two grids of persistent blocks (the wrapper's and 7:
   the same; corr_frame_probe also on the edges in their own order instead
   of the wrapper's sort by window origin), the ablation's ragged live gate
   (E = 1000 with nlive = 100, 0 and 1000 in every mode: the gate's rows
   within TOL, no other row written; E = 0: no launch), and with --parent
   their A/B (corr_frame_probe through its wrapper, sort included). Then the
   banded window ablation (corr_band_ablate, E = 15360 of which 6144 live,
   a 623 MB bf16 band ring) in its four modes and six index layouts within
   TOL on the live blocks, the copy probe (copy_probe, 9600 window copies
   of an int8 band ring) in seven modes on both copy routes, exactly at 1,
   7, 200 blocks and one an SM and timed at one block and one an SM, its
   order of the copies on the device (a counting sort by slot) against the
   plain version's exactly and timed alone, and its refusal of tall8, and
   the
   one-frame window product (corr_frame_probe, E = 15360) with and without
   extraction within TOL, with the windows it stages from L2 (the kernel's
   own count, which must be the grouping rule's worked out on the host), its
   wrapper's sort and the kernel alone timed apart (the sort's launches are
   counted under torch.profiler at the very end, and so is the device time
   of each of copy_probe's three kernels). Then every driver of
   devo_tpu_torch/scripts/ but profile_step, bench_window_variants and
   bench_copy_variants (which build variants of the probe kernels' sources)
   runs once through its main(),
   at its full repeat counts or fewer where those would not fit, its output
   under chiprun_out/probes/;
   each must launch the kernels it names and no other, and its launches
   are those the JSON record counts for the probe kernels.
4. Reference phase: the port's DEVO on the card against the same engine on
   the CPU (plain correlation; the CPU tests hold that path against the JAX
   package) at a small f32 size, for unquantised rings on every kernel
   choice and family (CORR_IMPL "pallas", "window", "gather") and for the
   int8 configurations, and for the frame input with the random selector
   (3-channel 0-255 frames, the selector's coordinates handed to both
   engines), also at TUM-RGBD's aspect (64x88: a level-1 map of 16x22),
   and the gradient selector (top-k): the same keyframes, culls,
   edge sets and new patch coordinates per frame, and poses and
   terminate() output (before and after the 12 extra updates) within one
   bound for every configuration: the stated tolerance, or twice the
   CPU's own spread where that is larger. The spread is the largest gap of
   the CPU port from itself with one input moved by one ulp (frames up,
   frames down, weights, depth draws): under random weights the frame and
   gradient trajectories amplify rounding that far on the CPU alone.
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
   corr_fixed), then with the gradient selector (bf16 rings, K1, one
   trial): random weights from seed 0 (a network without the scorer where
   the selector is not the scorer), an in-memory iterator
   of 48 frames of the same texture with intrinsics and timestamps, a
   straight-line ground truth, two trials on one cached engine, TUM dumps
   and a results JSON under OUT_DIR. Then the frame-input path
   (frames-rgb-random): the frame drivers' configuration
   (eval/frames.frame_config: EVS=False, 3 channels, the random selector,
   bf16 rings, K1) over 48 frames of the texture's first three bins mapped
   onto 0-255, from memory (no image tree is on the card), one trial,
   and the TUM-RGBD path (tum-rgb-random): the same at 256x352 with the
   freiburg1 intrinsics scaled as eval/frames.tum_image_iterator scales
   them; on both frame paths K1 is timed on the engine's final state beside
   its plain version and its bound (frame_k1_timing). It must hold one engine per
   configuration, as many poses from trial 0 as from a fresh engine, finite
   ATE / MPE / R_rmse that the independent ATE cross-check confirms, the
   artifacts on disk, one launch of the configuration's kernel per
   correlation of the run (two for corr_fixed, one a level) and no
   plain-correlation call. Under random
   weights the ATE says nothing about accuracy. Then the viewer phase:
   harness.run_voxel on the TUM path without and with the live viewer
   (runtime/viewer.py) snapshotting at every frame end: the same
   trajectory bit for bit, at least 10 snapshots, no failed render, PNGs
   where matplotlib is installed, frames/s of both. Then the live phase
   (LIVE_PATH): the native voxelizer (devo_tpu_torch/native, built with g++
   here) against data/event_utils.to_voxel_grid within 1e-3, then 48
   windows of seeded events on the sliding texture voxelized natively in
   the producer thread of data/stream.buffered and tracked in the default
   configuration at 480x640 (int8 rings, K1), K1 held against its plain
   version on the final state.
7. Bench phase: the bench entry point at full width,
   devo_tpu_torch.bench.run: the saturated 12288-edge point with the default
   kernel at the bench's full length (12 windows of 28 frames after the
   warm-up has brought the live edge count to the cap), then with each of
   CORR_KERNEL = split2, g8c, mono2, mono4, mono3 at 4 windows of 28 after
   the same warm-up rule, then the no-cull maximum-load point with the
   default kernel. Each prints the bench's JSON line and must reach its
   operating point, end with a finite pose per frame, and show launches > 0
   of the kernel it names, of no other, and no plain-correlation call.
   Train pieces phase (train_pieces_phase), no timing and no kernel of its
   own: ops/corr.corr_pyramid_train's forward at E = 12288 is the plain
   corr_pyramid's bits and within TOL of K1; its backward with the keep
   mask passed in, and the differentiable BA step's outputs and gradients
   (ops/ba.gauss_newton_step_diff), on the card against the CPU. Then the
   train phase (train_phase), no kernel of its own: one train step of
   devo_tpu_torch.train.trainer at small dims (TRAIN_SMALL) on the card
   against the CPU from the same weights and draws (loss terms, gradients,
   parameters, within TRAIN_TOL); the full-width step (TRAIN_FULL: dims
   384/128/32, 480x640, 15 frames, 18 iterations, 80 patches, batch 1, on
   synthetic clips of the sliding texture with a straight-line ground
   truth) three times with remat on and three with it off, each finite with
   grad_nonfinite 0 and moving parameters, its step ms and peak GiB on
   lines of their own, and one structure-only step; the stability run (50
   steps at small dims, PASS); the correlation counters read 0 across it.
   The
   profiled path of phase 5 runs after this one, then the trace phase
   (utils/timing.trace over 4 frames of the TUM path: the trace file names
   devo.update and K1's kernel), the g8c launch count
   (the int8 g8c configuration, 8 frames under torch.profiler after 24:
   kernel launches a frame, corr_group once a level and update, no
   tensor-code stage 2), and the profile_step driver, last.
8. Prints the order of the kernel work twice, by launches x (ms - bound)
   over every path and over the tracking paths alone (rule 2 of the port
   reads the second), each path's launches charged at the variant it runs
   (rule2_loss), the kernels' JSON record (all fifteen kernels; the
   probe kernels' launches are their drivers'), the card line, and as its
   last line
   {"ok": true, "device": {...}}.

With no CUDA device it exits non-zero before any result. Any failed build,
launch or check raises and exits non-zero.
"""
from __future__ import annotations

import hashlib
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
# the configurations of the eval phase, on EVAL_CONFIGS["eds"]: VOConfig
# overrides, the kernel each must launch, and its trials (a second trial
# resets the cached engine)
EVAL_PATHS = {
    "eval-eds-bf16-pair": (dict(CORR_KERNEL="pair"), "corr_pair", 2),
    "eval-eds-i8-pair2": (dict(CORR_KERNEL="pair2", CORR_RING_I8=True),
                          "corr_pair2", 2),
    "eval-eds-bf16-pallas": (dict(CORR_IMPL="pallas"), "corr_fixed", 2),
    "eval-eds-bf16-gradient": (dict(PATCH_SELECTOR="gradient"),
                               "corr_pyramid", 1),
}
# the frame-input path: evaluate_sequence in the frame drivers' configuration
# (eval/frames.frame_config: EVS=False, 3 channels, the random selector, the
# eval base's bf16 rings) over 3-channel 0-255 frames; overrides, kernel and
# trials as above
FRAME_PATHS = {"frames-rgb-random": (dict(), "corr_pyramid", 1),
               "tum-rgb-random": (dict(), "corr_pyramid", 1)}
# the frame size of each frame path: TUM-RGBD's is the evaluated 352x256
# (eval/frames.TUM_W x TUM_H, checked when the path runs), with its scaled
# freiburg1 intrinsics
FRAME_SIZES = {"frames-rgb-random": (HT, WD), "tum-rgb-random": (256, 352)}
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
    # corr_pyramid also on f32 patch features and rings of the same values
    # (MIXED_PRECISION=False), whose products stay on the CUDA cores
    f32 = tuple(r.float() for r in bf)
    for label, g, pyr, scales in (("bf16", gmap, bf, None), ("i8", gmap, i8, sc),
                                  ("f32", gmap.float(), f32, None)):
        out.append(("corr_pyramid", f"both levels {label}",
                    lambda g=g, pyr=pyr, scales=scales: cc.corr_pyramid_cuda(
                        g, pyr[0], pyr[1], coords, kk, jj, scales=scales),
                    lambda g=g, pyr=pyr, scales=scales: plain.corr_pyramid(
                        g, pyr, coords, kk, jj, scales=scales),
                    (pyr, (1, 4), scales or (None, None))))
    for label, pyr, scales in (("bf16", bf, None), ("i8", i8, sc)):
        ss = scales or (None, None)
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
    # the other two-level instances of the edge pipeline also on f32 patch
    # features and rings
    for name, fn in (("corr_pair", cc.corr_pair_cuda),
                     ("corr_pair2", cc.corr_pair2_cuda),
                     ("corr_mono3", cc.corr_mono3_cuda)):
        out.append((name, "both levels f32",
                    lambda fn=fn: fn(gmap.float(), f32[0], f32[1], coords, kk, jj),
                    lambda: plain.corr_pyramid(gmap.float(), f32, coords, kk, jj),
                    (f32, (1, 4), (None, None))))
    # the resident level 4 on bf16 patch features (the tensor cores) and f32
    # ones (the CUDA cores)
    for label, g in (("level 4 i8", gmap),
                     ("level 4 i8, f32 patch features", gmap.float())):
        out.append(("corr_level_resident", label,
                    lambda g=g: cc.corr_level_resident_cuda(g, i8[1], c4, kk, jj,
                                                            sc[1]),
                    lambda g=g: plain.corr_level(g, i8[1], c4, kk, jj, sc[1]),
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
# the default (int8) configurations run at the step's edge count (the order
# of the kernel work charges each path's launches at its own variant:
# rule2_loss)
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
            b_ms, b_by = bound_ms(g, rings, strides, scales, coords, kk, jj)
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
            group_surface_phase(case, gpu, record)
            full_stages(case, gpu, record)
            resident_phase(case, gpu, record)
            structures_phase(case, gpu, record)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for ring in (torch.bfloat16, torch.int8):
        cap, depth, blocks = cc.pair2_plan(3, 128, torch.bfloat16, ring)
        queried = cc.pair2_blocks_per_sm(3, 128, torch.bfloat16, ring)
        print(f"corr_pair2 [{ring} rings, C=128]: windows of {cap} vectors, "
              f"{depth} stages, {blocks} block(s) of 256 threads per SM planned "
              f"({queried} by the occupancy query), a persistent grid of "
              f"{cc.pair2_grid(E_MAIN, sms, queried)} blocks at E={E_MAIN} "
              f"[{gpu}]", flush=True)
        cap, depth = cc.mono3_plan(3, 128, torch.bfloat16, ring)
        print(f"corr_mono3 [{ring} rings, C=128]: windows of {cap} vectors, a "
              f"ring of {depth} stages, 1 block of 512 threads per SM planned "
              f"({cc.mono3_blocks_per_sm(3, 128, torch.bfloat16, ring)} by the "
              f"occupancy query), runs of {cc.mono3_run(E_MAIN, sms)} edges at "
              f"E={E_MAIN} [{gpu}]", flush=True)
        cap, depth, blocks = cc.mono_plan(3, 128, torch.bfloat16, ring)
        print(f"corr_pyramid [{ring} rings, C=128]: windows of {cap} vectors, "
              f"a ring of {depth} stages, {blocks} block(s) of 512 threads "
              f"per SM planned ({cc.mono_blocks_per_sm(3, 128, torch.bfloat16, ring)}"
              f" by the occupancy query), runs of {cc.mono_run(E_MAIN, dev)} "
              f"edges at E={E_MAIN} [{gpu}]", flush=True)
        occ = cc.mono_blocks_per_sm(3, 128, torch.bfloat16, ring, "corr_pair")
        print(f"corr_pair [{ring} rings, C=128]: corr_pyramid's plan, {occ} "
              f"block(s) of 512 threads per SM by the occupancy query [{gpu}]",
              flush=True)
        for name in ("corr_group", "corr_level_pipe", "corr_level"):
            cap, depth, blocks = cc.group_plan(3, 128, torch.bfloat16, ring)
            print(f"{name} [{ring} rings, C=128]: windows of {cap} vectors, a "
                  f"ring of {depth} stages (two pipelines), {blocks} block(s) "
                  f"of 512 threads per SM planned "
                  f"({cc.group_blocks_per_sm(3, 128, torch.bfloat16, ring, name)}"
                  f" by the occupancy query), runs of "
                  f"{cc.group_run(E_MAIN, dev, blocks)} edges at E={E_MAIN} "
                  f"({cc.group_smem_bytes(3, 128, torch.bfloat16, ring, cap, depth)}"
                  f" bytes a block) [{gpu}]", flush=True)
        cap, depth, pipes = cc.mono2_plan(3, 128, torch.bfloat16, ring)
        print(f"corr_mono2 [{ring} rings, C=128]: windows of {cap} vectors, "
              f"{pipes} pipeline(s) of a pair of edges a step, {depth} stage(s)"
              f" a block, 1 block of 512 threads per SM planned "
              f"({cc.mono2_blocks_per_sm(3, 128, torch.bfloat16, ring)} by the "
              f"occupancy query), runs of {cc.mono2_run(E_MAIN, dev)} edges at "
              f"E={E_MAIN} [{gpu}]", flush=True)
    for ring in (torch.bfloat16, torch.float32):
        for name in ("corr_group8", "corr_level_full"):
            cap, depth, blocks = cc.group_plan(3, 128, ring, ring)
            print(f"{name} [{ring} rings, C=128]: windows of {cap} vectors, a "
                  f"ring of {depth} stages (two pipelines), {blocks} block(s) "
                  f"of 512 threads per SM planned "
                  f"({cc.group_blocks_per_sm(3, 128, ring, ring, name)} by the "
                  f"occupancy query), runs of {cc.group_run(E_MAIN, dev, blocks)}"
                  f" edges at E={E_MAIN} "
                  f"({cc.group_smem_bytes(3, 128, ring, ring, cap, depth)} bytes"
                  f" a block) [{gpu}]", flush=True)
    for g in (torch.bfloat16, torch.float32):
        warps, cap, smem = cc.resident_plan(HT // 16, WD // 16, 128, 3, g)
        print(f"corr_level_resident [int8 rings, {g} patch features, C=128, "
              f"{HT // 16}x{WD // 16} frame]: {warps} warps a block, windows of "
              f"{cap} positions on the surface, {smem} bytes a block, "
              f"{cc._sms(dev)} persistent blocks [{gpu}]", flush=True)
    stages, blocks = cc.fixed_plan(3, 128, torch.bfloat16)
    print(f"corr_fixed [bf16 rings, C=128]: a ring of {stages} stages of 384 "
          f"positions x 32 channels, {blocks} block(s) of 256 threads per SM "
          f"planned ({cc.fixed_blocks_per_sm(3, 128, torch.bfloat16)} by the "
          f"occupancy query), a block an edge [{gpu}]", flush=True)
    empty_case(dev, gpu)
    narrow_case(dev, gpu, record)
    wide_case(dev, gpu, record)
    return record


def c_two_level(lib, name, gmap, pyr, coords, kk, jj, scales, plan):
    """One launch of the two-level kernel devo_<name> of `lib` (this tree's
    library where None) by its C interface, without the wrapper's checks and
    host work, so that two versions are timed alike: `plan` is (cap, the
    integers after the type flags)."""
    from devo_tpu_torch.ops import corr_cuda as cc
    lib = lib or cc._load()
    cap, extra = plan
    E, C = coords.shape[0], gmap.shape[-1]
    out = torch.empty((E, 2 * 49 * 9), dtype=torch.float32, device=gmap.device)
    ss = scales or (None, None)
    code = getattr(lib, "devo_" + name)(
        gmap.data_ptr(), pyr[0].data_ptr(), pyr[1].data_ptr(),
        *(None if t is None else t.data_ptr() for t in ss), coords.data_ptr(),
        kk.data_ptr(), jj.data_ptr(), out.data_ptr(), E, 9, C, pyr[0].shape[1],
        pyr[0].shape[2], pyr[1].shape[1], pyr[1].shape[2], cap, 1.0, 4.0,
        int(gmap.dtype == torch.bfloat16), int(scales is not None), *extra,
        torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"{name} by its C interface: launch failed ({code})")
    return out


def tree_plan(name, gmap, ring, E, concat=True):
    """(cap, integers after the type flags) of this tree's two-level kernel
    devo_<name> as its wrapper launches it on E edges."""
    from devo_tpu_torch.ops import corr_cuda as cc
    C, dev, g = gmap.shape[-1], gmap.device, gmap.dtype
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if name in ("corr_pyramid", "corr_pair"):
        cap, depth, _ = cc.mono_plan(3, C, g, ring)
        return cap, (depth, cc.mono_run(E, dev))
    if name == "corr_mono2":
        cap, depth, pipes = cc.mono2_plan(3, C, g, ring)
        return cap, (int(concat), depth, pipes, cc.mono2_run(E, dev))
    if name == "corr_mono3":
        cap, depth = cc.mono3_plan(3, C, g, ring)
        return cap, (depth, cc.mono3_run(E, sms))
    cap, depth, _ = cc.pair2_plan(3, C, g, ring)
    return cap, (depth, cc.pair2_grid(E, sms, cc.pair2_blocks_per_sm(3, C, g,
                                                                     ring)))


def in_turns(fns):
    """Median times of `fns`, measured in turns forward and then backward:
    two times each."""
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    times = [median_ms(fns[k]) for k in order]
    return [[t for t, i in zip(times, order) if i == k] for k in range(len(fns))]


def structures_phase(case, gpu: str, record):
    """The four structures of the edge pipeline that compute corr_pyramid's
    function, by their C interfaces at E = 12288, each held to corr_pyramid
    within TOL and then timed in turns (forward, then backward): K1 (two
    pipelines of 256 threads a block, two barriers a step), K5'' (K1's
    shape, schedule and plan in a kernel of its own), K4'' (one
    pipeline of 512 threads, rotating slots, one barrier a step) and K2''
    (persistent blocks of 256 threads, one barrier a step) at their wrappers'
    plans, and on int8 rings K2'' also at two blocks an SM, which its
    windows of 128 vectors allow. On the kernel phase's inputs (int8 and
    bf16 rings), where windows beyond 128 vectors read the ring, and on
    their patches put back on an exact unit grid (int8 rings), where every
    level-1 window is 10x10 vectors and none reads the ring. Then the
    one-level instances at both levels (level_structures)."""
    from devo_tpu_torch.ops import corr as plain
    from devo_tpu_torch.ops import corr_cuda as cc
    gmap, bf, i8, sc, coords, kk, jj = case
    E = coords.shape[0]
    sms = torch.cuda.get_device_properties(gmap.device).multi_processor_count
    center = coords[:, 1, 1, :]
    off = torch.arange(-1.0, 2.0, device=coords.device)
    tight = torch.stack([(center[:, None, None, 0] + off[None, None, :]).expand(E, 3, 3),
                         (center[:, None, None, 1] + off[None, :, None]).expand(E, 3, 3)],
                        -1).contiguous()
    blocks = cc._occupancy("corr_pair2", cc._load().devo_corr_pair2_blocks_per_sm(
        9, gmap.shape[-1], 128, cc.PAIR2_DEPTH, 1, 1))
    shared = (128, (cc.PAIR2_DEPTH, cc.pair2_grid(E, sms, blocks)))
    for what, c, pyr, scales in (("i8 rings", coords, i8, sc),
                                 ("bf16 rings", coords, bf, None),
                                 ("i8 rings, tight patches", tight, i8, sc)):
        versions = [(label, name, tree_plan(name, gmap, pyr[0].dtype, E))
                    for label, name in (("K1", "corr_pyramid"),
                                        ("K5''", "corr_pair"),
                                        ("K4''", "corr_mono3"),
                                        ("K2''", "corr_pair2"))]
        if scales is not None:
            versions.append((f"K2'' windows of 128, {blocks} blocks an SM",
                             "corr_pair2", shared))
        want = plain.corr_pyramid(gmap, pyr, c, kk, jj, scales=scales)
        fns = []
        for _, name, plan in versions:
            fns.append(lambda name=name, plan=plan, c=c, pyr=pyr, scales=scales:
                       c_two_level(None, name, gmap, pyr, c, kk, jj, scales,
                                   plan))
            torch.testing.assert_close(fns[-1](), want, **TOL)
        ms = in_turns(fns)
        for (label, name, plan), t in zip(versions, ms):
            record[name].setdefault("structures", []).append(dict(
                label=f"{label} [{what}]", E=E, cap=plan[0], ms=t))
        print(f"structures [{what}] E={E}, in turns forward and back: "
              + "; ".join(f"{label} (windows of {plan[0]}) {t[0]:.4f}, "
                          f"{t[1]:.4f}" for (label, _, plan), t in
                          zip(versions, ms))
              + f" ms [{gpu}]", flush=True)
    level_structures(case, gpu, record)


# the one-level instances of the edge pipeline timed beside each other in
# the structures phase, by ring: (label, kernel name)
LEVEL_STRUCTURES = {
    "i8": (("K7''", "corr_level_pipe"), ("K6'' (P)", "corr_level"),
           ("K8'' (taps rounded to bf16)", "corr_group")),
    "bf16": (("K7''", "corr_level_pipe"), ("K6'' (P)", "corr_level"),
             ("K10''", "corr_level_full"), ("K9''", "corr_group8"),
             ("K8'' (taps rounded to bf16)", "corr_group")),
}


def level_structures(case, gpu: str, record):
    """The one-level instances of the edge pipeline (LEVEL_STRUCTURES) by
    their C interfaces at E = 12288, at both levels on int8 and bf16 rings,
    each held to its plain version (corr_level; corr_group to
    corr_level_group within group_tol) and timed in turns forward and back:
    K7'', K6'' (P) and K10'' (corr_group8's shape and plan) beside K8''
    (the same shape with rounded taps) and K9'' (the same instance on float
    rings); K6'' (P) must give K7'''s bits. At level 4 on int8 rings K11'' (the
    resident frame) in the same turns, by its C interface on the edges
    already sorted by slot and through its wrapper with the sort."""
    from devo_tpu_torch.ops import corr as plain
    from devo_tpu_torch.ops import corr_cuda as cc
    gmap, bf, i8, sc, coords, kk, jj = case
    E = coords.shape[0]
    for ring, pyr, scales in (("i8", i8, sc), ("bf16", bf, None)):
        ss = scales or (None, None)
        for n, (lvl, c) in enumerate(((1, coords), (4, coords / 4))):
            fmap, scale = pyr[n], ss[n]
            want = plain.corr_level(gmap, fmap, c, kk, jj, scale)
            fns, versions, outs = [], [], {}
            for label, name in LEVEL_STRUCTURES[ring]:
                plan = level_plan(name, gmap, fmap, E)
                fns.append(lambda name=name, plan=plan, c=c, fmap=fmap,
                           scale=scale: c_level(None, name, gmap, fmap, c, kk,
                                                jj, scale, plan))
                outs[name] = got = fns[-1]()
                if name == "corr_group":
                    want_g = plain.corr_level_group(gmap, fmap, c, kk, jj, scale)
                    torch.testing.assert_close(got, want_g, **group_tol(want_g))
                else:
                    torch.testing.assert_close(got, want, **TOL)
                versions.append((label, name,
                                 f"windows of {plan[0]}, {plan[1][0]} stages"))
            if not torch.equal(outs["corr_level"], outs["corr_level_pipe"]):
                raise RuntimeError(f"K6'' (P) [level {lvl}, {ring} rings]: not "
                                   f"K7'''s bits")
            if ring == "i8" and lvl == 4:
                warps, cap, _ = cc.resident_plan(*fmap.shape[1:], gmap.shape[1],
                                                 gmap.dtype)
                sorted_ = cc.resident_order(jj, fmap.shape[0])
                blocks = cc._sms(gmap.device)
                fns.append(lambda c=c, fmap=fmap, scale=scale: c_resident(
                    None, gmap, fmap, c, kk, scale, sorted_,
                    (cap, warps, blocks)))
                fns.append(lambda c=c, fmap=fmap, scale=scale:
                           cc.corr_level_resident_cuda(gmap, fmap, c, kk, jj,
                                                       scale))
                for f in fns[-2:]:
                    torch.testing.assert_close(f(), want, **TOL)
                versions += [("K11'' (kernel alone)", "corr_level_resident",
                              f"{warps} warps, {blocks} blocks"),
                             ("K11'' (wrapper, with the sort)",
                              "corr_level_resident", "the same")]
            ms = in_turns(fns)
            what = f"level {lvl}, {ring} rings"
            for (label, name, plan), t in zip(versions, ms):
                record[name].setdefault("structures", []).append(
                    dict(label=f"{label} [{what}]", E=E, plan=plan, ms=t))
            print(f"structures [{what}] E={E}, in turns forward and back: "
                  + "; ".join(f"{label} ({plan}) {t[0]:.4f}, {t[1]:.4f}"
                              for (label, _, plan), t in zip(versions, ms))
                  + f" ms; K6'' (P) gives K7'''s bits [{gpu}]", flush=True)


def c_resident(lib, gmap, fmap, coords, kk, scale, sorted_, plan):
    """One launch of devo_corr_level_resident of `lib` (this tree's library
    where None) by its C interface on edges already sorted by slot
    (`sorted_`: ops/corr_cuda.resident_order's (order, slots, offsets)),
    with `plan` = (cap, warps, blocks)."""
    from devo_tpu_torch.ops import corr_cuda as cc
    lib = lib or cc._load()
    E, C, PP = coords.shape[0], gmap.shape[-1], gmap.shape[1] ** 2
    _, h, w, _ = fmap.shape
    order, slots, offsets = sorted_
    out = torch.empty((E, 49 * PP), dtype=torch.float32, device=gmap.device)
    cap, warps, blocks = plan
    code = lib.devo_corr_level_resident(
        gmap.data_ptr(), fmap.data_ptr(), scale.data_ptr(), coords.data_ptr(),
        kk.data_ptr(), order.data_ptr(), slots.data_ptr(), offsets.data_ptr(),
        out.data_ptr(), E, PP, C, h, w, cap, int(gmap.dtype == torch.bfloat16),
        warps, blocks, torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"corr_level_resident by its C interface: launch "
                           f"failed ({code})")
    return out


def resident_phase(case, gpu: str, record):
    """K11'' (the resident level 4) at E = 12288 on int8 rings with bf16
    patch features, on three distributions of jj: the kernel phase's
    uniform one, every edge on one slot, and the edges on the 10 newest
    slots (the tracking path's shape). Each: within TOL of corr_level; the
    same bits at two block counts by the C interface (one an SM, and 7) and
    through the wrapper; the blocks' edge counts and the frames they copy,
    worked out on the host from the kernel's split of the sorted edges (not
    counted by the kernel); and timed apart, the wrapper, the kernel alone
    by its C interface on the sorted edges, and the wrapper's sort and
    search alone."""
    from devo_tpu_torch.ops import corr as plain
    from devo_tpu_torch.ops import corr_cuda as cc
    gmap, bf, i8, sc, coords, kk, jj = case
    fmap, scale, c4 = i8[1], sc[1], coords / 4
    E, mem = coords.shape[0], fmap.shape[0]
    sms = cc._sms(gmap.device)
    warps, cap, smem = cc.resident_plan(*fmap.shape[1:], gmap.shape[1],
                                        gmap.dtype)
    g = torch.Generator(device=gmap.device).manual_seed(7)
    newest = (mem - 1 - torch.randint(0, 10, (E,), generator=g,
                                      device=gmap.device)).to(torch.int32)
    rec = record["corr_level_resident"].setdefault("distributions", [])
    for what, slots in (("uniform", jj), ("one slot", torch.full_like(jj, 5)),
                        ("10 newest slots", newest)):
        want = plain.corr_level(gmap, fmap, c4, kk, slots, scale)
        sorted_ = cc.resident_order(slots, mem)
        got = {b: c_resident(None, gmap, fmap, c4, kk, scale, sorted_,
                             (cap, warps, b)) for b in (sms, 7)}
        again = cc.corr_level_resident_cuda(gmap, fmap, c4, kk, slots, scale)
        torch.cuda.synchronize()
        err = (again - want).abs().max().item()
        torch.testing.assert_close(again, want, **TOL)
        if not (torch.equal(got[sms], got[7]) and torch.equal(got[sms], again)):
            raise RuntimeError(f"K11'' [{what}]: other bits at another block "
                               f"count or launch")
        # each block's share of the sorted edges and the frames it copies
        # (its runs of one slot), by the kernel's split formula on the host
        cuts = [b * E // sms for b in range(sms + 1)]
        ordered = sorted_[1].cpu()
        frames = sum(int(torch.unique_consecutive(ordered[a:b]).numel())
                     for a, b in zip(cuts, cuts[1:]) if b > a)
        counts = [b - a for a, b in zip(cuts, cuts[1:])]
        ms = median_ms(lambda: cc.corr_level_resident_cuda(gmap, fmap, c4, kk,
                                                           slots, scale))
        alone = median_ms(lambda: c_resident(None, gmap, fmap, c4, kk, scale,
                                             sorted_, (cap, warps, sms)))
        sort_ms = median_ms(lambda: cc.resident_order(slots, mem))
        b_ms, _ = bound_ms(gmap, (fmap,), (4,), (scale,), coords, kk, slots)
        rec.append(dict(label=what, E=E, max_abs_err=err, ms=ms, kernel_ms=alone,
                        sort_ms=sort_ms, bound_ms=b_ms, frames=frames,
                        edges_per_block=[min(counts), max(counts)]))
        record["corr_level_resident"]["max_abs_err"] = max(
            record["corr_level_resident"]["max_abs_err"], err)
        print(f"corr_level_resident [{what}, level 4 i8] E={E}: max_abs_err "
              f"{err:.3e}; the same bits at {sms} and 7 blocks and in two "
              f"launches; {warps} warps a block ({smem} bytes); by the split "
              f"formula {min(counts)}-{max(counts)} edges a block, {frames} "
              f"frames copied; wrapper "
              f"{ms:.4f} ms, kernel alone {alone:.4f} ms, sort and search "
              f"{sort_ms:.4f} ms, bound {b_ms:.4f} ms [{gpu}]", flush=True)


# the kernels redesigned since the parent commit (K13', K15'), the kernels
# that include csrc/corr_mma.cuh beside them (K1, K5'', K2'', K3'', K4'',
# K8'', K9'', K7'', K10'', K6'' on the edge pipeline, and K11''), and the
# sources a build of the parent's versions takes from the directory given by
# --parent
PARENT_SOURCES = ("corr.cu", "corr_pair.cu", "corr_pair2.cu", "corr_mono2.cu",
                  "corr_mono3.cu", "corr_group.cu", "corr_group8.cu",
                  "corr_level_pipe.cu", "corr_level_full.cu", "corr_level.cu",
                  "corr_level_resident.cu", "corr_band_ablate.cu",
                  "corr_frame_probe.cu", "copy_probe.cu", "corr_pipe.cuh",
                  "corr_common.cuh", "corr_mma.cuh", "window_probe.cuh")


def parent_library(parent_dir: str):
    """The parent commit's kernels of PARENT_SOURCES built from parent_dir (a
    copy of them and their headers) into a library of their own, with the
    parent's C interfaces, which are this tree's."""
    import ctypes
    from pathlib import Path
    from devo_tpu_torch.ops import corr_cuda
    src = Path(parent_dir)
    missing = [n for n in PARENT_SOURCES if not (src / n).is_file()]
    if missing:
        raise RuntimeError(f"--parent {parent_dir}: missing {missing}")
    lib = ctypes.CDLL(str(corr_cuda.build(src)))
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    two = [ptr] * 9 + [i] * 8 + [f] * 2
    lib.devo_corr_pyramid.argtypes = two + [i] * 4 + [ptr]
    lib.devo_corr_pair.argtypes = two + [i] * 4 + [ptr]
    lib.devo_corr_group.argtypes = [ptr] * 7 + [i] * 10 + [ptr]
    lib.devo_corr_mono2.argtypes = two + [i] * 6 + [ptr]
    lib.devo_corr_mono3.argtypes = two + [i] * 4 + [ptr]
    lib.devo_corr_pair2.argtypes = two + [i] * 4 + [ptr]
    lib.devo_corr_group8.argtypes = [ptr] * 6 + [i] * 9 + [ptr]
    lib.devo_corr_level_pipe.argtypes = [ptr] * 7 + [i] * 10 + [ptr]
    lib.devo_corr_level_full.argtypes = [ptr] * 6 + [i] * 10 + [ptr]
    lib.devo_corr_level.argtypes = [ptr] * 7 + [i] * 10 + [ptr]
    lib.devo_corr_level_resident.argtypes = [ptr] * 9 + [i] * 9 + [ptr]
    lib.devo_corr_band_ablate.argtypes = [ptr] * 9 + [i] * 6 + [ptr]
    lib.devo_corr_frame_probe.argtypes = [ptr] * 8 + [i] * 5 + [ptr] * 2
    lib.devo_copy_probe.argtypes = [ptr] * 6 + [ctypes.c_longlong] + [i] * 10 + [ptr]
    for fn in (lib.devo_corr_pyramid, lib.devo_corr_pair, lib.devo_corr_group,
               lib.devo_corr_mono2, lib.devo_corr_mono3, lib.devo_corr_pair2,
               lib.devo_corr_group8, lib.devo_corr_level_pipe,
               lib.devo_corr_level_full, lib.devo_corr_level,
               lib.devo_corr_level_resident, lib.devo_corr_band_ablate,
               lib.devo_corr_frame_probe, lib.devo_copy_probe):
        fn.restype = ctypes.c_int
    return lib


def level_plan(name, gmap, fmap, E):
    """(cap, integers after the type flags) of this tree's one-level kernel
    devo_<name> as its wrapper launches it on E edges: group_plan and
    group_run (corr_level_full's correlation stage)."""
    from devo_tpu_torch.ops import corr_cuda as cc
    cap, depth, blocks = cc.group_plan(3, gmap.shape[-1], gmap.dtype,
                                       fmap.dtype)
    extra = (depth, cc.group_run(E, gmap.device, blocks))
    return cap, (extra + (0,) if name == "corr_level_full" else extra)


# the one-level kernels whose C interface takes the ring slots' scales and
# two type flags (patch features, ring); the others take float rings and
# one flag
SCALED_LEVEL = ("corr_group", "corr_level_pipe", "corr_level")


def c_level(lib, name, gmap, fmap, coords, kk, jj, scale, plan):
    """One launch of the one-level kernel devo_<name> of `lib` (this tree's
    library where None) by its C interface: `plan` is (cap, the integers
    after the type flags)."""
    from devo_tpu_torch.ops import corr_cuda as cc
    lib = lib or cc._load()
    E, C = coords.shape[0], gmap.shape[-1]
    cap, extra = plan
    bf16 = int(gmap.dtype == torch.bfloat16)
    if name in SCALED_LEVEL:
        head = (None if scale is None else scale.data_ptr(),)
        flags = (bf16, int(scale is not None))
    else:
        head, flags = (), (bf16,)
    out = torch.empty((E, 49 * 9), dtype=torch.float32, device=gmap.device)
    code = getattr(lib, "devo_" + name)(
        gmap.data_ptr(), fmap.data_ptr(), *head, coords.data_ptr(),
        kk.data_ptr(), jj.data_ptr(), out.data_ptr(), E, 9, C, fmap.shape[1],
        fmap.shape[2], cap, *flags, *extra,
        torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"{name} by its C interface: launch failed ({code})")
    return out


def parent_ab():
    """What the A/B against the parent compares: (kernel, label, rule), rule
    "tol" for a kernel redesigned since the parent (each version at its own
    plan, held to each other within TOL) and "bits" for one that must give
    the parent's bits (or, for the copy probe, its exact output) at this
    tree's plan. K6'' at levels 1 and 4 on int8 and bf16 rings and at level
    1 on f32 rings, K11'' at level 4 on int8 rings and the other kernels on
    the edge pipeline on int8 and bf16 rings (K9'', K10'' on bf16 rings
    alone, K10'' also at level 1 on f32), K13'' in every mode on the
    `random` layout and K15'' with and without extraction, to the parent's
    bits; and K14'' (the copy probe) in COPY_AB_MODES on both copy routes
    at one block an SM, and `single` on one block, to the parent's exact
    output."""
    from devo_tpu_torch.ops.probe import ABLATE_MODES
    from devo_tpu_torch.ops.probe_cuda import ROUTES
    out = []
    for ring in ("i8", "bf16"):
        for name in ("corr_level", "corr_level_pipe", "corr_group") + (
                ("corr_group8", "corr_level_full") if ring == "bf16" else ()):
            out += [(name, f"level {lvl} {ring}", "bits") for lvl in (1, 4)]
        out += [(name, f"both levels {ring}", "bits") for name in
                ("corr_pyramid", "corr_pair", "corr_mono3", "corr_pair2")]
        out += [("corr_mono2", f"both levels {ring} {what}", "bits")
                for what in ("gathered", "in place")]
    out += [("corr_level", "level 1 f32", "bits"),
            ("corr_level_full", "level 1 f32", "bits"),
            ("corr_level_resident", "level 4 i8", "bits")]
    out += [("corr_band_ablate", f"random {mode}", "bits")
            for mode in ABLATE_MODES]
    out += [("corr_frame_probe", f"extract={x}", "bits") for x in (True, False)]
    out += [("copy_probe", f"{mode} {route}", "bits") for mode in COPY_AB_MODES
            for route in ROUTES]
    out += [("copy_probe", f"single {route}, one block", "bits") for route in ROUTES]
    return out


def ab_turns(name, label, rule, old, new, record, gpu, rows=None):
    """One A/B of parent_ab: the parent's version `old` and this tree's
    `new` held to each other by `rule` (on their first `rows` rows where
    given), then timed in turns, parent, this tree, this tree, parent; the
    times go to record[name]["parent_ab"]."""
    a, b = old()[:rows], new()[:rows]
    torch.cuda.synchronize()
    if rule == "bits":
        if not torch.equal(a, b):
            raise RuntimeError(f"{name} [{label}]: not the parent's bits")
    else:
        torch.testing.assert_close(b, a, **TOL)
    times = [median_ms(fn) for fn in (old, new, new, old)]
    record[name].setdefault("parent_ab", []).append(
        dict(label=label, E=b.shape[0], parent_ms=[times[0], times[3]],
             ms=[times[1], times[2]], same_bits=bool(torch.equal(a, b))))
    print(f"A/B {name} [{label}] E={b.shape[0]}: parent {times[0]:.4f}, "
          f"{times[3]:.4f} ms; this tree {times[1]:.4f}, {times[2]:.4f} ms (in "
          f"turns parent, tree, tree, parent); max abs diff "
          f"{(b - a).abs().max().item():.3e}"
          f"{', bit for bit' if torch.equal(a, b) else ''} [{gpu}]", flush=True)


def parent_phase(dev, gpu: str, lib, record):
    """The correlation kernels against the parent's versions of them
    (parent_ab, the probe kernels aside, which the probe phase compares on
    its own inputs), on the kernel phase's inputs at E = 12288, each version
    by its C interface at this tree's plan, which must give the parent's
    bits. `lib`: the parent's library (parent_library)."""
    from devo_tpu_torch.ops import corr_cuda as cc
    gmap, bf, i8, sc, coords, kk, jj = corr_case(E_MAIN, dev, 0)
    E = coords.shape[0]
    rings = {"i8": (gmap, i8, sc), "bf16": (gmap, bf, None),
             "f32": (gmap.float(), tuple(r.float() for r in bf), None)}

    def versions(name, label):
        ring = label.split()[-1] if name != "corr_mono2" else label.split()[2]
        g, pyr, scales = rings[ring]
        if label.startswith("both levels"):
            concat = not label.endswith("in place")
            plan = tree_plan(name, g, pyr[0].dtype, E, concat)
            return [lambda x=x: c_two_level(x, name, g, pyr, coords, kk, jj,
                                            scales, plan) for x in (lib, None)]
        n = 0 if label.startswith("level 1") else 1
        c, fmap = coords / (1, 4)[n], pyr[n]
        scale = None if scales is None else scales[n]
        if name == "corr_level_resident":
            sorted_ = cc.resident_order(jj, fmap.shape[0])
            warps, cap, _ = cc.resident_plan(*fmap.shape[1:], g.shape[1],
                                             g.dtype)
            plan = (cap, warps, cc._sms(dev))
            return [lambda x=x: c_resident(x, g, fmap, c, kk, scale, sorted_,
                                           plan) for x in (lib, None)]
        plan = level_plan(name, g, fmap, E)
        return [lambda x=x: c_level(x, name, g, fmap, c, kk, jj, scale, plan)
                for x in (lib, None)]

    for name, label, rule in parent_ab():
        if name not in PROBE_REPORTED:
            ab_turns(name, label, rule, *versions(name, label), record, gpu)


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


def surface_mask(coords, cap):
    """(ceil(E / 8), GROUP_ROWS, 128) bool: the rows and lanes that
    corr_group's surface instance writes (an edge's window positions, or its
    64 taps where the window exceeds cap)."""
    from devo_tpu_torch.ops import corr as plain
    _, y0, _, _, ww, wide = plain._group_index(coords, cap)
    wh = y0.amax(1, keepdim=True) - y0.amin(1, keepdim=True) + 8
    n_rows = torch.where(wide, torch.full_like(ww, 64), ww * wh)[:, 0]
    E, G, R = coords.shape[0], -(-coords.shape[0] // 8), plain.GROUP_ROWS
    mask = torch.zeros((G * 8, R), dtype=torch.bool, device=coords.device)
    mask[:E] = torch.arange(R, device=coords.device)[None, :] < n_rows[:, None]
    return (mask.reshape(G, 8, R, 1).expand(G, 8, R, 16).transpose(1, 2)
            .reshape(G, R, 128))


def group_surface_phase(case, gpu: str, record):
    """corr_group's surface instance (the TPU kernel's own output, which no
    path launches) at the step's edge count on both levels and ring types:
    against ops/corr.group_surface at the same cap on the rows and lanes it
    writes within one bf16 ulp of the largest product, zero elsewhere; timed
    beside its bound with the surface's write and read counted."""
    from devo_tpu_torch.ops import corr as plain
    from devo_tpu_torch.ops import corr_cuda as cc
    gmap, bf, i8, sc, coords, kk, jj = case
    out = record["corr_group"].setdefault("surface_instance", [])
    for n, (lvl, c) in enumerate(((1, coords), (4, coords / 4))):
        for label, ring, scale in (("bf16", bf[n], None), ("i8", i8[n], sc[n])):
            got, cap = cc.group_surface_cuda(gmap, ring, c, kk, jj, scale)
            want = plain.group_surface(gmap, ring, c, kk, jj, cap=cap)
            torch.cuda.synchronize()
            mask = surface_mask(c, cap)
            g, w = got.float(), want.float()
            if g[~mask].abs().max().item() != 0:
                raise RuntimeError("corr_group_surface wrote outside its rows")
            top = w[mask].abs().max().item()
            err = (g[mask] - w[mask]).abs().max().item()
            torch.testing.assert_close(g[mask], w[mask], atol=2.0 ** -7 * top,
                                       rtol=0)
            ms = median_ms(lambda: cc.group_surface_cuda(gmap, ring, c, kk, jj,
                                                         scale))
            b_ms, b_by = bound_ms(gmap, (ring,), (lvl,), (scale,), coords, kk,
                                  jj, surface=True)
            out.append(dict(label=f"level {lvl} {label}", max_abs_err=err,
                            ms=ms, bound_ms=b_ms, bound_by=b_by))
            print(f"corr_group_surface [level {lvl} {label}] E={coords.shape[0]}:"
                  f" max_abs_err {err:.3e} within one bf16 ulp of the largest "
                  f"product ({2.0 ** -7 * top:.3g}), equal on "
                  f"{(g[mask] == w[mask]).float().mean().item():.4f} of the "
                  f"written values; median {ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}, the surface written and read) [{gpu}]", flush=True)


def full_stages(case, gpu: str, record):
    """corr_level_full's stage instances at the step's edge count, level 1,
    bf16 rings, each against its plain version (ops/corr.corr_level_stage)
    and timed beside the whole kernel: the copy, product and extraction
    apart."""
    from devo_tpu_torch.ops import corr as plain
    from devo_tpu_torch.ops import corr_cuda as cc
    gmap, bf, i8, sc, coords, kk, jj = case
    ring = bf[0]
    cap = cc.full_knobs(gmap.shape[1], gmap.shape[-1], ring.dtype)[0]
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
    kernel choice and family (int8 rings where the choice takes them), and
    on f32 patch features and rings for the kernels of F32_TWO_LEVEL."""
    from devo_tpu_torch.ops import corr_cuda as cc
    gmap, bf, i8, sc, coords, kk, jj = corr_case(8, dev, 4)
    f32 = tuple(r.float() for r in bf)
    before = dict(cc.launches)
    for impl, kernel, g, pyr, scales in (
            [("banded", k, gmap, *((bf, None) if k in cc.FLOAT_ONLY else (i8, sc)))
             for k in cc.KERNELS]
            + [(impl, "mono", gmap, bf, None) for impl in cc.IMPLS[1:]]
            + [("banded", k, gmap.float(), f32, None)
               for k in F32_TWO_LEVEL.values()]):
        got = cc.corr_pyramid(g, pyr, coords[:0], kk[:0], jj[:0],
                              scales=scales, kernel=kernel, impl=impl)
        if got.shape != (0, 882) or cc.launches != before:
            raise RuntimeError(f"{impl} {kernel} at E=0: {tuple(got.shape)}, "
                               f"launches {cc.launches}")
    for g in (gmap, gmap.float()):          # the resident level 4
        got = cc.corr_pyramid(g, i8, coords[:0], kk[:0], jj[:0], scales=sc,
                              kernel="split", resident=True)
        if got.shape != (0, 882) or cc.launches != before:
            raise RuntimeError(f"split + resident at E=0: {tuple(got.shape)}, "
                               f"launches {cc.launches}")
    print(f"E=0: every kernel choice and family returns (0, 882) and launches "
          f"nothing [{gpu}]", flush=True)


# the two-level kernels that the float-ring checks also hold on f32 patch
# features and rings: counter -> kernel choice
F32_TWO_LEVEL = {"corr_pyramid": "mono", "corr_pair": "pair",
                 "corr_mono3": "mono3", "corr_pair2": "pair2"}
# kernel choice -> the launch counters it runs on
COUNTERS = {"mono": ("corr_pyramid",), "pair": ("corr_pair",),
            "pair2": ("corr_pair2",), "split": ("corr_level",),
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
    corr_pyramid; and the kernels of F32_TWO_LEVEL on the f32 rings."""
    from devo_tpu_torch.ops import corr as plain
    for ring, g, pyr in (("bf16", gmap, bf),
                         ("f32", gmap.float(), tuple(r.float() for r in bf))):
        ref = plain.corr_pyramid(g, pyr, coords, kk, jj)
        kernels = dict(FLOAT_LEVEL)
        if ring == "f32":
            kernels.update({name: ("banded", kernel)
                            for name, kernel in F32_TWO_LEVEL.items()})
        for name, (impl, kernel) in kernels.items():
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
# the reference phase's small configuration, under each entry of REFERENCE
REF_BASE = dict(BUFFER_SIZE=32, HT=REF_HT, WD=REF_WD, PATCHES_PER_FRAME=4,
                PATCH_LIFETIME=5, REMOVAL_WINDOW=9, OPTIMIZATION_WINDOW=4,
                MOTION_PROBE_THRESH=-1.0, MEM=16, DIM_INET=32, DIM_FNET=16,
                DIM=8, MIXED_PRECISION=False, SCORER_EVAL_MODE="topk")
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
    # the frame input (3-channel 0-255 frames) with the random selector,
    # whose coordinates both engines are handed, as the frame drivers
    # configure it (eval/frames.frame_config); the gradient selector
    "f32 rings frames random": dict(
        CORR_RING_I8=False, EVS=False, BINS=3, PATCH_SELECTOR="random",
        NORM="none", SCORER_EVAL_USE_GRID=False, OPTIMIZATION_WINDOW=15,
        KEYFRAME_THRESH=15.0),
    "f32 rings gradient topk": dict(CORR_RING_I8=False,
                                    PATCH_SELECTOR="gradient"),
}
# the frame input at TUM-RGBD's aspect (256x352) at the phase's scale: a
# level-1 map of 16x22 and a level 4 of 4x5, K1 at a width other than the
# square frames'
REFERENCE["f32 rings frames random 64x88"] = dict(
    REFERENCE["f32 rings frames random"], WD=88)
# pose atol: float noise compounds over the 12-update initialization and the
# per-frame BA; with int8 rings a feature that rounds the other way on the
# card moves a tap by one step of the ring's scale
REF_TOL = {False: 5e-2, True: 0.1}
# the CPU's own spread: the CPU port run again with one of its inputs moved
# by one ulp (every nonzero frame value, every weight, or every depth draw).
# Where a trajectory amplifies rounding, the card cannot be held closer to
# the CPU than the CPU is to itself: at every point compared the card's
# poses lie within max(REF_TOL, REF_SPREAD x the largest of these gaps)
REF_MOVES = {"frames +1 ulp": ("frames", np.inf),
             "frames -1 ulp": ("frames", -np.inf),
             "weights +1 ulp": ("weights", np.inf),
             "depths +1 ulp": ("depths", np.inf)}
# more moves, for `--reference ... --more-moves` alone (each is one more CPU
# run of every configuration that measures its spread)
REF_MORE_MOVES = {"weights -1 ulp": ("weights", -np.inf),
                  "depths -1 ulp": ("depths", -np.inf),
                  "intrinsics +1 ulp": ("intrinsics", np.inf),
                  "intrinsics -1 ulp": ("intrinsics", -np.inf)}
REF_OUT = "chiprun_out/reference"
REF_SPREAD = 2.0
# the spreads measured in this run, by the bits of the CPU run (reference_phase)
REF_SPREADS = {}


def ulp_move(a: np.ndarray, toward: float) -> np.ndarray:
    """Every nonzero entry of a float32 array moved one ulp toward `toward`
    (+-inf); zeros stay, so sparse voxels keep their events."""
    return np.where(a != 0, np.nextafter(a, np.float32(toward)), a).astype(
        np.float32)


def reference_knobs(spec: str) -> dict:
    """'LABEL[:KEY=VALUE,...]' -> REFERENCE[LABEL] with the overrides, the
    values read as Python literals (chip_smoke.py --reference)."""
    import ast
    label, _, sets = spec.partition(":")
    knobs = dict(REFERENCE[label])
    for item in filter(None, sets.split(",")):
        key, value = item.split("=")
        knobs[key.strip()] = ast.literal_eval(value.strip())
    return knobs


def reference_phase(dev, gpu: str, label: str, knobs: dict, moves=None):
    """The port on the card against the port on the CPU (plain correlation,
    CPU convolutions and sums), which the repo's CPU tests hold against the
    JAX package: a small f32 configuration with deterministic top-k patch
    selection and the same injected depth draws, over frames of a sliding
    texture. Per frame the same keyframe count, cull decision, (kk, jj)
    edge set and new patch coordinates, poses within the bound; then the
    same terminate() timestamps and poses within the bound, before and
    after N_UPDATES extra updates. The bound at each point: max(REF_TOL,
    REF_SPREAD x the CPU's own spread there, `moves`). With EVS=False the
    frames are 3-channel 0-255 images of a sliding texture, and the random
    selector's coordinates are drawn once and handed to every engine, as
    the depths are. `moves`: the moves of the spread (REF_MOVES by
    default). Where the card leaves both the tolerance and the CPU's own
    spread at some frame, the first such frame is printed with its new patches' coordinates, the edge
    set's size and both poses, and written under REF_OUT."""
    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.ops import corr as corr_plain
    from devo_tpu_torch.ops import corr_cuda
    from devo_tpu_torch.runtime.config import VOConfig
    from devo_tpu_torch.runtime.engine import DEVO, ring_i8
    from devo_tpu_torch.utils.params import random_state_dict

    cfg = VOConfig(**{**REF_BASE, **knobs})
    ht, wd = cfg.HT, cfg.WD
    tol = REF_TOL[ring_i8(cfg)]
    weights = random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS,
               patch_selector=cfg.PATCH_SELECTOR), seed=1)
    rng = np.random.default_rng(1)
    if cfg.EVS:
        base = rng.standard_normal((ht, 2 * wd, 5)).astype(np.float32)
        base *= rng.random(base.shape) < 0.15
    else:
        base = (rng.random((ht, 2 * wd, 3)) * 255).astype(np.float32)
    depths = rng.random((REF_FRAMES, cfg.M, 1)).astype(np.float32)
    intr = np.asarray([80.0, 80.0, wd / 2, ht / 2], np.float32)
    # the random selector's patch centres, inside [1, w-2] x [1, h-2]
    pick = np.random.default_rng(2)
    centres = [(pick.integers(1, wd // 4 - 1, (1, cfg.M)),
                pick.integers(1, ht // 4 - 1, (1, cfg.M)))
               for _ in range(REF_FRAMES)]

    cpu = torch.device("cpu")

    def drive(d, w, b, dp, intr=intr):
        """One engine over the frames: per frame (n, cull, edge set, new
        patch coordinates, poses), then terminate() before and after
        N_UPDATES updates, and whether it kept level 4 resident."""
        slam = DEVO(cfg, w, ht=ht, wd=wd, device=d)
        seen, patchify = [], slam.net.run_patchify

        def record(*args, **kw):
            out = patchify(*args, **kw)
            seen.append(out["coords"].cpu().clone())
            return out
        slam.net.run_patchify = record
        frames = []
        for i in range(REF_FRAMES):
            slam._draw_depth = lambda i=i: torch.from_numpy(dp[i]).to(d)
            slam._draw_coords = lambda i=i: tuple(
                torch.from_numpy(c).to(d) for c in centres[i])
            slam(i / 30.0, b[:, 3 * i:3 * i + wd], intr)
            frames.append((slam.n, slam.aux_log[-1][1].kf_removed,
                           set(zip(slam.kk.tolist(), slam.jj.tolist())),
                           seen[-1], slam.poses[:slam.n].cpu().numpy().copy()))
        ends = [slam.terminate()]
        for _ in range(N_UPDATES):
            slam.update()
        ends.append(slam.terminate())
        return frames, ends, slam.l4_resident

    def points(run):
        """The poses compared: at every frame, at terminate() before and
        after the updates."""
        frames, ends, _ = run
        return [f[4] for f in frames] + [p for p, _ in ends]

    def gap(a, b):                   # over the frames both hold
        k = min(len(a), len(b))
        return float(np.abs(a[:k] - b[:k]).max())

    t0 = time.perf_counter()
    corr_cuda.reset_launches()
    corr_plain.window_calls = corr_plain.gather_calls = 0
    got = drive(dev, weights, base, depths)
    ref = drive(cpu, weights, base, depths)
    for i, (g, r) in enumerate(zip(got[0], ref[0])):
        if g[:2] != r[:2]:
            raise RuntimeError(f"reference {label} frame {i}: n {g[0]} vs "
                               f"{r[0]}, cull {g[1]} vs {r[1]}")
        if g[2] != r[2]:
            raise RuntimeError(f"reference {label} frame {i}: edge tables differ")
        if not torch.equal(g[3], r[3]):
            raise RuntimeError(f"reference {label} frame {i}: the new patches' "
                               f"coordinates differ")
    culls = sum(r[1] for r in ref[0])
    # the CPU's own spread; a configuration whose CPU run gives an earlier
    # one's bits from the same inputs runs the same CPU computation (the
    # kernel choices differ on the card alone) and has its spread
    moves = REF_MOVES if moves is None else moves
    key = hashlib.sha256(b"".join(a.tobytes() for a in points(ref))
                         + repr(sorted(moves)).encode()).digest()
    if key not in REF_SPREADS:
        moved = []
        for what, toward in moves.values():
            w, b, dp, it = weights, base, depths, intr
            if what == "weights":
                w = {k: torch.from_numpy(ulp_move(v.numpy(), toward))
                     if v.is_floating_point() else v for k, v in weights.items()}
            elif what == "frames":
                b = ulp_move(base, toward)
            elif what == "intrinsics":
                it = ulp_move(intr, toward)
            else:
                dp = ulp_move(depths, toward)
            moved.append(points(drive(cpu, w, b, dp, it)))
        REF_SPREADS[key] = [max(gap(m[j], r) for m in moved)
                            for j, r in enumerate(points(ref))]
    spreads = REF_SPREADS[key]
    gaps = [gap(g, r) for g, r in zip(points(got), points(ref))]
    # frames where the card is farther from the CPU than both the tolerance
    # and the CPU from itself
    parted = [j for j in range(REF_FRAMES) if gaps[j] > max(tol, spreads[j])]
    if parted:
        j = parted[0]
        g, r = got[0][j], ref[0][j]
        import os
        os.makedirs(REF_OUT, exist_ok=True)
        name = "".join(c if c.isalnum() else "_" for c in label)
        with open(os.path.join(REF_OUT, f"{name}.json"), "w") as f:
            json.dump(dict(label=label, moves=list(moves), frame=j,
                           gap=gaps[j], spread=spreads[j], beyond=parted,
                           n=g[0], edges=sorted(g[2]),
                           new_coords=g[3].tolist(), poses_card=g[4].tolist(),
                           poses_cpu=r[4].tolist(), gaps=gaps,
                           spreads=spreads), f)
        print(f"reference [{label}]: the card first leaves the CPU's spread at "
              f"frame {j} ({gaps[j]:.3e} > {spreads[j]:.3e}; beyond it at "
              f"frames {parted}), n {g[0]}, {len(g[2])} edges (the CPU's), "
              f"new patches at {g[3].reshape(-1, 2).tolist()}; the last pose "
              f"card {np.round(g[4][-1], 5).tolist()} cpu "
              f"{np.round(r[4][-1], 5).tolist()} (all in {REF_OUT}/{name}.json)",
              flush=True)
    for j, (err, spread) in enumerate(zip(gaps, spreads)):
        if not err <= max(tol, REF_SPREAD * spread):
            where = (f"frame {j}" if j < REF_FRAMES else "terminate() "
                     + ("before" if j == REF_FRAMES else "after") + " the updates")
            raise RuntimeError(f"reference {label} {where}: poses differ by "
                               f"{err} (CPU spread {spread})")
    for (p_got, t_got), (_, t_ref) in zip(got[1], ref[1]):
        if not (np.array_equal(t_got, t_ref) and np.isfinite(p_got).all()):
            raise RuntimeError(f"reference {label}: terminate() outputs differ")
    worst = max(range(REF_FRAMES), key=lambda j: gaps[j])
    print(f"reference [{label}]: port on {dev.type} vs port on cpu, "
          f"{ht}x{wd}, {REF_FRAMES} frames + {N_UPDATES} updates: same "
          f"keyframes, culls ({culls}), edge sets and patch coordinates; poses "
          f"max abs diff (CPU spread under {len(moves)} one-ulp moves): "
          f"frames {gaps[worst]:.3e} ({max(spreads[:REF_FRAMES]):.3e}), "
          f"terminate() before the updates {gaps[-2]:.3e} ({spreads[-2]:.3e}), "
          f"after {gaps[-1]:.3e} ({spreads[-1]:.3e}); bound max({tol}, "
          f"{REF_SPREAD:g} x spread); kernel launches {corr_cuda.launches}; "
          f"resident level 4: {got[2]}; {time.perf_counter() - t0:.1f} s "
          f"[{gpu}]", flush=True)
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
    corr_plain.extract_calls = 0
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
    launches = dict(corr_cuda.launches)
    plain_calls = corr_plain.calls + corr_plain.extract_calls
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


def frame_k1_timing(slam, label: str, gpu: str):
    """K1 on the engine's own final edges and rings, timed beside its plain
    version and its bound (bound_ms): what a frame path's frame size does to
    the kernel at its live edge count."""
    from devo_tpu_torch.geom import edgewise
    from devo_tpu_torch.ops import corr as corr_plain
    from devo_tpu_torch.ops import corr_cuda
    cfg = slam.cfg
    geo = edgewise.reproject(slam.poses, slam.patches, slam.intrinsics,
                             slam.ii, slam.jj, slam.kk)
    coords = edgewise.coords_to_corr_format(geo, cfg.P)
    kk, jj = (slam.kk % (cfg.M * cfg.MEM)).int(), (slam.jj % cfg.MEM).int()
    rings = (slam.fmap1, slam.fmap2)
    scales = (slam.fsc1, slam.fsc2) if slam.ring_i8 else None
    ms = median_ms(lambda: corr_cuda.corr_pyramid_cuda(
        slam.gmap, *rings, coords, kk, jj, scales=scales))
    plain = median_ms(lambda: corr_plain.corr_pyramid(
        slam.gmap, rings, coords, kk, jj, scales=scales), launches=2,
        repeats=3)
    b_ms, b_by = bound_ms(slam.gmap, rings, (1, 4), scales or (None, None),
                          coords, kk, jj)
    print(f"K1 [{label}]: corr_pyramid on the engine's final state, E="
          f"{kk.shape[0]}, rings {tuple(rings[0].shape[1:3])} / "
          f"{tuple(rings[1].shape[1:3])} {rings[0].dtype}: {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{gpu}]", flush=True)


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
    corr_plain.calls = corr_plain.extract_calls = 0
    t0 = time.perf_counter()
    res = bench.run(knobs, device=dev, **({} if full else BENCH_SHORT))
    wall = time.perf_counter() - t0
    launches = dict(corr_cuda.launches)
    # a plain correlation, or the tensor-code stage 2 of "g8c", on the card
    plain_calls = corr_plain.calls + corr_plain.extract_calls
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


def rgb_stream(n: int, ht: int = HT, wd: int = WD):
    """n frames of the bench's sliding texture as 3-channel intensity
    frames, (3, ht, wd) f32 in 0-255: its first three bins mapped linearly
    from their range onto 0-255. Made in memory: no image tree is on the
    card's machine."""
    from devo_tpu_torch.bench import frame, texture
    base = texture(ht, wd)[..., :3]
    lo, hi = float(base.min()), float(base.max())
    base = np.clip((base - lo) * (255.0 / (hi - lo)), 0, 255).astype(np.float32)
    return [np.ascontiguousarray(frame(base, i).transpose(2, 0, 1))
            for i in range(n)]


def eval_phase(dev, gpu: str, label: str, engine_cache: dict, stream):
    """One configuration of EVAL_PATHS or FRAME_PATHS through
    evaluate_sequence at full width. `stream`: the frames as (bins, H, W)
    arrays. Returns (launches of each kernel during evaluate_sequence, max
    error of the configuration's kernel on the engine's final state)."""
    import os

    from devo_tpu_torch.eval import harness
    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.ops import corr as corr_plain
    from devo_tpu_torch.ops import corr_cuda
    from devo_tpu_torch.utils.params import random_state_dict

    _, kernel, trials = {**EVAL_PATHS, **FRAME_PATHS}[label]
    # random weights reject every frame at the learned motion probe
    cfg = path_config(label).replace(MOTION_PROBE_THRESH=-1.0)
    weights = random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS,
               patch_selector=cfg.PATCH_SELECTOR), seed=0)
    n = len(stream)
    ht, wd = stream[0].shape[1:]
    intr = stream_intrinsics(label, ht, wd)
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
        trials=trials, ht=ht, wd=wd, max_diff_s=0.01, outdir=OUT_DIR,
        name=label, engine_cache=engine_cache)
    torch.cuda.synchronize()
    launches, plain_calls = dict(corr_cuda.launches), corr_plain.calls
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    if len(engine_cache) != before + 1:
        raise RuntimeError(f"{label}: {len(engine_cache) - before} engines "
                           f"were cached for one configuration")
    # the engine of this configuration at this frame size (the frame paths
    # share one configuration at two sizes)
    slam = next(s for k, s in engine_cache.items() if k[:3] == (ht, wd, cfg))
    if slam.fmap1.shape[1:3] != (ht // 4, wd // 4):
        raise RuntimeError(f"{label}: the cached engine's rings are "
                           f"{tuple(slam.fmap1.shape[1:3])}")
    # correlations of one trial: the probe of frames 1-7, 12 updates at
    # initialization (frame 8), one per later frame, 12 final updates; a
    # kernel that takes one level a launch is launched twice for each
    per_trial = 7 + 12 + (n - 8) + N_UPDATES
    want = trials * per_trial * (2 if kernel in FLOAT_LEVEL else 1)
    others = [k for k, v in launches.items() if v and k != kernel]
    if launches[kernel] != want or others or plain_calls != 0:
        raise RuntimeError(f"{label}: expected {want} launches of {kernel} "
                           f"alone, got {launches} and {plain_calls} plain "
                           f"calls")
    if not all(np.isfinite([r.ate, r.mpe, r.r_rmse]).all() for r in results):
        raise RuntimeError(f"{label}: metrics are not finite: {results}")
    for trial in range(trials):
        dump = np.loadtxt(os.path.join(OUT_DIR, f"{label}_trial{trial}.txt"))
        if dump.shape != (n, 8) or not np.isfinite(dump).all():
            raise RuntimeError(f"{label}: TUM dump of trial {trial} is "
                               f"{dump.shape}")
    with open(os.path.join(OUT_DIR, f"{label}_results.json")) as f:
        blob = json.load(f)
    if (len(blob["trials"]) != trials or len(blob["fps"]) != trials
            or blob["median"]["ate"] != med.ate):
        raise RuntimeError(f"{label}: results JSON does not match the run")
    edges = slam.n_edges
    err = engine_state_check(slam, label, gpu)
    if label in FRAME_PATHS:
        frame_k1_timing(slam, label, gpu)

    # the bare slice in the same configuration: a fresh engine with trial
    # 0's seed, called by hand as slice_phase calls it, gives as many poses
    from devo_tpu_torch.runtime.engine import DEVO
    bare = DEVO(cfg, weights, ht=ht, wd=wd, seed=0, device=dev)
    bare_s = []
    for vox, t in zip(stream, tss):
        t0 = time.perf_counter()
        bare(float(t), vox.transpose(1, 2, 0), intr)
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
                for ts in yields[:trials]]
    frame_ms = [round(float(1e3 * np.median(np.diff(ts)[SKIP:])), 2)
                for ts in yields[:trials]]
    print(f"eval [{label}]: evaluate_sequence, {ht}x{wd}, "
          f"{stream[0].shape[0]} channels, PATCH_SELECTOR="
          f"{cfg.PATCH_SELECTOR!r}, EVS={cfg.EVS}, rings "
          f"{slam.fmap1.dtype}, CORR_IMPL={cfg.CORR_IMPL!r}, "
          f"CORR_KERNEL={cfg.CORR_KERNEL!r}, {n} frames + "
          f"{N_UPDATES} updates x {trials} trials on one engine: "
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


def stream_intrinsics(label: str, ht: int, wd: int) -> np.ndarray:
    """The intrinsics of a frame path's frames: TUM-RGBD's freiburg1
    calibration scaled to its evaluated size, else the bench's."""
    if label.startswith("tum-"):
        from devo_tpu_torch.eval import frames
        if (frames.TUM_H, frames.TUM_W) != (ht, wd):
            raise RuntimeError(f"{label}: frames of {ht}x{wd}, TUM-RGBD is "
                               f"evaluated at {frames.TUM_H}x{frames.TUM_W}")
        return frames.tum_intrinsics()
    return np.asarray([320.0, 320.0, wd / 2, ht / 2], np.float32)


# ---------------------------------------------------------------------------
# The tail: the live viewer, the live event input, the profiler trace.

VIZ_PATH = "tum-rgb-random"        # the eval path the viewer watches
VIZ_PERIOD = 0.0                   # a snapshot at every frame end
VIZ_DIR = "chiprun_out/eval_smoke/viz_tum"
LIVE_PATH = "live-events-i8-mono"  # native voxels through stream.buffered
LIVE_CONFIG = "i8-mono"            # ... into the default configuration
LIVE_EVENTS = 60_000               # events a frame
VOX_REPS = 7                       # timed voxelizer calls after a warm-up
TRACE_DIR = "chiprun_out/trace"
TRACE_FRAMES = 4


def viewer_phase(dev, gpu: str):
    """The live viewer on the card: harness.run_voxel over the 48 frames
    of VIZ_PATH (256x352), once without the viewer and once with it,
    snapshotting at every frame end (VIZ_PERIOD, passed by a wrapper of
    DEVO.start_viewer), on one cached engine
    reset to seed 0. The trajectory must be the same bit for bit, the
    viewer must have taken at least 10 snapshots with no render failed,
    and K1 must have launched. Prints whether PNGs were written
    (matplotlib present or not) and frames/s with and without it."""
    import os

    from devo_tpu_torch.eval import harness
    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.ops import corr_cuda
    from devo_tpu_torch.runtime.engine import DEVO
    from devo_tpu_torch.utils.params import random_state_dict

    cfg = path_config(VIZ_PATH).replace(MOTION_PROBE_THRESH=-1.0)
    weights = random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS,
               patch_selector=cfg.PATCH_SELECTOR), seed=0)
    ht, wd = FRAME_SIZES[VIZ_PATH]
    stream = rgb_stream(N_FRAMES, ht, wd)
    intr = stream_intrinsics(VIZ_PATH, ht, wd)
    cache, viewers = {}, []
    start = DEVO.start_viewer

    def keep(self, out_dir):         # the viewer run_voxel attaches
        viewers.append(start(self, out_dir, period=VIZ_PERIOD))
        return viewers[-1]

    def run(viz_dir):
        corr_cuda.reset_launches()
        items = ((v, intr, i / 30.0) for i, v in enumerate(stream))
        poses, tss, fps = harness.run_voxel(
            cfg, weights, items, ht, wd, seed=0, engine_cache=cache,
            device=dev, viz_dir=viz_dir)
        return poses, tss, fps, dict(corr_cuda.launches)

    plain = run(None)
    DEVO.start_viewer = keep
    try:
        viewed = run(VIZ_DIR)
    finally:
        DEVO.start_viewer = start
    (v,) = viewers
    pngs = [f for f in os.listdir(VIZ_DIR) if f.endswith(".png")]
    print(f"viewer [{VIZ_PATH}]: run_voxel {ht}x{wd}, {N_FRAMES} frames + "
          f"{N_UPDATES} updates, period {VIZ_PERIOD} s: {v.snapshots} "
          f"snapshots, {v.rendered} rendered, {v.failures} failed; PNGs "
          f"written: {bool(pngs)} ({len(pngs)} in {VIZ_DIR}; matplotlib "
          f"{'present' if v.png else 'missing'}); frames/s without the "
          f"viewer {plain[2]:.2f}, with it {viewed[2]:.2f} (run_voxel's, "
          f"initialization and final updates included); K1 launches "
          f"{plain[3]['corr_pyramid']} / {viewed[3]['corr_pyramid']} [{gpu}]",
          flush=True)
    if not (np.array_equal(plain[0], viewed[0])
            and np.array_equal(plain[1], viewed[1])):
        raise RuntimeError("viewer: the trajectory with the viewer differs "
                           "from the one without it")
    if v.failures or v.snapshots < 10 or v._t.is_alive():
        raise RuntimeError(f"viewer: {v.snapshots} snapshots, {v.failures} "
                           f"failures ({v.last_failure})")
    if v.png and len(pngs) != v.rendered:
        raise RuntimeError(f"viewer: {v.rendered} renders, {len(pngs)} PNGs")
    if not (plain[3]["corr_pyramid"] > 0
            and plain[3]["corr_pyramid"] == viewed[3]["corr_pyramid"]):
        raise RuntimeError(f"viewer: K1 launches {plain[3]} / {viewed[3]}")


def event_stream(n: int, ht: int = HT, wd: int = WD, seed: int = 0):
    """n windows of LIVE_EVENTS events, drawn from a seed where the bench's
    sliding texture is nonzero in frame i (x, y jittered within the pixel,
    the polarity the sign of its sum over the bins, t sorted in the
    frame's 1/30 s): (x f32, y f32, t_us i64, p i8) a window."""
    from devo_tpu_torch.bench import frame, texture
    base = texture(ht, wd).sum(-1, keepdims=True)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = frame(base, i)[..., 0]
        ys, xs = np.nonzero(f)
        pick = rng.integers(0, len(xs), LIVE_EVENTS)
        x = (xs[pick] + rng.random(LIVE_EVENTS)).astype(np.float32)
        y = (ys[pick] + rng.random(LIVE_EVENTS)).astype(np.float32)
        t = np.sort(rng.integers(i * 33_333, (i + 1) * 33_333, LIVE_EVENTS))
        p = np.where(f[ys[pick], xs[pick]] > 0, 1, -1).astype(np.int8)
        out.append((x, y, t.astype(np.int64), p))
    return out


def live_phase(dev, gpu: str):
    """The live input path: the native voxelizer (devo_tpu_torch/native,
    built with g++ on this host) against data/event_utils.to_voxel_grid on
    a seeded event window within test_native.py's 1e-3, then N_FRAMES
    windows of events voxelized natively in the producer thread of
    data/stream.buffered and tracked by DEVO in the default configuration
    (int8 rings, K1) at 480x640. Returns (launches of each kernel, K1's
    max error on the engine's final state)."""
    from devo_tpu_torch import native
    from devo_tpu_torch.data import event_utils, stream
    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.ops import corr as corr_plain
    from devo_tpu_torch.ops import corr_cuda
    from devo_tpu_torch.runtime.engine import DEVO
    from devo_tpu_torch.utils.params import random_state_dict

    if not native.available():
        raise RuntimeError(f"the native voxelizer did not build: "
                           f"{native.build_error()}")
    windows = event_stream(N_FRAMES)
    x, y, t, p = windows[0]

    def median_ms(fn):               # one warm-up call, then VOX_REPS
        out = fn(x, y, t, p, HT, WD, 5)
        ms = []
        for _ in range(VOX_REPS):
            t0 = time.perf_counter()
            fn(x, y, t, p, HT, WD, 5)
            ms.append(1e3 * (time.perf_counter() - t0))
        return out, float(np.median(ms))

    got, native_ms = median_ms(native.to_voxel_grid)
    want, numpy_ms = median_ms(event_utils.to_voxel_grid)
    vox_err = float(np.abs(got - want).max())
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)

    cfg = path_config(LIVE_PATH).replace(MOTION_PROBE_THRESH=-1.0)
    weights = random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS), seed=0)
    slam = DEVO(cfg, weights, ht=HT, wd=WD, seed=0, device=dev)
    intr = np.asarray([320.0, 320.0, WD / 2, HT / 2], np.float32)
    voxelized = []

    def produce():                   # the producer thread's work
        for i, (x, y, t, p) in enumerate(windows):
            t0 = time.perf_counter()
            vox = native.to_voxel_grid(x, y, t, p, HT, WD, cfg.BINS)
            voxelized.append(time.perf_counter() - t0)
            yield vox, intr, i / 30.0

    torch.cuda.synchronize()
    corr_cuda.reset_launches()
    corr_plain.calls = 0
    stamps = []
    for vox, k, ts in stream.buffered(produce(), maxsize=4):
        # one copy of the contiguous window, as the harness makes it
        slam(ts, torch.from_numpy(vox).to(dev).permute(1, 2, 0), k)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    for _ in range(N_UPDATES):
        slam.update()
    poses, tss = slam.terminate()
    launches, plain_calls = dict(corr_cuda.launches), corr_plain.calls
    fps = (N_FRAMES - 1 - SKIP) / (stamps[-1] - stamps[SKIP])
    print(f"live [{LIVE_PATH}]: native voxelizer built ({native.BUILD_DIR}), "
          f"{LIVE_EVENTS} events at {HT}x{WD}: {native_ms:.2f} ms native, "
          f"{numpy_ms:.2f} ms NumPy (medians of {VOX_REPS} calls after a "
          f"warm-up), max abs diff {vox_err:.2e} (atol 1e-3); "
          f"{N_FRAMES} windows voxelized in stream.buffered's producer thread "
          f"(median {1e3 * np.median(voxelized):.2f} ms a window) and tracked "
          f"on {slam.fmap1.dtype} rings: frames {SKIP}-{N_FRAMES - 1} "
          f"{fps:.2f} frames/s; keyframes {slam.n}, live edges "
          f"{slam.n_edges}; launches {launches}, plain corr calls "
          f"{plain_calls} [{gpu}]", flush=True)
    if poses.shape != (N_FRAMES, 7) or not np.isfinite(poses).all():
        raise RuntimeError(f"live: trajectory {poses.shape}, finite "
                           f"{np.isfinite(poses).all()}")
    others = [k for k, n in launches.items() if n and k != "corr_pyramid"]
    if launches["corr_pyramid"] < 1 or others or plain_calls:
        raise RuntimeError(f"live: expected K1 alone: {launches}, "
                           f"{plain_calls} plain calls")
    return launches, engine_state_check(slam, LIVE_PATH, gpu)


def trace_phase(dev, gpu: str):
    """utils/timing.trace on the card: TRACE_FRAMES frames of the TUM frame
    path's engine after its initialization, recorded by torch.profiler into
    TRACE_DIR. The trace file must exist and name the engine's devo.update
    span and K1's kernel."""
    import glob
    import os

    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.runtime.engine import DEVO
    from devo_tpu_torch.utils import timing
    from devo_tpu_torch.utils.params import random_state_dict

    cfg = path_config(VIZ_PATH).replace(MOTION_PROBE_THRESH=-1.0)
    weights = random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS,
               patch_selector=cfg.PATCH_SELECTOR), seed=0)
    ht, wd = FRAME_SIZES[VIZ_PATH]
    frames = rgb_stream(12 + TRACE_FRAMES, ht, wd)
    intr = stream_intrinsics(VIZ_PATH, ht, wd)
    slam = DEVO(cfg, weights, ht=ht, wd=wd, seed=0, device=dev)
    for i, f in enumerate(frames[:12]):
        slam(i / 30.0, f.transpose(1, 2, 0), intr)
    os.makedirs(TRACE_DIR, exist_ok=True)
    before = set(glob.glob(os.path.join(TRACE_DIR, "*.json")))
    t0 = time.perf_counter()
    with timing.trace(TRACE_DIR) as prof:
        for i, f in enumerate(frames[12:], 12):
            slam(i / 30.0, f.transpose(1, 2, 0), intr)
        torch.cuda.synchronize()
    (path,) = set(glob.glob(os.path.join(TRACE_DIR, "*.json"))) - before
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f).get("traceEvents", [])}
    kernel = KERNELS["corr_pyramid"][2]
    k1 = sorted(n for n in names if kernel in n)
    device_ms = sum(e.device_time_total for e in prof.key_averages()
                    if kernel in e.key) / 1e3
    print(f"trace: timing.trace over {TRACE_FRAMES} frames of {VIZ_PATH} "
          f"({ht}x{wd}) in {time.perf_counter() - t0:.1f} s -> {path} "
          f"({os.path.getsize(path) / 2**20:.1f} MiB, {len(names)} event "
          f"names); devo.update present: {'devo.update' in names}; K1 "
          f"{k1[:1]}, {device_ms:.3f} ms of device time [{gpu}]", flush=True)
    if "devo.update" not in names or not k1:
        raise RuntimeError(f"trace: {path} lacks devo.update or {kernel}")


# ---------------------------------------------------------------------------
# The differentiable pieces of training on the card against the CPU.

TRAIN_E, TRAIN_MEM = 1024, 4       # the backward's edges and ring slots
TRAIN_CORR_TOL = 1e-4              # of the largest gradient entry
TRAIN_BA_TOL = 1e-3                # relative, and of the largest entry: BA's
                                   # Schur system on this scene is
                                   # ill-conditioned (the CPU tests' rule)


def ba_scene(seed: int = 0, n_frames: int = 8, ppf: int = 24, P: int = 3,
             H: int = 120, W: int = 160):
    """tests/test_ba.py's synthetic scene, built with the port on the CPU: a
    forward-moving trajectory, patches with known depths, every edge within
    3 frames, targets at the true reprojections; then poses (but the first)
    and depths perturbed, every 7th edge masked, random weights. Returns
    (poses (n, 7), patches (M, 3*P*P) flat, intrinsics, ii, jj, kk, target,
    mask, weight)."""
    from devo_tpu_torch.geom import projective
    from devo_tpu_torch.lie import se3
    rng = np.random.default_rng(seed)
    xi = np.cumsum(rng.standard_normal((n_frames, 6)) * 0.02, axis=0)
    xi[:, 2] += np.arange(n_frames) * 0.05
    poses_gt = se3.exp(torch.from_numpy(xi.astype(np.float32)))
    M = n_frames * ppf
    cx = rng.uniform(20, W - 20, (M, 1, 1))
    cy = rng.uniform(20, H - 20, (M, 1, 1))
    off = np.arange(P) - P // 2
    d = np.broadcast_to(rng.uniform(0.5, 1.5, (M, 1, 1)), (M, P, P))
    patches = torch.from_numpy(np.stack([
        np.broadcast_to(cx + off[None, None, :], (M, P, P)),
        np.broadcast_to(cy + off[None, :, None], (M, P, P)), d], 1
    ).astype(np.float32))
    intr = torch.tensor([[120.0, 120.0, W / 2, H / 2]]).repeat(n_frames, 1)
    ix = np.repeat(np.arange(n_frames), ppf)
    edges = [(ix[k], fj, k) for k in range(M) for fj in range(n_frames)
             if 0 < abs(ix[k] - fj) <= 3]
    ii, jj, kk = (torch.tensor(c) for c in zip(*edges))
    coords, valid = projective.transform(poses_gt, patches, intr, ii, jj, kk,
                                         valid=True)
    target = coords[:, P // 2, P // 2, :].contiguous()
    mask = valid > 0
    mask[::7] = False
    noise = rng.standard_normal((n_frames, 6)).astype(np.float32) * 0.01
    noise[0] = 0.0
    poses = se3.retr(poses_gt, torch.from_numpy(noise))
    patches[:, 2] *= torch.from_numpy(
        rng.uniform(0.8, 1.2, (M, 1, 1)).astype(np.float32))
    weight = torch.from_numpy(rng.uniform(0.2, 1.0, (ii.shape[0], 2)
                                          ).astype(np.float32))
    return (poses, patches.reshape(M, -1), intr, ii, jj, kk, target, mask,
            weight)


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return float((got.cpu() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def ba_close(got, want, tol: float) -> bool:
    """|got - want| <= tol |want| + tol max|want| everywhere: the rule by
    which tests/test_torch_train_pieces.py holds the step to devo_tpu."""
    got, want = got.cpu().double(), want.double()
    return bool(((got - want).abs()
                 <= tol * want.abs() + tol * want.abs().max()).all())


def train_pieces_phase(dev, gpu: str):
    """The differentiable pieces of training (ops/corr.corr_pyramid_train,
    ops/ba.gauss_newton_step_diff) on the card against the same on the CPU.
    No timing and no kernel of its own. corr_pyramid_train's forward at the
    kernel phase's E = 12288 case must be the plain corr_pyramid's bits and
    lie within TOL of K1 (corr_pyramid's kernel) on the same bf16 rings;
    its backward (f32, TRAIN_E edges on TRAIN_MEM ring slots, the keep mask
    passed in) the CPU's within TRAIN_CORR_TOL, with no gradient to the
    coordinates; the differentiable BA step's outputs and the gradients of a
    scalar loss of them with respect to target, weight, poses and patches,
    on ba_scene in f32, the CPU's within TRAIN_BA_TOL (ba_close), beside
    both f32 runs' distance from the step in f64. Raises on a mismatch."""
    from devo_tpu_torch.ops import ba
    from devo_tpu_torch.ops import corr as corr_plain
    from devo_tpu_torch.ops import corr_cuda

    gmap, bf, _, _, coords, kk, jj = corr_case(E_MAIN, dev, 0)
    with torch.no_grad():
        train = corr_plain.corr_pyramid_train(gmap, bf, coords, kk, jj,
                                              dropout=1.0)
        plain = corr_plain.corr_pyramid(gmap, bf, coords, kk, jj)
        k1 = corr_cuda.corr_pyramid(gmap, bf, coords, kk, jj, kernel="mono")
    torch.cuda.synchronize()
    if not torch.equal(train, plain):
        raise RuntimeError("corr_pyramid_train's forward is not corr_pyramid's")
    torch.testing.assert_close(k1, train, **TOL)
    k1_err = (k1 - train).abs().max().item()

    # the backward on the first TRAIN_E edges, the rings cut to TRAIN_MEM
    # slots: card and CPU on the same f32 inputs, keep mask and cotangent
    E = TRAIN_E
    g = torch.Generator().manual_seed(0)
    keep = torch.rand(E, generator=g) < 0.2
    inputs = [gmap.float().cpu()] + [r[:TRAIN_MEM].float().cpu() for r in bf]
    idx = (coords[:E].cpu(), kk[:E].cpu().long(), (jj[:E] % TRAIN_MEM).cpu().long())
    ct = torch.randn((E, train.shape[1]), generator=g)
    grads = {}
    for d in (torch.device("cpu"), dev):
        leaves = [t.to(d).requires_grad_(True) for t in inputs]
        c = idx[0].to(d).requires_grad_(True)
        out = corr_plain.corr_pyramid_train(
            leaves[0], leaves[1:], c, idx[1].to(d), idx[2].to(d),
            keep=keep.to(d))
        grads[d.type] = torch.autograd.grad(out, leaves + [c], ct.to(d))
    corr_errs = [rel_err(a, b) for a, b in zip(grads[dev.type][:3],
                                                grads["cpu"][:3])]
    if max(corr_errs) > TRAIN_CORR_TOL or grads[dev.type][3].abs().max() != 0:
        raise RuntimeError(f"corr_pyramid_train's backward on the card: "
                           f"{corr_errs} of the largest entry (gmap, level 1, "
                           f"level 4), coords {grads[dev.type][3].abs().max()}")

    # the differentiable BA step
    scene = ba_scene()
    poses, patches, intr, ii, jj, kk_b, target, mask, weight = scene
    n, M = poses.shape[0], patches.shape[0]
    rng = np.random.default_rng(10)
    A = torch.from_numpy(rng.standard_normal((n, 7)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal(patches.shape).astype(np.float32))
    bounds = torch.tensor([-64.0, -64.0, 160 + 64.0, 120 + 64.0])
    res = {}
    # the card and the CPU in f32, and the CPU in f64, which measures how far
    # f32 itself is from the exact step on this scene
    for key, d, dt in (("cpu", torch.device("cpu"), torch.float32),
                       (dev.type, dev, torch.float32),
                       ("f64", torch.device("cpu"), torch.float64)):
        leaves = [t.to(d, dt).requires_grad_(True)
                  for t in (target, weight, poses, patches)]
        p, q, ok = ba.gauss_newton_step_diff(
            leaves[2], leaves[3], intr.to(d, dt), leaves[0], leaves[1], 1e-4,
            ii.to(d), jj.to(d), kk_b.to(d), mask.to(d), t0=1, t1=n, kbase=0,
            window=n - 1, patch_slots=M, bounds=bounds.to(d, dt))
        loss = (p * A.to(d, dt)).sum() + (q * B.to(d, dt)).sum()
        if not bool(ok):
            raise RuntimeError(f"the differentiable BA step's Cholesky failed "
                               f"({key})")
        res[key] = (p.detach(), q.detach(),
                    *torch.autograd.grad(loss, leaves))
    names = ("poses", "patches", "d/d target", "d/d weight", "d/d poses",
             "d/d patches")
    ba_errs = {name: rel_err(a, b) for name, a, b in zip(
        names, res[dev.type], res["cpu"])}
    f64_errs = {name: max(rel_err(res[k][i].double(), res["f64"][i])
                          for k in ("cpu", dev.type))
                for i, name in enumerate(names)}
    if not all(ba_close(a, b, TRAIN_BA_TOL)
               for a, b in zip(res[dev.type], res["cpu"])):
        raise RuntimeError(f"the differentiable BA step on the card: {ba_errs} "
                           f"of the largest entry, tolerance {TRAIN_BA_TOL} "
                           f"relative and of the largest entry")
    print(f"train pieces: corr_pyramid_train forward at E={E_MAIN} on bf16 "
          f"rings = the plain corr_pyramid bit for bit, K1 within "
          f"{k1_err:.3e} (atol {TOL['atol']} + rtol {TOL['rtol']}); its "
          f"backward at E={E} on {TRAIN_MEM} ring slots, {int(keep.sum())} "
          f"edges kept: card vs cpu {max(corr_errs):.3e} of the largest "
          f"gradient entry (tolerance {TRAIN_CORR_TOL}), coords 0; the "
          f"differentiable BA step on a {n}-frame scene of {M} patches and "
          f"{ii.shape[0]} edges: card vs cpu, of the largest entry, "
          + ", ".join(f"{k} {v:.3e}" for k, v in ba_errs.items())
          + f" (tolerance {TRAIN_BA_TOL} relative and of the largest entry); "
          f"f32 (either) vs f64 on the CPU "
          + ", ".join(f"{k} {v:.3e}" for k, v in f64_errs.items())
          + f" [{gpu}]", flush=True)


# ---------------------------------------------------------------------------
# The trainer (devo_tpu_torch/train/): no kernel of its own. Its correlation is
# the plain corr_pyramid_train, as devo_tpu's is XLA.

# (a) the card against the CPU: one train step at small dims
TRAIN_SMALL = dict(dim_inet=32, dim_fnet=16, dim=8, iters=3, ppi=4,
                   grow_after=2)
TRAIN_SMALL_CLIP = (5, 64, 96)             # frames, height, width
# every tensor within TRAIN_TOL relative plus TRAIN_TOL of its largest entry
# (the CPU tests' rule against devo_tpu, set by the differentiable BA step's
# f32 distance from f64, which every unrolled step runs twice), plus 1e-6 of
# the network's largest gradient entry for those that are 0 analytically;
# the parameters within 2 x lr: AdamW's first step is lr x g / (|g| + eps),
# whose sign a gradient entry near 0 may take either way
TRAIN_TOL = 1e-3
# (b) the full-width step: the reference's training scale
TRAIN_FULL = dict(dim_inet=384, dim_fnet=128, dim=32, iters=18, ppi=80,
                  grow_after=8, corr_dropout=0.2)
TRAIN_FULL_CLIP = (15, 480, 640)
TRAIN_FULL_STEPS = 3
# (c) stability at small dims: 50 steps, not train_stability's 100, which take
# 175 s on the card (1.75 s a step at small dims: launch-bound) and would
# hold the phase over its 3 minutes
TRAIN_STABILITY_STEPS = 50


def train_clip(n_frames: int, ht: int, wd: int):
    """One synthetic clip (train/synthetic.py: the bench's sliding texture,
    a straight-line ground truth, constant disparity) as a batch of 1."""
    from devo_tpu_torch.train.__main__ import _make_batch
    from devo_tpu_torch.train.synthetic import SyntheticClips
    data = SyntheticClips(n_frames, ht, wd)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in _make_batch(data, [0]).items()}


def train_against_cpu(dev) -> dict:
    """One train step at TRAIN_SMALL on `dev` and on the CPU from the same
    seeded weights with the same draws (the trainer's default draws come
    from CPU generators seeded by step and sample): the loss terms, the
    gradients after the step's rules and the parameters after it. Returns
    the distances; raises beyond the tolerance."""
    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.train.trainer import Trainer
    from devo_tpu_torch.utils.params import random_state_dict

    batch = train_clip(*TRAIN_SMALL_CLIP)
    kw = dict(TRAIN_SMALL)
    dims = {k: kw.pop(k) for k in ("dim_inet", "dim_fnet", "dim")}
    runs = {}
    for key, d in (("cpu", torch.device("cpu")), ("dev", dev)):
        net = EVONet(**dims)
        net.load_state_dict(random_state_dict(net, 0))
        tr = Trainer(net=net, total_steps=100, steps_unrolled=kw["iters"],
                     ppi=kw["ppi"], grow_after=kw["grow_after"], device=d)
        lr0 = tr.lr()
        m = tr.train_step(batch)
        runs[key] = (m, {n: p.grad.detach().cpu().double()
                         for n, p in tr.net.named_parameters()},
                     {n: p.detach().cpu().double()
                      for n, p in tr.net.named_parameters()})
    (m_cpu, g_cpu, p_cpu), (m_dev, g_dev, p_dev) = runs["cpu"], runs["dev"]
    loss_err = max(abs(m_dev[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30)
                   for k in ("loss", "flow", "pose", "scores"))
    top = max(float(g.abs().max()) for g in g_cpu.values())
    grad_err, grad_used = 0.0, 0.0
    for name, g in g_cpu.items():
        diff = (g_dev[name] - g).abs()
        allowed = TRAIN_TOL * g.abs() + TRAIN_TOL * float(g.abs().max()) \
            + 1e-6 * top
        # the share of the tolerance used, and the distance relative to the
        # tensor's largest entry (at least 1e-3 of the network's largest:
        # the gradients that are 0 analytically are noise)
        grad_used = max(grad_used, float((diff / allowed).max()))
        grad_err = max(grad_err, float(diff.max()) / max(float(g.abs().max()),
                                                          1e-3 * top))
    grad_ok = grad_used <= 1.0
    param_err = max(float((p_dev[n] - p).abs().max()) for n, p in p_cpu.items())
    out = dict(loss_rel=loss_err, grad_rel=grad_err, grad_used=grad_used,
               param_abs=param_err,
               param_bound=2 * lr0, loss=m_dev["loss"],
               nonfinite=(m_cpu["grad_nonfinite"], m_dev["grad_nonfinite"]))
    if not (loss_err <= TRAIN_TOL and grad_ok and param_err <= 2 * lr0
            and m_cpu["grad_nonfinite"] == m_dev["grad_nonfinite"] == 0
            and np.isfinite(m_dev["loss"])):
        raise RuntimeError(f"train step on {dev.type} against the CPU: {out}")
    return out


def stability_verdict(dev, steps: int = TRAIN_STABILITY_STEPS,
                      log=None) -> dict:
    """train_stability's run at its small defaults on synthetic clips."""
    from devo_tpu_torch.scripts import train_stability
    from devo_tpu_torch.train.synthetic import SyntheticClips
    return train_stability.run(SyntheticClips(5, 64, 96), dev, steps=steps,
                               log=log)


def train_phase(dev, gpu: str):
    """The trainer on the card: (a) one step at small dims against the
    CPU; (b) the full-width step (TRAIN_FULL on TRAIN_FULL_CLIP, batch 1),
    TRAIN_FULL_STEPS steps with remat on and with remat off, each finite
    with grad_nonfinite 0 and parameters that move, its step ms and peak
    GiB printed, then one structure-only step; (c) the stability run
    (TRAIN_STABILITY_STEPS). The top device operations of the step come
    from `python -m devo_tpu_torch.scripts.train_step --profile` (a
    profile of its 750k kernels takes minutes to read). The
    correlation counters are set to 0 before and must read 0 after:
    training takes the plain correlation."""
    from devo_tpu_torch.ops import corr_cuda
    from devo_tpu_torch.scripts import train_step
    from devo_tpu_torch.train.synthetic import SyntheticClips

    t0 = time.perf_counter()
    corr_cuda.reset_launches()
    cmp = train_against_cpu(dev)
    print(f"train (a) [{gpu}]: one step at {TRAIN_SMALL} on "
          f"{TRAIN_SMALL_CLIP} (frames, H, W), card against cpu from the same "
          f"weights and draws: loss terms {cmp['loss_rel']:.3e} relative, "
          f"gradients {cmp['grad_rel']:.3e} of their tensor's largest entry "
          f"(at least 1e-3 of the network's), {cmp['grad_used']:.3f} of the "
          f"tolerance ({TRAIN_TOL} relative + {TRAIN_TOL} of the tensor's "
          f"largest + 1e-6 of the network's), "
          f"parameters {cmp['param_abs']:.3e} (bound 2 x lr = "
          f"{cmp['param_bound']:.3e}); loss {cmp['loss']:.6f}", flush=True)

    data = SyntheticClips(*TRAIN_FULL_CLIP)
    for remat in (True, False):
        rec = train_step.run(data, dev, remat=remat, steps=TRAIN_FULL_STEPS,
                             **TRAIN_FULL)
        if not (rec["finite"] and rec["params_changed"]
                and not any(rec["grad_nonfinite"])):
            raise RuntimeError(f"full-width train step, remat {remat}: {rec}")
        mode = "on" if remat else "off"
        print(f"train (b) step ms, remat {mode}: {rec['step_ms']:.1f} "
              f"(steps {rec['steps_ms']})", flush=True)
        print(f"train (b) peak GiB, remat {mode}: {rec['peak_gib']:.3f}",
              flush=True)
        print(f"train (b) remat {mode} [{gpu}]: {rec['shape']}, losses "
              f"{[round(v, 4) for v in rec['loss']]}, grad_nonfinite "
              f"{rec['grad_nonfinite']}", flush=True)
    so = train_step.run(data, dev, remat=True, steps=1, structure_only=True,
                        **TRAIN_FULL)
    if not (so["finite"] and so["params_changed"]
            and not any(so["grad_nonfinite"])):
        raise RuntimeError(f"full-width structure-only step: {so}")
    print(f"train (b) structure-only step: {so['step_ms']:.1f} ms, loss "
          f"{so['loss'][0]:.4f}", flush=True)

    st = stability_verdict(dev)
    print(f"train (c) stability [{gpu}]: {st['steps']} steps, "
          f"grad_nonfinite total {st['grad_nonfinite_total']}, full-phase "
          f"head {st['fullphase_head']:.4f} -> tail {st['fullphase_tail']:.4f}"
          f": {'PASS' if st['pass'] else 'FAIL'} ({st['wall_s']:.1f} s)",
          flush=True)
    if not st["pass"]:
        raise RuntimeError(f"train stability failed: {st}")
    if any(corr_cuda.launches.values()):
        raise RuntimeError(f"training launched a correlation kernel: "
                           f"{corr_cuda.launches}")
    print(f"train phase: no correlation kernel launched "
          f"({sum(corr_cuda.launches.values())}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


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
COPY_AB_MODES = ("single", "pair", "tall4", "dual", "local")   # K14'' in turns
COPY_GRIDS = (1, 7, None, 200)    # the copy probe's exactness; None: one an SM
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


def frame_staged(inputs, group: int, grid: int) -> int:
    """The windows that corr_frame_probe's grouping rule (csrc/
    window_probe.cuh) stages on `inputs`, worked out on the host: one window
    for each group of up to `group` consecutive edges of one origin in
    frame_order, within each block's run of the order. The kernel's own
    count (c_frame's `staged`) must agree."""
    from devo_tpu_torch.ops import probe_cuda
    fmap, _, y0, x08 = inputs[:4]
    order = probe_cuda.frame_order(y0, x08, fmap.shape[1]).long()
    key = (y0.reshape(-1).long() * fmap.shape[1]
           + 8 * x08.reshape(-1).long())[order].cpu().numpy()
    E, n = key.size, 0
    for b in range(grid):
        i, hi = E * b // grid, E * (b + 1) // grid
        while i < hi:
            j = i + 1
            while j < hi and j - i < group and key[j] == key[i]:
                j += 1
            n, i = n + 1, j
    return n


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


SMALL_GRID = 7                   # the second grid of the same-bits check


def c_ablate(lib, args, mode: str, plan, out=None):
    """One launch of devo_corr_band_ablate of `lib` (this tree's library
    where None) by its C interface into `out` (a new tensor where None):
    `args` as ops/probe_cuda.band_ablate_cuda takes them, `plan` the two
    integers after the ring's shape: persistent blocks and stages."""
    from devo_tpu_torch.ops import corr_cuda as cc
    from devo_tpu_torch.ops import probe
    nlive, slot, band, y0, g, ry, rx, ring = args
    lib = lib or cc._load()
    E = g.shape[0]
    if out is None:
        out = torch.empty((E, 8, 16 * probe.PP), dtype=torch.float32,
                          device=g.device)
    code = lib.devo_corr_band_ablate(
        *(t.data_ptr() for t in (nlive, slot, band, y0, g, ry, rx, ring, out)),
        E, ring.shape[1], ring.shape[2], *plan, probe.ABLATE_MODES.index(mode),
        torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"corr_band_ablate by its C interface: launch "
                           f"failed ({code})")
    return out


def c_frame(lib, inputs, extract: bool, plan, order, staged=None):
    """One launch of devo_corr_frame_probe of `lib` (this tree's library
    where None) by its C interface, `plan` as c_ablate's, on the edges in
    `order` (ops/probe_cuda.frame_order or another permutation), with
    `staged` None or a (1,) int64 tensor on the device to which the kernel
    adds the windows it stages."""
    from devo_tpu_torch.ops import corr_cuda as cc
    from devo_tpu_torch.ops import probe
    fmap, gm = inputs[:2]
    lib = lib or cc._load()
    E = gm.shape[0]
    out = torch.empty((E, 8 if extract else probe.WIN, 16 * probe.PP),
                      dtype=torch.float32, device=gm.device)
    code = lib.devo_corr_frame_probe(
        *(t.data_ptr() for t in inputs), order.data_ptr(), out.data_ptr(), E,
        fmap.shape[1], *plan, int(extract),
        None if staged is None else staged.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"corr_frame_probe by its C interface: launch "
                           f"failed ({code})")
    return out


def c_copy(lib, ring, slot, row0, mode: str, route: str, blocks: int):
    """One launch of devo_copy_probe (K14'') of `lib` (this tree's library
    where None) by its C interface, uncounted, its order scratch included
    (ops/probe_cuda.copy_launch)."""
    from devo_tpu_torch.ops import corr_cuda as cc
    from devo_tpu_torch.ops import probe_cuda
    code, out = probe_cuda.copy_launch(lib or cc._load(), ring, slot, row0,
                                       mode, route, blocks)
    if code:
        raise RuntimeError(f"copy_probe by its C interface: launch failed "
                           f"({code})")
    return out


def c_copy_order(slot, mem: int):
    """The copy probe's order alone (devo_copy_order of this tree): (n,)
    int32, the copies stably sorted by slot."""
    from devo_tpu_torch.ops import corr_cuda as cc
    order = torch.empty(slot.shape[0], dtype=torch.int32, device=slot.device)
    code = cc._load().devo_copy_order(slot.data_ptr(), order.data_ptr(),
                                      slot.shape[0], mem,
                                      torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"copy_order by its C interface: launch failed "
                           f"({code})")
    return order


def window_plans(gpu: str):
    """The window kernels' plans (ops/probe_cuda.window_plan: K13'' in
    groups of one, K15'' in groups of FRAME_GROUP) against their own C
    queries: the shared memory at the plan's stages, and for every mode of
    K13'' and both settings of K15'' the blocks an SM by the occupancy
    query, which must hold WINDOW_BLOCKS."""
    from devo_tpu_torch.ops import corr_cuda as cc
    from devo_tpu_torch.ops import probe, probe_cuda
    lib = cc._load()
    plans = {"corr_band_ablate": probe_cuda.window_plan(),
             "corr_frame_probe": probe_cuda.window_plan(group=probe_cuda.FRAME_GROUP)}
    depth, fdepth = plans["corr_band_ablate"][0], plans["corr_frame_probe"][0]
    queried = {"corr_band_ablate": lib.devo_corr_band_ablate_smem(depth),
               "corr_frame_probe": lib.devo_corr_frame_probe_smem(fdepth)}
    blocks = {f"corr_band_ablate {m}": lib.devo_corr_band_ablate_blocks_per_sm(
        probe.ABLATE_MODES.index(m), depth) for m in probe.ABLATE_MODES}
    blocks.update({f"corr_frame_probe extract={x}":
                   lib.devo_corr_frame_probe_blocks_per_sm(int(x), fdepth)
                   for x in (True, False)})
    print(f"window plans (stages, bytes a block): {plans}, "
          f"{probe_cuda.WINDOW_BLOCKS} blocks an SM planned; the kernels' own "
          f"bytes {queried}; blocks an SM by the occupancy query {blocks} "
          f"[{gpu}]", flush=True)
    if (any(queried[k] != plans[k][1] for k in plans)
            or min(blocks.values()) < probe_cuda.WINDOW_BLOCKS):
        raise RuntimeError(f"window plans {plans} disagree with the kernels: "
                           f"{queried}, {blocks}")


def window_grids(args, frame_inputs, live: int, gpu: str):
    """K13'' (every mode) and K15'' (both settings) at this tree's grid and
    at SMALL_GRID persistent blocks, by their C interfaces: the same bits;
    and K15'' on the edges in their own order (no two adjacent edges share
    a window but by chance) against frame_order's: the same bits."""
    from devo_tpu_torch.ops import probe, probe_cuda
    depth, _ = probe_cuda.window_plan()
    dev = args[4].device
    grid = probe_cuda.window_grid(args[4].shape[0], dev)
    for mode in probe.ABLATE_MODES:
        a, b = (c_ablate(None, args, mode, (n, depth))[:live]
                for n in (grid, SMALL_GRID))
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise RuntimeError(f"corr_band_ablate [{mode}]: {grid} and "
                               f"{SMALL_GRID} blocks differ")
    fmap, _, y0, x08 = frame_inputs[:4]
    E = y0.shape[0]
    depth, _ = probe_cuda.window_plan(group=probe_cuda.FRAME_GROUP)
    grid = probe_cuda.window_grid(E, dev)
    order = probe_cuda.frame_order(y0, x08, fmap.shape[1])
    mine = torch.arange(E, dtype=torch.int32, device=dev)
    for extract in (True, False):
        a, b, c = (c_frame(None, frame_inputs, extract, (n, depth), o)
                   for n, o in ((grid, order), (SMALL_GRID, order), (grid, mine)))
        torch.cuda.synchronize()
        if not (torch.equal(a, b) and torch.equal(a, c)):
            raise RuntimeError(f"corr_frame_probe [extract={extract}]: {grid} "
                               f"and {SMALL_GRID} blocks, or the two orders, "
                               f"differ")
    print(f"window kernels: corr_band_ablate (every mode, {live} live rows) and "
          f"corr_frame_probe (both settings; in frame_order and in the edges' "
          f"own order) give the same bits at {grid} and {SMALL_GRID} blocks "
          f"[{gpu}]", flush=True)


RAGGED_E = 1000
RAGGED_LIVE = (100, 0, RAGGED_E)     # nlive: no multiple of 64, none, all


def ragged_ablate(args, gpu: str):
    """K13'' on the first RAGGED_E edges with nlive of RAGGED_LIVE in every
    mode, by its C interface into rows filled with NaN: the rows of the live
    gate's blocks within TOL of the plain version, every other row still
    NaN; and E = 0 through the wrapper (an empty result, no launch)."""
    from devo_tpu_torch.ops import corr_cuda as cc
    from devo_tpu_torch.ops import probe, probe_cuda
    nlive, slot, band, y0, g, ry, rx, ring = args
    dev = g.device
    depth, _ = probe_cuda.window_plan()
    grid = probe_cuda.window_grid(RAGGED_E, dev)
    cut = [t[:RAGGED_E] for t in (slot, band, y0, g, ry, rx)]
    for n in RAGGED_LIVE:
        nl = torch.tensor([n], dtype=torch.int32, device=dev)
        live = min(RAGGED_E, -(-n // probe.BE) * probe.BE)
        for mode in probe.ABLATE_MODES:
            small = (nl, *cut, ring)
            out = torch.full((RAGGED_E, 8, 16 * probe.PP), float("nan"),
                             device=dev)
            c_ablate(None, small, mode, (grid, depth), out)
            want = probe.band_ablate(*small, mode)
            torch.cuda.synchronize()
            torch.testing.assert_close(out[:live], want[:live], **TOL)
            if not out[live:].isnan().all():
                raise RuntimeError(f"corr_band_ablate [{mode}, nlive={n}]: "
                                   f"rows past the live gate were written")
    before = cc.launches["corr_band_ablate"]
    empty = probe_cuda.band_ablate_cuda(nlive, *(t[:0] for t in (slot, band, y0, g,
                                                                 ry, rx)), ring)
    if empty.shape != (0, 8, 16 * probe.PP) or cc.launches["corr_band_ablate"] != before:
        raise RuntimeError(f"corr_band_ablate at E = 0: {tuple(empty.shape)}, "
                           f"{cc.launches['corr_band_ablate'] - before} launches")
    print(f"corr_band_ablate ragged: E = {RAGGED_E} at nlive {RAGGED_LIVE} in "
          f"every mode, the live gate's rows within TOL and no other row "
          f"written; E = 0 empty with no launch [{gpu}]", flush=True)


def probe_phase(dev, gpu: str, record, parent=None):
    """The three probe kernels against their plain versions (ops/probe.py) on
    the card at their drivers' shapes, timed beside their bounds: the banded
    ablation in every mode and index layout (TOL, on the live blocks), the
    copy probe in every mode and route exactly at COPY_GRIDS and timed on one
    block and on one block an SM, its order alone against the plain
    version's (exactly) and timed, tall8's refusal, and the one-frame window
    product with and without extraction (TOL). The window kernels' plan
    against their own queries, their bits at two grids, the ablation's
    ragged live gate; with `parent` (the parent's library), the A/B of K13''
    and K15'' (the parent's bits) and of K14'' (parent_ab, its exact
    output) in turns."""
    from devo_tpu_torch.ops import probe, probe_cuda
    from devo_tpu_torch.scripts import bench_banded_ablate as ablate
    from devo_tpu_torch.scripts import bench_gather, probe_desc_wall
    for name in PROBE_REPORTED:
        record[name] = dict(max_abs_err=0.0, variants=[])
    window_plans(gpu)

    ring, g, ry, rx, layouts = ablate.inputs(dev, PROBE_E, PROBE_MEM, PROBE_NBX,
                                             PROBE_HP)
    nlive = torch.tensor([PROBE_LIVE], dtype=torch.int32, device=dev)
    live = -(-PROBE_LIVE // probe.BE) * probe.BE
    rng = np.random.default_rng(0)
    frame = bench_gather.frame_inputs(np.random.default_rng(1), dev, PROBE_E)
    random_args = (nlive, *layouts["random"], g, ry, rx, ring)
    window_grids(random_args, frame, live, gpu)
    ragged_ablate(random_args, gpu)
    if parent is not None:
        # K13'' and K15'' by their C interfaces at this tree's plans (K15''
        # on its wrapper's order of the edges)
        grid = probe_cuda.window_grid(PROBE_E, dev)
        plans = {"corr_band_ablate": (grid, probe_cuda.window_plan()[0]),
                 "corr_frame_probe": (grid, probe_cuda.window_plan(
                     group=probe_cuda.FRAME_GROUP)[0])}
        order = probe_cuda.frame_order(*frame[2:4], frame[0].shape[1])
        for name, label, rule in parent_ab():
            if name == "corr_band_ablate":
                mode = label.split()[1]
                old, new = (lambda x=x: c_ablate(x, random_args, mode,
                                                 plans[name])
                            for x in (parent, None))
                ab_turns(name, label, rule, old, new, record, gpu, rows=live)
            elif name == "corr_frame_probe":
                extract = label.endswith("True")
                old, new = (lambda x=x: c_frame(x, frame, extract, plans[name],
                                                order)
                            for x in (parent, None))
                ab_turns(name, label, rule, old, new, record, gpu)
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
    del ring, g, ry, rx, layouts, random_args

    rows = probe.banded_shape(120, 160)[0] * probe.BWIN
    gen = torch.Generator(device=dev).manual_seed(0)
    ring8 = torch.randint(-127, 127, (PROBE_MEM, rows, 128), generator=gen,
                          device=dev, dtype=torch.int8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grids = [g or sms for g in COPY_GRIDS]
    copy_ab = {label: rule for name, label, rule in parent_ab()
               if name == "copy_probe"} if parent is not None else {}
    for mode in probe_desc_wall.MODES:
        n = probe.copy_count(mode, COPY_ND)
        slot, row0 = probe_desc_wall.offsets(rng, mode, n, PROBE_MEM, rows, dev)
        want = probe.copy_probe(ring8, slot, row0, mode)
        plain_ms = median_ms(lambda: probe.copy_probe(ring8, slot, row0, mode), 2, 3)
        bound = copy_bound(ring8, slot, row0, mode)
        depth, ns = probe_cuda.copy_depth(mode)
        if mode != "local":
            # the order on the device, exactly the plain version's
            order = c_copy_order(slot, PROBE_MEM)
            if not torch.equal(order, probe.copy_order(slot, mode)[0]):
                raise RuntimeError(f"copy_probe [{mode}]: the copies' order is "
                                   f"not the plain version's")
        if mode == "single":
            order_ms = median_ms(lambda: c_copy_order(slot, PROBE_MEM))
            record["copy_probe"]["order"] = dict(ms=order_ms, n=n)
            print(f"copy_probe's order alone (one cluster of 8 blocks, a "
                  f"counting sort of {n} copies over {PROBE_MEM} slots): "
                  f"{order_ms:.4f} ms, the plain version's bits [{gpu}]",
                  flush=True)
        for route in probe_cuda.ROUTES:
            for blocks in grids:
                got = probe_cuda.copy_probe_cuda(ring8, slot, row0, mode, route,
                                                 blocks)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"copy_probe [{mode} {route}, {blocks} "
                                       f"blocks] is not exact: max abs diff "
                                       f"{(got - want).abs().max().item()}")
            for blocks, what in ((1, "one block"), (sms, "one block an SM")):
                def fn(route=route, blocks=blocks):
                    return probe_cuda.copy_probe_cuda(ring8, slot, row0, mode,
                                                      route, blocks)
                probe_record(record, "copy_probe", f"{mode} {route}, {what}",
                             0.0, median_ms(fn), plain_ms, bound, gpu,
                             f" (exact at {grids} blocks); {n} copies, ring "
                             f"of {depth} stage(s) in {ns} ring(s)")
            for blocks, label in ((sms, f"{mode} {route}"),
                                  (1, f"{mode} {route}, one block")):
                if label in copy_ab:
                    old, new = (lambda x=x, r=route, b=blocks: c_copy(
                        x, ring8, slot, row0, mode, r, b) for x in (parent, None))
                    ab_turns("copy_probe", label, copy_ab[label], old, new,
                             record, gpu)
    try:
        probe_cuda.copy_probe_cuda(ring8, slot[:8], row0[:8], "tall8")
    except ValueError as err:
        print(f"copy_probe [tall8]: refused as it must be: {err} [{gpu}]",
              flush=True)
    else:
        raise RuntimeError("copy_probe [tall8] was not refused")
    del ring8

    inputs = frame
    fmap, _, y0, x08 = frame[:4]
    sort_ms = median_ms(lambda: probe_cuda.frame_order(y0, x08, fmap.shape[1]))
    record["corr_frame_probe"]["sort"] = dict(ms=sort_ms)
    # the kernel alone: by its C interface on the wrapper's order and plan
    order = probe_cuda.frame_order(y0, x08, fmap.shape[1])
    plan = (probe_cuda.window_grid(PROBE_E, dev),
            probe_cuda.window_plan(group=probe_cuda.FRAME_GROUP)[0])
    # the windows staged from L2, as the kernel counts them
    counted = {}
    for extract in (True, False):
        n = torch.zeros(1, dtype=torch.int64, device=dev)
        c_frame(None, inputs, extract, plan, order, staged=n)
        counted[f"extract={extract}"] = int(n.item())
    rule = frame_staged(frame, probe_cuda.FRAME_GROUP, plan[0])
    print(f"corr_frame_probe windows staged a launch, the kernel's own count: "
          f"{counted}; the grouping rule worked out on the host: {rule}; at "
          f"one an edge: {PROBE_E}; a window is 384 x 128 bf16 (98,304 bytes) "
          f"[{gpu}]", flush=True)
    if set(counted.values()) != {rule}:
        raise RuntimeError(f"corr_frame_probe staged {counted} windows, the "
                           f"grouping rule {rule}")
    windows = counted["extract=True"]
    record["corr_frame_probe"]["staged"] = dict(windows=counted)
    alone = record["corr_frame_probe"]["kernel_alone_ms"] = {}
    for extract in (True, False):
        got = probe_cuda.frame_probe_cuda(*inputs, extract=extract)
        want = probe.frame_windows(*inputs, extract=extract)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **TOL)
        alone[f"extract={extract}"] = median_ms(
            lambda: c_frame(None, inputs, extract, plan, order))
        probe_record(record, "corr_frame_probe", f"extract={extract}", err,
                     median_ms(lambda: probe_cuda.frame_probe_cuda(*inputs,
                                                                   extract=extract)),
                     median_ms(lambda: probe.frame_windows(*inputs, extract=extract),
                               2, 3),
                     frame_bound(inputs[0], inputs, extract), gpu,
                     f" within atol {TOL['atol']} + rtol {TOL['rtol']}, output "
                     f"scale {want.abs().max().item():.1f}; {windows} windows "
                     f"staged (the kernel's count), the "
                     f"wrapper's sort alone {sort_ms:.4f} ms, the kernel alone "
                     f"{alone[f'extract={extract}']:.4f} ms")


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


G8C_LAUNCHES = "g8c-launches"
G8C_WARM = 24                       # frames before the profiled ones


def g8c_launch_phase(dev, gpu: str):
    """The launches a frame of every kernel on the g8c configuration (int8
    rings, the bench's CORR_KERNEL="g8c"), under torch.profiler after
    G8C_WARM frames at full width: corr_group once a level and update, no
    other correlation kernel, and no tensor-code stage 2. Runs after the
    profiled slice (nothing is timed after a profile). Returns the launches
    of each kernel over the profiled frames."""
    from devo_tpu_torch.bench import frames
    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.ops import corr as corr_plain
    from devo_tpu_torch.ops import corr_cuda
    from devo_tpu_torch.runtime.config import VOConfig
    from devo_tpu_torch.runtime.engine import DEVO
    from devo_tpu_torch.utils.params import random_state_dict

    cfg = VOConfig(MOTION_PROBE_THRESH=-1.0, CORR_KERNEL="g8c")
    weights = random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS), seed=0)
    slam = DEVO(cfg, weights, ht=HT, wd=WD, seed=0, device=dev)
    intr = np.asarray([320.0, 320.0, WD / 2, HT / 2], np.float32)
    stream = list(frames(G8C_WARM + N_PROFILED))
    for i, vox in enumerate(stream[:G8C_WARM]):
        slam(i / 30.0, vox, intr)
    torch.cuda.synchronize()
    corr_cuda.reset_launches()
    corr_plain.calls = corr_plain.extract_calls = 0
    print(f"g8c launches [int8 rings, {HT}x{WD}, live edges {slam.n_edges}]:",
          flush=True)
    profile_frames(slam, stream[G8C_WARM:], intr, gpu)
    launches = dict(corr_cuda.launches)
    others = [k for k, v in launches.items() if v and k != "corr_group"]
    print(f"g8c launches: corr_group {launches['corr_group'] / N_PROFILED:.2f} "
          f"a frame, tensor-code stage 2 calls {corr_plain.extract_calls}, "
          f"plain correlations {corr_plain.calls} [{gpu}]", flush=True)
    if (launches["corr_group"] < 1 or others or corr_plain.extract_calls
            or corr_plain.calls):
        raise RuntimeError(f"g8c launches: {launches}, stage 2 "
                           f"{corr_plain.extract_calls}, plain {corr_plain.calls}")
    return launches


def frame_sort_launches(dev, gpu: str, record):
    """The kernel launches of corr_frame_probe's sort (ops/probe_cuda.
    frame_order) at the driver's E, counted under torch.profiler, into
    record["corr_frame_probe"]["sort"]. Runs after the profiled phases
    (nothing is timed after a profile)."""
    from torch.profiler import ProfilerActivity, profile
    from devo_tpu_torch.ops import probe_cuda
    from devo_tpu_torch.scripts import bench_gather
    fmap, _, y0, x08 = bench_gather.frame_inputs(np.random.default_rng(1), dev,
                                                 PROBE_E)[:4]
    probe_cuda.frame_order(y0, x08, fmap.shape[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        probe_cuda.frame_order(y0, x08, fmap.shape[1])
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages() if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx"))
    record["corr_frame_probe"]["sort"]["launches"] = n
    print(f"corr_frame_probe's sort (frame_order, E = {PROBE_E}): {n} kernel "
          f"launches a call, {record['corr_frame_probe']['sort']['ms']:.4f} ms "
          f"alone (probe phase) [{gpu}]", flush=True)


def copy_probe_kernels(dev, gpu: str, record):
    """The device time of each of copy_probe's three kernels (the order, the
    copies, the blocks' sum) under torch.profiler, over 20 launches by its C
    interface in `single` at one block an SM on each route, at the driver's
    point, into record["copy_probe"]["kernels_us"]. Runs after the profiled
    phases (nothing is timed after a profile)."""
    from torch.profiler import ProfilerActivity, profile
    from devo_tpu_torch.ops import probe
    from devo_tpu_torch.scripts import probe_desc_wall
    rows = probe.banded_shape(120, 160)[0] * probe.BWIN
    gen = torch.Generator(device=dev).manual_seed(0)
    ring8 = torch.randint(-127, 127, (PROBE_MEM, rows, 128), generator=gen,
                          device=dev, dtype=torch.int8)
    slot, row0 = probe_desc_wall.offsets(np.random.default_rng(0), "single",
                                         COPY_ND, PROBE_MEM, rows, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    names = ("copy_order_kernel", "copy_probe_kernel", "copy_probe_sum")
    record["copy_probe"]["kernels_us"] = out = {}
    for route in ("cp.async", "bulk"):
        for _ in range(3):
            c_copy(None, ring8, slot, row0, "single", route, sms)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                c_copy(None, ring8, slot, row0, "single", route, sms)
            torch.cuda.synchronize()
        out[route] = {name: sum(e.device_time_total for e in prof.key_averages()
                                if name in e.key) / 20 for name in names}
        print(f"copy_probe [single {route}, one block an SM], device us a "
              f"launch by kernel under torch.profiler: {out[route]} [{gpu}]",
              flush=True)


# the kernels that take one level a launch, once for each level of an update
PER_LEVEL = ("corr_level", "corr_level_pipe", "corr_group", "corr_fixed",
             "corr_group8", "corr_level_full")


def path_config(label):
    """The VOConfig that tracking path `label` runs: its overrides of PATHS,
    EVAL_PATHS (over EVAL_CONFIGS["eds"]), FRAME_PATHS (over the frame
    drivers' configuration) or BENCH_PATHS, or the g8c launch count's.
    Raises KeyError on a label of no tracking path."""
    from devo_tpu_torch.runtime.config import EVAL_CONFIGS, VOConfig
    if label in PATHS:
        return VOConfig(**PATHS[label][0])
    if label in EVAL_PATHS:
        return EVAL_CONFIGS["eds"].replace(**EVAL_PATHS[label][0])
    if label in FRAME_PATHS:
        from devo_tpu_torch.eval.frames import frame_config
        return frame_config().replace(**FRAME_PATHS[label][0])
    if label in BENCH_PATHS:
        return VOConfig(**BENCH_PATHS[label][0])
    if label == G8C_LAUNCHES:
        return VOConfig(CORR_KERNEL="g8c")
    if label == LIVE_PATH:
        return VOConfig(**PATHS[LIVE_CONFIG][0])
    raise KeyError(f"{label!r} is no tracking path of chip_smoke.py")


def path_variants(name, label, launched):
    """The kernel phase's variants at which path `label` runs kernel `name`,
    with the share of the path's launches each takes: the ring type of the
    path's configuration by the engine's rule (runtime/engine.ring_i8; bf16
    or f32 rings by MIXED_PRECISION otherwise), each level for a per-level
    kernel (two launches an update, one a level; corr_level level 1 alone
    where the path also launched the resident level-4 kernel), gathered or
    in place for corr_mono2 (CORR_KERNEL "mono2" / "mono4"). `launched`: the
    path's launches of every kernel. None for a driver of DRIVERS, which
    runs its kernels at its own shapes."""
    from devo_tpu_torch.runtime.engine import ring_i8
    if label in DRIVERS:
        return None
    cfg = path_config(label)
    ring = "i8" if ring_i8(cfg) else "bf16"
    if not cfg.MIXED_PRECISION:      # f32 patch features: no variant on i8
        ring = "f32" if ring == "bf16" else "i8, f32 patch features"
    if name == "corr_level_resident":
        return [(f"level 4 {ring}", 1.0)]
    if name == "corr_level" and launched.get("corr_level_resident"):
        return [(f"level 1 {ring}", 1.0)]
    if name in PER_LEVEL:
        return [(f"level 1 {ring}", 0.5), (f"level 4 {ring}", 0.5)]
    if name == "corr_mono2":
        what = "in place" if cfg.CORR_KERNEL == "mono4" else "gathered"
        return [(f"both levels {ring} {what}", 1.0)]
    return [(f"both levels {ring}", 1.0)]


def rule2_loss(kernels, by_path, labels):
    """{kernel name: ms it loses to its bound over the paths `labels`}: each
    path's launches of a kernel times (ms - bound_ms) of the variant the
    path runs (path_variants) at E = E_MAIN; a driver's at the kernel's
    reported time and bound. Raises where a tracking path launched a kernel
    at a variant the kernel phase did not measure. `kernels`: the JSON
    record's entries (name, ms, bound_ms, variants); `by_path`: {path
    label: {kernel name: launches}}."""
    loss = {}
    for k in kernels:
        at = {v["label"]: v for v in k["variants"] if v.get("E") == E_MAIN}
        total = 0.0
        for label in labels:
            n = by_path[label].get(k["name"], 0)
            if not n:
                continue
            parts = path_variants(k["name"], label, by_path[label])
            for variant, share in parts or [(None, 1.0)]:
                if variant is not None and variant not in at:
                    raise KeyError(
                        f"{label} launched {k['name']} {n} times at "
                        f"{variant!r}, which the kernel phase did not measure "
                        f"at E={E_MAIN} (measured: {sorted(at)})")
                v = at[variant] if variant is not None else k
                total += n * share * (v["ms"] - v["bound_ms"])
        loss[k["name"]] = total
    return loss


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of devo_tpu_torch on "
                                 "one CUDA GPU (see the module's docstring).")
    ap.add_argument("--parent", metavar="DIR",
                    help="a directory holding the parent commit's "
                    f"{', '.join(PARENT_SOURCES)}: time the redesigned kernels "
                    "against them after the kernel phase")
    ap.add_argument("--more-moves", action="store_true",
                    help="with --reference: the CPU's spread under "
                    "REF_MORE_MOVES as well as REF_MOVES")
    ap.add_argument("--reference", metavar="LABEL[:KEY=VALUE,...]",
                    action="append",
                    help="run the reference phase alone on this entry of "
                    "REFERENCE, with VOConfig overrides (values as Python "
                    "literals); may be repeated. Prints each entry's line, "
                    "no ok line, and exits non-zero if any entry failed")
    args = ap.parse_args(argv)
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

    if args.reference:
        failed = []
        for spec in args.reference:
            try:
                reference_phase(dev, gpu, spec, reference_knobs(spec),
                                {**REF_MOVES, **REF_MORE_MOVES}
                                if args.more_moves else None)
            except RuntimeError as e:
                print(f"reference [{spec}] failed: {e}", flush=True)
                failed.append(spec)
        sys.exit(f"failed: {failed}" if failed else 0)
    record = kernel_phase(dev, gpu)
    parent = parent_library(args.parent) if args.parent else None
    if parent is not None:
        parent_phase(dev, gpu, parent, record)
    by_path = {}
    probe_phase(dev, gpu, record, parent)
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
    for label, (_, name, _) in EVAL_PATHS.items():
        by_path[label], err = eval_phase(dev, gpu, label, engine_cache, stream)
        record[name]["max_abs_err"] = max(record[name]["max_abs_err"], err)
    for label, (_, name, _) in FRAME_PATHS.items():
        stream = rgb_stream(N_FRAMES, *FRAME_SIZES[label])
        by_path[label], err = eval_phase(dev, gpu, label, engine_cache, stream)
        record[name]["max_abs_err"] = max(record[name]["max_abs_err"], err)
    del engine_cache, stream
    viewer_phase(dev, gpu)
    by_path[LIVE_PATH], err = live_phase(dev, gpu)
    record["corr_pyramid"]["max_abs_err"] = max(
        record["corr_pyramid"]["max_abs_err"], err)
    for label, (_, _, name) in BENCH_PATHS.items():
        by_path[label], err = bench_phase(dev, gpu, label)
        record[name]["max_abs_err"] = max(record[name]["max_abs_err"], err)
    train_pieces_phase(dev, gpu)
    train_phase(dev, gpu)
    run_slice(PROFILED)              # last: nothing is timed after a profile
    trace_phase(dev, gpu)
    by_path[G8C_LAUNCHES] = g8c_launch_phase(dev, gpu)
    by_path[PROFILED_DRIVER] = driver_phase(dev, gpu, PROFILED_DRIVER)
    frame_sort_launches(dev, gpu, record)
    copy_probe_kernels(dev, gpu, record)

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
            **{key: rec[key] for key in ("stages", "parent_ab", "structures",
                                         "surface_instance", "sort", "staged",
                                         "kernel_alone_ms", "order",
                                         "kernels_us")
               if key in rec}})
        if kernels[-1]["launches"] < 1:
            raise RuntimeError(f"{name} was launched on no path")
    # the order of the port's kernel work: a kernel slower than a PyTorch call
    # for the same function first (none has one), then by the time it loses
    # to its bound over this run's launches, each at the variant its path
    # runs; first over every path, drivers included, then over the tracking
    # paths alone (slice, eval, bench and the g8c launch count; no driver of
    # devo_tpu_torch/scripts/), which is the order rule 2 reads
    for what, labels in (("every path, drivers included", list(by_path)),
                         ("the tracking paths alone (rule 2)",
                          [k for k in by_path if k not in DRIVERS])):
        loss = rule2_loss(kernels, by_path, labels)
        print(f"kernels by launches x (ms - bound_ms), {what}, this run: "
              + ", ".join(f"{name} {v:.1f}" for name, v in
                          sorted(loss.items(), key=lambda kv: -kv[1])),
              flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
