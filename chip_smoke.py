"""Smoke run of devo_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

1. Prints the card (`nvidia-smi` name and power limit) and the torch / CUDA
   versions.
2. Builds the correlation kernels (csrc/*.cu, one nvcc call for sm_90a) into
   devo_tpu_torch/_build/ and prints ptxas's register report.
3. Kernel phase: every kernel against its plain PyTorch version on the card,
   at the tracking step's shapes (E = 12288 edges, E = 96 for the motion
   probe, a ragged E; C = 128, mem = 32, rings of 120x160 and 30x40,
   coordinates partly off the image): the three two-level kernels
   (corr_pyramid, corr_pair, corr_pair2) on bf16 and on int8 rings, the
   per-level kernel on both levels and both ring types, the resident
   level-4 kernel on int8 rings; the per-level kernels stacked, and
   corr_pair and corr_pair2, against corr_pyramid; and corr_pair and
   corr_pair2 at a narrow width (C = 8) whose int8 feature vectors are too
   short for the 16-byte copies, so that every tap reads the ring
   directly. Max error against the stated tolerance, the
   median time of each, and the kernel's bound: the least time the card
   could take, the larger of the bytes it must move (the ring positions its
   taps touch, the distinct patch features, coordinates, indices, scales and
   the output, each once) over 3.35 TB/s and its operations over 989
   TFLOP/s.
4. Reference phase: the port's DEVO on the card against the same engine on
   the CPU (plain correlation; the CPU tests hold that path against the JAX
   package) at a small f32 size, for unquantised rings (corr_pyramid,
   corr_pair, corr_pair2) and for the five int8 configurations: the same
   keyframes, culls and edge sets per frame, and poses and terminate()
   output within the stated tolerance.
5. Slice phase: the port's DEVO at full width (480x640, 96 patches, mixed
   precision) with seeded random weights over frames of a sliding event
   texture, then 12 update() calls and terminate(), on three paths of 48
   timed frames each, so that their frame rates compare: the bf16 path (the
   two-level kernel on bf16 rings), the default path (int8 rings, the
   two-level kernel) and, after the eval phase, the quantised split path
   (int8 rings, one launch per level, level 4 from the resident ring),
   which then runs 8 more frames under torch.profiler (where the time
   goes, by engine phase). The launch counts are set to 0 just
   before each path and read just after it. Each path must end with a
   finite trajectory with one pose per frame, at least one keyframe cull,
   launches > 0 of the kernels it names and no plain-correlation call; then
   its kernels are held against the plain versions once more on the
   engine's own final edges and rings.
6. Eval phase: the evaluation entry point at full width.
   devo_tpu_torch.eval.harness.evaluate_sequence with EVAL_CONFIGS["eds"]
   (bf16 rings) and CORR_KERNEL="pair", then with int8 rings and
   CORR_KERNEL="pair2": random weights from seed 0, an in-memory iterator
   of 48 frames of the same texture with intrinsics and timestamps, a
   straight-line ground truth, two trials on one cached engine, TUM dumps
   and a results JSON under chiprun_out/. It must hold one engine per
   configuration, as many poses from trial 0 as from a fresh engine, finite
   ATE / MPE / R_rmse that the independent ATE cross-check confirms, the
   artifacts on disk, one launch of the configuration's kernel per
   correlation of the run and no plain-correlation call. Under random
   weights the ATE says nothing about accuracy.
7. Prints the kernels' JSON record, the card line, and as its last line
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
}
# the three paths of the slice phase: VOConfig overrides and the kernels
# each must launch. The profiled path runs last, so that no path is timed
# in a process that torch.profiler has already traced (its tracing may stay
# attached and cost the host time at every later launch).
PATHS = {
    "bf16-mono": (dict(CORR_RING_I8=False, CORR_KERNEL="mono",
                       CORR_L4_RESIDENT="off"), ("corr_pyramid",)),
    "i8-mono": (dict(CORR_RING_I8=True, CORR_KERNEL="mono",
                     CORR_L4_RESIDENT="off"), ("corr_pyramid",)),
    "i8-split-resident": (dict(CORR_RING_I8=True, CORR_KERNEL="split",
                               CORR_L4_RESIDENT="auto"),
                          ("corr_level", "corr_level_resident")),
}
PROFILED = "i8-split-resident"
# the two configurations of the eval phase, on EVAL_CONFIGS["eds"]: VOConfig
# overrides and the kernel each must launch
EVAL_PATHS = {
    "eval-eds-bf16-pair": (dict(CORR_KERNEL="pair"), "corr_pair"),
    "eval-eds-i8-pair2": (dict(CORR_KERNEL="pair2", CORR_RING_I8=True),
                          "corr_pair2"),
}
EVAL_TRIALS = 2
OUT_DIR = "chiprun_out/eval_smoke"


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


def bound_ms(gmap, rings, strides, scales, coords, kk, jj):
    """The least time the card could take for the correlation of these
    inputs over `rings` (one per level, coords divided by its stride): the
    larger of bytes / 3.35 TB/s and operations / 989 TFLOP/s. Returns
    (ms, "bytes" or "operations")."""
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
        flops += 2 * C * taps
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def variants(case):
    """Every (kernel name, label, kernel call, plain call, bound arguments)
    measured on one case."""
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
        for name, fn in (("corr_pair", cc.corr_pair_cuda),
                         ("corr_pair2", cc.corr_pair2_cuda)):
            out.append((name, f"both levels {label}",
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
    out.append(("corr_level_resident", "level 4 i8",
                lambda: cc.corr_level_resident_cuda(gmap, i8[1], c4, kk, jj, sc[1]),
                lambda: plain.corr_level(gmap, i8[1], c4, kk, jj, sc[1]),
                ((i8[1],), (4,), (sc[1],))))
    return out


# the variant whose numbers stand for a kernel in the JSON record: the one
# the default (int8) configurations run at the step's edge count
REPORTED = {"corr_pyramid": "both levels i8", "corr_level": "level 1 i8",
            "corr_level_resident": "level 4 i8", "corr_pair": "both levels i8",
            "corr_pair2": "both levels i8"}


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
            torch.testing.assert_close(got, want, **TOL)
            ms = median_ms(kernel)
            plain_ms = median_ms(plain, launches=2, repeats=3)
            b_ms, b_by = bound_ms(gmap, rings, strides, scales, coords, kk, jj)
            print(f"{name} [{label}] E={E}: max_abs_err {err:.3e} within atol "
                  f"{TOL['atol']} + rtol {TOL['rtol']}; median kernel "
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
                continue
            for kernel in ("pair", "pair2"):
                got = cc.corr_pyramid(gmap, pyr, coords, kk, jj, scales=scales,
                                      kernel=kernel)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, mono, **TOL)
                print(f"{kernel} vs mono [{label}] E={E}: max abs diff "
                      f"{(got - mono).abs().max().item():.3e} [{gpu}]",
                      flush=True)
    for ring in (torch.bfloat16, torch.int8):
        blocks = cc.pair2_blocks_per_sm(3, 128, torch.bfloat16, ring)
        print(f"corr_pair2 [{ring} rings, C=128]: {blocks} block(s) of 384 "
              f"threads per SM [{gpu}]", flush=True)
    narrow_case(dev, gpu, record)
    return record


def narrow_case(dev, gpu: str, record):
    """corr_pair and corr_pair2 at C = 8: an int8 feature vector is 8 bytes,
    no multiple of the 16-byte copies, so nothing is staged and every tap
    reads the ring directly; a bf16 vector is 16 bytes, the narrowest that
    is staged."""
    from devo_tpu_torch.ops import corr as plain
    from devo_tpu_torch.ops import corr_cuda as cc
    gmap, bf, i8, sc, coords, kk, jj = corr_case(5003, dev, 3, C=8)
    for label, pyr, scales in (("i8, direct reads", i8, sc),
                               ("bf16, staged", bf, None)):
        want = plain.corr_pyramid(gmap, pyr, coords, kk, jj, scales=scales)
        for kernel in ("pair", "pair2"):
            got = cc.corr_pyramid(gmap, pyr, coords, kk, jj, scales=scales,
                                  kernel=kernel)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            torch.testing.assert_close(got, want, **TOL)
            rec = record["corr_" + kernel]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            print(f"corr_{kernel} [C=8 {label}] E=5003: max_abs_err {err:.3e} "
                  f"within atol {TOL['atol']} + rtol {TOL['rtol']} [{gpu}]",
                  flush=True)


def frames(n: int):
    """bench.py's synthetic stream: a sliding 5-bin event texture."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((HT, WD * 2, 5)).astype(np.float32)
    base *= rng.random((HT, WD * 2, 5)) < 0.1
    for i in range(n):
        sh = (3 * i) % WD
        yield base[:, sh:sh + WD]


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
    from devo_tpu_torch.ops import corr_cuda
    from devo_tpu_torch.runtime.config import VOConfig
    from devo_tpu_torch.runtime.engine import DEVO
    from devo_tpu_torch.utils.params import random_state_dict

    cfg = VOConfig(BUFFER_SIZE=32, HT=REF_HT, WD=REF_WD, PATCHES_PER_FRAME=4,
                   PATCH_LIFETIME=5, REMOVAL_WINDOW=9, OPTIMIZATION_WINDOW=4,
                   MOTION_PROBE_THRESH=-1.0, MEM=16, DIM_INET=32, DIM_FNET=16,
                   DIM=8, MIXED_PRECISION=False, SCORER_EVAL_MODE="topk",
                   **knobs)
    tol = REF_TOL[cfg.CORR_RING_I8]
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
    if not any(corr_cuda.launches.values()):
        raise RuntimeError(f"reference {label}: no kernel was launched")


def slice_phase(dev, gpu: str, label: str, n_frames: int, n_profiled: int):
    """One path of PATHS at full width. Returns (launches of each kernel on
    the path, max error of its kernels on the engine's final state)."""
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
    corr_plain.calls = 0
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

    n_all = len(stream)
    culls = sum(bool(aux.kf_removed) for _, aux in slam.aux_log)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    tail = frame_s[SKIP:]
    print(f"slice [{label}]: {HT}x{WD}, rings {slam.fmap1.dtype}, resident "
          f"level 4 {slam.l4_resident}; frames {SKIP}-{n_frames - 1}: "
          f"{len(tail) / sum(tail):.2f} frames/s (median frame "
          f"{1e3 * np.median(tail):.2f} ms), kernel launches per frame "
          f"{per_frame}; first frame "
          f"{1e3 * frame_s[0]:.1f} ms, init frame {1e3 * max(frame_s[:SKIP]):.1f} "
          f"ms; {N_UPDATES} updates + terminate {1e3 * t_end:.1f} ms; after "
          f"{n_all} frames: live edges {slam.n_edges}, keyframes {slam.n}, "
          f"culls {culls}; peak memory {peak_gib:.3f} GiB; kernel launches "
          f"{launches}, plain corr calls {plain_calls} [{gpu}]", flush=True)
    if poses.shape != (n_all, 7) or tss.shape != (n_all,):
        raise RuntimeError(f"{label}: trajectory shape {poses.shape}, {tss.shape}")
    if not np.isfinite(poses).all():
        raise RuntimeError(f"{label}: trajectory is not finite")
    if culls < 1:
        raise RuntimeError(f"{label}: no keyframe cull happened")
    unnamed = [k for k in launches if k not in named and launches[k]]
    if any(launches[k] < 1 for k in named) or unnamed or plain_calls != 0:
        raise RuntimeError(f"{label}: the step did not run on its kernels "
                           f"{named} alone: {launches}, {plain_calls} plain calls")

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
    scales = (slam.fsc1, slam.fsc2) if cfg.CORR_RING_I8 else None
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel=cfg.CORR_KERNEL,
                                 resident=slam.l4_resident)
    want = corr_plain.corr_pyramid(*args, scales=scales)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **TOL)
    print(f"engine state [{label}] E={slam.n_edges}: max_abs_err {err:.3e} "
          f"within atol {TOL['atol']} + rtol {TOL['rtol']} [{gpu}]", flush=True)
    return err


def eval_phase(dev, gpu: str, label: str, engine_cache: dict, stream):
    """One configuration of EVAL_PATHS through evaluate_sequence at full
    width. `stream`: the frames as (bins, H, W) arrays. Returns (launches of
    each kernel during evaluate_sequence, max error of the configuration's
    kernel on the engine's final state)."""
    import os

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
    # initialization (frame 8), one per later frame, 12 final updates
    per_trial = 7 + 12 + (n - 8) + N_UPDATES
    others = [k for k, v in launches.items() if v and k != kernel]
    if (launches[kernel] != EVAL_TRIALS * per_trial or others
            or plain_calls != 0):
        raise RuntimeError(f"{label}: expected {EVAL_TRIALS * per_trial} "
                           f"launches of {kernel} alone, got {launches} and "
                           f"{plain_calls} plain calls")
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
          f"{slam.fmap1.dtype}, CORR_KERNEL={cfg.CORR_KERNEL!r}, {n} frames + "
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
    for label, knobs in REFERENCE.items():
        reference_phase(dev, gpu, label, knobs)

    by_path = {}

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
    stream = [np.ascontiguousarray(v.transpose(2, 0, 1)) for v in frames(N_FRAMES)]
    for label, (_, name) in EVAL_PATHS.items():
        by_path[label], err = eval_phase(dev, gpu, label, engine_cache, stream)
        record[name]["max_abs_err"] = max(record[name]["max_abs_err"], err)
    del engine_cache, stream
    run_slice(PROFILED)              # last: nothing is timed after a profile

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
            "reported_variant": f"{REPORTED[name]}, E={E_MAIN}",
            "variants": rec["variants"]})
        if kernels[-1]["launches"] < 1:
            raise RuntimeError(f"{name} was launched on no path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
