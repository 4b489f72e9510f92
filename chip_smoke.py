"""Smoke run of devo_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

1. Prints the card (`nvidia-smi` name and power limit) and the torch / CUDA
   versions.
2. Builds the correlation kernel (csrc/corr.cu, nvcc for sm_90a) into
   devo_tpu_torch/_build/ and prints ptxas's register report.
3. Kernel phase: the kernel against its plain PyTorch version on the card,
   at the tracking step's shapes (E = 12288 edges, E = 96 for the motion
   probe, a ragged E; C = 128, mem = 32, rings of 120x160 and 30x40 in bf16,
   coordinates partly off the image), with max error against the stated
   tolerance and the median time of each.
4. Reference phase: the port's DEVO on the card against the same engine on
   the CPU (plain correlation; the CPU tests hold that path against the JAX
   package) at a small f32 size: the same keyframes, culls and edge sets
   per frame, and poses and terminate() output within atol 5e-2.
5. Slice phase: the port's DEVO at full width (VOConfig() defaults:
   480x640, 96 patches, mixed precision) with seeded random weights over 48
   timed frames of a sliding event texture, 8 more frames under
   torch.profiler (where the time goes, by engine phase), then 12 update()
   calls and terminate(). Checks a finite trajectory with one pose per
   frame, at least one keyframe cull, kernel launches > 0 and no
   plain-correlation call; then holds the kernel against the plain version
   once more on the engine's own final edges and rings.
6. Prints the kernels' JSON record, the card line, and as its last line
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
N_FRAMES = 48                      # timed frames
N_PROFILED = 8                     # then frames under torch.profiler
N_UPDATES = 12
TOL = dict(atol=1e-3, rtol=1e-4)   # f32 sums of the same bf16 products,
                                   # in another order


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


def corr_case(E: int, dev, seed: int):
    """Random bf16 rings and patch-grid coordinates at the step's shapes;
    patch centers reach 8 px past the level-1 image on every side."""
    from devo_tpu_torch.runtime.config import VOConfig
    cfg = VOConfig()
    g = torch.Generator(device=dev).manual_seed(seed)
    h1, w1, C, mem, M = HT // 4, WD // 4, cfg.DIM_FNET, cfg.MEM, cfg.M
    bf = torch.bfloat16
    gmap = torch.randn((mem * M, 3, 3, C), generator=g, device=dev).to(bf)
    fmap1 = torch.randn((mem, h1, w1, C), generator=g, device=dev).to(bf)
    fmap2 = torch.randn((mem, h1 // 4, w1 // 4, C), generator=g, device=dev).to(bf)
    cx = torch.rand((E, 1, 1), generator=g, device=dev) * (w1 + 16) - 8
    cy = torch.rand((E, 1, 1), generator=g, device=dev) * (h1 + 16) - 8
    off = torch.arange(-1.0, 2.0, device=dev)
    coords = torch.stack([(cx + off[None, None, :]).expand(E, 3, 3),
                          (cy + off[None, :, None]).expand(E, 3, 3)], -1)
    coords = coords + 0.3 * torch.randn(coords.shape, generator=g, device=dev)
    kk = torch.randint(0, mem * M, (E,), generator=g, device=dev, dtype=torch.int32)
    jj = torch.randint(0, mem, (E,), generator=g, device=dev, dtype=torch.int32)
    return gmap, (fmap1, fmap2), coords.contiguous(), kk, jj


def compare(label: str, args, time_it: bool, gpu: str):
    from devo_tpu_torch.ops import corr as corr_plain
    from devo_tpu_torch.ops import corr_cuda
    gmap, pyr, coords, kk, jj = args
    got = corr_cuda.corr_pyramid(gmap, pyr, coords, kk, jj)
    want = corr_plain.corr_pyramid(gmap, pyr, coords, kk, jj)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **TOL)
    ms = plain_ms = None
    if time_it:
        ms = median_ms(lambda: corr_cuda.corr_pyramid(gmap, pyr, coords, kk, jj))
        plain_ms = median_ms(
            lambda: corr_plain.corr_pyramid(gmap, pyr, coords, kk, jj),
            launches=2, repeats=3)
    timing = (f"; median kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
              if time_it else "")
    print(f"corr {label} E={coords.shape[0]}: max_abs_err {err:.3e} within "
          f"atol {TOL['atol']} + rtol {TOL['rtol']}{timing} [{gpu}]",
          flush=True)
    return err, ms, plain_ms


def kernel_phase(dev, gpu: str):
    errs, ms, plain_ms = [], None, None
    for E, seed in ((12288, 0), (96, 1), (5003, 2)):
        err, t, pt = compare("random", corr_case(E, dev, seed), True, gpu)
        errs.append(err)
        if E == 12288:
            ms, plain_ms = t, pt
    return max(errs), ms, plain_ms


def frames():
    """bench.py's synthetic stream: a sliding 5-bin event texture."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((HT, WD * 2, 5)).astype(np.float32)
    base *= rng.random((HT, WD * 2, 5)) < 0.1
    for i in range(N_FRAMES + N_PROFILED):
        sh = (3 * i) % WD
        yield base[:, sh:sh + WD]


def profile_frames(slam, stream, intr, gpu: str):
    """Run frames under torch.profiler and print where the time goes: the
    device's busy share, the kernel's share of device time, kernel launches,
    and host and device time of each engine phase (the devo.* spans)."""
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
    k1_ms = sum(e.self_device_time_total for e in device
                if "corr_pyramid_kernel" in e.key) / 1e3
    def count(*names):
        return sum(e.count for e in ka if e.key in names)

    n_launch = count("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx")
    # each one makes the host wait for the device
    n_sync = count("cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize")
    n_copy = count("cudaMemcpyAsync", "cudaMemcpy")
    print(f"profile: {n} frames under torch.profiler, {wall_ms / n:.2f} ms/frame "
          f"wall; device busy {dev_ms / n:.2f} ms/frame ({dev_ms / wall_ms:.3f} "
          f"of wall); corr kernel {k1_ms / n:.3f} ms/frame "
          f"({k1_ms / max(dev_ms, 1e-9):.3f} "
          f"of device time); per frame {n_launch / n:.0f} kernel launches, "
          f"{n_sync / n:.1f} host syncs, {n_copy / n:.1f} memcpy calls [{gpu}]",
          flush=True)
    for e in sorted((e for e in ka if e.key.startswith("devo.")
                     and e.cpu_time_total > 0), key=lambda e: e.key):
        print(f"  {e.key}: {e.count / n:.2f} calls/frame, host "
              f"{e.cpu_time_total / 1e3 / n:.2f} ms/frame, device "
              f"{e.device_time_total / 1e3 / n:.2f} ms/frame", flush=True)


REF_HT, REF_WD, REF_FRAMES = 64, 64, 18
REF_TOL = 5e-2      # pose atol: float noise compounds over the 12-update
                    # initialization and the per-frame BA


def reference_phase(dev, gpu: str):
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
                   DIM=8, MIXED_PRECISION=False, SCORER_EVAL_MODE="topk")
    weights = random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS), seed=1)
    rng = np.random.default_rng(1)
    base = rng.standard_normal((REF_HT, 2 * REF_WD, 5)).astype(np.float32)
    base *= rng.random(base.shape) < 0.15
    depths = rng.random((REF_FRAMES, cfg.M, 1)).astype(np.float32)
    intr = np.asarray([80.0, 80.0, REF_WD / 2, REF_HT / 2], np.float32)

    engines = {d.type: DEVO(cfg, weights, ht=REF_HT, wd=REF_WD, device=d)
               for d in (torch.device("cpu"), dev)}
    before = corr_cuda.launches
    culls = 0
    for i in range(REF_FRAMES):
        vox = base[:, 3 * i:3 * i + REF_WD]
        for d, slam in engines.items():
            slam._draw_depth = lambda i=i, d=d: torch.from_numpy(depths[i]).to(d)
            slam(i / 30.0, vox, intr)
        ref, got = engines["cpu"], engines[dev.type]
        if (got.n != ref.n or got.aux_log[-1][1].kf_removed
                != ref.aux_log[-1][1].kf_removed):
            raise RuntimeError(f"reference frame {i}: n {got.n} vs {ref.n}, "
                               f"cull {got.aux_log[-1][1].kf_removed} vs "
                               f"{ref.aux_log[-1][1].kf_removed}")
        edges = [set(zip(s.kk.tolist(), s.jj.tolist())) for s in (got, ref)]
        if edges[0] != edges[1]:
            raise RuntimeError(f"reference frame {i}: edge tables differ")
        err = (got.poses[:got.n].cpu() - ref.poses[:ref.n]).abs().max().item()
        if not err <= REF_TOL:
            raise RuntimeError(f"reference frame {i}: poses differ by {err}")
        culls += ref.aux_log[-1][1].kf_removed
    for slam in engines.values():
        for _ in range(N_UPDATES):
            slam.update()
    (p_got, t_got), (p_ref, t_ref) = (engines[dev.type].terminate(),
                                      engines["cpu"].terminate())
    err = float(np.abs(p_got - p_ref).max())
    print(f"reference: port on {dev.type} vs port on cpu, {REF_HT}x{REF_WD}, "
          f"{REF_FRAMES} frames + {N_UPDATES} updates: same keyframes, culls "
          f"({culls}) and edge sets; terminate() poses max abs diff {err:.3e} "
          f"(atol {REF_TOL}); corr kernel launches "
          f"{corr_cuda.launches - before} [{gpu}]", flush=True)
    if not (err <= REF_TOL and np.array_equal(t_got, t_ref)
            and np.isfinite(p_got).all()):
        raise RuntimeError("reference: terminate() outputs differ")
    if culls < 1:
        raise RuntimeError("reference: no keyframe cull happened")


def slice_phase(dev, gpu: str):
    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.ops import corr as corr_plain
    from devo_tpu_torch.ops import corr_cuda
    from devo_tpu_torch.runtime.config import VOConfig
    from devo_tpu_torch.runtime.engine import DEVO
    from devo_tpu_torch.utils.params import random_state_dict

    # random weights reject every frame at the motion probe (a learned
    # behavior, devo.py:531-534); bench.py disables it the same way
    cfg = VOConfig(MOTION_PROBE_THRESH=-1.0)
    weights = random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS), seed=0)
    slam = DEVO(cfg, weights, ht=HT, wd=WD, seed=0, device=dev)
    intr = np.asarray([320.0, 320.0, WD / 2, HT / 2], np.float32)
    stream = list(frames())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    corr_cuda.launches = 0
    corr_plain.calls = 0
    frame_s = []
    for i, vox in enumerate(stream[:N_FRAMES]):
        t0 = time.perf_counter()
        slam(i / 30.0, vox, intr)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    profile_frames(slam, stream[N_FRAMES:], intr, gpu)
    t0 = time.perf_counter()
    for _ in range(N_UPDATES):
        slam.update()
    poses, tss = slam.terminate()
    torch.cuda.synchronize()
    t_end = time.perf_counter() - t0
    launches, plain_calls = corr_cuda.launches, corr_plain.calls

    n_all = len(stream)
    culls = sum(bool(aux.kf_removed) for _, aux in slam.aux_log)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    skip = N_FRAMES // 3        # initialization and the first culls
    tail = frame_s[skip:]
    print(f"slice: {HT}x{WD}, frames/s over frames {skip}-{N_FRAMES - 1}: "
          f"{len(tail) / sum(tail):.2f} (median frame {1e3 * np.median(tail):.2f} "
          f"ms; first frame {1e3 * frame_s[0]:.1f} ms, init frame "
          f"{1e3 * max(frame_s[:skip]):.1f} ms); {N_UPDATES} updates + "
          f"terminate {1e3 * t_end:.1f} ms; after {n_all} frames: live edges "
          f"{slam.n_edges}, keyframes {slam.n}, culls {culls}; peak memory "
          f"{peak_gib:.2f} GiB; corr kernel launches {launches}, plain corr "
          f"calls {plain_calls} [{gpu}]", flush=True)
    if poses.shape != (n_all, 7) or tss.shape != (n_all,):
        raise RuntimeError(f"trajectory shape {poses.shape}, {tss.shape}")
    if not np.isfinite(poses).all():
        raise RuntimeError("trajectory is not finite")
    if culls < 1:
        raise RuntimeError("no keyframe cull happened")
    if launches < 1 or plain_calls != 0:
        raise RuntimeError(f"the step did not run on the kernel alone: "
                           f"{launches} launches, {plain_calls} plain calls")

    # the kernel once more, on the engine's own edges and rings
    from devo_tpu_torch.geom import edgewise
    geo = edgewise.reproject(slam.poses, slam.patches, slam.intrinsics,
                             slam.ii, slam.jj, slam.kk)
    args = (slam.gmap, (slam.fmap1, slam.fmap2),
            edgewise.coords_to_corr_format(geo, cfg.P),
            (slam.kk % (cfg.M * cfg.MEM)).int(), (slam.jj % cfg.MEM).int())
    err, _, _ = compare("engine-state", args, False, gpu)
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
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    print(lib.with_suffix(".log").read_text().strip(), flush=True)

    err_k, ms, plain_ms = kernel_phase(dev, gpu)
    reference_phase(dev, gpu)
    launches, err_e = slice_phase(dev, gpu)

    print(json.dumps({"kernels": [{
        "name": "corr_pyramid", "route": "cuda",
        "source": "devo_tpu_torch/csrc/corr.cu",
        "replaces": "devo_tpu/ops/corr_pallas.py:1553",
        "launches": launches, "max_abs_err": max(err_k, err_e),
        "ms": ms, "plain_ms": plain_ms}]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
