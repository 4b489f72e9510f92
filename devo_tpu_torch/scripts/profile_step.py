"""Profile the steady tracking step of the engine with torch.profiler and
print the top device operations; counterpart of scripts/profile_step.py.

    python -m devo_tpu_torch.scripts.profile_step [N_WARM]

The engine at full width (480x640, random weights from seed 0,
MOTION_PROBE_THRESH=-1) over the bench's sliding texture: N_WARM frames
(default 40), then 6 frames (--profiled) under the profiler. Prints the top device
operations by self device time per frame, the device's busy share of the
wall clock, and per frame the kernel launches, the host waits for the
device (stream, device and event synchronisations) and the copies. The
configuration comes from the bench's environment knobs (BENCH_CORR_KERNEL,
BENCH_RING_I8, BENCH_KEYFRAME_THRESH; devo_tpu_torch.bench): a bad value,
a knob of a TPU layout (BENCH_CORR_WR1, BENCH_SCORER_S2D,
BENCH_ENCODER_S2D, ...) or --hlo (an XLA dump) exits non-zero.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from devo_tpu_torch import bench
from devo_tpu_torch.scripts import common

N_PROFILED = 6
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
COPIES = ("cudaMemcpyAsync", "cudaMemcpy")


def profile(slam, frames, first: int, intr, dev):
    """Run `frames` under torch.profiler; returns (key_averages, wall ms)."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with prof_ctx(activities=acts) as prof:
        t0 = time.perf_counter()
        for i, vox in enumerate(frames):
            slam((first + i) / 30.0, vox, intr)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = 1e3 * (time.perf_counter() - t0)
    return prof.key_averages(), wall


def main(argv=None):
    p = common.parser(__doc__.split("\n\n")[0])
    p.add_argument("n_warm", nargs="?", type=int, default=40)
    p.add_argument("--hlo", action="store_true",
                   help="devo_tpu's XLA dump: refused")
    p.add_argument("--size", type=int, nargs=2, default=(bench.HT, bench.WD))
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   help="a VOConfig field over the bench's configuration")
    p.add_argument("--top", type=int, default=45)
    p.add_argument("--profiled", type=int, default=N_PROFILED,
                   help="frames under the profiler")
    args = p.parse_args(argv)
    if args.hlo:
        raise SystemExit("--hlo dumps XLA's optimised HLO; the port runs "
                         "eager PyTorch and has none")
    knobs = bench.knobs_from_env()
    dev = common.device(args)
    gpu = common.card(dev)
    from torch.autograd import DeviceType

    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.runtime.config import VOConfig
    from devo_tpu_torch.runtime.engine import DEVO
    from devo_tpu_torch.utils.params import random_state_dict

    ht, wd = args.size
    cfg = VOConfig(HT=ht, WD=wd, MOTION_PROBE_THRESH=-1.0,
                   **{**knobs, **common.overrides(args.set)})
    weights = random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS), seed=0)
    slam = DEVO(cfg, weights, ht=ht, wd=wd, seed=0, device=dev)
    base = bench.texture(ht, wd, cfg.BINS)
    intr = bench.intrinsics(ht, wd)
    for i in range(args.n_warm):
        slam(i / 30.0, bench.frame(base, i), intr)
    print(f"profiling after {args.n_warm} frames: live edges {slam.n_edges}, "
          f"keyframes {slam.n}, CORR_KERNEL={cfg.CORR_KERNEL!r}, rings "
          f"{slam.fmap1.dtype} [{gpu}]", flush=True)
    n = args.profiled
    frames = [bench.frame(base, args.n_warm + i) for i in range(n)]
    ka, wall = profile(slam, frames, args.n_warm, intr, dev)
    device_ops = [e for e in ka if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in device_ops) / 1e3
    ops = device_ops if device_ops else [e for e in ka if not e.is_user_annotation]

    def self_ms(e):
        t = e.self_device_time_total if device_ops else e.self_cpu_time_total
        return t / 1e3

    print(f"{'op':60s} {'self ms':>10s} {'count':>7s}")
    for e in sorted(ops, key=self_ms, reverse=True)[:args.top]:
        print(f"{e.key[:60]:60s} {self_ms(e) / n:10.3f} {e.count / n:7.1f}")
    print(f"(self ms and count per frame over {n} profiled frames; "
          f"{'device' if device_ops else 'host (no device trace)'} time)")

    def count(names):
        return sum(e.count for e in ka if e.key in names) / n

    print(f"per frame: wall {wall / n:.2f} ms, device busy {busy / n:.2f} ms "
          f"({busy / wall:.3f} of wall), {count(LAUNCHES):.0f} kernel launches, "
          f"{count(WAITS):.1f} host waits, {count(COPIES):.1f} copies [{gpu}]",
          flush=True)
    return ka


if __name__ == "__main__":
    main()
