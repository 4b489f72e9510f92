"""Frames/s of the evaluation path, run_voxel, on the bench's synthetic
480x640 stream; counterpart of scripts/bench_eval_path.py.

    python -m devo_tpu_torch.scripts.bench_eval_path [N_FRAMES]

devo_tpu_torch.bench feeds the engine by hand; real runs go through
eval.harness.run_voxel, which copies each (bins, H, W) frame of an
iterator to the device and adds 12 final updates. This drives the same
sliding texture through run_voxel: a warm run of 72 frames on a cached
engine, then the timed run of N_FRAMES (default 160) on the same engine,
and prints one JSON line with its frames/s (first frame to the last
update). With EVAL_PATH_INSTRUMENT set it replays run_voxel's loop with
clocks around the frame's copy, the engine's call and the final updates
instead. The configuration comes from the bench's environment knobs
(devo_tpu_torch.bench); a bad value or a TPU-only knob exits non-zero.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from devo_tpu_torch import bench
from devo_tpu_torch.scripts import common


def stream(base, n: int, intr, offset: int = 0):
    """n frames of the texture as run_voxel's iterators yield them:
    ((bins, H, W), intrinsics, timestamp)."""
    for i in range(offset, offset + n):
        yield (np.transpose(bench.frame(base, i), (2, 0, 1)), intr, i / 30.0)


def main(argv=None):
    p = common.parser(__doc__.split("\n\n")[0])
    p.add_argument("n_frames", nargs="?", type=int, default=160)
    p.add_argument("--warm", type=int, default=72)
    p.add_argument("--size", type=int, nargs=2, default=(bench.HT, bench.WD))
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   help="a VOConfig field over the bench's configuration")
    args = p.parse_args(argv)
    knobs = bench.knobs_from_env()
    dev = common.device(args)
    gpu = common.card(dev)
    from devo_tpu_torch.eval.harness import _on_device, run_voxel
    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.runtime.config import VOConfig
    from devo_tpu_torch.utils.params import random_state_dict

    ht, wd = args.size
    cfg = VOConfig(HT=ht, WD=wd, MOTION_PROBE_THRESH=-1.0,
                   **{**knobs, **common.overrides(args.set)})
    weights = random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS), seed=0)
    base = bench.texture(ht, wd, cfg.BINS)
    intr = bench.intrinsics(ht, wd)
    cache = {}
    t0 = time.perf_counter()
    run_voxel(cfg, weights, stream(base, args.warm, intr), ht, wd, seed=0,
              final_updates=0, engine_cache=cache, device=dev)
    print(f"warm run of {args.warm} frames in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if os.environ.get("EVAL_PATH_INSTRUMENT"):
        slam = next(iter(cache.values()))
        slam.reset(seed=0)
        t_copy = t_call = 0.0
        t0 = time.perf_counter()
        n = 0
        for vox, intr_f, ts in stream(base, args.n_frames, intr):
            g0 = time.perf_counter()
            uv = _on_device(vox, dev)
            g1 = time.perf_counter()
            slam(ts, uv, intr_f)
            g2 = time.perf_counter()
            t_copy += g1 - g0
            t_call += g2 - g1
            n += 1
        f0 = time.perf_counter()
        for _ in range(12):
            slam.update()
        sync()
        f1 = time.perf_counter()
        print(json.dumps({
            "metric": "eval_path_phase_ms_per_frame", "n_frames": n,
            "total_s": f1 - t0, "fps": n / (f1 - t0),
            "copy_ms": t_copy / n * 1e3, "call_ms": t_call / n * 1e3,
            "final_updates_s": f1 - f0, "card": gpu}))
        return None

    poses, _, fps = run_voxel(cfg, weights, stream(base, args.n_frames, intr),
                              ht, wd, seed=0, final_updates=12,
                              engine_cache=cache, timing=True, device=dev)
    if poses.shape != (args.n_frames, 7) or not np.isfinite(poses).all():
        raise SystemExit(f"the run gave {poses.shape} poses, not all finite")
    out = {"metric": "eval_path_fps", "value": fps, "unit": "frames/s",
           "n_frames": args.n_frames, "corr_kernel": cfg.CORR_KERNEL,
           "ring_i8": cfg.CORR_RING_I8, "device": str(dev), "card": gpu,
           "size": [ht, wd],
           "note": "run_voxel on the bench's synthetic stream, one copy a "
                   "frame, incl. 12 final updates"}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
