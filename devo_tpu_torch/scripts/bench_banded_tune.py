"""Tune the per-level window kernel of CORR_KERNEL="full"
(csrc/corr_level_full.cu) on an engine-shaped level-1 workload; counterpart
of scripts/bench_banded_tune.py.

    python -m devo_tpu_torch.scripts.bench_banded_tune [--depth D] [--run R]
        [--edges E] [--live LIVE] [--jj cycle13|random|const] [--drift 1|0]
        [--stage full|noext|nomm|noDMA]

The TPU script's knobs (IF, K, NSC, BE: the copies in flight, the ring, the
result scratches, the edge block) have these counterparts: --depth, the
stages of the window ring (2 to ops/corr_cuda.FULL_MAX_DEPTH; default as
many as two blocks an SM hold), and --run, the consecutive edges a block
walks (default ops/corr_cuda.full_run's); both are checked against the
kernel's shared memory. --stage is the TPU's ABLATE. The workload: 32 bf16
rings of 120x160x128, 3072 patch features, E edges sorted by patch with
their frames cycling a 13-frame window (or random, or one frame), patch
centers scattered over the image; the first LIVE edges are the live ones,
which the kernel takes (the port's engine passes live edges alone). With
drift the coordinates move by -1, 0 and +1 pixel in turn from launch to
launch.
Prints ms a launch and us a live edge, the median over repeats of
back-to-back launches between CUDA events.
"""
from __future__ import annotations

import numpy as np
import torch

from devo_tpu_torch.ops import corr as plain
from devo_tpu_torch.ops import corr_cuda
from devo_tpu_torch.scripts import common

H, W, C = 120, 160, 128
MEM, MR = 32, 32 * 96


def main(argv=None):
    p = common.parser(__doc__.split("\n\n")[0])
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--run", type=int, default=None)
    p.add_argument("--edges", type=int, default=10240)
    p.add_argument("--live", type=int, default=6912)
    p.add_argument("--jj", default="cycle13", choices=("cycle13", "random", "const"))
    p.add_argument("--drift", type=int, default=1, choices=(0, 1))
    p.add_argument("--stage", default="full", choices=plain.STAGES)
    p.add_argument("--iters", type=int, default=20,
                   help="back-to-back launches a repeat")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--size", type=int, nargs=2, default=(H, W),
                   help="level-1 rows and columns")
    args = p.parse_args(argv)
    h, w = args.size
    try:
        cap, depth, blocks = corr_cuda.full_knobs(3, C, torch.bfloat16,
                                                  args.depth, args.run)
    except ValueError as err:
        raise SystemExit(f"refused: {err}")
    dev = common.device(args)
    gpu = common.card(dev)
    E, live = args.edges, min(args.live, args.edges)
    rng = np.random.default_rng(0)
    fmap = common.randn((MEM, h, w, C), dev, 0, 0.1)
    gmap = common.randn((MR, 3, 3, C), dev, 1, 0.1)
    kk = np.sort(rng.integers(0, MR, E))
    jj = {"cycle13": np.arange(E) % 13, "random": rng.integers(0, 13, E),
          "const": np.zeros(E, np.int64)}[args.jj]
    cx = rng.uniform(8, w - 8, (E, 1, 1))
    cy = rng.uniform(8, h - 8, (E, 1, 1))
    gx, gy = np.meshgrid(np.arange(3) - 1, np.arange(3) - 1, indexing="xy")
    coords0 = np.stack([cx + gx, cy + gy], -1).astype(np.float32)[:live]
    kk = torch.from_numpy(kk[:live].astype(np.int32)).to(dev)
    jj = torch.from_numpy(jj[:live].astype(np.int32)).to(dev)
    # the coordinates of every launch, made before the clock: the TPU
    # script's steps of -1, 0, +1 pixel, summed
    shifts = (-1.0, -1.0, 0.0) if args.drift else (0.0,)
    coords = [torch.from_numpy(coords0 + s).to(dev) for s in shifts]

    def launch(i):
        c = coords[i % len(coords)]
        if dev.type == "cpu":
            return plain.corr_level_stage(gmap, fmap, c, kk, jj, args.stage, cap)
        return corr_cuda.corr_level_full_cuda(gmap, fmap, c, kk, jj,
                                              stage=args.stage, depth=depth,
                                              run=args.run)

    ms = common.median(common.median_ms(launch, dev, args.iters, args.repeats))
    run = (args.run or corr_cuda.full_run(live, dev, blocks)
           if dev.type == "cuda" else args.run)
    print(f"depth={depth} run={run} cap={cap} E={E} LIVE={live} jj={args.jj} "
          f"drift={args.drift} {args.stage}: {ms:8.3f} ms "
          f"({ms / live * 1e3:6.3f} us/live-edge) [{gpu}]", flush=True)
    return ms


if __name__ == "__main__":
    main()
