"""Correctness and time of the fixed-window correlation kernel of
CORR_IMPL="pallas" (csrc/corr_fixed.cu) at E = 20480 edges; counterpart of
scripts/bench_pallas2.py.

    python -m devo_tpu_torch.scripts.bench_pallas2

Patches of 3x3 pixels spread up to 1.2 px around random centers, frames at
random in [0, 32). The first 512 edges (of the first 6144, the live ones)
against the plain version (ops/corr.corr_level): the max abs error, the
scale of the output and their ratio; then the launch over all E edges,
timed as the median over repeats of back-to-back launches between CUDA
events.
"""
from __future__ import annotations

import numpy as np
import torch

from devo_tpu_torch.ops import corr as plain
from devo_tpu_torch.scripts import bench_pallas, common

MEM, H, W, C = 32, 120, 160, 128
P, PP, M = 3, 9, 96


def main(argv=None):
    p = common.parser(__doc__.split("\n\n")[0])
    p.add_argument("--edges", type=int, default=20480)
    p.add_argument("--live", type=int, default=6144)
    p.add_argument("--check", type=int, default=512,
                   help="edges held against the plain version")
    p.add_argument("--iters", type=int, default=8,
                   help="back-to-back launches a repeat")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--size", type=int, nargs=2, default=(H, W))
    args = p.parse_args(argv)
    dev = common.device(args)
    gpu = common.card(dev)
    h, w = args.size
    E = args.edges
    rng = np.random.default_rng(0)
    fmap = common.randn((MEM, h, w, C), dev, 0)
    gmap = common.randn((MEM * M, P, P, C), dev, 1)
    kk = torch.from_numpy(rng.integers(0, MEM * M, E).astype(np.int32)).to(dev)
    jj = torch.from_numpy(rng.integers(0, MEM, E).astype(np.int32)).to(dev)
    x = rng.uniform(8, w - 8, (E, 1)) + rng.uniform(-1.2, 1.2, (E, PP))
    y = rng.uniform(8, h - 8, (E, 1)) + rng.uniform(-1.2, 1.2, (E, PP))
    coords = torch.from_numpy(np.stack([x, y], -1).reshape(E, P, P, 2)
                              .astype(np.float32)).to(dev)

    out = bench_pallas.fixed_level(gmap, fmap, coords, kk, jj)
    print(f"output {tuple(out.shape)} [{gpu}]", flush=True)
    S = min(args.check, args.live, E)
    ref = plain.corr_level(gmap, fmap, coords[:S], kk[:S], jj[:S])
    err = (out[:S] - ref).abs().max().item()
    den = ref.abs().max().item()
    print(f"max abs err vs the plain version on {S} edges: {err:.3e} (scale "
          f"{den:.1f}, rel {err / den:.2e}) [{gpu}]", flush=True)
    ms = common.median(common.median_ms(
        lambda i: bench_pallas.fixed_level(gmap, fmap, coords, kk, jj), dev,
        args.iters, args.repeats))
    print(f"corr_fixed (E={E}): {ms:.4f} ms ({ms / E * 1e3:.4f} us/edge) "
          f"[{gpu}]", flush=True)
    return err, ms


if __name__ == "__main__":
    main()
