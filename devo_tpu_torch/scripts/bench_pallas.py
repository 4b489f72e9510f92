"""Time the fixed-window correlation kernel of CORR_IMPL="pallas"
(csrc/corr_fixed.cu) at E = 20480 edges, of which 6144 are live;
counterpart of scripts/bench_pallas.py.

    python -m devo_tpu_torch.scripts.bench_pallas

One level-1 launch over 32 bf16 rings of 120x160x128 and 3072 patch
features, every pixel of a patch at its own random coordinate, frames
sorted in [0, 20): once over all E edges (the TPU kernel's grid) and once
over the live ones (what the port's engine passes). Prints ms a launch and
us an edge, the median over repeats of back-to-back launches between CUDA
events.
"""
from __future__ import annotations

import numpy as np
import torch

from devo_tpu_torch.ops import corr as plain
from devo_tpu_torch.ops import corr_cuda
from devo_tpu_torch.scripts import common

MEM, H, W, C = 32, 120, 160, 128
P, PP, M = 3, 9, 96


def fixed_level(gmap, fmap, coords, kk, jj):
    """corr_fixed on the card, its plain version on the CPU."""
    if gmap.device.type == "cpu":
        return plain.corr_level(gmap, fmap, coords, kk, jj)
    return corr_cuda.corr_fixed_cuda(gmap, fmap, coords, kk, jj)


def main(argv=None):
    p = common.parser(__doc__.split("\n\n")[0])
    p.add_argument("--edges", type=int, default=20480)
    p.add_argument("--live", type=int, default=6144)
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
    jj = torch.from_numpy(np.sort(rng.integers(0, 20, E)).astype(np.int32)).to(dev)
    x = rng.uniform(8, w - 8, (E, PP)).astype(np.float32)
    y = rng.uniform(8, h - 8, (E, PP)).astype(np.float32)
    coords = torch.from_numpy(np.stack([x, y], -1).reshape(E, P, P, 2)).to(dev)
    results = {}
    for label, n in (("all", E), ("live", min(args.live, E))):
        ms = common.median(common.median_ms(
            lambda i, n=n: fixed_level(gmap, fmap, coords[:n], kk[:n], jj[:n]),
            dev, args.iters, args.repeats))
        results[label] = ms
        print(f"corr_fixed (E={n}, {label} edges of {E}, live={args.live}): "
              f"{ms:.4f} ms ({ms / n * 1e3:.4f} us/edge) [{gpu}]", flush=True)
    return results


if __name__ == "__main__":
    main()
