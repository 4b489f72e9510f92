"""The per-level cost split of the two-level correlation on int8 rings:
level 1 and level 4 of the per-level kernel (csrc/corr_level.cu,
CORR_KERNEL="split") timed apart and as the pyramid; counterpart of
scripts/probe_level_split.py.

    python -m devo_tpu_torch.scripts.probe_level_split

E = 10240 edges of which the first 6912 (the live ones, which the port's
engine passes) are computed; 4x4 patches of 128 channels at one random
point each; 32 int8 ring slots holding one quantised frame, of 120x160
(level 1) and 30x40 (level 4), with unit scales. Prints ms a launch and us
a live edge of each, the median over repeats of back-to-back launches
between CUDA events, and the sum of the levels against the pyramid.
"""
from __future__ import annotations

import numpy as np
import torch

from devo_tpu_torch.ops import corr as plain
from devo_tpu_torch.ops import corr_cuda
from devo_tpu_torch.scripts import common

MEM, C = 32, 128
H0, W0 = 120, 160


def int8_ring(rng, h: int, w: int, dev):
    """MEM slots of one quantised (h, w, C) frame of standard normal values,
    with unit scales (as the TPU script stacks them)."""
    f = torch.from_numpy(rng.standard_normal((h, w, C)).astype(np.float32))
    q, _ = plain.quantize_frame(f)
    ring = q.to(dev)[None].expand(MEM, h, w, C).contiguous()
    return ring, torch.ones(MEM, dtype=torch.float32, device=dev)


def level(gmap, ring, coords, kk, jj, scale, resident: bool = False):
    """One level: the per-level kernel (or, with `resident`, the
    resident-ring kernel) on the card, the plain version on the CPU."""
    if gmap.device.type == "cpu":
        return plain.corr_level(gmap, ring, coords, kk, jj, scale)
    fn = corr_cuda.corr_level_resident_cuda if resident else corr_cuda.corr_level_cuda
    return fn(gmap, ring, coords, kk, jj, scale)


def edges(rng, E: int, live: int, P: int, dev, gmap_dtype=torch.bfloat16,
          mr: int = MEM * 96, kk=None):
    """(gmap, coords, kk, jj) of the live edges: patch features (mr, P, P,
    C) * 0.1, every pixel of an edge at its patch's one random point."""
    gmap = common.randn((mr, P, P, C), dev, 1, 0.1, gmap_dtype)
    kk = (torch.from_numpy(rng.integers(0, mr, (E,)).astype(np.int32))
          if kk is None else kk)
    jj = torch.from_numpy(rng.integers(0, MEM, (E,)).astype(np.int32))
    xy = np.stack([rng.uniform(8, W0 - 8, (E,)), rng.uniform(8, H0 - 8, (E,))],
                  -1).astype(np.float32)
    coords = np.broadcast_to(xy[:, None, None, :], (E, P, P, 2))
    return (gmap, torch.from_numpy(np.ascontiguousarray(coords[:live])).to(dev),
            kk[:live].to(dev), jj[:live].to(dev))


def main(argv=None):
    p = common.parser(__doc__.split("\n\n")[0])
    p.add_argument("--edges", type=int, default=10240)
    p.add_argument("--live", type=int, default=6912)
    p.add_argument("--patch", type=int, default=4)
    p.add_argument("--iters", type=int, default=30,
                   help="back-to-back launches a repeat")
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    dev = common.device(args)
    gpu = common.card(dev)
    live = min(args.live, args.edges)
    rng = np.random.default_rng(0)
    gmap, coords, kk, jj = edges(rng, args.edges, live, args.patch, dev)
    r1, s1 = int8_ring(rng, H0, W0, dev)
    r4, s4 = int8_ring(rng, H0 // 4, W0 // 4, dev)
    c4 = coords / 4
    runs = {
        "lvl1": lambda i: level(gmap, r1, coords, kk, jj, s1),
        "lvl4": lambda i: level(gmap, r4, c4, kk, jj, s4),
        "pyramid": lambda i: corr_cuda.corr_pyramid(
            gmap, (r1, r4), coords, kk, jj, scales=(s1, s4), kernel="split"),
    }
    results = {}
    for name, fn in runs.items():
        ms = common.median(common.median_ms(fn, dev, args.iters, args.repeats))
        results[name] = ms
        print(f"{name}: {ms:.4f} ms ({ms / live * 1e3:.4f} us/live-edge) "
              f"[{gpu}]", flush=True)
    print(f"lvl1+lvl4 = {results['lvl1'] + results['lvl4']:.4f} ms vs pyramid "
          f"{results['pyramid']:.4f} ms [{gpu}]", flush=True)
    return results


if __name__ == "__main__":
    main()
