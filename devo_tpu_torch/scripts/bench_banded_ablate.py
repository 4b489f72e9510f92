"""Ablate the stages of the banded window kernel (csrc/corr_band_ablate.cu),
counterpart of scripts/bench_banded_ablate.py.

    python -m devo_tpu_torch.scripts.bench_banded_ablate [--drift]

Modes, all on the same inputs and launch shape:
  full   copy + product + extraction of the pixels' strips
  noext  copy + product, the first 72 rows of the product out
  nomm   copy only, window values out
  noDMA  product + extraction on a window that is never copied
for six layouts of the window addresses (slot, band, y0): random, sorted
slots, one constant window, the engine's cyclic pattern, slots cycling 0..7
with (band, y0) fixed per group of 8, and cyclic slots at random group
origins. E = 15360 edges of which the first 6144 are live (the kernel's
gate reads the count on the device). Prints ms a launch and us a live
edge, the median over repeats of back-to-back launches between CUDA
events; with --drift every launch of a repeat reads other windows (y0 and
band move by one), as the real step's addresses do.
"""
from __future__ import annotations

import numpy as np
import torch

from devo_tpu_torch.ops import probe, probe_cuda
from devo_tpu_torch.scripts import common

LAYOUTS = ("random", "sorted", "const", "cyclic", "cycle8", "grouped")


def layouts(rng, E: int, mem: int, nbx: int, hp: int) -> dict:
    """layout -> (slot, band, y0) int32 arrays, drawn from `rng` as
    scripts/bench_banded_ablate.py:132-169 draws them (each index then
    taken modulo its range, which changes nothing at the script's sizes)."""
    top = hp - probe.WIN
    i = np.arange(E)
    out = {
        "random": (rng.integers(0, mem, E), rng.integers(0, nbx, E),
                   rng.integers(0, top, E)),
        "sorted": (np.sort(rng.integers(0, mem, E)), rng.integers(0, nbx, E),
                   rng.integers(0, top, E)),
        "const": (np.zeros(E), np.zeros(E), np.zeros(E)),
        "cyclic": (i % 13,
                   np.clip((i // 13) % nbx + rng.integers(-1, 2, E), 0, nbx - 1),
                   np.clip(rng.integers(0, top, E // 13 + 1).repeat(13)[:E]
                           + rng.integers(-2, 3, E), 0, top)),
        "cycle8": (i % 8, rng.integers(0, nbx, (E // 8 + 1,)).repeat(8)[:E],
                   rng.integers(0, top, (E // 8 + 1,)).repeat(8)[:E]),
        "grouped": (i % 13,
                    np.clip(rng.integers(0, nbx, E // 13 + 1).repeat(13)[:E]
                            + rng.integers(-1, 2, E), 0, nbx - 1),
                    np.clip(rng.integers(0, top, E // 13 + 1).repeat(13)[:E]
                            + rng.integers(-2, 3, E), 0, top)),
    }
    # the cyclic layouts address slots 0..12 and need a ring that deep
    return {k: tuple((np.asarray(a) % m).astype(np.int32)
                     for a, m in zip(v, (mem, nbx, top + 1)))
            for k, v in out.items()}


def inputs(dev, E: int, mem: int, nbx: int, hp: int, seed: int = 0):
    """(ring, g, ry, rx, layouts): the ring and the patch rows made on the
    device from `seed`, the offsets and the layouts drawn by numpy."""
    rng = np.random.default_rng(seed)
    ring = common.randn((mem, nbx, hp, probe.BWIN, 128), dev, seed, 0.1)
    g = common.randn((E, probe.ROWS, 128), dev, seed + 1, 0.1)
    ry = torch.from_numpy(rng.integers(0, 8, (E, 16)).astype(np.int32)).to(dev)
    rx = torch.from_numpy(rng.integers(0, 3, (E, 16)).astype(np.int32)).to(dev)
    lay = {k: tuple(torch.from_numpy(a).to(dev) for a in v)
           for k, v in layouts(rng, E, mem, nbx, hp).items()}
    return ring, g, ry, rx, lay


def main(argv=None):
    p = common.parser(__doc__.split("\n\n")[0])
    p.add_argument("--drift", action="store_true",
                   help="move every launch's windows (y0 and band + 1)")
    p.add_argument("--edges", type=int, default=15360)
    p.add_argument("--live", type=int, default=6144)
    p.add_argument("--mem", type=int, default=32)
    p.add_argument("--nbx", type=int, default=22)
    p.add_argument("--hp", type=int, default=144)
    p.add_argument("--iters", type=int, default=12,
                   help="back-to-back launches a repeat")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--layouts", nargs="+", default=list(LAYOUTS),
                   choices=LAYOUTS)
    p.add_argument("--modes", nargs="+", default=list(probe.ABLATE_MODES),
                   choices=probe.ABLATE_MODES)
    args = p.parse_args(argv)
    dev = common.device(args)
    gpu = common.card(dev)
    E, live, hp, nbx = args.edges, args.live, args.hp, args.nbx
    ring, g, ry, rx, lay = inputs(dev, E, args.mem, nbx, hp)
    nlive = torch.tensor([live], dtype=torch.int32, device=dev)
    depth, smem = probe_cuda.window_plan()
    print(f"E={E} live={live} ring {tuple(ring.shape)} bf16 "
          f"({ring.numel() * 2 / 1e6:.0f} MB), window ring of {depth} stages "
          f"({smem} bytes a block, {probe_cuda.WINDOW_BLOCKS} blocks an SM), "
          f"drift={int(args.drift)} [{gpu}]", flush=True)
    results = {}
    for layout in args.layouts:
        slot, band, y0 = lay[layout]
        # the addresses of every launch of a repeat, made before its clock
        moves = [(band, y0)]
        if args.drift:
            for _ in range(args.iters - 1):
                b, y = moves[-1]
                moves.append(((b + 1) % nbx, (y + 1) % (hp - probe.WIN)))
        for mode in args.modes:
            def launch(i, mode=mode):
                b, y = moves[i % len(moves)]
                return probe_cuda.band_ablate_cuda(nlive, slot, b, y, g, ry,
                                                   rx, ring, mode)
            ms = common.median(common.median_ms(launch, dev, args.iters,
                                                args.repeats))
            results[(layout, mode)] = ms
            print(f"{layout:8s} {mode:8s} {ms:8.3f} ms  "
                  f"({ms / live * 1e3:6.3f} us/live-edge) [{gpu}]", flush=True)
    return results


if __name__ == "__main__":
    main()
