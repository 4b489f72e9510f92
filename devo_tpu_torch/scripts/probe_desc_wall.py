"""The copy-issue probe (csrc/copy_probe.cu), counterpart of
scripts/probe_desc_wall.py: what issuing a window copy from device memory
into shared memory costs, at the engine's int8 band shapes.

    python -m devo_tpu_torch.scripts.probe_desc_wall [MODE ...]

Modes (default: single pair tall2 tall4 dual quad local):
  single     9600 copies of one window, 384 rows x 128 bytes (48 KB)
  pair       4800 copies spanning the same rows of two consecutive slots
  tallM      9600 / M copies of M windows' rows (tall8, 384 KB a copy, is
             beyond a block's shared memory: refused)
  local      9600 copies out of a 1024-row column held in shared memory
  dual/quad  single, the copies dealt in turn to 2 / 4 rings of stages
Each on both copy routes (cp.async: 16 bytes a thread; bulk: one
cp.async.bulk a contiguous run, waited on an mbarrier), and on one block
and on one block an SM (contiguous runs of the copies). A run prints the
mode's ring depth and copies in flight, then per route and block count the
best and median time of a launch over repeats, each with fresh random
offsets, and us a copy and GB/s.
"""
from __future__ import annotations

import numpy as np
import torch

from devo_tpu_torch.ops import probe, probe_cuda
from devo_tpu_torch.scripts import common

MODES = ("single", "pair", "tall2", "tall4", "dual", "quad", "local")
H0, W0 = 120, 160             # level-1 features of a 480x640 frame


def offsets(rng, mode: str, n: int, mem: int, rows: int, dev):
    """(slot, row0) of n copies: random slots (the first of a pair) and
    random rows, multiples of 8, that keep the copy inside its slot."""
    S, M, _ = probe.copy_plan(mode)
    max_r0 = rows - M * probe.WR - 8
    slot = rng.integers(0, mem - (S - 1), n).astype(np.int32)
    row0 = (rng.integers(0, max_r0 // 8, n) * 8).astype(np.int32)
    return torch.from_numpy(slot).to(dev), torch.from_numpy(row0).to(dev)


def main(argv=None):
    p = common.parser(__doc__.split("\n\n")[0])
    p.add_argument("modes", nargs="*", default=list(MODES),
                   help=f"of {probe.COPY_MODES}")
    p.add_argument("--routes", nargs="+", default=list(probe_cuda.ROUTES),
                   choices=probe_cuda.ROUTES)
    p.add_argument("--nd", type=int, default=9600,
                   help="window-sized copies (about the live edges)")
    p.add_argument("--mem", type=int, default=32)
    p.add_argument("--rows", type=int, default=None,
                   help="rows of a slot; default that of a 120x160 level")
    p.add_argument("--colr", type=int, default=probe.COLR)
    p.add_argument("--nit", type=int, default=16,
                   help="back-to-back launches a repeat")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--blocks", nargs="+", default=None, type=int,
                   help="block counts; default 1 and one an SM")
    args = p.parse_args(argv)
    for mode in args.modes:
        try:
            probe_cuda.copy_depth(mode, args.colr)
        except ValueError as err:
            raise SystemExit(f"refused: {err}")
    dev = common.device(args)
    gpu = common.card(dev)
    rows = (args.rows or probe.banded_shape(H0, W0)[0] * probe.BWIN)
    C = 128
    g = torch.Generator(device=dev).manual_seed(0)
    ring = torch.randint(-127, 127, (args.mem, rows, C), generator=g,
                         device=dev, dtype=torch.int8)
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 4)
    blocks = args.blocks or [1, sms]
    print(f"ring ({args.mem}, {rows}, {C}) int8 ({ring.numel() / 1e6:.0f} MB), "
          f"{args.nd} window copies of {probe.WR} rows [{gpu}]", flush=True)
    rng = np.random.default_rng(0)
    results = {}
    for mode in args.modes:
        S, M, _ = probe.copy_plan(mode)
        depth, ns = probe_cuda.copy_depth(mode, args.colr)
        n = probe.copy_count(mode, args.nd)
        nbytes = S * M * probe.WR * C
        print(f"[{mode}] {n} copies of {nbytes // 1024} KB; ring of {depth} "
              f"stage(s) in {ns} ring(s), {depth} copies in flight", flush=True)
        for route in args.routes:
            for nb in blocks:
                state = {}

                def fresh(rep, mode=mode, n=n):
                    # fresh random offsets every repeat
                    state["idx"] = offsets(rng, mode, n, args.mem, rows, dev)

                def launch(i, mode=mode, route=route, nb=nb):
                    return probe_cuda.copy_probe_cuda(
                        ring, *state["idx"], mode, route, nb, args.colr)

                fresh(-1)
                times = common.median_ms(launch, dev, args.nit, args.repeats,
                                         before=fresh)
                dt = times[0]
                source = ("device memory" if mode != "local"
                          else f"a {args.colr}-row column in shared memory")
                results[(mode, route, nb)] = times
                print(f"[{mode}] {route:8s} {nb:3d} block(s): min {dt:.4f} "
                      f"ms/launch (med {common.median(times):.4f}, max "
                      f"{times[-1]:.4f}); {dt / n * 1e3:.4f} us/copy, "
                      f"{n * nbytes / dt / 1e6:.0f} GB/s into shared memory, "
                      f"{n * nbytes / 1e6:.1f} MB copied from {source} "
                      f"({args.nd / n:.0f} window(s) a copy) [{gpu}]",
                      flush=True)
    return results


if __name__ == "__main__":
    main()
