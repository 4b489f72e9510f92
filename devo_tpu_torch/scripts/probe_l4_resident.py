"""The two-level correlation with level 4 from the resident-ring kernel
(csrc/corr_level_resident.cu) against the per-level kernel on both levels
(csrc/corr_level.cu), in one process; counterpart of
scripts/probe_l4_resident.py.

    python -m devo_tpu_torch.scripts.probe_l4_resident

E = 10240 edges of which the first 6912 (the live ones) are computed, f32
patch features, every pixel of an edge at one random point; 32 int8 ring
slots of one quantised frame, 120x160 and 30x40, each level with the
frame's own scale. Patches of 3x3 pixels: the TPU script's 4x4 patches do
not fit the resident kernel's block (a 30x40x128 int8 frame and eight
warps' taps of 16 pixels take 251,904 bytes of shared memory, a block has
232,448), and --patch 4 is refused. Prints each configuration's agreement
with the plain version, then its ms a launch and us a live edge, the
median over repeats of back-to-back launches between CUDA events.
"""
from __future__ import annotations

import numpy as np
import torch

from devo_tpu_torch.ops import corr as plain
from devo_tpu_torch.ops import corr_cuda
from devo_tpu_torch.scripts import common
from devo_tpu_torch.scripts.probe_level_split import H0, MEM, W0, C, edges

TOL = dict(atol=1e-3, rtol=1e-4)


def main(argv=None):
    p = common.parser(__doc__.split("\n\n")[0])
    p.add_argument("--edges", type=int, default=10240)
    p.add_argument("--live", type=int, default=6912)
    p.add_argument("--patch", type=int, default=3)
    p.add_argument("--iters", type=int, default=32,
                   help="back-to-back launches a repeat")
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    if not corr_cuda.resident_fits(H0 // 4, W0 // 4, C, args.patch):
        raise SystemExit(
            f"refused: a {H0 // 4}x{W0 // 4}x{C} int8 frame with {args.patch}x"
            f"{args.patch} patches needs "
            f"{corr_cuda.resident_smem_bytes(H0 // 4, W0 // 4, C, args.patch)} "
            f"bytes of shared memory; a block has {corr_cuda.SMEM_MAX}")
    dev = common.device(args)
    gpu = common.card(dev)
    live = min(args.live, args.edges)
    rng = np.random.default_rng(0)
    kk = torch.arange(args.edges, dtype=torch.int32) % (MEM * 4)
    gmap, coords, kk, jj = edges(rng, args.edges, live, args.patch, dev,
                                 torch.float32, mr=args.edges, kk=kk)

    def ring(h, w):
        f = torch.from_numpy(rng.standard_normal((h, w, C)).astype(np.float32))
        q, s = plain.quantize_frame(f)
        return (q.to(dev)[None].expand(MEM, h, w, C).contiguous(),
                s.to(dev).expand(MEM).contiguous())

    r1, s1 = ring(H0, W0)
    r4, s4 = ring(H0 // 4, W0 // 4)
    want = plain.corr_pyramid(gmap, (r1, r4), coords, kk, jj, scales=(s1, s4))
    results = {}
    for name, resident in (("resident", True), ("banded", False)):
        def fn(i, resident=resident):
            return corr_cuda.corr_pyramid(gmap, (r1, r4), coords, kk, jj,
                                          scales=(s1, s4), kernel="split",
                                          resident=resident)
        got = fn(0)
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **TOL)
        ms = common.median(common.median_ms(fn, dev, args.iters, args.repeats))
        results[name] = ms
        print(f"{name}: finite={bool(torch.isfinite(got).all())}, max abs err "
              f"{err:.3e} against the plain version; pyramid {ms:.4f} ms "
              f"({ms / live * 1e3:.4f} us/live-edge, 2 levels) [{gpu}]",
              flush=True)
    return results


if __name__ == "__main__":
    main()
