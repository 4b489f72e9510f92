"""E-row gathers against one-hot products for the engine's lookups, and the
one-frame window product kernel (csrc/corr_frame_probe.cu); counterpart of
scripts/bench_gather.py.

    python -m devo_tpu_torch.scripts.bench_gather

The gathers and one-hot products are PyTorch calls on purpose: they are
the script's comparison (E = 15360 lookups into a table of 2496 live patch
slots, or of 32 frames), timed as index_select, as indexing, and as one-hot
products in bf16 and in f32. The kernel: one resident (144, 184, 128) bf16
frame, a 16 x 24 window an edge at a given origin, its product with the
edge's 16 patch rows, with the pixels' strips extracted (E, 8, 144) and
without ((E, 16, 144)); the TPU script's `nsc` only rotated scratch buffers
and is gone. Times are medians of back-to-back launches between CUDA
events.
"""
from __future__ import annotations

import numpy as np
import torch

from devo_tpu_torch.ops import probe, probe_cuda
from devo_tpu_torch.scripts import common

HP, WP, C = 144, 184, 128


def frame_inputs(rng, dev, E: int):
    """(fmap, gm, y0, x08, ry, rx8) as scripts/bench_gather.py:67-72 draws
    them, the bulk values made on the device."""
    fmap = common.randn((HP, WP, C), dev, 1)
    gm = common.randn((E, 16, C), dev, 2)

    def ints(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32)).to(dev)

    return (fmap, gm, ints(0, HP - probe.WIN, (E, 1)),
            ints(0, (WP - probe.BWIN) // 8, (E, 1)), ints(0, 9, (E, 16)),
            ints(0, 2, (E, 16)))


def main(argv=None):
    p = common.parser(__doc__.split("\n\n")[0])
    p.add_argument("--edges", type=int, default=15360)
    p.add_argument("--slots", type=int, default=2496, help="live patch slots")
    p.add_argument("--iters", type=int, default=8,
                   help="back-to-back launches a repeat")
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    dev = common.device(args)
    gpu = common.card(dev)
    E, T = args.edges, args.slots
    rng = np.random.default_rng(0)

    def timed(name, fn):
        ms = common.median(common.median_ms(lambda i: fn(), dev, args.iters,
                                            args.repeats))
        print(f"{name:44s} {ms:8.4f} ms [{gpu}]", flush=True)
        return ms

    def table(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    def index(hi):
        return torch.from_numpy(rng.integers(0, hi, E)).to(dev)

    tbl384, tbl27, tbl7 = table((T, 384)), table((T, 27)), table((32, 7))
    idx, idx32 = index(T), index(32)
    results = {}
    for tbl, ix, what in ((tbl384, idx, "E x (384,)"), (tbl27, idx, "E x (27,)"),
                          (tbl7, idx32, "E x (7,) from (32, 7)")):
        results[f"index_select {what}"] = timed(
            f"index_select {what} f32", lambda t=tbl, i=ix: t.index_select(0, i))
        results[f"indexing {what}"] = timed(
            f"indexing {what} f32", lambda t=tbl, i=ix: t[i])
    for tbl, ix, what in ((tbl384, idx, "E x (384,)"), (tbl27, idx, "E x (27,)"),
                          (tbl7, idx32, "E x (7,)")):
        rows = torch.arange(tbl.shape[0], device=dev)

        def onehot(t=tbl, i=ix, rows=rows):
            oh = (i[:, None] == rows[None, :]).to(torch.bfloat16)
            return (oh @ t.to(torch.bfloat16)).float()

        results[f"one-hot bf16 {what}"] = timed(f"one-hot matmul bf16 {what}", onehot)
    rows = torch.arange(T, device=dev)
    results["one-hot f32 E x (384,)"] = timed(
        "one-hot matmul f32 E x (384,)",
        lambda: (idx[:, None] == rows[None, :]).float() @ tbl384)

    inputs = frame_inputs(rng, dev, E)
    for extract in (True, False):
        ms = timed(f"frame window product extract={extract}",
                   lambda x=extract: probe_cuda.frame_probe_cuda(*inputs, extract=x))
        results[f"frame extract={extract}"] = ms
        print(f"   -> {ms / E * 1e3:.4f} us/edge [{gpu}]", flush=True)
    return results


if __name__ == "__main__":
    main()
