"""The window kernels of csrc/window_probe.cuh (K13'' corr_band_ablate, K15''
corr_frame_probe) against variants of their design, each built from a copy
of this tree's sources with one edit, timed in turns at the probe drivers'
shapes.

    python -m devo_tpu_torch.scripts.bench_window_variants [--variants NAME ...]

The variants (VARIANTS): `g1` and `g2`, K15'' in groups of one edge (on
the edges' own order, so with no sort) and of two; `nohint`, the window
copies without their L2 fetch hint (both kernels); `contiguous`, K13'' over
contiguous runs of the live edges instead of every grid-th edge. Each must
give this tree's bits. K13'' runs its `--layouts` in its `--modes`; K15''
runs with and without extraction, each kernel alone by its C interface,
and beside them this tree's wrapper, whose sort of the edges is included.
Times are medians of back-to-back launches between CUDA events, in turns:
every version once forward, then once backward. The variants are built by
nvcc into devo_tpu_torch/_build/, so the script needs the card.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

from devo_tpu_torch.ops import corr_cuda, probe, probe_cuda
from devo_tpu_torch.scripts import bench_banded_ablate, bench_gather, common

# the sources of the two kernels, headers included
SOURCES = ("corr_band_ablate.cu", "corr_frame_probe.cu", "window_probe.cuh",
           "corr_mma.cuh", "corr_common.cuh")
# name: (file, text, its replacement, corr_frame_probe's group, the kernels
# it changes)
VARIANTS = {
    "g1": ("corr_frame_probe.cu", "constexpr int kGroup = 3;",
           "constexpr int kGroup = 1;", 1, ("corr_frame_probe",)),
    "g2": ("corr_frame_probe.cu", "constexpr int kGroup = 3;",
           "constexpr int kGroup = 2;", 2, ("corr_frame_probe",)),
    "nohint": ("window_probe.cuh", "cp_async16_l2_128(dst + c * 8,",
               "cp_async16(dst + c * 8,", probe_cuda.FRAME_GROUP,
               ("corr_band_ablate", "corr_frame_probe")),
    "contiguous": ("window_probe.cuh", "constexpr bool kStrided = kGroup == 1;",
                   "constexpr bool kStrided = false;", probe_cuda.FRAME_GROUP,
                   ("corr_band_ablate",)),
}


def variant_sources(name: str, dst: Path, sources=SOURCES,
                    variants=VARIANTS) -> Path:
    """Copies `sources` of this tree into dst with the edit of variant
    `name` of `variants` ({name: (file, text, its replacement, ...)}, or a
    tuple of texts and one of their replacements for an edit in several
    places), each text found exactly once in the tree's file. Returns dst."""
    file, old, new = variants[name][:3]
    dst.mkdir(parents=True, exist_ok=True)
    for src in sources:
        shutil.copy(corr_cuda.CSRC / src, dst / src)
    tree = text = (dst / file).read_text()
    edits = (old, new) if isinstance(old, tuple) else ((old,), (new,))
    for o, w in zip(*edits, strict=True):
        if tree.count(o) != 1:
            raise RuntimeError(f"variant {name}: {o!r} occurs {tree.count(o)} "
                               f"times in {file}, not once")
        text = text.replace(o, w)
    (dst / file).write_text(text)
    return dst


def _bind(lib):
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.devo_corr_band_ablate.argtypes = [ptr] * 9 + [i] * 6 + [ptr]
    lib.devo_corr_frame_probe.argtypes = [ptr] * 8 + [i] * 5 + [ptr] * 2
    lib.devo_corr_band_ablate.restype = ctypes.c_int
    lib.devo_corr_frame_probe.restype = ctypes.c_int
    return lib


def _ablate(lib, args, mode: str, plan):
    nlive, slot, band, y0, g, ry, rx, ring = args
    out = torch.empty((g.shape[0], 8, 16 * probe.PP), dtype=torch.float32,
                      device=g.device)
    code = lib.devo_corr_band_ablate(
        *(t.data_ptr() for t in (nlive, slot, band, y0, g, ry, rx, ring, out)),
        g.shape[0], ring.shape[1], ring.shape[2], *plan,
        probe.ABLATE_MODES.index(mode), torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"corr_band_ablate launch failed ({code})")
    return out


def _frame(lib, inputs, extract: bool, plan, order):
    fmap, gm = inputs[:2]
    out = torch.empty((gm.shape[0], 8 if extract else probe.WIN, 16 * probe.PP),
                      dtype=torch.float32, device=gm.device)
    code = lib.devo_corr_frame_probe(
        *(t.data_ptr() for t in inputs), order.data_ptr(), out.data_ptr(),
        gm.shape[0], fmap.shape[1], *plan, int(extract), None,
        torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"corr_frame_probe launch failed ({code})")
    return out


def in_turns(fns: dict, check, dev, iters: int, repeats: int) -> dict:
    """{name: [forward ms, backward ms]}: each of `fns` timed once in
    order, then once in reverse; check(name, output) first."""
    for name, fn in fns.items():
        check(name, fn())
    names = list(fns) + list(reversed(fns))
    times = {name: [] for name in fns}
    for name in names:
        times[name].append(common.median(common.median_ms(
            lambda i: fns[name](), dev, iters, repeats)))
    return times


def main(argv=None):
    p = common.parser(__doc__.split("\n\n")[0])
    p.add_argument("--variants", nargs="+", default=list(VARIANTS),
                   choices=list(VARIANTS))
    p.add_argument("--edges", type=int, default=15360)
    p.add_argument("--live", type=int, default=6144)
    p.add_argument("--layouts", nargs="+", default=["random", "sorted"],
                   choices=bench_banded_ablate.LAYOUTS)
    p.add_argument("--modes", nargs="+", default=["full", "nomm"],
                   choices=probe.ABLATE_MODES)
    p.add_argument("--iters", type=int, default=12,
                   help="back-to-back launches a repeat")
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    dev = common.device(args)
    if dev.type != "cuda":
        sys.exit("bench_window_variants builds and times CUDA kernels: it "
                 "needs the card")
    gpu = common.card(dev)
    tree = corr_cuda._load()
    root = corr_cuda.BUILD_DIR / "variants"
    with concurrent.futures.ThreadPoolExecutor(len(args.variants)) as pool:
        built = dict(zip(args.variants, pool.map(
            lambda v: corr_cuda.build(variant_sources(v, root / v)),
            args.variants)))
    libs = {name: _bind(ctypes.CDLL(str(path))) for name, path in built.items()}
    E = args.edges
    grid = probe_cuda.window_grid(E, dev)
    results = {}

    def same_bits(kernel, want, rows=None):
        def check(name, got):
            torch.cuda.synchronize()
            if not torch.equal(got[:rows], want[:rows]):
                raise RuntimeError(f"{kernel} variant {name}: not the tree's "
                                   f"bits")
        return check

    ring, g, ry, rx, lay = bench_banded_ablate.inputs(dev, E, 32, 22, 144)
    nlive = torch.tensor([args.live], dtype=torch.int32, device=dev)
    live = -(-args.live // probe.BE) * probe.BE
    plan = (grid, probe_cuda.window_plan()[0])
    mine = [v for v in args.variants if "corr_band_ablate" in VARIANTS[v][4]]
    for layout in args.layouts:
        case = (nlive, *lay[layout], g, ry, rx, ring)
        for mode in args.modes:
            fns = {"tree": lambda m=mode, c=case: _ablate(tree, c, m, plan)}
            fns.update({v: lambda v=v, m=mode, c=case: _ablate(libs[v], c, m, plan)
                        for v in mine})
            want = fns["tree"]()
            t = in_turns(fns, same_bits("corr_band_ablate", want, live), dev,
                         args.iters, args.repeats)
            results[("corr_band_ablate", layout, mode)] = t
            print(f"corr_band_ablate {layout} {mode}, ms in turns: " + "; ".join(
                f"{k} {a:.4f}, {b:.4f}" for k, (a, b) in t.items())
                + f" (each the tree's bits on {live} live rows) [{gpu}]",
                flush=True)
    del ring, g, ry, rx, lay, case

    frame = bench_gather.frame_inputs(np.random.default_rng(1), dev, E)
    fmap, _, y0, x08 = frame[:4]
    order = probe_cuda.frame_order(y0, x08, fmap.shape[1])
    own = torch.arange(E, dtype=torch.int32, device=dev)
    mine = [v for v in args.variants if "corr_frame_probe" in VARIANTS[v][4]]
    for extract in (True, False):
        fplan = (grid, probe_cuda.window_plan(group=probe_cuda.FRAME_GROUP)[0])
        fns = {"tree": lambda x=extract: _frame(tree, frame, x, fplan, order),
               "tree's wrapper": lambda x=extract: probe_cuda.frame_probe_cuda(
                   *frame, extract=x)}
        for v in mine:
            vplan = (grid, probe_cuda.window_plan(group=VARIANTS[v][3])[0])
            vorder = own if VARIANTS[v][3] == 1 else order
            fns[v] = (lambda v=v, x=extract, p=vplan, o=vorder:
                      _frame(libs[v], frame, x, p, o))
        want = fns["tree"]()
        t = in_turns(fns, same_bits("corr_frame_probe", want), dev, args.iters,
                     args.repeats)
        results[("corr_frame_probe", f"extract={extract}")] = t
        print(f"corr_frame_probe extract={extract}, ms in turns (each kernel "
              f"alone by its C interface; the tree's wrapper with its sort; "
              f"g1 on the edges' own order): " + "; ".join(
                  f"{k} {a:.4f}, {b:.4f}" for k, (a, b) in t.items())
              + f" (each the tree's bits) [{gpu}]", flush=True)
    return results


if __name__ == "__main__":
    main()
