"""The copy probe K14'' (csrc/copy_probe.cu) against variants of its design,
each built from a copy of this tree's sources with one edit (`ticket`'s in
several places), timed in turns at the probe driver's point.

    python -m devo_tpu_torch.scripts.bench_copy_variants [--variants NAME ...]

The variants (VARIANTS): `ticket`, the blocks claim positions of the
slot-major order from a global counter (one atomicAdd a copy) instead of
taking every G-th; `order_1`, the order's counting sort in one block
instead of a cluster of 8 (its order also timed alone, in turns with the
tree's, as device time under torch.profiler, on the `single` copies' slots); `unsorted`, the blocks stride over the copies
in their own (random) order, the sort still made but not read; `l2_128` and
`l2_256`, the cp.async route's copies with the L2 fetch hint of 128 / 256
bytes; `bulk2` and `bulk4`, the bulk route's window part in 2 / 4 bulk
copies instead of one; `fetch_late`, a block fetches the indices of its
next copy after the wait for the current one instead of before it;
`nopdl`, the copy and sum kernels launched only once the kernel before
them has ended (no programmatic dependent launch). Each must give this
tree's output exactly. Every mode of --modes runs on each copy route that
a variant changes, at one block an SM, every version by its C interface
(ops/probe_cuda.copy_launch, the sort of the copies included) on one draw
of the driver's random offsets. Times are medians of back-to-back launches
between CUDA events, in turns: every version once forward, then once
backward. The variants are built by nvcc into devo_tpu_torch/_build/, so
the script needs the card.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import sys

import numpy as np
import torch

from devo_tpu_torch.ops import corr_cuda, probe, probe_cuda
from devo_tpu_torch.scripts import bench_window_variants, common, probe_desc_wall

SOURCES = ("copy_probe.cu", "corr_common.cuh")
_HINT = ('asm volatile("cp.async.cg.shared.global.L2::{}B [%0], [%1], 16;\\n" '
         '::"r"(smem_addr(dst + s * part + ch * 16)), "l"(from + ch * 16) '
         ': "memory");')
_PIECES = ("for (int k = 0; k < {0}; ++k) bulk_copy(dst + s * part + k * (part "
           "/ {0}), source(src, s) + k * (part / {0}), part / {0}, bar);")
_CP = "cp_async16(dst + s * part + ch * 16, from + ch * 16);"
_BULK = "bulk_copy(dst + s * part, source(src, s), part, bar);"
# `ticket`'s edits, each text followed by its replacement: a global counter
# that the sum kernel puts back to 0, a block's claimed positions (thread 0
# claims copy i's position two barriers before its indices are fetched)
_TICKET = (
    "constexpr int kSumGroups = 8;",
    "__device__ int copy_ticket = 0;\nconstexpr int kSumGroups = 8;",
    "  __shared__ __align__(8) uint64_t bars[kMaxStages + 1];\n",
    "  __shared__ __align__(8) uint64_t bars[kMaxStages + 1];\n"
    "  __shared__ int claimed[kMaxStages + 2];\n",
    "    return static_cast<int>(blockIdx.x) + i * static_cast<int>(gridDim.x);\n"
    "  };\n",
    "    return claimed[i % (a.depth + 2)];\n  };\n  auto claim = [&](int i) {\n"
    "    if (tid == 0) claimed[i % (a.depth + 2)] = atomicAdd(&copy_ticket, 1);\n"
    "  };\n",
    "  wait_prerequisite();                       // the order is written\n",
    "  wait_prerequisite();\n  for (int k = 0; k <= a.depth; ++k) claim(k);\n",
    "    const Src next = fetch(i + a.depth);",
    "    claim(i + a.depth + 1);\n    const Src next = fetch(i + a.depth);",
    "    out[c] = s;\n",
    "    out[c] = s;\n    if (c == 0) copy_ticket = 0;\n",
)
# the variants that change the order's kernel, timed alone too
ORDER_VARIANTS = ("order_1",)
# name: (file, text, its replacement, the copy routes it changes); an edit in
# several places gives a tuple of texts and one of their replacements
VARIANTS = {
    "ticket": ("copy_probe.cu", _TICKET[0::2], _TICKET[1::2], probe_cuda.ROUTES),
    "order_1": ("copy_probe.cu", "constexpr int kOrderBlocks = 8;",
                "constexpr int kOrderBlocks = 1;", probe_cuda.ROUTES),
    "unsorted": ("copy_probe.cu",
                 "const int c = a.order ? __ldg(a.order + p) : p;",
                 "const int c = p;", probe_cuda.ROUTES),
    "l2_128": ("copy_probe.cu", _CP, _HINT.format(128), ("cp.async",)),
    "l2_256": ("copy_probe.cu", _CP, _HINT.format(256), ("cp.async",)),
    "bulk2": ("copy_probe.cu", _BULK, _PIECES.format(2), ("bulk",)),
    "bulk4": ("copy_probe.cu", _BULK, _PIECES.format(4), ("bulk",)),
    "fetch_late": ("copy_probe.cu",
                   "const Src next = fetch(i + a.depth);",
                   "#define next fetch(i + a.depth)\n", probe_cuda.ROUTES),
    "nopdl": ("copy_probe.cu",
              "attr[0].val.programmaticStreamSerializationAllowed = 1;",
              "attr[0].val.programmaticStreamSerializationAllowed = 0;",
              probe_cuda.ROUTES),
}
MODES = ("single", "pair", "tall4", "dual")


def variant_sources(name: str, dst):
    """This tree's SOURCES in dst with the edit of variant `name`."""
    return bench_window_variants.variant_sources(name, dst, SOURCES, VARIANTS)


def _order(lib, slot, mem: int):
    order = torch.empty_like(slot)
    code = lib.devo_copy_order(slot.data_ptr(), order.data_ptr(), slot.shape[0],
                               mem, probe_cuda._stream(slot))
    if code:
        raise RuntimeError(f"copy_order launch failed ({code})")
    return order


def _device_us(fn, launches: int = 20) -> float:
    """The device time of copy_order_kernel a call of fn, under
    torch.profiler over `launches` calls."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if "copy_order_kernel" in e.key) / launches


def _copy(lib, ring, slot, row0, mode: str, route: str, blocks: int):
    code, out = probe_cuda.copy_launch(lib, ring, slot, row0, mode, route,
                                       blocks)
    if code:
        raise RuntimeError(f"copy_probe launch failed ({code})")
    return out


def main(argv=None):
    p = common.parser(__doc__.split("\n\n")[0])
    p.add_argument("--variants", nargs="+", default=list(VARIANTS),
                   choices=list(VARIANTS))
    p.add_argument("--modes", nargs="+", default=list(MODES),
                   choices=[m for m in probe_desc_wall.MODES if m != "local"])
    p.add_argument("--nd", type=int, default=9600,
                   help="window-sized copies (about the live edges)")
    p.add_argument("--mem", type=int, default=32)
    p.add_argument("--iters", type=int, default=12,
                   help="back-to-back launches a repeat")
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    dev = common.device(args)
    if dev.type != "cuda":
        sys.exit("bench_copy_variants builds and times CUDA kernels: it needs "
                 "the card")
    gpu = common.card(dev)
    tree = corr_cuda._load()
    root = corr_cuda.BUILD_DIR / "copy_variants"
    with concurrent.futures.ThreadPoolExecutor(len(args.variants)) as pool:
        built = dict(zip(args.variants, pool.map(
            lambda v: corr_cuda.build(variant_sources(v, root / v)),
            args.variants)))
    libs = {}
    for name, path in built.items():
        lib = libs[name] = ctypes.CDLL(str(path))
        lib.devo_copy_probe.argtypes = tree.devo_copy_probe.argtypes
        lib.devo_copy_probe.restype = ctypes.c_int
        lib.devo_copy_order.argtypes = tree.devo_copy_order.argtypes
        lib.devo_copy_order.restype = ctypes.c_int
    rows = (probe.banded_shape(probe_desc_wall.H0, probe_desc_wall.W0)[0]
            * probe.BWIN)
    g = torch.Generator(device=dev).manual_seed(0)
    ring = torch.randint(-127, 127, (args.mem, rows, 128), generator=g,
                         device=dev, dtype=torch.int8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    results = {}
    for mode in args.modes:
        n = probe.copy_count(mode, args.nd)
        slot, row0 = probe_desc_wall.offsets(rng, mode, n, args.mem, rows, dev)
        case = (ring, slot, row0, mode)
        for route in probe_cuda.ROUTES:
            mine = [v for v in args.variants if route in VARIANTS[v][3]]
            if not mine:
                continue
            fns = {"tree": lambda r=route: _copy(tree, *case, r, sms)}
            fns.update({v: lambda v=v, r=route: _copy(libs[v], *case, r, sms)
                        for v in mine})
            want = fns["tree"]()

            def check(name, got, want=want, label=f"{mode} {route}"):
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"copy_probe [{label}] variant {name}: "
                                       f"not the tree's output")

            t = bench_window_variants.in_turns(fns, check, dev, args.iters,
                                               args.repeats)
            results[(mode, route)] = t
            print(f"copy_probe {mode} {route}, {n} copies at {sms} blocks, ms "
                  f"in turns: " + "; ".join(
                      f"{k} {a:.4f}, {b:.4f}" for k, (a, b) in t.items())
                  + f" (each the tree's exact output) [{gpu}]", flush=True)
    mine = [v for v in args.variants if v in ORDER_VARIANTS]
    if mine:    # profiled last: nothing is timed by events after a profile
        slot, _ = probe_desc_wall.offsets(np.random.default_rng(0), "single",
                                          args.nd, args.mem, rows, dev)
        fns = {"tree": lambda: _order(tree, slot, args.mem)}
        fns.update({v: lambda v=v: _order(libs[v], slot, args.mem) for v in mine})
        want = fns["tree"]()
        t = results["order"] = {name: [] for name in fns}
        for name in list(fns) + list(reversed(fns)):
            if not torch.equal(fns[name](), want):
                raise RuntimeError(f"copy_order variant {name}: not the tree's "
                                   f"order")
            t[name].append(_device_us(fns[name]))
        print(f"copy_order alone, {args.nd} copies over {args.mem} slots, device "
              f"us a launch under torch.profiler in turns: " + "; ".join(
                  f"{k} {a:.2f}, {b:.2f}" for k, (a, b) in t.items())
              + f" (each the tree's order) [{gpu}]", flush=True)
    return results


if __name__ == "__main__":
    main()
