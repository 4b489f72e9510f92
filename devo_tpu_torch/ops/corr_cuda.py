"""The engine's correlation entry point, and the bindings of the CUDA
kernels in csrc/.

`corr_pyramid` takes the plain PyTorch versions (ops/corr.py) for tensors on
the CPU and launches a kernel for tensors on a CUDA device; there is no
fallback from one to the other. Twelve correlation kernels, one launch
counter each (`launches`), chosen by `impl` (the engine's CORR_IMPL),
`kernel` (its CORR_KERNEL) and `resident`:

- "mono", `corr_pyramid_cuda` (csrc/corr.cu): both pyramid levels in one
  launch, blocks walking runs of edges behind a ring of staged windows (the
  edge pipeline, csrc/corr_pipe.cuh), the window products on the tensor
  cores (csrc/corr_mma.cuh) for bf16 patch features;
- "split", `corr_level_cuda` (csrc/corr_level.cu): one level per launch,
  the edge pipeline's one-level instance of "split2" under its own name;
- `resident`, `corr_level_resident_cuda` (csrc/corr_level_resident.cu): the
  last level of a per-level kernel from an int8 ring slot held, swizzled, in
  a block's shared memory, one warp an edge on the tensor cores, persistent
  blocks over the slot-sorted edges;
- "pair", `corr_pair_cuda` (csrc/corr_pair.cu): both levels in one launch,
  an instance of the edge pipeline in corr_pyramid's shape, schedule and
  plan;
- "pair2", `corr_pair2_cuda` (csrc/corr_pair2.cu): the same on the edge
  pipeline, by persistent blocks of 256 threads strided over the edges,
  several an SM, one barrier a step and the extraction one step behind the
  products;
- "split2", `corr_level_pipe_cuda` (csrc/corr_level_pipe.cu): one level per
  launch on the edge pipeline in corr_group8's shape and plan, every tap
  exact, on every ring type;
- "g8c", `corr_group_cuda` (csrc/corr_group.cu): one level per launch,
  every tap rounded once to bf16 before the ring slot's scale (the TPU's bf16
  product surface, kept in shared memory), on the edge pipeline of
  csrc/corr_pipe.cuh with K1's tensor-core products; its surface instance
  (`group_surface_cuda`, counter "corr_group_surface") writes the TPU
  kernel's own output and runs on no engine path;
- "mono2" / "mono4", `corr_mono2_cuda` (csrc/corr_mono2.cu): both levels in
  one launch on the same pipeline, a pair of edges a step, the pair's
  windows of a level gathered into one run of rows ("mono2") or read where
  the copies landed ("mono4");
- "mono3", `corr_mono3_cuda` (csrc/corr_mono3.cu): both levels in one launch
  on the edge pipeline, one pipeline of 512 threads a block walking a run of
  edges behind the deepest ring of stages that fits, two rotating product
  surfaces a level and one barrier a step;
- "g8", `corr_group8_cuda` (csrc/corr_group8.cu): one level per launch on
  the edge pipeline in corr_group's shape and plan, the f32 product surface
  kept in the block, every tap exact;
- "full", `corr_level_full_cuda` (csrc/corr_level_full.cu): one level per
  launch on the edge pipeline in corr_group8's shape and plan, whose ring
  depth and runs of edges may be set for tuning; its stage instances
  ("noext", "nomm", "noDMA") time the copy, the product and the extraction
  apart.

`impl` (the engine's CORR_IMPL) chooses the family: "banded" is the kernel
`kernel` names; "pallas" is `corr_fixed_cuda` (csrc/corr_fixed.cu), one
level per launch over a fixed 16x24 window an edge (its product on the tensor
cores for bf16 rings); "window" and "gather"
are tensor code on either device (ops/corr.corr_pyramid_window,
ops/corr.corr_pyramid_gather), with no kernel.

The probe kernels of the drivers in devo_tpu_torch/scripts/ are bound in
ops/probe_cuda.py, built into the same library and counted in `launches`.

All take float rings (bf16 or f32, the type of the patch features) or, with
per-slot scales, int8 rings; the resident kernel int8 only; "g8", "full" and
every family but "banded" float rings only. The sources are
compiled for sm_90a, one `nvcc` process each at the same time, and linked
into devo_tpu_torch/_build/ at first use (a shared library with a plain C
interface, loaded with ctypes), once per version of the sources.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import corr as plain

# launches of each kernel, counted so a run can show it went through them
launches = {"corr_pyramid": 0, "corr_level": 0, "corr_level_resident": 0,
            "corr_pair": 0, "corr_pair2": 0, "corr_level_pipe": 0,
            "corr_group": 0, "corr_mono2": 0, "corr_mono3": 0,
            # corr_group's surface instance, which no engine path launches
            "corr_group_surface": 0,
            "corr_fixed": 0, "corr_group8": 0, "corr_level_full": 0,
            # the probe kernels, launched by ops/probe_cuda.py
            "corr_band_ablate": 0, "copy_probe": 0, "corr_frame_probe": 0}

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_RADIUS = 3
_TAPS = (2 * _RADIUS + 2) ** 2          # integer taps of one pixel
_FEATS = (2 * _RADIUS + 1) ** 2         # blended offsets of one pixel
SMEM_MAX = 232_448            # the most a block can have on sm_90
LEVEL_WINDOW_CAP = 144        # feature vectors of a level's staged window
_PAIR_STATIC = 4096           # bound on the static shared memory of
                              #   corr_pair2 (its per-edge index tables)
_MONO3_STATIC = 6144          # the same of corr_mono3 (ten such tables)
_MONO_STATIC = 4096           # and of corr_pyramid, corr_pair, corr_group,
                              #   corr_group8, corr_level_pipe and
                              #   corr_level_full (six)
_MONO2_STATIC = 5120          # and of corr_mono2 (eight)
_SMEM_SM = 233_472            # shared memory of an SM on sm_90
_SMEM_RESERVED = 1024         # of which each resident block takes this much
MONO3_RUN = 64                # edges a corr_mono3 block walks
MONO3_MAX_DEPTH = 8           # stages of its window ring
PAIR2_DEPTH = 2               # stages of a corr_pair2 block
FULL_MAX_DEPTH = 4            # stages of corr_level_full's window ring
_FIXED_POSITIONS = 16 * 24    # corr_fixed's window
_FIXED_STAGES = 2             # chunk stages of its bf16 kernel's window
_FIXED_STATIC = 1024          # bound on its static shared memory
MONO_MAX_DEPTH = 4            # stages of corr_pyramid's window ring
_MMA_CHUNK = 32               # channels of a chunk of a tensor-core product
RESIDENT_CAP = 96             # window positions of corr_level_resident's
                              #   surface (six m-tiles)
RESIDENT_MAX_WARPS = 16       # warps of its block, at most
_RESIDENT_TABLE = 256         # bytes of a warp's pixel table
_lib = None


def reset_launches():
    for name in launches:
        launches[name] = 0


def sources(csrc: Path = CSRC):
    """The CUDA sources of `csrc`, headers included, in a fixed order."""
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build(csrc: Path = CSRC) -> Path:
    """Compile every .cu of `csrc` (the package's csrc/ unless given) for
    sm_90a into one library unless this version of the sources is built
    already: one `nvcc -c` per source, all started together, then one link.
    Returns the library's path; ptxas's register and shared memory report is
    kept beside it with the suffix .log."""
    digest = hashlib.sha256()
    for src in sources(csrc):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    lib = BUILD_DIR / f"libdevo_corr_{digest.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    nvcc = _nvcc()
    units = [s for s in sources(csrc) if s.suffix == ".cu"]
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in units]
    cmds = [[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xptxas=-v", "-Xcompiler", "-fPIC", "-c", "-o", str(obj),
             str(src)] for src, obj in zip(units, objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = BUILD_DIR / f"{tag}.tmp"
    try:
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{log}")
        cmd = [nvcc, "-shared", "-o", str(tmp)] + [str(o) for o in objects]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.devo_corr_pyramid.argtypes = ([ptr] * 9 + [i] * 8 + [f] * 2
                                          + [i] * 4 + [ptr])
        lib.devo_corr_pyramid_smem.argtypes = [i] * 6
        lib.devo_corr_pyramid_smem.restype = ctypes.c_longlong
        lib.devo_corr_pyramid_blocks_per_sm.argtypes = [i] * 6
        lib.devo_corr_fixed_smem.argtypes = [i] * 3
        lib.devo_corr_fixed_smem.restype = ctypes.c_longlong
        lib.devo_corr_fixed_blocks_per_sm.argtypes = [i] * 3
        lib.devo_corr_level.argtypes = [ptr] * 7 + [i] * 10 + [ptr]
        lib.devo_corr_level_smem.argtypes = [i] * 6
        lib.devo_corr_level_smem.restype = ctypes.c_longlong
        lib.devo_corr_level_blocks_per_sm.argtypes = [i] * 6
        lib.devo_corr_level_resident.argtypes = [ptr] * 9 + [i] * 9 + [ptr]
        lib.devo_corr_level_resident_smem.argtypes = [i] * 7
        lib.devo_corr_level_resident_smem.restype = ctypes.c_longlong
        lib.devo_corr_pair.argtypes = lib.devo_corr_pyramid.argtypes
        lib.devo_corr_pair_smem.argtypes = [i] * 6
        lib.devo_corr_pair_smem.restype = ctypes.c_longlong
        lib.devo_corr_pair_blocks_per_sm.argtypes = [i] * 6
        lib.devo_corr_pair2.argtypes = ([ptr] * 9 + [i] * 8 + [f] * 2
                                        + [i] * 4 + [ptr])
        lib.devo_corr_pair2_smem.argtypes = [i] * 6
        lib.devo_corr_pair2_smem.restype = ctypes.c_longlong
        lib.devo_corr_pair2_blocks_per_sm.argtypes = [i] * 6
        lib.devo_corr_group.argtypes = [ptr] * 7 + [i] * 10 + [ptr]
        lib.devo_corr_level_pipe.argtypes = lib.devo_corr_group.argtypes
        lib.devo_corr_level_pipe_smem.argtypes = [i] * 6
        lib.devo_corr_level_pipe_smem.restype = ctypes.c_longlong
        lib.devo_corr_level_pipe_blocks_per_sm.argtypes = [i] * 6
        lib.devo_corr_group_surface.argtypes = [ptr] * 6 + [i] * 11 + [ptr]
        lib.devo_corr_group_smem.argtypes = [i] * 6
        lib.devo_corr_group_smem.restype = ctypes.c_longlong
        lib.devo_corr_group_blocks_per_sm.argtypes = [i] * 6
        lib.devo_corr_mono2.argtypes = ([ptr] * 9 + [i] * 8 + [f] * 2
                                        + [i] * 6 + [ptr])
        lib.devo_corr_mono2_smem.argtypes = [i] * 7
        lib.devo_corr_mono2_smem.restype = ctypes.c_longlong
        lib.devo_corr_mono2_blocks_per_sm.argtypes = [i] * 7
        lib.devo_corr_mono3.argtypes = lib.devo_corr_pair2.argtypes
        lib.devo_corr_mono3_smem.argtypes = [i] * 6
        lib.devo_corr_mono3_smem.restype = ctypes.c_longlong
        lib.devo_corr_mono3_blocks_per_sm.argtypes = [i] * 6
        lib.devo_corr_fixed.argtypes = [ptr] * 6 + [i] * 6 + [ptr]
        lib.devo_corr_group8.argtypes = [ptr] * 6 + [i] * 9 + [ptr]
        lib.devo_corr_group8_smem.argtypes = [i] * 5
        lib.devo_corr_group8_smem.restype = ctypes.c_longlong
        lib.devo_corr_group8_blocks_per_sm.argtypes = [i] * 6
        lib.devo_corr_level_full.argtypes = [ptr] * 6 + [i] * 10 + [ptr]
        lib.devo_corr_level_full_smem.argtypes = [i] * 5
        lib.devo_corr_level_full_smem.restype = ctypes.c_longlong
        lib.devo_corr_level_full_blocks_per_sm.argtypes = [i] * 6
        lib.devo_corr_band_ablate.argtypes = [ptr] * 9 + [i] * 6 + [ptr]
        lib.devo_corr_band_ablate_smem.argtypes = [i]
        lib.devo_corr_band_ablate_smem.restype = ctypes.c_longlong
        lib.devo_corr_band_ablate_blocks_per_sm.argtypes = [i] * 2
        lib.devo_corr_frame_probe.argtypes = [ptr] * 8 + [i] * 5 + [ptr] * 2
        lib.devo_corr_frame_probe_smem.argtypes = [i]
        lib.devo_corr_frame_probe_smem.restype = ctypes.c_longlong
        lib.devo_corr_frame_probe_blocks_per_sm.argtypes = [i] * 2
        lib.devo_copy_probe.argtypes = ([ptr] * 6 + [ctypes.c_longlong]
                                        + [i] * 10 + [ptr])
        lib.devo_copy_order.argtypes = [ptr] * 2 + [i] * 2 + [ptr]
        for fn in (lib.devo_corr_fixed, lib.devo_corr_group8,
                   lib.devo_corr_group8_blocks_per_sm,
                   lib.devo_corr_pair_blocks_per_sm,
                   lib.devo_corr_level_full,
                   lib.devo_corr_level_full_blocks_per_sm, lib.devo_corr_pyramid,
                   lib.devo_corr_pyramid_blocks_per_sm,
                   lib.devo_corr_fixed_blocks_per_sm,
                   lib.devo_corr_level, lib.devo_corr_level_blocks_per_sm,
                   lib.devo_corr_level_resident, lib.devo_corr_pair,
                   lib.devo_corr_pair2, lib.devo_corr_pair2_blocks_per_sm,
                   lib.devo_corr_level_pipe,
                   lib.devo_corr_level_pipe_blocks_per_sm,
                   lib.devo_corr_group, lib.devo_corr_group_surface,
                   lib.devo_corr_group_blocks_per_sm, lib.devo_corr_mono2,
                   lib.devo_corr_mono2_blocks_per_sm,
                   lib.devo_corr_mono3, lib.devo_corr_mono3_blocks_per_sm,
                   lib.devo_corr_band_ablate,
                   lib.devo_corr_band_ablate_blocks_per_sm,
                   lib.devo_corr_frame_probe,
                   lib.devo_corr_frame_probe_blocks_per_sm, lib.devo_copy_probe,
                   lib.devo_copy_order):
            fn.restype = ctypes.c_int
        lib.devo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.devo_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"corr kernel: {msg}")


def _launched(name: str, code: int):
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_lib.devo_cuda_error_string(code).decode()}")
    launches[name] += 1


def _occupancy(name: str, occ: int) -> int:
    """The result of a kernel's occupancy query: blocks an SM, or raise on
    the error it returned (as minus the cudaError_t)."""
    if occ < 0:
        raise RuntimeError(f"{name} occupancy query failed: "
                           f"{_lib.devo_cuda_error_string(-occ).decode()}")
    return occ


def _check_call(gmap, rings, scales, coords, kk, jj):
    """What every kernel asks of its arguments. Returns (E, P, C, i8)."""
    dev = gmap.device
    tensors = dict(gmap=gmap, coords=coords, kk=kk, jj=jj)
    tensors.update({f"fmap{n + 1}": r for n, r in enumerate(rings)})
    tensors.update({f"scale{n + 1}": s for n, s in enumerate(scales)
                    if s is not None})
    for name, t in tensors.items():
        _check(t.is_cuda and t.device == dev, f"{name} is not on {dev}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
    _check(gmap.dtype in (torch.bfloat16, torch.float32),
           f"patch features must be bf16 or f32, got {gmap.dtype}")
    _check(gmap.ndim == 4 and gmap.shape[1] == gmap.shape[2],
           f"gmap must be (M, P, P, C), got {tuple(gmap.shape)}")
    _, P, _, C = gmap.shape
    E = coords.shape[0]
    i8 = rings[0].dtype == torch.int8
    mem = rings[0].shape[0]
    for ring, scale in zip(rings, scales):
        _check(ring.dtype == (torch.int8 if i8 else gmap.dtype),
               "the rings must be all int8 or all of gmap's dtype")
        _check(ring.ndim == 4 and ring.shape[-1] == C and ring.shape[0] == mem,
               "rings must be (mem, h, w, C) with gmap's C")
        _check(ring.data_ptr() % 16 == 0, "a ring is not 16-byte aligned")
        _check((scale is not None) == i8,
               "an int8 ring, and only an int8 ring, takes a scale")
        if i8:
            _check(scale.dtype == torch.float32
                   and tuple(scale.shape) == (mem,),
                   f"a ring's scale must be ({mem},) f32")
    _check(coords.dtype == torch.float32, "coords must be f32")
    _check(kk.dtype == torch.int32 and jj.dtype == torch.int32,
           "kk and jj must be int32")
    _check(tuple(coords.shape) == (E, P, P, 2),
           f"coords must be ({E}, {P}, {P}, 2), got {tuple(coords.shape)}")
    _check(tuple(kk.shape) == (E,) and tuple(jj.shape) == (E,),
           "kk and jj must be (E,)")
    _check(C % 4 == 0, f"C must be a multiple of 4, got {C}")
    return E, P, C, i8


def _ptr(t):
    return None if t is None else t.data_ptr()


def _item(dtype) -> int:
    return dtype.itemsize


def _staged_call(name, smem, static, cap, extra, gmap, rings, coords, kk, jj,
                 levels, scales):
    """The checks, the output and the launch that the kernels with windows
    staged by asynchronous copies share. `name`: the launch counter, and
    devo_<name> the C function; `smem`: the block's dynamic shared memory at
    window size `cap`; `extra`: the integers the C function takes after the
    type flags, or a function of E that gives them once the arguments have
    passed the checks (an occupancy query); `rings`: one ring (a per-level
    kernel, which takes no level strides) or two, as many as the output has
    levels."""
    two = len(rings) == 2
    scales = (None,) * len(rings) if scales is None else tuple(scales)
    _check(len(levels) == len(rings) == len(scales),
           f"the kernel computes {len(rings)} level(s)")
    E, P, C, i8 = _check_call(gmap, rings, scales, coords, kk, jj)
    _check(P * P <= 16, f"P={P}: the kernel's index table holds 16 pixels")
    for t_name, t in (("gmap", gmap), ("coords", coords)):
        _check(t.data_ptr() % 16 == 0, f"{t_name} is not 16-byte aligned")
    _check(smem <= SMEM_MAX - static,
           f"P={P}, C={C} needs more shared memory than a block can have")

    out = torch.empty((E, len(rings) * _FEATS * P * P), dtype=torch.float32,
                      device=gmap.device)
    if E == 0:
        return out
    lib = _load()
    if callable(extra):
        extra = extra(E)
    sizes = [x for r in rings for x in r.shape[1:3]]
    code = getattr(lib, "devo_" + name)(
        gmap.data_ptr(), *(r.data_ptr() for r in rings),
        *(_ptr(sc) for sc in scales), coords.data_ptr(), kk.data_ptr(),
        jj.data_ptr(), out.data_ptr(), E, P * P, C, *sizes, cap,
        *((float(levels[0]), float(levels[1])) if two else ()),
        int(gmap.dtype == torch.bfloat16), int(i8), *extra,
        torch.cuda.current_stream(gmap.device).cuda_stream)
    _launched(name, code)
    return out


def _patch_shape(gmap):
    """(P, C) of the patch features, for the shared memory plan that precedes
    the other checks."""
    _check(gmap.ndim == 4, f"gmap must be (M, P, P, C), got {tuple(gmap.shape)}")
    return gmap.shape[1], gmap.shape[3]


def _padded(C: int, ring_dtype) -> int:
    """Bytes between the vectors of a window that is read position by
    position (corr_mono3, corr_group): 16 more than a vector, so that the
    lanes' 16-byte reads fall into different banks."""
    return C * _item(ring_dtype) + 16


def _mma_stride(C: int) -> int:
    """Elements between two rows of an operand staged for the tensor cores
    (csrc/corr_mma.cuh, mma_stride): C rounded up to chunks of 32 channels,
    and one chunk more where their number is even."""
    chans = -(-C // _MMA_CHUNK) * _MMA_CHUNK
    return chans if chans // _MMA_CHUNK % 2 else chans + _MMA_CHUNK


def _surface_row(P: int) -> int:
    """Floats of a row of a product surface: a column per pixel, rounded up
    to even."""
    return P * P + P * P % 2


def _stage_bytes(P: int, C: int, gmap_dtype, ring_dtype, cap: int,
                 levels: int) -> int:
    """Bytes of one edge in a stage of the edge pipeline (csrc/corr_pipe.cuh,
    PipeLayout): the patch feature, rounded up to 16 bytes, and `levels`
    windows of `cap` vectors. bf16 patch features stage rows for the tensor
    cores (_mma_stride); f32 ones the plain patch feature and padded
    vectors."""
    PP = P * P
    if gmap_dtype == torch.bfloat16:
        graw = PP * _mma_stride(C) * 2
        vector = _mma_stride(C) * _item(ring_dtype)
    else:
        graw, vector = PP * C * 4, _padded(C, ring_dtype)
    return -(-graw // 16) * 16 + levels * cap * vector


def _slot_bytes(P: int, cap: int) -> int:
    """Bytes of a surface slot of the edge pipeline: f32 rows of `cap`
    window positions, or a level's taps where that is more."""
    return 4 * max(cap * _surface_row(P), P * P * _TAPS)


def _window_cap(fits, mma: bool) -> int:
    """The largest window, at most LEVEL_WINDOW_CAP vectors (in whole
    m-tiles of 16 positions for the tensor cores), for which fits(cap)
    holds; 0 where none does."""
    return next((cap for cap in range(LEVEL_WINDOW_CAP, 0, -16 if mma else -1)
                 if fits(cap)), 0)


def _pipe_checks(P: int, C: int, gmap_dtype, ring_dtype) -> bool:
    """What the edge pipeline's kernels ask of the shapes (raises
    ValueError otherwise). Returns whether a window is staged at all: bf16
    patch features always; f32 ones only where a ring's vector is a whole
    number of 16-byte copies."""
    _check(P * P <= 16, f"P={P}: the kernel's index table holds 16 pixels")
    _check(C % 4 == 0, f"C must be a multiple of 4, got {C}")
    return gmap_dtype == torch.bfloat16 or C * _item(ring_dtype) % 16 == 0


def mono_smem_bytes(P: int, C: int, gmap_dtype, ring_dtype, cap: int,
                    depth: int) -> int:
    """Dynamic shared memory of a corr_pyramid block (csrc/corr.cu on the
    edge pipeline): `depth` stages, each the patch feature and both levels'
    windows of `cap` vectors (_stage_bytes), then four surface slots (two
    halves of the block x two levels)."""
    return (depth * _stage_bytes(P, C, gmap_dtype, ring_dtype, cap, 2)
            + 4 * _slot_bytes(P, cap))


@functools.lru_cache(maxsize=None)
def mono_plan(P: int, C: int, gmap_dtype, ring_dtype):
    """(cap, depth, blocks an SM) of corr_pyramid, whose block of 512 threads
    (two halves, each its own pipeline of edges with depth / 2 stages) takes
    an SM to itself: windows as large as a ring of two stages allows, at
    most LEVEL_WINDOW_CAP vectors (in whole m-tiles of 16 positions for bf16
    patch features), then four stages where they fit. f32 patch features on
    a ring whose vector is no multiple of 16 bytes stage nothing (cap = 0:
    every tap reads the ring). Raises ValueError on what the kernel does
    not take. Worked out once a shape, as mono3_plan."""
    stageable = _pipe_checks(P, C, gmap_dtype, ring_dtype)
    mma = gmap_dtype == torch.bfloat16
    room = SMEM_MAX - _MONO_STATIC

    def smem(cap, depth):
        return mono_smem_bytes(P, C, gmap_dtype, ring_dtype, cap, depth)

    cap = _window_cap(lambda cap: smem(cap, 2) <= room, mma) if stageable else 0
    _check(smem(cap, 2) <= room,
           f"P={P}, C={C} needs more shared memory than a block can have")
    depth = MONO_MAX_DEPTH if smem(cap, MONO_MAX_DEPTH) <= room else 2
    return cap, depth, 1


def mono_run(E: int, device) -> int:
    """Consecutive edges a corr_pyramid block walks: the E edges spread over
    one round of blocks, one on every SM of `device`."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, -(-E // sms))


def corr_pyramid_cuda(gmap, fmap1, fmap2, coords, kk, jj, levels=(1, 4),
                      scales=None) -> torch.Tensor:
    """Launch csrc/corr.cu: gmap (Mring, P, P, C) bf16 or f32; fmap1
    (mem, h1, w1, C) and fmap2 (mem, h2, w2, C) of gmap's dtype, or int8
    with scales = (scale1, scale2), each (mem,) f32; coords (E, P, P, 2) f32
    at level-1 resolution; kk, jj (E,) int32 ring indices. Returns
    (E, 2*49*P*P) f32 in [dx, dy, pixel, level] order; the plain version is
    ops/corr.corr_pyramid."""
    P, C = _patch_shape(gmap)
    cap, depth, _ = mono_plan(P, C, gmap.dtype, fmap1.dtype)
    run = mono_run(coords.shape[0], gmap.device) if gmap.is_cuda else 1
    return _staged_call(
        "corr_pyramid",
        mono_smem_bytes(P, C, gmap.dtype, fmap1.dtype, cap, depth),
        _MONO_STATIC, cap, (depth, run), gmap, (fmap1, fmap2), coords, kk, jj,
        levels, scales)


def _blocks_per_sm(kernel: str, plan) -> int:
    """Blocks of `kernel` (a launch counter's name, its C entry point
    devo_<kernel>_blocks_per_sm) that one SM of the current CUDA device
    holds at a time at the sizes of `plan`, (P, C, gmap dtype, ring dtype,
    cap, depth): shared memory and registers."""
    P, C, gmap_dtype, ring_dtype, cap, depth = plan
    query = getattr(_load(), f"devo_{kernel}_blocks_per_sm")
    return _occupancy(kernel, query(P * P, C, cap, depth,
                                    int(gmap_dtype == torch.bfloat16),
                                    int(ring_dtype == torch.int8)))


def mono_blocks_per_sm(P: int, C: int, gmap_dtype, ring_dtype,
                       kernel: str = "corr_pyramid") -> int:
    """Blocks of corr_pyramid's kernel, or of corr_pair's (`kernel`), that
    one SM of the current CUDA device holds at a time at mono_plan's
    sizes."""
    cap, depth, _ = mono_plan(P, C, gmap_dtype, ring_dtype)
    return _blocks_per_sm(kernel, (P, C, gmap_dtype, ring_dtype, cap, depth))


def corr_pair_cuda(gmap, fmap1, fmap2, coords, kk, jj, levels=(1, 4),
                   scales=None) -> torch.Tensor:
    """Launch csrc/corr_pair.cu, corr_pyramid's instance of the edge
    pipeline under its own name, at mono_plan and mono_run. Arguments and
    result as `corr_pyramid_cuda`; the plain version is
    ops/corr.corr_pyramid."""
    P, C = _patch_shape(gmap)
    cap, depth, _ = mono_plan(P, C, gmap.dtype, fmap1.dtype)
    run = mono_run(coords.shape[0], gmap.device) if gmap.is_cuda else 1
    return _staged_call(
        "corr_pair", mono_smem_bytes(P, C, gmap.dtype, fmap1.dtype, cap, depth),
        _MONO_STATIC, cap, (depth, run), gmap, (fmap1, fmap2), coords, kk, jj,
        levels, scales)


MONO2_PIPES_CAP = 128         # windows below which corr_mono2 keeps one
                              #   pipeline a block


def mono2_smem_bytes(P: int, C: int, gmap_dtype, ring_dtype, cap: int,
                     depth: int, pipes: int) -> int:
    """Dynamic shared memory of a corr_mono2 block (csrc/corr_mono2.cu on the
    edge pipeline, a pair of edges a step): `depth` stages, each two edges'
    patch features and both levels' windows of `cap` vectors (_stage_bytes),
    then four surface slots (two edges x two levels) for each of the block's
    `pipes` pipelines. "mono2"'s gather moves rows inside a stage: both
    variants take the same."""
    return (depth * 2 * _stage_bytes(P, C, gmap_dtype, ring_dtype, cap, 2)
            + pipes * 4 * _slot_bytes(P, cap))


def mono2_plan(P: int, C: int, gmap_dtype, ring_dtype):
    """(cap, depth, pipelines a block) of corr_mono2, one block of 512
    threads an SM: bf16 patch features on int8 rings take two pipelines of
    one stage each where windows of MONO2_PIPES_CAP vectors fit them; every
    other pair one pipeline with windows as large as one stage allows (at
    most LEVEL_WINDOW_CAP, whole m-tiles for bf16 patch features), then two
    stages where they fit. Raises ValueError on what the kernel does not
    take."""
    stageable = _pipe_checks(P, C, gmap_dtype, ring_dtype)
    mma = gmap_dtype == torch.bfloat16
    room = SMEM_MAX - _MONO2_STATIC

    def smem(cap, depth, pipes):
        return mono2_smem_bytes(P, C, gmap_dtype, ring_dtype, cap, depth, pipes)

    if mma and ring_dtype == torch.int8:
        cap = _window_cap(lambda cap: smem(cap, 2, 2) <= room, True)
        if cap >= MONO2_PIPES_CAP:
            return cap, 2, 2
    cap = _window_cap(lambda cap: smem(cap, 1, 1) <= room, mma) if stageable else 0
    _check(smem(cap, 1, 1) <= room,
           f"P={P}, C={C} needs more shared memory than a block can have")
    return cap, 2 if smem(cap, 2, 1) <= room else 1, 1


def mono2_run(E: int, device) -> int:
    """Consecutive edges a corr_mono2 block walks: the E edges spread over
    one round of blocks, one on every SM of `device`, in whole pairs."""
    run = mono_run(E, device)
    return run + run % 2


def corr_mono2_cuda(gmap, fmap1, fmap2, coords, kk, jj, levels=(1, 4),
                    scales=None, concat: bool = True) -> torch.Tensor:
    """Launch csrc/corr_mono2.cu: both levels, a pair of edges a pipeline
    step. `concat`: gather each pair's windows of a level into one run of
    rows before its products (CORR_KERNEL="mono2"), or read them where the
    copies landed ("mono4"). Arguments and result otherwise as
    `corr_pyramid_cuda`; the plain version is ops/corr.corr_pyramid."""
    P, C = _patch_shape(gmap)
    cap, depth, pipes = mono2_plan(P, C, gmap.dtype, fmap1.dtype)
    run = mono2_run(coords.shape[0], gmap.device) if gmap.is_cuda else 2
    return _staged_call(
        "corr_mono2",
        mono2_smem_bytes(P, C, gmap.dtype, fmap1.dtype, cap, depth, pipes),
        _MONO2_STATIC, cap, (int(concat), depth, pipes, run), gmap,
        (fmap1, fmap2), coords, kk, jj, levels, scales)


def mono2_blocks_per_sm(P: int, C: int, gmap_dtype, ring_dtype) -> int:
    """Blocks of corr_mono2's kernel that one SM of the current CUDA device
    holds at a time at mono2_plan's sizes (shared memory and registers)."""
    cap, depth, pipes = mono2_plan(P, C, gmap_dtype, ring_dtype)
    return _occupancy("corr_mono2", _load().devo_corr_mono2_blocks_per_sm(
        P * P, C, cap, depth, pipes, int(gmap_dtype == torch.bfloat16),
        int(ring_dtype == torch.int8)))


def _sms(device) -> int:
    """Streaming multiprocessors of the CUDA device `device`."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def mono3_smem_bytes(P: int, C: int, gmap_dtype, ring_dtype, cap: int,
                     depth: int) -> int:
    """Dynamic shared memory of a corr_mono3 block (csrc/corr_mono3.cu on the
    edge pipeline, one pipeline): `depth` stages, each the patch feature and
    both levels' windows of `cap` vectors (_stage_bytes), then four surface
    slots (two rotating slots x two levels)."""
    return (depth * _stage_bytes(P, C, gmap_dtype, ring_dtype, cap, 2)
            + 4 * _slot_bytes(P, cap))


@functools.lru_cache(maxsize=None)
def mono3_plan(P: int, C: int, gmap_dtype, ring_dtype):
    """(cap, depth) of corr_mono3, one block of 512 threads an SM: windows as
    large as a ring of two stages allows (at most LEVEL_WINDOW_CAP vectors,
    whole m-tiles of 16 positions for bf16 patch features; 0 where nothing
    is staged, as mono_plan), then the deepest ring, at most MONO3_MAX_DEPTH
    stages, that fits. Raises ValueError on what the kernel does not take.
    Worked out once a shape: the search over window sizes for f32 patch
    features cost the wrapper more host time than its kernel takes at small
    E."""
    stageable = _pipe_checks(P, C, gmap_dtype, ring_dtype)
    mma = gmap_dtype == torch.bfloat16
    room = SMEM_MAX - _MONO3_STATIC

    def smem(cap, depth):
        return mono3_smem_bytes(P, C, gmap_dtype, ring_dtype, cap, depth)

    cap = _window_cap(lambda cap: smem(cap, 2) <= room, mma) if stageable else 0
    _check(smem(cap, 2) <= room,
           f"P={P}, C={C} needs more shared memory than a block can have")
    depth = max(d for d in range(2, MONO3_MAX_DEPTH + 1)
                if smem(cap, d) <= room)
    return cap, depth


def mono3_run(E: int, sms: int) -> int:
    """Consecutive edges a corr_mono3 block walks on a device of `sms` SMs:
    at most MONO3_RUN, and such that the runs come to a whole number of
    rounds over the SMs (a block takes an SM to itself): E edges in k
    rounds of one run an SM, with the least k that keeps a run within
    MONO3_RUN. Block b takes edges b * run .. b * run + run - 1."""
    rounds = max(1, -(-E // (sms * MONO3_RUN)))
    return max(1, -(-E // (sms * rounds)))


def corr_mono3_cuda(gmap, fmap1, fmap2, coords, kk, jj, levels=(1, 4),
                    scales=None) -> torch.Tensor:
    """Launch csrc/corr_mono3.cu: both levels, one pipeline a block with two
    rotating product surfaces a level. Arguments and result as
    `corr_pyramid_cuda`; the plain version is ops/corr.corr_pyramid."""
    P, C = _patch_shape(gmap)
    cap, depth = mono3_plan(P, C, gmap.dtype, fmap1.dtype)
    run = mono3_run(coords.shape[0], _sms(gmap.device)) if gmap.is_cuda else 1
    return _staged_call(
        "corr_mono3",
        mono3_smem_bytes(P, C, gmap.dtype, fmap1.dtype, cap, depth),
        _MONO3_STATIC, cap, (depth, run), gmap, (fmap1, fmap2), coords, kk, jj,
        levels, scales)


def mono3_blocks_per_sm(P: int, C: int, gmap_dtype, ring_dtype) -> int:
    """Blocks of corr_mono3's kernel that one SM of the current CUDA device
    holds at a time at mono3_plan's sizes (shared memory and registers)."""
    cap, depth = mono3_plan(P, C, gmap_dtype, ring_dtype)
    return _occupancy("corr_mono3", _load().devo_corr_mono3_blocks_per_sm(
        P * P, C, cap, depth, int(gmap_dtype == torch.bfloat16),
        int(ring_dtype == torch.int8)))


def pair2_smem_bytes(P: int, C: int, gmap_dtype, ring_dtype, cap: int,
                     depth: int) -> int:
    """Dynamic shared memory of a corr_pair2 block (csrc/corr_pair2.cu on the
    edge pipeline, one pipeline): the layout of corr_mono3's block."""
    return mono3_smem_bytes(P, C, gmap_dtype, ring_dtype, cap, depth)


@functools.lru_cache(maxsize=None)
def pair2_plan(P: int, C: int, gmap_dtype, ring_dtype):
    """(cap, depth, blocks an SM) of corr_pair2, whose blocks of 256 threads
    hold one pipeline of PAIR2_DEPTH stages: two blocks an SM where half an
    SM holds full windows (LEVEL_WINDOW_CAP vectors) or the ring stages
    nothing, else one block with windows as large as a block allows (whole
    m-tiles for bf16 patch features). Smaller windows for a second block
    lost: at C = 128 on int8 rings, two blocks of windows of 128 vectors
    took 0.58-0.60 ms at E = 12288 against one block of 144's 0.38-0.40
    (chip_smoke.py's "structures" lines, PERF.md), the windows beyond 128
    reading the ring. Raises ValueError on what the kernel does not take.
    Worked out once a shape, as mono3_plan."""
    stageable = _pipe_checks(P, C, gmap_dtype, ring_dtype)
    mma = gmap_dtype == torch.bfloat16

    def smem(cap):
        return pair2_smem_bytes(P, C, gmap_dtype, ring_dtype, cap, PAIR2_DEPTH)

    for blocks in (2, 1):
        room = (_SMEM_SM // 2 - _SMEM_RESERVED if blocks == 2
                else SMEM_MAX) - _PAIR_STATIC
        cap = (_window_cap(lambda cap: smem(cap) <= room, mma)
               if stageable else 0)
        if cap == (LEVEL_WINDOW_CAP if stageable else 0):
            break
    _check(smem(cap) <= room,
           f"P={P}, C={C} needs more shared memory than a block can have")
    return cap, PAIR2_DEPTH, blocks


def pair2_grid(E: int, sms: int, blocks: int) -> int:
    """Blocks of corr_pair2's persistent grid on a device of `sms` SMs that
    hold `blocks` each: as many as the SMs hold at once, at most E. Block b
    takes edges b, b + grid, b + 2 grid, ..."""
    return min(E, sms * blocks)


def corr_pair2_cuda(gmap, fmap1, fmap2, coords, kk, jj, levels=(1, 4),
                    scales=None) -> torch.Tensor:
    """Launch csrc/corr_pair2.cu: both levels, persistent blocks of one
    pipeline strided over the edges, as many an SM as the occupancy query
    gives. Arguments and result as `corr_pyramid_cuda`; the plain version is
    ops/corr.corr_pyramid."""
    P, C = _patch_shape(gmap)
    cap, depth, _ = pair2_plan(P, C, gmap.dtype, fmap1.dtype)

    def extra(E):
        blocks = pair2_blocks_per_sm(P, C, gmap.dtype, fmap1.dtype)
        return depth, pair2_grid(E, _sms(gmap.device), blocks)

    return _staged_call(
        "corr_pair2",
        pair2_smem_bytes(P, C, gmap.dtype, fmap1.dtype, cap, depth),
        _PAIR_STATIC, cap, extra, gmap, (fmap1, fmap2), coords, kk, jj, levels,
        scales)


def pair2_blocks_per_sm(P: int, C: int, gmap_dtype, ring_dtype) -> int:
    """Blocks of corr_pair2's kernel that one SM of the current CUDA device
    holds at a time at pair2_plan's sizes (the kernel's grid is that times
    the number of SMs, at most E). Asked once a device and shape: asked on
    every launch, the query of the f32 instance made those launches
    host-bound at small E (PERF.md)."""
    return _pair2_blocks(torch.cuda.current_device(), P, C, gmap_dtype,
                         ring_dtype)


@functools.lru_cache(maxsize=None)
def _pair2_blocks(device: int, P: int, C: int, gmap_dtype, ring_dtype) -> int:
    cap, depth, _ = pair2_plan(P, C, gmap_dtype, ring_dtype)
    return _occupancy("corr_pair2", _load().devo_corr_pair2_blocks_per_sm(
        P * P, C, cap, depth, int(gmap_dtype == torch.bfloat16),
        int(ring_dtype == torch.int8)))


def group_smem_bytes(P: int, C: int, gmap_dtype, ring_dtype, cap: int,
                     depth: int) -> int:
    """Dynamic shared memory of a corr_group block (csrc/corr_group.cu on the
    edge pipeline, two pipelines a block): `depth` stages, each the patch
    feature and one level's window of `cap` vectors (_stage_bytes), then
    two surface slots (one a pipeline)."""
    return (depth * _stage_bytes(P, C, gmap_dtype, ring_dtype, cap, 1)
            + 2 * _slot_bytes(P, cap))


@functools.lru_cache(maxsize=None)
def group_plan(P: int, C: int, gmap_dtype, ring_dtype):
    """(cap, depth, blocks an SM) of corr_group, whose block of 512 threads
    holds two pipelines of edges: two blocks an SM where half its shared
    memory holds a ring of two stages of full windows (LEVEL_WINDOW_CAP
    vectors) or the ring stages nothing, else one block with windows as
    large as two stages allow; then four stages where they fit that share.
    Raises ValueError on what the kernel does not take. Worked out once a
    shape, as mono3_plan."""
    stageable = _pipe_checks(P, C, gmap_dtype, ring_dtype)
    mma = gmap_dtype == torch.bfloat16

    def smem(cap, depth):
        return group_smem_bytes(P, C, gmap_dtype, ring_dtype, cap, depth)

    for blocks in (2, 1):
        room = (_SMEM_SM // 2 - _SMEM_RESERVED if blocks == 2
                else SMEM_MAX) - _MONO_STATIC
        cap = (_window_cap(lambda cap: smem(cap, 2) <= room, mma)
               if stageable else 0)
        if cap == (LEVEL_WINDOW_CAP if stageable else 0):
            break
    _check(smem(cap, 2) <= room,
           f"P={P}, C={C} needs more shared memory than a block can have")
    depth = 4 if smem(cap, 4) <= room else 2
    return cap, depth, blocks


def group_run(E: int, device, blocks: int) -> int:
    """Consecutive edges a corr_group block walks: the E edges spread over
    one round of blocks, `blocks` on every SM of `device`."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, -(-E // (sms * blocks)))


def _group_call(name, gmap, fmap, coords, kk, jj, scale):
    """One launch of the one-level kernel devo_<name> that takes the ring
    slots' scales at group_plan and group_run (corr_group,
    corr_level_pipe, corr_level)."""
    P, C = _patch_shape(gmap)
    cap, depth, blocks = group_plan(P, C, gmap.dtype, fmap.dtype)
    run = group_run(coords.shape[0], gmap.device, blocks) if gmap.is_cuda else 1
    return _staged_call(
        name, group_smem_bytes(P, C, gmap.dtype, fmap.dtype, cap, depth),
        _MONO_STATIC, cap, (depth, run), gmap, (fmap,), coords, kk, jj, (1,),
        (scale,))


def corr_group_cuda(gmap, fmap, coords, kk, jj, scale=None) -> torch.Tensor:
    """Launch csrc/corr_group.cu, one pyramid level through the bf16 product
    surface in one launch (CORR_KERNEL="g8c"): every tap rounded once to
    bf16 before the ring slot's scale and the blend. Arguments and result as
    `corr_level_cuda`; the plain version is ops/corr.corr_level_group."""
    return _group_call("corr_group", gmap, fmap, coords, kk, jj, scale)


def group_surface_cuda(gmap, fmap, coords, kk, jj, scale=None):
    """Launch the surface instance of csrc/corr_group.cu, which writes the
    TPU kernel's own output and which no engine path launches. Arguments as
    `corr_group_cuda` (the scale is checked and not applied). Returns
    (surface, cap): the raw product surface (ceil(E / 8), GROUP_ROWS, 128)
    bf16, zero where the kernel writes nothing, and the window capacity it
    was written with; the plain version is ops/corr.group_surface(..., cap)
    on the rows the kernel writes (an edge's window positions, or its 64
    taps where the window exceeds cap)."""
    E, P, C, i8 = _check_call(gmap, (fmap,), (scale,), coords, kk, jj)
    _check(gmap.data_ptr() % 16 == 0, "gmap is not 16-byte aligned")
    cap, depth, blocks = group_plan(P, C, gmap.dtype, fmap.dtype)
    surface = torch.zeros((-(-E // plain.GROUP_EDGES), plain.GROUP_ROWS,
                           plain.GROUP_EDGES * plain.GROUP_LANES),
                          dtype=torch.bfloat16, device=gmap.device)
    if E == 0:
        return surface, cap
    lib = _load()
    code = lib.devo_corr_group_surface(
        gmap.data_ptr(), fmap.data_ptr(), coords.data_ptr(), kk.data_ptr(),
        jj.data_ptr(), surface.data_ptr(), E, P * P, C, fmap.shape[1],
        fmap.shape[2], cap, plain.GROUP_ROWS, int(gmap.dtype == torch.bfloat16),
        int(i8), depth, group_run(E, gmap.device, blocks),
        torch.cuda.current_stream(gmap.device).cuda_stream)
    _launched("corr_group_surface", code)
    return surface, cap


def group_blocks_per_sm(P: int, C: int, gmap_dtype, ring_dtype,
                        kernel: str = "corr_group") -> int:
    """Blocks of corr_group's kernel, or of another kernel at group_plan
    (`kernel`: corr_level_pipe, corr_level, or corr_group8 or
    corr_level_full on float rings), that one SM of the current CUDA device
    holds at a time at group_plan's sizes."""
    cap, depth, _ = group_plan(P, C, gmap_dtype, ring_dtype)
    return _blocks_per_sm(kernel, (P, C, gmap_dtype, ring_dtype, cap, depth))


def corr_level_pipe_cuda(gmap, fmap, coords, kk, jj, scale=None) -> torch.Tensor:
    """Launch csrc/corr_level_pipe.cu, one pyramid level on the edge pipeline
    in corr_group8's shape at group_plan and group_run, every tap exact, on
    every ring type (CORR_KERNEL="split2"). Arguments and result as
    `corr_level_cuda`; the plain version is ops/corr.corr_level."""
    return _group_call("corr_level_pipe", gmap, fmap, coords, kk, jj, scale)


def corr_level_cuda(gmap, fmap, coords, kk, jj, scale=None) -> torch.Tensor:
    """Launch csrc/corr_level.cu, one pyramid level (CORR_KERNEL="split"):
    corr_level_pipe's instance of the edge pipeline under its own name, at
    group_plan and group_run, its bits. gmap (Mring, P, P, C) bf16 or f32;
    fmap (mem, h, w, C) of gmap's dtype, or int8 with scale (mem,) f32;
    coords (E, P, P, 2) f32 at this level's resolution; kk, jj (E,) int32.
    Returns (E, 49*P*P) f32 in [dx, dy, pixel] order; the plain version is
    ops/corr.corr_level."""
    return _group_call("corr_level", gmap, fmap, coords, kk, jj, scale)


@functools.lru_cache(maxsize=None)
def resident_plan(h: int, w: int, C: int, P: int, gmap_dtype):
    """(warps, cap, bytes) of a corr_level_resident block on an (h, w, C)
    int8 ring with P x P patches of `gmap_dtype`: the frame, one row a
    position of C rounded up to whole chunks of 32 channels, and one zero
    row; then for each warp its surface slot (RESIDENT_CAP rows of a column
    a pixel, or a level's P*P x 64 taps where that is more), its pixel table
    and, for f32 patch features, the patch feature as f32; as many warps as
    the rest of a block holds, at most RESIDENT_MAX_WARPS. Raises
    ValueError on what the kernel does not take: C no multiple of 16 (the
    frame copies in 16-byte pieces), more than 16 pixels, a frame that
    leaves no room for one warp. The C query devo_corr_level_resident_smem
    gives the same bytes."""
    _check(C % 16 == 0, f"C must be a multiple of 16, got {C}")
    _check(P * P <= 16, f"P={P}: the kernel's pixel table holds 16 pixels")
    row = -(-C // _MMA_CHUNK) * _MMA_CHUNK
    frame = (h * w + 1) * row
    warp = (_slot_bytes(P, RESIDENT_CAP) + _RESIDENT_TABLE
            + (P * P * C * 4 if gmap_dtype == torch.float32 else 0))
    warps = min(RESIDENT_MAX_WARPS, (SMEM_MAX - frame) // warp)
    _check(warps >= 1, f"a {h}x{w}x{C} int8 frame and one warp's scratch "
                       f"({frame + warp} bytes) exceed the {SMEM_MAX} bytes "
                       f"of shared memory a block can have")
    return warps, RESIDENT_CAP, frame + warps * warp


def resident_smem_bytes(h: int, w: int, C: int, P: int,
                        gmap_dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of a corr_level_resident block (resident_plan)."""
    return resident_plan(h, w, C, P, gmap_dtype)[2]


def resident_fits(h: int, w: int, C: int, P: int) -> bool:
    """Whether corr_level_resident takes an (h, w, C) int8 ring with P x P
    patches whatever the patch features' type: the plan with fewer warps
    (f32 patch features) holds one warp beside the frame."""
    try:
        for dtype in (torch.bfloat16, torch.float32):
            resident_plan(h, w, C, P, dtype)
    except ValueError:
        return False
    return True


def corr_level_resident_cuda(gmap, fmap, coords, kk, jj, scale) -> torch.Tensor:
    """Launch csrc/corr_level_resident.cu: corr_level_cuda's function for an
    int8 ring small enough that one frame fits a block's shared memory
    (`resident_plan`), read from that frame. The edges are sorted by ring
    slot on the device (a stable sort and a search, no host sync) and
    walked by persistent blocks, one an SM; every row of the output is
    written at its edge's own position, the same bits whatever the block
    count."""
    _check(fmap.dtype == torch.int8 and scale is not None,
           "the resident kernel takes int8 rings with per-slot scales")
    E, P, C, _ = _check_call(gmap, (fmap,), (scale,), coords, kk, jj)
    mem, h, w, _ = fmap.shape
    warps, cap, _ = resident_plan(h, w, C, P, gmap.dtype)
    for name, t in (("gmap", gmap), ("coords", coords)):
        _check(t.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")

    out = torch.empty((E, _FEATS * P * P), dtype=torch.float32,
                      device=gmap.device)
    if E == 0:
        return out
    order, slots, offsets = resident_order(jj, mem)
    lib = _load()
    code = lib.devo_corr_level_resident(
        gmap.data_ptr(), fmap.data_ptr(), scale.data_ptr(), coords.data_ptr(),
        kk.data_ptr(), order.data_ptr(), slots.data_ptr(), offsets.data_ptr(),
        out.data_ptr(), E, P * P, C, h, w, cap,
        int(gmap.dtype == torch.bfloat16), warps,
        _sms(gmap.device),
        torch.cuda.current_stream(gmap.device).cuda_stream)
    _launched("corr_level_resident", code)
    return out


def resident_order(jj, mem: int):
    """The edges sorted by ring slot on jj's device, without a host sync:
    (order, the slots in that order, offsets (mem + 1,) of each slot's
    first position), all int32."""
    by_slot = torch.sort(jj, stable=True)
    offsets = torch.searchsorted(
        by_slot.values,
        torch.arange(mem + 1, dtype=torch.int32, device=jj.device),
        out_int32=True)
    return by_slot.indices.to(torch.int32), by_slot.values, offsets


def _float_level_call(gmap, fmap, coords, kk, jj, scale):
    """What the kernels that take one float-ring level ask of their
    arguments. Returns (E, P, C)."""
    _check(scale is None and fmap.dtype != torch.int8,
           "the kernel takes float rings (bf16 or f32) without scales")
    E, P, C, _ = _check_call(gmap, (fmap,), (None,), coords, kk, jj)
    _check(P * P <= 16, f"P={P}: the kernel's index table holds 16 pixels")
    for name, t in (("gmap", gmap), ("coords", coords)):
        _check(t.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")
    return E, P, C


def fixed_smem_bytes(P: int, C: int, dtype) -> int:
    """Dynamic shared memory of a corr_fixed block. bf16 (the tensor-core
    kernel): _FIXED_STAGES stages of the window's 384 positions x 32
    channels, the patch feature as rows for the tensor cores (_mma_stride),
    the f32 product surface of the 384 positions and a pixel's 64 taps for
    every pixel. f32: the f32 patch feature, the surface and the taps."""
    PP = P * P
    if dtype == torch.bfloat16:
        return ((_FIXED_STAGES * _FIXED_POSITIONS * _MMA_CHUNK
                 + PP * _mma_stride(C)) * 2
                + (_FIXED_POSITIONS * _surface_row(P) + PP * _TAPS) * 4)
    return (PP * C + (_FIXED_POSITIONS + _TAPS) * PP) * 4


def fixed_plan(P: int, C: int, dtype):
    """(stages, blocks an SM) of corr_fixed: the stages of the bf16 kernel's
    window ring (0 for f32 rings, whose kernel stages no window) and the
    blocks that one SM's shared memory and threads hold. Raises ValueError on
    what the kernel does not take."""
    _check(P * P <= 16, f"P={P}: the kernel's index table holds 16 pixels")
    _check(C % 4 == 0, f"C must be a multiple of 4, got {C}")
    smem = fixed_smem_bytes(P, C, dtype)
    _check(smem <= SMEM_MAX - _FIXED_STATIC,
           f"P={P}, C={C} needs more shared memory than a block can have")
    bf16 = dtype == torch.bfloat16
    threads = 256 if bf16 else _FIXED_POSITIONS // 2
    blocks = min(_SMEM_SM // (smem + _FIXED_STATIC + _SMEM_RESERVED),
                 2048 // threads)
    return (_FIXED_STAGES if bf16 else 0), blocks


def fixed_blocks_per_sm(P: int, C: int, dtype) -> int:
    """Blocks of corr_fixed's kernel that one SM of the current CUDA device
    holds at a time (shared memory and registers)."""
    return _occupancy("corr_fixed", _load().devo_corr_fixed_blocks_per_sm(
        P * P, C, int(dtype == torch.bfloat16)))


def corr_fixed_cuda(gmap, fmap, coords, kk, jj, scale=None) -> torch.Tensor:
    """Launch csrc/corr_fixed.cu, one pyramid level over a fixed 16x24 window
    an edge (CORR_IMPL="pallas"): gmap (Mring, P, P, C) and fmap
    (mem, h, w, C) both bf16 or both f32; coords (E, P, P, 2) f32 at this
    level's resolution; kk, jj (E,) int32. Returns (E, 49*P*P) f32 in
    [dx, dy, pixel] order; the plain version is ops/corr.corr_level."""
    E, P, C = _float_level_call(gmap, fmap, coords, kk, jj, scale)
    fixed_plan(P, C, gmap.dtype)
    out = torch.empty((E, _FEATS * P * P), dtype=torch.float32,
                      device=gmap.device)
    if E == 0:
        return out
    lib = _load()
    code = lib.devo_corr_fixed(
        gmap.data_ptr(), fmap.data_ptr(), coords.data_ptr(), kk.data_ptr(),
        jj.data_ptr(), out.data_ptr(), E, P * P, C, fmap.shape[1],
        fmap.shape[2], int(gmap.dtype == torch.bfloat16),
        torch.cuda.current_stream(gmap.device).cuda_stream)
    _launched("corr_fixed", code)
    return out


def corr_group8_cuda(gmap, fmap, coords, kk, jj, scale=None) -> torch.Tensor:
    """Launch csrc/corr_group8.cu, one pyramid level on corr_group's pipeline
    and plan with exact taps (CORR_KERNEL="g8"). Arguments and result as
    `corr_fixed_cuda`; the plain version is ops/corr.corr_level."""
    E, P, C = _float_level_call(gmap, fmap, coords, kk, jj, scale)
    cap, depth, blocks = group_plan(P, C, gmap.dtype, fmap.dtype)
    out = torch.empty((E, _FEATS * P * P), dtype=torch.float32,
                      device=gmap.device)
    if E == 0:
        return out
    lib = _load()
    code = lib.devo_corr_group8(
        gmap.data_ptr(), fmap.data_ptr(), coords.data_ptr(), kk.data_ptr(),
        jj.data_ptr(), out.data_ptr(), E, P * P, C, fmap.shape[1],
        fmap.shape[2], cap, int(gmap.dtype == torch.bfloat16), depth,
        group_run(E, gmap.device, blocks),
        torch.cuda.current_stream(gmap.device).cuda_stream)
    _launched("corr_group8", code)
    return out


def full_knobs(P: int, C: int, ring_dtype, depth: int = None,
               run: int = None):
    """(cap, depth, blocks an SM) of corr_level_full, an instance of the edge
    pipeline in corr_group8's shape: group_plan's, with `depth` (the stages
    of a block's ring, half of them each of its two pipelines') in its place
    where given, and then two blocks an SM where half an SM holds that ring,
    else one. Raises ValueError on a depth outside 2 .. FULL_MAX_DEPTH or no
    multiple of the two pipelines, on a depth beyond a block's shared
    memory, and on a run below 1."""
    if run is not None and run < 1:
        raise ValueError(f"run must be at least 1, got {run}")
    cap, plan_depth, blocks = group_plan(P, C, ring_dtype, ring_dtype)
    if depth is None:
        return cap, plan_depth, blocks
    if not 2 <= depth <= FULL_MAX_DEPTH or depth % 2:
        raise ValueError(f"depth must be 2 to {FULL_MAX_DEPTH} and a multiple "
                         f"of the block's 2 pipelines, got {depth}")
    smem = group_smem_bytes(P, C, ring_dtype, ring_dtype, cap, depth)
    if smem > SMEM_MAX - _MONO_STATIC:
        raise ValueError(f"P={P}, C={C} with a ring of {depth} stages needs "
                         f"more shared memory than a block can have")
    half = _SMEM_SM // 2 - _SMEM_RESERVED - _MONO_STATIC
    return cap, depth, 2 if smem <= half else 1


def corr_level_full_cuda(gmap, fmap, coords, kk, jj, scale=None,
                         stage: str = "full", depth: int = None,
                         run: int = None) -> torch.Tensor:
    """Launch csrc/corr_level_full.cu, one pyramid level on the edge pipeline
    in corr_group8's shape (CORR_KERNEL="full"). Arguments and result as
    `corr_fixed_cuda`; the plain version is ops/corr.corr_level. `stage`
    picks the kernel's instance: "full" (the correlation) or one that skips
    a part of it to time the rest, "noext" (no extraction), "nomm" (no
    product), "noDMA" (no copy); those write what ops/corr.corr_level_stage
    defines at full_knobs' cap. `depth` (the stages of a block's ring: 2 or
    FULL_MAX_DEPTH, a multiple of its two pipelines, as many as a block's
    shared memory holds) and `run` (at least 1) override group_plan's ring
    depth and group_run's edges a block, for tuning."""
    if stage not in plain.STAGES:
        raise ValueError(f"stage must be one of {plain.STAGES}, got {stage!r}")
    E, P, C = _float_level_call(gmap, fmap, coords, kk, jj, scale)
    cap, depth, blocks = full_knobs(P, C, fmap.dtype, depth, run)
    out = torch.empty((E, _FEATS * P * P), dtype=torch.float32,
                      device=gmap.device)
    if E == 0:
        return out
    lib = _load()
    code = lib.devo_corr_level_full(
        gmap.data_ptr(), fmap.data_ptr(), coords.data_ptr(), kk.data_ptr(),
        jj.data_ptr(), out.data_ptr(), E, P * P, C, fmap.shape[1],
        fmap.shape[2], cap, int(gmap.dtype == torch.bfloat16), depth,
        run or group_run(E, gmap.device, blocks), plain.STAGES.index(stage),
        torch.cuda.current_stream(gmap.device).cuda_stream)
    _launched("corr_level_full", code)
    return out


KERNELS = ("mono", "mono2", "mono3", "mono4", "pair", "pair2", "split",
           "split2", "g8c", "g8", "full")
IMPLS = ("banded", "pallas", "window", "gather")
# the kernels that take float rings only
FLOAT_ONLY = ("g8", "full")
# the kernels that take both levels in one launch
_TWO_LEVEL = {
    "mono": corr_pyramid_cuda, "pair": corr_pair_cuda,
    "pair2": corr_pair2_cuda, "mono3": corr_mono3_cuda,
    "mono2": functools.partial(corr_mono2_cuda, concat=True),
    "mono4": functools.partial(corr_mono2_cuda, concat=False)}
# the kernels that take one level a launch: (kernel, its plain version)
_PER_LEVEL = {"split": (corr_level_cuda, plain.corr_level),
              "split2": (corr_level_pipe_cuda, plain.corr_level),
              "g8c": (corr_group_cuda, plain.corr_level_group),
              "g8": (corr_group8_cuda, plain.corr_level),
              "full": (corr_level_full_cuda, plain.corr_level)}
# the kernels that may hand their last level to the resident kernel
RESIDENT_KERNELS = ("split", "split2", "g8c")


def corr_pyramid(gmap, pyramid, coords, kk, jj, radius: int = 3,
                 levels=(1, 4), scales=None, kernel: str = "mono",
                 resident: bool = False, impl: str = "banded") -> torch.Tensor:
    """Two-level correlation feature (E, 2*49*P*P) f32 in [dx, dy, pixel,
    level] order: the plain versions for CPU tensors, the CUDA kernels for
    CUDA tensors. `scales`: per level the (mem,) f32 scales of an int8 ring.
    `impl`: one of IMPLS, the engine's CORR_IMPL. "banded" = the kernel
    `kernel` names; "pallas" = csrc/corr_fixed.cu, one launch per level
    (plain version: ops/corr.corr_level); "window", "gather" = tensor code on
    either device (ops/corr.corr_pyramid_window, corr_pyramid_gather). Every
    family but "banded" takes float rings. `kernel`: one of KERNELS. "mono",
    "mono2", "mono3", "mono4", "pair", "pair2" = both levels in one launch
    (plain version: ops/corr.corr_pyramid); "split", "split2", "g8", "full"
    = one launch per level (ops/corr.corr_level; "g8" and "full" float rings
    only); "g8c" = one launch per level through a bf16 product surface
    (ops/corr.corr_level_group). With `resident` the last level of "split",
    "split2" or "g8c" comes from the resident-ring kernel (int8 rings
    only)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl != "banded":
        if scales is not None or resident:
            raise ValueError(f"impl={impl!r} takes float rings, without "
                             "scales or a resident level")
        if impl == "gather":
            return plain.corr_pyramid_gather(gmap, pyramid, coords, kk, jj,
                                             radius, levels)
        _check(radius == _RADIUS, f"impl={impl!r} is built for radius "
                                  f"{_RADIUS}")
        if impl == "window":
            return plain.corr_pyramid_window(gmap, pyramid, coords, kk, jj,
                                             levels)
        return _per_level(corr_fixed_cuda, plain.corr_level, gmap, pyramid,
                          coords, kk, jj, levels, None, False)
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if kernel in FLOAT_ONLY and scales is not None:
        raise ValueError(f"kernel {kernel!r} takes float rings, without scales")
    if resident and (kernel not in RESIDENT_KERNELS or scales is None):
        raise ValueError("the resident level needs a per-level kernel "
                         f"({', '.join(RESIDENT_KERNELS)}) and int8 rings with "
                         "scales")
    if kernel in _TWO_LEVEL:
        if gmap.device.type == "cpu":
            return plain.corr_pyramid(gmap, pyramid, coords, kk, jj, radius,
                                      levels, scales)
        _check(radius == _RADIUS, f"the kernel is built for radius {_RADIUS}")
        _check(len(pyramid) == 2, "the kernel computes two levels")
        return _TWO_LEVEL[kernel](gmap, pyramid[0], pyramid[1], coords, kk,
                                  jj, levels, scales)

    _check(radius == _RADIUS, f"the per-level kernels are built for radius "
                              f"{_RADIUS}")
    return _per_level(*_PER_LEVEL[kernel], gmap, pyramid, coords, kk, jj,
                      levels, scales, resident)


def _per_level(on_card, on_cpu, gmap, pyramid, coords, kk, jj, levels, scales,
               resident):
    """A kernel that takes one level a launch (`on_card`, plain version
    `on_cpu`) over the levels of `pyramid`, coords divided by each level's
    stride here. With `resident` the last level comes from the resident-ring
    kernel, whose plain version is corr_level."""
    if scales is None:
        scales = (None,) * len(pyramid)
    outs = []
    for n, (fmap, lvl, scale) in enumerate(zip(pyramid, levels, scales)):
        at_level = coords / lvl
        last = resident and n == len(pyramid) - 1
        if gmap.device.type == "cpu":
            fn = plain.corr_level if last else on_cpu
        else:
            fn = corr_level_resident_cuda if last else on_card
        outs.append(fn(gmap, fmap, at_level, kk, jj, scale))
    return plain.stack_levels(outs)
