"""The engine's correlation entry point, and the bindings of the CUDA
kernels in csrc/.

`corr_pyramid` takes the plain PyTorch versions (ops/corr.py) for tensors on
the CPU and launches a kernel for tensors on a CUDA device; there is no
fallback from one to the other. Nine kernels, one launch counter each
(`launches`), chosen by `kernel` (the engine's CORR_KERNEL) and `resident`:

- "mono", `corr_pyramid_cuda` (csrc/corr.cu): both pyramid levels in one
  launch, one warp per tap reading the ring;
- "split", `corr_level_cuda` (csrc/corr_level.cu): one level per launch;
- `resident`, `corr_level_resident_cuda` (csrc/corr_level_resident.cu): the
  last level of a per-level kernel from an int8 ring slot held in a block's
  shared memory;
- "pair", `corr_pair_cuda` (csrc/corr_pair.cu): both levels in one launch, a
  block per edge, the patch feature shared by the levels and each level's
  window staged by its own group of asynchronous copies;
- "pair2", `corr_pair2_cuda` (csrc/corr_pair2.cu): the same by persistent
  blocks that keep the next edge's windows in flight while they compute the
  current one;
- "split2", `corr_level_pipe_cuda` (csrc/corr_level_pipe.cu): one level per
  launch by such persistent blocks;
- "g8c", `corr_group_cuda` (csrc/corr_group.cu): one level per launch in two
  stages: the kernel writes the raw bf16 product surface of groups of eight
  edges, and ops/corr.extract_blend_group reads the taps from it;
- "mono2" / "mono4", `corr_mono2_cuda` (csrc/corr_mono2.cu): both levels in
  one launch, two edges a block, their windows gathered into one buffer
  ("mono2") or read where the copies landed ("mono4");
- "mono3", `corr_mono3_cuda` (csrc/corr_mono3.cu): both levels in one launch
  from a per-edge product surface in shared memory, a block walking a run of
  edges behind a ring of window copies;
- "g8", `corr_group8_cuda` (csrc/corr_group8.cu): one level per launch, eight
  consecutive edges a block, their f32 product surfaces kept in the block
  and extracted there;
- "full", `corr_level_full_cuda` (csrc/corr_level_full.cu): one level per
  launch, a block walking a run of edges with the copy, the product surface
  and the extraction of every edge interleaved; its stage instances
  ("noext", "nomm", "noDMA") time those parts apart.

`impl` (the engine's CORR_IMPL) chooses the family: "banded" is the kernel
`kernel` names; "pallas" is `corr_fixed_cuda` (csrc/corr_fixed.cu), one
level per launch over a fixed 16x24 window an edge; "window" and "gather"
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
            "corr_fixed": 0, "corr_group8": 0, "corr_level_full": 0,
            # the probe kernels, launched by ops/probe_cuda.py
            "corr_band_ablate": 0, "copy_probe": 0, "corr_frame_probe": 0}

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_RADIUS = 3
_TAPS = (2 * _RADIUS + 2) ** 2          # integer taps of one pixel
_FEATS = (2 * _RADIUS + 1) ** 2         # blended offsets of one pixel
_SMEM_DEFAULT = 48 * 1024     # dynamic shared memory of a block by default
SMEM_MAX = 232_448            # the most a block can have on sm_90
LEVEL_WINDOW_CAP = 144        # feature vectors of a level's staged window
_PAIR_STATIC = 4096           # bound on the static shared memory of the pair
                              #   kernels (their per-edge index tables)
_MONO3_STATIC = 6144          # the same of corr_mono3 (ten such tables)
_GROUP_STATIC = 5120          # and of corr_group and corr_group8 (eight)
_FULL_STATIC = 4096           # and of corr_level_full (six)
_SMEM_SM = 233_472            # shared memory of an SM on sm_90
_SMEM_RESERVED = 1024         # of which each resident block takes this much
MONO3_RUN = 64                # edges a corr_mono3 block walks
MONO3_MAX_DEPTH = 8           # stages of its window ring
FULL_RUN = 64                 # edges a corr_level_full block walks
FULL_MAX_DEPTH = 4            # stages of its window ring
_FIXED_POSITIONS = 16 * 24    # corr_fixed's window
_RESIDENT_WARPS = 8           # warps of a corr_level_resident block
_RESIDENT_SPLIT = 8           # blocks per ring slot (grid.y)
_lib = None


def reset_launches():
    for name in launches:
        launches[name] = 0


def sources():
    """The CUDA sources, headers included, in a fixed order."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build() -> Path:
    """Compile every csrc/*.cu for sm_90a into one library unless this
    version of the sources is built already: one `nvcc -c` per source, all
    started together, then one link. Returns the library's path; ptxas's
    register and shared memory report is kept beside it with the suffix
    .log."""
    digest = hashlib.sha256()
    for src in sources():
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    lib = BUILD_DIR / f"libdevo_corr_{digest.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    nvcc = _nvcc()
    units = [s for s in sources() if s.suffix == ".cu"]
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
        lib.devo_corr_pyramid.argtypes = [ptr] * 9 + [i] * 7 + [f] * 2 + [i, i, ptr]
        lib.devo_corr_level.argtypes = [ptr] * 7 + [i] * 8 + [ptr]
        lib.devo_corr_level_resident.argtypes = [ptr] * 8 + [i] * 8 + [ptr]
        lib.devo_corr_pair.argtypes = [ptr] * 9 + [i] * 8 + [f] * 2 + [i, i, ptr]
        lib.devo_corr_pair2.argtypes = lib.devo_corr_pair.argtypes
        lib.devo_corr_pair2_blocks_per_sm.argtypes = [i] * 5
        lib.devo_corr_level_pipe.argtypes = lib.devo_corr_level.argtypes
        lib.devo_corr_level_pipe_blocks_per_sm.argtypes = [i] * 5
        lib.devo_corr_group.argtypes = [ptr] * 6 + [i] * 9 + [ptr]
        lib.devo_corr_mono2.argtypes = ([ptr] * 9 + [i] * 8 + [f] * 2
                                        + [i] * 3 + [ptr])
        lib.devo_corr_mono3.argtypes = ([ptr] * 9 + [i] * 8 + [f] * 2
                                        + [i] * 4 + [ptr])
        lib.devo_corr_fixed.argtypes = [ptr] * 6 + [i] * 6 + [ptr]
        lib.devo_corr_group8.argtypes = [ptr] * 6 + [i] * 7 + [ptr]
        lib.devo_corr_level_full.argtypes = [ptr] * 6 + [i] * 10 + [ptr]
        lib.devo_corr_band_ablate.argtypes = [ptr] * 9 + [i] * 6 + [ptr]
        lib.devo_corr_frame_probe.argtypes = [ptr] * 7 + [i] * 5 + [ptr]
        lib.devo_copy_probe.argtypes = ([ptr] * 5 + [ctypes.c_longlong]
                                        + [i] * 9 + [ptr])
        for fn in (lib.devo_corr_fixed, lib.devo_corr_group8,
                   lib.devo_corr_level_full, lib.devo_corr_pyramid,
                   lib.devo_corr_level,
                   lib.devo_corr_level_resident, lib.devo_corr_pair,
                   lib.devo_corr_pair2, lib.devo_corr_pair2_blocks_per_sm,
                   lib.devo_corr_level_pipe,
                   lib.devo_corr_level_pipe_blocks_per_sm,
                   lib.devo_corr_group, lib.devo_corr_mono2,
                   lib.devo_corr_mono3, lib.devo_corr_band_ablate,
                   lib.devo_corr_frame_probe, lib.devo_copy_probe):
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


def corr_pyramid_cuda(gmap, fmap1, fmap2, coords, kk, jj, levels=(1, 4),
                      scales=None) -> torch.Tensor:
    """Launch csrc/corr.cu: gmap (Mring, P, P, C) bf16 or f32; fmap1
    (mem, h1, w1, C) and fmap2 (mem, h2, w2, C) of gmap's dtype, or int8
    with scales = (scale1, scale2), each (mem,) f32; coords (E, P, P, 2) f32
    at level-1 resolution; kk, jj (E,) int32 ring indices. Returns
    (E, 2*49*P*P) f32 in [dx, dy, pixel, level] order."""
    scales = (None, None) if scales is None else tuple(scales)
    _check(len(levels) == 2 and len(scales) == 2,
           "the kernel computes two levels")
    E, P, C, i8 = _check_call(gmap, (fmap1, fmap2), scales, coords, kk, jj)
    PP = P * P
    _check((PP * C + 2 * PP * _TAPS) * 4 <= _SMEM_DEFAULT,
           f"P={P}, C={C} needs more shared memory than a block gets")

    out = torch.empty((E, 2 * _FEATS * PP), dtype=torch.float32,
                      device=gmap.device)
    if E == 0:
        return out
    lib = _load()
    code = lib.devo_corr_pyramid(
        gmap.data_ptr(), fmap1.data_ptr(), fmap2.data_ptr(),
        _ptr(scales[0]), _ptr(scales[1]), coords.data_ptr(), kk.data_ptr(),
        jj.data_ptr(), out.data_ptr(), E, PP, C, fmap1.shape[1],
        fmap1.shape[2], fmap2.shape[1], fmap2.shape[2], float(levels[0]),
        float(levels[1]), int(gmap.dtype == torch.bfloat16), int(i8),
        torch.cuda.current_stream(gmap.device).cuda_stream)
    _launched("corr_pyramid", code)
    return out


def level_smem_bytes(P: int, C: int, ring_dtype, cap: int) -> int:
    """Dynamic shared memory of a corr_level block: the patch feature and
    the taps as f32, and `cap` feature vectors of the ring's type."""
    PP = P * P
    return (PP * C + PP * _TAPS) * 4 + cap * C * _item(ring_dtype)


def corr_level_cuda(gmap, fmap, coords, kk, jj, scale=None) -> torch.Tensor:
    """Launch csrc/corr_level.cu, one pyramid level: gmap (Mring, P, P, C)
    bf16 or f32; fmap (mem, h, w, C) of gmap's dtype, or int8 with scale
    (mem,) f32; coords (E, P, P, 2) f32 at this level's resolution; kk, jj
    (E,) int32. Returns (E, 49*P*P) f32 in [dx, dy, pixel] order."""
    E, P, C, i8 = _check_call(gmap, (fmap,), (scale,), coords, kk, jj)
    # the window is staged by 16-byte copies; a ring whose feature vector
    # is no multiple of that reads every tap from the ring
    cap = LEVEL_WINDOW_CAP if C * fmap.element_size() % 16 == 0 else 0
    _check(level_smem_bytes(P, C, fmap.dtype, cap) <= SMEM_MAX,
           f"P={P}, C={C} needs more shared memory than a block can have")

    out = torch.empty((E, _FEATS * P * P), dtype=torch.float32,
                      device=gmap.device)
    if E == 0:
        return out
    lib = _load()
    code = lib.devo_corr_level(
        gmap.data_ptr(), fmap.data_ptr(), _ptr(scale), coords.data_ptr(),
        kk.data_ptr(), jj.data_ptr(), out.data_ptr(), E, P * P, C,
        fmap.shape[1], fmap.shape[2], cap,
        int(gmap.dtype == torch.bfloat16), int(i8),
        torch.cuda.current_stream(gmap.device).cuda_stream)
    _launched("corr_level", code)
    return out


def _item(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def pair_smem_bytes(P: int, C: int, ring_dtype, cap: int) -> int:
    """Dynamic shared memory of a corr_pair block: the patch feature and
    both levels' taps as f32, and per level `cap` feature vectors of the
    ring's type."""
    PP = P * P
    return (PP * C + 2 * PP * _TAPS) * 4 + 2 * cap * C * _item(ring_dtype)


def pair2_smem_bytes(P: int, C: int, gmap_dtype, ring_dtype, cap: int) -> int:
    """Dynamic shared memory of a corr_pair2 block: the patch feature and
    both levels' taps as f32, and two stages, each the raw patch feature
    (rounded up to 16 bytes) and per level `cap` feature vectors."""
    PP = P * P
    graw = -(-PP * C * _item(gmap_dtype) // 16) * 16
    return ((PP * C + 2 * PP * _TAPS) * 4
            + 2 * (graw + 2 * cap * C * _item(ring_dtype)))


def _pair_smem(name: str, P: int, C: int, gmap_dtype, ring_dtype, cap: int):
    """Dynamic shared memory of the pair kernel `name` at window size
    `cap`."""
    if name == "corr_pair":
        return pair_smem_bytes(P, C, ring_dtype, cap)
    return pair2_smem_bytes(P, C, gmap_dtype, ring_dtype, cap)


def _fit_cap(smem_of_cap, C: int, ring_dtype, room: int) -> int:
    """Feature vectors of each staged window of a kernel whose block takes
    `smem_of_cap(cap)` bytes of shared memory: LEVEL_WINDOW_CAP, fewer where
    `room` bytes hold no more, and 0 (every tap reads the ring) where none
    fits or a feature vector is no multiple of the 16-byte copies."""
    if C * _item(ring_dtype) % 16 != 0:
        return 0
    return next((cap for cap in range(LEVEL_WINDOW_CAP, 0, -1)
                 if smem_of_cap(cap) <= room), 0)


def pair_cap(name: str, P: int, C: int, gmap_dtype, ring_dtype) -> int:
    """Feature vectors of each staged window of the pair kernel `name`
    ("corr_pair" or "corr_pair2"), see `_fit_cap`."""
    return _fit_cap(
        lambda cap: _pair_smem(name, P, C, gmap_dtype, ring_dtype, cap), C,
        ring_dtype, SMEM_MAX - _PAIR_STATIC)


def _staged_call(name, smem, static, cap, extra, gmap, rings, coords, kk, jj,
                 levels, scales):
    """The checks, the output and the launch that the kernels with windows
    staged by asynchronous copies share. `name`: the launch counter, and
    devo_<name> the C function; `smem`: the block's dynamic shared memory at
    window size `cap`; `extra`: the integers the C function takes after the
    type flags; `rings`: one ring (a per-level kernel, which takes no level
    strides) or two, as many as the output has levels."""
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


def _pair_call(name, gmap, fmap1, fmap2, coords, kk, jj, levels, scales):
    """corr_pair and corr_pair2; `name` is the kernel's launch counter."""
    P, C = _patch_shape(gmap)
    cap = pair_cap(name, P, C, gmap.dtype, fmap1.dtype)
    return _staged_call(
        name, _pair_smem(name, P, C, gmap.dtype, fmap1.dtype, cap),
        _PAIR_STATIC, cap, (), gmap, (fmap1, fmap2), coords, kk, jj, levels,
        scales)


def corr_pair_cuda(gmap, fmap1, fmap2, coords, kk, jj, levels=(1, 4),
                   scales=None) -> torch.Tensor:
    """Launch csrc/corr_pair.cu. Arguments and result as
    `corr_pyramid_cuda`; the plain version is ops/corr.corr_pyramid."""
    return _pair_call("corr_pair", gmap, fmap1, fmap2, coords, kk, jj,
                      levels, scales)


def corr_pair2_cuda(gmap, fmap1, fmap2, coords, kk, jj, levels=(1, 4),
                    scales=None) -> torch.Tensor:
    """Launch csrc/corr_pair2.cu. Arguments and result as
    `corr_pyramid_cuda`; the plain version is ops/corr.corr_pyramid."""
    return _pair_call("corr_pair2", gmap, fmap1, fmap2, coords, kk, jj,
                      levels, scales)


def pair2_blocks_per_sm(P: int, C: int, gmap_dtype, ring_dtype) -> int:
    """Blocks of corr_pair2's kernel that one SM of the current CUDA device
    holds at a time at these sizes (the kernel's grid is that times the
    number of SMs)."""
    cap = pair_cap("corr_pair2", P, C, gmap_dtype, ring_dtype)
    occ = _load().devo_corr_pair2_blocks_per_sm(
        P * P, C, cap, int(gmap_dtype == torch.bfloat16),
        int(ring_dtype == torch.int8))
    if occ < 0:
        raise RuntimeError("corr_pair2 occupancy query failed: "
                           f"{_lib.devo_cuda_error_string(-occ).decode()}")
    return occ


def _padded(C: int, ring_dtype) -> int:
    """Bytes between the vectors of a window that is read position by
    position (corr_mono3, corr_group): 16 more than a vector, so that the
    lanes' 16-byte reads fall into different banks."""
    return C * _item(ring_dtype) + 16


def level_pipe_smem_bytes(P: int, C: int, gmap_dtype, ring_dtype, cap: int) -> int:
    """Dynamic shared memory of a corr_level_pipe block: the patch feature
    and the taps as f32, and two stages, each the raw patch feature (rounded
    up to 16 bytes) and `cap` feature vectors."""
    PP = P * P
    graw = -(-PP * C * _item(gmap_dtype) // 16) * 16
    return ((PP * C + PP * _TAPS) * 4
            + 2 * (graw + cap * C * _item(ring_dtype)))


def level_pipe_cap(P: int, C: int, gmap_dtype, ring_dtype) -> int:
    """Feature vectors of corr_level_pipe's staged window, see `_fit_cap`."""
    return _fit_cap(
        lambda cap: level_pipe_smem_bytes(P, C, gmap_dtype, ring_dtype, cap),
        C, ring_dtype, SMEM_MAX - _PAIR_STATIC)


def corr_level_pipe_cuda(gmap, fmap, coords, kk, jj, scale=None) -> torch.Tensor:
    """Launch csrc/corr_level_pipe.cu, one pyramid level. Arguments and
    result as `corr_level_cuda`; the plain version is ops/corr.corr_level."""
    P, C = _patch_shape(gmap)
    cap = level_pipe_cap(P, C, gmap.dtype, fmap.dtype)
    return _staged_call(
        "corr_level_pipe",
        level_pipe_smem_bytes(P, C, gmap.dtype, fmap.dtype, cap),
        _PAIR_STATIC, cap, (), gmap, (fmap,), coords, kk, jj, (1,), (scale,))


def level_pipe_blocks_per_sm(P: int, C: int, gmap_dtype, ring_dtype) -> int:
    """Blocks of corr_level_pipe's kernel that one SM of the current CUDA
    device holds at a time at these sizes (its grid is that times the number
    of SMs)."""
    cap = level_pipe_cap(P, C, gmap_dtype, ring_dtype)
    occ = _load().devo_corr_level_pipe_blocks_per_sm(
        P * P, C, cap, int(gmap_dtype == torch.bfloat16),
        int(ring_dtype == torch.int8))
    if occ < 0:
        raise RuntimeError("corr_level_pipe occupancy query failed: "
                           f"{_lib.devo_cuda_error_string(-occ).decode()}")
    return occ


def mono2_smem_bytes(P: int, C: int, ring_dtype, cap: int, concat: bool) -> int:
    """Dynamic shared memory of a corr_mono2 block: two edges' patch features
    and taps of both levels as f32, their four windows of `cap` feature
    vectors, and with `concat` the buffer that holds one level's pair of
    windows side by side."""
    PP = P * P
    return (2 * (PP * C + 2 * PP * _TAPS) * 4
            + (6 if concat else 4) * cap * C * _item(ring_dtype))


def mono2_cap(P: int, C: int, ring_dtype, concat: bool) -> int:
    """Feature vectors of each of corr_mono2's staged windows, see
    `_fit_cap`."""
    return _fit_cap(lambda cap: mono2_smem_bytes(P, C, ring_dtype, cap, concat),
                    C, ring_dtype, SMEM_MAX - _PAIR_STATIC)


def corr_mono2_cuda(gmap, fmap1, fmap2, coords, kk, jj, levels=(1, 4),
                    scales=None, concat: bool = True) -> torch.Tensor:
    """Launch csrc/corr_mono2.cu: both levels, two edges a block. `concat`:
    gather each pair of windows into one buffer before its dots
    (CORR_KERNEL="mono2"), or read them where the copies landed ("mono4").
    Arguments and result otherwise as `corr_pyramid_cuda`; the plain version
    is ops/corr.corr_pyramid."""
    P, C = _patch_shape(gmap)
    cap = mono2_cap(P, C, fmap1.dtype, concat)
    return _staged_call(
        "corr_mono2", mono2_smem_bytes(P, C, fmap1.dtype, cap, concat),
        _PAIR_STATIC, cap, (int(concat),), gmap, (fmap1, fmap2), coords, kk,
        jj, levels, scales)


def mono3_smem_bytes(P: int, C: int, ring_dtype, cap: int, depth: int) -> int:
    """Dynamic shared memory of a corr_mono3 block: two slots of the f32 patch
    feature, of the product scratch (cap positions x P*P a level) and of the
    tap buffer, and `depth` stages of two windows with padded vectors."""
    PP = P * P
    return ((2 * PP * C + 4 * cap * PP + 4 * PP * _TAPS) * 4
            + depth * 2 * cap * _padded(C, ring_dtype))


def mono3_plan(P: int, C: int, ring_dtype):
    """(cap, depth) of corr_mono3: the window size that fits a ring of two
    stages (see `_fit_cap`), then as many stages, at most MONO3_MAX_DEPTH, as
    a block's shared memory holds at that size."""
    cap = _fit_cap(lambda cap: mono3_smem_bytes(P, C, ring_dtype, cap, 2), C,
                   ring_dtype, SMEM_MAX - _MONO3_STATIC)
    depth = 2
    while (depth < MONO3_MAX_DEPTH
           and mono3_smem_bytes(P, C, ring_dtype, cap, depth + 1)
           <= SMEM_MAX - _MONO3_STATIC):
        depth += 1
    return cap, depth


def mono3_run(E: int, device) -> int:
    """Consecutive edges a corr_mono3 block walks: at most MONO3_RUN, and
    such that the runs come to a whole number of rounds over the SMs of
    `device` (a block takes an SM to itself): E edges in k rounds of one run
    an SM, with the least k that keeps a run within MONO3_RUN."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rounds = max(1, -(-E // (sms * MONO3_RUN)))
    return max(1, -(-E // (sms * rounds)))


def corr_mono3_cuda(gmap, fmap1, fmap2, coords, kk, jj, levels=(1, 4),
                    scales=None) -> torch.Tensor:
    """Launch csrc/corr_mono3.cu: both levels from a per-edge product surface
    in shared memory. Arguments and result as `corr_pyramid_cuda`; the plain
    version is ops/corr.corr_pyramid."""
    P, C = _patch_shape(gmap)
    cap, depth = mono3_plan(P, C, fmap1.dtype)
    run = mono3_run(coords.shape[0], gmap.device) if gmap.is_cuda else 1
    return _staged_call(
        "corr_mono3", mono3_smem_bytes(P, C, fmap1.dtype, cap, depth),
        _MONO3_STATIC, cap, (depth, run), gmap, (fmap1, fmap2), coords, kk, jj,
        levels, scales)


def group_smem_bytes(P: int, C: int, ring_dtype, cap: int) -> int:
    """Dynamic shared memory of a corr_group block: two parities of two
    edges' f32 patch features and of their windows with padded vectors."""
    return 4 * P * P * C * 4 + 4 * cap * _padded(C, ring_dtype)


def group_cap(P: int, C: int, ring_dtype) -> int:
    """Positions of corr_group's staged window, see `_fit_cap`; an edge whose
    window has more keeps its taps in the surface instead."""
    return _fit_cap(lambda cap: group_smem_bytes(P, C, ring_dtype, cap), C,
                    ring_dtype, SMEM_MAX - _GROUP_STATIC)


_SURFACE_STEP = 256           # groups by which the cached surface grows
_surfaces = {}                # device -> the surface buffer of corr_group


def _surface(groups: int, device) -> torch.Tensor:
    """The first `groups` groups of the device's surface buffer, which is
    allocated once per size (rounded up to _SURFACE_STEP groups) and reused
    by every later call on the same stream order."""
    buf = _surfaces.get(device)
    if buf is None or buf.shape[0] < groups:
        n = -(-groups // _SURFACE_STEP) * _SURFACE_STEP
        _surfaces[device] = None               # release before allocating
        buf = torch.empty((n, plain.GROUP_ROWS, plain.GROUP_EDGES
                           * plain.GROUP_LANES), dtype=torch.bfloat16,
                          device=device)
        _surfaces[device] = buf
    return buf[:groups]


def group_surface_cuda(gmap, fmap, coords, kk, jj, scale=None):
    """Launch csrc/corr_group.cu, stage 1 of the grouped correlation of one
    level. Arguments as `corr_level_cuda` (the scale is checked and left to
    stage 2). Returns (surface, cap): the raw product surface
    (ceil(E / 8), GROUP_ROWS, 128) bf16, a view of a buffer that the next
    call overwrites, and the window capacity it was written with; the plain
    version is ops/corr.group_surface."""
    E, P, C, i8 = _check_call(gmap, (fmap,), (scale,), coords, kk, jj)
    _check(P * P <= 16, f"P={P}: the kernel's index table holds 16 pixels")
    _check(gmap.data_ptr() % 16 == 0, "gmap is not 16-byte aligned")
    cap = group_cap(P, C, fmap.dtype)
    _check(group_smem_bytes(P, C, fmap.dtype, cap) <= SMEM_MAX - _GROUP_STATIC,
           f"P={P}, C={C} needs more shared memory than a block can have")
    surface = _surface(-(-E // plain.GROUP_EDGES), gmap.device)
    if E == 0:
        return surface, cap
    lib = _load()
    code = lib.devo_corr_group(
        gmap.data_ptr(), fmap.data_ptr(), coords.data_ptr(), kk.data_ptr(),
        jj.data_ptr(), surface.data_ptr(), E, P * P, C, fmap.shape[1],
        fmap.shape[2], cap, plain.GROUP_ROWS,
        int(gmap.dtype == torch.bfloat16), int(i8),
        torch.cuda.current_stream(gmap.device).cuda_stream)
    _launched("corr_group", code)
    return surface, cap


def corr_group_cuda(gmap, fmap, coords, kk, jj, scale=None) -> torch.Tensor:
    """One pyramid level through the bf16 product surface: csrc/corr_group.cu
    (stage 1) and ops/corr.extract_blend_group (stage 2, plain tensor code on
    the device). Arguments and result as `corr_level_cuda`; the plain version
    is ops/corr.corr_level_group."""
    surface, cap = group_surface_cuda(gmap, fmap, coords, kk, jj, scale)
    return plain.extract_blend_group(surface, coords, jj, fmap.shape[1:3],
                                     scale, cap)


def resident_smem_bytes(h: int, w: int, C: int, P: int) -> int:
    """Dynamic shared memory of a corr_level_resident block: one int8
    (h, w, C) frame, and per warp the patch feature and the taps as f32."""
    PP = P * P
    return h * w * C + _RESIDENT_WARPS * (PP * C + PP * _TAPS) * 4


def resident_fits(h: int, w: int, C: int, P: int) -> bool:
    """Whether corr_level_resident takes an (h, w, C) int8 ring: the block's
    shared memory holds a frame, and the frame copies in 16-byte pieces."""
    return (C % 4 == 0 and (h * w * C) % 16 == 0
            and resident_smem_bytes(h, w, C, P) <= SMEM_MAX)


def corr_level_resident_cuda(gmap, fmap, coords, kk, jj, scale) -> torch.Tensor:
    """Launch csrc/corr_level_resident.cu: corr_level_cuda's function for an
    int8 ring small enough that one frame fits a block's shared memory
    (`resident_fits`). The edges are bucketed by ring slot on the device,
    without a host sync; every row of the output is written at its edge's
    own position."""
    _check(fmap.dtype == torch.int8 and scale is not None,
           "the resident kernel takes int8 rings with per-slot scales")
    E, P, C, _ = _check_call(gmap, (fmap,), (scale,), coords, kk, jj)
    mem, h, w, _ = fmap.shape
    _check(resident_fits(h, w, C, P),
           f"a {h}x{w}x{C} frame does not fit a block's shared memory")

    out = torch.empty((E, _FEATS * P * P), dtype=torch.float32,
                      device=gmap.device)
    if E == 0:
        return out
    by_slot = torch.sort(jj, stable=True)
    order = by_slot.indices.to(torch.int32)
    offsets = torch.searchsorted(
        by_slot.values,
        torch.arange(mem + 1, dtype=torch.int32, device=jj.device),
        out_int32=True)
    lib = _load()
    code = lib.devo_corr_level_resident(
        gmap.data_ptr(), fmap.data_ptr(), scale.data_ptr(), coords.data_ptr(),
        kk.data_ptr(), order.data_ptr(), offsets.data_ptr(), out.data_ptr(),
        E, mem, _RESIDENT_SPLIT, P * P, C, h, w,
        int(gmap.dtype == torch.bfloat16),
        torch.cuda.current_stream(gmap.device).cuda_stream)
    _launched("corr_level_resident", code)
    return out


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


def fixed_smem_bytes(P: int, C: int) -> int:
    """Dynamic shared memory of a corr_fixed block: the f32 patch feature,
    the f32 product surface of the 384 window positions, and a pixel's 64
    taps for every pixel, as f32."""
    PP = P * P
    return (PP * C + (_FIXED_POSITIONS + _TAPS) * PP) * 4


def corr_fixed_cuda(gmap, fmap, coords, kk, jj, scale=None) -> torch.Tensor:
    """Launch csrc/corr_fixed.cu, one pyramid level over a fixed 16x24 window
    an edge (CORR_IMPL="pallas"): gmap (Mring, P, P, C) and fmap
    (mem, h, w, C) both bf16 or both f32; coords (E, P, P, 2) f32 at this
    level's resolution; kk, jj (E,) int32. Returns (E, 49*P*P) f32 in
    [dx, dy, pixel] order; the plain version is ops/corr.corr_level."""
    E, P, C = _float_level_call(gmap, fmap, coords, kk, jj, scale)
    _check(fixed_smem_bytes(P, C) <= SMEM_MAX,
           f"P={P}, C={C} needs more shared memory than a block can have")
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


def group8_smem_bytes(P: int, C: int, ring_dtype, cap: int) -> int:
    """Dynamic shared memory of a corr_group8 block: two parities of two
    edges' f32 patch features, eight f32 surface slots of max(cap, 64)
    positions, and two parities of two windows with padded vectors."""
    PP = P * P
    return ((4 * PP * C + 8 * max(cap, _TAPS) * PP) * 4
            + 4 * cap * _padded(C, ring_dtype))


def group8_cap(P: int, C: int, ring_dtype) -> int:
    """Positions of corr_group8's staged windows; an edge whose window has
    more keeps its taps in its surface slot instead."""
    return _fit_cap(lambda cap: group8_smem_bytes(P, C, ring_dtype, cap), C,
                    ring_dtype, SMEM_MAX - _GROUP_STATIC)


def corr_group8_cuda(gmap, fmap, coords, kk, jj, scale=None) -> torch.Tensor:
    """Launch csrc/corr_group8.cu, one pyramid level, eight edges a block
    (CORR_KERNEL="g8"). Arguments and result as `corr_fixed_cuda`; the plain
    version is ops/corr.corr_level."""
    E, P, C = _float_level_call(gmap, fmap, coords, kk, jj, scale)
    cap = group8_cap(P, C, fmap.dtype)
    _check(group8_smem_bytes(P, C, fmap.dtype, cap) <= SMEM_MAX - _GROUP_STATIC,
           f"P={P}, C={C} needs more shared memory than a block can have")
    out = torch.empty((E, _FEATS * P * P), dtype=torch.float32,
                      device=gmap.device)
    if E == 0:
        return out
    lib = _load()
    code = lib.devo_corr_group8(
        gmap.data_ptr(), fmap.data_ptr(), coords.data_ptr(), kk.data_ptr(),
        jj.data_ptr(), out.data_ptr(), E, P * P, C, fmap.shape[1],
        fmap.shape[2], cap, int(gmap.dtype == torch.bfloat16),
        torch.cuda.current_stream(gmap.device).cuda_stream)
    _launched("corr_group8", code)
    return out


def full_smem_bytes(P: int, C: int, ring_dtype, cap: int, depth: int) -> int:
    """Dynamic shared memory of a corr_level_full block: `depth` window
    stages with padded vectors, and two slots each of the f32 patch
    feature, the f32 product surface (cap positions) and the tap buffer."""
    PP = P * P
    return ((2 * PP * C + 2 * cap * PP + 2 * PP * _TAPS) * 4
            + depth * cap * _padded(C, ring_dtype))


def full_plan(P: int, C: int, ring_dtype):
    """(cap, depth, blocks an SM) of corr_level_full: two blocks an SM where
    their shared memory holds full windows (LEVEL_WINDOW_CAP vectors) in a
    ring of two stages, else one; then as many stages, at most
    FULL_MAX_DEPTH, as that share holds."""
    for blocks in (2, 1):
        room = (_SMEM_SM // blocks - _SMEM_RESERVED if blocks > 1
                else SMEM_MAX) - _FULL_STATIC
        cap = _fit_cap(lambda cap: full_smem_bytes(P, C, ring_dtype, cap, 2),
                       C, ring_dtype, room)
        if cap == LEVEL_WINDOW_CAP or blocks == 1 or cap == 0:
            break
    depth = 2
    while (depth < FULL_MAX_DEPTH
           and full_smem_bytes(P, C, ring_dtype, cap, depth + 1) <= room):
        depth += 1
    return cap, depth, blocks


def full_knobs(P: int, C: int, ring_dtype, depth: int = None,
               run: int = None):
    """(cap, depth, blocks an SM) of corr_level_full: full_plan's, with
    `depth` in its place where given. Raises ValueError on a depth outside
    2 .. FULL_MAX_DEPTH or beyond a block's shared memory, and on a run
    below 1."""
    cap, plan_depth, blocks = full_plan(P, C, ring_dtype)
    depth = plan_depth if depth is None else depth
    if not 2 <= depth <= FULL_MAX_DEPTH:
        raise ValueError(f"depth must be 2 to {FULL_MAX_DEPTH}, got {depth}")
    if run is not None and run < 1:
        raise ValueError(f"run must be at least 1, got {run}")
    if full_smem_bytes(P, C, ring_dtype, cap, depth) > SMEM_MAX - _FULL_STATIC:
        raise ValueError(f"P={P}, C={C} with a ring of {depth} stages needs "
                         f"more shared memory than a block can have")
    return cap, depth, blocks


def full_run(E: int, device, blocks: int) -> int:
    """Consecutive edges a corr_level_full block walks: at most FULL_RUN, and
    such that the runs come to a whole number of rounds over the `blocks`
    blocks an SM of `device` holds (as `mono3_run`)."""
    slots = blocks * torch.cuda.get_device_properties(device).multi_processor_count
    rounds = max(1, -(-E // (slots * FULL_RUN)))
    return max(1, -(-E // (slots * rounds)))


def corr_level_full_cuda(gmap, fmap, coords, kk, jj, scale=None,
                         stage: str = "full", depth: int = None,
                         run: int = None) -> torch.Tensor:
    """Launch csrc/corr_level_full.cu, one pyramid level
    (CORR_KERNEL="full"). Arguments and result as `corr_fixed_cuda`; the
    plain version is ops/corr.corr_level. `stage` picks the kernel's
    instance: "full" (the correlation) or one that skips a part of it to
    time the rest, "noext" (no extraction), "nomm" (no product), "noDMA" (no
    copy); those write what ops/corr.corr_level_stage defines. `depth` (2 ..
    FULL_MAX_DEPTH, as many as a block's shared memory holds) and `run` (at
    least 1) override full_plan's ring depth and full_run's edges a block,
    for tuning."""
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
        run or full_run(E, gmap.device, blocks), plain.STAGES.index(stage),
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
