"""The engine's correlation entry point, and the bindings of the CUDA
kernels in csrc/.

`corr_pyramid` takes the plain PyTorch versions (ops/corr.py) for tensors on
the CPU and launches a kernel for tensors on a CUDA device; there is no
fallback from one to the other. Five kernels, one launch counter each
(`launches`):

- `corr_pyramid_cuda` (csrc/corr.cu): both pyramid levels in one launch,
  one warp per tap reading the ring;
- `corr_level_cuda` (csrc/corr_level.cu): one level per launch;
- `corr_level_resident_cuda` (csrc/corr_level_resident.cu): level 4 from an
  int8 ring slot held in a block's shared memory;
- `corr_pair_cuda` (csrc/corr_pair.cu): both levels in one launch, a block
  per edge, the patch feature shared by the levels and each level's window
  staged by its own group of asynchronous copies;
- `corr_pair2_cuda` (csrc/corr_pair2.cu): the same by persistent blocks that
  keep the next edge's windows in flight while they compute the current one.

All take float rings (bf16 or f32, the type of the patch features) or, with
per-slot scales, int8 rings; the resident kernel int8 only. The sources are
compiled together by one `nvcc` call for sm_90a into devo_tpu_torch/_build/
at first use (a shared library with a plain C interface, loaded with
ctypes), once per version of the sources.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import corr as plain

# launches of each kernel, counted so a run can show it went through them
launches = {"corr_pyramid": 0, "corr_level": 0, "corr_level_resident": 0,
            "corr_pair": 0, "corr_pair2": 0}

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
    version of the sources is built already. Returns the library's path;
    ptxas's register and shared memory report is kept beside it with the
    suffix .log."""
    digest = hashlib.sha256()
    for src in sources():
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    lib = BUILD_DIR / f"libdevo_corr_{digest.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xptxas=-v", "--threads", "0", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(tmp)]
    cmd += [str(s) for s in sources() if s.suffix == ".cu"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    lib.with_suffix(".log").write_text(res.stdout + res.stderr)
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
        for fn in (lib.devo_corr_pyramid, lib.devo_corr_level,
                   lib.devo_corr_level_resident, lib.devo_corr_pair,
                   lib.devo_corr_pair2, lib.devo_corr_pair2_blocks_per_sm):
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


def pair_cap(name: str, P: int, C: int, gmap_dtype, ring_dtype) -> int:
    """Feature vectors of each staged window of the pair kernel `name`
    ("corr_pair" or "corr_pair2"): LEVEL_WINDOW_CAP, fewer where a block's
    shared memory holds no more, and 0 (every tap reads the ring) where a
    feature vector is no multiple of the 16-byte copies."""
    if C * _item(ring_dtype) % 16 != 0:
        return 0
    fixed = _pair_smem(name, P, C, gmap_dtype, ring_dtype, 0)
    per_vector = _pair_smem(name, P, C, gmap_dtype, ring_dtype, 1) - fixed
    room = SMEM_MAX - _PAIR_STATIC - fixed
    return max(0, min(LEVEL_WINDOW_CAP, room // per_vector))


def _pair_call(name, gmap, fmap1, fmap2, coords, kk, jj, levels, scales):
    """The checks, the output and the launch that corr_pair and corr_pair2
    share; `name` is the kernel's launch counter."""
    scales = (None, None) if scales is None else tuple(scales)
    _check(len(levels) == 2 and len(scales) == 2,
           "the kernel computes two levels")
    E, P, C, i8 = _check_call(gmap, (fmap1, fmap2), scales, coords, kk, jj)
    _check(P * P <= 16, f"P={P}: the kernel's index table holds 16 pixels")
    for t_name, t in (("gmap", gmap), ("coords", coords)):
        _check(t.data_ptr() % 16 == 0, f"{t_name} is not 16-byte aligned")
    cap = pair_cap(name, P, C, gmap.dtype, fmap1.dtype)
    _check(_pair_smem(name, P, C, gmap.dtype, fmap1.dtype, cap)
           <= SMEM_MAX - _PAIR_STATIC,
           f"P={P}, C={C} needs more shared memory than a block can have")

    out = torch.empty((E, 2 * _FEATS * P * P), dtype=torch.float32,
                      device=gmap.device)
    if E == 0:
        return out
    lib = _load()
    code = getattr(lib, "devo_" + name)(
        gmap.data_ptr(), fmap1.data_ptr(), fmap2.data_ptr(),
        _ptr(scales[0]), _ptr(scales[1]), coords.data_ptr(), kk.data_ptr(),
        jj.data_ptr(), out.data_ptr(), E, P * P, C, fmap1.shape[1],
        fmap1.shape[2], fmap2.shape[1], fmap2.shape[2], cap,
        float(levels[0]), float(levels[1]),
        int(gmap.dtype == torch.bfloat16), int(i8),
        torch.cuda.current_stream(gmap.device).cuda_stream)
    _launched(name, code)
    return out


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


KERNELS = ("mono", "split", "pair", "pair2")
# the kernels that take both levels in one launch
_TWO_LEVEL = {"mono": corr_pyramid_cuda, "pair": corr_pair_cuda,
              "pair2": corr_pair2_cuda}


def corr_pyramid(gmap, pyramid, coords, kk, jj, radius: int = 3,
                 levels=(1, 4), scales=None, kernel: str = "mono",
                 resident: bool = False) -> torch.Tensor:
    """Two-level correlation feature (E, 2*49*P*P) f32 in [dx, dy, pixel,
    level] order: the plain versions for CPU tensors, the CUDA kernels for
    CUDA tensors. `scales`: per level the (mem,) f32 scales of an int8 ring.
    `kernel`: "mono", "pair", "pair2" = both levels in one launch, by
    corr.cu, corr_pair.cu, corr_pair2.cu; "split" = one launch per level,
    and with `resident` the last level from the resident-ring kernel (int8
    rings only)."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if resident and (kernel != "split" or scales is None):
        raise ValueError("the resident level needs kernel='split' and int8 "
                         "rings with scales")
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
    if scales is None:
        scales = (None,) * len(pyramid)
    outs = []
    for n, (fmap, lvl, scale) in enumerate(zip(pyramid, levels, scales)):
        at_level = coords / lvl
        if gmap.device.type == "cpu":
            fn = plain.corr_level
        elif resident and n == len(pyramid) - 1:
            fn = corr_level_resident_cuda
        else:
            fn = corr_level_cuda
        outs.append(fn(gmap, fmap, at_level, kk, jj, scale))
    return plain.stack_levels(outs)
