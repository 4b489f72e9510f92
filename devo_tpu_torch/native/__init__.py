"""ctypes bindings of the native event frontend (the port's own copy of
devo_tpu/native).

`voxelizer.cpp` is built with g++ into devo_tpu_torch/_build/ at first use
(one library per hash of the source, the command and the host's CPU, since
-march=native compiles for the CPU at hand; written under a temporary name
and renamed, so that concurrent first uses do not race) and
exposes numpy-friendly wrappers. Where no compiler is available, or the
build fails, the wrappers fall back to the NumPy implementations of
data/event_utils.py and the reason is printed once; `available()` says
which path runs, and `build_error()` why the native one does not.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import platform
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "voxelizer.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"
_CMD = ("g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib = None
_error: Optional[str] = None


def _host_cpu() -> str:
    """The CPU that -march=native compiles for: its model and flags."""
    try:
        with open("/proc/cpuinfo") as f:
            return "".join(line for line in f
                           if line.startswith(("model name", "flags")))[:4096]
    except OSError:
        return platform.processor() or platform.machine()


def _build() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_CMD).encode()
                            + _host_cpu().encode())
    lib = BUILD_DIR / f"libdevo_voxelizer_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp"
    res = subprocess.run(list(_CMD) + [str(_SRC), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exited {res.returncode}: {res.stderr[-2000:]}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, RuntimeError) as e:
        _error = str(e)
        sys.stderr.write(f"devo_tpu_torch.native: build failed ({_error}); "
                         "using the NumPy path\n")
        return None
    lib.voxelize.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.ms_to_idx.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.window_offsets.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    lib.remove_hot_pixels.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float]
    lib.quantize_i8.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int8)]
    lib.quantize_i8.restype = ctypes.c_float
    for fn in (lib.voxelize, lib.ms_to_idx, lib.window_offsets,
               lib.remove_hot_pixels):
        fn.restype = None
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native library is built and loaded."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the native library is not available, or None."""
    _load()
    return _error


def _cptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def to_voxel_grid(x, y, t, p, H: int, W: int, bins: int = 5,
                  rectify_map=None) -> np.ndarray:
    """Native trilinear event splat; the contract of
    data/event_utils.to_voxel_grid."""
    lib = _load()
    if lib is None:
        from devo_tpu_torch.data.event_utils import to_voxel_grid as np_voxelize
        return np_voxelize(x, y, t, p, H, W, bins, rectify_map)

    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    t = np.ascontiguousarray(t, np.int64)
    p = np.ascontiguousarray(p, np.int8)
    if not x.ndim == 1 or not x.shape == y.shape == t.shape == p.shape:
        raise ValueError(f"events of shapes {x.shape}, {y.shape}, {t.shape}, "
                         f"{p.shape}: expected four of one length")
    out = np.empty((bins, H, W), np.float32)
    rm = None
    if rectify_map is not None:
        rm = np.ascontiguousarray(rectify_map, np.float32)
        if rm.shape != (H, W, 2):        # the C code reads it at (y, x)
            raise ValueError(f"rectify_map of shape {rm.shape}, expected "
                             f"{(H, W, 2)}")
    lib.voxelize(_cptr(x, ctypes.c_float), _cptr(y, ctypes.c_float),
                 _cptr(t, ctypes.c_int64), _cptr(p, ctypes.c_int8),
                 len(x), bins, H, W,
                 rm.ctypes.data_as(ctypes.c_void_p) if rm is not None else None,
                 _cptr(out, ctypes.c_float))
    return out


def compute_ms_to_idx(t_us: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        from devo_tpu_torch.data.event_utils import compute_ms_to_idx as np_msidx
        return np_msidx(t_us)
    t_us = np.ascontiguousarray(t_us, np.int64)
    n_ms = math.ceil(int(t_us[-1]) / 1000) + 1 if t_us.size else 1
    out = np.empty((n_ms,), np.int64)
    lib.ms_to_idx(_cptr(t_us, ctypes.c_int64), len(t_us), n_ms,
                  _cptr(out, ctypes.c_int64))
    return out


def quantize_i8(v: np.ndarray):
    """(int8 array, float scale) such that v ~= out * scale, in two fused
    passes over v."""
    lib = _load()
    if lib is None:
        v = np.asarray(v, np.float32)
        m = float(np.max(np.abs(v))) if v.size else 0.0
        scale = m / 127.0 if m > 0 else 1.0
        return np.clip(np.rint(v / scale), -127, 127).astype(np.int8), scale
    v = np.ascontiguousarray(v, np.float32)
    out = np.empty(v.shape, np.int8)
    scale = lib.quantize_i8(_cptr(v, ctypes.c_float), v.size,
                            _cptr(out, ctypes.c_int8))
    return out, float(scale)


def remove_hot_pixels(vox: np.ndarray, num_stds: float = 10.0) -> np.ndarray:
    lib = _load()
    if lib is None:
        from devo_tpu_torch.data.event_utils import remove_hot_pixels_voxel
        return remove_hot_pixels_voxel(vox, num_stds)
    # always copy: the C++ filters in place, and for a contiguous f32 input
    # ascontiguousarray would alias the caller's array, which the NumPy path
    # never mutates
    vox = np.array(vox, np.float32, order="C", copy=True)
    if vox.ndim != 3:
        raise ValueError(f"a (bins, H, W) voxel, got shape {vox.shape}")
    lib.remove_hot_pixels(_cptr(vox, ctypes.c_float), vox.shape[0],
                          vox.shape[1], vox.shape[2], num_stds)
    return vox
