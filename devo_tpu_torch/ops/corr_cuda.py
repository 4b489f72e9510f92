"""The engine's correlation entry point, and the binding of the CUDA kernel
in csrc/corr.cu.

`corr_pyramid` takes the plain PyTorch version (ops/corr.py) for tensors on
the CPU and launches the kernel for tensors on a CUDA device; there is no
fallback from one to the other. The kernel is compiled by `nvcc` for sm_90a
into devo_tpu_torch/_build/ at first use (a shared library with a plain C
interface, loaded with ctypes), once per version of the source.
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

# launches of the kernel, counted so a run can show it went through it
launches = 0

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "corr.cu"
BUILD_DIR = _PKG / "_build"
_RADIUS = 3
_SMEM_LIMIT = 48 * 1024     # the default dynamic shared memory of a block
_lib = None


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build() -> Path:
    """Compile csrc/corr.cu for sm_90a unless this version of the source is
    built already. Returns the library's path; ptxas's register and shared
    memory report is kept beside it with the suffix .log."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libdevo_corr_{tag}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
           "-o", str(tmp), str(SOURCE)]
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
        lib.devo_corr_pyramid.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
            + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
        lib.devo_corr_pyramid.restype = ctypes.c_int
        lib.devo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.devo_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"corr kernel: {msg}")


def corr_pyramid_cuda(gmap, fmap1, fmap2, coords, kk, jj,
                      levels=(1, 4)) -> torch.Tensor:
    """Launch the kernel: gmap (Mring, P, P, C), fmap1 (mem, h1, w1, C),
    fmap2 (mem, h2, w2, C), one dtype (bf16 or f32); coords (E, P, P, 2)
    f32 at level-1 resolution; kk, jj (E,) int32 ring indices. Returns
    (E, 2*49*P*P) f32 in [dx, dy, pixel, level] order."""
    global launches
    dev = gmap.device
    tensors = dict(gmap=gmap, fmap1=fmap1, fmap2=fmap2, coords=coords,
                   kk=kk, jj=jj)
    for name, t in tensors.items():
        _check(t.is_cuda and t.device == dev, f"{name} is not on {dev}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
    _check(gmap.dtype in (torch.bfloat16, torch.float32),
           f"features must be bf16 or f32, got {gmap.dtype}")
    _check(fmap1.dtype == gmap.dtype and fmap2.dtype == gmap.dtype,
           "gmap and the rings differ in dtype")
    _check(coords.dtype == torch.float32, "coords must be f32")
    _check(kk.dtype == torch.int32 and jj.dtype == torch.int32,
           "kk and jj must be int32")
    _check(gmap.ndim == 4 and gmap.shape[1] == gmap.shape[2],
           f"gmap must be (M, P, P, C), got {tuple(gmap.shape)}")
    _, P, _, C = gmap.shape
    E = coords.shape[0]
    _check(fmap1.ndim == 4 and fmap2.ndim == 4
           and fmap1.shape[-1] == C and fmap2.shape[-1] == C
           and fmap1.shape[0] == fmap2.shape[0],
           "rings must be (mem, h, w, C) with gmap's C")
    _check(tuple(coords.shape) == (E, P, P, 2),
           f"coords must be ({E}, {P}, {P}, 2), got {tuple(coords.shape)}")
    _check(tuple(kk.shape) == (E,) and tuple(jj.shape) == (E,),
           "kk and jj must be (E,)")
    _check(C % 2 == 0, f"C must be even, got {C}")
    _check(len(levels) == 2, "the kernel computes two levels")
    PP = P * P
    _check((PP * C + 2 * PP * (2 * _RADIUS + 2) ** 2) * 4 <= _SMEM_LIMIT,
           f"P={P}, C={C} needs more shared memory than a block gets")

    out = torch.empty((E, 2 * (2 * _RADIUS + 1) ** 2 * PP),
                      dtype=torch.float32, device=dev)
    if E == 0:
        return out
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.devo_corr_pyramid(
        gmap.data_ptr(), fmap1.data_ptr(), fmap2.data_ptr(),
        coords.data_ptr(), kk.data_ptr(), jj.data_ptr(), out.data_ptr(),
        E, PP, C, fmap1.shape[1], fmap1.shape[2], fmap2.shape[1],
        fmap2.shape[2], float(levels[0]), float(levels[1]),
        int(gmap.dtype == torch.bfloat16), stream)
    if code != 0:
        raise RuntimeError(f"corr kernel launch failed: "
                           f"{lib.devo_cuda_error_string(code).decode()}")
    launches += 1
    return out


def corr_pyramid(gmap, pyramid, coords, kk, jj, radius: int = 3,
                 levels=(1, 4)) -> torch.Tensor:
    """Two-level correlation feature (E, 2*49*P*P) f32: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    if gmap.device.type == "cpu":
        return plain.corr_pyramid(gmap, pyramid, coords, kk, jj, radius,
                                  levels)
    _check(radius == _RADIUS, f"the kernel is built for radius {_RADIUS}")
    _check(len(pyramid) == 2, "the kernel computes two levels")
    return corr_pyramid_cuda(gmap, pyramid[0], pyramid[1], coords, kk, jj,
                             levels)
