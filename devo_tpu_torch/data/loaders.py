"""Benchmark data iterators (host side).

Counterpart of upstream DEVO's utils/load_utils.py (1290 LoC): each function
yields (voxel (bins,H,W) float32, intrinsics (4,), timestamp_s) for one
sequence of a benchmark, slicing raw events around image/pose timestamps,
rectifying, and splatting to voxel grids. Ground-truth loaders return
(tss (N,), poses (N,7) [t, q xyzw]).

Directory conventions follow the reference's preprocessing scripts
(scripts/pp_*.py): per sequence an events h5 (events/{x,y,t,p} + ms_to_idx),
`rectify_map*.h5` (H, W, 2) float, `calib_undist*.json` with intrinsics, and
timestamped image/GT text files in microseconds.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from .event_utils import EventSlicer, remove_hot_pixels_voxel, to_voxel_grid

try:
    import h5py
except Exception:  # pragma: no cover
    h5py = None


def load_intrinsics_json(path: str) -> np.ndarray:
    with open(path) as f:
        calib = json.load(f)
    if isinstance(calib, dict):
        for key in ("intrinsics_undistorted", "intrinsics", "cam0"):
            if key in calib:
                calib = calib[key]
                break
    if isinstance(calib, list):
        calib = calib[0]
    fx = calib.get("fx", calib.get("focal_x"))
    fy = calib.get("fy", calib.get("focal_y"))
    cx = calib.get("cx", calib.get("center_x"))
    cy = calib.get("cy", calib.get("center_y"))
    return np.asarray([fx, fy, cx, cy], np.float32)


def load_rectify_map(path: str) -> np.ndarray:
    with h5py.File(path, "r") as f:
        return np.asarray(f["rectify_map"])


def load_intrinsics_txt(path: str) -> np.ndarray:
    """Single-line 'fx fy cx cy' sidecar (calib_undist*.txt — the format
    pp_hku.py:88 / pp_rpg.py:139 / preprocess.save_calib_undist_txt write)."""
    v = np.loadtxt(path).reshape(-1)
    return np.asarray(v[:4], np.float32)


def load_tum_traj(path: str, tss_unit: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """TUM format: t x y z qx qy qz qw (one pose per line)."""
    data = np.loadtxt(path, comments="#")
    tss = data[:, 0] * tss_unit
    # eval/ate.associate() searchsorts the GT stamps (same contract the
    # reference loaders assert, load_utils.py:616)
    assert np.all(np.diff(tss) >= 0), f"{path}: stamps not sorted"
    poses = data[:, 1:8].astype(np.float32)
    return tss, poses


def event_window_iterator(
    events_h5: str,
    tss_imgs_us: np.ndarray,
    intrinsics: np.ndarray,
    H: int,
    W: int,
    rectify_map: Optional[np.ndarray] = None,
    bins: int = 5,
    dT_ms: Optional[float] = None,
    hotpixel_filter: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
    """Generic event-benchmark iterator (pattern of load_utils.py:184-260):
    for each image timestamp, voxelize events in [ts, ts + dT] where dT is
    half the mean frame spacing by default (load_utils.py:198)."""
    if dT_ms is None:
        dT_ms = float(np.mean(np.diff(tss_imgs_us))) / 1e3 / 2.0

    with h5py.File(events_h5, "r") as f:
        slicer = EventSlicer(f)
        for ts_us in tss_imgs_us:
            ev = slicer.get_events(int(ts_us), int(ts_us + dT_ms * 1e3))
            if ev is None or ev["t"].size < 2:
                continue
            vox = to_voxel_grid(ev["x"], ev["y"], ev["t"], ev["p"], H, W,
                                bins, rectify_map=rectify_map)
            if hotpixel_filter:
                vox = remove_hot_pixels_voxel(vox)
            yield vox, intrinsics, float(ts_us) / 1e6


def voxel_h5_iterator(
    voxel_dir: str,
    intrinsics: np.ndarray,
    tss_us: Optional[np.ndarray] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
    """Pre-voxelized h5 sequence (TartanAir-EVS, load_utils.py:439-490):
    one h5 per frame with a 'voxel' dataset (float16, (bins, H, W))."""
    files = sorted(glob.glob(os.path.join(voxel_dir, "*.h5")))
    for i, fn in enumerate(files):
        with h5py.File(fn, "r") as f:
            vox = np.asarray(f["voxel"], np.float32)
        ts = float(tss_us[i]) / 1e6 if tss_us is not None else float(i)
        yield vox, intrinsics, ts


# ------------------------------------------------------------- benchmarks

def _seq_paths(indir: str, side: str = "left"):
    ev = None
    for pat in (f"events_{side}.h5", "events.h5", f"evs_{side}.h5", "evs.h5"):
        cand = os.path.join(indir, pat)
        if os.path.exists(cand):
            ev = cand
            break
    def first(*patterns):
        # explicit preferred names first, then any suffixed sidecar the
        # pp scripts write (rectify_map_calib1.h5, calib_undist_calib0.json,
        # ... — suffix per dataset, preprocess.py `suffix=`)
        for pat in patterns:
            hits = sorted(glob.glob(os.path.join(indir, pat)))
            if hits:
                return hits[0]
        return None

    rect = first(f"rectify_map_{side}.h5", "rectify_map_calib0.h5",
                 "rectify_map.h5", "rectify_map*.h5")
    calib = first("calib_undist.json", f"calib_undist_{side}.json",
                  "calib.json", "calib_undist*.json", "calib_undist.txt",
                  f"calib_undist_{side}.txt", "calib_undist*.txt")
    return ev, rect, calib


def make_evs_iterator(indir: str, H: int, W: int, side: str = "left",
                      stride: int = 1, timing: bool = False, bins: int = 5):
    """Benchmark-agnostic event iterator: works for EDS / RPG / HKU / VECtor /
    TUM-VIE / FPV / MVSEC sequences preprocessed by scripts/pp_*.py."""
    ev, rect, calib = _seq_paths(indir, side)
    if ev is None:
        raise FileNotFoundError(f"no events h5 under {indir}")
    if calib is None:
        # the engine cannot track without intrinsics — fail at setup, not
        # deep inside the first jitted step
        raise FileNotFoundError(
            f"no calib_undist sidecar under {indir} (run scripts/pp_*.py)")
    intr = (load_intrinsics_txt(calib) if calib.endswith(".txt")
            else load_intrinsics_json(calib))
    rect_map = load_rectify_map(rect) if rect else None
    if rect_map is None:
        # legitimate for simulated/pre-rectified trees, but silent on a raw
        # distorted sequence it means garbage tracking — say so once
        import sys
        print(f"[loaders] {indir}: no rectify_map*.h5 — assuming events are "
              "already rectified", file=sys.stderr)

    ts_file = os.path.join(indir, "images_timestamps_us.txt")
    if os.path.exists(ts_file):
        tss_us = np.loadtxt(ts_file)
    else:
        with h5py.File(ev, "r") as f:
            sl = EventSlicer(f)
            t0, t1 = sl.get_start_time_us(), sl.get_final_time_us()
        tss_us = np.arange(t0, t1, 1e6 / 30.0)  # synthesize 30 Hz windows
    tss_us = tss_us[::stride]
    return event_window_iterator(ev, tss_us, intr, H, W, rect_map, bins=bins)


BENCHMARK_RES = {
    # (H, W) of the event camera per benchmark (load_utils.py per-iterator)
    "eds": (480, 640),
    "tumvie": (720, 1280),
    "fpv": (260, 346),
    "mvsec": (260, 346),
    "rpg": (180, 240),
    "ecd": (180, 240),
    "hku": (260, 346),
    "vector": (480, 640),
    "tartanair": (480, 640),
}


def benchmark_iterator(name: str, indir: str, **kw):
    H, W = BENCHMARK_RES[name.lower()]
    return make_evs_iterator(indir, H, W, **kw)
