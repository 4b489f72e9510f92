"""Event stream primitives (host side).

NumPy counterpart of upstream DEVO's utils/event_utils.py: `EventSlicer`
(millisecond-indexed windowed queries over HDF5 event streams), trilinear
event-to-voxel-grid splatting, hot-pixel filtering, and ms_to_idx
construction. The reference accelerates the offset search with numba; here
the search is vectorized NumPy. The port's own copy of
devo_tpu/data/event_utils.py; that package's optional C++ voxelizer
(devo_tpu/native) is not carried over yet.

Event storage convention (as produced by the pp_* preprocessing scripts):
an HDF5 file with datasets events/{x, y, t, p} (t in microseconds) and an
optional ms_to_idx index, plus an optional t_offset.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

try:  # h5py is baked in; guard anyway for minimal installs
    import h5py
except Exception:  # pragma: no cover
    h5py = None


class EventSlicer:
    """Windowed event queries via the ms_to_idx index
    (event_utils.py:13-176)."""

    def __init__(self, h5f):
        self.h5f = h5f
        self.events: Dict[str, "h5py.Dataset"] = {}
        for dset_str in ["p", "x", "y", "t"]:
            self.events[dset_str] = self.h5f[f"events/{dset_str}"]
        if "ms_to_idx" in self.h5f:
            self.ms_to_idx = np.asarray(self.h5f["ms_to_idx"], np.int64)
        else:
            self.ms_to_idx = compute_ms_to_idx(np.asarray(self.events["t"]))
        self.t_offset = int(self.h5f["t_offset"][()]) if "t_offset" in self.h5f else 0
        self.t_final = int(self.events["t"][-1]) + self.t_offset

    def get_start_time_us(self) -> int:
        return self.t_offset

    def get_final_time_us(self) -> int:
        return self.t_final

    def get_events(self, t_start_us: int, t_end_us: int) -> Optional[Dict[str, np.ndarray]]:
        """All events in [t_start_us, t_end_us). Returns None if the window
        falls outside the stream (event_utils.py:53-90)."""
        assert t_start_us < t_end_us
        t_start_us -= self.t_offset
        t_end_us -= self.t_offset

        t_start_ms, t_end_ms = self.get_conservative_window_ms(t_start_us, t_end_us)
        # windows starting before the stream's t_offset clamp to stream
        # start (reference event_utils.py:70) — common for the first EDS
        # image stamps; without this ms2idx's time_ms >= 0 assert fires
        t_start_ms = max(t_start_ms, 0)
        t_start_ms_idx = self.ms2idx(t_start_ms)
        t_end_ms_idx = self.ms2idx(t_end_ms)
        if t_start_ms_idx is None or t_end_ms_idx is None:
            return None

        time_array_conservative = np.asarray(
            self.events["t"][t_start_ms_idx:t_end_ms_idx])
        idx_start_offset, idx_end_offset = self.get_time_indices_offsets(
            time_array_conservative, t_start_us, t_end_us)
        t_start_us_idx = t_start_ms_idx + idx_start_offset
        t_end_us_idx = t_start_ms_idx + idx_end_offset

        events = {"t": time_array_conservative[idx_start_offset:idx_end_offset]
                  + self.t_offset}
        for dset_str in ["p", "x", "y"]:
            events[dset_str] = np.asarray(
                self.events[dset_str][t_start_us_idx:t_end_us_idx])
            if events[dset_str].size != events["t"].size:
                return None
        return events

    @staticmethod
    def get_conservative_window_ms(ts_start_us: int, ts_end_us: int) -> Tuple[int, int]:
        assert ts_end_us > ts_start_us
        return math.floor(ts_start_us / 1000), math.ceil(ts_end_us / 1000)

    @staticmethod
    def get_time_indices_offsets(time_array: np.ndarray, t_start: int, t_end: int):
        """Vectorized replacement of the numba-jit search
        (event_utils.py:112-170): first index >= t_start, first >= t_end."""
        lo = int(np.searchsorted(time_array, t_start, side="left"))
        hi = int(np.searchsorted(time_array, t_end, side="left"))
        return lo, hi

    def ms2idx(self, time_ms: int) -> Optional[int]:
        assert time_ms >= 0
        if time_ms >= self.ms_to_idx.size:
            return None
        return int(self.ms_to_idx[time_ms])


def compute_ms_to_idx(t_us: np.ndarray) -> np.ndarray:
    """ms_to_idx[ms] = min { i : t[i] >= ms * 1000 } (event_utils.py:263-282)."""
    n_ms = math.ceil(int(t_us[-1]) / 1000) + 1 if t_us.size else 1
    edges = np.arange(n_ms, dtype=np.int64) * 1000
    return np.searchsorted(t_us, edges, side="left").astype(np.int64)


def to_voxel_grid(
    x: np.ndarray, y: np.ndarray, t: np.ndarray, p: np.ndarray,
    H: int, W: int, nb_of_time_bins: int = 5,
    rectify_map: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Trilinear splat of an event window into a (bins, H, W) voxel grid
    (event_utils.py:180-232). Polarity contributes +-1; timestamps are
    normalized to [0, bins-1]; x/y/t each split bilinearly over the two
    neighboring cells. Optionally applies a rectify map (undistortion lookup
    per original pixel) before splatting.
    """
    vox = np.zeros((nb_of_time_bins, H, W), np.float32)
    if x.size == 0:
        return vox

    t = t.astype(np.float64)
    duration = max(float(t[-1] - t[0]), 1e-9)
    t_norm = (t - t[0]) / duration * (nb_of_time_bins - 1)

    if rectify_map is not None:
        xy = rectify_map[y.astype(np.int64), x.astype(np.int64)]
        xf = xy[..., 0].astype(np.float64)
        yf = xy[..., 1].astype(np.float64)
    else:
        xf = x.astype(np.float64)
        yf = y.astype(np.float64)

    pol = p.astype(np.float32)
    pol = np.where(pol > 0, 1.0, -1.0).astype(np.float32)

    x0 = np.floor(xf)
    y0 = np.floor(yf)
    t0 = np.floor(t_norm)
    wx = (xf - x0).astype(np.float32)
    wy = (yf - y0).astype(np.float32)
    wt = (t_norm - t0).astype(np.float32)

    flat = vox.reshape(-1)
    for dt in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi = x0 + dx
                yi = y0 + dy
                ti = t0 + dt
                wgt = (pol
                       * (wx if dx else 1 - wx)
                       * (wy if dy else 1 - wy)
                       * (wt if dt else 1 - wt))
                ok = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
                      & (ti >= 0) & (ti < nb_of_time_bins))
                idx = (ti[ok].astype(np.int64) * H + yi[ok].astype(np.int64)) * W \
                    + xi[ok].astype(np.int64)
                np.add.at(flat, idx, wgt[ok])
    return vox


def remove_hot_pixels_voxel(vox: np.ndarray, num_stds: float = 10.0) -> np.ndarray:
    """Zero ELEMENTS whose |value| exceeds mean + num_stds * std of the raw
    SIGNED voxel (event_utils.py:243-260: the reference thresholds each
    (bin, y, x) element against the statistics of the signed flattened
    voxel and zeroes elements individually — not whole pixels against
    bin-sum statistics, which selects a substantially different hot set).
    std is the unbiased (ddof=1) estimate like torch.std."""
    v = np.asarray(vox)
    mean = v.mean()
    std = v.std(ddof=1) if v.size > 1 else 0.0
    out = v.copy()
    out[np.abs(v) > mean + num_stds * std] = 0.0
    return out
