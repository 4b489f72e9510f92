"""Evaluation of the frame-input families (counterpart of
evals/common_frames.py, after upstream DEVO's evals/eval_rgb, eval_e2v and
eval_evs_frame).

Intensity frames (camera RGB, E2VID reconstructions, or rendered event
frames) run through the engine in frame mode: cfg.EVS=False, a 3-channel
encoder and the frames scaled to [-0.5, 1.5] (devo.py:395), with the
random patch selector. The three families differ only in the directory of
images they read.

    python -m devo_tpu_torch.eval.cli eds --family rgb --datapath <dir> \\
        --weights <frame model state dict> --val_split ... --trials 5

A scene holds `calib_undist.txt` (fx fy cx cy, written by the benchmark's
preprocessor), `stamped_groundtruth_us.txt`, optionally
`images_timestamps_us.txt`, and the family's directory of PNG / JPG files.
Reading images needs cv2, imported when the first frame is read.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from devo_tpu_torch.runtime.config import EVAL_CONFIGS, VOConfig

# family -> the scene's directory of images (eval_e2v/eval_eds_e2v.py:41-50)
FAMILIES = {"rgb": "images_undistorted_calib0", "e2v": "e2v",
            "evs_frame": "evs_frames"}


def frame_config() -> VOConfig:
    """The frame drivers' configuration: every reference frame driver
    merges default_rgb.yaml (DPVO's settings: an optimization window of
    15, a keyframe threshold of 15, the random selector) whatever the
    benchmark's event-mode threshold (evals/common_frames.py:71-74)."""
    return EVAL_CONFIGS["default"].replace(
        EVS=False, BINS=3, PATCH_SELECTOR="random", NORM="none",
        SCORER_EVAL_MODE="random", SCORER_EVAL_USE_GRID=False,
        OPTIMIZATION_WINDOW=15, KEYFRAME_THRESH=15.0)


def frame_iterator(imgdir: str, intrinsics, stride: int = 1):
    """Yields (frame (3, H, W) f32 in 0-255, intrinsics, timestamp s) for
    the PNG and JPG files of `imgdir` in name order, every `stride`-th;
    timestamps from the scene's images_timestamps_us.txt where there is
    one, else the frame's index. A grey image is repeated over 3
    channels."""
    import cv2

    files = sorted(glob.glob(os.path.join(imgdir, "*.png"))
                   + glob.glob(os.path.join(imgdir, "*.jpg")))[::stride]
    tss = None
    ts_file = os.path.join(os.path.dirname(imgdir), "images_timestamps_us.txt")
    if os.path.exists(ts_file):
        tss = np.loadtxt(ts_file)[::stride]
    for i, fn in enumerate(files):
        img = cv2.imread(fn)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        ts = tss[i] / 1e6 if tss is not None else float(i)
        yield img.transpose(2, 0, 1).astype(np.float32), intrinsics, ts


def load_undist_intrinsics(datapath: str) -> np.ndarray:
    """The undistorted intrinsics the benchmark's preprocessor wrote. A
    missing file is a setup error, with no fallback: guessed intrinsics
    track garbage without a warning."""
    calib = os.path.join(datapath, "calib_undist.txt")
    if not os.path.exists(calib):
        raise FileNotFoundError(
            f"{calib} missing: run the benchmark's preprocessor to write the "
            "undistorted intrinsics (there is no fallback)")
    intr = np.loadtxt(calib)
    if intr.shape != (4,):
        raise ValueError(f"{calib}: expected 4 values, got {intr.size}")
    return np.asarray(intr, np.float32)
