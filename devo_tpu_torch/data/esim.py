"""Event simulation from video frames (ESIM model; the port's own copy of
devo_tpu/data/esim.py).

Self-contained counterpart of upstream DEVO's scripts/convert_tartan.py
(which shells out to vid2e + esim_torch): generates events from a sequence
of intensity frames with the standard ESIM contrast-threshold model —
per-sequence thresholds sampled U(0.16, 0.34) (convert_tartan.py:199-216),
log-intensity crossings linearly interpolated in time, zero refractory
period — and splits/voxelizes the stream at the original frame timestamps
(convert_tartan.py:264-296).

The reference upsamples frames to high fps with vid2e/Super-SloMo before
ESIM (convert_tartan.py:178). Without it, the per-pixel crossing
interpolation below only produces events along each pixel's temporal
intensity ramp — fast inter-frame motion generates no events along the
motion PATH. `upsample_frames` stands in for vid2e: motion-compensated
(Farneback optical flow) or linear frame interpolation at N x the source
rate. Residual deviation from Super-SloMo: Farneback flow is coarser than
a learned interpolator near occlusions and thin structures, and the
occlusion model is a soft blend rather than learned visibility maps — the
event streams match vid2e's in spatial support and rate scaling, not
event-for-event.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

LOG_EPS = 1e-3


def _warp(img: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Backward-warp: out(x) = img(x + flow(x)) (cv2.remap, border
    replicate so frame edges don't strobe off-image events)."""
    import cv2

    H, W = img.shape
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    return cv2.remap(img, gx + flow[..., 0], gy + flow[..., 1],
                     interpolation=cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_REPLICATE)


def upsample_frames(
    frames: Iterator[Tuple[np.ndarray, float]],
    factor: int = 1,
    mode: str = "flow",
):
    """High-fps interpolation stage standing in for vid2e/Super-SloMo
    (upstream DEVO's scripts/convert_tartan.py:178): yields (img, t_us) at
    `factor` x the source rate.

    mode="flow": global translation from windowed phase correlation (the
    large-displacement stage a learned interpolator provides; Farneback
    alone cannot latch a structure that jumps past its own width) +
    Farneback refinement of the residual; the intermediate frame at
    fraction tau is the standard two-sided backward warp
    I_tau(x) = (1-tau) * I0(x - tau F(x)) + tau * I1(x + (1-tau) F(x))
    (Super-SloMo's flow-composition stage with linear visibility) — moving
    structure sweeps through intermediate positions, so ESIM emits events
    along the motion path like the reference's pipeline.
    mode="linear": plain cross-fade (cheap; moving edges double-expose
    instead of sweeping — only for smoke tests).
    """
    assert factor >= 1 and mode in ("flow", "linear")
    if factor == 1:
        yield from frames
        return
    import cv2

    hann = None
    prev = None
    for img, t_us in frames:
        if prev is not None:
            img0, t0 = prev
            if mode == "flow":
                H, W = img.shape
                if hann is None:
                    hann = cv2.createHanningWindow((W, H), cv2.CV_64F)
                # stage 1: dominant global translation (phase correlation)
                (gx, gy), _ = cv2.phaseCorrelate(
                    img0.astype(np.float64), img.astype(np.float64), hann)
                # wrap the cyclic estimate into (-dim/2, dim/2]
                gx = gx - W * np.round(gx / W)
                gy = gy - H * np.round(gy / H)
                # stage 2: Farneback on the globally-aligned pair
                img1c = _warp(img, np.broadcast_to(
                    np.asarray([gx, gy], np.float32), (H, W, 2)))
                res = cv2.calcOpticalFlowFarneback(
                    (np.clip(img0, 0, 1) * 255).astype(np.uint8),
                    (np.clip(img1c, 0, 1) * 255).astype(np.uint8), None,
                    pyr_scale=0.5, levels=4, winsize=21, iterations=3,
                    poly_n=5, poly_sigma=1.1, flags=0)
                flow = res + np.asarray([gx, gy], np.float32)
            for k in range(1, factor):
                tau = k / factor
                tk = t0 + tau * (t_us - t0)
                if mode == "flow":
                    a = _warp(img0, -tau * flow)
                    b = _warp(img, (1.0 - tau) * flow)
                    yield (1.0 - tau) * a + tau * b, tk
                else:
                    yield (1.0 - tau) * img0 + tau * img, tk
        else:
            yield img, t_us
            prev = (img, t_us)
            continue
        yield img, t_us
        prev = (img, t_us)


class ESIM:
    """Per-pixel contrast-threshold event generator."""

    def __init__(self, c_pos: float, c_neg: float):
        self.c_pos = c_pos
        self.c_neg = c_neg
        self.ref: Optional[np.ndarray] = None  # reference log intensity
        self.t_prev: Optional[float] = None
        self.log_prev: Optional[np.ndarray] = None

    def forward(self, img: np.ndarray, t_us: float):
        """Feed one frame (float intensity in [0, 1]); returns events
        (x, y, t, p) generated since the previous frame."""
        logI = np.log(img.astype(np.float64) + LOG_EPS)
        if self.ref is None:
            self.ref = logI.copy()
            self.log_prev = logI
            self.t_prev = t_us
            return (np.empty(0, np.int32),) * 2 + (np.empty(0, np.int64),
                                                   np.empty(0, np.int8))

        H, W = logI.shape
        xs, ys, ts, ps = [], [], [], []
        delta = logI - self.ref
        # number of threshold crossings per pixel (vectorized over polarity)
        for pol, c in ((1, self.c_pos), (-1, self.c_neg)):
            d = delta * pol
            n_ev = np.floor(d / c).astype(np.int64)
            n_ev = np.maximum(n_ev, 0)
            max_n = int(n_ev.max()) if n_ev.size else 0
            if max_n == 0:
                continue
            yy, xx = np.nonzero(n_ev > 0)
            counts = n_ev[yy, xx]
            reps = np.repeat(np.arange(len(yy)), counts)
            k = np.concatenate([np.arange(1, c_ + 1) for c_ in counts])
            # linear interpolation of crossing times within the frame interval
            d_prev = (self.log_prev - self.ref)[yy, xx] * pol
            d_now = d[yy, xx]
            frac = (k * c - d_prev[reps]) / np.maximum(
                (d_now - d_prev)[reps], 1e-12)
            frac = np.clip(frac, 0.0, 1.0)
            t_ev = self.t_prev + frac * (t_us - self.t_prev)
            xs.append(xx[reps].astype(np.int32))
            ys.append(yy[reps].astype(np.int32))
            ts.append(t_ev.astype(np.int64))
            ps.append(np.full(len(reps), pol, np.int8))
            # advance reference by the emitted crossings
            self.ref[yy, xx] += pol * counts * c

        self.log_prev = logI
        self.t_prev = t_us
        if not xs:
            return (np.empty(0, np.int32),) * 2 + (np.empty(0, np.int64),
                                                   np.empty(0, np.int8))
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        t = np.concatenate(ts)
        p = np.concatenate(ps)
        order = np.argsort(t, kind="stable")
        return x[order], y[order], t[order], p[order]


def simulate_sequence(
    frames: Iterator[Tuple[np.ndarray, float]],
    seed: int = 0,
    bins: int = 5,
    contrast_range: Tuple[float, float] = (0.16, 0.34),
    upsample: int = 1,
    upsample_mode: str = "flow",
):
    """Simulate events for a frame sequence and voxelize between consecutive
    SOURCE frame timestamps (the reference splits at the original stamps,
    convert_tartan.py:264-296, regardless of the high-fps upsampling).
    Yields (voxel (bins, H, W) float16, t_us) per source interval.

    upsample > 1 inserts `upsample_frames` before ESIM (the vid2e stage):
    events are generated at the interpolated rate, then pooled back into
    source-rate voxels."""
    from .event_utils import to_voxel_grid

    rng = np.random.default_rng(seed)
    c_pos = float(rng.uniform(*contrast_range))
    c_neg = float(rng.uniform(*contrast_range))
    esim = ESIM(c_pos, c_neg)

    stream = upsample_frames(frames, upsample, upsample_mode)
    bufs = []
    idx = 0
    prev_orig = None
    for img, t_us in stream:
        ev = esim.forward(img, t_us)
        if ev[0].size:
            bufs.append(ev)
        if idx % upsample == 0:              # a SOURCE frame boundary
            if prev_orig is not None:
                H, W = img.shape
                if bufs:
                    x, y, t, p = (np.concatenate(b) for b in zip(*bufs))
                else:
                    x = y = np.empty(0, np.int32)
                    t = np.empty(0, np.int64)
                    p = np.empty(0, np.int8)
                vox = to_voxel_grid(x, y, t, p, H, W, bins)
                yield vox.astype(np.float16), t_us
            bufs = []
            prev_orig = t_us
        idx += 1
