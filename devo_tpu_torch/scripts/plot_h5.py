"""Render event chunks from an h5 stream to PNG frames.

Counterpart of upstream DEVO's scripts/plot_h5.py (and plot_evs_txt.py via
--txt): slice the stream at the given image timestamps (or a fixed 30 Hz
grid), optionally rectify, and write one rendered event frame per window.

The port's own copy of scripts/plot_h5.py, on devo_tpu_torch's modules: the
same arguments and outputs.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from devo_tpu_torch.data.event_utils import EventSlicer
from devo_tpu_torch.utils.viz import render_events


def main():
    p = argparse.ArgumentParser(description="plot event chunks from h5/txt")
    p.add_argument("--infile", required=True)
    p.add_argument("--rmap_fname", default=None)
    p.add_argument("--tss_fname", default=None)
    p.add_argument("--H", type=int, default=480)
    p.add_argument("--W", type=int, default=640)
    p.add_argument("--outdir", default=None)
    p.add_argument("--max_frames", type=int, default=200)
    a = p.parse_args()

    outdir = a.outdir or osp.join(osp.dirname(a.infile), "evs_frames")
    os.makedirs(outdir, exist_ok=True)

    rect = None
    if a.rmap_fname:
        import h5py
        with h5py.File(a.rmap_fname, "r") as f:
            rect = np.asarray(f["rectify_map"])

    def write(i, xs, ys, ps):
        if rect is not None:
            r = rect[np.clip(ys.astype(np.int32), 0, rect.shape[0] - 1),
                     np.clip(xs.astype(np.int32), 0, rect.shape[1] - 1)]
            xs, ys = r[..., 0], r[..., 1]
        img = render_events(xs, ys, ps, a.H, a.W)
        try:
            import cv2
            cv2.imwrite(osp.join(outdir, f"{i:06d}.png"), img[..., ::-1])
        except Exception:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            plt.imsave(osp.join(outdir, f"{i:06d}.png"), img)

    if a.infile.endswith(".txt"):
        evs = np.loadtxt(a.infile, delimiter=" ")    # [t, x, y, p]
        tss = (np.loadtxt(a.tss_fname) if a.tss_fname else
               np.arange(evs[0, 0], evs[-1, 0], 1e6 / 30.0))
        dT = float(np.mean(np.diff(tss)))
        for i, t0 in enumerate(tss[:a.max_frames]):
            sel = (evs[:, 0] >= t0) & (evs[:, 0] < t0 + dT)
            if sel.any():
                b = evs[sel]
                write(i, b[:, 1], b[:, 2], b[:, 3])
    else:
        import h5py
        with h5py.File(a.infile, "r") as f:
            sl = EventSlicer(f)
            tss = (np.loadtxt(a.tss_fname) if a.tss_fname else
                   np.arange(sl.get_start_time_us(), sl.get_final_time_us(),
                             1e6 / 30.0))
            dT = float(np.mean(np.diff(tss)))
            for i, t0 in enumerate(tss[:a.max_frames]):
                ev = sl.get_events(int(t0), int(t0 + dT))
                if ev is not None and ev["t"].size:
                    write(i, ev["x"], ev["y"], ev["p"])
    print(f"wrote event frames to {outdir}")


if __name__ == "__main__":
    main()
