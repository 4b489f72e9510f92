"""Preprocess UZH-FPV sequences (260x346 mDAVIS, equidistant fisheye).

Mirrors upstream DEVO's scripts/pp_fpv.py: reads the dataset's shipped
kalibr yaml (cam0 intrinsics + distortion_coeffs + T_cam_imu,
get_calib_fpv), normalizes the raw text events / seconds-stamped GT /
image stamps to microsecond sidecars (pp_fpv.py:50-91), writes the
CAMERA-frame GT (stamped_groundtruth_us_cam.txt via inv(T_cam_imu),
pp_fpv.py:19-43 — the file eval_fpv_evs.py:55 evaluates against),
computes the fisheye rectify map (balance=0, pp_fpv.py:103-104) and
undistorts the frames.

Usage: python -m devo_tpu_torch.scripts.pp_fpv --indir <seq_dir>...
       [--calib-yaml <camchain.yaml>]

The port's own copy of scripts/pp_fpv.py, on devo_tpu_torch's modules: the
same arguments and outputs.
"""
import argparse
import glob
import os

import numpy as np

from devo_tpu_torch.data import calibs
from devo_tpu_torch.data.preprocess import (normalize_time_offsets,
                                      preprocess_with_calib,
                                      write_camera_frame_gt)


def _first_event_ts_us(evs_txt: str) -> float:
    """events.txt rows are time-sorted [ts_sec x y p]; the min stamp is the
    first data line (avoids loading the multi-GB file)."""
    with open(evs_txt) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                return float(line.split()[0]) * 1e6
    raise ValueError(f"{evs_txt}: no events")


def _normalize_raw_fpv(indir: str):
    """us-normalize a raw FPV tree (text events, seconds GT/image stamps)
    exactly as pp_fpv.py:65-91: offset = min over events/GT/images, write
    stamped_groundtruth_us.txt / images_timestamps_us.txt / t_offset_us.txt."""
    if os.path.exists(os.path.join(indir, "t_offset_us.txt")):
        return True
    evs_txt = os.path.join(indir, "events.txt")
    if not os.path.exists(evs_txt):
        return False
    tss_evs_us = np.asarray([_first_event_ts_us(evs_txt)])
    gt = None
    gtp = os.path.join(indir, "groundtruth.txt")
    if os.path.exists(gtp):
        gt = np.loadtxt(gtp, skiprows=1)
        gt[:, 0] *= 1e6                      # seconds -> us (pp_fpv.py:70)
    tss_imgs = None
    imp = os.path.join(indir, "images.txt")
    if os.path.exists(imp):
        tss_imgs = np.loadtxt(imp, usecols=1, ndmin=1) * 1e6
    normalize_time_offsets(indir, tss_evs_us, gt, tss_imgs)
    return True


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--indir", required=True, nargs="+")
    p.add_argument("--calib-yaml", default=None)
    p.add_argument("--calib", default=None, help="JSON override")
    args = p.parse_args()
    for indir in args.indir:
        cy = args.calib_yaml or next(
            iter(glob.glob(os.path.join(indir, "*camchain*.yaml"))), None)
        if args.calib:
            cam = calibs.from_user_json(args.calib, default_size=(260, 346))
        else:
            if cy is None:
                raise SystemExit(f"{indir}: no kalibr camchain yaml found")
            cam = calibs.read_fpv_calib(cy)
        raw_normed = _normalize_raw_fpv(indir)
        imgdir = ("img" if os.path.isdir(os.path.join(indir, "img"))
                  else "images" if os.path.isdir(os.path.join(indir, "images"))
                  else None)
        off = preprocess_with_calib(indir, cam, images_dir=imgdir,
                                    normalize_times=not raw_normed)

        # camera-frame GT via the kalibr extrinsics (pp_fpv.py:19-43,98-101)
        gtp = os.path.join(indir, "stamped_groundtruth_us.txt")
        T_cam_imu = calibs.read_fpv_T_cam_imu(cy) if cy else None
        if os.path.exists(gtp) and T_cam_imu is not None:
            write_camera_frame_gt(
                gtp, os.path.join(indir, "stamped_groundtruth_us_cam.txt"),
                np.linalg.inv(T_cam_imu))
        print(f"{indir}: offset {off} us, rectify map + calib written")


if __name__ == "__main__":
    main()
