"""Preprocess TUM-VIE sequences (1280x720 events, Kannala-Brandt fisheye).

Mirrors upstream DEVO's scripts/pp_tumvie.py: reads the dataset's shipped
camera-calibration JSON (cam 0/1 = grayscale images, 2/3 = event cameras,
pp_tumvie.py:50-80), builds the event rectify map with the reference's
balance=0.5 fisheye target (pp_tumvie.py:72) and undistorts images with
balance=0 (pp_tumvie.py:142).

Usage: python -m devo_tpu_torch.scripts.pp_tumvie --indir <seq_dir>...
       [--calib-json <camera-calibrationA.json>] [--side left]

The port's own copy of scripts/pp_tumvie.py, on devo_tpu_torch's modules: the
same arguments and outputs.
"""
import argparse
import glob
import os

from devo_tpu_torch.data import calibs
from devo_tpu_torch.data.preprocess import preprocess_with_calib


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--indir", required=True, nargs="+")
    p.add_argument("--calib-json", default=None)
    p.add_argument("--side", default="left", choices=["left", "right"])
    p.add_argument("--calib", default=None, help="JSON override")
    args = p.parse_args()
    ev_idx = 2 if args.side == "left" else 3
    img_idx = 0 if args.side == "left" else 1
    for indir in args.indir:
        cj = args.calib_json or next(
            iter(glob.glob(os.path.join(indir, "*camera-calibration*.json"))),
            None)
        if args.calib:
            evs, img = calibs.from_user_json(
                args.calib, default_size=(720, 1280)), None
        else:
            if cj is None:
                raise SystemExit(f"{indir}: no camera-calibration JSON found")
            evs = calibs.read_tumvie_calib(cj, ev_idx)
            img = calibs.read_tumvie_calib(cj, img_idx, for_images=True)
        # the grayscale cameras are different sensors (1024x768): never
        # undistort frames with the event calibration
        imgdir = ("images" if img is not None
                  and os.path.isdir(os.path.join(indir, "images"))
                  else None)
        off = preprocess_with_calib(
            indir, evs, suffix=f"_{args.side}",
            images_dir=imgdir, img_calib=img)
        print(f"{indir}: offset {off} us, rectify map + calib written")


if __name__ == "__main__":
    main()
