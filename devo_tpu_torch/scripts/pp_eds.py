"""Preprocess EDS sequences (480x640, Prophesee Gen3 + GS RGB).

Mirrors upstream DEVO's scripts/pp_eds.py: microsecond time-offset
normalization, event rectify map under the dataset's published calibration
(calib0 or calib1, both built in — pp_eds.py:61-105), and RGB undistortion
to images_undistorted_{calibstr}/ under the matching RGB calibration.

Usage: python -m devo_tpu_torch.scripts.pp_eds --indir <seq_dir>... [--calibstr calib0]
       [--calib <override.json>] [--no-images]

The port's own copy of scripts/pp_eds.py, on devo_tpu_torch's modules: the
same arguments and outputs.
"""
import argparse
import os

from devo_tpu_torch.data import calibs
from devo_tpu_torch.data.preprocess import preprocess_with_calib


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--indir", required=True, nargs="+")
    p.add_argument("--calibstr", default="calib0", choices=["calib0", "calib1"])
    p.add_argument("--calib", default=None,
                   help="JSON override: {K, dist[, model, policy, size]}")
    p.add_argument("--no-images", action="store_true",
                   help="skip RGB undistortion (events-only sequences)")
    args = p.parse_args()
    for indir in args.indir:
        evs = (calibs.from_user_json(args.calib, default_size=(480, 640)) if args.calib
               else calibs.EDS[(args.calibstr, "evs")])
        rgb = calibs.EDS[(args.calibstr, "rgb")]
        imgdir = "images" if (not args.no_images
                              and os.path.isdir(os.path.join(indir, "images"))
                              ) else None
        off = preprocess_with_calib(
            indir, evs, suffix=f"_{args.calibstr}",
            images_dir=imgdir, img_calib=rgb)
        print(f"{indir}: offset {off} us; rectify map + calib"
              + ("" if imgdir is None else " + undistorted images") + " written")


if __name__ == "__main__":
    main()
