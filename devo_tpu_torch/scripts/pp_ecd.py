"""Preprocess ECD sequences (180x240 DAVIS240C).

Mirrors upstream DEVO's scripts/pp_ecd.py: reads the sequence's shipped
calib.txt (fx fy cx cy k1 k2 p1 p2 k3, pp_ecd.py:41-49), writes tss_us.txt
from images.txt, the rectify map, calib_undist.txt, and undistorted images.

Usage: python -m devo_tpu_torch.scripts.pp_ecd --indir <seq_dir>...

The port's own copy of scripts/pp_ecd.py, on devo_tpu_torch's modules: the
same arguments and outputs.
"""
import argparse
import os

import numpy as np

from devo_tpu_torch.data import calibs
from devo_tpu_torch.data.preprocess import preprocess_with_calib


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--indir", required=True, nargs="+")
    p.add_argument("--calib", default=None, help="JSON override")
    args = p.parse_args()
    for indir in args.indir:
        cam = (calibs.from_user_json(args.calib, default_size=(180, 240)) if args.calib
               else calibs.read_ecd_calib(os.path.join(indir, "calib.txt")))
        # images.txt: "t filename" rows; the reference dumps tss_us.txt
        # (pp_ecd.py:35-39)
        imtxt = os.path.join(indir, "images.txt")
        if os.path.exists(imtxt):
            tss = np.loadtxt(imtxt, usecols=0) * 1e6
            np.savetxt(os.path.join(indir, "tss_us.txt"), tss, fmt="%.6f")
        imgdir = ("images" if os.path.isdir(os.path.join(indir, "images"))
                  else None)
        off = preprocess_with_calib(indir, cam, images_dir=imgdir)
        print(f"{indir}: offset {off} us, rectify map + calib written")


if __name__ == "__main__":
    main()
