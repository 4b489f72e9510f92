"""Preprocess RPG stereo-DAVIS sequences (180x240).

Mirrors upstream DEVO's scripts/pp_rpg.py: the 180x240 sequences' published
per-side radtan intrinsics are built in (pp_rpg.py:28-45); 260x346 variants
(whose calibration lives in the rosbag camera_info) take a --calib JSON.

Usage: python -m devo_tpu_torch.scripts.pp_rpg --indir <seq_dir>... [--side left]

The port's own copy of scripts/pp_rpg.py, on devo_tpu_torch's modules: the
same arguments and outputs.
"""
import argparse
import os

from devo_tpu_torch.data import calibs
from devo_tpu_torch.data.preprocess import preprocess_with_calib


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--indir", required=True, nargs="+")
    p.add_argument("--side", default="left", choices=["left", "right"])
    p.add_argument("--calib", default=None,
                   help="JSON override (required for 260x346 sequences)")
    args = p.parse_args()
    for indir in args.indir:
        cam = (calibs.from_user_json(args.calib, default_size=(180, 240)) if args.calib
               else calibs.RPG_180x240[args.side])
        imgdir = ("images" if os.path.isdir(os.path.join(indir, "images"))
                  else None)
        off = preprocess_with_calib(indir, cam, images_dir=imgdir)
        print(f"{indir}: offset {off} us, rectify map + calib written")


if __name__ == "__main__":
    main()
