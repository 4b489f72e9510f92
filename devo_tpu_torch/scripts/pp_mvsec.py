"""Preprocess MVSEC sequences (260x346 DAVIS, equidistant fisheye).

Mirrors upstream DEVO's scripts/pp_mvsec.py: reads the dataset's shipped
kalibr camchain (camchain-imucam-*.yaml, cam0=left / cam1=right,
pp_mvsec.py:82-88), computes the fisheye rectify map (balance=0,
pp_mvsec.py:15-41), undistorts the DAVIS frames, and writes
rectify_map_{side}.h5 + calib_undist_{side}.txt.

Usage: python -m devo_tpu_torch.scripts.pp_mvsec --indir <seq_dir>... [--side left]
       [--camchain <yaml>]   (default: ../indoor_flying_calib/
                              camchain-imucam-indoor_flying.yaml per seq)

The port's own copy of scripts/pp_mvsec.py, on devo_tpu_torch's modules: the
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
    p.add_argument("--camchain", default=None)
    p.add_argument("--calib", default=None, help="JSON override")
    args = p.parse_args()
    for indir in args.indir:
        if args.calib:
            cam = calibs.from_user_json(args.calib, default_size=(260, 346))
        else:
            chain = args.camchain or os.path.join(
                indir, "../indoor_flying_calib/"
                "camchain-imucam-indoor_flying.yaml")
            cam = calibs.read_mvsec_camchain(chain, args.side)
        imgdir = ("images" if os.path.isdir(os.path.join(indir, "images"))
                  else None)
        off = preprocess_with_calib(
            indir, cam, suffix=f"_{args.side}",
            imgs_ts_file=f"tss_imgs_us_{args.side}.txt",
            images_dir=imgdir,
            # the MVSEC loader reads stamps from the dataset
            # hdf5 directly — do not shift sidecars
            normalize_times=False)
        print(f"{indir}: offset {off} us, rectify map + calib written")


if __name__ == "__main__":
    main()
