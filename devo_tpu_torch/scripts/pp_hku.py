"""Preprocess HKU sequences (260x346 DAVIS346, events + frames share the
sensor).

Mirrors upstream DEVO's scripts/pp_hku.py: per-side published intrinsics are
built in (pp_hku.py:29-49), images are undistorted to
images_undistorted_{side}/, and the rectify map + calib_undist_{side}.txt
sidecars are written. Raw .bag extraction (events/images/Vicon poses with
the marker/stereo extrinsics, pp_hku.py:100-145) is provided by
devo_tpu_torch.data.stream.rosbag_event_stream + calibs.HKU_T_* when the optional
`rosbags` package is present; this CLI expects the extracted
events.h5/images tree.

Usage: python -m devo_tpu_torch.scripts.pp_hku --indir <seq_dir>... [--side left]

The port's own copy of scripts/pp_hku.py, on devo_tpu_torch's modules: the
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
    p.add_argument("--calib", default=None, help="JSON override")
    args = p.parse_args()
    for indir in args.indir:
        cam = (calibs.from_user_json(args.calib, default_size=(260, 346)) if args.calib
               else calibs.HKU[args.side])
        imgdir = "images" if os.path.isdir(os.path.join(indir, "images")) \
            else None
        off = preprocess_with_calib(
            indir, cam, suffix=f"_{args.side}",
            events_file=f"evs_{args.side}.h5"
            if os.path.exists(os.path.join(indir, f"evs_{args.side}.h5"))
            else "events.h5",
            # gt_stamped_* stamps are ALREADY microseconds (the reference
            # writes them as tss_gt_us, pp_hku.py:122-135) — no unit scaling
            gt_file=f"gt_stamped_{args.side}.txt", gt_tss_unit=1.0,
            imgs_ts_file=f"tss_imgs_us_{args.side}.txt",
            images_dir=imgdir,
            # HKU trees carry extraction-time stamps that the
            # loader reads natively; shifting only the sidecar
            # GT would desync the time bases
            normalize_times=False)
        print(f"{indir}: offset {off} us, rectify map + calib written")


if __name__ == "__main__":
    main()
