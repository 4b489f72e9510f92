"""Convert TartanAir RGB sequences to simulated event voxels.

Counterpart of upstream DEVO's scripts/convert_tartan.py: reads each scene's
image_left frames + timestamps, runs the ESIM contrast-threshold simulator
(contrast sampled U(0.16, 0.34) per sequence, convert_tartan.py:199-216),
splits the event stream at the original frame timestamps and writes one
float16 'voxel' h5 per interval under <scene>/evs_left/h5/ — an IN-PLACE
conversion of a raw TartanAir trajectory dir (<scene> contains image_left/,
depth_left/, pose_left.txt). devo_tpu_torch.data.tartan.TartanAirEVS reads both
this layout and the reference's restructured modality-first tree
(<difficulty>/evs_left/<traj>/h5).

Usage: python -m devo_tpu_torch.scripts.convert_tartan --scenes <scene_dir> [...] [--fps 100]

The port's own copy of scripts/convert_tartan.py, on devo_tpu_torch's modules: the
same arguments and outputs.
"""
import argparse
import glob
import os

import numpy as np

from devo_tpu_torch.data.esim import simulate_sequence

try:
    import cv2
except Exception:
    cv2 = None
try:
    import h5py
except Exception:
    h5py = None


def frame_iter(img_files, fps):
    for i, fn in enumerate(img_files):
        img = cv2.imread(fn, cv2.IMREAD_GRAYSCALE).astype(np.float32) / 255.0
        yield img, i * 1e6 / fps


def convert_sequence(scene: str, fps: float, seed: int,
                     upsample: int = 1, upsample_mode: str = "flow"):
    img_dir = os.path.join(scene, "image_left")
    img_files = sorted(glob.glob(os.path.join(img_dir, "*.png")))
    if not img_files:
        print(f"skip {scene}: no images")
        return
    outdir = os.path.join(scene, "evs_left", "h5")
    os.makedirs(outdir, exist_ok=True)
    n = 0
    for i, (vox, t_us) in enumerate(
            simulate_sequence(frame_iter(img_files, fps), seed=seed,
                              upsample=upsample,
                              upsample_mode=upsample_mode)):
        with h5py.File(os.path.join(outdir, f"{i:06d}.h5"), "w") as f:
            f.create_dataset("voxel", data=vox, dtype="float16")
        n += 1
    # a single-image scene yields zero inter-frame intervals -> n == 0
    print(f"{scene}: wrote {n} voxels")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scenes", nargs="+", required=True)
    p.add_argument("--fps", type=float, default=100.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--upsample", type=int, default=1,
                   help="N-x frame interpolation before ESIM (the vid2e/"
                        "Super-SloMo stage, reference convert_tartan.py:178;"
                        " flow-warped intermediates by default)")
    p.add_argument("--upsample_mode", default="flow",
                   choices=["flow", "linear"])
    args = p.parse_args()
    for k, scene in enumerate(args.scenes):
        convert_sequence(scene, args.fps, args.seed + k,
                         upsample=args.upsample,
                         upsample_mode=args.upsample_mode)


if __name__ == "__main__":
    main()
