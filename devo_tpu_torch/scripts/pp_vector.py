"""Preprocess VECtor sequences (480x640 events + 1024x1224 grayscale).

Mirrors upstream DEVO's scripts/pp_vector.py: reads the dataset's shipped
ROS-style intrinsic yamls (0_calib/{side}_event_camera_intrinsic_results.yaml
and {side}_regular_camera_intrinsic_results.yaml, pp_vector.py:110-119),
computes the event rectify map (alpha=0 plumb-bob, load_utils.py:1041-1057)
and undistorts the grayscale frames.

Usage: python -m devo_tpu_torch.scripts.pp_vector --indir <seq_dir>... [--side left]
       [--calib-dir <0_calib dir>]   (default: <indir>/../0_calib)

The port's own copy of scripts/pp_vector.py, on devo_tpu_torch's modules: the
same arguments and outputs.
"""
import argparse
import os

from devo_tpu_torch.data import calibs
from devo_tpu_torch.data.preprocess import preprocess_with_calib, write_camera_frame_gt


def _write_event_gt(indir: str, cdir: str, side: str):
    """poses_evs_{side}.txt: the dataset's seconds-stamped mocap GT
    ({seq}1.synced.gt.txt, body frame) mapped into the event-camera frame
    via T_world_camEvs = T_world_body @ inv(T_camgray_body) @
    T_camgray_camEvs (upstream DEVO's scripts/pp_vector.py:39-69; camId 2 =
    left DVS, 3 = right in the joint extrinsic yaml). This is the file
    eval_vector_evs.py:42 evaluates against."""
    import glob

    import numpy as np
    import yaml

    seq = os.path.basename(os.path.normpath(indir))
    gtp = os.path.join(indir, f"{seq}1.synced.gt.txt")
    mocap = os.path.join(cdir, "camera_mocap_extrinsic_results1.yaml")
    joints = sorted(glob.glob(
        os.path.join(cdir, "*joint_camera_extrinsic_results*.yaml")))
    # the reference hardcodes the small_scale joint calib (pp_vector.py:47)
    joint = next((j for j in joints if "small_scale" in j),
                 joints[0] if joints else None)
    if not (os.path.exists(gtp) and os.path.exists(mocap) and joint):
        return False
    with open(mocap) as f:
        T_camgray_body = np.asarray(
            yaml.safe_load(f)["cam0"]["T_cam_body"], np.float64).reshape(4, 4)
    cam_id = 2 if side == "left" else 3
    with open(joint) as f:
        T_camgray_camevs = np.asarray(
            yaml.safe_load(f)[f"cam{cam_id}"][f"T_cam0_cam{cam_id}"],
            np.float64).reshape(4, 4)
    write_camera_frame_gt(
        gtp, os.path.join(indir, f"poses_evs_{side}.txt"),
        np.linalg.inv(T_camgray_body) @ T_camgray_camevs,
        skiprows=2, tss_to_us=1e6)
    return True


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--indir", required=True, nargs="+")
    p.add_argument("--side", default="left", choices=["left", "right"])
    p.add_argument("--calib-dir", default=None)
    p.add_argument("--calib", default=None, help="JSON override")
    args = p.parse_args()
    for indir in args.indir:
        cdir = args.calib_dir or os.path.join(indir, "../0_calib")
        if args.calib:
            evs, gray = calibs.from_user_json(args.calib, default_size=(480, 640)), None
        else:
            evs = calibs.read_vector_calib(os.path.join(
                cdir, f"{args.side}_event_camera_intrinsic_results.yaml"))
            gp = os.path.join(
                cdir, f"{args.side}_regular_camera_intrinsic_results.yaml")
            gray = (calibs.read_vector_calib(gp, size=(1024, 1224))
                    if os.path.exists(gp) else None)
        # the grayscale camera is a DIFFERENT sensor (1024x1224): never
        # undistort frames with the event calibration
        imgdir = ("images" if gray is not None
                  and os.path.isdir(os.path.join(indir, "images"))
                  else None)
        off = preprocess_with_calib(
            indir, evs, suffix=f"_{args.side}",
            imgs_ts_file=f"tss_imgs_us_{args.side}.txt",
            images_dir=imgdir, img_calib=gray,
            normalize_times=False)
        wrote_gt = _write_event_gt(indir, cdir, args.side)
        print(f"{indir}: offset {off} us, rectify map + calib"
              f"{' + poses_evs GT' if wrote_gt else ''} written")


if __name__ == "__main__":
    main()
