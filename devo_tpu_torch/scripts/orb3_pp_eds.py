"""Prepare EDS sequences for an external ORB-SLAM3 baseline run.

Counterpart of upstream DEVO's scripts/orb3_pp_eds.py: copy undistorted
images to ORB3_<calib>/data named by their nanosecond timestamps, write
`images_tss_ns.txt`, convert `stamped_groundtruth.txt` (seconds) to the
comma-separated `groundtruth_ns.txt` ORB3 evaluation expects, and (when a
template yaml is given) patch Camera.fps into the sequence settings.

The port's own copy of scripts/orb3_pp_eds.py, on devo_tpu_torch's modules: the
same arguments and outputs.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil

import numpy as np


def prepare_seq_eds(indir: str, calibstr: str = "calib0",
                    yaml_template: str = ""):
    assert calibstr in ("calib0", "calib1")
    imgdirin = osp.join(indir, f"images_undistorted_{calibstr}")
    assert osp.isdir(imgdirin), imgdirin
    orb3out = osp.join(indir, f"ORB3_{calibstr}")
    imgdirout = osp.join(orb3out, "data")
    os.makedirs(imgdirout, exist_ok=True)

    img_list = sorted(f for f in os.listdir(imgdirin) if f.endswith(".png"))
    tss_imgs_us = np.loadtxt(osp.join(indir, "images_timestamps.txt"))
    tss_imgs_ns = (tss_imgs_us * 1e3).astype(np.int64)
    np.savetxt(osp.join(orb3out, "images_tss_ns.txt"), tss_imgs_ns, fmt="%d")

    # GT: seconds (skiprows=1) -> ns, comma-separated (orb3_pp_eds.py:50-55)
    gt_s = np.loadtxt(osp.join(indir, "stamped_groundtruth.txt"), skiprows=1)
    gt_ns = gt_s.copy()
    gt_ns[:, 0] *= 1e9
    np.savetxt(osp.join(orb3out, "groundtruth_ns.txt"), gt_ns, fmt="%f",
               delimiter=",")

    if yaml_template:
        # patch the camera fps into the ORB3 settings yaml; plain text edit
        # (no ruamel in this image)
        fps = 1e9 / float(np.mean(np.diff(tss_imgs_ns)))
        yamlout = osp.join(orb3out, osp.basename(yaml_template))
        with open(yaml_template) as f:
            text = f.read()
        lines = [f"Camera.fps: {int(fps)}" if line.startswith("Camera.fps")
                 else line for line in text.splitlines()]
        with open(yamlout, "w") as f:
            f.write("\n".join(lines) + "\n")

    if len(os.listdir(imgdirout)) != len(img_list):
        for i, f in enumerate(img_list):
            shutil.copy(osp.join(imgdirin, f),
                        osp.join(imgdirout, f"{int(tss_imgs_ns[i]):019d}.png"))
    print(f"prepared {indir} ({len(img_list)} images) for ORB3")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="prepare EDS dirs for ORB-SLAM3")
    p.add_argument("--indir", required=True)
    p.add_argument("--calibstr", default="calib0")
    p.add_argument("--yaml_template", default="")
    a = p.parse_args()
    roots = sorted({root for root, dirs, files in os.walk(a.indir)
                    if "images_timestamps.txt" in files
                    and any("images" in d for d in dirs)})
    for root in roots or [a.indir]:
        prepare_seq_eds(root, a.calibstr, a.yaml_template)
