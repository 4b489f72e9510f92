"""Published camera calibrations + undistortion policies per benchmark
(the port's own copy of devo_tpu/data/calibs.py).

The reference preprocessing scripts pin each benchmark's camera model as
code: hard-coded constants for EDS / HKU / RPG-180x240
(upstream DEVO's scripts/pp_eds.py:61-105, pp_hku.py:29-49,
pp_rpg.py:28-45) and readers for the calibration files the other datasets
distribute (pp_tumvie.py:50-80, pp_mvsec.py:82-88, pp_ecd.py:41-49).
This module centralizes both so the pp_*.py CLIs work out of the box on a
freshly downloaded sequence, with a user JSON override kept for re-calibrated
or cropped variants.

The constants are the datasets' published calibration values (facts of the
benchmark releases, reproduced from their calibration files), not code.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class CamCalib:
    """One physical camera: intrinsics + distortion + undistortion policy.

    model:  'radtan' (OpenCV plumb-bob k1 k2 p1 p2 [k3]) or 'fisheye'
            (equidistant k1..k4).
    policy: how the undistorted pinhole camera is chosen —
            'optimal0'  cv2.getOptimalNewCameraMatrix(alpha=0)
            'balance0'  cv2.fisheye.estimateNewCameraMatrixForUndistortRectify
                        (balance=0); 'balance05' the same with balance=0.5
            'keep'      K_new = K (already-rectified streams).
    """
    fx: float
    fy: float
    cx: float
    cy: float
    dist: Tuple[float, ...]
    model: str = "radtan"
    policy: str = "optimal0"
    size: Tuple[int, int] = (0, 0)  # (H, W); 0 = caller supplies

    @property
    def K(self) -> np.ndarray:
        K = np.zeros((3, 3), np.float64)
        K[0, 0], K[1, 1] = self.fx, self.fy
        K[0, 2], K[1, 2] = self.cx, self.cy
        K[2, 2] = 1.0
        return K

    @property
    def dist_np(self) -> np.ndarray:
        return np.asarray(self.dist, np.float64)


# --------------------------------------------------------------- registries
# EDS (480x640): two factory calibrations shipped with the dataset; the
# reference hard-codes both for the event and the global-shutter RGB camera
# (pp_eds.py:61-105). Sequences are evaluated under the calibration that was
# current when they were recorded.
EDS = {
    ("calib0", "evs"): CamCalib(
        560.8520948927032, 560.6295819972383,
        313.00733235019237, 217.32858679842997,
        (-0.09776467241921379, 0.2143738428636279,
         -0.004710710105172864, -0.004215916089401789),
        size=(480, 640)),
    ("calib1", "evs"): CamCalib(
        548.8989250692618, 550.0282089284915,
        313.5293514832678, 219.6325753720951,
        (-0.08095806072593555, 0.15743578875760092,
         -0.0035154416164982195, -0.003950567808338846),
        size=(480, 640)),
    ("calib0", "rgb"): CamCalib(
        766.536025127154, 767.5749459126396,
        291.0503512057777, 227.4060484950132,
        (-0.36965913545735024, 0.17414034009883844,
         0.003915245015812422, 0.003666687416655559),
        size=(480, 640)),
    ("calib1", "rgb"): CamCalib(
        758.1291471478728, 759.5125594392973,
        289.0985666049996, 228.23374237672056,
        (-0.36599825863847607, 0.15566628749131536,
         0.003684464282510181, 0.004564651739351755),
        size=(480, 640)),
}

# HKU (260x346 DAVIS346 — events and frames share the sensor): per-side
# intrinsics (pp_hku.py:29-49) plus the stereo/marker extrinsics used to
# express the Vicon poses in cam0 (pp_hku.py:105-121).
HKU = {
    "left": CamCalib(
        249.69341447817564, 248.41625664694038,
        176.74240257052816, 129.47631010746218,
        (-0.3794794654640921, 0.15393049046270296,
         0.0011400586965363895, -0.0019042695753031854),
        size=(260, 346)),
    "right": CamCalib(
        258.61441518089174, 258.00363445501824,
        178.44356547141308, 135.84792628403616,
        (-0.3864639588089853, 0.1707517912637013,
         -0.00046695742172563157, 0.0006610867041757214),
        size=(260, 346)),
}

HKU_T_CAM0_CAM1 = np.array([
    [0.9999189999842378, 0.00927392731970859, -0.00871709484799569,
     -0.05968052204060377],
    [-0.009231577824269699, 0.9999454511978819, 0.004885959428529005,
     -0.0005334476469976882],
    [0.008761931373541011, -0.004805091126247473, 0.9999500685823629,
     0.0005990728587972945],
    [0.0, 0.0, 0.0, 1.0]])

HKU_T_MARKER_CAM0 = np.linalg.inv(np.array([
    [0.9999552277012158, -0.00603191153357543, 0.007290996931816412,
     0.00011018857347815285],
    [0.005994670026470383, 0.9999689294906282, 0.005118982773930891,
     -0.0007730487905611042],
    [-0.007321647648062164, -0.005075046464534421, 0.9999603179022153,
     -0.060160984076249716],
    [0.0, 0.0, 0.0, 1.0]]))

# RPG stereo-DAVIS (180x240): hard-coded radtan per side (pp_rpg.py:28-45);
# the 260x346 variants read camera_info from the rosbag instead.
RPG_180x240 = {
    "left": CamCalib(
        196.63936292910697, 196.7329768429481,
        105.06412666477927, 72.47170071387173,
        (-0.3367326394292646, 0.11178850939644308,
         -0.0014005281258491276, -0.00045959441440687044),
        size=(180, 240)),
    "right": CamCalib(
        196.42564072599785, 196.56440793223533,
        110.74517642512458, 88.11310058123058,
        (-0.3462937629552321, 0.12772002965572962,
         -0.00027205054024332645, -0.00019580078540073353),
        size=(180, 240)),
}


# ------------------------------------------------- dataset-shipped readers

def read_tumvie_calib(calib_json: str, cam_idx: int,
                      for_images: bool = False) -> CamCalib:
    """TUM-VIE `camera-calibration*.json` (pp_tumvie.py:50-80): Kannala-
    Brandt fisheye per camera; index 0/1 = grayscale images, 2/3 = event
    cameras. The reference picks balance=0.5 for the event rectify map and
    balance=0 for image undistortion (pp_tumvie.py:72,142)."""
    with open(calib_json) as f:
        data = json.load(f)
    intr = data["value0"]["intrinsics"][cam_idx]["intrinsics"]
    res = data["value0"]["resolution"][cam_idx]
    return CamCalib(intr["fx"], intr["fy"], intr["cx"], intr["cy"],
                    (intr["k1"], intr["k2"], intr["k3"], intr["k4"]),
                    model="fisheye",
                    policy="balance0" if for_images else "balance05",
                    size=(int(res[1]), int(res[0])))


def read_mvsec_camchain(camchain_yaml: str, side: str = "left") -> CamCalib:
    """MVSEC `camchain-imucam-*.yaml` (pp_mvsec.py:82-88): equidistant
    fisheye; cam0 = left, cam1 = right."""
    import yaml

    with open(camchain_yaml) as f:
        all_intr = yaml.safe_load(f)
    cam = all_intr["cam0" if side == "left" else "cam1"]
    fx, fy, cx, cy = cam["intrinsics"]
    H, W = (260, 346)
    if "resolution" in cam:
        W, H = cam["resolution"]
    return CamCalib(fx, fy, cx, cy, tuple(cam["distortion_coeffs"]),
                    model="fisheye", policy="balance0", size=(H, W))


def read_ecd_calib(calib_txt: str) -> CamCalib:
    """ECD `calib.txt` (pp_ecd.py:41-49): fx fy cx cy k1 k2 p1 p2 k3."""
    v = np.loadtxt(calib_txt)
    return CamCalib(v[0], v[1], v[2], v[3], tuple(v[4:9]),
                    model="radtan", policy="optimal0", size=(180, 240))


def read_fpv_calib(calib_yaml: str) -> CamCalib:
    """UZH-FPV kalibr yaml (pp_fpv.py get_calib_fpv): equidistant fisheye
    (`cam0` block with intrinsics [fx fy cx cy])."""
    import yaml

    with open(calib_yaml) as f:
        data = yaml.safe_load(f)
    cam = data["cam0"] if "cam0" in data else data
    fx, fy, cx, cy = cam["intrinsics"]
    W, H = cam.get("resolution", [346, 260])
    return CamCalib(fx, fy, cx, cy, tuple(cam["distortion_coeffs"]),
                    model="fisheye", policy="balance0", size=(H, W))


def read_fpv_T_cam_imu(calib_yaml: str):
    """(4, 4) camera-from-IMU extrinsic from the kalibr camchain
    (cam0["T_cam_imu"], upstream DEVO's scripts/pp_fpv.py get_calib_fpv) —
    used to write the camera-frame GT the FPV eval scores against. Returns
    None when the yaml carries no extrinsics."""
    import yaml

    with open(calib_yaml) as f:
        data = yaml.safe_load(f)
    cam = data["cam0"] if "cam0" in data else data
    T = cam.get("T_cam_imu")
    return None if T is None else np.asarray(T, np.float64).reshape(4, 4)


def read_vector_calib(calib_yaml: str,
                      size: Tuple[int, int] = (480, 640)) -> CamCalib:
    """VECtor ROS-style intrinsic yaml (`0_calib/{side}_event_camera_
    intrinsic_results.yaml`, pp_vector.py:110-119): plumb-bob
    camera_matrix/distortion_coefficients `data` lists."""
    import yaml

    with open(calib_yaml) as f:
        d = yaml.safe_load(f)
    K = np.asarray(d["camera_matrix"]["data"], np.float64).reshape(3, 3)
    dist = tuple(d["distortion_coefficients"]["data"])
    if "image_height" in d:
        size = (int(d["image_height"]), int(d["image_width"]))
    return CamCalib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], dist,
                    model="radtan", policy="optimal0", size=size)


def from_user_json(path: str,
                   default_size: Tuple[int, int] = (0, 0)) -> CamCalib:
    """{"K": 3x3 (or [fx,fy,cx,cy]), "dist": [...], "model": ..., "policy":
    ..., "size": [H, W]} override, the escape hatch the pp CLIs always
    accept. `default_size` fills in the benchmark's known resolution when
    the JSON has no "size" (the common {K, dist}-only file)."""
    with open(path) as f:
        c = json.load(f)
    K = np.asarray(c["K"], np.float64)
    if K.size == 9:
        K = K.reshape(3, 3)
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    else:
        fx, fy, cx, cy = K.reshape(-1)[:4]
    size = tuple(c.get("size", default_size))
    return CamCalib(fx, fy, cx, cy, tuple(c.get("dist", (0, 0, 0, 0))),
                    model=c.get("model", "radtan"),
                    policy=c.get("policy", "optimal0"), size=size)
