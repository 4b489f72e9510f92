"""Dataset preprocessing primitives (the port's own copy of
devo_tpu/data/preprocess.py).

Shared implementation behind the devo_tpu_torch/scripts/pp_*.py one-time
preprocessing CLIs, mirroring upstream DEVO's scripts/pp_{eds,tumvie,fpv,hku,mvsec,rpg,
vector,ecd}.py: microsecond time-offset normalization of events / GT /
image stamps, undistortion rectify-map computation (plain and fisheye via
OpenCV), and the standard sidecar outputs (rectify_map*.h5,
calib_undist*.json, t_offset_us.txt, stamped_groundtruth_us.txt).
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None
try:
    import h5py
except Exception:  # pragma: no cover
    h5py = None


def normalize_time_offsets(indir: str, tss_evs_us: np.ndarray,
                           gt: Optional[np.ndarray] = None,
                           tss_imgs_us: Optional[np.ndarray] = None):
    """Subtract the global minimum timestamp so everything starts near 0
    (pp_eds.py:34-57). Returns (offset_us, shifted arrays); writes the
    standard sidecar files."""
    mins = [tss_evs_us.min()]
    if gt is not None:
        mins.append(gt[:, 0].min())
    if tss_imgs_us is not None:
        mins.append(tss_imgs_us.min())
    offset_us = np.int64(min(mins))

    out = {}
    out["events_t"] = tss_evs_us - offset_us
    if gt is not None:
        gt = gt.copy()
        gt[:, 0] -= offset_us
        np.savetxt(os.path.join(indir, "stamped_groundtruth_us.txt"), gt,
                   header="#timestamp[us] px py pz qx qy qz qw")
        out["gt"] = gt
    if tss_imgs_us is not None:
        tss = tss_imgs_us - offset_us
        np.savetxt(os.path.join(indir, "images_timestamps_us.txt"), tss, fmt="%d")
        out["tss_imgs_us"] = tss
    np.savetxt(os.path.join(indir, "t_offset_us.txt"), np.asarray([offset_us]))
    return offset_us, out


def write_camera_frame_gt(gt_path: str, out_path: str, T_body_cam,
                          skiprows: int = 0, tss_to_us: float = 1.0):
    """Rewrite a [t x y z qx qy qz qw] body/IMU-frame GT file into the
    camera frame: T_world_cam = T_world_body @ T_body_cam. This is the
    transform behind the reference's stamped_groundtruth_us_cam.txt
    (pp_fpv.py:19-43, T_body_cam = inv(T_cam_imu)) and poses_evs_{side}.txt
    (pp_vector.py:52-69, T_body_cam = inv(T_camgray_body) @ T_camgray_camEvs).
    Stamps are scaled to microseconds with `tss_to_us`."""
    from devo_tpu_torch.utils.pose_utils import (poses_hom_to_quat,
                                                 poses_quat_to_hom)
    gt = np.loadtxt(gt_path, skiprows=skiprows)
    T_wb = poses_quat_to_hom(gt[:, 1:8])
    T_wc = T_wb @ np.asarray(T_body_cam, np.float64)[None]
    out = np.concatenate([gt[:, :1] * tss_to_us, poses_hom_to_quat(T_wc)], 1)
    np.savetxt(out_path, out, fmt="%.6f")
    return out


def new_camera_matrix(K: np.ndarray, dist: np.ndarray, H: int, W: int,
                      model: str = "radtan",
                      policy: str = "optimal0") -> np.ndarray:
    """Undistorted pinhole target per the reference's per-dataset policy:
    'optimal0' = cv2.getOptimalNewCameraMatrix(alpha=0) (pp_eds.py:81,
    pp_hku.py:86), 'balance0'/'balance05' = the fisheye estimator at
    balance 0 / 0.5 (pp_mvsec.py:26, pp_tumvie.py:72), 'keep' = K."""
    if policy == "keep":
        return np.asarray(K, np.float64)
    if model == "fisheye" or policy.startswith("balance"):
        bal = 0.5 if policy == "balance05" else 0.0
        return cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
            np.asarray(K, np.float64), np.asarray(dist[:4], np.float64),
            (W, H), np.eye(3), balance=bal)
    K_new, _ = cv2.getOptimalNewCameraMatrix(
        np.asarray(K, np.float64), np.asarray(dist, np.float64), (W, H),
        alpha=0, newImgSize=(W, H))
    return K_new


def undistort_images(img_paths, outdir: str, K: np.ndarray, dist: np.ndarray,
                     K_new: np.ndarray, H: int, W: int,
                     model: str = "radtan",
                     name_fmt: str = "{i:06d}.png") -> int:
    """Remap raw frames onto the undistorted pinhole camera and write
    `{i:06d}.png` files (pp_eds.py:107-120, pp_hku.py:92-99,
    pp_mvsec.py:104-116 — all use INTER_CUBIC remap, which is sharper than
    per-image undistortImage). `img_paths` may be file paths or arrays."""
    os.makedirs(outdir, exist_ok=True)
    if model == "fisheye":
        mx, my = cv2.fisheye.initUndistortRectifyMap(
            np.asarray(K, np.float64), np.asarray(dist[:4], np.float64),
            np.eye(3), K_new, (W, H), cv2.CV_32FC1)
    else:
        mx, my = cv2.initUndistortRectifyMap(
            np.asarray(K, np.float64), np.asarray(dist, np.float64),
            np.eye(3), K_new, (W, H), cv2.CV_32FC1)
    n = 0
    for i, img in enumerate(img_paths):
        if isinstance(img, (str, os.PathLike)):
            img = cv2.imread(str(img), cv2.IMREAD_UNCHANGED)
        und = cv2.remap(np.asarray(img), mx, my, cv2.INTER_CUBIC)
        cv2.imwrite(os.path.join(outdir, name_fmt.format(i=i)), und)
        n += 1
    return n


def save_calib_undist_txt(path: str, K_new: np.ndarray):
    """Single-line 'fx fy cx cy' sidecar (pp_hku.py:88, pp_mvsec.py:91,
    pp_rpg.py:139, pp_ecd.py:54 — the format the loaders read back)."""
    with open(path, "w") as f:
        f.write(f"{K_new[0, 0]} {K_new[1, 1]} {K_new[0, 2]} {K_new[1, 2]}")


def compute_rectify_map(K: np.ndarray, dist: np.ndarray, H: int, W: int,
                        K_new: Optional[np.ndarray] = None,
                        fisheye: bool = False) -> np.ndarray:
    """Per-pixel undistortion lookup: for each raw pixel (x, y), the
    undistorted coordinates (pp_mvsec.py:15-41 uses the fisheye model).
    Returns (H, W, 2) float32."""
    coords = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1
                      ).reshape(-1, 1, 2).astype(np.float32)
    if K_new is None:
        K_new = K
    if fisheye:
        und = cv2.fisheye.undistortPoints(coords, K, dist[:4], P=K_new)
    elif hasattr(cv2, "undistortPointsIter"):
        # the reference rectify maps use the ITERATIVE solve with a
        # 100-iteration / 1e-3 termination criterion (load_utils.py:690-691,
        # :1045-1046); plain undistortPoints runs 5 fixed iterations, which
        # does not converge at the corners of strongly-distorted radtan
        # cameras (ECD/RPG k1 ~ -0.34) and shifts the map by >1 px there
        crit = (cv2.TERM_CRITERIA_MAX_ITER | cv2.TERM_CRITERIA_EPS,
                100, 0.001)
        und = cv2.undistortPointsIter(coords, K, dist, np.eye(3), K_new,
                                      criteria=crit)
    else:
        und = cv2.undistortPoints(coords, K, dist, P=K_new)
    return und.reshape(H, W, 2).astype(np.float32)


def save_rectify_map(path: str, rectify_map: np.ndarray):
    with h5py.File(path, "w") as f:
        f.create_dataset("rectify_map", data=rectify_map)


def save_calib_undist(path: str, K_new: np.ndarray, H: int, W: int):
    with open(path, "w") as f:
        json.dump({"intrinsics_undistorted": {
            "fx": float(K_new[0, 0]), "fy": float(K_new[1, 1]),
            "cx": float(K_new[0, 2]), "cy": float(K_new[1, 2]),
            "H": H, "W": W}}, f, indent=2)


def preprocess_sequence(
    indir: str,
    K: np.ndarray, dist: np.ndarray, H: int, W: int,
    fisheye: bool = False, calibstr: str = "calib0",
    events_file: str = "events.h5",
    gt_file: str = "stamped_groundtruth.txt", gt_tss_unit: float = 1e6,
    imgs_ts_file: Optional[str] = "images_timestamps.txt",
):
    """Full per-sequence preprocessing: time offsets + rectify map + calib."""
    evpath = os.path.join(indir, events_file)
    with h5py.File(evpath, "r") as f:
        t = np.asarray(f["events/t"] if "events" in f else f["t"])

    gt = None
    gtp = os.path.join(indir, gt_file)
    if os.path.exists(gtp):
        gt = np.loadtxt(gtp)
        gt[:, 0] *= gt_tss_unit

    tss_imgs = None
    tsp = os.path.join(indir, imgs_ts_file) if imgs_ts_file else None
    if tsp and os.path.exists(tsp):
        tss_imgs = np.loadtxt(tsp)

    offset, _ = normalize_time_offsets(indir, t, gt, tss_imgs)

    K_new, _ = cv2.getOptimalNewCameraMatrix(K, dist, (W, H), 0) \
        if not fisheye else (K, None)
    rmap = compute_rectify_map(K, dist, H, W, K_new, fisheye=fisheye)
    save_rectify_map(os.path.join(indir, f"rectify_map_{calibstr}.h5"), rmap)
    save_calib_undist(os.path.join(indir, "calib_undist.json"), K_new, H, W)
    return offset


def preprocess_with_calib(
    indir: str,
    calib,                      # calibs.CamCalib (event camera)
    suffix: str = "",           # "_calib0" / "_left" per-dataset naming
    events_file: str = "events.h5",
    gt_file: str = "stamped_groundtruth.txt", gt_tss_unit: float = 1e6,
    imgs_ts_file: Optional[str] = "images_timestamps.txt",
    images_dir: Optional[str] = None,
    img_calib=None,             # separate frame camera (EDS rgb); None =
                                # same sensor as the events (DAVIS ONLY —
                                # callers with a distinct frame camera must
                                # pass it or skip images_dir)
    normalize_times: bool = True,  # False for datasets whose loaders read
                                # dataset-native stamps (HKU/MVSEC/VECtor
                                # extraction trees) — shifting only the
                                # sidecar GT would desync the time bases
):
    """Benchmark-faithful per-sequence preprocessing: time-offset
    normalization, event rectify map under the dataset's published event
    calibration, and (when `images_dir` is given) image undistortion under
    the dataset's frame-camera policy with the reference's sidecar formats
    (rectify_map{suffix}.h5, calib_undist{suffix}.txt,
    images_undistorted{suffix}/)."""
    H, W = calib.size
    if H <= 0 or W <= 0:
        raise ValueError(
            "calibration has no resolution — pass a CamCalib with size set "
            "(user-JSON overrides: add \"size\": [H, W])")
    evpath = os.path.join(indir, events_file)
    offset = 0
    if normalize_times and os.path.exists(evpath):
        with h5py.File(evpath, "r") as f:
            t = np.asarray(f["events/t"] if "events" in f else f["t"])
        gt = None
        gtp = os.path.join(indir, gt_file)
        if os.path.exists(gtp):
            gt = np.loadtxt(gtp)
            gt[:, 0] *= gt_tss_unit
        tss_imgs = None
        tsp = os.path.join(indir, imgs_ts_file) if imgs_ts_file else None
        if tsp and os.path.exists(tsp):
            tss_imgs = np.loadtxt(tsp)
        offset, _ = normalize_time_offsets(indir, t, gt, tss_imgs)

    K_new = new_camera_matrix(calib.K, calib.dist_np, H, W,
                              calib.model, calib.policy)
    rmap = compute_rectify_map(calib.K, calib.dist_np, H, W, K_new,
                               fisheye=calib.model == "fisheye")
    save_rectify_map(os.path.join(indir, f"rectify_map{suffix}.h5"), rmap)
    save_calib_undist_txt(
        os.path.join(indir, f"calib_undist{suffix}.txt"), K_new)
    save_calib_undist(os.path.join(indir, f"calib_undist{suffix}.json"),
                      K_new, H, W)

    if images_dir is not None:
        ic = img_calib or calib
        iH, iW = ic.size if ic.size != (0, 0) else (H, W)
        iK_new = new_camera_matrix(ic.K, ic.dist_np, iH, iW,
                                   ic.model, ic.policy)
        src = os.path.join(indir, images_dir)
        imgs = sorted(
            os.path.join(src, p) for p in os.listdir(src)
            if p.lower().endswith((".png", ".jpg")))
        undistort_images(imgs,
                         os.path.join(indir, f"images_undistorted{suffix}"),
                         ic.K, ic.dist_np, iK_new, iH, iW, ic.model)
    return offset
