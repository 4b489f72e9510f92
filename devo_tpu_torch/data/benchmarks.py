"""Per-benchmark event data loaders with dataset-specific quirks.

Faithful counterpart of upstream DEVO's utils/load_utils.py's per-benchmark
iterators (tumvie:84, eds:184, rpg:770, mvsec:826, vector:959, hku:1096,
fpv:1189) and GT loaders (:560-634). Each benchmark has its own file
conventions, event-window rule, hot-pixel policy, and hand-tuned
start/stop crops — this module encodes them all; data/loaders.py keeps the
benchmark-agnostic fallback for preprocessed trees.

Quirk summary (all cited from load_utils.py):
  EDS     events.h5 + rectify_map_calib{0,1}.h5; HARD-CODED undistorted
          intrinsics per calib (:170-177); dT = mean-frame-spacing / 2
          (:198); hot-pixel filter at 10 sigma (:219).
  TUM-VIE *events_{side}.h5 (camID 2=left, 3=right); calibration json;
          dT = mean spacing (:97); hot-pixel at 6 SIGMA (:111); optional
          down-scale to (H, W) with intrinsics rescale (:103-107).
  RPG     evs_{side}.txt TEXT events [us, x, y, p]; calib_undist_{side}.txt;
          no rectify map for simulation_3planes (:784); ECD-style windows:
          ts_out = min((t0 + t1)/2, next) and the last frame dropped
          (:635-664).
  FPV     events.txt [s, x, y, p] -> us minus t_offset_us.txt (:1203-1206);
          ECD-style windows; GT-window crop when GT is >5 s shorter than
          the images (:1218-1225); calib_undist.txt (ECD convention).
  MVSEC   *_data.hdf5 (davis/<side>/events + image_raw_event_inds): windows
          are EVENT-INDEX ranges between consecutive images, not time
          slices (:849-860); *_gt.hdf5 davis/<side>/pose (4, 4) homogeneous
          GT (:560-571).
  VECtor  <seq>1.synced.<side>_event.hdf5; dT = mean*2 (normal) or mean/2
          ("fast" sequences) (:980-984); per-sequence imstart/imstop crops
          (:909-957).
  HKU     evs_{side}.h5; dT = mean; NO hot-pixel filter (:1114); per-
          sequence crops + corrupt-frame del_idxs for HDR_circle/HDR_slow
          (:1121-1135).
"""
from __future__ import annotations

import glob
import json
import os
import os.path as osp
from typing import Iterator, Optional, Tuple

import numpy as np

from .event_utils import EventSlicer, remove_hot_pixels_voxel, to_voxel_grid

try:
    import h5py
except Exception:  # pragma: no cover
    h5py = None


# ----------------------------------------------------------- EDS constants

# hard-coded undistorted event-camera intrinsics (load_utils.py:170-177)
EDS_INTRINSICS = {
    "calib0": np.asarray([562.9412231445312, 563.5700073242188,
                          310.53467429134616, 215.59711647292897], np.float32),
    "calib1": np.asarray([548.6773071289062, 551.0106201171875,
                          310.9592609123247, 218.11182443004145], np.float32),
}

# per-sequence start/stop crops (load_utils.py:909-957)
VECTOR_CROPS = {
    "corner_slow": (30, 1180), "robot_normal": (40, -1),
    "robot_fast": (30, 901), "desk_normal": (65, -1),
    "desk_fast": (25, 1380), "sofa_normal": (120, 2700),
    "sofa_fast": (50, 1200), "mountain_normal": (40, -1),
    "mountain_fast": (15, 1290), "hdr_normal": (30, -1),
    "hdr_fast": (35, -1), "corridors_dolly": (115, -1),
    "school_dolly": (80, 3160), "school_scooter": (20, 1290),
    "units_dolly": (20, 5750), "units_scooter": (10, 2790),
}

# (load_utils.py:1060-1092)
HKU_CROPS = {
    "hdr_tran_rota": (135, 3230), "HDR_slow": (240, 4150),
    "HDR_circle": (155, 2115), "hdr_agg": (145, 3600),
    "dark_normal": (150, 2805), "aggressive_walk": (150, 2385),
    "aggressive_translation": (165, 1795),
    "aggressive_small_flip": (150, 1585),
    "aggressive_rotation": (157, 1660),
}

# corrupt frames deleted outright (load_utils.py:1124-1127)
HKU_DEL_IDXS = {
    "HDR_circle": [1349, 1350, 1351, 1352, 1353, 1354],
    "HDR_slow": [3238, 3239, 3240, 3241, 3242],
}


def _crop_for(table, path):
    for key, (a, b) in table.items():
        if key in path:
            return a, b
    return 0, -1


def _read_rmap(path, H, W):
    with h5py.File(path, "r") as f:
        rmap = np.asarray(f["rectify_map"])
    assert rmap.shape == (H, W, 2), f"{path}: {rmap.shape} != ({H},{W},2)"
    return rmap


def _slicer_windows(events_h5, tss_us, intr, H, W, rect_map, dT_ms,
                    hotpix_stds=None, resize_to=None, parallel=False,
                    workers=8):
    """Common [ts, ts + dT] slicer loop (load_utils.py:47-77). With
    `parallel`, the timestamp list is split across processes like
    load_utils.py:121-131 / :384-435 (each worker reopens the h5)."""
    if parallel:
        yield from _parallel_windows(events_h5, tss_us, intr, H, W, rect_map,
                                     dT_ms, hotpix_stds, resize_to, workers)
        return
    with h5py.File(events_h5, "r") as f:
        slicer = EventSlicer(f)
        for ts_us in tss_us:
            t1_us = ts_us + dT_ms * 1e3
            ev = slicer.get_events(int(ts_us), int(t1_us))
            if ev is None or ev["t"].size < 2:
                continue
            vox = to_voxel_grid(ev["x"], ev["y"], ev["t"], ev["p"], H, W, 5,
                                rectify_map=rect_map)
            # trafos order is resize THEN hot-pixel filter, matching the
            # reference's trafos=[resize, RemoveHotPixelsVoxel]
            # (load_utils.py:101-112) — the sigma test runs on the
            # downscaled voxel
            if resize_to is not None:
                vox = _resize_voxel(vox, *resize_to)
            if hotpix_stds is not None:
                vox = remove_hot_pixels_voxel(vox, num_stds=hotpix_stds)
            # the emitted stamp is the window MIDPOINT (t0+t1)/2
            # (load_utils.py:76) — GT association breaks at start stamps
            yield vox, intr, float(ts_us + t1_us) / 2e6


def _worker_windows(args):
    (events_h5, tss_chunk, H, W, rect_map, dT_ms, hotpix_stds,
     resize_to) = args
    out = []
    with h5py.File(events_h5, "r") as f:
        slicer = EventSlicer(f)
        for ts_us in tss_chunk:
            t1_us = ts_us + dT_ms * 1e3
            ev = slicer.get_events(int(ts_us), int(t1_us))
            if ev is None or ev["t"].size < 2:
                continue
            vox = to_voxel_grid(ev["x"], ev["y"], ev["t"], ev["p"], H, W, 5,
                                rectify_map=rect_map)
            if resize_to is not None:     # resize BEFORE hotpix, see
                vox = _resize_voxel(vox, *resize_to)   # _slicer_windows
            if hotpix_stds is not None:
                vox = remove_hot_pixels_voxel(vox, num_stds=hotpix_stds)
            out.append((vox, float(ts_us + t1_us) / 2e6))
    return out


def _parallel_windows(events_h5, tss_us, intr, H, W, rect_map, dT_ms,
                      hotpix_stds, resize_to, workers):
    """Process-parallel voxelization (load_utils.py:384-435): split the
    timestamp list, voxelize chunks concurrently, re-emit in order."""
    import multiprocessing as mp

    chunks = np.array_split(np.asarray(tss_us), workers)
    args = [(events_h5, c.tolist(), H, W, rect_map, dT_ms, hotpix_stds,
             resize_to) for c in chunks if len(c)]
    ctx = mp.get_context("spawn")
    with ctx.Pool(len(args)) as pool:
        for chunk_out in pool.map(_worker_windows, args):
            for vox, ts_s in chunk_out:
                yield vox, intr, ts_s


def _resize_voxel(vox, H, W):
    """Bilinear (bins, h, w) -> (bins, H, W) resize (torchvision.Resize
    equivalent, load_utils.py:103)."""
    import cv2

    return np.stack([cv2.resize(v, (W, H), interpolation=cv2.INTER_LINEAR)
                     for v in vox])


def _scale_intrinsics(intr, H, W, H_orig, W_orig):
    """(load_utils.py:38-45)."""
    sx, sy = W / W_orig, H / H_orig
    return np.asarray([intr[0] * sx, intr[1] * sy, intr[2] * sx,
                       intr[3] * sy], np.float32)


def _ecd_windows(evs_txt_us, tss_us, intr, H, W, rect_map, dT_ms):
    """ECD-style text-event windows (load_utils.py:635-664): the emitted
    timestamp is min((t0 + t1)/2, next image stamp) and the LAST image is
    dropped. evs: (N, 4) [t_us, x, y, p]. dT_ms=None spans each window to
    the NEXT image stamp (the reference's DELTA_MS=None ECD default,
    load_utils.py:643-646)."""
    t = evs_txt_us[:, 0]
    for i, ts_us in enumerate(tss_us):
        if i == len(tss_us) - 1:
            break
        t0 = ts_us
        t1 = tss_us[i + 1] if dT_ms is None else ts_us + dT_ms * 1e3
        sel = (t >= t0) & (t < t1)
        if not sel.any():
            continue
        b = evs_txt_us[sel]
        if rect_map is not None:
            rect = rect_map[b[:, 2].astype(np.int32), b[:, 1].astype(np.int32)]
            vox = to_voxel_grid(rect[..., 0], rect[..., 1], b[:, 0], b[:, 3],
                                H, W, 5)
        else:
            vox = to_voxel_grid(b[:, 1], b[:, 2], b[:, 0], b[:, 3], H, W, 5)
        yield vox, intr, float(min((t0 + t1) / 2, tss_us[i + 1])) / 1e6


# ------------------------------------------------------------- iterators

def eds_evs_iterator(scenedir, calib1=False, stride=1, H=480, W=640,
                     parallel=False):
    """load_utils.py:184-262."""
    calibstr = "calib1" if calib1 else "calib0"
    intr = EDS_INTRINSICS[calibstr]
    rect = _read_rmap(osp.join(scenedir, f"rectify_map_{calibstr}.h5"),
                      480, 640)
    tss = np.sort(np.loadtxt(osp.join(scenedir, "images_timestamps_us.txt")))
    dT_ms = float(np.mean(np.diff(tss))) / 2e3          # HALF mean spacing
    tss = tss[0:-1:stride]
    resize = None
    if (H, W) != (480, 640):
        intr = _scale_intrinsics(intr, H, W, 480, 640)
        resize = (H, W)
    return _slicer_windows(osp.join(scenedir, "events.h5"), tss, intr,
                           480, 640, rect, dT_ms, hotpix_stds=10.0,
                           resize_to=resize, parallel=parallel)


def tumvie_evs_iterator(scenedir, camID=2, stride=1, H=720, W=1280,
                        dT_ms=None, parallel=False):
    """load_utils.py:84-159."""
    assert camID in (2, 3)
    side = "left" if camID == 2 else "right"
    intr = load_intrinsics_tumvie(scenedir, camID)
    rect = _read_rmap(glob.glob(
        osp.join(scenedir, f"rectify_map_{side}.h5"))[0], 720, 1280)
    ev = glob.glob(osp.join(scenedir, f"*events_{side}.h5"))[0]
    tss = np.sort(np.loadtxt(osp.join(
        scenedir, f"{side}_images_undistorted",
        f"image_timestamps_{side}.txt")))
    if dT_ms is None:
        dT_ms = float(np.mean(np.diff(tss))) / 1e3
    assert 3 < dT_ms < 100
    tss = tss[::stride]
    resize = None
    if (H, W) != (720, 1280):   # down-scaled evaluation (load_utils.py:103)
        intr = _scale_intrinsics(intr, H, W, 720, 1280)
        resize = (H, W)
    return _slicer_windows(ev, tss, intr, 720, 1280, rect, dT_ms,
                           hotpix_stds=6.0, resize_to=resize,
                           parallel=parallel)


def rpg_evs_iterator(scenedir, side="left", stride=1, dT_ms=None,
                     H=180, W=240):
    """load_utils.py:770-825."""
    intr = np.loadtxt(osp.join(scenedir, f"calib_undist_{side}.txt"))
    evs = np.loadtxt(glob.glob(osp.join(scenedir, f"evs_{side}.txt"))[0],
                     delimiter=" ")          # [t_us, x, y, p]
    rect = None if "simulation_3planes" in scenedir else _read_rmap(
        osp.join(scenedir, f"rectify_map_{side}.h5"), H, W)
    tss = np.sort(np.loadtxt(osp.join(scenedir, f"tss_imgs_us_{side}.txt")))
    if dT_ms is None:
        dT_ms = float(np.mean(np.diff(tss))) / 1e3
    assert 3 < dT_ms < 1000
    return _ecd_windows(evs, tss[::stride], np.asarray(intr, np.float32),
                        H, W, rect, dT_ms)


def fpv_evs_iterator(scenedir, stride=1, dT_ms=None, H=260, W=346,
                     tss_gt_us=None):
    """load_utils.py:1189-1258."""
    evs = np.loadtxt(glob.glob(osp.join(scenedir, "events.txt"))[0],
                     delimiter=" ")          # [t_s, x, y, p]
    evs[:, 0] = evs[:, 0] * 1e6
    t_off = np.loadtxt(osp.join(scenedir, "t_offset_us.txt")).astype(np.int64)
    evs[:, 0] -= t_off
    rect = _read_rmap(osp.join(scenedir, "rectify_map.h5"), H, W)
    intr = np.loadtxt(osp.join(scenedir, "calib_undist.txt"))
    tss = np.sort(np.loadtxt(osp.join(scenedir, "images_timestamps_us.txt")))
    imstart, imstop = 0, -1
    if tss_gt_us is not None:
        # GT much shorter than the recording: crop to the GT window
        # (load_utils.py:1218-1225)
        dT_imgs = tss[-1] - tss[0]
        dT_gt = tss_gt_us[-1] - tss_gt_us[0]
        if (dT_imgs - dT_gt) > 5e6 and (tss_gt_us[0] - tss[0]) > 5e6:
            imstart = int(np.where(tss > tss_gt_us[0])[0][0])
            imstop = int(np.where(tss < tss_gt_us[-1])[0][-1])
    if dT_ms is None:
        dT_ms = float(np.mean(np.diff(tss))) / 1e3
    assert 3 < dT_ms < 200
    return _ecd_windows(evs, tss[imstart:imstop:stride],
                        np.asarray(intr, np.float32), H, W, rect, dT_ms)


def ecd_evs_iterator(scenedir, stride=1, dT_ms=None, H=180, W=240):
    """load_utils.py:704-757 — 180x240 DAVIS240C Event Camera Dataset.

    events.txt is stamped in SECONDS -> us (unlike RPG's evs_*.txt which is
    already us, and like FPV but with no t_offset file); image stamps come
    from tss_us.txt (written by pp_ecd.py from images.txt); windows default
    to [ts, next image ts) (DELTA_MS=None, load_utils.py:643-646) rather
    than a mean-spacing dT like RPG/FPV; an explicit dT_ms must be in
    (5, 1000) (load_utils.py:705-706)."""
    if dT_ms is not None:
        assert 5 < dT_ms < 1000, f"dT_ms={dT_ms} outside (5, 1000)"
    evs_file = glob.glob(osp.join(scenedir, "events.txt"))
    assert len(evs_file) == 1, f"expected one events.txt under {scenedir}"
    evs = np.asarray(np.loadtxt(evs_file[0], delimiter=" "))  # [t_s, x, y, p]
    evs[:, 0] = evs[:, 0] * 1e6
    rect = _read_rmap(osp.join(scenedir, "rectify_map.h5"), H, W)
    intr = np.loadtxt(osp.join(scenedir, "calib_undist.txt"))
    assert len(intr) == 4                    # load_intrinsics_ecd (:592-597)
    tss = np.sort(np.loadtxt(osp.join(scenedir, "tss_us.txt")))
    return _ecd_windows(evs, tss[::stride], np.asarray(intr, np.float32),
                        H, W, rect, dT_ms)


def mvsec_evs_iterator(scenedir, side="left", stride=1, H=260, W=346):
    """load_utils.py:826-872: windows are EVENT-INDEX ranges between
    consecutive raw images (image_raw_event_inds), not time slices."""
    intr = np.asarray(np.loadtxt(
        osp.join(scenedir, f"calib_undist_{side}.txt")), np.float32)
    rect = _read_rmap(osp.join(scenedir, f"rectify_map_{side}.h5"), H, W)
    h5in = glob.glob(osp.join(scenedir, "*_data.hdf5"))
    assert len(h5in) == 1
    with h5py.File(h5in[0], "r") as f:
        num_imgs = f["davis"][side]["image_raw"].shape[0]
        event_idxs = np.asarray(f["davis"][side]["image_raw_event_inds"])
        all_evs = np.asarray(f["davis"][side]["events"])  # [x, y, t_s, p]
    tss = np.sort(np.loadtxt(osp.join(scenedir, f"tss_imgs_us_{side}.txt")))
    assert num_imgs == len(tss)
    # windows ALWAYS span consecutive images (the reference's stride arg is
    # unused, load_utils.py:851-860); stride only thins which voxels are
    # emitted — carrying `left` across strided frames would merge several
    # inter-image intervals into one voxel
    for i in range(num_imgs):
        left = int(event_idxs[i - 1]) if i > 0 else 0
        right = int(event_idxs[i])
        if i % stride:
            continue
        b = all_evs[left:right]
        if len(b) < 2:
            continue
        r = rect[b[:, 1].astype(np.int32), b[:, 0].astype(np.int32)]
        vox = to_voxel_grid(r[..., 0], r[..., 1], b[:, 2], b[:, 3], H, W, 5)
        yield vox, intr, float(tss[i]) / 1e6


def vector_evs_iterator(indir, side="left", stride=1, dT_ms=None,
                        H=480, W=640, parallel=False):
    """load_utils.py:959-1040."""
    intr = np.asarray(np.loadtxt(
        osp.join(indir, f"calib_undist_evs_{side}.txt")), np.float32)
    assert len(intr) == 4
    rect = _read_rmap(osp.join(indir, f"rectify_map_{side}.h5"), H, W)
    seq = indir.rstrip("/").split("/")[-1]
    ev = osp.join(indir, f"{seq}1.synced.{side}_event.hdf5")
    tss = np.loadtxt(osp.join(indir, f"tss_imgs_us_{side}.txt"))
    if dT_ms is None:
        dT_ms = float(np.mean(np.diff(tss))) / 1e3
    # fast sequences use half the window, others double (load_utils.py:980)
    dT_ms = dT_ms / 2.0 if "fast" in indir else dT_ms * 2.0
    assert 0 < dT_ms < 1000
    imstart, imstop = _crop_for(VECTOR_CROPS, indir)
    return _slicer_windows(ev, tss[imstart:imstop:stride], intr, H, W, rect,
                           dT_ms, parallel=parallel)


def hku_evs_iterator(indir, side="left", stride=1, dT_ms=None,
                     H=260, W=346, parallel=False):
    """load_utils.py:1096-1150 — crops + corrupt-frame deletion, NO
    hot-pixel filter."""
    intr = np.asarray(np.loadtxt(
        osp.join(indir, f"calib_undist_{side}.txt")), np.float32)
    assert len(intr) == 4
    rect = _read_rmap(osp.join(indir, f"rectify_map_{side}.h5"), H, W)
    ev = osp.join(indir, f"evs_{side}.h5")
    tss = np.loadtxt(osp.join(indir, f"tss_imgs_us_{side}.txt"))
    if dT_ms is None:
        dT_ms = float(np.mean(np.diff(tss))) / 1e3
    imstart, imstop = _crop_for(HKU_CROPS, indir)
    del_idxs = next((v for k, v in HKU_DEL_IDXS.items() if k in indir), None)
    if del_idxs is not None:
        drop = list(del_idxs) + list(range(0, imstart)) \
            + list(range(imstop, len(tss)))
        tss = np.delete(tss, [d for d in drop if d < len(tss)])[::stride]
    else:
        tss = tss[imstart:imstop:stride]
    return _slicer_windows(ev, tss, intr, H, W, rect, dT_ms,
                           parallel=parallel)


# ------------------------------------------------------------- GT loaders

def load_intrinsics_tumvie(scenedir, camID=2):
    """(load_utils.py:22-28): calibration json, camera list index camID."""
    with open(osp.join(scenedir, "calibration.json")) as f:
        calib = json.load(f)
    c = calib["value0"]["intrinsics"][camID]["intrinsics"]
    return np.asarray([c["fx"], c["fy"], c["cx"], c["cy"]], np.float32)


def _check_traj(traj, path):
    # sortedness asserts mirror the reference loaders (load_utils.py:607,
    # 616): eval/ate.associate() searchsorts the GT stamps, so an unsorted
    # file would silently pair poses with wrong timestamps
    assert traj.ndim == 2 and traj.shape[1] == 8, \
        f"{path}: expected (N, 8) [t x y z qx qy qz qw], got {traj.shape}"
    assert np.all(np.diff(traj[:, 0]) >= 0), f"{path}: stamps not sorted"


def load_eds_traj(path):
    """stamped GT in us, one header row (load_utils.py:573-581)."""
    traj = np.loadtxt(path, delimiter=" ", skiprows=1)
    _check_traj(traj, path)
    return traj[:, 0].copy(), traj[:, 1:]


load_tumvie_traj = load_eds_traj     # identical format (load_utils.py:583)


def load_ecd_gt(path, skiprows=0):
    """GT stamped in SECONDS -> us (load_utils.py:604-611)."""
    traj = np.loadtxt(path, delimiter=" ", skiprows=skiprows)
    _check_traj(traj, path)
    return traj[:, 0].copy() * 1e6, traj[:, 1:]


def load_gt_us(path, skiprows=0):
    """(load_utils.py:613-620)."""
    traj = np.loadtxt(path, delimiter=" ", skiprows=skiprows)
    _check_traj(traj, path)
    return traj[:, 0].copy(), traj[:, 1:]


def load_mvsec_traj(scenedir, side="left"):
    """Homogeneous (N, 4, 4) GT from <seq>_gt.hdf5 (load_utils.py:560-571)."""
    from devo_tpu_torch.utils.pose_utils import poses_hom_to_quat

    seq = scenedir.rstrip("/").split("/")[-1]
    base = seq[:-5] if seq.endswith("_data") else seq
    gt = glob.glob(osp.join(scenedir, f"{base}*_gt.hdf5"))
    assert gt, f"no *_gt.hdf5 under {scenedir}"
    with h5py.File(gt[0], "r") as f:
        traj_h = np.asarray(f["davis"][side]["pose"])         # (N, 4, 4)
        tss_us = np.asarray(f["davis"][side]["pose_ts"],
                            np.float64) * 1e6
    return tss_us, poses_hom_to_quat(traj_h)


# --------------------------------------------------------------- registry

ITERATORS = {
    "ecd": ecd_evs_iterator,
    "eds": eds_evs_iterator,
    "tumvie": tumvie_evs_iterator,
    "rpg": rpg_evs_iterator,
    "fpv": fpv_evs_iterator,
    "mvsec": mvsec_evs_iterator,
    "vector": vector_evs_iterator,
    "hku": hku_evs_iterator,
}


def load_benchmark_gt(benchmark: str, datapath: str, side: str = "left"):
    """Per-benchmark GT resolution (the files each reference eval script
    loads): returns (tss_us, traj (N, 7)). Every candidate file is
    MICROSECOND-stamped:
      rpg    gt_stamped_{side}.txt   written in us by pp_rpg.py:16-18,
                                     loaded with load_gt_us (NO unit
                                     conversion, eval_rpg_evs.py:50)
      vector poses_evs_{side}.txt    body->event-camera GT written by
                                     pp_vector.py:66-69 (eval_vector_evs.py:42)
      hku    gt_stamped_{side}.txt   eval_hku_evs.py:40
      fpv    stamped_groundtruth_us_cam.txt  CAMERA-frame GT via T_cam_imu
                                     (pp_fpv.py:19-43, eval_fpv_evs.py:55);
                                     the body/IMU-frame file is a fallback
                                     with the lever-arm caveat
    Falls back to the generic stamped file."""
    b = benchmark.lower()
    if b == "mvsec":
        return load_mvsec_traj(datapath, side=side)
    if b == "ecd":
        # ECD ships groundtruth.txt stamped in SECONDS (load_ecd_gt,
        # load_utils.py:604-611)
        for c in ("groundtruth.txt", "stamped_groundtruth.txt"):
            p = osp.join(datapath, c)
            if osp.exists(p):
                return load_ecd_gt(p)
        raise FileNotFoundError(f"no ECD GT file under {datapath}")
    candidates = {
        "eds": ["stamped_groundtruth_us.txt"],
        "tumvie": ["mocap_data.txt", "stamped_groundtruth_us.txt"],
        "rpg": [f"gt_stamped_{side}.txt", "stamped_groundtruth_us.txt"],
        "fpv": ["stamped_groundtruth_us_cam.txt",
                "stamped_groundtruth_us.txt"],
        "vector": [f"poses_evs_{side}.txt", "gt_stamped_us.txt",
                   "stamped_groundtruth_us.txt"],
        "hku": [f"gt_stamped_{side}.txt", "gt_stamped_us.txt",
                "stamped_groundtruth_us.txt"],
    }.get(b, ["stamped_groundtruth_us.txt"])
    for c in candidates:
        p = osp.join(datapath, c)
        if osp.exists(p):
            skip = 1 if b in ("eds", "tumvie") else 0
            return load_gt_us(p, skiprows=skip)
    raise FileNotFoundError(f"no GT file under {datapath} "
                            f"(tried {candidates})")


def benchmark_evs_iterator(benchmark: str, datapath: str, stride: int = 1,
                           tss_gt_us=None, **kw):
    """Dispatch to the benchmark's quirk-aware iterator; unknown benchmarks
    fall back to the generic preprocessed-tree iterator in loaders.py."""
    b = benchmark.lower()
    if b in ITERATORS:
        if b == "fpv":
            return fpv_evs_iterator(datapath, stride=stride,
                                    tss_gt_us=tss_gt_us, **kw)
        return ITERATORS[b](datapath, stride=stride, **kw)
    from .loaders import benchmark_iterator
    return benchmark_iterator(b, datapath, stride=stride)
