"""TartanAir event-voxel training dataset, host side (the port's own copy
of devo_tpu/data/tartan.py, after upstream DEVO's devo/data_readers/
{base.py, tartan.py, augmentation.py, rgbd_utils.py, projective_ops.py}).

Scene discovery over the converted TartanAir-EVS layout, a co-visibility
frame graph built from camera-motion-induced optical flow, clip sampling by
graph walk, the EVSD augmentor (value jitter + random rescale + center
crop), and the disparity / pose normalization (s = 0.7 * q98, base.py:
368-371). NumPy alone, so that it runs in the loader's worker threads; with
one seed it gives devo_tpu's clips bit for bit. h5py is imported where a
voxel file is read: the card's machine has none and reads no h5 tree.
"""
from __future__ import annotations

import glob
import os
import os.path as osp
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

DEPTH_SCALE = 5.0     # tartan.py:143
MIN_DEPTH = 0.2


# ------------------------------------------------------- dense flow geometry

def _quat_rot(q, v):
    qv, qw = q[..., :3], q[..., 3:4]
    uv = 2.0 * np.cross(qv, v)
    return v + qw * uv + np.cross(qv, uv)


def _pose_inv(p):
    qinv = p[..., 3:7] * np.asarray([-1.0, -1.0, -1.0, 1.0])
    return np.concatenate([-_quat_rot(qinv, p[..., :3]), qinv], -1)


def _pose_mul(a, b):
    x1, y1, z1, w1 = np.split(a[..., 3:7], 4, -1)
    x2, y2, z2, w2 = np.split(b[..., 3:7], 4, -1)
    q = np.concatenate([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)
    t = a[..., :3] + _quat_rot(a[..., 3:7], b[..., :3])
    return np.concatenate([t, q], -1)


def _flow_mag(X0, x, y, Gij, intrinsics):
    """Mean induced-flow magnitude for ONE direction given the source
    frame's precomputed back-projection X0 (..., 4) and the relative pose
    Gij (data_readers/projective_ops.py:98-140). Returns (mag, valid_frac)."""
    fx, fy, cx, cy = intrinsics
    Xr = _quat_rot(Gij[3:7][None, None], X0[..., :3]) + Gij[:3][None, None] * X0[..., 3:4]
    Z = Xr[..., 2]
    zi = 1.0 / np.maximum(Z, 0.1)
    x1 = fx * Xr[..., 0] * zi + cx
    y1 = fy * Xr[..., 1] * zi + cy
    flow = np.stack([x1 - x, y1 - y], -1)
    valid = (Z > MIN_DEPTH) & (X0[..., 2] > MIN_DEPTH)

    mag = np.minimum(np.linalg.norm(flow, axis=-1), 100.0)
    vfrac = valid.mean()
    if vfrac < 1e-6:
        return np.inf, 0.0
    return float((mag * valid).sum() / valid.sum()), float(vfrac)


def _backproject_all(disps, intrinsics):
    """Per-frame pinhole back-projection (N, H, W, 4), hoisted out of the
    O(N^2) pair loop."""
    N, H, W = disps.shape
    fx, fy, cx, cy = intrinsics
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    X0 = np.empty((N, H, W, 4), np.float32)
    X0[..., 0] = (x - cx) / fx
    X0[..., 1] = (y - cy) / fy
    X0[..., 2] = 1.0
    X0[..., 3] = disps
    return X0, x, y


def induced_flow_mag(poses_w2c, disps, intrinsics, i, j):
    """One-pair convenience wrapper (kept for tests/direct use)."""
    X0, x, y = _backproject_all(disps, intrinsics)
    Gij = (_pose_mul(poses_w2c[j], _pose_inv(poses_w2c[i])) if i != j
           else np.asarray([-0.1, 0, 0, 0, 0, 0, 1.0], np.float32))
    return _flow_mag(X0[i], x, y, Gij, intrinsics)


def compute_distance_matrix_flow(poses_c2w, disps, intrinsics):
    """All-pairs bidirectional flow distance (rgbd_utils.py:104-142).

    d[i, j] = (mag(i->j) + mag(j->i)) / 2 is symmetric by construction, so
    only the upper triangle is evaluated and mirrored, with the per-frame
    back-projection hoisted — 4x fewer dense flow evaluations than the
    reference's full ordered-pair loop for identical values."""
    N = poses_c2w.shape[0]
    poses_w2c = _pose_inv(poses_c2w)
    X0, x, y = _backproject_all(disps, intrinsics)
    G_self = np.asarray([-0.1, 0, 0, 0, 0, 0, 1.0], np.float32)
    d = np.zeros((N, N), np.float32)
    for i in range(N):
        m, v = _flow_mag(X0[i], x, y, G_self, intrinsics)
        d[i, i] = np.inf if v < 0.7 else m
        inv_i = _pose_inv(poses_w2c[i])
        for j in range(i + 1, N):
            m1, v1 = _flow_mag(X0[i], x, y,
                               _pose_mul(poses_w2c[j], inv_i), intrinsics)
            m2, v2 = _flow_mag(X0[j], x, y,
                               _pose_mul(poses_w2c[i], _pose_inv(poses_w2c[j])),
                               intrinsics)
            val = np.inf if min(v1, v2) < 0.7 else 0.5 * (m1 + m2)
            d[i, j] = d[j, i] = val
    return d


def build_frame_graph(poses_c2w, depth_files, intrinsics, f=16, max_flow=256,
                      depth_read=None):
    """Co-visibility graph {i: (frames, distances)} (base.py:79-102)."""
    def read_disp(fn):
        depth = depth_read(fn)[f // 2::f, f // 2::f]
        depth[depth < 0.01] = np.mean(depth)
        return 1.0 / depth

    disps = np.stack([read_disp(fn) for fn in depth_files], 0)
    d = f * compute_distance_matrix_flow(poses_c2w, disps, np.asarray(intrinsics) / f)
    graph = {}
    for i in range(d.shape[0]):
        j, = np.where(d[i] < max_flow)
        graph[i] = (j, d[i, j])
    return graph


# ------------------------------------------------------------- augmentation

def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """align_corners=False bilinear resize of (..., H, W)."""
    H, W = img.shape[-2:]
    ys = (np.arange(out_h) + 0.5) * H / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * W / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)
    wx = np.clip(xs - x0, 0.0, 1.0)
    a = img[..., y0, :][..., :, x0]
    b = img[..., y0, :][..., :, x1]
    c = img[..., y1, :][..., :, x0]
    e = img[..., y1, :][..., :, x1]
    top = a * (1 - wx) + b * wx
    bot = c * (1 - wx) + e * wx
    return top * (1 - wy[..., :, None]) + bot * wy[..., :, None]


def _nearest_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """F.interpolate(mode='nearest') resize of (..., H, W) — the mode the
    reference uses for DEPTHS (augmentation.py:135, default mode): bilinear
    blending at depth discontinuities would invent 'flying pixel' values
    that lie on no real surface."""
    H, W = img.shape[-2:]
    ys = np.minimum((np.arange(out_h) * H // out_h), H - 1)
    xs = np.minimum((np.arange(out_w) * W // out_w), W - 1)
    return img[..., ys, :][..., :, xs]


class EVSDAugmentor:
    """Voxel value jitter + random rescale + center crop
    (augmentation.py:92-174)."""

    def __init__(self, crop_size: Tuple[int, int], rng: Optional[np.random.Generator] = None):
        self.crop_size = crop_size
        self.max_scale = 0.25
        self.rng = rng or np.random.default_rng()

    def __call__(self, voxels, poses, depths, intrinsics):
        # value jitter (augmentation.py:79-89)
        voxels = voxels + (self.rng.random(voxels.shape).astype(np.float32) - 0.5) * 2e-4

        ht, wd = voxels.shape[-2:]
        min_scale = np.log2(max((self.crop_size[0] + 1) / ht,
                                (self.crop_size[1] + 1) / wd))
        scale = 1.0
        if self.rng.random() < 0.8:
            scale = 2 ** self.rng.uniform(min_scale, self.max_scale)

        nh, nw = int(round(ht * scale)), int(round(wd * scale))
        voxels = _bilinear_resize(voxels, nh, nw).astype(np.float32)
        depths = _nearest_resize(depths, nh, nw).astype(np.float32)
        intrinsics = intrinsics * scale

        y0 = (nh - self.crop_size[0]) // 2
        x0 = (nw - self.crop_size[1]) // 2
        intrinsics = intrinsics - np.asarray([0.0, 0.0, x0, y0], np.float32)
        voxels = voxels[..., y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        depths = depths[..., y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return voxels, poses, depths, intrinsics


# ------------------------------------------------------------------ dataset

def depth_read(depth_file: str) -> np.ndarray:
    depth = np.load(depth_file) / DEPTH_SCALE
    depth[np.isnan(depth)] = 1.0
    depth[np.isinf(depth)] = 1.0
    return depth


def voxel_read(voxel_file: str) -> np.ndarray:
    import h5py

    with h5py.File(voxel_file, "r") as h5:
        return np.asarray(h5["voxel"], np.float32)


def pose_read(scene: str) -> np.ndarray:
    # restructured tree (<difficulty>/image_left/<traj>/pose_left.txt,
    # the reference layout) or an in-place conversion over a raw TartanAir
    # tree (<traj>/pose_left.txt next to image_left/, scripts/convert_tartan)
    cands = [osp.join(scene.replace("evs_left", "image_left"),
                      "pose_left.txt"),
             osp.join(osp.dirname(scene), "pose_left.txt")]
    path = next((p for p in cands if osp.exists(p)), cands[0])
    poses = np.loadtxt(path, delimiter=" ")[1:]
    poses = poses[:, [1, 2, 0, 4, 5, 3, 6]]     # NED -> camera frame (tartan.py:174)
    poses[:, :3] /= DEPTH_SCALE
    return poses.astype(np.float32)


TARTAN_INTRINSICS = np.asarray([320.0, 320.0, 320.0, 240.0], np.float32)


def evs_scene_dir(root: str, entry: str) -> str:
    """Resolve a split-file entry (<env>/<env>/<difficulty>/<Pxxx>) to its
    evs_left scene dir: the converted data tree inserts evs_left before the
    trajectory component (<...>/<difficulty>/evs_left/<Pxxx>/h5/*.h5).
    Entries that already contain evs_left pass through."""
    entry = entry.rstrip("/")
    if "evs_left" in entry:
        return os.path.join(root, entry)
    head, tail = os.path.split(entry)
    return os.path.join(root, head, "evs_left", tail)


class TartanAirEVS:
    """Clip-sampling dataset over converted TartanAir-EVS scenes
    (tartan.py:140-207 + base.py:288-383)."""

    def __init__(self, root: str, n_frames: int = 15, fmin: float = 16.0,
                 fmax: float = 96.0, aug: bool = True,
                 crop_size: Tuple[int, int] = (480, 640),
                 cache_path: Optional[str] = None, seed: int = 0):
        self.root = root
        self.n_frames = n_frames
        self.fmin, self.fmax = fmin, fmax
        self.rng = np.random.default_rng(seed)
        self.aug = EVSDAugmentor(crop_size, self.rng) if aug else None

        if cache_path and osp.exists(cache_path):
            with open(cache_path, "rb") as f:
                self.scene_info = pickle.load(f)
        else:
            self.scene_info = self._build_dataset()
            if cache_path:
                with open(cache_path, "wb") as f:
                    pickle.dump(self.scene_info, f)

        self.dataset_index = []
        for scene, info in self.scene_info.items():
            graph = info["graph"]
            for i in graph:
                if len(graph[i][0]) > self.n_frames:
                    self.dataset_index.append((scene, i))

    def _build_dataset(self) -> Dict:
        scene_info = {}
        scenes = sorted(glob.glob(osp.join(self.root, "**/evs_left/**/h5"),
                                  recursive=True))
        scenes = [osp.dirname(s) for s in scenes]
        for scene in scenes:
            voxels = sorted(glob.glob(osp.join(scene, "h5/*.h5")))
            # restructured layout first (reference tartan.py:158), then an
            # in-place conversion over a raw tree (<traj>/depth_left/*.npy)
            depths = sorted(glob.glob(osp.join(
                scene.replace("evs_left", "depth_left"), "depth_left/*.npy")))
            if not depths:
                depths = sorted(glob.glob(osp.join(
                    osp.dirname(scene), "depth_left", "*.npy")))
            depths = depths[1:]   # no event voxel at t=0 (tartan.py:158)
            if not voxels or len(voxels) != len(depths):
                if voxels:
                    print(f"[tartan] skipping {scene}: {len(voxels)} voxels "
                          f"vs {len(depths)} depths")
                continue
            poses = pose_read(scene)
            # truncated/mismatched pose files must fail here, not as an
            # IndexError mid-training (reference asserts, tartan.py:176)
            assert poses.shape[0] == len(voxels), \
                f"{scene}: {poses.shape[0]} poses vs {len(voxels)} voxels"
            intr = [TARTAN_INTRINSICS] * len(voxels)
            graph = build_frame_graph(poses, depths, TARTAN_INTRINSICS,
                                      depth_read=depth_read)
            scene_info[scene] = dict(voxels=voxels, depths=depths, poses=poses,
                                     intrinsics=intr, graph=graph)
        return scene_info

    def _sample_inds(self, scene: str, ix: int) -> List[int]:
        """Co-visibility walk preferring forward-in-time frames
        (base.py:305-341, sample=True path)."""
        graph = self.scene_info[scene]["graph"]
        n_total = len(self.scene_info[scene]["voxels"])
        inds = [ix]
        while len(inds) < self.n_frames:
            frames, dist = graph[ix]
            k = (dist > self.fmin) & (dist < self.fmax)
            frames = frames[k]
            forward = frames[frames > ix]
            if len(forward) > 0:
                ix = int(self.rng.choice(forward))
            elif ix + 1 < n_total:
                ix = ix + 1
            elif len(frames) > 0:
                ix = int(self.rng.choice(frames))
            inds.append(ix)
        return inds

    def __len__(self):
        return len(self.dataset_index)

    def __getitem__(self, index):
        scene, ix = self.dataset_index[index % len(self.dataset_index)]
        info = self.scene_info[scene]
        inds = self._sample_inds(scene, ix)

        voxels = np.stack([voxel_read(info["voxels"][i]) for i in inds])
        depths = np.stack([depth_read(info["depths"][i]) for i in inds])
        poses = np.stack([info["poses"][i] for i in inds])
        intr = np.stack([info["intrinsics"][i] for i in inds])

        disps = 1.0 / depths
        if self.aug is not None:
            voxels, poses, disps, intr = self.aug(voxels, poses, disps, intr)

        # normalize depth scale (base.py:368-371)
        s = 0.7 * np.quantile(disps, 0.98)
        disps = disps / s
        poses = poses.copy()
        poses[:, :3] *= s
        return voxels, poses, disps, intr
