"""TartanAir RGB / E2VID training datasets and the RGB-D augmentor.

The port's own copy of devo_tpu/data/rgbd.py: the NumPy host-side
counterpart of upstream DEVO's devo/data_readers/
{base.py:23-201 (RGBDDataset), tartan.py:16-139 (TartanAir, TartanAirE2VID),
augmentation.py:16-75 (RGBDAugmentor)}. Feeds the frame-input (3-channel)
model family — the RGB / E2VID-reconstruction training paths that mirror the
event-voxel TartanAirEVS pipeline.

Torch-free: color jitter and the spatial transform are implemented directly
in NumPy/cv2 with torchvision-equivalent semantics (shared jitter parameters
across the clip, bicubic image resize, nearest depth resize, center crop).
"""
from __future__ import annotations

import glob
import os.path as osp
import pickle
from typing import Dict, Optional, Tuple

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

from .tartan import (DEPTH_SCALE, TARTAN_INTRINSICS, TartanAirEVS,
                     build_frame_graph, depth_read)


# --------------------------------------------------------------- color jitter

def _rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma (PIL 'L' mode), channel-last."""
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])


def _blend(a: np.ndarray, b: np.ndarray, f: float) -> np.ndarray:
    return np.clip(f * a + (1.0 - f) * b, 0.0, 255.0)


def _adjust_hue(img: np.ndarray, shift: float) -> np.ndarray:
    """Hue rotation by `shift` (fraction of a full turn), RGB channel-last
    in [0, 255]."""
    hsv = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_RGB2HSV)
    h = hsv[..., 0].astype(np.int32)  # OpenCV hue in [0, 180)
    hsv[..., 0] = ((h + int(round(shift * 180.0))) % 180).astype(hsv.dtype)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32)


class RGBDAugmentor:
    """Color jitter + random grayscale/invert + scaled center crop
    (augmentation.py:16-75).

    images: (N, H, W, 3) float32 RGB in [0, 255]; depths (N, H, W);
    intrinsics (N, 4). Jitter parameters are shared across the clip (the
    reference concatenates the clip into one wide image, augmentation.py:67).
    """

    def __init__(self, crop_size: Tuple[int, int],
                 rng: Optional[np.random.Generator] = None):
        self.crop_size = crop_size
        self.max_scale = 0.5
        self.rng = rng or np.random.default_rng()

    def color_transform(self, images: np.ndarray) -> np.ndarray:
        # stored order is BGR (image_read == base.py:73); the jitter math
        # runs in RGB like the reference and swaps back at the end
        # (augmentation.py:68-69)
        images = images[..., ::-1]
        r = self.rng
        # ColorJitter(brightness=.4, contrast=.4, saturation=.4, hue=.2/pi)
        ops = []
        b = r.uniform(0.6, 1.4)
        ops.append(lambda im: _blend(im, np.zeros(()), b))
        c = r.uniform(0.6, 1.4)
        # contrast blends against ONE gray mean shared by the whole clip:
        # the reference concatenates the clip into a single wide image
        # before torchvision's adjust_contrast (augmentation.py:67-69)
        ops.append(lambda im: _blend(im, _rgb_to_gray(im).mean(), c))
        s = r.uniform(0.6, 1.4)
        ops.append(lambda im: _blend(im, _rgb_to_gray(im)[..., None], s))
        h = r.uniform(-0.2 / np.pi, 0.2 / np.pi)
        ops.append(lambda im: np.stack(
            [_adjust_hue(f, h) for f in im]))
        for i in r.permutation(4):
            images = ops[i](images)
        if r.random() < 0.1:  # RandomGrayscale
            images = np.repeat(_rgb_to_gray(images)[..., None], 3, axis=-1)
        if r.random() < 0.1:  # RandomInvert
            images = 255.0 - images
        return images[..., ::-1].astype(np.float32)

    def spatial_transform(self, images, depths, intrinsics):
        ht, wd = images.shape[1:3]
        min_scale = np.log2(max((self.crop_size[0] + 1) / ht,
                                (self.crop_size[1] + 1) / wd))
        scale = 1.0
        if self.rng.random() < 0.8:
            # reference samples U(0, max_scale) here (augmentation.py:41),
            # unlike the EVSD path's U(min_scale, 0.25)
            scale = 2 ** self.rng.uniform(max(0.0, min_scale), self.max_scale)
        nh, nw = int(scale * ht), int(scale * wd)
        images = np.stack([cv2.resize(f, (nw, nh), interpolation=cv2.INTER_CUBIC)
                           for f in images])
        depths = np.stack([cv2.resize(d, (nw, nh),
                                      interpolation=cv2.INTER_NEAREST)
                           for d in depths])
        intrinsics = intrinsics * scale
        y0 = (nh - self.crop_size[0]) // 2
        x0 = (nw - self.crop_size[1]) // 2
        intrinsics = intrinsics - np.asarray([0.0, 0.0, x0, y0], np.float32)
        images = images[:, y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        depths = depths[:, y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return images, depths, intrinsics

    def __call__(self, images, poses, depths, intrinsics):
        if self.rng.random() < 0.5:
            images = self.color_transform(images)
        images, depths, intrinsics = self.spatial_transform(
            np.clip(images, 0.0, 255.0), depths, intrinsics)
        return images.astype(np.float32), poses, depths, intrinsics


# ------------------------------------------------------------------- datasets

def image_read(image_file: str) -> np.ndarray:
    """BGR channel-last float32 in [0, 255] — the order the NETWORK consumes
    in the reference (base.py:73 cv2.imread feeds BGR straight through; the
    jitter path swaps to RGB only internally and swaps back,
    augmentation.py:68-69). Weight-imported RGB models expect BGR input."""
    img = cv2.imread(image_file)
    assert img is not None, f"unreadable image {image_file}"
    return img.astype(np.float32)


class TartanAirRGB(TartanAirEVS):
    """RGB frame clips over the TartanAir layout (tartan.py:16-74). Reuses
    the EVS clip sampler / frame graph; only discovery + frame IO differ."""

    frame_key = "images"

    def __init__(self, root: str, aug: bool = True,
                 crop_size: Tuple[int, int] = (480, 640), **kw):
        super().__init__(root, aug=False, **kw)
        self.aug = RGBDAugmentor(crop_size, self.rng) if aug else None

    def _scene_frames(self, scene: str):
        imgs = sorted(glob.glob(osp.join(scene, "imgs/*.png")))
        depths = sorted(glob.glob(osp.join(
            scene.replace("image_left", "depth_left"), "depth_left/*.npy")))
        return imgs, depths, 0

    def _discover(self):
        return [osp.dirname(s) for s in sorted(
            glob.glob(osp.join(self.root, "**/image_left/**/imgs"),
                      recursive=True))]

    def _build_dataset(self) -> Dict:
        scene_info = {}
        for scene in self._discover():
            frames, depths, pose_skip = self._scene_frames(scene)
            if not frames or len(frames) != len(depths):
                continue
            poses = self._pose_read(scene)[pose_skip:]
            if poses.shape[0] != len(frames):
                continue
            graph = build_frame_graph(poses, depths, TARTAN_INTRINSICS,
                                      depth_read=depth_read)
            scene_info[scene] = dict(
                voxels=frames, depths=depths, poses=poses,
                intrinsics=[TARTAN_INTRINSICS] * len(frames), graph=graph)
        return scene_info

    @staticmethod
    def _pose_read(scene: str) -> np.ndarray:
        pfile = osp.join(scene, "pose_left.txt")
        poses = np.loadtxt(pfile, delimiter=" ")
        poses = poses[:, [1, 2, 0, 4, 5, 3, 6]]  # NED -> camera (tartan.py:44)
        poses[:, :3] /= DEPTH_SCALE
        return poses.astype(np.float32)

    def __getitem__(self, index):
        scene, ix = self.dataset_index[index % len(self.dataset_index)]
        info = self.scene_info[scene]
        inds = self._sample_inds(scene, ix)

        images = np.stack([image_read(info["voxels"][i]) for i in inds])
        depths = np.stack([depth_read(info["depths"][i]) for i in inds])
        poses = np.stack([info["poses"][i] for i in inds])
        intr = np.stack([info["intrinsics"][i] for i in inds])

        disps = 1.0 / depths
        if self.aug is not None:
            images, poses, disps, intr = self.aug(images, poses, disps, intr)

        s = 0.7 * np.quantile(disps, 0.98)  # base.py:186-189
        disps = disps / s
        poses = poses.copy()
        poses[:, :3] *= s
        return images, poses, disps, intr


class TartanAirE2VID(TartanAirRGB):
    """E2VID reconstruction clips (tartan.py:77-139): images live under
    e2v/.../e2calib, depths/poses come from the parallel RGB layout with the
    first frame dropped (reconstructions start at frame 1)."""

    def _scene_frames(self, scene: str):
        imgs = sorted(glob.glob(osp.join(scene, "e2calib/*.png")))
        depths = sorted(glob.glob(osp.join(
            scene.replace("e2v", "depth_left"), "depth_left/*.npy")))[1:]
        return imgs, depths, 1

    def _discover(self):
        return [osp.dirname(s) for s in sorted(
            glob.glob(osp.join(self.root, "**/e2v/**/e2calib"),
                      recursive=True))]

    @staticmethod
    def _pose_read(scene: str) -> np.ndarray:
        pfile = osp.join(scene.replace("e2v", "image_left"), "pose_left.txt")
        poses = np.loadtxt(pfile, delimiter=" ")
        poses = poses[:, [1, 2, 0, 4, 5, 3, 6]]
        poses[:, :3] /= DEPTH_SCALE
        return poses.astype(np.float32)
