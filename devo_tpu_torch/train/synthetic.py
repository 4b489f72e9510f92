"""Synthetic training clips in memory: the bench's sliding event texture
(devo_tpu_torch.bench) seen by a camera that moves along x at constant
depth, so that the texture's 3 pixels a frame are the ground truth's
optical flow. For the train-step drivers and the smoke run on a machine
without a TartanAir-EVS tree; items look like TartanAirEVS's.
"""
from __future__ import annotations

import numpy as np

from devo_tpu_torch import bench

SHIFT = 3.0          # pixels a frame the texture slides (bench.frame)


class SyntheticClips:
    """Clips of `n_frames` frames of the sliding texture at ht x wd, item i
    starting at frame 5 * i, modulo the starts whose clip stays inside one
    period of the texture (it wraps after wd / 3 frames). An item is (voxels (n, bins, H, W), poses
    (n, 7) world-to-camera, disps (n, H, W), intrinsics (n, 4)), f32: the
    camera moves SHIFT / (fx * disp) along x a frame, no rotation, and every
    pixel has disparity `disp`."""

    def __init__(self, n_frames: int = 15, ht: int = 480, wd: int = 640,
                 bins: int = 5, disp: float = 1.0, length: int = 64):
        self.n_frames = n_frames
        self.ht, self.wd = ht, wd
        self.disp = disp
        self.length = length
        self.base = bench.texture(ht, wd, bins)
        self.intrinsics = bench.intrinsics(ht, wd)

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        starts = max(self.wd // int(SHIFT) - self.n_frames + 1, 1)
        start = (5 * (index % self.length)) % starts
        frames = [bench.frame(self.base, start + i) for i in range(self.n_frames)]
        voxels = np.stack([f.transpose(2, 0, 1) for f in frames]).astype(np.float32)
        step = SHIFT / (self.intrinsics[0] * self.disp)
        poses = np.zeros((self.n_frames, 7), np.float32)
        poses[:, 0] = -step * (start + np.arange(self.n_frames))
        poses[:, 6] = 1.0
        disps = np.full((self.n_frames, self.ht, self.wd), self.disp, np.float32)
        intr = np.tile(self.intrinsics[None], (self.n_frames, 1))
        return voxels, poses, disps, intr
