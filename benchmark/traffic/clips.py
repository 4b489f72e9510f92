"""The training traffic's generator: clips of a seeded sparse event
texture sliding `shift_px` pixels a frame, seen by a camera that moves
along x at constant disparity, so that the texture's slide is the ground
truth's optical flow (after the port's train/synthetic.py, with the
texture drawn from the seed). Item s, for step s, starts at frame
5 * s within one period of the texture.

A mix's file (traffic/<name>.json) gives `shift_px`, `disp`, `density`
and `length` (the items before they repeat).

The texture is drawn once on the host and kept on the device; a batch is
sliced from it there, so that a step's data costs a few copies on the
card and no host work or host-to-device copy, as a loader that prefetches
ahead of the step would leave it.
"""
from __future__ import annotations

import numpy as np


def seed_sequence(seed: int, *keys: int) -> np.random.SeedSequence:
    """The seed sequence of (seed, keys...); any whole seed, also one wider
    than 32 bits or negative."""
    return np.random.SeedSequence([seed % (1 << 64), *keys])


def derived_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for a torch.Generator, from (seed, keys...)."""
    return int(seed_sequence(seed, *keys).generate_state(2, np.uint64)[0]
               >> np.uint64(1))


class Clips:
    def __init__(self, seed: int, n_frames: int, ht: int, wd: int, bins: int,
                 shift_px: float = 3.0, disp: float = 1.0,
                 density: float = 0.1, length: int = 64, device="cpu"):
        import torch
        rng = np.random.default_rng(seed_sequence(seed, 4))
        base = rng.standard_normal((ht, 2 * wd, bins), dtype=np.float32)
        base *= rng.random((ht, 2 * wd, bins), dtype=np.float32) < density
        self.base = torch.from_numpy(base).to(device)
        self.device = self.base.device
        self.n_frames, self.ht, self.wd = n_frames, ht, wd
        self.shift, self.disp, self.length = int(shift_px), disp, length
        self.intrinsics = np.asarray([wd / 2, wd / 2, wd / 2, ht / 2],
                                     np.float32)

    def start(self, index: int) -> int:
        """The first texture frame of item `index`."""
        starts = max(self.wd // self.shift - self.n_frames + 1, 1)
        return (5 * (index % self.length)) % starts

    def poses(self, start: int) -> np.ndarray:
        """(n, 7) world-to-camera poses of the frames from `start`, f32."""
        step = self.shift / (self.intrinsics[0] * self.disp)
        poses = np.zeros((self.n_frames, 7), np.float32)
        poses[:, 0] = -step * (start + np.arange(self.n_frames))
        poses[:, 6] = 1.0
        return poses

    def batch(self, indices):
        """Items stacked as the port's trainer takes them, on the device:
        voxels (B, n, H, W, bins) channels-last, poses (B, n, 7), disps
        (B, n, H, W), intrinsics (B, 4), f32."""
        import torch
        starts = [self.start(int(i)) for i in indices]
        cols = [(self.shift * (s + f)) % self.wd
                for s in starts for f in range(self.n_frames)]
        voxels = torch.stack([self.base[:, c:c + self.wd] for c in cols])
        B, n = len(starts), self.n_frames
        poses = np.stack([self.poses(s) for s in starts])
        return {
            "voxels": voxels.reshape(B, n, self.ht, self.wd, -1),
            "poses": torch.from_numpy(poses).to(self.device),
            "disps": torch.full((B, n, self.ht, self.wd), self.disp,
                                dtype=torch.float32, device=self.device),
            "intrinsics": torch.from_numpy(
                np.stack([self.intrinsics] * B)).to(self.device)}
