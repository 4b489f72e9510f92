"""Feature encoders for event voxel grids (counterpart of
devo_tpu/nets/encoder.py, after upstream DEVO's devo/extractor.py and
selector.py).

Modules take NCHW input, as torch convolutions do; attribute paths follow
the reference torch modules, so a DEVO.pth state dict loads with
`load_state_dict`. Instance norm is `nn.InstanceNorm2d`'s default
(per-sample spatial stats, no affine, eps 1e-5), which is the JAX
package's per-channel GroupNorm.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def make_norm(norm_fn: str, channels: int) -> nn.Module:
    if norm_fn == "instance":
        return nn.InstanceNorm2d(channels, eps=1e-5)
    if norm_fn == "none":
        return nn.Sequential()
    raise NotImplementedError(f"norm_fn={norm_fn}")


class ResidualBlock(nn.Module):
    """Two 3x3 convs + optional strided 1x1 downsample (extractor.py:6-55)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance",
                 stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.relu = nn.ReLU()
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.norm3 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class BasicEncoder4Evs(nn.Module):
    """Stride-4 event-voxel encoder (extractor.py:269-335):
    (N, bins, H, W) -> (N, output_dim, H/4, W/4)."""

    def __init__(self, output_dim: int = 128, dim: int = 32,
                 norm_fn: str = "instance", bins: int = 5):
        super().__init__()
        self.conv1 = nn.Conv2d(bins, dim, 7, stride=2, padding=3)
        self.norm1 = make_norm(norm_fn, dim)
        self.relu1 = nn.ReLU()
        self.layer1 = nn.Sequential(ResidualBlock(dim, dim, norm_fn, 1),
                                    ResidualBlock(dim, dim, norm_fn, 1))
        self.layer2 = nn.Sequential(ResidualBlock(dim, 2 * dim, norm_fn, 2),
                                    ResidualBlock(2 * dim, 2 * dim, norm_fn, 1))
        self.conv2 = nn.Conv2d(2 * dim, output_dim, 1)

    def forward(self, x):
        x = self.relu1(self.norm1(self.conv1(x)))
        x = self.layer2(self.layer1(x))
        return self.conv2(x)


class Scorer(nn.Module):
    """Patch-selector scoring CNN (devo/selector.py:19-47): four VALID 3x3
    convs (bins->8->16->32->1) + 4x4 max pool.
    (N, bins, H, W) -> (N, (H-8)//4, (W-8)//4)."""

    def __init__(self, bins: int = 5):
        super().__init__()
        self.scorer = nn.Sequential(
            nn.Conv2d(bins, 8, 3), nn.ReLU(),
            nn.Conv2d(8, 16, 3), nn.ReLU(),
            nn.Conv2d(16, 32, 3), nn.ReLU(),
            nn.Conv2d(32, 1, 3))

    def forward(self, x):
        x = F.max_pool2d(self.scorer(x), 4, 4)
        return x[:, 0].float()
