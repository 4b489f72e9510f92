"""Event-voxel normalization (counterpart of devo_tpu/data/normalize.py,
after upstream DEVO's utils/voxel_utils.py), with statistics over the whole
voxel, as the engine normalizes one frame at a time."""
from __future__ import annotations

import torch


def std_normalize(vox: torch.Tensor) -> torch.Tensor:
    """Standardize over the *nonzero* elements; a voxel with no events is
    left untouched."""
    nonzero = vox != 0.0
    v = vox.float()
    num = nonzero.sum().float()
    safe = num.clamp_min(1.0)
    mean = v.sum() / safe
    var = (v * v).sum() / safe - mean * mean
    stddev = torch.sqrt(var.clamp_min(1e-12))
    out = torch.where(nonzero, (v - mean) / stddev, torch.zeros_like(v))
    return torch.where(num > 0, out, v).to(vox.dtype)


def rescale_normalize(vox: torch.Tensor) -> torch.Tensor:
    """Scale positive events into (0, 1], negative into [-1, 0)."""
    pos = vox > 0
    neg = vox < 0
    zero = torch.zeros_like(vox)
    vx_max = torch.where(pos, vox, zero).amax()
    vx_min = torch.where(neg, vox, zero).amin()
    vx_max = torch.where(vx_max > 0, vx_max, torch.full_like(vx_max, 1e-5))
    vx_min = torch.where(vx_min < 0, vx_min, torch.full_like(vx_min, -1e-5))
    return torch.where(pos, vox / vx_max, torch.where(neg, vox / -vx_min, vox))


def normalize(vox: torch.Tensor, mode: str) -> torch.Tensor:
    mode = mode.lower()
    if mode == "none":
        return vox
    if mode in ("rescale", "norm"):
        return rescale_normalize(vox)
    if mode in ("standard", "std", "standard2", "std2"):
        return std_normalize(vox)
    raise NotImplementedError(mode)
