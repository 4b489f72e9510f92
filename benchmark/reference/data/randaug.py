"""Event-voxel random augmentation ("randaug"), on the device (counterpart
of devo_tpu/data/randaug.py, after upstream DEVO's utils/voxel_utils.py:
55-137).

Each voxel slice becomes a fake RGB image (R = -negative events, G = 0,
B = positive events) quantized to uint8, one image op (brightness /
contrast / invert / posterize / saturation / sharpness / solarize) is
applied at a strength bin, and the image maps back to a signed voxel that
is standardized again. The uint8 values are held in f32 with torchvision's
truncating casts and clamps, as devo_tpu holds them.

Voxels are channels-last (..., H, W, bins), as the trainer holds them; the
ops work on (..., bins, 3, H, W). The op index, the strength bin and the
p = 0.33 roll are drawn by the caller (`draw_augment`) or passed in.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .normalize import rescale_normalize, std_normalize

NUM_BINS = 10  # factor bins (voxel_utils.py:104)
PROB = 0.33    # the chance of an augmentation (enet.py:261-269)


def _to_rgb_u8(vox: torch.Tensor) -> torch.Tensor:
    """evs2rgb + uint8 quantization: (..., H, W) in [-1, 1] ->
    (..., 3, H, W) [R = neg, G = 0, B = pos] of integer values."""
    pos = vox.clamp(0.0, 1.0)
    neg = (-vox).clamp(0.0, 1.0)
    rgb = torch.stack([neg, torch.zeros_like(vox), pos], dim=-3)
    return torch.floor(255.0 * rgb)


def _from_rgb_u8(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 round trip + rgb2evs: (..., 3, H, W) -> (..., H, W)."""
    rgb = rgb / 255.0
    return rgb[..., 2, :, :] - rgb[..., 0, :, :]


def _gray(rgb: torch.Tensor) -> torch.Tensor:
    """torchvision rgb_to_grayscale on uint8 (truncating cast):
    (..., 3, H, W) -> (..., H, W)."""
    return torch.floor(0.2989 * rgb[..., 0, :, :] + 0.587 * rgb[..., 1, :, :]
                       + 0.114 * rgb[..., 2, :, :])


def _blend(img1, img2, ratio) -> torch.Tensor:
    """torchvision _blend for uint8: clamp, then truncate."""
    return torch.floor((ratio * img1 + (1.0 - ratio) * img2).clamp(0.0, 255.0))


def _brightness(rgb, factor):
    return _blend(rgb, torch.zeros_like(rgb), factor)


def _contrast(rgb, factor):
    # the mean grey level of each (frame, bin) image
    mean = _gray(rgb).mean(dim=(-2, -1), keepdim=True)[..., None, :, :]
    return _blend(rgb, mean, factor)


def _invert(rgb, factor):
    return 255.0 - rgb


def _posterize(rgb, bits):
    # img & ~(2^(8-bits) - 1): the low (8 - bits) bits cleared
    shift = 2.0 ** (8.0 - bits)
    return torch.floor(rgb / shift) * shift


def _saturation(rgb, factor):
    return _blend(rgb, _gray(rgb)[..., None, :, :], factor)


def _sharpness(rgb, factor):
    """The image blended with its blur by [[1,1,1],[1,5,1],[1,1,1]] / 13,
    a depthwise 3x3 convolution on the interior; the borders keep the
    original."""
    *lead, C, H, W = rgb.shape
    img = rgb.reshape(-1, C, H, W)
    k = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]],
                     dtype=rgb.dtype, device=rgb.device) / 13.0
    blur = F.conv2d(img, k.expand(C, 1, 3, 3), groups=C)
    blur = torch.floor(blur.clamp(0.0, 255.0))
    inner = _blend(img[..., 1:-1, 1:-1], blur, factor)
    out = img.clone()
    out[..., 1:-1, 1:-1] = inner
    return out.reshape(rgb.shape)


def _solarize(rgb, threshold):
    return torch.where(rgb >= threshold, 255.0 - rgb, rgb)


OPS = (_brightness, _contrast, _invert, _posterize, _saturation, _sharpness,
       _solarize)


# (7, NUM_BINS) strength table (voxel_utils.py:104-114): linspace(0.1, 0.2),
# linspace(0.05, 0.2), unused, 8 - round(i / 2.25), linspace(0.05, 0.2),
# linspace(0.9, 2.0), round(linspace(0, 30)), as the f32 values devo_tpu's
# jnp.linspace gives (a float32 linspace computed another way differs from
# them in the last bit of a few entries, and a blend's floor can follow it)
_LIN_01_02 = (0.1, 0.11111111, 0.12222223, 0.13333333, 0.14444445, 0.15555556,
              0.16666667, 0.17777778, 0.18888889, 0.2)
_LIN_005_02 = (0.05, 0.06666667, 0.083333336, 0.1, 0.116666675, 0.13333334,
               0.15, 0.16666667, 0.18333334, 0.2)
FACTORS = (
    _LIN_01_02,                                                  # brightness
    _LIN_005_02,                                                 # contrast
    (0.0,) * NUM_BINS,                                           # invert
    (8.0, 8.0, 7.0, 7.0, 6.0, 6.0, 5.0, 5.0, 4.0, 4.0),          # posterize
    _LIN_005_02,                                                 # saturation
    (0.9, 1.0222222, 1.1444445, 1.2666667, 1.3888888, 1.5111111, 1.6333333,
     1.7555555, 1.8777778, 2.0),                                 # sharpness
    (0.0, 3.0, 7.0, 10.0, 13.0, 17.0, 20.0, 23.0, 27.0, 30.0),   # solarize
)


def _factor_table() -> torch.Tensor:
    """(7, NUM_BINS) strength table, f32."""
    return torch.tensor(FACTORS, dtype=torch.float32)


def draw_augment(generator: torch.Generator) -> Tuple[bool, int, int]:
    """The three draws of one augmentation from a CPU generator: whether
    to augment (p = PROB), the op index and the strength bin."""
    u = torch.rand((), generator=generator)
    op = torch.randint(0, len(OPS), (), generator=generator)
    fbin = torch.randint(0, NUM_BINS, (), generator=generator)
    return bool(u < PROB), int(op), int(fbin)


def voxel_augment(vox: torch.Tensor, op: int, fbin: int,
                  rescaled: bool = False) -> torch.Tensor:
    """Op `op` at strength bin `fbin` on voxels (..., H, W, bins)
    (voxel_utils.py:117-137). Returns the voxels std-normalized over the
    whole sequence, as the reference's trailing `std(voxs)`."""
    if not rescaled:
        vox = rescale_normalize(vox)
    factor = float(_factor_table()[op, fbin])
    x = vox.movedim(-1, -3)                       # (..., bins, H, W)
    rgb = OPS[op](_to_rgb_u8(x), factor)          # (..., bins, 3, H, W)
    vox = _from_rgb_u8(rgb).movedim(-3, -1)
    return std_normalize(vox.float())


def maybe_voxel_augment(vox: torch.Tensor, norm: str,
                        draw: Tuple[bool, int, int]):
    """The training gate (enet.py:261-269): voxel_augment where the draw
    (augment?, op, bin) of `draw_augment` says so (probability PROB);
    rescale-normalized inputs skip the re-rescale."""
    do, op, fbin = draw
    if not do:
        return vox
    return voxel_augment(vox, op, fbin, rescaled=norm in ("rescale", "norm"))
