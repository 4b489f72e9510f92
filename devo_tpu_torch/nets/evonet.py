"""The event-VO network: Patchifier + Update operator (counterpart of
devo_tpu/nets/evonet.py, after upstream DEVO's devo/enet.py).

The module tree mirrors the reference torch attribute paths
(patchify.fnet / .inet / .scorer, update.*), so a DEVO.pth state dict
loads with `load_state_dict`. Voxels come in channels-last (n, H, W, bins),
as the engine holds them; the feature map goes out channels-last for the
correlation rings.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from devo_tpu_torch.ops.patchify import coords_grid_with_index, extract_patches

from . import selector as sel
from .encoder import BasicEncoder4Evs, Scorer
from .update import Update


class Patchifier(nn.Module):
    def __init__(self, patch_size: int = 3, dim_inet: int = 384,
                 dim_fnet: int = 128, dim: int = 32, bins: int = 5):
        super().__init__()
        self.patch_size = patch_size
        self.fnet = BasicEncoder4Evs(dim_fnet, dim, "instance", bins)
        self.inet = BasicEncoder4Evs(dim_inet, dim, "none", bins)
        self.scorer = Scorer(bins)

    def forward(self, voxels: torch.Tensor, patches_per_image: int,
                generator: Optional[torch.Generator] = None,
                scorer_eval_mode: str = "multi",
                scorer_eval_use_grid: bool = True,
                noise=None) -> Dict[str, torch.Tensor]:
        """voxels (n, H, W, bins). `generator` (or injected `noise`) feeds
        the "multi" sampler's draws."""
        n = voxels.shape[0]
        P = self.patch_size
        ppi = patches_per_image
        x = voxels.permute(0, 3, 1, 2)
        fmap = (self.fnet(x) / 4.0).float().permute(0, 2, 3, 1)  # (n,h,w,Df)
        imap = (self.inet(x) / 4.0).float().permute(0, 2, 3, 1)  # (n,h,w,Di)
        h, w = fmap.shape[1:3]

        scores = torch.sigmoid(self.scorer(x))                   # (n, h2, w2)
        if scorer_eval_mode == "multi":
            xs, ys = sel.select_multi(scores, ppi, generator,
                                      use_grid=scorer_eval_use_grid,
                                      noise=noise)
        elif scorer_eval_mode == "topk":
            xs, ys = sel.select_topk(scores, ppi,
                                     use_grid=scorer_eval_use_grid)
        elif scorer_eval_mode == "nms":
            xs, ys = sel.select_nms(scores, ppi,
                                    use_grid=scorer_eval_use_grid)
        else:
            raise NotImplementedError(scorer_eval_mode)
        scores_sel = sel.gather_scores(scores, xs, ys)
        coords = torch.stack([xs + 1, ys + 1], -1).float()      # (n, ppi, 2)

        imap_p = extract_patches(imap, coords, 0)[:, :, 0, 0, :]
        gmap_p = extract_patches(fmap, coords, P // 2)
        grid = coords_grid_with_index(
            torch.ones((n, h, w), dtype=fmap.dtype, device=fmap.device))
        patches = extract_patches(grid, coords, P // 2).permute(0, 1, 4, 2, 3)

        # event "color" for visualization: |voxel| summed over bins
        mag = voxels.float().abs().sum(-1, keepdim=True)
        clr = extract_patches(mag, 4.0 * (coords + 0.5), 0)[:, :, 0, 0, 0]

        return {
            "fmap": fmap, "imap": imap_p, "gmap": gmap_p,
            "patches": patches, "scores": scores_sel,
            "clr": clr.clamp(0, 255), "coords": coords,
        }


class EVONet(nn.Module):
    """Container matching eVONet's parameter tree (enet.py:219-232)."""

    def __init__(self, P: int = 3, dim_inet: int = 384, dim_fnet: int = 128,
                 dim: int = 32, bins: int = 5):
        super().__init__()
        self.P = P
        self.patchify = Patchifier(P, dim_inet, dim_fnet, dim, bins)
        self.update = Update(dim_inet, 2 * 49 * P * P)

    def run_patchify(self, voxels, patches_per_image, **kw):
        return self.patchify(voxels, patches_per_image, **kw)

    def run_update(self, *args):
        return self.update(*args)
