"""The event-VO network: Patchifier + Update operator (counterpart of
devo_tpu/nets/evonet.py, after upstream DEVO's devo/enet.py).

The module tree mirrors the reference torch attribute paths
(patchify.fnet / .inet / .scorer, update.*), so a DEVO.pth state dict
loads with `load_state_dict`; a selector other than the scorer holds no
scorer parameters, as devo_tpu's does. Voxels come in channels-last (n, H, W, bins),
as the engine holds them; the feature map goes out channels-last for the
correlation rings.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from benchmark.reference.ops.patchify import coords_grid_with_index, extract_patches

from . import selector as sel
from .encoder import BasicEncoder4Evs, Scorer
from .update import Update

SELECTORS = ("scorer", "gradient", "random")


class Patchifier(nn.Module):
    """The encoders and the patch selection. `patch_selector`: "scorer"
    (the learned score map; only this selector holds its parameters),
    "gradient" (the pooled event-gradient map, nets/selector.event_gradient)
    or "random" (uniform coordinates)."""

    def __init__(self, patch_size: int = 3, dim_inet: int = 384,
                 dim_fnet: int = 128, dim: int = 32, bins: int = 5,
                 patch_selector: str = "scorer"):
        super().__init__()
        if patch_selector not in SELECTORS:
            raise NotImplementedError(
                f"patch_selector={patch_selector!r}: one of {SELECTORS}")
        self.patch_size = patch_size
        self.patch_selector = patch_selector
        self.fnet = BasicEncoder4Evs(dim_fnet, dim, "instance", bins)
        self.inet = BasicEncoder4Evs(dim_inet, dim, "none", bins)
        if patch_selector == "scorer":
            self.scorer = Scorer(bins)

    def _sample(self, smap, ppi, generator, mode, use_grid, noise):
        """Eval-time sampling of a score map (scorer or event gradient)."""
        if mode == "multi":
            return sel.select_multi(smap, ppi, generator, use_grid=use_grid,
                                    noise=noise)
        if mode == "topk":
            return sel.select_topk(smap, ppi, use_grid=use_grid)
        if mode == "nms":
            return sel.select_nms(smap, ppi, use_grid=use_grid)
        raise NotImplementedError(mode)

    def forward(self, voxels: torch.Tensor, patches_per_image: int,
                generator: Optional[torch.Generator] = None,
                scorer_eval_mode: str = "multi",
                scorer_eval_use_grid: bool = True,
                noise=None, training: bool = False,
                disps: Optional[torch.Tensor] = None,
                candidates=None, coords=None) -> Dict[str, torch.Tensor]:
        """voxels (n, H, W, bins). `generator` feeds the selectors' draws;
        tests inject them instead: `noise` for the "multi" sampler,
        `candidates` (x, y) for the 3x-random draws of training, `coords`
        (x, y), each (n, ppi), for the random selector; either may be a
        callable that draws them, `candidates(n, k, x_high, y_high)` and
        `coords(n, ppi, h, w)` (the trainer's draws). `disps` (n, h, w):
        the inverse depths the patches take (ones when left out).
        `training` takes the training draws (devo_tpu/nets/evonet.py:87-139):
        the scorer's 3x-random candidates by score, the gradient
        selector's by gradient; "scores" is None for all but the scorer."""
        n = voxels.shape[0]
        P = self.patch_size
        ppi = patches_per_image
        x = voxels.permute(0, 3, 1, 2)
        if x.device.type == "cpu" and torch.is_grad_enabled():
            # the CPU's backward of a convolution of this channels-last view
            # corrupts the heap under several intra-op threads (oneDNN, torch
            # 2.13 for the CPU); a contiguous copy takes the other path
            x = x.contiguous()
        fmap = (self.fnet(x) / 4.0).float().permute(0, 2, 3, 1)  # (n,h,w,Df)
        imap = (self.inet(x) / 4.0).float().permute(0, 2, 3, 1)  # (n,h,w,Di)
        h, w = fmap.shape[1:3]

        scores_sel = None
        if self.patch_selector == "scorer":
            scores = torch.sigmoid(self.scorer(x))               # (n, h2, w2)
            if training:
                xs, ys, scores_sel = sel.select_training_scorer(
                    scores, ppi, generator, candidates)
            else:
                xs, ys = self._sample(scores, ppi, generator, scorer_eval_mode,
                                      scorer_eval_use_grid, noise)
                scores_sel = sel.gather_scores(scores, xs, ys)
                xs, ys = xs + 1, ys + 1
        elif self.patch_selector == "gradient":
            # the pooled gradient map replaces the score map; the coords are
            # clamped into [1, w-2] x [1, h-2], not shifted by one
            g = sel.event_gradient(voxels)
            if training:
                xs, ys = sel.select_3xrandom(g, ppi, generator, candidates)
            else:
                xs, ys = self._sample(g, ppi, generator, scorer_eval_mode,
                                      scorer_eval_use_grid, noise)
            xs, ys = xs.clamp(1, w - 2), ys.clamp(1, h - 2)
        elif coords is not None:
            if callable(coords):
                coords = coords(n, ppi, h, w)
            xs, ys = (c.to(fmap.device) for c in coords)
        else:
            xs, ys = sel.select_random(n, h, w, ppi, generator, fmap.device)
        coords = torch.stack([xs, ys], -1).float()               # (n, ppi, 2)

        imap_p = extract_patches(imap, coords, 0)[:, :, 0, 0, :]
        gmap_p = extract_patches(fmap, coords, P // 2)
        if disps is None:
            disps = torch.ones((n, h, w), dtype=fmap.dtype, device=fmap.device)
        grid = coords_grid_with_index(disps)
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
                 dim: int = 32, bins: int = 5, patch_selector: str = "scorer"):
        super().__init__()
        self.P = P
        self.patchify = Patchifier(P, dim_inet, dim_fnet, dim, bins,
                                   patch_selector)
        self.update = Update(dim_inet, 2 * 49 * P * P)

    def run_patchify(self, voxels, patches_per_image, **kw):
        return self.patchify(voxels, patches_per_image, **kw)

    def run_update(self, *args):
        return self.update(*args)
