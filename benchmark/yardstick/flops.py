"""Operations of the model's work, counted from shapes, and the card's
published peak for the configuration's precision.

Nothing here reads the program: the encoders' and the update operator's
shapes come from the reference's module tree (a frozen copy of the
port's), run on the meta device, and the correlation's and BA's from the
edge schedule.
"""
from __future__ import annotations

import torch
import torch.nn as nn

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_F32 = 67e12          # FLOP/s outside the tensor cores (TF32 off)

RADIUS = 3
LEVELS = (1, 4)


def _conv_linear_flops(module: nn.Module, *inputs) -> int:
    """2 x multiply-adds of every Conv2d and Linear of `module` over one
    forward of `inputs` on the meta device."""
    total = 0

    def hook(mod, args, out):
        nonlocal total
        if isinstance(mod, nn.Conv2d):
            k = mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
            total += 2 * out.numel() * k
        elif isinstance(mod, nn.Linear):
            total += 2 * out.numel() * mod.in_features

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        with torch.no_grad():
            module(*inputs)
    finally:
        for h in handles:
            h.remove()
    return total


def patchify_flops(ht: int, wd: int, bins: int = 5, dim_inet: int = 384,
                   dim_fnet: int = 128, dim: int = 32, scorer: bool = True,
                   frames: int = 1) -> int:
    """The encoders' (and the scorer's) FLOPs for `frames` frames."""
    from benchmark.reference.nets.encoder import BasicEncoder4Evs, Scorer
    with torch.device("meta"):
        x = torch.empty(frames, bins, ht, wd)
        nets = [BasicEncoder4Evs(dim_fnet, dim, "instance", bins),
                BasicEncoder4Evs(dim_inet, dim, "none", bins)]
        if scorer:
            nets.append(Scorer(bins))
        return sum(_conv_linear_flops(n, x) for n in nets)


def update_flops_per_edge(dim_inet: int = 384, patch: int = 3) -> int:
    """The update operator's FLOPs for one edge: every Linear applied once
    an edge (SoftAgg's read-back commutes with its `h`)."""
    from benchmark.reference.nets.update import Update
    with torch.device("meta"):
        up = Update(dim_inet, 2 * (2 * RADIUS + 1) ** 2 * patch * patch)
    return sum(2 * m.in_features * m.out_features for m in up.modules()
               if isinstance(m, nn.Linear))


def corr_flops_per_edge(patch: int = 3, channels: int = 128,
                        levels: int = len(LEVELS)) -> int:
    """The two-level correlation of one edge: at each level and patch
    pixel, the dot products of the (2r+2)^2 integer window positions, then
    (2r+1)^2 bilinear taps of 4 products and 3 sums."""
    D, d = 2 * RADIUS + 2, 2 * RADIUS + 1
    return levels * patch * patch * (D * D * 2 * channels + d * d * 7)


def ba_flops_per_edge(iterations: int = 2) -> int:
    """Gauss-Newton's per-edge work: the 2 x 13 Jacobian's outer products
    into the Hessian's blocks and the gradient, 2 x (13 x 13 + 13)
    multiply-adds an iteration; the solve is left out (small)."""
    return iterations * 2 * 2 * (13 * 13 + 13)


def edge_flops(dim_inet: int, dim_fnet: int, patch: int) -> int:
    """One edge's FLOPs in one update: correlation, update operator, BA."""
    return (update_flops_per_edge(dim_inet, patch)
            + corr_flops_per_edge(patch, dim_fnet) + ba_flops_per_edge())


def train_step_flops(cfg: dict) -> int:
    """One train step's model FLOPs, forward and backward (3 x the
    forward; remat's recompute is not counted): the patchify of the clip's
    frames, then each unrolled iteration's correlation, update operator
    and two BA iterations over that iteration's edges."""
    from benchmark.reference.train.forward import build_edge_schedule
    sched = build_edge_schedule(cfg["n_frames"], cfg["ppi"], cfg["iters"],
                                grow_after=cfg["grow_after"])
    pf = patchify_flops(cfg["ht"], cfg["wd"], cfg["bins"], cfg["dim_inet"],
                        cfg["dim_fnet"], cfg["dim"], True, cfg["n_frames"])
    edges = sum(len(es.ii) for es in sched)
    return 3 * (pf + edges * edge_flops(cfg["dim_inet"], cfg["dim_fnet"],
                                        cfg["patch"]))
