"""Network building blocks (counterpart of devo_tpu/nets/blocks.py, after
upstream DEVO's devo/blocks.py): GatedResidual, SoftAgg, and the gradient
clip / zero identities whose backward passes tame the training gradient."""
from __future__ import annotations

import torch
import torch.nn as nn

from benchmark.reference.ops.graph import segment_softmax_sum


class _GradientClip(torch.autograd.Function):
    """Identity; the backward maps NaN to 0 and clamps the gradient to
    [-0.01, 0.01] (devo/blocks.py:74-89)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        return g.clamp(-0.01, 0.01)


class _GradientZero(torch.autograd.Function):
    """Identity; the backward maps NaN to 0 and zeroes every gradient with
    |g| > 0.1 (devo/blocks.py:91-100)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        return torch.where(g.abs() > 0.1, torch.zeros_like(g), g)


def gradient_clip(x: torch.Tensor) -> torch.Tensor:
    return _GradientClip.apply(x)


def gradient_zero(x: torch.Tensor) -> torch.Tensor:
    return _GradientZero.apply(x)


class GradientClip(nn.Module):
    """`gradient_clip` as a layer, where the reference's heads hold one."""

    def forward(self, x):
        return gradient_clip(x)


class GatedResidual(nn.Module):
    """x + sigmoid(W_g x) * MLP(x) (devo/blocks.py:15-29)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gate = nn.Sequential(nn.Linear(dim, dim), nn.Sigmoid())
        self.res = nn.Sequential(nn.Linear(dim, dim), nn.ReLU(),
                                 nn.Linear(dim, dim))

    def forward(self, x):
        return x + self.gate(x) * self.res(x)


class SoftAgg(nn.Module):
    """Softmax attention pooling over graph groups (devo/blocks.py:31-48):
    y_seg = sum_e softmax_seg(g(x))_e * f(x)_e; output h(y)[seg(e)]."""

    def __init__(self, dim: int):
        super().__init__()
        self.f = nn.Linear(dim, dim)
        self.g = nn.Linear(dim, dim)
        self.h = nn.Linear(dim, dim)

    def forward(self, x, segment_ids, num_segments: int, mask):
        back = segment_softmax_sum(self.f(x).float(), self.g(x).float(),
                                   segment_ids, num_segments, mask)
        # h(y)[seg(e)] == h(y[seg(e)]): the row-wise Linear commutes with
        # the read-back
        return self.h(back)
