"""Network building blocks (counterpart of devo_tpu/nets/blocks.py, after
upstream DEVO's devo/blocks.py): GatedResidual and SoftAgg."""
from __future__ import annotations

import torch
import torch.nn as nn

from devo_tpu_torch.ops.graph import segment_softmax_sum


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
