"""Recurrent update operator (counterpart of devo_tpu/nets/update.py, after
upstream DEVO's devo/enet.py:32-99).

Injects context + correlation features into the per-edge hidden state,
passes temporal messages along each patch's edge chain (sequentially: the
successor message reads the state after the predecessor residual, as the
reference's in-place update does, enet.py:90-91), aggregates over patch and
frame-pair groups with SoftAgg, runs the gated-residual "GRU", and emits the
2D flow correction + confidence weights. Under bf16 autocast the Linears run
in bf16; the LayerNorms and the two output heads stay f32.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .blocks import GatedResidual, GradientClip, SoftAgg


class Update(nn.Module):
    def __init__(self, dim: int = 384, corr_dim: int = 882):
        super().__init__()
        self.corr = nn.Sequential(
            nn.Linear(corr_dim, dim), nn.ReLU(), nn.Linear(dim, dim),
            nn.LayerNorm(dim, eps=1e-3), nn.ReLU(), nn.Linear(dim, dim))
        self.norm = nn.LayerNorm(dim, eps=1e-3)
        self.c1 = nn.Sequential(nn.Linear(dim, dim), nn.ReLU(),
                                nn.Linear(dim, dim))
        self.c2 = nn.Sequential(nn.Linear(dim, dim), nn.ReLU(),
                                nn.Linear(dim, dim))
        self.agg_kk = SoftAgg(dim)
        self.agg_ij = SoftAgg(dim)
        self.gru = nn.Sequential(
            nn.LayerNorm(dim, eps=1e-3), GatedResidual(dim),
            nn.LayerNorm(dim, eps=1e-3), GatedResidual(dim))
        # the heads' GradientClip is an identity in the forward pass; it
        # clamps the training gradient (enet.py:68-77,
        # devo_tpu/nets/update.py:100-102)
        self.d = nn.Sequential(nn.ReLU(), nn.Linear(dim, 2), GradientClip())
        self.w = nn.Sequential(nn.ReLU(), nn.Linear(dim, 2), GradientClip(),
                               nn.Sigmoid())

    def forward(self, net, ctx, corr_feat, ix, jx, kk_seg, nseg_kk: int,
                ij_seg, nseg_ij: int, mask):
        """net, ctx (E, dim); corr_feat (E, corr_dim); ix, jx (E,)
        predecessor / successor edge (-1 if none); kk_seg, ij_seg (E,) dense
        group ids; mask (E,) bool. Returns (net f32, delta (E, 2),
        weight (E, 2))."""
        m = mask[:, None].float()
        c = self.corr(corr_feat.float())
        net = net.float() + ctx.float() + c.float()
        net = self.norm(net).float() * m

        prev = net[ix.clamp(min=0)] * ((ix >= 0) & mask)[:, None].float()
        net = net + self.c1(prev).float()
        nxt = net[jx.clamp(min=0)] * ((jx >= 0) & mask)[:, None].float()
        net = net + self.c2(nxt).float()

        net = net + self.agg_kk(net, kk_seg, nseg_kk, mask).float()
        net = net + self.agg_ij(net, ij_seg, nseg_ij, mask).float()
        net = self.gru(net).float() * m

        with torch.autocast(net.device.type, enabled=False):
            delta = self.d(net)
            weight = self.w(net)
        return net, delta, weight
