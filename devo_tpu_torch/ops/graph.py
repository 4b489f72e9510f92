"""Patch-graph index operations (counterpart of devo_tpu/ops/graph.py):
temporal neighbors on the (kk, jj)-sorted edge table and the segment
softmax-sum of the SoftAgg blocks (devo/blocks.py:31-48), as segment
reductions: `scatter_reduce` for the maximum, whose result no order
changes, and ops/segment's sums in a fixed order for the rest."""
from __future__ import annotations

import torch

from devo_tpu_torch.ops import segment


def sorted_neighbors(kk: torch.Tensor, mask: torch.Tensor = None):
    """Predecessor / successor edge of each edge in a table sorted by
    (kk, jj): the adjacent row when it holds the same patch, else -1."""
    E = kk.shape[0]
    if mask is None:
        mask = torch.ones_like(kk, dtype=torch.bool)
    idx = torch.arange(E, device=kk.device)
    same = (kk[1:] == kk[:-1]) & mask[1:] & mask[:-1]
    no = torch.zeros(1, dtype=torch.bool, device=kk.device)
    same_prev = torch.cat([no, same])
    same_next = torch.cat([same, no])
    minus1 = torch.full_like(idx, -1)
    ix = torch.where(same_prev & mask, idx - 1, minus1)
    jx = torch.where(same_next & mask, idx + 1, minus1)
    return ix, jx


def segment_softmax_sum(values: torch.Tensor, logits: torch.Tensor,
                        segment_ids: torch.Tensor, num_segments: int,
                        mask: torch.Tensor):
    """Per-channel softmax of `logits` within each segment, then the
    softmax-weighted segment sum of `values` (torch_scatter.scatter_softmax
    + scatter_sum, as SoftAgg uses them), read back at each edge's segment.

    values, logits (E, C) f32; segment_ids (E,) in [0, num_segments); mask
    (E,) bool, masked rows contribute nothing and read back zeros.
    Returns (E, C).
    """
    E, C = values.shape
    # masked rows go to one extra dummy segment
    seg = torch.where(mask, segment_ids, torch.full_like(segment_ids,
                                                         num_segments))
    S = num_segments + 1
    idx = seg[:, None].expand(E, C)
    seg_max = torch.full((S, C), -1e30, dtype=logits.dtype,
                         device=logits.device)
    seg_max = seg_max.scatter_reduce(0, idx, logits, "amax", include_self=True)
    ex = torch.exp(logits - seg_max[seg]) * mask[:, None]
    # one sort serves both sums
    order = segment.segments(seg, S)
    denom = segment.segment_sum(ex, order)
    # non-empty segments hold their max term exp(0) = 1; the guard only
    # keeps the dummy segment's 0/0 at 0
    w = ex / denom[seg].clamp_min(1e-30)
    return segment.segment_sum(values * w, order)[seg]
