"""Patch-graph index operations (counterpart of devo_tpu/ops/graph.py):
temporal neighbors on an unsorted edge table (training's) and on the
(kk, jj)-sorted one (the engine's), and the segment
softmax-sum of the SoftAgg blocks (devo/blocks.py:31-48), as segment
reductions: `scatter_reduce` for the maximum, whose result no order
changes, and ops/segment's sums in a fixed order for the rest."""
from __future__ import annotations

import torch

from benchmark.reference.ops import segment


def neighbors(kk: torch.Tensor, jj: torch.Tensor, mask: torch.Tensor = None):
    """Predecessor / successor edge of each edge of an unsorted table
    (ba.cpp:127-136): among the edges of the same patch kk, the previous /
    next one in ascending jj, by a stable lexicographic sort on (kk, jj),
    so that duplicates of a pair keep their table order. -1 where there is
    none and for masked edges, which take part in no chain."""
    E = kk.shape[0]
    if mask is None:
        mask = torch.ones_like(kk, dtype=torch.bool)
    big = torch.full_like(kk, 0x3FFFFFFF)
    kk_key = torch.where(mask, kk, big)
    jj_key = torch.where(mask, jj, big)
    perm1 = torch.sort(jj_key, stable=True).indices
    order = perm1[torch.sort(kk_key[perm1], stable=True).indices]
    kk_s, valid_s = kk_key[order], mask[order]
    same = kk_s[1:] == kk_s[:-1]
    no = torch.zeros(1, dtype=torch.bool, device=kk.device)
    minus1 = torch.full((1,), -1, dtype=order.dtype, device=kk.device)
    prev = torch.where(torch.cat([no, same]) & valid_s,
                       torch.cat([minus1, order[:-1]]), -1)
    nxt = torch.where(torch.cat([same, no]) & valid_s,
                      torch.cat([order[1:], minus1]), -1)
    ix = torch.empty(E, dtype=order.dtype, device=kk.device)
    jx = torch.empty_like(ix)
    ix[order] = prev
    jx[order] = nxt
    return (torch.where(mask, ix, torch.full_like(ix, -1)),
            torch.where(mask, jx, torch.full_like(jx, -1)))


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
