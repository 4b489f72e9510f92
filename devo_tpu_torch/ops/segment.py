"""Segment sums whose order of additions is fixed, so that two runs on the
card give the same bits: by sort and segmented reduction (`segment_sum`)
for many segments, by a one-hot product (`dense_segment_sum`) for few.

`index_add_` on a CUDA tensor adds through atomics: the order of the float
additions, and with it the rounding, changes from run to run, and a
tracking run that takes different keyframe or cull decisions follows
(devo_tpu pins bitwise equality of two runs, tests/test_determinism.py).
Here the rows are put in segment order by a stable sort, computed once per
index and shared by every sum over it, and `torch.segment_reduce` adds each
segment's run of rows in that order: on the card one thread per (segment,
column) walks its run, or CUB's segmented reduction takes it, neither with
atomics. No process-wide switch (torch.use_deterministic_algorithms) is
involved, and no cumulative sum with differences at the segment ends, which
cancels badly over long tables.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Segments(NamedTuple):
    order: torch.Tensor    # (N,) int64: the rows in segment order, stable
    lengths: torch.Tensor  # (num_segments,) int64: rows of each segment


def segments(ids: torch.Tensor, num_segments: int) -> Segments:
    """The order of the rows of `ids` (N,) by segment, every id in
    [0, num_segments). No host sync."""
    ids = ids.long()
    sorted_ids, order = torch.sort(ids, stable=True)
    bounds = torch.searchsorted(
        sorted_ids, torch.arange(num_segments + 1, device=ids.device))
    return Segments(order, bounds[1:] - bounds[:-1])


def segment_sum(values: torch.Tensor, seg: Segments) -> torch.Tensor:
    """(num_segments, *values.shape[1:]): the sum of the rows of `values`
    (N, ...) in each segment of `seg`, 0 for an empty one; the rows of a
    segment are added in their order in `values`."""
    width = math.prod(values.shape[1:])
    flat = values[seg.order].reshape(values.shape[0], width)
    out = torch.segment_reduce(flat, "sum", lengths=seg.lengths, axis=0,
                               unsafe=True)
    return out.reshape((seg.lengths.shape[0],) + values.shape[1:])


def dense_segment_sum(values: torch.Tensor, ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """What `segment_sum` computes, for few segments (BA's pose blocks): the
    product of the one-hot (num_segments, N) matrix with `values` (N, ...),
    in f64 and rounded once to values' type. A long segment costs
    segment_reduce one thread walking all its rows; the product spreads
    them over the card. cuBLAS gives the same bits at every run on one
    stream, and the f64 product is untouched by a caller's TF32 setting."""
    onehot = (ids[None, :] == torch.arange(num_segments, device=ids.device)[:, None])
    width = math.prod(values.shape[1:])
    out = onehot.to(torch.float64) @ values.reshape(values.shape[0], width).double()
    return out.to(values.dtype).reshape((num_segments,) + values.shape[1:])
