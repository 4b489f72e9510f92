"""Reading a device-only torch.profiler trace into what the per-layer
metrics need: the device's busy intervals, the device time of each kernel
name, the count of kernels, and the longest idle gaps.
"""
from __future__ import annotations

from bisect import bisect_left
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple


def merge(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals, sorted."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(prof) -> dict:
    """The device's kernels of one profiled region: "busy" (their merged
    intervals, ns on the trace's clock), "kernels" ({name: [seconds,
    count]}), "n_kernels" and "starts" ([(start ns, name)], sorted)."""
    from torch.autograd import DeviceType
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    ivs, starts = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        s, t = e.start_ns(), e.end_ns()
        rec = by_name[e.name()]
        rec[0] += (t - s) / 1e9
        rec[1] += 1
        ivs.append((s, t))
        starts.append((s, e.name()))
    return {"busy": merge(ivs), "kernels": dict(by_name),
            "n_kernels": len(ivs), "starts": sorted(starts)}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    between the first kernel's start and the last one's end, each named by
    the kernel that ended it: the launch the host was preparing."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])[:top]
    busy, starts = summary["busy"], summary["starts"]
    at = [s for s, _ in starts]
    gaps = sorted(((b - a, b) for (_, a), (b, _) in zip(busy, busy[1:])),
                  reverse=True)[:top]
    return {"device_ops": [[n[:64], v[0]] for n, v in ops],
            "idle_gaps": [["before " + starts[bisect_left(at, b)][1][:57],
                           g / 1e9] for g, b in gaps]}
