"""The program's spans beside a device-only torch.profiler trace of the
same step: each kernel's device time given to the span the host was in
when it launched the kernel, the idle gaps named by the span the host was
in, and the per-layer readings of the train step drawn from them.

The spans are `devo_tpu_torch.utils.timing`'s records (id, parent, step,
thread, name, t0_ns, t1_ns, attrs), on the profiler's clock. A kernel
belongs to the innermost span (the deepest in the span tree; of two as
deep, the later opened) open at its launch: the start of the CUDA runtime
call that the trace links to it by correlation id, or, where the trace
holds no such call, the kernel's own start. Each kernel is credited with
the part of its interval that no earlier kernel covered, so the spans'
sums, with "(none)" for kernels under no span, are the union of the
kernels' intervals: the trace's busy time.

    python3 -m benchmark.yardstick.spans --workload train-tartan-remat \
        --seed N [--steps 2] [--first-traced] [--out FILE]

runs the cell's set-up, then profiled steps with the tracer off and on in
turns (on first with --first-traced), and prints one JSON line a step: its
wall time, kernels, busy time, the longest idle gaps (where in the step,
under which spans, beside which runtime calls); with the tracer on also
per-span device and host seconds, the counters, the idle gaps named by
span, the runtime calls by name, and the layer readings (`layers`).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from bisect import bisect_right
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

NONE = "(none)"
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def key(span) -> str:
    """A span's name, with " (recompute)" for remat's recompute."""
    if span is None:
        return NONE
    return span.name + (" (recompute)" if span.attrs.get("recompute") else "")


def timeline(spans: Sequence) -> Tuple[List[int], list]:
    """The innermost open span over time: (starts, owners), owners[i] the
    innermost span open from starts[i] to starts[i + 1] (None for none)."""
    by_id = {s.id: s for s in spans}
    depth: Dict[int, int] = {}

    def d(s):
        if s.id not in depth:
            p = by_id.get(s.parent)
            depth[s.id] = 0 if p is None else d(p) + 1
        return depth[s.id]

    events = sorted([(s.t0_ns, 1, s.id) for s in spans]
                    + [(s.t1_ns, 0, s.id) for s in spans])
    open_: Dict[int, object] = {}
    starts, owners = [], []
    for t, opening, sid in events:
        if opening:
            open_[sid] = by_id[sid]
        else:
            open_.pop(sid, None)
        top = max(open_.values(), key=lambda s: (d(s), s.t0_ns), default=None)
        if starts and starts[-1] == t:
            owners[-1] = top
        else:
            starts.append(t)
            owners.append(top)
    return starts, owners


def owner(tl: Tuple[List[int], list], t: int):
    """The innermost span open at time t, or None."""
    starts, owners = tl
    i = bisect_right(starts, t) - 1
    return owners[i] if i >= 0 else None


def attribute(spans: Sequence, kernels: Sequence[Tuple[int, int, int]],
              launches: Dict[int, int]) -> dict:
    """Device seconds by span key. kernels: (start_ns, end_ns, correlation
    id); launches: {correlation id: launch ns}. Returns {"dev_s": {key:
    s}, "by_launch": kernels placed by their launch, "by_start": by their
    own start}."""
    tl = timeline(spans)
    dev: Dict[str, float] = defaultdict(float)
    reach = None
    n_launch = n_start = 0
    for start, end, corr in sorted(kernels):
        lo = start if reach is None else max(start, reach)
        reach = end if reach is None else max(reach, end)
        if end <= lo:
            continue
        t = launches.get(corr)
        if t is None:
            t, n_start = start, n_start + 1
        else:
            n_launch += 1
        dev[key(owner(tl, t))] += (end - lo) / 1e9
    return {"dev_s": dict(dev), "by_launch": n_launch, "by_start": n_start}


def host_s(spans: Sequence) -> Dict[str, float]:
    """Host wall seconds by span key."""
    out: Dict[str, float] = defaultdict(float)
    for s in spans:
        out[key(s)] += (s.t1_ns - s.t0_ns) / 1e9
    return dict(out)


def name_gaps(summary: dict, breakdown: dict, spans: Sequence) -> dict:
    """`breakdown` (yardstick/trace.breakdown of `summary`) with each idle
    gap's name led by the span the host was in at the gap's midpoint:
    "<span>: before <kernel>", cut to 64 characters."""
    tl = timeline(spans)
    busy = summary["busy"]
    gaps = sorted(((b - a, b, a) for (_, a), (b, _) in zip(busy, busy[1:])),
                  reverse=True)[:len(breakdown["idle_gaps"])]
    named = [[f"{key(owner(tl, (a + b) // 2))}: {name}"[:64], s]
             for (_, b, a), (name, s) in zip(gaps, breakdown["idle_gaps"])]
    return dict(breakdown, idle_gaps=named)


def path(span, by_id: Dict[int, object]) -> str:
    """The span's chain from its root, "a/b[s=3]/c", the train.iter's
    index shown."""
    names = []
    while span is not None:
        it = f"[s={span.attrs['s']}]" if "s" in span.attrs else ""
        names.append(key(span) + it)
        span = by_id.get(span.parent)
    return "/".join(reversed(names)) or NONE


def gap_detail(busy: Sequence[Tuple[int, int]], spans: Sequence,
               runtime: Sequence, t0: int, top: int = 10) -> List[dict]:
    """The `top` longest idle gaps between the busy intervals: each one's
    seconds, its start in seconds from t0 (ns), the chain of spans open at
    its midpoint, and the runtime calls (start_ns, end_ns, name) that
    overlap it, {name: [count, seconds inside the gap]}."""
    tl = timeline(spans)
    by_id = {s.id: s for s in spans}
    gaps = sorted(((b - a, a, b) for (_, a), (b, _) in zip(busy, busy[1:])),
                  reverse=True)[:top]
    runtime = sorted(runtime)
    starts = [c[0] for c in runtime]
    out = []
    for g, a, b in gaps:
        calls: Dict[str, list] = defaultdict(lambda: [0, 0.0])
        # each host thread makes one call at a time: a call in progress at
        # the gap's start is among the last few that began before it
        for c0, c1, name in runtime[max(bisect_right(starts, a) - 8, 0):
                                    bisect_right(starts, b)]:
            inside = min(c1, b) - max(c0, a)
            if inside > 0:
                calls[name][0] += 1
                calls[name][1] += inside / 1e9
        out.append({"s": g / 1e9, "at_s": (a - t0) / 1e9,
                    "spans": path(owner(tl, (a + b) // 2), by_id),
                    "calls": dict(calls)})
    return out


def device_events(prof) -> Tuple[List[Tuple[int, int, int]], Dict[int, int],
                                 List[Tuple[int, int, str]]]:
    """A device-only profile's device events (start_ns, end_ns, correlation
    id), the launch time of each correlation id from the CUDA API calls
    (cuda*, cu*) in the trace, and those calls (start_ns, end_ns, name)."""
    from torch.autograd import DeviceType
    kernels, launches, runtime = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                kernels.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        elif e.name().startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()
            runtime.append((e.start_ns(), e.end_ns(), e.name()))
    return kernels, launches, runtime


def trace_keys(events, rec, steps: int) -> dict:
    """What a traced run adds to the trace dict from the step's profile
    (`device_events`) and the tracer's recording: the spans, the counters
    by name (summed over the steps), the per-span device and host seconds,
    how the kernels were placed, the runtime calls by name and the
    runtime's waits for the device by span."""
    kernels, launches, runtime = events
    att = attribute(rec.spans, kernels, launches)
    tl = timeline(rec.spans)
    counts: Dict[str, int] = defaultdict(int)
    for (_, name), n in rec.counts.items():
        counts[name] += n
    waits = Counter(key(owner(tl, t0)) for t0, _, name in runtime
                    if name in WAITS)
    return {"spans": [list(s) for s in rec.spans], "counts": dict(counts),
            "span_dev_s": att["dev_s"], "span_host_s": host_s(rec.spans),
            "by_launch": att["by_launch"], "by_start": att["by_start"],
            "runtime_calls": dict(Counter(name for _, _, name in runtime)),
            "steps_profiled": steps, "waits_by_span": dict(waits)}


def layers(trace: dict) -> Dict[str, Optional[float]]:
    """The train step's layer readings a step, from `trace_keys`: device ms
    under train.corr (recompute included) and train.corr.bwd; under
    train.update and train.ba, forward and recompute (their backward stays
    in train.backward's own time); the host's ms in train.optimizer; the
    host_waits counter. None where the trace has no spans."""
    if "span_dev_s" not in trace:
        return {}
    dev, host, n = trace["span_dev_s"], trace["span_host_s"], trace[
        "steps_profiled"]

    def dev_ms(*names):
        return 1e3 * sum(dev.get(k, 0.0) for name in names
                         for k in (name, name + " (recompute)")) / n

    return {"corr_dev_ms.train": dev_ms("train.corr", "train.corr.bwd"),
            "update_dev_ms.train": dev_ms("train.update"),
            "ba_dev_ms.train": dev_ms("train.ba"),
            "optimizer_ms.train": 1e3 * host.get("train.optimizer", 0.0) / n,
            "host_waits_per_step.train":
                trace["counts"].get("host_waits", 0) / n}


def profiled_step(tr, clips, s: int, dev, traced: bool) -> dict:
    """Step s under a device-only profile, as runners/train.profile_step
    takes it, with the tracer on or off; Python's garbage collections in
    the step are timed beside the runtime's calls ("gc genN")."""
    import contextlib
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.yardstick import trace as tt
    from devo_tpu_torch.utils import timing
    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else [
        ProfilerActivity.CPU]
    collections = []

    def on_gc(phase, info):
        if phase == "start":
            collections.append([time.time_ns(), None, info["generation"]])
        else:
            collections[-1][1] = time.time_ns()

    tracing = timing.recording() if traced else contextlib.nullcontext()
    gc.callbacks.append(on_gc)
    try:
        with tracing as rec, profile(activities=acts) as prof:
            wall0 = time.time_ns()
            tr.train_step(clips.batch([s]))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall1 = time.time_ns()
    finally:
        gc.callbacks.remove(on_gc)
    summ = tt.summarize(prof)
    events = device_events(prof)
    host = [(a, b, f"gc gen{g}") for a, b, g in collections if b is not None]
    gcs: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    for a, b, name in host:
        gcs[name][0] += 1
        gcs[name][1] += (b - a) / 1e9
    spans = rec.spans if traced else []
    out = {"traced": traced, "step": s, "wall_s": (wall1 - wall0) / 1e9,
           "n_kernels": summ["n_kernels"],
           "busy_s": sum(e - a for a, e in summ["busy"]) / 1e9,
           "gc": dict(gcs),
           "gaps": gap_detail(summ["busy"], spans, sorted(events[2] + host),
                              wall0)}
    bd = tt.breakdown(summ)
    if traced:
        keys = trace_keys(events, rec, 1)
        del keys["spans"]
        out.update(keys, layers=layers(keys), n_spans=len(rec.spans),
                   breakdown=name_gaps(summ, bd, rec.spans))
    else:
        out["breakdown"] = bd
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="train-tartan-remat")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=2,
                   help="profiled steps with the tracer off and on each")
    p.add_argument("--first-traced", action="store_true",
                   help="the first profiled step with the tracer on")
    p.add_argument("--device", default=None, help="cpu: a test's run")
    p.add_argument("--root", default=None, help="the benchmark's directory")
    p.add_argument("--out", default=None, help="also append the lines here")
    args = p.parse_args(argv)
    import torch

    from benchmark import harness
    from benchmark.runners import train as runner
    from devo_tpu_torch.nets import evonet
    from devo_tpu_torch.train import trainer
    root = harness.HERE if args.root is None else Path(args.root)
    cell = harness.load_cell(args.workload, root)
    dev = torch.device(args.device or "cuda")
    cfg = cell["config"]["train"]
    runner._tf32(cfg["tf32"])
    clips = runner.clips_of(cell, args.seed, dev)
    wts = runner.weights_of(cell, args.seed, dev)
    tr = runner._trainer(evonet, trainer, cfg, wts, dev, cfg["remat"])
    runner.drive(tr, clips, range(runner.CHECKED), dev)
    card = harness.card_info() if dev.type == "cuda" else "cpu"
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    s = runner.CHECKED
    for i in range(2 * args.steps):
        line = profiled_step(tr, clips, s, dev,
                             traced=bool(i % 2) != args.first_traced)
        line.update(seed=args.seed, card=card)
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        s += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
