"""Time the full-width train step and measure its peak memory (counterpart
of scripts/measure_train_memory.py, which compiled the step on the TPU and
read XLA's memory analysis; here the step runs).

    python -m devo_tpu_torch.scripts.train_step [--remat on|off|both]
        [--steps 3] [--structure_only]

Defaults are the reference's training scale (train.py:358-380): 480x640
voxels, clips of 15 frames, 18 unrolled iterations, 80 patches an image,
dims 384 / 128 / 32, batch 1, on synthetic clips of the bench's sliding
texture (train/synthetic.py) and seeded random weights. Prints one JSON line
for each remat mode: the step's ms (the median of the synchronised steps
after the first), the allocator's peak GiB, each step's loss and
grad_nonfinite, and whether the parameters changed. Exits non-zero if a
step is not finite or leaves the parameters as they were.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from devo_tpu_torch.nets.evonet import EVONet
from devo_tpu_torch.train.__main__ import _make_batch
from devo_tpu_torch.train.synthetic import SyntheticClips
from devo_tpu_torch.train.trainer import Trainer
from devo_tpu_torch.utils.params import random_state_dict

from . import common


def run(dataset, device=None, remat: bool = True, steps: int = 3,
        dim_inet: int = 384, dim_fnet: int = 128, dim: int = 32,
        iters: int = 18, ppi: int = 80, grow_after: int = 8,
        corr_dropout: float = 0.2, structure_only: bool = False,
        profile: bool = False) -> dict:
    """`steps` optimizer steps of a fresh trainer (seeded random weights),
    batch 1, on items 0, 1, ... of `dataset` (TartanAirEVS-like). Returns
    the record of the run; with
    `profile`, one more step under torch.profiler, untimed, and its 15
    operations of the largest device (on the CPU: host) self time,
    "top_ops", each [name, ms, calls]."""
    from devo_tpu_torch.runtime.engine import resolve_device
    dev = resolve_device(device)
    net = EVONet(dim_inet=dim_inet, dim_fnet=dim_fnet, dim=dim)
    net.load_state_dict(random_state_dict(net, 0))
    tr = Trainer(net=net, total_steps=240_000, steps_unrolled=iters, ppi=ppi,
                 grow_after=grow_after, corr_dropout=corr_dropout,
                 remat=remat, device=dev)
    before = [p.detach().clone() for p in tr.net.parameters()]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    times, metrics = [], []
    for s in range(steps):
        items = _make_batch(dataset, [s])
        b = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in items.items()}
        t0 = time.perf_counter()
        metrics.append(tr.train_step(b, structure_only))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(1e3 * (time.perf_counter() - t0))
    changed = any(not torch.equal(a, p.detach())
                  for a, p in zip(before, tr.net.parameters()))
    top = None
    if profile:
        items = _make_batch(dataset, [steps])
        b = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in items.items()}
        top = profile_step(tr, b, structure_only)
    return {
        "remat": remat, "structure_only": structure_only, "steps": steps,
        "step_ms": float(np.median(times[1:] if steps > 1 else times)),
        "steps_ms": [round(t, 2) for t in times],
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                     if dev.type == "cuda" else None),
        "loss": [m["loss"] for m in metrics],
        "grad_nonfinite": [m["grad_nonfinite"] for m in metrics],
        "finite": all(np.isfinite(m["loss"]) for m in metrics),
        "params_changed": changed, "top_ops": top,
        "shape": dict(ht=dataset.ht, wd=dataset.wd, n_frames=dataset.n_frames,
                      iters=iters, ppi=ppi, dims=[dim_inet, dim_fnet, dim],
                      batch=1, grow_after=grow_after,
                      corr_dropout=corr_dropout),
    }


def profile_step(tr: Trainer, batch, structure_only: bool = False,
                 rows: int = 15) -> list:
    """One train step under torch.profiler: its `rows` operations of the
    largest self time on the device (the host's on the CPU), each [name,
    ms, calls], and the step's whole device time as ["(all)", ms, calls]."""
    cuda = tr.device.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        tr.train_step(batch, structure_only)
        if cuda:
            torch.cuda.synchronize(tr.device)

    def self_us(e):
        if not cuda:
            return e.self_cpu_time_total
        # the name of the device total before torch 2.4 and after
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages() if self_us(e) > 0]
    events.sort(key=lambda e: -self_us(e))
    total = sum(self_us(e) for e in events) / 1e3
    return ([["(all)", total, sum(e.count for e in events)]]
            + [[e.key, self_us(e) / 1e3, e.count] for e in events[:rows]])


def main(argv=None):
    p = common.parser("Time the full-width train step (see the module's "
                      "docstring).")
    p.add_argument("--remat", default="both", choices=["on", "off", "both"])
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--structure_only", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="one more step under torch.profiler: its top "
                        "operations by device time")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--n_frames", type=int, default=15)
    p.add_argument("--iters", type=int, default=18)
    p.add_argument("--ppi", type=int, default=80)
    p.add_argument("--grow_after", type=int, default=8)
    p.add_argument("--dims", type=int, nargs=3, default=(384, 128, 32),
                   metavar=("DIM_INET", "DIM_FNET", "DIM"))
    args = p.parse_args(argv)
    dev = common.device(args)
    data = SyntheticClips(args.n_frames, args.height, args.width)
    ok = True
    for remat in {"on": [True], "off": [False], "both": [True, False]}[args.remat]:
        rec = run(data, dev, remat=remat, steps=args.steps,
                  dim_inet=args.dims[0], dim_fnet=args.dims[1],
                  dim=args.dims[2], iters=args.iters, ppi=args.ppi,
                  grow_after=args.grow_after,
                  structure_only=args.structure_only, profile=args.profile)
        rec["card"] = common.card(dev)
        print(json.dumps(rec), flush=True)
        ok &= (rec["finite"] and rec["params_changed"]
               and not any(rec["grad_nonfinite"]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
