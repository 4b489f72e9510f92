"""Training cells: the port's `Trainer` stepping back to back on synthetic
clips, item s for step s, in one process on one card.

Set-up makes the weights and the clips' texture on the card from the seed
(a step's clip is sliced from it there, traffic/clips.py), builds one
trainer and drives it through its first CHECKED steps (the steps the
reference follows), through the same call and feed as the window. The window runs
steps until one ends past `--seconds`; `train_clips_per_s` counts the
completed steps times the batch over the time from the first window step's
start to the last completed step's synchronised end, so that a step cut by
the window counts neither its clips nor its time.

`correct`: once the window has closed and the trainer is freed, the
reference (reference/train, plain PyTorch, f32 with TF32 off, remat off)
takes the same weights and clips through CHECKED steps. Compared: each
step's loss; the first step's gradient, after the clip, as AdamW got it
(its first moment over 1 - beta1); and the parameters' change over the
CHECKED steps. The last two by the worst leaf: the gap between the two
leaf norms over the larger of the reference's leaf norm and its median
leaf's. Leaves whose reference gradient lies under a thousandth of the
median leaf's are left out of the change (AdamW moves them by round-off).
"""
from __future__ import annotations

import math
import sys
import time
from typing import Dict, List, Optional

from benchmark import harness
from benchmark.traffic.clips import Clips, derived_seed

CHECKED = 3
BETA1 = 0.9


def _tf32(on: bool):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def clips_of(cell: dict, seed: int, device) -> Clips:
    c, t = cell["config"]["train"], cell["traffic"]
    return Clips(seed, c["n_frames"], c["ht"], c["wd"], c["bins"],
                 t["shift_px"], t["disp"], t["density"], t["length"], device)


def weights_of(cell: dict, seed: int, device):
    from benchmark import weights
    c = cell["config"]["train"]
    spec = weights.shapes(c["dim_inet"], c["dim_fnet"], c["dim"], c["bins"],
                          c["patch"])
    return weights.random_weights(spec, derived_seed(seed, 0), device)


def _trainer(mod_evonet, mod_trainer, cfg: dict, wts, dev, remat: bool):
    net = mod_evonet.EVONet(cfg["patch"], cfg["dim_inet"], cfg["dim_fnet"],
                            cfg["dim"], cfg["bins"])
    net.load_state_dict(wts)
    return mod_trainer.Trainer(
        net=net, lr=cfg["lr"], total_steps=cfg["total_steps"],
        steps_unrolled=cfg["iters"], ppi=cfg["ppi"],
        grow_after=cfg["grow_after"], corr_dropout=cfg["corr_dropout"],
        remat=remat, device=dev)


def readings(tr, wts: dict, losses: List[float], grad1: Dict[str, float]
             ) -> dict:
    """What the comparison needs of a trainer after CHECKED steps: the
    losses, the first gradient's leaf norms, the change's leaf norms."""
    change = {n: float((p.detach() - wts[n]).norm())
              for n, p in tr.net.named_parameters()}
    return {"loss": losses, "grad1": grad1, "change": change}


def first_grad(tr) -> Dict[str, float]:
    """The first step's gradient leaf norms from AdamW's first moment."""
    out = {}
    for n, p in tr.net.named_parameters():
        m = tr.opt.state.get(p, {}).get("exp_avg")
        out[n] = 0.0 if m is None else float((m / (1 - BETA1)).norm())
    return out


def drive(tr, clips: Clips, steps, dev, after_first=None) -> List[float]:
    losses = []
    for s in steps:
        losses.append(tr.train_step(clips.batch([s]))["loss"])
        if s == 0 and after_first is not None:
            after_first()
    _sync(dev)
    return losses


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The three numbers compared (see the module's docstring)."""
    def leaf_gap(a: Dict[str, float], b: Dict[str, float], keep) -> float:
        med = sorted(b.values())[len(b) // 2]
        return max((abs(a[n] - b[n]) / max(b[n], med, 1e-30)
                    for n in b if keep(n)), default=math.inf)

    g_med = sorted(ref["grad1"].values())[len(ref["grad1"]) // 2]
    moved = lambda n: ref["grad1"][n] >= 1e-3 * g_med  # noqa: E731
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss = math.inf
    return {"loss": loss,
            "grad": leaf_gap(prog["grad1"], ref["grad1"], lambda n: True),
            "change": leaf_gap(prog["change"], ref["change"], moved)}


def clips_rate(t_start: float, ends: List[float], seconds: float,
               batch: int) -> float:
    """Clips a second over the window's completed steps: `ends` are the
    steps' synchronised ends in order; a step that ends past `seconds`
    counts neither its clips nor its time."""
    done = [t for t in ends if t - t_start <= seconds]
    return len(done) * batch / (done[-1] - t_start) if done else 0.0


def run(cell: dict, seed: int, seconds: float, trace: bool, t_process: float,
        device: Optional[str] = None, fault: Optional[str] = None,
        program: Optional[dict] = None, **_) -> dict:
    """One run of a training cell. `device` "cpu", `fault` and `program`
    ({"tf32": True}: the control) are for tests and the control."""
    import torch
    from devo_tpu_torch.nets import evonet as p_evonet
    from devo_tpu_torch.train import trainer as p_trainer
    dev = torch.device(device) if device else torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cfg = cell["config"]["train"]
    _tf32(bool((program or {}).get("tf32", cfg["tf32"])))
    clips = clips_of(cell, seed, dev)
    wts = weights_of(cell, seed, dev)
    tr = _trainer(p_evonet, p_trainer, cfg, wts, dev, cfg["remat"])
    if fault:
        plant(fault, tr)
    grad1 = {}
    losses = drive(tr, clips, range(CHECKED), dev,
                   lambda: grad1.update(first_grad(tr)))
    prog = readings(tr, wts, losses, grad1)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.monotonic() - t_process

    B = cfg["batch"]
    t_start = time.monotonic()
    ends, s = [], CHECKED
    while not ends or ends[-1] - t_start <= seconds:
        tr.train_step(clips.batch(range(s * B, (s + 1) * B)))
        _sync(dev)
        ends.append(time.monotonic())
        s += 1
    rate = clips_rate(t_start, ends, seconds, B)
    steps = [round(b - a, 4) for a, b in zip([t_start] + ends, ends)]
    print(f"window steps (s): {steps}", file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = {"attempted": s - CHECKED, "failed": 0,
           "card": harness.card_info() if dev.type == "cuda" else None,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": kind, "count": 1, "memory_peak_bytes": int(peak)},
           "end_to_end": {
               "train_clips_per_s": {"value": rate, "unit": "clips/s"},
               "peak_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
               "setup_s": {"value": setup_s, "unit": "s"}}}
    if trace:
        out["trace"], out["breakdown"] = profile_step(tr, clips, s, dev, cfg,
                                                      rate)
        out["device"]["busy_s"] = out["trace"]["busy_s"]
        out["device"]["window_s"] = out["trace"]["window_s"]

    del tr
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _tf32(False)
    ref = reference(cell, seed, dev)
    ok, compared = harness.judge(compare(prog, ref), cell["workload"]["limits"])
    out.update(correct=ok, compared=compared)
    return out


def reference(cell: dict, seed: int, dev) -> dict:
    """The reference's readings after CHECKED steps from the same weights
    and clips."""
    from benchmark.reference.nets import evonet as r_evonet
    from benchmark.reference.train import trainer as r_trainer
    cfg = cell["config"]["train"]
    clips = clips_of(cell, seed, dev)
    wts = weights_of(cell, seed, dev)
    tr = _trainer(r_evonet, r_trainer, cfg, wts, dev, remat=False)
    grad1 = {}
    losses = drive(tr, clips, range(CHECKED), dev,
                   lambda: grad1.update(first_grad(tr)))
    return readings(tr, wts, losses, grad1)


def profile_step(tr, clips, s: int, dev, cfg: dict, rate: float):
    """One more step under torch.profiler, the device's activity alone (the
    host's would slow its ~400k launches): its kernels, the card's busy
    time over the step's wall time, and the top device operations."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    from benchmark.yardstick import flops, trace as tt
    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else [
        ProfilerActivity.CPU]
    with prof_ctx(activities=acts) as prof:
        wall0 = time.time_ns()
        tr.train_step(clips.batch([s]))
        _sync(dev)
        wall1 = time.time_ns()
    summ = tt.summarize(prof)
    numbers = {"kind": "train", "n_kernels": summ["n_kernels"],
               "steps_profiled": 1,
               "busy_s": sum(e - a for a, e in summ["busy"]) / 1e9,
               "window_s": (wall1 - wall0) / 1e9,
               "step_flops": flops.train_step_flops(cfg),
               "steps_per_s": rate / cfg["batch"]}
    return numbers, tt.breakdown(summ)


def plant(name: str, tr):
    """Faults under the timed path, for the test that sees `correct` come
    out false: a step that leaves the parameters unchanged, or one whose
    update is altered where the optimizer produces it."""
    import torch
    if name == "frozen":
        tr.opt.step = lambda *a, **k: None
    elif name == "altered":
        orig = tr.opt.step

        def altered(*a, **k):
            out = orig(*a, **k)
            with torch.no_grad():
                p = next(iter(tr.net.parameters()))
                p.add_(1e-3 * p.abs().max())
            return out

        tr.opt.step = altered
    else:
        raise ValueError(f"no fault {name!r}")


FAULTS = ("frozen", "altered")
