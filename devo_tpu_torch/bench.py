"""Benchmark: event-voxel VO throughput of the port on one CUDA GPU
(counterpart of devo_tpu's bench.py).

    python -m devo_tpu_torch.bench [--device cpu]

Runs the full DEVO tracking engine (patchify CNNs + patch selection +
recurrent update + bundle adjustment + keyframing) at full model width with
seeded random weights over a synthetic EDS-resolution (480x640, 5-bin)
event-voxel stream, a sliding texture with real optical flow, and prints ONE
JSON line with the steady-state frames/s.

The operating point. Under random weights every frame is culled (the flow
magnitude stays under KEYFRAME_THRESH), each cull removes one frame's edges
while the append adds slightly more, and the live edge count creeps about 96
edges a frame without bound. The cap therefore defines the point: by default
EDGE_CAP = 12288 (an append past it drops the table's tail), the mid-band of
real sequence loads; the frames before the timed windows run until the live
count is within 128 of the cap, so that every window measures the saturated
state. The live count is the number of edges a frame's update runs on, the
table after the append (`DEVO.update_edges`): the cull that follows shrinks
the table at once, where devo_tpu's engine keeps the culled rows, masked,
until the next append. BENCH_KEYFRAME_THRESH=-1 selects the no-cull
maximum-load point: EDGE_CAP stays at its derived worst case, the live count
saturates near 41k edges, and two calm probes end the warm-up.

The measurement. N_WARM frames, N_POST more, then up to N_POST_MAX in steps
of 8 until the operating point is reached; then N_BENCH timed frames as
WINDOWS windows, one torch.cuda.synchronize() at each window's end and none
inside. Each frame goes to the device by one copy, as the eval harness
copies it. Per window the JSON also carries the host time spent inside the
engine's calls (which return before the device has finished), the time of
the copies, and the live edge count, read outside the window's clock.

Environment knobs, each failing loudly on a bad value:
  BENCH_CORR_KERNEL      mono (default), mono2, mono3, mono4, pair, pair2,
                         split, split2, g8c: VOConfig.CORR_KERNEL
  BENCH_RING_I8          1 (default) / 0: int8 or bf16 feature rings
  BENCH_KEYFRAME_THRESH  VOConfig.KEYFRAME_THRESH; negative = maximum load
devo_tpu's other bench knobs choose transports and layouts that this port
does not have (BENCH_WIRE, BENCH_CORR_WR1, BENCH_SCORER_S2D,
BENCH_ENCODER_S2D, DEVO_FORCE_BUCKET, DEVO_CORR_IF / K / BE): with one of
them set the program exits, so that a run never measures another
configuration than the one asked for.

With no --device the program takes the current CUDA device and exits
non-zero where there is none; --device cpu runs the plain path (a test's
size only: the numbers of a CPU run say nothing about the card).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from devo_tpu_torch.nets.evonet import EVONet
from devo_tpu_torch.ops import corr as corr_plain
from devo_tpu_torch.ops import corr_cuda
from devo_tpu_torch.runtime.config import VOConfig
from devo_tpu_torch.runtime.engine import DEVO, resolve_device
from devo_tpu_torch.utils.params import random_state_dict

HT, WD, BINS = 480, 640, 5
N_WARM, N_POST, N_POST_MAX, N_BENCH, WINDOWS = 48, 8, 336, 336, 12
EDGE_POINT = 12288            # the saturated point's EDGE_CAP
NEAR_CAP = 128                # "at the cap": within this many edges of it
CALM = 64                     # a calm probe: fewer new edges in 8 frames
KERNELS = ("split", "split2", "pair", "pair2", "mono", "mono2", "mono3",
           "mono4", "g8c")
DROPPED_KNOBS = ("BENCH_WIRE", "BENCH_CORR_WR1", "BENCH_SCORER_S2D",
                 "BENCH_ENCODER_S2D", "DEVO_FORCE_BUCKET", "DEVO_CORR_IF",
                 "DEVO_CORR_K", "DEVO_CORR_BE")


def _hb(msg):
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def texture(ht: int = HT, wd: int = WD, bins: int = BINS) -> np.ndarray:
    """The synthetic event texture, (ht, 2 * wd, bins) f32: seeded normal
    values at 10% density."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((ht, wd * 2, bins)).astype(np.float32)
    base *= (rng.random((ht, wd * 2, bins)) < 0.1)
    return base


def frame(base: np.ndarray, i: int) -> np.ndarray:
    """Frame i of the stream: the (ht, wd, bins) view of the texture that
    slides 3 pixels a frame."""
    wd = base.shape[1] // 2
    sh = (3 * i) % wd
    return base[:, sh:sh + wd]


def frames(n: int, ht: int = HT, wd: int = WD):
    """The first n frames of the stream."""
    base = texture(ht, wd)
    for i in range(n):
        yield frame(base, i)


def intrinsics(ht: int = HT, wd: int = WD) -> np.ndarray:
    return np.asarray([320.0, 320.0, wd / 2, ht / 2], np.float32)


def knobs_from_env(environ=os.environ) -> dict:
    """VOConfig overrides from the BENCH_* environment knobs. Exits on a bad
    value and on a knob of something the port does not have."""
    for name in DROPPED_KNOBS:
        if name in environ:
            sys.exit(f"{name} is set, and devo_tpu_torch has no counterpart "
                     f"of what it chooses (a TPU transport, layout or "
                     f"compiled shape): unset it")
    ring_raw = environ.get("BENCH_RING_I8", "1").strip().lower()
    if ring_raw not in ("0", "1", "true", "false", "yes", "no", ""):
        sys.exit(f"BENCH_RING_I8={ring_raw!r}: expected one of "
                 "0/1/true/false/yes/no")
    kern = environ.get("BENCH_CORR_KERNEL", "").strip().lower()
    kern = kern or VOConfig.CORR_KERNEL
    if kern not in KERNELS:
        sys.exit(f"BENCH_CORR_KERNEL={kern!r}: expected {'/'.join(KERNELS)}")
    kf_raw = environ.get("BENCH_KEYFRAME_THRESH", str(VOConfig.KEYFRAME_THRESH))
    try:
        kf_thresh = float(kf_raw)
    except ValueError:
        sys.exit(f"BENCH_KEYFRAME_THRESH={kf_raw!r}: expected a number")
    return dict(CORR_RING_I8=ring_raw in ("1", "true", "yes"),
                CORR_KERNEL=kern, KEYFRAME_THRESH=kf_thresh)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def run(cfg_overrides: dict = None, device=None, n_warm: int = N_WARM,
        n_post: int = N_POST, n_post_max: int = N_POST_MAX,
        n_bench: int = N_BENCH, windows: int = WINDOWS, ht: int = HT,
        wd: int = WD) -> dict:
    """One benchmark run; returns the result as a dict: what `main` prints,
    and (not printed) the final trajectory under "poses" and the engine
    under "engine".

    `cfg_overrides`: VOConfig fields over the bench's configuration (full
    model width, MOTION_PROBE_THRESH=-1). With KEYFRAME_THRESH >= 0 the run
    is pinned: EDGE_CAP is EDGE_POINT unless given, and timing starts once
    the live count is within NEAR_CAP of it; otherwise after two calm
    probes. A run that has not reached its point after n_post_max frames
    says so ("reached": false). The defaults are the full-length run."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    over = dict(cfg_overrides or {})
    # the motion-probe gate is a learned behavior (devo.py:531-534); with
    # random weights it rejects every frame and the bench would measure the
    # (cheap) rejection path instead of tracking
    over.setdefault("MOTION_PROBE_THRESH", -1.0)
    pinned = over.get("KEYFRAME_THRESH", VOConfig.KEYFRAME_THRESH) >= 0
    if pinned:
        over.setdefault("EDGE_CAP", EDGE_POINT)
    cfg = VOConfig(HT=ht, WD=wd, **over)
    target = cfg.EDGE_CAP if pinned else None
    weights = random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS), seed=0)
    slam = DEVO(cfg, weights, ht=ht, wd=wd, seed=0, device=device)
    base = texture(ht, wd, cfg.BINS)
    intr = intrinsics(ht, wd)
    copy_s = 0.0
    n_fed = 0

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def feed():
        """The next frame: one contiguous copy to the device, then the
        engine. Returns the host time inside the engine's call."""
        nonlocal copy_s, n_fed
        t0 = time.perf_counter()
        vox = torch.from_numpy(np.ascontiguousarray(frame(base, n_fed))).to(device)
        t1 = time.perf_counter()
        slam(n_fed / 30.0, vox, intr)
        t2 = time.perf_counter()
        copy_s += t1 - t0
        n_fed += 1
        return t2 - t1

    _hb(f"engine built on {device}; warming")
    for _ in range(n_warm + n_post):
        feed()
    sync()
    # keep running post frames until the operating point is reached, so
    # that every timed window measures the same load
    used = n_post
    cur = prev = slam.update_edges
    calm = 0
    reached = target is not None and cur >= target - NEAR_CAP
    while not reached and used + 8 <= n_post_max:
        for _ in range(8):
            feed()
        used += 8
        sync()
        cur = slam.update_edges
        if target is not None:
            # pinned: the live-edge treadmill creeps to the cap and
            # equilibrates there under append-shedding
            reached = cur >= target - NEAR_CAP
            continue
        # maximum load: append and removal make the growth bursty; require
        # two consecutive calm probes
        calm = calm + 1 if cur - prev < CALM else 0
        reached = calm >= 2
        prev = cur
    _hb(f"{cur} live edges after {n_warm + used} frames "
        f"({'at' if reached else 'NOT at'} the operating point); timing")

    per = n_bench // windows
    win_dt, win_disp, win_copy, win_live = [], [], [], []
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    corr_cuda.reset_launches()
    corr_plain.calls = 0
    for _ in range(windows):
        copy_s = 0.0
        disp = 0.0
        t0 = time.perf_counter()
        for _ in range(per):
            # host time inside the engine's call (it returns before the
            # device has finished): near the window's length, the run is
            # bound by the host's dispatch, not by the device
            disp += feed()
        sync()
        win_dt.append(time.perf_counter() - t0)
        win_disp.append(disp)
        win_copy.append(copy_s)
        win_live.append(slam.update_edges)   # outside the window's clock
    launches = {k: v for k, v in corr_cuda.launches.items() if v}
    plain_calls = corr_plain.calls
    peak_gib = (torch.cuda.max_memory_allocated(device) / 2**30 if on_card
                else None)
    poses, _ = slam.terminate()

    win_fps = [per / dt for dt in win_dt]
    fps = windows * per / sum(win_dt)
    return {
        "metric": "event_vo_fps_640x480",
        "value": round(fps, 2),
        "unit": "frames/s",
        "steady_window_fps": round(float(np.median(win_fps)), 2),
        "window_fps": [round(f, 2) for f in win_fps],
        "window_spread": round((max(win_fps) - min(win_fps)) / max(win_fps), 3),
        "config": {"ring_i8": cfg.CORR_RING_I8, "corr_kernel": cfg.CORR_KERNEL,
                   "keyframe_thresh": cfg.KEYFRAME_THRESH,
                   "edge_cap": cfg.EDGE_CAP, "l4_resident": slam.l4_resident},
        "size": [ht, wd],
        "device": (torch.cuda.get_device_name(device) if on_card else "cpu"),
        "card": card() if on_card else None,
        "reached": reached,
        "frames_before_timing": n_warm + used,
        "window_dispatch_s": [round(x, 3) for x in win_disp],
        "window_copy_s": [round(x, 3) for x in win_copy],
        "window_end_live_edges": win_live,
        "launches": launches,
        "plain_corr_calls": plain_calls,
        "peak_gib": None if peak_gib is None else round(peak_gib, 3),
        "poses": poses,
        "engine": slam,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="event-voxel VO throughput of devo_tpu_torch")
    parser.add_argument("--device", default=None,
                        help="'cpu' for the plain path; default: the current "
                             "CUDA device, which must exist")
    args = parser.parse_args(argv)
    knobs = knobs_from_env()
    if args.device is None and not torch.cuda.is_available():
        sys.exit("no CUDA device: the bench runs on the card (--device cpu "
                 "runs the plain path)")
    result = run(knobs, device=args.device)
    del result["poses"], result["engine"]
    print(json.dumps(result))
    if not result["reached"]:
        sys.exit("the run did not reach its operating point")


if __name__ == "__main__":
    main()
