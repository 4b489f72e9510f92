"""Evaluation harness (counterpart of devo_tpu/eval/harness.py, after
upstream DEVO's utils/eval_utils.py).

`run_voxel` drives the DEVO engine over a voxel iterator (plus 12 final
refinement updates, eval_utils.py:127-130), and `evaluate_sequence`
aggregates ATE/MPE/R_rmse over seeded trials with median selection
(eval_utils.py:418-452) and writes per-trial TUM trajectory dumps and a
results JSON (log_results, eval_utils.py:315-415).

The entry points run on the current CUDA device unless the caller names
another (`device="cpu"` takes the plain correlation). Each frame goes to the
device by one copy of the iterator's contiguous (bins, H, W) array, and the
engine sees it as an (H, W, bins) view. devo_tpu's background upload thread
and its batched uploads are not carried over: they amortise a fixed cost per
transfer that a local card does not have.
"""
from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import asdict
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from devo_tpu_torch.runtime.config import VOConfig
from devo_tpu_torch.runtime.engine import DEVO, resolve_device

from .ate import ate_real, compute_median_results
from .ate_check import cross_check_ate


def _on_device(voxel, device: torch.device) -> torch.Tensor:
    """A (bins, H, W) frame as an (H, W, bins) f32 view on the device."""
    vox = torch.as_tensor(np.ascontiguousarray(voxel), dtype=torch.float32)
    return vox.to(device).permute(1, 2, 0)


def run_voxel(cfg: VOConfig, weights, iterator, ht: int, wd: int,
              seed: int = 0, final_updates: int = 12, timing: bool = False,
              engine_cache: Optional[dict] = None, device=None):
    """Track one sequence; returns (poses (N,7) c2w, tstamps (N,), fps).

    `iterator` yields (voxel (bins, H, W), intrinsics (4,), timestamp).
    `weights`: an EVONet state dict or a checkpoint path. `engine_cache`
    (keyed by (H, W, cfg, device)) reuses DEVO instances, with their network
    on the device and their built kernels, across trials and sequences: a
    cached engine is `reset` to `seed` and tracks as a fresh one would."""
    device = resolve_device(device)
    it = iter(iterator)
    first = next(it, None)
    if first is None:
        raise RuntimeError("empty iterator")
    voxel, intrinsics, tss = first
    H, W = voxel.shape[-2], voxel.shape[-1]
    if (H, W) != (ht, wd):
        # the engine is sized by the voxels the iterator yields: a resize
        # must happen in the iterator (e.g. tumvie_evs_iterator(H=, W=))
        print(f"[run_voxel] iterator yields {H}x{W} voxels; "
              f"caller asked {ht}x{wd} - tracking at {H}x{W}",
              file=sys.stderr)
    W_eff = W - 2 if W == 346 else W  # MVSEC crop (devo.py:466)
    # the key includes cfg: a cached engine keeps its config on reset, so
    # reuse across configs (e.g. run_voxel_norm_seq's NORM='none') would
    # track with the wrong settings
    key = (H, W_eff, cfg, str(device))
    if engine_cache is not None and key in engine_cache:
        slam = engine_cache[key]
        slam.reset(seed=seed, weights=weights)
    else:
        slam = DEVO(cfg, weights, ht=H, wd=W_eff, seed=seed, device=device)
        if engine_cache is not None:
            engine_cache[key] = slam

    t_start = time.perf_counter()
    slam(tss, _on_device(voxel, device), intrinsics)
    nframes = 1
    for voxel, intr, t in it:
        slam(t, _on_device(voxel, device), intr)
        nframes += 1

    for _ in range(final_updates):
        slam.update()

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t_start
    fps = nframes / dt
    if timing:
        print(f"{nframes} frames in {dt:.2f}s -> {fps:.2f} FPS")

    poses, tstamps = slam.terminate()
    return poses, tstamps, fps


def run_voxel_norm_seq(cfg: VOConfig, weights, iterator, ht: int, wd: int,
                       seed: int = 0, final_updates: int = 12,
                       N_norm: int = 15, engine_cache: Optional[dict] = None,
                       device=None):
    """run_voxel with batched sequence normalization: buffer N_norm frames,
    rescale each polarity jointly over the batch to [-1, 1], then track
    (upstream DEVO's utils/eval_utils.py:69-107 run_voxel_norm_seq). The
    engine runs with NORM='none' so frames are not normalized again."""
    cfg = cfg.replace(NORM="none")

    def normed():
        buf = []
        for item in iterator:
            buf.append(item)
            if len(buf) < N_norm:
                continue
            yield from _flush_norm(buf)
            buf = []
        yield from _flush_norm(buf)

    def _flush_norm(buf):
        if not buf:
            return
        vox = np.stack([np.asarray(v, np.float32) for v, _, _ in buf])
        pos, neg = vox > 0, vox < 0
        vmax = vox[pos].max() if pos.any() else 1.0
        vmin = vox[neg].min() if neg.any() else 1.0
        vox = np.where(pos, vox / vmax, vox)
        vox = np.where(neg, vox / -vmin, vox)
        for v, (_, intr, t) in zip(vox, buf):
            yield v, intr, t

    return run_voxel(cfg, weights, normed(), ht, wd, seed=seed,
                     final_updates=final_updates, engine_cache=engine_cache,
                     device=device)


def evaluate_sequence(
    cfg: VOConfig, weights, make_iterator: Callable[[], Iterable],
    traj_gt: np.ndarray, tss_gt: np.ndarray,
    trials: int = 1, ht: int = 480, wd: int = 640,
    max_diff_s: float = 1.0, outdir: Optional[str] = None, name: str = "seq",
    engine_cache: Optional[dict] = None, viz: bool = False, device=None,
):
    """Seeded multi-trial evaluation; returns (median TrajectoryMetrics,
    all metrics, fps list). One engine is shared across trials (and across
    sequences if the caller passes a persistent `engine_cache`). Every
    trial's ATE is recomputed by an independent implementation and the two
    must agree (eval/ate_check.py). The live viewer is not ported: `viz`
    raises."""
    if viz:
        raise NotImplementedError(
            "the live viewer (devo_tpu/runtime/viewer.py) is not ported yet: "
            "see ROADMAP.md, Queue 1, the viewer")
    results, fps_list = [], []
    if engine_cache is None:
        engine_cache = {}
    for trial in range(trials):
        poses, tss, fps = run_voxel(cfg, weights, make_iterator(), ht, wd,
                                    seed=trial, engine_cache=engine_cache,
                                    device=device)
        m = ate_real(poses, tss, traj_gt, tss_gt, max_diff=max_diff_s)
        # runtime metric cross-check (reference eval_utils.py:358: evo and
        # rpg ATE must agree to 1e-5): recompute with the independent
        # Horn-quaternion alignment and assert
        cross_check_ate(m, poses, tss, traj_gt, tss_gt, max_diff=max_diff_s)
        results.append(m)
        fps_list.append(fps)
        if outdir:
            os.makedirs(outdir, exist_ok=True)
            save_tum(os.path.join(outdir, f"{name}_trial{trial}.txt"), poses, tss)

    med, _ = compute_median_results(results)
    if outdir:
        with open(os.path.join(outdir, f"{name}_results.json"), "w") as f:
            json.dump({"median": asdict(med),
                       "trials": [asdict(r) for r in results],
                       "fps": fps_list}, f, indent=2)
    return med, results, fps_list


def save_tum(path: str, poses: np.ndarray, tss: np.ndarray):
    """TUM-format trajectory export (devo/plot_utils.py:86-91)."""
    data = np.concatenate([np.asarray(tss)[:, None], poses], axis=1)
    np.savetxt(path, data, fmt="%.9f")
