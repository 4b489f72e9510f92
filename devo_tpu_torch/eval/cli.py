"""Command-line evaluation on the benchmarks (counterpart of evals/common.py
and its eval_*_evs.py wrappers, after the per-benchmark scripts of upstream
DEVO's evals/eval_evs/, and of evals/common_frames.py and its eval_*_rgb.py,
_e2v.py and _evs_frame.py wrappers).

    python -m devo_tpu_torch.eval.cli eds --datapath <dir> --weights DEVO.pth \\
        --val_split splits/eds/eds_val.txt --trials 5 --outdir results
    python -m devo_tpu_torch.eval.cli eds --family rgb --datapath <dir> \\
        --weights <frame model state dict> --trials 5
    python -m devo_tpu_torch.eval.cli tum --family rgb --datapath <dir> \\
        --weights <frame model state dict> --val_split <scenes> --trials 5

One module serves every benchmark: the benchmark's name is the first
argument, `--family` the input (`evs`, the default: event voxels; `rgb`,
`e2v`, `evs_frame`: intensity frames, eval/frames.py). TUM-RGBD (`tum`,
evals/eval_tum_rgb.py's counterpart) takes `--family rgb` alone. It runs on the current CUDA device; `--device cpu` asks for the
plain PyTorch path. `--weights` is a checkpoint of upstream DEVO (.pth) or
a saved EVONet state dict.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

import numpy as np

from devo_tpu_torch.data.benchmarks import (benchmark_evs_iterator,
                                            load_benchmark_gt)
from devo_tpu_torch.data.loaders import (BENCHMARK_RES, benchmark_iterator,
                                         load_tum_traj, voxel_h5_iterator)
from devo_tpu_torch.data.tartan import TARTAN_INTRINSICS, evs_scene_dir
from devo_tpu_torch.eval import frames
from devo_tpu_torch.eval.ate import aggregate_results
from devo_tpu_torch.eval.harness import evaluate_sequence
from devo_tpu_torch.runtime.config import EVAL_CONFIGS, VOConfig
from devo_tpu_torch.train.validate import _load_tartan_gt
from devo_tpu_torch.utils.params import load_weights

# the event benchmarks' sizes, and TUM-RGBD's frames as eval/frames.py
# resizes them
RES = dict(BENCHMARK_RES, tum=(frames.TUM_H, frames.TUM_W))
BENCHMARKS = tuple(RES)


def _evs_family(benchmark: str, args):
    """The event family's configuration, ground-truth loader and iterator
    (evals/common.py)."""
    cfg = EVAL_CONFIGS.get(benchmark, EVAL_CONFIGS["default"])
    if args.config:
        # reference-format yaml override (eval_eds_evs.py:85 yacs merge)
        cfg = VOConfig.from_yaml(args.config, base=cfg)
    # iterator settings the reference eval scripts hardcode
    # (eval_tumvie_evs.py:39 passes dT_ms=25, half the ~50 ms default
    # the mean frame spacing would give at TUM-VIE's image rate)
    it_kw = {"tumvie": {"dT_ms": 25}}.get(benchmark, {})

    def load_gt(datapath):
        # per-benchmark GT formats (load_utils.py:560-634)
        return load_benchmark_gt(benchmark, datapath)

    def iterator_for(datapath, tss_gt_us):
        # the quirk-aware iterator knows each benchmark's file conventions,
        # event-window rule, hot-pixel policy and start/stop crops; the
        # generic preprocessed-tree iterator is its fallback
        def make_iterator():
            # the quirk iterators are generators: their file I/O raises at
            # the first next(), not at call time, so probe one item before
            # committing to them, then stitch it back on. Only missing-file
            # errors fall back to the generic preprocessed-tree iterator: a
            # data-sanity AssertionError inside a quirk iterator must
            # surface, not silently swap windowing and hot-pixel semantics.
            try:
                it = benchmark_evs_iterator(benchmark, datapath,
                                            stride=args.stride,
                                            tss_gt_us=tss_gt_us, **it_kw)
                first = next(it)
            except (FileNotFoundError, OSError, StopIteration):
                return benchmark_iterator(benchmark, datapath,
                                          stride=args.stride)
            return itertools.chain([first], it)
        return make_iterator

    return cfg, load_gt, iterator_for


def _frame_family(family: str, args):
    """A frame family's configuration, ground-truth loader and iterator
    (evals/common_frames.py)."""
    if args.config:
        # the frame drivers take default_rgb.yaml's settings, not the
        # benchmark's event configuration
        raise ValueError("--config applies to the event family; the frame "
                         "families take eval/frames.frame_config() and "
                         "--config_overrides")

    def load_gt(datapath):
        return load_tum_traj(os.path.join(datapath,
                                          "stamped_groundtruth_us.txt"))

    def iterator_for(datapath, tss_gt_us):
        # read here, before the first trial: a missing calib_undist.txt
        # raises
        intr = frames.load_undist_intrinsics(datapath)
        imgdir = os.path.join(datapath, frames.FAMILIES[family])
        return lambda: frames.frame_iterator(imgdir, intr, args.stride)

    return frames.frame_config(), load_gt, iterator_for


def _tum_family(args):
    """TUM-RGBD's configuration, ground truth and iterator
    (evals/eval_tum_rgb.py:50-76): the frame drivers' configuration, the
    scene's groundtruth.txt in seconds, its rgb/ images undistorted and
    resized by eval/frames.tum_image_iterator."""
    if args.config:
        raise ValueError("--config applies to the event family; tum takes "
                         "eval/frames.frame_config() and --config_overrides")

    def load_gt(datapath):
        tss_s, traj = load_tum_traj(os.path.join(datapath, "groundtruth.txt"))
        return tss_s * 1e6, traj

    def iterator_for(datapath, tss_gt_us):
        return lambda: frames.tum_image_iterator(datapath, args.stride)

    return frames.frame_config(), load_gt, iterator_for


def evaluate_benchmark(benchmark: str, args) -> dict:
    """Every scene of the split through evaluate_sequence, one engine
    across scenes and trials, in the input family `args.family`. Returns
    {scene: metrics, "_summary": the benchmark's aggregation}."""
    if benchmark == "tartanair" and args.family != "evs":
        raise ValueError("tartanair: the pre-voxelized TartanAir-EVS trees "
                         "hold event voxels alone (--family evs)")
    if benchmark == "tum":
        if args.family != "rgb":
            raise ValueError("tum: TUM-RGBD holds camera images alone "
                             "(--family rgb)")
        cfg, load_gt, iterator_for = _tum_family(args)
        suffix = "_rgb"
    elif args.family == "evs":
        cfg, load_gt, iterator_for = _evs_family(benchmark, args)
        suffix = ""
    else:
        cfg, load_gt, iterator_for = _frame_family(args.family, args)
        suffix = f"_{args.family}"
    weights = load_weights(args.weights)
    if args.config_overrides:
        cfg = cfg.replace(**json.loads(args.config_overrides))
    H, W = RES[benchmark]

    if args.val_split:
        with open(args.val_split) as f:
            scenes = f.read().split()
    else:
        scenes = [""]
    results = {}
    engine_cache = {}   # one engine across scenes and trials
    if benchmark == "tartanair":
        return _evaluate_tartanair(cfg, weights, scenes, args, engine_cache)
    for scene in scenes:
        datapath = os.path.join(args.datapath, scene)
        try:
            tss_gt_us, traj_gt = load_gt(datapath)
        except (FileNotFoundError, OSError) as e:
            # a scene without GT must not abort the benchmark and drop the
            # already-computed scenes' results from the final JSON
            print(f"[{benchmark}] {scene}: no ground truth ({e}); skipping",
                  file=sys.stderr)
            results[scene] = dict(error=str(e))
            continue
        med, all_res, fps = evaluate_sequence(
            cfg, weights,
            make_iterator=iterator_for(datapath, tss_gt_us),
            traj_gt=traj_gt, tss_gt=tss_gt_us / 1e6,
            trials=args.trials, ht=H, wd=W,
            outdir=args.outdir,
            name=(scene.replace("/", "_") or benchmark) + suffix,
            engine_cache=engine_cache, viz=args.viz, device=args.device,
        )
        results[scene] = dict(ate_cm=med.ate, mpe=med.mpe, r_rmse=med.r_rmse,
                              fps=float(np.mean(fps)),
                              ate_trials=[r.ate for r in all_res])
        print(f"{scene}: ATE {med.ate:.2f} cm  MPE {med.mpe:.3f} %/m  "
              f"R {med.r_rmse:.2f} deg  {np.mean(fps):.1f} FPS")
    # benchmark-level aggregation: per-scene medians + AUC + AVG, plus the
    # reference's LaTeX-row table (eval_utils.py:418-450)
    results["_summary"] = aggregate_results(
        {k: v["ate_trials"] for k, v in results.items() if "ate_trials" in v},
        benchmark + suffix, outfolder=args.outdir)
    return results


def _evaluate_tartanair(cfg, weights, scenes, args, engine_cache) -> dict:
    """The TartanAir-EVS validation benchmark (evals/common.py:108-142):
    one pre-voxelized h5 a frame under <env>/<difficulty>/evs_left/<Pxxx>/
    h5, the ground truth from the parallel image_left/pose_left.txt (NED ->
    camera permutation, the first pose skipped: voxel t holds the events
    between frames t - 1 and t; upstream DEVO's
    evals/eval_evs/eval_tartan_evs.py:38-55), TARTAN_INTRINSICS, 480x640."""
    results = {}
    for scene in scenes:
        scenedir = evs_scene_dir(args.datapath, scene)
        vdir = os.path.join(scenedir, "h5") \
            if os.path.isdir(os.path.join(scenedir, "h5")) else scenedir
        traj_gt = _load_tartan_gt(scenedir)
        tss_gt = np.arange(len(traj_gt), dtype=np.float64)
        med, all_res, fps = evaluate_sequence(
            cfg, weights,
            make_iterator=lambda vd=vdir, gt=tss_gt: voxel_h5_iterator(
                vd, TARTAN_INTRINSICS, tss_us=gt * 1e6),
            traj_gt=traj_gt, tss_gt=tss_gt, trials=args.trials,
            ht=480, wd=640, outdir=args.outdir,
            name=scene.replace("/", "_") or "tartanair",
            engine_cache=engine_cache, max_diff_s=0.5, viz=args.viz,
            device=args.device)
        results[scene] = dict(ate_cm=med.ate, mpe=med.mpe, r_rmse=med.r_rmse,
                              fps=float(np.mean(fps)),
                              ate_trials=[r.ate for r in all_res])
        print(f"{scene}: ATE {med.ate:.2f} cm  {np.mean(fps):.1f} FPS")
    results["_summary"] = aggregate_results(
        {k: v["ate_trials"] for k, v in results.items()},
        "tartanair", outfolder=args.outdir)
    return results


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m devo_tpu_torch.eval.cli",
        description="DEVO (PyTorch/CUDA) evaluation on an event benchmark")
    p.add_argument("benchmark", choices=BENCHMARKS)
    p.add_argument("--family", choices=("evs",) + tuple(frames.FAMILIES),
                   default="evs",
                   help="evs: event voxels; rgb, e2v, evs_frame: intensity "
                        "frames in frame mode (eval/frames.py)")
    p.add_argument("--datapath", default="", help="path to dataset directory")
    p.add_argument("--weights", default="DEVO.pth",
                   help="upstream DEVO checkpoint (.pth) or a saved EVONet "
                        "state dict")
    p.add_argument("--val_split", type=str, default=None)
    p.add_argument("--trials", type=int, default=5)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--outdir", type=str, default="results")
    p.add_argument("--config", type=str, default=None,
                   help="yaml config file (config/eval_*.yaml), applied on "
                        "top of the benchmark's built-in EVAL_CONFIGS entry")
    p.add_argument("--config_overrides", type=str, default=None,
                   help="JSON dict of VOConfig overrides")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the current CUDA device "
                        "(there must be one). 'cpu' runs the plain path")
    p.add_argument("--viz", action="store_true",
                   help="the live viewer of trial 0: PNG frames of the "
                        "trajectory and point cloud in <outdir>/viz_<scene> "
                        "(runtime/viewer.py)")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    results = evaluate_benchmark(args.benchmark, args)
    os.makedirs(args.outdir, exist_ok=True)
    name = args.benchmark if args.family == "evs" else (
        f"{args.benchmark}_{args.family}")
    with open(os.path.join(args.outdir, f"{name}_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
