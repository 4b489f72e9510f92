"""Command-line evaluation on the event benchmarks (counterpart of
evals/common.py and its eval_*_evs.py wrappers, after the per-benchmark
scripts of upstream DEVO's evals/eval_evs/).

    python -m devo_tpu_torch.eval.cli eds --datapath <dir> --weights DEVO.pth \\
        --val_split splits/eds/eds_val.txt --trials 5 --outdir results

One module serves every benchmark: the benchmark's name is the first
argument. It runs on the current CUDA device; `--device cpu` asks for the
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
from devo_tpu_torch.data.loaders import BENCHMARK_RES, benchmark_iterator
from devo_tpu_torch.eval.ate import aggregate_results
from devo_tpu_torch.eval.harness import evaluate_sequence
from devo_tpu_torch.runtime.config import EVAL_CONFIGS, VOConfig
from devo_tpu_torch.utils.params import load_weights

BENCHMARKS = tuple(BENCHMARK_RES)


def evaluate_benchmark(benchmark: str, args) -> dict:
    cfg = EVAL_CONFIGS.get(benchmark, EVAL_CONFIGS["default"])
    if args.config:
        # reference-format yaml override (eval_eds_evs.py:85 yacs merge)
        cfg = VOConfig.from_yaml(args.config, base=cfg)
    if args.config_overrides:
        cfg = cfg.replace(**json.loads(args.config_overrides))
    if benchmark == "tartanair":
        raise NotImplementedError(
            "the tartanair benchmark reads pre-voxelized TartanAir-EVS trees "
            "through data/tartan.py and train/validate.py, which come with "
            "the training slice of the port (ROADMAP Queue 1)")
    weights = load_weights(args.weights)
    H, W = BENCHMARK_RES[benchmark]

    if args.val_split:
        with open(args.val_split) as f:
            scenes = f.read().split()
    else:
        scenes = [""]
    results = {}
    engine_cache = {}   # one engine across scenes and trials
    for scene in scenes:
        datapath = os.path.join(args.datapath, scene)
        # per-benchmark GT formats (load_utils.py:560-634); the quirk-aware
        # iterator knows each benchmark's file conventions, event-window
        # rule, hot-pixel policy and start/stop crops; the generic
        # preprocessed-tree iterator is its fallback
        try:
            tss_gt_us, traj_gt = load_benchmark_gt(benchmark, datapath)
        except (FileNotFoundError, OSError) as e:
            # a scene without GT must not abort the benchmark and drop the
            # already-computed scenes' results from the final JSON
            print(f"[{benchmark}] {scene}: no ground truth ({e}); skipping",
                  file=sys.stderr)
            results[scene] = dict(error=str(e))
            continue

        # iterator settings the reference eval scripts hardcode
        # (eval_tumvie_evs.py:39 passes dT_ms=25, half the ~50 ms default
        # the mean frame spacing would give at TUM-VIE's image rate)
        it_kw = {"tumvie": {"dT_ms": 25}}.get(benchmark, {})

        def _make_iterator(dp=datapath, gt=tss_gt_us, it_kw=it_kw):
            # the quirk iterators are generators: their file I/O raises at
            # the first next(), not at call time, so probe one item before
            # committing to them, then stitch it back on. Only missing-file
            # errors fall back to the generic preprocessed-tree iterator: a
            # data-sanity AssertionError inside a quirk iterator must
            # surface, not silently swap windowing and hot-pixel semantics.
            try:
                it = benchmark_evs_iterator(benchmark, dp, stride=args.stride,
                                            tss_gt_us=gt, **it_kw)
                first = next(it)
            except (FileNotFoundError, OSError, StopIteration):
                return benchmark_iterator(benchmark, dp, stride=args.stride)
            return itertools.chain([first], it)

        med, all_res, fps = evaluate_sequence(
            cfg, weights,
            make_iterator=_make_iterator,
            traj_gt=traj_gt, tss_gt=tss_gt_us / 1e6,
            trials=args.trials, ht=H, wd=W,
            outdir=args.outdir, name=scene.replace("/", "_") or benchmark,
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
        benchmark, outfolder=args.outdir)
    return results


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m devo_tpu_torch.eval.cli",
        description="DEVO (PyTorch/CUDA) evaluation on an event benchmark")
    p.add_argument("benchmark", choices=BENCHMARKS)
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
                   help="the live viewer of trial 0 (not ported yet: raises)")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    results = evaluate_benchmark(args.benchmark, args)
    os.makedirs(args.outdir, exist_ok=True)
    with open(os.path.join(args.outdir,
                           f"{args.benchmark}_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
