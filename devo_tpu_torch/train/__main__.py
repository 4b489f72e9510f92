"""Training entry point (the port's counterpart of train.py, after upstream
DEVO's train.py): TartanAir-EVS clips through the unrolled network with the
flow, pose and scorer losses, AdamW with the linear one-cycle schedule, the
gradient clipped at 10, checkpoints and in-training validation every
--ckpt_every / --eval_every steps, the first 1000 steps of a fresh run
structure-only.

    python -m devo_tpu_torch.train --name run1 --datapath <tartanair_root> \\
        --steps 240000 --lr 8e-5 --iters 18 --n_frames 15
    torchrun --nproc_per_node 4 -m devo_tpu_torch.train --datapath ...

It runs on the current CUDA device (under torchrun, one a process, with
DistributedDataParallel over NCCL); `--device cpu` runs on the CPU (gloo
under torchrun). `--batch` is the batch of one process.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import queue
import threading
import time

import numpy as np
import torch


def _make_batch(dataset, idxs):
    """Items of `dataset` stacked into a batch, voxels channels-last."""
    samples = [dataset[int(i)] for i in idxs]
    return {
        "voxels": np.stack([s[0] for s in samples]).transpose(0, 1, 3, 4, 2),
        "poses": np.stack([s[1] for s in samples]),
        "disps": np.stack([s[2] for s in samples]),
        "intrinsics": np.stack([s[3][0] for s in samples]),
    }


def _proc_worker(dataset, batch_size, seed, wid, q):
    """A worker process's loop (top level, so that spawn can pickle it)."""
    wrng = np.random.default_rng(seed + wid + 1)
    while True:
        q.put(_make_batch(dataset, wrng.integers(0, len(dataset), batch_size)))


def data_loader(dataset, batch_size: int, seed: int, workers: int = 4,
                qsize: int = 4, method: str = "thread"):
    """Background batch producer (counterpart of DataLoader(num_workers=4),
    upstream train.py:93-95). "thread": the h5 decode and the numpy
    augmentor release the GIL; "process": spawned workers, for datasets
    whose per-item work holds it."""
    if method == "process":
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        q = ctx.Queue(maxsize=qsize)
        for w in range(workers):
            ctx.Process(target=_proc_worker,
                        args=(dataset, batch_size, seed, w, q),
                        daemon=True).start()
        while True:
            yield q.get()

    tq: "queue.Queue" = queue.Queue(maxsize=qsize)

    def worker(wid):
        wrng = np.random.default_rng(seed + wid + 1)
        while True:
            tq.put(_make_batch(dataset,
                               wrng.integers(0, len(dataset), batch_size)))

    for w in range(workers):
        threading.Thread(target=worker, args=(w,), daemon=True).start()
    while True:
        yield tq.get()


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m devo_tpu_torch.train",
                                description="DEVO training (PyTorch)")
    p.add_argument("--name", default="devo_tpu")
    p.add_argument("--datapath", required=True)
    p.add_argument("--ckpt_dir", default="checkpoints")
    p.add_argument("--checkpoint", default=None, help="resume path")
    p.add_argument("--loader", default="thread", choices=["process", "thread"],
                   help="batch-loader workers: threads (the h5 decode and "
                        "the numpy augmentor release the GIL) or spawned "
                        "processes")
    p.add_argument("--loader_workers", type=int, default=4)
    p.add_argument("--warmstart", default=None,
                   help="torch .pth to warm-start from (e.g. RGB-pretrained "
                        "DPVO): the weights whose shapes differ, the "
                        "3-channel conv1 pair, keep their initialization "
                        "(reference train.py:114-138)")
    p.add_argument("--steps", type=int, default=240_000)
    p.add_argument("--lr", type=float, default=8e-5)
    p.add_argument("--batch", type=int, default=1, help="per-process batch")
    p.add_argument("--iters", type=int, default=18)
    p.add_argument("--n_frames", type=int, default=15)
    p.add_argument("--patches_per_image", type=int, default=80)
    p.add_argument("--dim_inet", type=int, default=384)
    p.add_argument("--dim_fnet", type=int, default=128)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--pose_weight", type=float, default=10.0)
    p.add_argument("--flow_weight", type=float, default=0.1)
    p.add_argument("--scores_weight", type=float, default=0.05)
    p.add_argument("--ckpt_every", type=int, default=10_000)
    p.add_argument("--eval_every", type=int, default=10_000,
                   help="in-training validation cadence (ref train.py:282)")
    p.add_argument("--val_split", default="splits/tartan/tartan_val.txt",
                   help="file listing validation scenes (evs_left inserted "
                        "where the entry does not hold it)")
    p.add_argument("--val_datapath", default=None,
                   help="root of the val_split entries (default: --datapath)")
    p.add_argument("--val_max_frames", type=int, default=None,
                   help="cap frames per validation sequence (smoke runs)")
    p.add_argument("--randaug", action="store_true",
                   help="randAug voxel augmentation")
    p.add_argument("--crop_size", type=int, nargs=2, default=(480, 640),
                   help="augmentor crop (H W)")
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler over a few steady steps "
                        "(ref train.py:143-152)")
    p.add_argument("--profile_at", type=int, default=10,
                   help="steps after start before the profile begins")
    p.add_argument("--profile_steps", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="torch device; default: the current CUDA device "
                        "(there must be one). 'cpu' trains on the CPU")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)

    from devo_tpu_torch.data.tartan import TartanAirEVS, evs_scene_dir
    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.runtime.config import EVAL_CONFIGS
    from devo_tpu_torch.runtime.engine import resolve_device
    from devo_tpu_torch.train.trainer import Trainer, init_distributed
    from devo_tpu_torch.train.validate import validate_tartan_evs
    from devo_tpu_torch.utils import timing
    from devo_tpu_torch.utils.logger import Logger
    from devo_tpu_torch.utils.params import random_state_dict, warm_start

    if args.device is None:
        resolve_device(None)        # raises where there is no CUDA device
    rank, world, _ = init_distributed(
        "cuda" if args.device is None else torch.device(args.device).type)
    device = resolve_device(args.device)
    lead = rank == 0
    if lead:
        print(f"devices: {world} x {device}", flush=True)

    dataset = TartanAirEVS(args.datapath, n_frames=args.n_frames,
                           crop_size=tuple(args.crop_size),
                           cache_path=os.path.join(args.datapath,
                                                   "fgraph_cache.pkl"))
    if lead:
        print(f"dataset: {len(dataset)} clips", flush=True)

    net = EVONet(dim_inet=args.dim_inet, dim_fnet=args.dim_fnet, dim=args.dim)
    net.load_state_dict(random_state_dict(net, 0))
    if args.warmstart and not args.checkpoint:
        # RGB -> event migration: a fresh optimizer and schedule, the
        # weights whose shapes match (reference train.py:114-138)
        warm_start(args.warmstart, net, verbose=lead)
    tr = Trainer(net=net, lr=args.lr, total_steps=args.steps,
                 steps_unrolled=args.iters, ppi=args.patches_per_image,
                 pose_weight=args.pose_weight, flow_weight=args.flow_weight,
                 scores_weight=args.scores_weight, randaug=args.randaug,
                 device=device)
    start = 0
    if args.checkpoint:
        # a full resume: weights, AdamW moments, schedule and step
        start = tr.load_checkpoint(args.checkpoint)

    loader = data_loader(dataset, args.batch, seed=1000 * rank,
                         workers=args.loader_workers, method=args.loader)
    logger = Logger(args.name, total_steps=start) if lead else None

    # validation scenes (the reference evaluates TartanAir-EVS val every 10k
    # steps and logs ATE and trajectory figures, train.py:282-294)
    val_scenes = []
    if lead and args.eval_every and args.val_split \
            and os.path.exists(args.val_split):
        root = args.val_datapath or args.datapath
        val_scenes = [evs_scene_dir(root, s)
                      for s in open(args.val_split).read().split()]
        val_scenes = [s for s in val_scenes if os.path.isdir(s)]
    val_engines = {}     # engines persist across validation rounds

    def run_validation(step):
        # an engine at the training network's dimensions
        cfg = EVAL_CONFIGS.get("tartanair", EVAL_CONFIGS["default"]).replace(
            DIM_INET=args.dim_inet, DIM_FNET=args.dim_fnet, DIM=args.dim,
            PATCHES_PER_FRAME=args.patches_per_image)
        weights = {k: v.detach().clone() for k, v in tr.net.state_dict().items()}
        vm = validate_tartan_evs(
            weights, val_scenes, cfg=cfg, engine_cache=val_engines,
            max_frames=args.val_max_frames,
            figures_dir=os.path.join("runs", args.name, "val_figs"),
            step=step, device=device)
        if vm:
            logger.write_dict(vm)
            print(f"[val @ {step}] " + "  ".join(
                f"{k}={v:.2f}" for k, v in vm.items()), flush=True)

    prof = None
    prof_dir = os.path.join("runs", args.name, "profile")
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        if args.profile and prof is None and step - start == args.profile_at:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            # the tracer on inside the profile: the step's spans show in it
            profiling = contextlib.ExitStack()
            profiling.enter_context(timing.recording())
            prof = profiling.enter_context(
                torch.profiler.profile(activities=acts))
        batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in next(loader).items()}
        # structure-only warmup for the first 1k steps (train.py:160)
        structure_only = step < 1000 and args.checkpoint is None
        metrics = tr.train_step(batch, structure_only)
        if lead:
            logger.push(metrics)
            print(f"step {step + 1}: " + "  ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in metrics.items())
                + f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
        if prof is not None and step - start + 1 == (args.profile_at
                                                    + args.profile_steps):
            prof = _finish_profile(prof, profiling, prof_dir, device, lead)
        if lead and (step + 1) % args.ckpt_every == 0:
            path = os.path.abspath(os.path.join(
                args.ckpt_dir, args.name, f"{step + 1:06d}.pth"))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tr.save_checkpoint(path)
            print(f"saved {path}", flush=True)
        if val_scenes and (step + 1) % args.eval_every == 0:
            run_validation(step + 1)

    if prof is not None:     # the run ended inside the profiled steps
        _finish_profile(prof, profiling, prof_dir, device, lead)
    if logger is not None:
        logger.close()       # flush the tail metrics
    if world > 1:
        torch.distributed.destroy_process_group()


def _finish_profile(prof, profiling: contextlib.ExitStack, prof_dir: str,
                    device, lead: bool):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiling.close()
    if lead:
        os.makedirs(prof_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
        key = ("self_cuda_time_total" if device.type == "cuda"
               else "self_cpu_time_total")
        print(prof.key_averages().table(sort_by=key, row_limit=20), flush=True)
        print(f"profile trace written to {prof_dir}", flush=True)
    return None


if __name__ == "__main__":
    main()
