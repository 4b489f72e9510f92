"""In-training validation on TartanAir-EVS validation scenes (counterpart of
devo_tpu/train/validate.py, after upstream DEVO's every-10k-steps hook,
train.py:282-294): the port's tracking engine runs over each scene with the
training network's current weights, and the Sim3-aligned ATE goes to the
logger, with trajectory figures where matplotlib imports (devo/logger.py:
55-60). Engines are cached across rounds: a cached engine is reset to the
new weights.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Dict, Optional

import numpy as np

from devo_tpu_torch.data.loaders import voxel_h5_iterator
from devo_tpu_torch.data.tartan import DEPTH_SCALE, TARTAN_INTRINSICS
from devo_tpu_torch.eval.ate import ate_real
from devo_tpu_torch.eval.harness import run_voxel
from devo_tpu_torch.runtime.config import EVAL_CONFIGS, VOConfig


def _load_tartan_gt(scene: str) -> np.ndarray:
    """Ground-truth camera-to-world poses of an evs_left scene directory
    (NED -> camera permutation and DEPTH_SCALE, as data/tartan.pose_read);
    the first pose is skipped: voxel t holds the events between frames
    t - 1 and t."""
    pose_path = osp.join(scene.replace("evs_left", "image_left"),
                         "pose_left.txt")
    poses = np.loadtxt(pose_path, delimiter=" ")[1:]
    poses = poses[:, [1, 2, 0, 4, 5, 3, 6]]
    poses[:, :3] /= DEPTH_SCALE
    return poses.astype(np.float32)


def validate_tartan_evs(weights, val_scenes, cfg: Optional[VOConfig] = None,
                        engine_cache: Optional[dict] = None,
                        max_frames: Optional[int] = None,
                        figures_dir: Optional[str] = None, step: int = 0,
                        ht: int = 480, wd: int = 640,
                        intrinsics: Optional[np.ndarray] = None,
                        device=None) -> Dict[str, float]:
    """Tracks each scene (an evs_left directory of voxel h5 files) with
    `weights` (an EVONet state dict). Returns {"val/<scene>/ate": cm, ...,
    "val/ate_mean": cm}; a scene that raises is recorded as
    "val/<scene>/failed" and left out of the mean."""
    cfg = cfg or EVAL_CONFIGS.get("tartanair", EVAL_CONFIGS["default"])
    if engine_cache is None:
        engine_cache = {}
    metrics: Dict[str, float] = {}
    ates = []
    for scene in val_scenes:
        name = "_".join(scene.rstrip("/").split(os.sep)[-3:])
        gt = _load_tartan_gt(scene)
        tss = np.arange(len(gt), dtype=np.float64)
        vdir = osp.join(scene, "h5") if osp.isdir(osp.join(scene, "h5")) \
            else scene
        intr = TARTAN_INTRINSICS if intrinsics is None else intrinsics

        def it():
            gen = voxel_h5_iterator(vdir, intr, tss_us=tss * 1e6)
            for i, item in enumerate(gen):
                if max_frames is not None and i >= max_frames:
                    break
                yield item

        try:
            poses, tss_est, _fps = run_voxel(cfg, weights, it(), ht, wd,
                                             engine_cache=engine_cache,
                                             device=device)
        except Exception as e:  # noqa: BLE001
            # one bad scene must not end a long training run; the failure
            # is recorded, so that val/ate_mean is never silently taken over
            # a smaller set of scenes
            print(f"[val] scene {name} FAILED: {type(e).__name__}: {e}")
            metrics[f"val/{name}/failed"] = 1.0
            continue
        m = ate_real(poses, tss_est, gt, tss, max_diff=0.5)
        metrics[f"val/{name}/ate"] = float(m.ate)
        ates.append(float(m.ate))
        if figures_dir:
            _save_traj_figure(figures_dir, name, step, poses, gt)
    if ates:
        metrics["val/ate_mean"] = float(np.mean(ates))
    return metrics


def _save_traj_figure(outdir: str, name: str, step: int,
                      poses_est: np.ndarray, poses_gt: np.ndarray):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    os.makedirs(outdir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(poses_gt[:, 0], poses_gt[:, 1], "k-", lw=1, label="GT")
    ax.plot(poses_est[:, 0], poses_est[:, 1], "b-", lw=1, label="est")
    ax.set_aspect("equal")
    ax.legend()
    fig.savefig(osp.join(outdir, f"{name}_step{step}.png"), dpi=100)
    plt.close(fig)
