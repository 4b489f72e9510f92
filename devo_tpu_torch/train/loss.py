"""Training losses (counterpart of devo_tpu/train/loss.py, after the loss
block of upstream DEVO's train.py:176-246):

  * flow loss: the min-over-patch-pixel reprojection residual on close
    edges (dij in (0, 2]), masked by ground-truth validity (train.py:181-184);
  * pose loss: the all-pairs relative-pose error after Umeyama scale
    alignment of the predicted trajectory (train.py:207-236, kabsch_umeyama
    :54-65);
  * scorer loss, on the final iteration: the score-weighted flow error
    modulated by the BA confidence, plus a -log(score) regularizer
    (train.py:189-203).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from devo_tpu_torch.lie import se3
from devo_tpu_torch.utils.timing import upload


def _safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The norm with a guarded root: its gradient at exactly 0 is 0, not
    NaN (masked edges multiply the result by 0, and NaN * 0 = NaN)."""
    return torch.sqrt((x * x).sum(dim).clamp_min(1e-12))


def kabsch_umeyama_scale(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The Sim3 scale that best aligns B to A (train.py:54-65): A = ground
    truth, B = prediction."""
    EA = A.mean(0)
    EB = B.mean(0)
    VarA = ((A - EA) ** 2).sum(-1).mean()
    H = (A - EA).T @ (B - EB) / A.shape[0]
    d = torch.linalg.svdvals(H)
    return VarA / d.sum().clamp_min(1e-9)


def _pixel_error(step: Dict[str, Any]) -> torch.Tensor:
    """Each edge's smallest reprojection error over its patch's pixels."""
    e = _safe_norm(step["coords"] - step["coords_gt"])      # (E, P, P)
    return e.reshape(e.shape[0], -1).amin(-1)


def _edge_mask(step: Dict[str, Any], max_dij: int) -> torch.Tensor:
    dij = np.abs(step["ii"] - step["jj"])
    near = upload((dij > 0) & (dij <= max_dij), step["emask"].device)
    return (step["valid"] > 0.5) & near & step["emask"]


def flow_loss_step(step: Dict[str, Any], P: int) -> torch.Tensor:
    """Min-over-pixel flow residual on close edges (train.py:181-184)."""
    valid = _edge_mask(step, 2)
    cnt = valid.sum().clamp_min(1)
    return (_pixel_error(step) * valid).sum() / cnt


def pose_loss_step(step: Dict[str, Any]) -> torch.Tensor:
    """All-pairs relative pose error with Umeyama scale (train.py:207-236)."""
    Gs = se3.inv(step["Gs"])          # world-to-camera -> camera-to-world
    Ps = se3.inv(step["Ps"])
    N = Gs.shape[0]
    ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    k = ii.reshape(-1) != jj.reshape(-1)
    ii = upload(ii.reshape(-1)[k], Gs.device)
    jj = upload(jj.reshape(-1)[k], Gs.device)

    with torch.no_grad():
        s = kabsch_umeyama_scale(Ps[:, :3], Gs[:, :3]).clamp(max=10.0)
    Gs_scaled = se3.scale(Gs, s)

    dP = se3.mul(se3.inv(Gs_scaled[ii]), Gs_scaled[jj])
    dG = se3.mul(se3.inv(Ps[ii]), Ps[jj])
    e1 = se3.log(se3.mul(dP, se3.inv(dG)))
    tr = _safe_norm(e1[:, :3])
    ro = _safe_norm(e1[:, 3:6])
    return tr.mean() + ro.mean()


def scorer_loss_step(step: Dict[str, Any], P: int) -> torch.Tensor:
    """Score supervision on the last step (train.py:189-203)."""
    valid = _edge_mask(step, 16)
    ef = _pixel_error(step)
    kk = upload(step["kk"], ef.device).long()
    sc = step["scores"].reshape(-1)[kk]
    w_ba = step["weight"].mean(-1).detach()
    mod = -0.5 * torch.log(w_ba.clamp_min(1e-12)) + 1.0
    cnt = valid.sum().clamp_min(1)
    loss = (mod * sc * ef.detach() * valid).sum() / cnt
    reg = -torch.log(step["scores"].clamp_min(1e-6)).mean()
    return loss + reg


def total_loss(traj: List[Dict[str, Any]], P: int = 3,
               flow_weight: float = 0.1, pose_weight: float = 10.0,
               scores_weight: float = 0.05, structure_only: bool = False,
               use_scorer: bool = True) -> Dict[str, torch.Tensor]:
    """The weighted sum over the unrolled steps: the flow loss at every
    step, the pose loss from step 2 on (none under structure_only), the
    scorer loss at the last step for the scorer selector. Returns the loss
    and the last step's flow, pose and scorer terms."""
    zero = traj[0]["coords"].new_zeros(())
    loss = zero
    flow_l = pose_l = scores_l = zero
    for i, step in enumerate(traj):
        fl = flow_loss_step(step, P)
        loss = loss + flow_weight * fl
        flow_l = fl
        pl = pose_loss_step(step)
        pose_l = pl
        if not structure_only and i >= 2:
            loss = loss + pose_weight * pl
        if use_scorer and i == len(traj) - 1:
            sl = scorer_loss_step(step, P)
            loss = loss + scores_weight * sl
            scores_l = sl
    return {"loss": loss, "flow": flow_l, "pose": pose_l, "scores": scores_l}
