"""Training loop (counterpart of devo_tpu/train/trainer.py, after upstream
DEVO's train.py): AdamW with the linear one-cycle schedule (train.py:
109-111), the gradient clipped to a global norm of 10 (train.py:248),
checkpoints of model, optimizer, schedule and step (train.py:271-280), and
data parallelism by DistributedDataParallel (NCCL on GPUs, gloo on the
CPU) where a process group is up.

A step, in devo_tpu's order (trainer.py:116-145): the per-sample losses of
the batch (each sample with its own draws) and their mean's gradient,
all-reduced over the processes; every non-finite gradient entry counted
(`grad_nonfinite`) and set to 0, every gradient set to 0 if the loss is not
finite; the clip; the AdamW step, taken with zero gradients too, as optax
takes it. The step is the tracer's `train.step` span (utils/timing.py),
with train.forward, train.loss, train.backward, train.optimizer
(train.sanitize, train.clip, train.adamw) and train.readout under it.
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from devo_tpu_torch.nets.evonet import EVONet
from devo_tpu_torch.runtime.engine import resolve_device
from devo_tpu_torch.utils.timing import read, span

from .forward import Draws, evonet_forward
from .loss import total_loss

METRICS = ("loss", "flow", "pose", "scores")
WEIGHT_DECAY = 1e-5        # AdamW's (train.py:109)
CLIP = 10.0                # the global gradient norm's limit (train.py:248)
DRAW_SEED = 1234           # the default draws' seed


def one_cycle_linear(lr: float, total_steps: int,
                     pct_start: float = 0.01) -> Callable[[int], float]:
    """devo_tpu's optax schedule (trainer.py:30-37), the reference's
    OneCycleLR(anneal_strategy='linear'): linear from lr / 25 to lr over
    max(int(total_steps * pct_start), 1) steps, then linear to lr / 1e4 at
    total_steps. The learning rate of step k (from 0)."""
    warmup = max(int(total_steps * pct_start), 1)

    def linear(init, end, steps, k):
        # optax.linear_schedule: (init - end) * (1 - k / steps) + end
        if steps <= 0:
            return init
        k = min(max(k, 0), steps)
        return (init - end) * (1.0 - k / steps) + end

    def sched(k: int) -> float:
        if k < warmup:
            return linear(lr / 25.0, lr, warmup, k)
        return linear(lr, lr / 1e4, total_steps - warmup, k - warmup)

    return sched


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm, in place: every gradient scaled by
    max_norm / norm where the global norm reaches max_norm, as (g / norm) *
    max_norm, with nothing added to the divisor."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def _allreduce_sum(state, bucket):
    """DDP's communication hook: the gradients summed over the processes,
    not averaged (each process's losses are already divided by the global
    batch)."""
    fut = dist.all_reduce(bucket.buffer(), async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


class _Sample(nn.Module):
    """One clip's losses as a module's forward, so that
    DistributedDataParallel sees the network's use."""

    def __init__(self, net: EVONet, trainer: "Trainer"):
        super().__init__()
        self.net = net
        self.trainer = trainer

    def forward(self, voxels, poses, disps, intrinsics, draws: Draws,
                structure_only: bool):
        t = self.trainer
        with span("train.forward"):
            traj = evonet_forward(
                self.net, voxels, poses, disps, intrinsics, draws,
                steps=t.steps_unrolled, ppi=t.ppi,
                structure_only=structure_only, randaug_on=t.randaug,
                grow_after=t.grow_after, corr_dropout=t.corr_dropout,
                remat=t.remat)
        # the gradient and random selectors emit no score maps: the scorer
        # loss is the scorer selector's alone (enet.py:193-195)
        with span("train.loss"):
            return total_loss(
                traj, P=self.net.P, structure_only=structure_only,
                use_scorer=self.net.patchify.patch_selector == "scorer",
                **t.weights)


class Trainer:
    """The network, its optimizer and schedule, and the train step. Runs on
    the current CUDA device unless `device` names another."""

    def __init__(self, net: Optional[EVONet] = None, lr: float = 8e-5,
                 total_steps: int = 240_000, steps_unrolled: int = 18,
                 ppi: int = 80, pose_weight: float = 10.0,
                 flow_weight: float = 0.1, scores_weight: float = 0.05,
                 randaug: bool = False, grow_after: int = 8,
                 corr_dropout: float = 0.2, remat: bool = True, device=None):
        """`corr_dropout`: the edge fraction the correlation backward keeps
        (enet.py:204). `remat`: torch.utils.checkpoint around each unrolled
        step."""
        self.device = resolve_device(device)
        self.net = (net or EVONet()).to(self.device)
        self.steps_unrolled = steps_unrolled
        self.ppi = ppi
        self.randaug = randaug
        self.grow_after = grow_after
        self.corr_dropout = corr_dropout
        self.remat = remat
        self.weights = dict(pose_weight=pose_weight, flow_weight=flow_weight,
                            scores_weight=scores_weight)
        self.distributed = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if self.distributed else 0
        self.world = dist.get_world_size() if self.distributed else 1
        self.model = _Sample(self.net, self)
        if self.distributed:
            self.model = nn.parallel.DistributedDataParallel(
                self.model, device_ids=([self.device.index]
                                        if self.device.type == "cuda" else None))
            self.model.register_comm_hook(None, _allreduce_sum)
        self.opt = torch.optim.AdamW(self.net.parameters(), lr=lr,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=WEIGHT_DECAY)
        self.lr_at = one_cycle_linear(lr, total_steps)
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            self.opt, lambda k: self.lr_at(k) / lr)
        self.step = 0

    def draws(self, step: int, sample: int) -> Draws:
        """The draws of one sample (its index in the global batch) of one
        step: a CPU generator seeded from (step, sample), so that a sample
        draws the same on every device and in every process layout."""
        g = torch.Generator().manual_seed(
            (DRAW_SEED << 40) + (step << 16) + sample)
        return Draws(g, self.device)

    def losses(self, batch: Dict[str, torch.Tensor],
               structure_only: bool = False) -> Dict[str, torch.Tensor]:
        """The batch's mean losses, their gradient accumulated into the
        network's (all-reduced over the processes). batch: voxels (B, n, H,
        W, bins), poses (B, n, 7), disps (B, n, H, W), intrinsics (B, 4),
        this process's share of the global batch."""
        B = batch["voxels"].shape[0]
        sums = {k: torch.zeros((), device=self.device) for k in METRICS}
        for i in range(B):
            args = [batch[k][i].to(self.device, torch.float32)
                    for k in ("voxels", "poses", "disps", "intrinsics")]
            draws = self.draws(self.step, self.rank * B + i)
            # one all-reduce a step: the last sample's backward. Each loss
            # is scaled by 1 / (global batch) before its backward and the
            # all-reduce sums: the heads' gradient clip (nets/blocks.py)
            # sees the cotangent of the global mean, as under devo_tpu's
            # grad of the batch mean, whatever the process layout
            last = i == B - 1 or not self.distributed
            with contextlib.nullcontext() if last else self.model.no_sync():
                out = self.model(*args, draws, structure_only)
                with span("train.backward"):
                    (out["loss"] / (B * self.world)).backward()
            for k in METRICS:
                sums[k] = sums[k] + out[k].detach()
        means = {k: v / B for k, v in sums.items()}
        if self.distributed:
            stacked = torch.stack([means[k] for k in METRICS])
            dist.all_reduce(stacked)
            means = dict(zip(METRICS, stacked / self.world))
        return means

    def train_step(self, batch: Dict[str, torch.Tensor],
                   structure_only: bool = False) -> Dict[str, float]:
        """One optimizer step on the batch. Returns the mean losses and
        grad_nonfinite, the count of non-finite gradient entries."""
        with span("train.step", step=self.step):
            self.opt.zero_grad(set_to_none=False)
            means = self.losses(batch, structure_only)
            nonfinite = self.apply_gradients(means["loss"])
            with span("train.readout"):
                metrics = {k: read(v) for k, v in means.items()}
                metrics["grad_nonfinite"] = read(nonfinite)
        return metrics

    @span("train.optimizer")
    def apply_gradients(self, loss: torch.Tensor) -> torch.Tensor:
        """The optimizer step on the network's gradients, in devo_tpu's
        order: count and zero the non-finite entries, zero everything if
        `loss` is not finite, clip, AdamW (with zero gradients too). Returns
        the count of non-finite entries."""
        with span("train.sanitize"):
            grads = []
            for p in self.net.parameters():
                if p.grad is None:      # a parameter the loss does not reach
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            finite = [torch.isfinite(g) for g in grads]
            nonfinite = sum((~f).sum() for f in finite)
            loss_ok = torch.isfinite(loss)
            with torch.no_grad():
                for g, f in zip(grads, finite):
                    g.copy_(torch.where(f & loss_ok, g, torch.zeros_like(g)))
        with span("train.clip"), torch.no_grad():
            clip_by_global_norm(grads, CLIP)
        with span("train.adamw"):
            self.opt.step()
            self.sched.step()
        self.step += 1
        return nonfinite

    def lr(self) -> float:
        """The learning rate the next step takes."""
        return self.opt.param_groups[0]["lr"]

    # ------------------------------------------------------ checkpoints
    # model + optimizer + schedule + step, as the reference saves them
    # (train.py:271-280): a resume without the AdamW moments or the
    # schedule's position would leave the uninterrupted run's path
    def save_checkpoint(self, path: str):
        torch.save({"model": self.net.state_dict(),
                    "optimizer": self.opt.state_dict(),
                    "scheduler": self.sched.state_dict(),
                    "step": self.step}, path)

    def load_checkpoint(self, path: str):
        ck = torch.load(path, map_location=self.device, weights_only=True)
        self.net.load_state_dict(ck["model"])
        self.opt.load_state_dict(ck["optimizer"])
        self.sched.load_state_dict(ck["scheduler"])
        self.step = int(ck["step"])
        return self.step


def init_distributed(device_type: str):
    """The process group from torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) where WORLD_SIZE > 1: NCCL for the card,
    gloo for the CPU. Returns (rank, world size, local rank)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1, 0
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device_type == "cuda":
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    return dist.get_rank(), world, local

