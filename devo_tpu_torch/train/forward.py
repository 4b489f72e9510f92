"""Unrolled training forward pass (counterpart of devo_tpu/train/forward.py,
after upstream DEVO's devo/enet.py:235-385, `eVONet.forward`).

Normalize the event voxels (then randaug, p = 0.33), patchify with the
training selector (3x-random candidates, the best-scoring kept), then run
STEPS unrolled iterations of reproject -> correlate -> update -> 2x
differentiable BA, growing the patch graph by one frame a step from step
`grow_after` on (enet.py:319-339), with a 10% chance of dropping the edges
of frame n-4 for that step (enet.py:331-336).

The edge schedule depends only on (n_frames, ppi, steps), so it is built on
the host; the edge drop is a mask. Poses and patches are detached at each
step's start (enet.py:315-316). With `remat=True` each step's chain runs
under torch.utils.checkpoint: the backward keeps each step's boundary
values and recomputes the rest. Every random draw goes through one `Draws`
object, one method a draw; a draw the checkpointed chain needs (the
correlation's keep mask) is made outside it, since a recompute cannot
replay an explicit generator.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from devo_tpu_torch.data import randaug
from devo_tpu_torch.data.normalize import rescale_normalize, std_normalize
from devo_tpu_torch.geom import projective as pops
from devo_tpu_torch.lie import se3
from devo_tpu_torch.ops import ba as ba_ops
from devo_tpu_torch.ops import corr as corr_ops
from devo_tpu_torch.ops.graph import neighbors

DROP_PROB = 0.1      # the chance of dropping frame n-4's edges for a step


class EdgeSchedule(NamedTuple):
    """Static per-step edge table (cumulative, new edges first)."""
    ii: np.ndarray
    jj: np.ndarray
    kk: np.ndarray
    n_active_frames: int     # frames in the graph after this step's growth
    added_frame: int         # frame added at this step (-1 if none)
    new_edges: int           # count of freshly added edges (prefix)


def build_edge_schedule(n_frames: int, ppi: int, steps: int,
                        grow_after: int = 8) -> List[EdgeSchedule]:
    """The reference's graph growth (enet.py:300, 319-339). grow_after:
    the first step that adds a frame (reference: 8); smaller values let a
    short unroll reach the growth and the edge drop."""
    init = min(8, grow_after, n_frames)
    ix = np.repeat(np.arange(n_frames), ppi)
    kk, jj = np.meshgrid(np.where(ix < init)[0], np.arange(init), indexing="ij")
    kk, jj = kk.reshape(-1), jj.reshape(-1)
    ii = ix[kk]

    sched = []
    n = init
    for s in range(steps):
        added, new = -1, 0
        if s >= grow_after and n < n_frames:
            kk1, jj1 = np.meshgrid(np.where(ix < n)[0], [n], indexing="ij")
            kk2, jj2 = np.meshgrid(np.where(ix == n)[0], np.arange(n + 1), indexing="ij")
            kk_new = np.concatenate([kk1.reshape(-1), kk2.reshape(-1)])
            jj_new = np.concatenate([jj1.reshape(-1), jj2.reshape(-1)])
            ii_new = ix[kk_new]
            ii = np.concatenate([ii_new, ii])
            jj = np.concatenate([jj_new, jj])
            kk = np.concatenate([kk_new, kk])
            added, new = n, len(kk_new)
            n += 1
        sched.append(EdgeSchedule(ii.copy(), jj.copy(), kk.copy(), n, added, new))
    return sched


class Draws:
    """Every random draw of one sample's forward, one method a draw, from a
    CPU `torch.Generator`; each result goes to `device`, so that a sample
    draws the same on the card as on the CPU. Tests replace the methods
    with devo_tpu's draws."""

    def __init__(self, generator: torch.Generator, device=None):
        self.generator = generator
        self.device = torch.device(device or "cpu")

    def _to(self, t):
        return t.to(self.device)

    def augment(self):
        """randaug's (augment?, op index, strength bin)."""
        return randaug.draw_augment(self.generator)

    def candidates(self, n: int, k: int, x_high: int, y_high: int):
        """The training selector's 3x-random candidates (x, y), (n, k)."""
        return tuple(self._to(torch.randint(0, hi, (n, k),
                                            generator=self.generator))
                     for hi in (x_high, y_high))

    def coords(self, n: int, ppi: int, h: int, w: int):
        """The random selector's coordinates in [1, w-2] x [1, h-2]."""
        return tuple(self._to(torch.randint(1, hi - 1, (n, ppi),
                                            generator=self.generator))
                     for hi in (w, h))

    def depths(self, m: int) -> torch.Tensor:
        """The patches' random initial inverse depths, (m,) in [0, 1)."""
        return self._to(torch.rand(m, generator=self.generator))

    def drop(self, step: int) -> bool:
        """Whether step `step` drops the edges of frame n-4."""
        return bool(torch.rand((), generator=self.generator) < DROP_PROB)

    def keep(self, step: int, E: int, dropout: float) -> torch.Tensor:
        """The correlation backward's keep mask of step `step`, (E,) bool:
        uniform < dropout, every edge where dropout >= 1."""
        if dropout is None or dropout >= 1.0:
            return torch.ones(E, dtype=torch.bool, device=self.device)
        return self._to(torch.rand(E, generator=self.generator) < dropout)


def normalize_sequence(voxels: torch.Tensor, norm: str) -> torch.Tensor:
    """The training normalization (enet.py:246-259): "std2" / "standard2"
    / "standard" over the whole sequence, "std" frame by frame, "rescale" /
    "norm" over the whole sequence, "none" untouched."""
    if norm == "std":
        return torch.stack([std_normalize(v) for v in voxels])
    if norm in ("std2", "standard2", "standard"):
        return std_normalize(voxels)
    if norm in ("rescale", "norm"):
        return rescale_normalize(voxels)
    if norm == "none":
        return voxels
    raise NotImplementedError(norm)


def _median_init(patches, ppi: int, n: int):
    """The new frame's patches take the lower median depth of the two
    frames before it (enet.py:338; torch.median semantics)."""
    M, _, P, _ = patches.shape
    pf = torch.arange(M, device=patches.device) // ppi
    sel = (pf == n - 1) | (pf == n - 2)
    vals = torch.sort(patches[sel][:, 2].reshape(-1)).values
    med = vals[max((vals.numel() - 1) // 2, 0)]
    patches = patches.clone()
    patches[pf == n, 2] = med
    return patches


def evonet_forward(net, voxels: torch.Tensor, poses_gt: torch.Tensor,
                   disps: torch.Tensor, intrinsics: torch.Tensor,
                   draws: Draws, steps: int = 18, ppi: int = 80,
                   structure_only: bool = False, norm: str = "std2",
                   randaug_on: bool = False, grow_after: int = 8,
                   corr_dropout: float = 0.2,
                   remat: bool = True) -> List[Dict[str, Any]]:
    """One clip through the unrolled network. voxels (n_frames, H, W,
    bins), poses_gt (n_frames, 7) world-to-camera, disps (n_frames, H, W)
    ground-truth disparity, intrinsics (4,) at full resolution, all on one
    device, f32. Returns one dict a step: coords, coords_gt, valid, ii, jj,
    kk, emask, weight, Gs, Ps, scores."""
    n_frames, H, W, _ = voxels.shape
    P = net.P
    dev = voxels.device

    voxels = normalize_sequence(voxels, norm)
    if randaug_on:
        voxels = randaug.maybe_voxel_augment(voxels, norm, draw=draws.augment())

    intr4 = intrinsics / 4.0
    disps4 = disps[:, 1::4, 1::4]

    out = net.run_patchify(voxels, ppi, training=True, disps=disps4,
                           candidates=draws.candidates, coords=draws.coords)
    fmap, gmap, imap = out["fmap"], out["gmap"], out["imap"]
    patches_gt = out["patches"].reshape(-1, 3, P, P)      # (n*ppi, 3, P, P)
    scores = out["scores"]                                # (n, ppi) or None
    M = patches_gt.shape[0]

    # random initial depths (enet.py:294-295)
    d0 = draws.depths(M).to(patches_gt.dtype)
    patches = torch.cat([patches_gt[:, :2],
                         d0[:, None, None, None].expand(M, 1, P, P)], 1)

    gmap_flat = gmap.reshape(-1, P, P, gmap.shape[-1])
    imap_flat = imap.reshape(-1, imap.shape[-1])

    # 2-level correlation pyramid (enet.py:203-216)
    n, h4, w4, C = fmap.shape
    fmap2 = fmap.reshape(n, h4 // 4, 4, w4 // 4, 4, C).mean((2, 4))
    pyramid = (fmap, fmap2)

    intr_all = intr4[None].expand(n_frames, 4)
    sched = build_edge_schedule(n_frames, ppi, steps, grow_after=grow_after)

    Gs = se3.identity((n_frames,), dtype=poses_gt.dtype, device=dev)
    if structure_only:
        Gs = poses_gt
    bounds = torch.tensor([-64.0, -64.0, w4 + 64.0, h4 + 64.0], device=dev)

    traj = []
    dim_inet = imap_flat.shape[-1]
    net_state = torch.zeros((len(sched[0].ii), dim_inet), device=dev)
    emask_np = np.ones((len(sched[0].ii),), bool)

    for s, es in enumerate(sched):
        Gs = Gs.detach()
        patches = patches.detach()

        E = len(es.ii)
        ii = torch.as_tensor(es.ii, device=dev).long()
        jj = torch.as_tensor(es.jj, device=dev).long()
        kk = torch.as_tensor(es.kk, device=dev).long()

        if es.added_frame >= 0:
            nf = es.added_frame
            if not structure_only:
                Gs = Gs.clone()
                Gs[nf] = Gs[nf - 1]
            net_state = torch.cat([torch.zeros((es.new_edges, dim_inet),
                                               device=dev), net_state])
            emask_np = np.concatenate([np.ones(es.new_edges, bool), emask_np])
            # 10%: this step drops the edges touching frame n-4
            touches = (es.ii == nf - 4) | (es.jj == nf - 4)
            step_mask = emask_np & ~(draws.drop(s) & touches)
            patches = _median_init(patches, ppi, nf)
        else:
            step_mask = emask_np
        emask = torch.as_tensor(step_mask, device=dev)

        ixn, jxn = neighbors(kk, jj, emask)
        _, ij_seg = np.unique(es.ii.astype(np.int64) * n_frames + es.jj,
                              return_inverse=True)
        nseg_ij = int(ij_seg.max()) + 1
        ij_seg = torch.as_tensor(ij_seg.reshape(-1), device=dev).long()
        n_act = es.n_active_frames
        keep = draws.keep(s, E, corr_dropout)

        def one_step(Gs, patches, net_state, ii=ii, jj=jj, kk=kk, emask=emask,
                     ixn=ixn, jxn=jxn, ij_seg=ij_seg, nseg_ij=nseg_ij,
                     n_act=n_act, keep=keep):
            coords = pops.transform(Gs, patches, intr_all, ii, jj, kk)
            corr_feat = corr_ops.corr_pyramid_train(
                gmap_flat, pyramid, coords, kk, jj, dropout=corr_dropout,
                radius=3, levels=(1, 4), keep=keep)
            net_state2, delta, weight = net.run_update(
                net_state, imap_flat[kk], corr_feat, ixn, jxn, kk, M, ij_seg,
                nseg_ij, emask)
            target = coords[:, P // 2, P // 2, :] + delta
            weight_m = torch.where(emask[:, None], weight,
                                   torch.zeros_like(weight))
            flat = patches.reshape(M, -1)
            for _ in range(2):
                Gs, flat, _ = ba_ops.gauss_newton_step_diff(
                    Gs, flat, intr_all, target, weight_m, 1e-4, ii, jj, kk,
                    emask, t0=1, t1=n_act, kbase=0, window=n_frames - 1,
                    patch_slots=M, bounds=bounds, max_residual=250.0,
                    ep=10.0, lm=1e-4, structure_only=structure_only)
            return Gs, flat.reshape(M, 3, P, P), net_state2, weight

        if remat:
            Gs, patches, net_state, weight = checkpoint(
                one_step, Gs, patches, net_state, use_reentrant=False)
        else:
            Gs, patches, net_state, weight = one_step(Gs, patches, net_state)

        coords_est = pops.transform(Gs, patches, intr_all, ii, jj, kk)
        coords_gt, valid_gt = pops.transform(poses_gt, patches_gt, intr_all,
                                             ii, jj, kk, valid=True)
        traj.append({
            "coords": coords_est, "coords_gt": coords_gt,
            "valid": valid_gt * emask, "ii": es.ii, "jj": es.jj, "kk": es.kk,
            "emask": emask, "weight": weight, "Gs": Gs[:n_act],
            "Ps": poses_gt[:n_act], "scores": scores,
        })
    return traj
