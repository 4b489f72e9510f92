"""The DEVO inference engine (counterpart of devo_tpu/runtime/engine.py,
after upstream DEVO's devo/devo.py).

One call per frame runs the tracking step: normalize the voxel (and skip an
empty first frame), patchify, apply the motion model and the depth init,
run the motion probe before initialization, append the new frame's edges
to the (kk, jj)-sorted edge table and purge old ones, run the update
operator with two Gauss-Newton BA iterations (twelve updates at
initialization), then keyframe, which may cull a frame.

cfg.PATCH_SELECTOR chooses the patch selection: the learned scorer, the
event-gradient map or uniform random draws (the frame-input drivers',
eval/frames.py, with cfg.EVS=False and 3-channel frames).

Tensors live on `device`; the keyframe count `n`, the frame counter and the
keyframe bookkeeping are host ints, as in the reference. The host reads the
device at a few decision points: the empty-voxel gate while n == 0, the
motion probe before initialization, and the keyframe test once per frame.
The edge table has a dynamic size up to cfg.EDGE_CAP; an append past it
drops the table's tail. A keyframe cull drops its edges at once.
Feature rings hold cfg.MEM frames: per-frame-scaled int8 with one
dequantisation scale per ring slot under cfg.CORR_RING_I8 (the default) and
CORR_IMPL="banded", else the net dtype (bf16 under mixed precision).
cfg.CORR_IMPL, cfg.CORR_KERNEL and cfg.CORR_L4_RESIDENT choose the
correlation (ops/corr_cuda.py), by devo_tpu's rules (`ring_i8`,
`l4_resident`, `_check_corr_knobs`).

The phases carry `torch.profiler.record_function` spans (devo.patchify,
devo.probe, devo.append, devo.update, devo.keyframe) that a profiler run
reads per phase; without a profiler they cost a few microseconds a frame.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from devo_tpu_torch.data.normalize import normalize
from devo_tpu_torch.geom import edgewise
from devo_tpu_torch.lie import se3
from devo_tpu_torch.nets import selector as sel
from devo_tpu_torch.nets.evonet import EVONet
from devo_tpu_torch.ops import ba as ba_ops
from devo_tpu_torch.ops import corr as corr_ops
from devo_tpu_torch.ops import corr_cuda
from devo_tpu_torch.ops.graph import sorted_neighbors
from devo_tpu_torch.utils.params import load_weights

from .config import VOConfig


class StepAux(NamedTuple):
    status: int                  # 0 = skipped, 1 = probe-rejected, 2 = tracked
    kf_removed: bool = False     # a keyframe was culled this step
    kf_t0: int = 0               # counter stamp of the culled frame's predecessor
    kf_t1: int = 0               # counter stamp of the culled frame
    kf_dP: Optional[torch.Tensor] = None   # (7,) P_k * P_{k-1}^-1


def ring_i8(cfg: VOConfig) -> bool:
    """Whether the feature rings are int8 with per-slot scales: under
    CORR_RING_I8 and CORR_IMPL="banded" alone. devo_tpu allocates int8
    rings and scales for its banded family only (engine.py:189-205); every
    other family keeps its rings in the net dtype, whatever CORR_RING_I8
    says."""
    return cfg.CORR_RING_I8 and cfg.CORR_IMPL == "banded"


# names that devo_tpu's corr_level_banded takes as `ablate` to time its
# kernel's stages: they compute no correlation
STAGE_NAMES = corr_ops.STAGES[1:]


def _check_corr_knobs(cfg: VOConfig):
    """Raise on a correlation configuration the engine does not run:
    CORR_KERNEL outside corr_cuda.KERNELS (K10's stage names among them: they
    compute no correlation, and bench.py refuses them too), and "g8" or
    "full" on int8 rings (devo_tpu asserts there, corr_pallas.py:770-773)."""
    kern = cfg.CORR_KERNEL
    if kern in STAGE_NAMES:
        raise ValueError(
            f"CORR_KERNEL={kern!r} names a stage of the 'full' kernel, which "
            f"computes no correlation: ops/corr_cuda.corr_level_full_cuda("
            f"stage={kern!r}) times it")
    if kern not in corr_cuda.KERNELS:
        raise ValueError(f"CORR_KERNEL={kern!r}: one of {corr_cuda.KERNELS}")
    if kern in corr_cuda.FLOAT_ONLY and ring_i8(cfg):
        raise ValueError(f"CORR_KERNEL={kern!r} takes float rings: set "
                         f"CORR_RING_I8=False")


def l4_resident(cfg: VOConfig, ht: int, wd: int) -> bool:
    """Whether level 4 of the correlation is read by the resident-ring
    kernel. It needs CORR_IMPL="banded" (elsewhere it is off without an
    error, as devo_tpu's _l4_resident is), int8 rings, a per-level kernel
    (CORR_KERNEL="split", "split2" or "g8c": a kernel that takes both levels
    in one launch has no level to hand over, and "g8" / "full" take float
    rings) and a level-4 frame that fits a block's shared memory beside the
    kernel's scratch (corr_cuda.resident_fits). "on" raises where it cannot
    hold; "auto" turns it on where it can."""
    mode = cfg.CORR_L4_RESIDENT
    if mode not in ("on", "off", "auto"):
        raise ValueError(f"CORR_L4_RESIDENT={mode!r}: 'on', 'off' or 'auto'")
    if mode == "off" or cfg.CORR_IMPL != "banded":
        return False
    h4, w4 = ht // 16, wd // 16
    for ok, why in (
            (cfg.CORR_KERNEL in corr_cuda.RESIDENT_KERNELS,
             f"needs a per-level kernel (CORR_KERNEL='split', 'split2' or "
             f"'g8c'), not {cfg.CORR_KERNEL!r}"),
            (cfg.CORR_RING_I8, "requires CORR_RING_I8"),
            (corr_cuda.resident_fits(h4, w4, cfg.DIM_FNET, cfg.P),
             f"a {h4}x{w4}x{cfg.DIM_FNET} int8 frame and the kernel's "
             f"scratch exceed the {corr_cuda.SMEM_MAX} bytes of shared "
             f"memory a block can have")):
        if not ok:
            if mode == "on":
                raise ValueError(f"CORR_L4_RESIDENT='on' {why}")
            return False
    return True


def resolve_device(device=None) -> torch.device:
    """Where an entry point runs: `device` if given, else the current CUDA
    device, and there must be one. The CPU is taken only when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "DEVO runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class DEVO:
    """Host-side engine with the reference's interface (devo.py:21-555):
    call per frame, `update()` for extra refinement, then `terminate()` for
    the trajectory."""

    def __init__(self, cfg: VOConfig, weights, ht: int = 480, wd: int = 640,
                 seed: int = 0, device=None):
        """weights: an EVONet state dict or the path of a DEVO checkpoint.
        `seed` seeds the generator of the step's random draws (patch
        sampling, initial depths). `device`: where the engine runs; left
        out, it is the current CUDA device, and there must be one. The CPU
        (the plain correlation, no kernel) is taken only when asked for."""
        device = resolve_device(device)
        if (cfg.HT, cfg.WD) != (ht, wd):
            cfg = cfg.replace(HT=ht, WD=wd)
        _check_corr_knobs(cfg)
        self.cfg = cfg
        self._ht, self._wd = ht, wd
        self.ring_i8 = ring_i8(cfg)
        self.l4_resident = l4_resident(cfg, ht, wd)
        self.device = device
        self.net = EVONet(P=cfg.P, dim_inet=cfg.DIM_INET, dim_fnet=cfg.DIM_FNET,
                          dim=cfg.DIM, bins=cfg.BINS,
                          patch_selector=cfg.PATCH_SELECTOR)
        self.net.load_state_dict(load_weights(weights), strict=True)
        self.net.to(self.device).eval()
        self.generator = torch.Generator(device=self.device)
        self.viewer = None          # the live viewer (start_viewer)
        self._init_state(seed)

    def _init_state(self, seed: int):
        """The tracking state of a new sequence: empty buffers, rings and
        edge table, and the generator at `seed`."""
        cfg, ht, wd = self.cfg, self._ht, self._wd
        self.generator.manual_seed(seed)
        N, M, P, mem = cfg.BUFFER_SIZE, cfg.M, cfg.P, cfg.MEM
        h1, w1 = ht // 4, wd // 4
        dev = self.device
        fdt = torch.bfloat16 if cfg.MIXED_PRECISION else torch.float32
        self.tstamps = [0] * N                      # frame-counter stamps
        self.poses = se3.identity((N,), device=dev)  # (N, 7) world-to-camera
        self.patches = torch.zeros((N * M, 3 * P * P), device=dev)  # [x, y, d]
        self.intrinsics = torch.zeros((N, 4), device=dev)  # feature resolution
        self.colors = torch.zeros((N, M), device=dev)
        self.imap = torch.zeros((mem * M, cfg.DIM_INET), dtype=fdt, device=dev)
        self.gmap = torch.zeros((mem * M, P, P, cfg.DIM_FNET), dtype=fdt,
                                device=dev)
        rdt = torch.int8 if self.ring_i8 else fdt
        self.fmap1 = torch.zeros((mem, h1, w1, cfg.DIM_FNET), dtype=rdt,
                                 device=dev)
        self.fmap2 = torch.zeros((mem, h1 // 4, w1 // 4, cfg.DIM_FNET),
                                 dtype=rdt, device=dev)
        # dequantisation scale of each ring slot (int8 rings only)
        self.fsc1 = torch.ones((mem,), device=dev) if self.ring_i8 else None
        self.fsc2 = torch.ones((mem,), device=dev) if self.ring_i8 else None
        # the edge table, packed and sorted by (kk, jj)
        self.ii = torch.zeros(0, dtype=torch.long, device=dev)
        self.jj = torch.zeros(0, dtype=torch.long, device=dev)
        self.kk = torch.zeros(0, dtype=torch.long, device=dev)
        self.enet = torch.zeros(
            (0, cfg.DIM_INET),
            dtype=torch.bfloat16 if cfg.ENET_BF16 else torch.float32, device=dev)
        self.n = 0                  # keyframes
        self.counter = 0            # frames tracked
        self.update_edges = 0       # edges the last update ran on (a cull
                                    #   shrinks the table after it)
        self.initialized = False
        self.aux_log: List[Tuple[float, StepAux]] = []

    def reset(self, seed: int = 0, weights=None):
        """Start a new sequence or trial on this engine (counterpart of
        devo_tpu's DEVO.reset): the tracking state, the rings, the edge
        table, `aux_log` and the generator go back to what the constructor
        makes for `seed`, the network stays on the device, and `weights` (a
        state dict or a checkpoint path), when given, are loaded into it. A
        reset engine tracks as a fresh one with the same seed does.

        devo_tpu's upload / upload_batch / VOXEL_WIRE / _rebucket /
        wait_buckets have no counterpart here: they batch transfers through
        a tunnel and manage compiled shapes, and this engine runs eagerly
        and takes each frame by a plain host-to-device copy."""
        if weights is not None:
            self.net.load_state_dict(load_weights(weights), strict=True)
        # release the rings before their replacements are allocated
        self.fmap1 = self.fmap2 = self.gmap = self.imap = None
        self._init_state(seed)

    # ------------------------------------------------------------ helpers

    def _amp(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.cfg.MIXED_PRECISION)

    def _draw_depth(self) -> torch.Tensor:
        """Initial inverse depths of a new frame's patches before
        initialization (devo.py:514-520): (M, 1) uniform draws."""
        return torch.rand((self.cfg.M, 1), generator=self.generator,
                          device=self.device)

    def _draw_coords(self):
        """The random selector's patch centres of a new frame (enet.py:
        144-147): x, y each (1, M), uniform in [1, w-2] x [1, h-2] at
        feature resolution."""
        return sel.select_random(1, self._ht // 4, self._wd // 4, self.cfg.M,
                                 self.generator, self.device)

    @property
    def n_edges(self) -> int:
        return self.kk.shape[0]

    # --------------------------------------------------------- edge table

    @record_function("devo.append")
    def _append_edges(self, drop: torch.Tensor):
        """Drop the rows `drop` marks, then add the new frame's edges
        (devo.py:361-380): forward edges from the live patches of frames
        [n-r, n-1) to frame n-1 merge into the table in (kk, jj) order, and
        the new frame's patches x frames [n-r, n) go to the tail. Called
        after n was incremented; the new frame is n-1."""
        cfg, dev = self.cfg, self.device
        M, r, n = cfg.M, cfg.PATCH_LIFETIME, self.n
        keep = ~drop
        fstart = max(n - r, 0)
        fk = torch.arange(M * fstart, M * (n - 1), device=dev)
        kk = torch.cat([self.kk[keep], fk])
        jj = torch.cat([self.jj[keep], torch.full_like(fk, n - 1)])
        ii = torch.cat([self.ii[keep], fk // M])
        net = torch.cat([self.enet[keep],
                         self.enet.new_zeros((fk.shape[0], cfg.DIM_INET))])
        order = torch.sort(kk * cfg.BUFFER_SIZE + jj, stable=True).indices

        s = n - fstart
        kk_b = M * (n - 1) + torch.arange(M, device=dev).repeat_interleave(s)
        jj_b = torch.arange(fstart, n, device=dev).repeat(M)
        E = cfg.EDGE_CAP         # an overflowing append drops the tail
        self.kk = torch.cat([kk[order], kk_b])[:E]
        self.jj = torch.cat([jj[order], jj_b])[:E]
        self.ii = torch.cat([ii[order], torch.full_like(kk_b, n - 1)])[:E]
        self.enet = torch.cat([net[order], net.new_zeros((kk_b.shape[0],
                                                          cfg.DIM_INET))])[:E]

    # ------------------------------------------------------------- update

    def _edge_features(self, ii, jj, kk):
        """Reproject + two-level correlation + context for a set of edges
        (devo.py:210-223, 308-314)."""
        cfg = self.cfg
        M, mem = cfg.M, cfg.MEM
        geo = edgewise.reproject(self.poses, self.patches, self.intrinsics,
                                 ii, jj, kk)
        coords = edgewise.coords_to_corr_format(geo, cfg.P)
        kk_ring = kk % (M * mem)
        corr = corr_cuda.corr_pyramid(
            self.gmap, (self.fmap1, self.fmap2), coords,
            kk_ring.to(torch.int32), (jj % mem).to(torch.int32),
            radius=cfg.CORR_RADIUS, levels=cfg.CORR_LEVELS,
            scales=(self.fsc1, self.fsc2) if self.ring_i8 else None,
            kernel=cfg.CORR_KERNEL, resident=self.l4_resident,
            impl=cfg.CORR_IMPL)
        return geo, corr, self.imap[kk_ring].float()

    @record_function("devo.update")
    def _update_once(self):
        """One tracking update: reproject -> corr -> recurrent update -> 2
        Gauss-Newton iterations of BA (devo.py:308-344)."""
        cfg = self.cfg
        self.update_edges = self.n_edges
        if self.n_edges == 0:
            return
        geo, corr, ctx = self._edge_features(self.ii, self.jj, self.kk)
        mask = torch.ones_like(self.kk, dtype=torch.bool)
        ix, jx = sorted_neighbors(self.kk, mask)
        span = cfg.frame_span
        tmin = max(self.n - span, 0)
        kbase = tmin * cfg.M
        kk_seg = (self.kk - kbase).clamp(0, cfg.patch_slots - 1)
        ij_seg = ((self.ii - tmin).clamp(0, span - 1) * span
                  + (self.jj - tmin).clamp(0, span - 1))
        with self._amp():
            enet, delta, weight = self.net.run_update(
                self.enet, ctx, corr, ix, jx, kk_seg, cfg.patch_slots,
                ij_seg, span ** 2, mask)
        target = torch.stack([geo.center_x, geo.center_y], -1) + delta

        t0 = max(self.n - cfg.OPTIMIZATION_WINDOW, 1) if self.initialized else 1
        intr = self.intrinsics[max(self.n - 1, 0)]
        bounds = torch.cat([intr.new_full((2,), -64.0), 2 * intr[2:4] + 64])
        ba_ops.run_ba(self.poses, self.patches, self.intrinsics, target,
                      weight, 1e-4, self.ii, self.jj, self.kk, mask,
                      t0=t0, t1=self.n, kbase=kbase, window=cfg.ba_window,
                      patch_slots=cfg.patch_slots, bounds=bounds,
                      iterations=2, structure_only=False, max_residual=128.0,
                      ep=1.0, lm=1e-4)
        self.enet = enet.to(self.enet.dtype)

    @record_function("devo.probe")
    def _motion_probe(self) -> float:
        """Throwaway update of the last frame's patches against the new
        frame (devo.py:241-256); returns the median predicted flow norm."""
        cfg, dev = self.cfg, self.device
        M = cfg.M
        kk = (self.n - 1) * M + torch.arange(M, device=dev)
        jj = torch.full_like(kk, self.n)
        ii = torch.full_like(kk, self.n - 1)
        _, corr, ctx = self._edge_features(ii, jj, kk)
        none = torch.full_like(kk, -1)
        with self._amp():
            _, delta, _ = self.net.run_update(
                torch.zeros((M, cfg.DIM_INET), device=dev), ctx, corr, none,
                none, torch.arange(M, device=dev), M, torch.zeros_like(kk), 1,
                torch.ones_like(kk, dtype=torch.bool))
        return float(torch.quantile(delta.norm(dim=-1), 0.5))

    # ----------------------------------------------------------- keyframe

    @record_function("devo.keyframe")
    def _keyframe(self) -> StepAux:
        """Keyframing (devo.py:267-306): if the mean flow between frames
        n-KI-1 and n-KI+1 is small, cull frame n-KI."""
        cfg = self.cfg
        KI, n = cfg.KEYFRAME_INDEX, self.n
        i, j, k = n - KI - 1, n - KI + 1, n - KI
        if i < 0:
            return StepAux(2)
        fm = edgewise.flow_mag_edges(self.poses, self.patches, self.intrinsics,
                                     self.ii, self.jj, self.kk, beta=0.5)

        def masked_mean(a, b):
            sel = (self.ii == a) & (self.jj == b)
            cnt = sel.sum()
            return (fm * sel).sum() / cnt.clamp_min(1), cnt > 0

        # an empty direction (the reference's mean is NaN) suppresses the cull
        m_ij, ok_ij = masked_mean(i, j)
        m_ji, ok_ji = masked_mean(j, i)
        remove = bool(((m_ij + m_ji) / 2.0 < cfg.KEYFRAME_THRESH) & ok_ij & ok_ji)
        if not remove:
            return StepAux(2)
        aux = StepAux(2, True, self.tstamps[k - 1], self.tstamps[k],
                      se3.mul(self.poses[k], se3.inv(self.poses[k - 1])))
        self._remove_keyframe(k)
        return aux

    def _remove_keyframe(self, k: int):
        """Cull keyframe k (devo.py:279-303): drop its edges, shift the
        later frames' indices and buffers down one slot. The index shifts
        keep the table sorted."""
        cfg = self.cfg
        M, mem = cfg.M, cfg.MEM
        keep = ~((self.ii == k) | (self.jj == k))
        self.ii = torch.where(self.ii > k, self.ii - 1, self.ii)[keep]
        self.jj = torch.where(self.jj > k, self.jj - 1, self.jj)[keep]
        self.kk = torch.where(self.kk // M > k, self.kk - M, self.kk)[keep]
        self.enet = self.enet[keep]

        # frames k+1 .. n-1 move down one slot
        L = self.n - 1 - k
        self.tstamps[k:k + L] = self.tstamps[k + 1:k + L + 1]
        for buf in (self.poses, self.intrinsics, self.colors):
            buf[k:k + L] = buf[k + 1:k + L + 1].clone()
        self.patches[k * M:(k + L) * M] = \
            self.patches[(k + 1) * M:(k + L + 1) * M].clone()
        for j in range(L):
            dst, src = (k + j) % mem, (k + j + 1) % mem
            self.imap[dst * M:(dst + 1) * M] = self.imap[src * M:(src + 1) * M]
            self.gmap[dst * M:(dst + 1) * M] = self.gmap[src * M:(src + 1) * M]
            self.fmap1[dst] = self.fmap1[src]
            self.fmap2[dst] = self.fmap2[src]
            if self.ring_i8:         # a slot's scale moves with its frame
                self.fsc1[dst] = self.fsc1[src]
                self.fsc2[dst] = self.fsc2[src]
        self.n -= 1

    # --------------------------------------------------------------- step

    @record_function("devo.patchify")
    def _write_frame(self, voxel: torch.Tensor, intrinsics: torch.Tensor):
        """Patchify the new frame and fill the buffers at slot n
        (devo.py:475-527)."""
        cfg = self.cfg
        M, P, mem, n = cfg.M, cfg.P, cfg.MEM, self.n
        PP = P * P
        coords = (self._draw_coords() if cfg.PATCH_SELECTOR == "random"
                  else None)
        with self._amp():
            out = self.net.run_patchify(
                voxel[None], M, generator=self.generator,
                scorer_eval_mode=cfg.SCORER_EVAL_MODE,
                scorer_eval_use_grid=cfg.SCORER_EVAL_USE_GRID, coords=coords)
        patches = out["patches"][0].reshape(M, 3 * PP)

        # motion model (devo.py:502-512)
        if n > 1:
            P1, P2 = self.poses[n - 1], self.poses[n - 2]
            xi = cfg.MOTION_DAMPING * se3.log(se3.mul(P1, se3.inv(P2)))
            new_pose = se3.mul(se3.exp(xi), P1)
        else:
            new_pose = self.poses[max(n - 1, 0)].clone()

        # depth init (devo.py:514-520): the median depth of the last three
        # frames once initialized (quantile 0.5 averages the middle pair,
        # as the reference's median over an even count does), else random
        if self.initialized:
            lo = max(n - 3, 0) * M
            depth = torch.quantile(self.patches[lo:lo + 3 * M, 2 * PP:], 0.5)
        else:
            depth = self._draw_depth()
        patches[:, 2 * PP:] = depth

        fmap = out["fmap"][0]                       # (h1, w1, Df) f32
        h1, w1 = fmap.shape[:2]
        slot = n % mem
        self.tstamps[n] = self.counter
        self.poses[n] = new_pose
        self.patches[n * M:(n + 1) * M] = patches
        self.intrinsics[n] = intrinsics / 4.0
        self.colors[n] = out["clr"][0]
        self.imap[slot * M:(slot + 1) * M] = out["imap"][0]
        self.gmap[slot * M:(slot + 1) * M] = out["gmap"][0]
        # level 4 of the pyramid: the reference's avg_pool2d(fmap, 4, 4),
        # which drops trailing rows and columns (a 65 x 86 map at 260 x 344)
        h2, w2 = h1 // 4, w1 // 4
        fmap2 = fmap[:4 * h2, :4 * w2].reshape(h2, 4, w2, 4, -1).mean((1, 3))
        if self.ring_i8:             # each level with its own scale
            self.fmap1[slot], self.fsc1[slot] = corr_ops.quantize_frame(fmap)
            self.fmap2[slot], self.fsc2[slot] = corr_ops.quantize_frame(fmap2)
        else:
            self.fmap1[slot] = fmap
            self.fmap2[slot] = fmap2
        self.counter += 1

    def _step(self, voxel: torch.Tensor, intrinsics: torch.Tensor) -> StepAux:
        cfg = self.cfg
        if cfg.EVS:
            # normalization + empty-voxel gate (devo.py:406-457)
            skip = (self.n == 0
                    and float((voxel != 0).float().mean()) < 2e-2)
            voxel = normalize(voxel, cfg.NORM)
        else:
            # frame input (devo.py:395): scale to [-0.5, 1.5]
            skip = False
            voxel = 2.0 * (voxel / 255.0) - 0.5
        if skip:
            return StepAux(0)

        self._write_frame(voxel, intrinsics)
        if self.n > 0 and not self.initialized:
            # a NaN probe rejects the frame, as the comparison is false
            if not self._motion_probe() >= cfg.MOTION_PROBE_THRESH:
                return StepAux(1)

        self.n += 1
        # purge edges of patches older than the removal window (devo.py:
        # 305-306, with the pre-increment n) and, deliberately, edges whose
        # target frame left the live ring window: their ring slot is
        # overwritten once jj < n - MEM (the JAX engine's deviation from the
        # reference, kept for parity; +1 margin for the next update)
        purge = (((self.kk // cfg.M) < self.n - 1 - cfg.REMOVAL_WINDOW)
                 | (self.jj < self.n - (cfg.MEM - 6) + 1))
        self._append_edges(purge)

        aux = StepAux(2)
        if self.n == 8 and not self.initialized:
            self.initialized = True
            for _ in range(12):
                self._update_once()
        elif self.initialized:
            self._update_once()
            aux = self._keyframe()
        return aux

    # ------------------------------------------------------------ host API

    def start_viewer(self, out_dir: str = "viewer_out", period: float = 2.0):
        """Attach the live viewer (devo.py:139-149, runtime/viewer.py): a
        render thread writes PNG frames of the trajectory and the point
        cloud to `out_dir`, from snapshots taken at the end of a frame at
        most once per `period` seconds. `terminate` joins it."""
        from devo_tpu_torch.runtime.viewer import Viewer
        self.viewer = Viewer(self, out_dir=out_dir, period=period)
        return self.viewer

    @torch.no_grad()
    def __call__(self, tstamp, voxel, intrinsics):
        """voxel: (H, W, bins) array or tensor; intrinsics: (4,)."""
        if self.viewer is not None and isinstance(voxel, np.ndarray):
            self.viewer.update_image(voxel)   # a host reference (devo.py:388)
        if voxel.shape[-2] == 346:  # MVSEC/FPV width hack (devo.py:466-467)
            voxel = voxel[:, 1:-1, :]
        voxel = torch.as_tensor(voxel, dtype=torch.float32).to(self.device)
        intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32).to(self.device)
        self.aux_log.append((tstamp, self._step(voxel, intrinsics)))
        if self.viewer is not None:
            self.viewer.snapshot()

    @torch.no_grad()
    def update(self):
        """Extra refinement update (the eval harness's 12 final iterations,
        eval_utils.py:127-130)."""
        self._update_once()

    @torch.no_grad()
    def terminate(self):
        """Reconstruct the full-rate trajectory (devo.py:186-208): chain the
        stored relative deltas onto the keyframe poses, invert to c2w.
        Returns (poses (counter, 7) f32, timestamps f64) as numpy arrays.
        An attached viewer renders the final state and is joined first
        (devo.py:205-206)."""
        if self.viewer is not None:
            self.viewer.join()
            self.viewer = None
        n, counter = self.n, self.counter
        tlist = [t for t, aux in self.aux_log if aux.status != 0]
        if not self.initialized:
            noise = torch.randn((counter, 3), generator=self.generator,
                                device=self.device).cpu()
            poses = se3.identity((counter,))
            poses[:, :3] += noise * 0.01
            return poses.numpy(), np.asarray(tlist, np.float64)

        poses_kf = self.poses[:n].cpu()
        traj = {t: poses_kf[i] for i, t in enumerate(self.tstamps[:n])}
        delta = {}
        cnt = 0
        for _, aux in self.aux_log:
            if aux.status == 0:
                continue
            cnt += 1
            if aux.status == 1:  # probe-rejected: identity to previous
                delta[cnt - 1] = (cnt - 2, se3.identity())
            if aux.kf_removed:
                delta[aux.kf_t1] = (aux.kf_t0, aux.kf_dP.cpu())

        def get_pose(t):
            # iterative delta-chain walk (devo.py:179-184 recurses)
            chain = []
            while t not in traj:
                chain.append(t)
                t = delta[t][0]
            base = traj[t]
            for tt in reversed(chain):
                base = se3.mul(delta[tt][1], base)
                traj[tt] = base
            return base

        poses = torch.stack([get_pose(t) for t in range(counter)])
        return se3.inv(poses).numpy(), np.asarray(tlist, np.float64)

    @torch.no_grad()
    def point_cloud(self) -> np.ndarray:
        """World-frame patch centers (devo.py:342-344), (n*M, 3)."""
        return self.point_cloud_tensor().cpu().numpy()

    @torch.no_grad()
    def point_cloud_tensor(self) -> torch.Tensor:
        """`point_cloud` on the engine's device, (n*M, 3)."""
        M, P = self.cfg.M, self.cfg.P
        PP = P * P
        n = self.n
        ix = torch.arange(n * M, device=self.device) // M
        pk = self.patches[:n * M]
        intr = self.intrinsics[ix]
        c = PP // 2
        X = torch.stack([(pk[:, c] - intr[:, 2]) / intr[:, 0],
                         (pk[:, PP + c] - intr[:, 3]) / intr[:, 1],
                         torch.ones_like(intr[:, 0]), pk[:, 2 * PP + c]], -1)
        pts = se3.act4(se3.inv(self.poses[ix]), X)
        return pts[:, :3] / pts[:, 3:].clamp_min(1e-8)
