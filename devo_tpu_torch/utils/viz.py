"""Visualization utilities.

The port's own copy of devo_tpu/utils/viz.py, the counterpart of upstream
DEVO's utils/viz_utils.py and devo/plot_utils.py: voxel rendering to RGB,
score-map overlays, patch/flow drawing, and trajectory plots + TUM export.
Matplotlib-only; the live view of a running engine is
runtime/viewer.py, and the point cloud is exposed via DEVO.point_cloud()
for external viewers.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def render_voxel(voxel: np.ndarray, eps: float = 1e-3) -> np.ndarray:
    """(bins, H, W) voxel -> (H, W, 3) uint8: positive red, negative blue
    (viz_utils.py voxel rendering convention)."""
    img = voxel.sum(0)
    out = np.full(img.shape + (3,), 255, np.uint8)
    out[img > eps] = (255, 0, 0)
    out[img < -eps] = (0, 0, 255)
    return out


def render_scorer_map(scores: np.ndarray) -> np.ndarray:
    """(h, w) score map -> (h, w, 3) heat image."""
    s = (scores - scores.min()) / max(float(scores.max() - scores.min()), 1e-9)
    out = np.zeros(s.shape + (3,), np.uint8)
    out[..., 0] = (255 * s).astype(np.uint8)
    out[..., 2] = (255 * (1 - s)).astype(np.uint8)
    return out


def draw_patches(img: np.ndarray, coords: np.ndarray, color=(0, 255, 0)) -> np.ndarray:
    """Draw patch centers (M, 2) on an (H, W, 3) image."""
    out = img.copy()
    H, W = out.shape[:2]
    for x, y in np.asarray(coords).reshape(-1, 2):
        xi, yi = int(round(x)), int(round(y))
        if 0 <= yi < H and 0 <= xi < W:
            out[max(yi - 1, 0):yi + 2, max(xi - 1, 0):xi + 2] = color
    return out


def plot_trajectory(path: str, poses_est: np.ndarray,
                    poses_gt: Optional[np.ndarray] = None, title: str = ""):
    """Top-down + side trajectory plot (plot_utils.py:25-91)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for ax, (a, b), lbl in zip(axes, [(0, 1), (0, 2)], ["xy", "xz"]):
        ax.plot(poses_est[:, a], poses_est[:, b], "b-", lw=0.8, label="est")
        if poses_gt is not None:
            ax.plot(poses_gt[:, a], poses_gt[:, b], "k--", lw=0.8, label="gt")
        ax.set_xlabel(lbl[0]); ax.set_ylabel(lbl[1]); ax.axis("equal")
        ax.legend()
    fig.suptitle(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def save_flow_visualization(outdir: str, flow_data: Dict, scale: float = 4.0):
    """Per-frame patch-flow overlays (viz_utils.py:698-774 spirit): draw the
    reprojections TARGETING this frame (jj == frame), scaled from feature
    (1/4) to image resolution like viz_flow_inference."""
    import os
    os.makedirs(outdir, exist_ok=True)
    for t, rec in flow_data.items():
        img = rec.get("img")
        if img is None:
            continue
        img = np.asarray(img)
        if img.ndim == 3 and img.shape[0] <= 8:   # raw (bins, H, W) voxel
            img = render_voxel(img)
        c = np.asarray(rec["coords_est"])
        ctr = (c[..., c.shape[-3] // 2, c.shape[-2] // 2, :]
               if c.ndim >= 4 else c)             # patch center, any P
        jj = np.asarray(rec.get("jj", []))
        if jj.size == ctr.shape[0]:
            ctr = ctr[jj == int(t)]               # only edges into frame t
        out = draw_patches(img, ctr.reshape(-1, 2) * scale)
        _imwrite(os.path.join(outdir, f"{int(t):06d}.png"), out)


def render_events(x: np.ndarray, y: np.ndarray, pol: np.ndarray,
                  H: int, W: int) -> np.ndarray:
    """Raw event frame: last polarity per pixel, red = neg / blue = pos on
    white (viz_utils.py:12-26)."""
    img = np.full((H, W, 3), 255, np.uint8)
    mask = np.zeros((H, W), np.int32)
    p = np.asarray(pol).astype(int)
    p[p == 0] = -1
    ok = (x >= 0) & (y >= 0) & (x < W) & (y < H)
    mask[np.asarray(y)[ok].astype(np.int32),
         np.asarray(x)[ok].astype(np.int32)] = p[ok]
    img[mask == -1] = (255, 0, 0)
    img[mask == 1] = (0, 0, 255)
    return img


def save_voxels(voxels, outdir: str, eps: float = 1e-3, prefix: str = "vox"):
    """Render voxels to PNG files (viz_utils.py:666-728 visualize_voxel /
    visualize_N_voxels, headless form): one image per VOXEL (bins summed),
    for (bins, H, W) single input or (N, bins, H, W) batches."""
    import os

    os.makedirs(outdir, exist_ok=True)
    vox = np.asarray(voxels)
    if vox.ndim == 2:                              # single-bin (H, W)
        vox = vox[None]
    batch = vox[None] if vox.ndim == 3 else vox    # -> (N, bins, H, W)
    paths = []
    for i, v in enumerate(batch):
        p = os.path.join(outdir, f"{prefix}_{i:04d}.png")
        _imwrite(p, render_voxel(v, eps=eps))
        paths.append(p)
    return paths


def render_depth_map(depth: np.ndarray) -> np.ndarray:
    """Inverse-depth heat map (viz_utils.py:730-739)."""
    d = np.asarray(depth, np.float32)
    d = (d - d.min()) / max(float(d.max() - d.min()), 1e-9)
    out = np.zeros(d.shape + (3,), np.uint8)
    out[..., 0] = (255 * d).astype(np.uint8)
    out[..., 1] = (255 * (1.0 - np.abs(d - 0.5) * 2)).astype(np.uint8)
    out[..., 2] = (255 * (1 - d)).astype(np.uint8)
    return out


def _imwrite(path: str, img_rgb: np.ndarray):
    try:
        import cv2
        cv2.imwrite(path, np.asarray(img_rgb)[..., ::-1])
    except Exception:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.imsave(path, np.asarray(img_rgb))


def draw_flow_lines(img: np.ndarray, coords_src: np.ndarray,
                    coords_dst: np.ndarray, color=(0, 200, 0)) -> np.ndarray:
    """Line from each patch center to its reprojected target
    (viz_utils.py:212-327 viz_flow_inference core)."""
    out = np.ascontiguousarray(img.copy())
    try:
        import cv2
        for (x0, y0), (x1, y1) in zip(
                np.asarray(coords_src).reshape(-1, 2),
                np.asarray(coords_dst).reshape(-1, 2)):
            cv2.line(out, (int(round(x0)), int(round(y0))),
                     (int(round(x1)), int(round(y1))), color, 1)
            cv2.circle(out, (int(round(x1)), int(round(y1))), 2, color, -1)
    except Exception:
        out = draw_patches(out, coords_dst, color)
    return out


def plot_patch_following(images, patch_data, outdir: str,
                         num_frame_pairs: int = 3, seed: int = 0):
    """Track selected patches across random frame pairs and save overlay
    pairs (viz_utils.py:52-144): left = host frame with the patch source,
    right = target frame with the reprojected location."""
    import os

    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = len(images)
    for k in range(num_frame_pairs):
        i = int(rng.integers(0, max(n - 1, 1)))
        j = min(i + 1 + int(rng.integers(0, 3)), n - 1)
        rec = patch_data.get(j)
        if rec is None:
            continue
        ii = np.asarray(rec["ii"])
        jj = np.asarray(rec["jj"])
        coords = np.asarray(rec["coords_est"])
        sel = (ii == i) & (jj == j)
        if not sel.any():
            continue
        ctr = coords[sel][..., coords.shape[-3] // 2,
                          coords.shape[-2] // 2, :] \
            if coords.ndim >= 4 else coords[sel]
        host = np.asarray(images[i])
        targ = np.asarray(images[j])
        if host.ndim == 3 and host.shape[0] <= 8:   # (bins, H, W) voxel
            host, targ = render_voxel(host), render_voxel(targ)
        _imwrite(os.path.join(outdir, f"pair{k}_host{i}.png"), host)
        _imwrite(os.path.join(outdir, f"pair{k}_target{j}.png"),
                 draw_patches(targ, ctr.reshape(-1, 2) * 4.0))


def viz_flow_inference(outdir: str, flow_data, line_scale: float = 4.0):
    """Per-frame flow overlays: for each tracked frame, draw lines from the
    previous frame's patch centers to their reprojection in the current
    frame (viz_utils.py:212-327, compact headless form). `flow_data` is
    {fidx: {"ii", "jj", "coords_est", "img"}} as recorded by the engine."""
    import os

    viz_dir = os.path.join(outdir, "flow_viz")
    os.makedirs(viz_dir, exist_ok=True)
    for fidx, rec in flow_data.items():
        img = rec.get("img")
        if img is None:
            continue
        img = np.asarray(img)
        if img.ndim == 3 and img.shape[0] <= 8:
            img = render_voxel(img)
        ii = np.asarray(rec["ii"])
        jj = np.asarray(rec["jj"])
        coords = np.asarray(rec["coords_est"])
        jmax = jj.max() if len(jj) else 0
        sel = (jj == jmax) & (ii == jmax - 1)
        if not sel.any():
            continue
        c = coords[sel]
        ctr = c[..., c.shape[-3] // 2, c.shape[-2] // 2, :] if c.ndim >= 4 else c
        src = rec.get("coords_src")
        dst = ctr.reshape(-1, 2) * line_scale
        out = (draw_flow_lines(img, np.asarray(src).reshape(-1, 2) * line_scale,
                               dst) if src is not None
               else draw_patches(img, dst))
        _imwrite(os.path.join(viz_dir, f"{int(fidx):06d}.png"), out)


def visualize_pose(*poses, plot_axes: str = "xy", path: Optional[str] = None):
    """Overlay translation tracks of several pose sets on one plot
    (viz_utils.py:741-754). Each argument is (N, 7) [t, q] or (N, 3)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ax_ix = {"x": 0, "y": 1, "z": 2}
    a, b = ax_ix[plot_axes[0]], ax_ix[plot_axes[1]]
    fig, ax = plt.subplots(figsize=(6, 6))
    for i, p in enumerate(poses):
        p = np.asarray(p)
        ax.plot(p[:, a], p[:, b], lw=0.9, label=f"traj {i}")
        ax.scatter(p[0, a], p[0, b], marker="o", s=12)
    ax.set_xlabel(plot_axes[0]); ax.set_ylabel(plot_axes[1])
    ax.axis("equal"); ax.legend()
    if path is not None:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_flow_train(voxels, traj_step: Dict, outdir: str,
                    fidx_center: Optional[int] = None, B: int = 2,
                    scale: float = 4.0):
    """Training-time flow diagnostic (viz_utils.py:462-577
    plot_flow_tartan_train, compact headless form): around a center frame,
    one panel per neighbor within +-B frames showing the estimated (green)
    vs ground-truth (orange) reprojections of the center frame's patches.
    `traj_step` is one evonet_forward record ({coords, coords_gt, ii, jj,
    emask}); `voxels` is the (N, H, W, bins) or (N, bins, H, W) input."""
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(outdir, exist_ok=True)
    ii = np.asarray(traj_step["ii"])
    jj = np.asarray(traj_step["jj"])
    em = np.asarray(traj_step["emask"]).astype(bool)
    ce = np.asarray(traj_step["coords"])
    cg = np.asarray(traj_step["coords_gt"])
    vox = np.asarray(voxels)
    if vox.ndim == 4 and vox.shape[-1] <= 8:       # (N, H, W, bins)
        vox = vox.transpose(0, 3, 1, 2)
    n = vox.shape[0]
    if fidx_center is None:
        fidx_center = n // 2
    nb = [j for j in range(max(0, fidx_center - B),
                           min(n, fidx_center + B + 1)) if j != fidx_center]
    fig, axes = plt.subplots(1, max(len(nb), 1),
                             figsize=(4 * max(len(nb), 1), 4),
                             squeeze=False)
    paths = []
    for ax, j in zip(axes[0], nb):
        ax.imshow(render_voxel(vox[j]))
        sel = (ii == fidx_center) & (jj == j) & em
        if sel.any():
            c = ce[sel]
            ctr = (c[..., c.shape[-3] // 2, c.shape[-2] // 2, :]
                   if c.ndim >= 3 else c).reshape(-1, 2) * scale
            g = cg[sel]
            gtr = (g[..., g.shape[-3] // 2, g.shape[-2] // 2, :]
                   if g.ndim >= 3 else g).reshape(-1, 2) * scale
            ax.scatter(ctr[:, 0], ctr[:, 1], s=6, c="lime", label="est")
            ax.scatter(gtr[:, 0], gtr[:, 1], s=6, c="orange", marker="x",
                       label="gt")
            ax.plot(np.stack([ctr[:, 0], gtr[:, 0]]),
                    np.stack([ctr[:, 1], gtr[:, 1]]), c="yellow", lw=0.5)
        ax.set_title(f"{fidx_center}->{j}")
        ax.axis("off")
    p = os.path.join(outdir, f"flow_train_{fidx_center:04d}.png")
    fig.savefig(p, dpi=100, bbox_inches="tight")
    plt.close(fig)
    paths.append(p)
    return paths


def plot_patch_following_all(images, patch_data, outdir: str,
                             num_frame_pairs: int = 3, seed: int = 0):
    """All-patches variant (viz_utils.py:146-210): same sampling as
    plot_patch_following but overlays every live patch of the host frame on
    BOTH frames of the pair in one side-by-side figure."""
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = len(images)
    paths = []
    for k in range(num_frame_pairs):
        i = int(rng.integers(0, max(n - 1, 1)))
        j = min(i + 1 + int(rng.integers(0, 3)), n - 1)
        rec = patch_data.get(j)
        if rec is None:
            continue
        ii = np.asarray(rec["ii"])
        jj = np.asarray(rec["jj"])
        coords = np.asarray(rec["coords_est"])
        sel_h = (ii == i) & (jj == i)
        sel_t = (ii == i) & (jj == j)
        host = np.asarray(images[i])
        targ = np.asarray(images[j])
        if host.ndim == 3 and host.shape[0] <= 8:
            host, targ = render_voxel(host), render_voxel(targ)
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        for ax, img, sel, ttl in [(axes[0], host, sel_h, f"host {i}"),
                                  (axes[1], targ, sel_t, f"target {j}")]:
            ax.imshow(img)
            if sel.any():
                c = coords[sel]
                ctr = (c[..., c.shape[-3] // 2, c.shape[-2] // 2, :]
                       if c.ndim >= 4 else c).reshape(-1, 2) * 4.0
                ax.scatter(ctr[:, 0], ctr[:, 1], s=8, c="lime")
            ax.set_title(ttl)
            ax.axis("off")
        p = os.path.join(outdir, f"pair_all_{k}.png")
        fig.savefig(p, dpi=100, bbox_inches="tight")
        plt.close(fig)
        paths.append(p)
    return paths


def plot_patch_depths(images, patches, outdir: str, P: int = 3):
    """Overlay per-patch inverse depth as colored markers
    (viz_utils.py:579-648, compact form): one PNG per frame."""
    import os

    os.makedirs(outdir, exist_ok=True)
    pa = np.asarray(patches)
    for i, img in enumerate(images):
        img = np.asarray(img)
        if img.ndim == 3 and img.shape[0] <= 8:
            img = render_voxel(img)
        if i >= len(pa):
            break
        xy = pa[i, :, :2, P // 2, P // 2] * 4.0       # (M, 2)
        d = pa[i, :, 2, P // 2, P // 2]
        dn = (d - d.min()) / max(float(d.max() - d.min()), 1e-9)
        out = img.copy()
        H, W = out.shape[:2]
        for (x, y), z in zip(xy, dn):
            xi, yi = int(round(x)), int(round(y))
            if 0 <= yi < H and 0 <= xi < W:
                out[max(yi - 2, 0):yi + 3, max(xi - 2, 0):xi + 3] = (
                    int(255 * z), 64, int(255 * (1 - z)))
        _imwrite(os.path.join(outdir, f"depth_{i:06d}.png"), out)
