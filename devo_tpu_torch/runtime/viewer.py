"""Live tracking viewer (counterpart of devo_tpu/runtime/viewer.py, the
dpviewer hook of upstream DEVO's devo.py:139-149, :205-206, :388-389).

A render thread writes matplotlib frames (the trajectory, the patch-centre
point cloud and the current input frame in an inset) as PNGs to a
directory: it works headless and doubles as a progress artifact for long
evaluations.

The engine writes its buffers in place, and a keyframe cull compacts them,
so a read from another thread could see half a frame. The snapshot is
therefore taken on the tracking thread, at the end of `DEVO.__call__`, at
most once per `period` seconds: the keyframe count, the poses, the world
points of the patch centres and their colours are copied into pinned host
buffers without blocking, and a CUDA event is recorded behind the copies.
The render thread waits on that event, never the tracking thread. Two sets
of buffers alternate: a snapshot the renderer has not taken up yet is
overwritten by the next, and one that it is rendering is never waited for.

A render that raises is counted in `failures` and reported at `join`; a
CUDA error is never caught (it is sticky, and the tracking thread meets it
at its next call). matplotlib is imported in the render thread alone; where
it is missing, the viewer still takes and counts its snapshots and says
once that it writes no PNGs.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from devo_tpu_torch.lie import se3

__all__ = ["Viewer"]


@dataclass
class _Buffers:
    """One snapshot's host copies (pinned on a CUDA engine)."""
    poses: torch.Tensor                   # (N, 7) w2c
    points: torch.Tensor                  # (N * M, 3) world frame
    colors: torch.Tensor                  # (N * M,)
    n: int = 0
    image: Optional[np.ndarray] = None
    ready: Optional[torch.cuda.Event] = None


class Viewer:
    """Renderer of the engine's live state.

    engine: the DEVO engine to watch. out_dir: directory of the
    `frame_%06d.png` renders. period: least seconds between two snapshots.
    max_points: cap on the rendered points (matplotlib slows past ~50k).
    """

    def __init__(self, engine, out_dir: str = "viewer_out",
                 period: float = 2.0, max_points: int = 20000):
        self.engine = engine
        self.out_dir = out_dir
        self.period = float(period)
        self.max_points = int(max_points)
        self.snapshots = 0      # snapshots taken
        self.rendered = 0       # PNGs written
        self.failures = 0       # renders that raised
        self.last_failure: Optional[str] = None
        self.png = None         # whether matplotlib is there (known once a
                                #   snapshot has been rendered)
        self._image = None      # latest input frame (host array)
        self._last = -float("inf")
        cfg = engine.cfg
        pin = engine.device.type == "cuda"
        N, M = cfg.BUFFER_SIZE, cfg.M

        def host(*shape):
            return torch.empty(shape, pin_memory=pin)

        self._free = [_Buffers(host(N, 7), host(N * M, 3), host(N * M))
                      for _ in range(2)]
        self._pending: Optional[_Buffers] = None
        self._cv = threading.Condition()
        self._stop = False
        self._clean = False     # the render thread ended by `join`
        os.makedirs(out_dir, exist_ok=True)
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    # -- the engine's hooks (devo.py:388-389, :205-206) ---------------------

    def update_image(self, image):
        """Keep the latest host input frame for the inset (a reference
        only: called from the tracking thread, it touches no device)."""
        self._image = image

    def snapshot(self, force: bool = False) -> bool:
        """Copy the engine's state for the renderer if `period` has passed
        since the last snapshot (or `force`). Called on the tracking thread
        at the end of a frame; enqueues copies and never waits on the
        device. Returns whether a snapshot was taken."""
        now = time.perf_counter()
        if not force and now - self._last < self.period:
            return False
        eng = self.engine
        n = eng.n
        if n < 2 or not eng.initialized:
            return False
        with self._cv:
            if self._free:
                buf = self._free.pop()
            elif self._pending is not None:  # not rendered yet: overwrite
                buf, self._pending = self._pending, None
            else:                       # the renderer holds both sets
                return False
        M = eng.cfg.M
        cuda = eng.device.type == "cuda"
        buf.poses[:n].copy_(eng.poses[:n], non_blocking=cuda)
        buf.points[:n * M].copy_(eng.point_cloud_tensor(), non_blocking=cuda)
        buf.colors[:n * M].copy_(eng.colors[:n].reshape(-1), non_blocking=cuda)
        buf.n, buf.image = n, self._image
        if cuda:
            buf.ready = torch.cuda.Event()
            buf.ready.record()
        self._last = now
        self.snapshots += 1
        with self._cv:
            if self._pending is not None:   # never rendered: superseded
                self._free.append(self._pending)
            self._pending = buf
            self._cv.notify()
        return True

    def join(self, timeout: Optional[float] = 60.0):
        """Take a last snapshot, render it, stop the render thread and
        report the failures. Returns the number of failed renders."""
        self.snapshot(force=True)
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._t.join(timeout)
        if self._t.is_alive():
            raise RuntimeError(f"viewer: the render thread is still busy "
                               f"after {timeout} s")
        if not self._clean:
            raise RuntimeError("viewer: the render thread died waiting on "
                               "the device (its traceback is above)")
        if self.failures:
            print(f"[viewer] {self.failures} of {self.snapshots} renders "
                  f"failed; the last: {self.last_failure}", file=sys.stderr)
        return self.failures

    # -- the render thread ---------------------------------------------------

    def _run(self):
        while True:
            with self._cv:
                while self._pending is None and not self._stop:
                    self._cv.wait()
                buf, self._pending = self._pending, None
            if buf is None:             # stopped with nothing pending
                self._clean = True
                return
            if buf.ready is not None:
                buf.ready.synchronize()  # not caught: a CUDA error is sticky
            n, M = buf.n, self.engine.cfg.M
            poses = buf.poses[:n].clone()
            points = buf.points[:n * M].numpy().copy()
            colors = buf.colors[:n * M].numpy().copy()
            image = buf.image
            with self._cv:
                self._free.append(buf)
            try:
                self._render(poses, points, colors, image)
            except Exception as e:      # matplotlib, the file system
                self.failures += 1
                self.last_failure = f"{type(e).__name__}: {e}"

    def _render(self, poses: torch.Tensor, pts: np.ndarray,
                colors: np.ndarray, image):
        """Write one frame from a snapshot's host copies."""
        try:
            import matplotlib
        except ImportError:
            if self.png is None:
                print("[viewer] matplotlib is not installed: snapshots are "
                      "taken and counted, no PNG is written", file=sys.stderr)
            self.png = False
            return
        self.png = True
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        # camera centres: the translation of the c2w poses
        cam = se3.inv(poses)[:, :3].numpy()

        # drop far outliers so that one bad depth does not flatten the view
        if len(pts):
            d = np.linalg.norm(pts - np.median(pts, 0), axis=1)
            keep = d < 10.0 * (np.median(d) + 1e-6)
            pts, colors = pts[keep], colors[keep]
        if len(pts) > self.max_points:
            sel = np.random.default_rng(0).choice(
                len(pts), self.max_points, replace=False)
            pts, colors = pts[sel], colors[sel]

        fig = plt.figure(figsize=(8, 6))
        try:
            ax = fig.add_subplot(111, projection="3d")
            if len(pts):
                ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.5,
                           c=np.clip(colors, 0, 1), cmap="viridis", alpha=0.6)
            ax.plot(cam[:, 0], cam[:, 1], cam[:, 2], "r-", lw=1.5)
            ax.scatter(cam[-1:, 0], cam[-1:, 1], cam[-1:, 2], c="red", s=30,
                       marker="^")
            ax.set_title(f"devo_tpu_torch live - {len(cam)} keyframes, "
                         f"{len(pts)} points")
            ax.set_box_aspect((1, 1, 1))
            if image is not None:
                img = np.asarray(image, np.float32)
                if img.ndim == 3 and img.shape[-1] > 3:   # voxel: sum bins
                    img = np.abs(img).sum(-1)
                elif img.ndim == 3:       # a 0-255 BGR frame
                    img = np.clip(img[..., ::-1] / 255.0, 0.0, 1.0)
                ax2 = fig.add_axes([0.02, 0.68, 0.28, 0.28])
                ax2.imshow(img, cmap="gray")
                ax2.set_xticks([]), ax2.set_yticks([])
            fig.savefig(os.path.join(self.out_dir,
                                     f"frame_{self.rendered:06d}.png"), dpi=80)
        finally:
            plt.close(fig)
        self.rendered += 1
