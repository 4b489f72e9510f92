"""The live viewer of the port (runtime/viewer.py, the counterpart of
devo_tpu/runtime/viewer.py and tests/test_viewer.py) on a small CPU engine
in frame mode (eval/frames.frame_config at tests/test_torch_frames.py's
size, random weights, a camera panning over a texture): it renders PNGs and
joins at terminate(), survives an engine that is not initialized, takes
every snapshot at the end of a frame (each equals, bit for bit, the poses,
points and colours the engine held at the end of some frame), leaves the
trajectory bit for bit as it is without the viewer, counts its render
failures, and takes and counts its snapshots without matplotlib.
"""
import builtins
import glob
import os
import time

import numpy as np
import pytest
import torch

from devo_tpu_torch.eval import frames
from devo_tpu_torch.nets.evonet import EVONet
from devo_tpu_torch.runtime.engine import DEVO
from devo_tpu_torch.runtime.viewer import Viewer
from devo_tpu_torch.utils.params import random_state_dict

from test_torch_frames import SMALL

HT = WD = 64
N_FRAMES = 14
INTR = np.asarray([60.0, 60.0, 32.0, 32.0], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CFG = frames.frame_config().replace(**SMALL)
WEIGHTS = random_state_dict(EVONet(CFG.P, CFG.DIM_INET, CFG.DIM_FNET,
                                   CFG.DIM, CFG.BINS,
                                   patch_selector=CFG.PATCH_SELECTOR), seed=0)


def make_frames(n=N_FRAMES):
    """(H, W, 3) frames in 0-255 of a camera panning 2 px a frame."""
    rng = np.random.default_rng(0)
    base = (rng.random((HT, WD + 2 * n, 3)) * 255).astype(np.float32)
    return [base[:, 2 * i:2 * i + WD] for i in range(n)]


def engine():
    return DEVO(CFG, WEIGHTS, ht=HT, wd=WD, seed=0, device="cpu")


def track(slam, n=N_FRAMES, after_frame=None):
    for i, f in enumerate(make_frames(n)):
        slam(float(i), f, INTR)
        if after_frame is not None:
            after_frame(slam)
    return slam.terminate()


def test_viewer_renders_and_joins(tmp_path):
    slam = engine()
    out = str(tmp_path / "viz")
    viewer = slam.start_viewer(out_dir=out, period=0.0)
    assert slam.viewer is viewer
    poses, _ = track(slam)
    assert slam.viewer is None and not viewer._t.is_alive()
    # the __call__ hook fed the inset with the host frame
    assert viewer._image is not None and viewer._image.shape == (HT, WD, 3)
    pngs = sorted(glob.glob(os.path.join(out, "frame_*.png")))
    assert viewer.failures == 0 and viewer.png is True
    assert len(pngs) == viewer.rendered >= 1
    assert viewer.snapshots >= viewer.rendered
    assert os.path.getsize(pngs[0]) > 1000
    assert np.isfinite(poses).all()


def test_viewer_survives_uninitialized_engine(tmp_path):
    """Before initialization no snapshot is taken, and join() writes
    nothing and fails nothing (tests/test_viewer.py)."""
    slam = engine()
    v = Viewer(slam, out_dir=str(tmp_path / "v"), period=0.05)
    for i, f in enumerate(make_frames(3)):
        slam(float(i), f, INTR)
        assert not v.snapshot(force=True)
    assert v.join() == 0
    assert v.snapshots == v.rendered == 0
    assert glob.glob(str(tmp_path / "v" / "*.png")) == []


def test_snapshots_are_frame_end_states(tmp_path, monkeypatch):
    """Every snapshot the renderer receives equals, bit for bit, the state
    at the end of one frame: the engine's poses, world points and colours,
    recorded frame by frame. A slow renderer makes the tracking thread
    overwrite snapshots it has not taken up, never wait for them."""
    states = []

    def record(slam):
        n = slam.n
        states.append((slam.poses[:n].clone(), slam.point_cloud(),
                       slam.colors[:n].reshape(-1).clone()))

    got = []

    def render(self, poses, pts, colors, image):
        time.sleep(0.02)
        got.append((poses, pts, colors))

    monkeypatch.setattr(Viewer, "_render", render)
    slam = engine()
    viewer = slam.start_viewer(out_dir=str(tmp_path), period=0.0)
    track(slam, after_frame=record)
    assert viewer.failures == 0 and len(got) >= 2
    for poses, pts, colors in got:
        assert any(torch.equal(poses, p) and np.array_equal(pts, q)
                   and torch.equal(torch.from_numpy(colors), c)
                   for p, q, c in states)
    # the last render is the final state (join snapshots it)
    assert torch.equal(got[-1][0], states[-1][0])


def test_viewer_leaves_the_trajectory_bitwise(tmp_path, monkeypatch):
    """A snapshot at every frame end changes no bit of the trajectory (the
    renders themselves read host copies alone: skipped here)."""
    monkeypatch.setattr(Viewer, "_render", lambda self, *a: None)
    plain = track(engine())
    slam = engine()
    slam.start_viewer(out_dir=str(tmp_path), period=0.0)
    viewed = track(slam)
    np.testing.assert_array_equal(viewed[0], plain[0])
    np.testing.assert_array_equal(viewed[1], plain[1])


def test_render_failures_are_counted_and_reported(tmp_path, monkeypatch,
                                                  capsys):
    def render(self, *a):
        raise OSError("disk full")

    monkeypatch.setattr(Viewer, "_render", render)
    slam = engine()
    viewer = slam.start_viewer(out_dir=str(tmp_path), period=0.0)
    track(slam)
    assert viewer.failures >= 1 and viewer.rendered == 0
    assert viewer.last_failure == "OSError: disk full"
    assert f"{viewer.failures} of {viewer.snapshots} renders failed" in \
        capsys.readouterr().err


def test_without_matplotlib_snapshots_are_taken_and_counted(
        tmp_path, monkeypatch, capsys):
    real = builtins.__import__

    def no_mpl(name, *a, **k):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    slam = engine()
    viewer = slam.start_viewer(out_dir=str(tmp_path), period=0.0)
    track(slam)
    assert viewer.png is False and viewer.failures == 0
    assert viewer.snapshots >= 1 and viewer.rendered == 0
    assert glob.glob(str(tmp_path / "*.png")) == []
    assert capsys.readouterr().err.count("matplotlib is not installed") == 1
