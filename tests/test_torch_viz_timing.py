"""The port's visualization and profiling helpers: utils/viz.py (its own
copy of devo_tpu/utils/viz.py) against devo_tpu's, and utils/timing.py
(the torch.profiler counterpart of devo_tpu/utils/timing.py).

- viz: the array functions (render_voxel, render_scorer_map, draw_patches,
  render_events, render_depth_map, draw_flow_lines) give devo_tpu's arrays
  bit for bit on tests/test_viz.py's inputs; the plotting functions write
  the same files as devo_tpu's, by name (matplotlib's PNG bytes are not
  compared: they carry the figure's text through font caches of the
  process).
- timing: `trace` writes a Chrome trace of a small CPU engine that holds
  the engine's spans (devo.update, devo.corr inside it) and the caller's
  own `span` (the tracer's other tests: tests/test_torch_tracing.py).
"""
import json
import os

import numpy as np
import pytest

from devo_tpu.utils import viz as jviz
from devo_tpu_torch.utils import timing, viz

# _two_threads: the viewer tests' two intra-op threads, module-wide (the
# profiler over a small engine beside other test processes crawls with
# every core's thread)
from test_torch_viewer import INTR, _two_threads, engine, make_frames  # noqa: F401


@pytest.fixture()
def voxel():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((5, 24, 32)).astype(np.float32)
    return v * (np.abs(v) > 1.0)


def test_array_functions_are_devo_tpus(voxel):
    rng = np.random.default_rng(1)
    img = (rng.random((20, 30, 3)) * 255).astype(np.uint8)
    s = np.linspace(0, 1, 12).reshape(3, 4)
    x, y = rng.integers(0, 40, 200), rng.integers(0, 30, 200)
    pol = rng.integers(0, 2, 200)
    pts = np.array([[5.0, 5.0], [200.0, 5.0], [29.0, 19.0]])
    cases = [
        ("render_voxel", (voxel,), {}),
        ("render_voxel", (voxel,), {"eps": 0.5}),
        ("render_scorer_map", (s,), {}),
        ("render_scorer_map", (np.zeros((3, 4)),), {}),
        ("render_depth_map", (s,), {}),
        ("render_depth_map", (rng.uniform(0.5, 3, (8, 9)),), {}),
        ("render_events", (x, y, pol, 30, 40), {}),
        ("draw_patches", (img, pts), {}),
        ("draw_patches", (img, pts), {"color": (1, 2, 3)}),
        ("draw_flow_lines", (img, pts[:1] + 1, np.array([[10.0, 12.0]])), {}),
        ("draw_flow_lines", (img, rng.random((6, 2)) * 25,
                             rng.random((6, 2)) * 25), {}),
    ]
    for name, args, kw in cases:
        got = getattr(viz, name)(*args, **kw)
        want = getattr(jviz, name)(*args, **kw)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_plots_write_devo_tpus_files(tmp_path, voxel):
    rng = np.random.default_rng(2)
    t = np.linspace(0, 1, 30)
    est = np.stack([np.cos(t), np.sin(t), t], -1)
    n, E = 4, 10
    flow = {3: {"ii": np.array([2, 2]), "jj": np.array([3, 3]),
                "coords_est": rng.random((2, 3, 3, 2)) * 6,
                "coords_src": rng.random((2, 2)) * 6, "img": voxel}}
    rec = {"ii": np.array([0, 0, 1]), "jj": np.array([1, 1, 2]),
           "coords_est": rng.random((3, 3, 3, 2)) * 6}
    step = {"ii": rng.integers(0, n, E), "jj": rng.integers(0, n, E),
            "coords": rng.random((E, 3, 3, 2)) * 6,
            "coords_gt": rng.random((E, 3, 3, 2)) * 6,
            "emask": np.ones(E, bool)}
    patches = rng.random((n, 4, 3, 3, 3)).astype(np.float32)
    voxels = np.stack([voxel] * n).transpose(0, 2, 3, 1)
    for mod, root in ((viz, tmp_path / "port"), (jviz, tmp_path / "jax")):
        root.mkdir()
        mod.plot_trajectory(str(root / "traj.png"), est, est + 0.01,
                            title="t")
        mod.visualize_pose(est, est + 0.01, plot_axes="xz",
                           path=str(root / "pose.png"))
        mod.save_voxels(voxel[None], str(root / "vox"))
        mod.viz_flow_inference(str(root), flow)
        mod.save_flow_visualization(str(root / "fv"), flow)
        mod.plot_patch_following([voxel] * 3, {1: rec, 2: rec},
                                 str(root / "pf"), num_frame_pairs=2)
        mod.plot_patch_following_all([voxel] * 3, {1: rec, 2: rec},
                                     str(root / "pfa"), num_frame_pairs=2)
        mod.plot_flow_train(voxels, step, str(root / "ft"), fidx_center=2)
        mod.plot_patch_depths([voxel] * n, patches, str(root / "pd"))
    got = _files(tmp_path / "port")
    assert got == _files(tmp_path / "jax")
    assert len(got) >= 10
    assert all(os.path.getsize(tmp_path / "port" / f) > 100 for f in got)


def test_trace_holds_the_engines_spans(tmp_path):
    """timing.trace around the ninth frame of a small CPU engine (one
    update after the initialization): the Chrome trace names devo.update,
    devo.corr and a span of the caller's own."""
    slam = engine()
    *first, last = make_frames(9)
    for i, f in enumerate(first):
        slam(float(i), f, INTR)
    assert slam.initialized
    with timing.trace(str(tmp_path)) as prof:
        with timing.span("caller.frame"):
            slam(8.0, last, INTR)
    names = {e.key for e in prof.key_averages()}
    assert {"devo.update", "devo.corr", "caller.frame"} <= names
    (path,) = list(tmp_path.glob("*.pt.trace.json"))
    events = json.loads(path.read_text())["traceEvents"]
    spans = {e.get("name") for e in events}
    assert {"devo.update", "devo.corr", "devo.patchify",
            "caller.frame"} <= spans
