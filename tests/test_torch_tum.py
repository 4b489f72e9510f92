"""TUM-RGBD as a benchmark of the port's eval CLI (`python -m
devo_tpu_torch.eval.cli tum --family rgb`, the counterpart of
evals/eval_tum_rgb.py): eval/frames.tum_image_iterator against
evals/eval_tum_rgb.tum_image_iterator, loaded through importlib, on a fake
rgb/ tree of 640x480 PNGs that cv2 writes (the same arrays, intrinsics and
stamps bit for bit: both are the same cv2 calls); the configuration against
that script's; the CLI's refusals; and one run end to end on the CPU.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from devo_tpu_torch.eval import cli, frames
from devo_tpu_torch.runtime.config import VOConfig

from test_torch_frames import SMALL, _weights

ROOT = Path(__file__).resolve().parent.parent
N_IMGS = 10


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def eval_tum_rgb(monkeypatch):
    """evals/eval_tum_rgb.py as a module (its `common` import is
    evals/common.py)."""
    monkeypatch.syspath_prepend(str(ROOT / "evals"))
    spec = importlib.util.spec_from_file_location(
        "eval_tum_rgb", ROOT / "evals" / "eval_tum_rgb.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_scene(d, n=N_IMGS):
    """rgb/<stamp>.png at 640x480, a camera panning over a texture, and
    groundtruth.txt in seconds, a little denser than the images."""
    (d / "rgb").mkdir(parents=True)
    rng = np.random.default_rng(0)
    base = cv2.resize((rng.random((60, 120, 3)) * 255).astype(np.uint8),
                      (1280, 480), interpolation=cv2.INTER_LINEAR)
    for i in range(n):
        cv2.imwrite(str(d / "rgb" / f"{1305031102.175304 + i / 30:.6f}.png"),
                    base[:, 12 * i:12 * i + 640])
    t = 1305031102.16 + np.arange(2 * n + 2) / 60
    gt = np.zeros((len(t), 8))
    gt[:, 0], gt[:, 1], gt[:, 7] = t, 0.01 * np.arange(len(t)), 1.0
    np.savetxt(d / "groundtruth.txt", gt, fmt="%.6f",
               header="timestamp tx ty tz qx qy qz qw")


def test_tum_iterator_is_eval_tum_rgbs(tmp_path, eval_tum_rgb):
    write_scene(tmp_path)
    for stride, skip in ((1, 0), (3, 1)):
        got = list(frames.tum_image_iterator(str(tmp_path), stride, skip))
        want = list(eval_tum_rgb.tum_image_iterator(str(tmp_path), stride, skip))
        assert len(got) == len(want) == len(range(skip, N_IMGS, stride))
        for (img, intr, ts), (wimg, wintr, wts) in zip(got, want):
            assert img.shape == (3, 256, 352) and img.dtype == np.float32
            np.testing.assert_array_equal(img, wimg)
            np.testing.assert_array_equal(intr, wintr)
            assert ts == wts
    assert (frames.TUM_H, frames.TUM_W) == (eval_tum_rgb.H_OUT, eval_tum_rgb.W_OUT)
    np.testing.assert_array_equal(frames.TUM_DIST, eval_tum_rgb.TUM_DIST)
    np.testing.assert_allclose(frames.tum_intrinsics(),
                               [517.3 * 0.55, 516.5 * 256 / 480,
                                318.6 * 0.55, 255.3 * 256 / 480], rtol=1e-6)


def test_tum_config_is_eval_tum_rgbs():
    """eval_tum_rgb.py:50-54's configuration is the frame drivers'."""
    from devo_tpu.runtime.config import EVAL_CONFIGS as JEVAL_CONFIGS
    want = JEVAL_CONFIGS["default"].replace(
        EVS=False, BINS=3, PATCH_SELECTOR="random", NORM="none",
        SCORER_EVAL_MODE="random", SCORER_EVAL_USE_GRID=False,
        OPTIMIZATION_WINDOW=15, KEYFRAME_THRESH=15.0)
    got = frames.frame_config()
    for f in dataclasses.fields(VOConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_tum_refuses_other_families_and_a_config(tmp_path):
    p = cli.make_parser()
    assert cli.RES["tum"] == (256, 352)
    for fam in ("evs", "e2v", "evs_frame"):
        args = p.parse_args(["tum", "--family", fam, "--device", "cpu"])
        with pytest.raises(ValueError, match="--family rgb"):
            cli.evaluate_benchmark("tum", args)
    args = p.parse_args(["tum", "--family", "rgb", "--config",
                         "config/eval_eds.yaml", "--device", "cpu"])
    with pytest.raises(ValueError, match="--config"):
        cli.evaluate_benchmark("tum", args)


def test_tum_cli_end_to_end_on_the_cpu(tmp_path):
    """`python -m devo_tpu_torch.eval.cli tum --family rgb ... --device
    cpu` on one scene of 10 images: the engine initializes at 256x352, and
    the run gives finite metrics, the TUM dump and the results JSON."""
    data = tmp_path / "tum"
    write_scene(data / "rgbd_dataset_freiburg1_xyz")
    split = tmp_path / "val.txt"
    split.write_text("rgbd_dataset_freiburg1_xyz\n")
    weights = tmp_path / "weights.pth"
    _weights(weights)
    out = tmp_path / "out"
    results = cli.main([
        "tum", "--family", "rgb", "--datapath", str(data), "--weights",
        str(weights), "--val_split", str(split), "--trials", "1",
        "--outdir", str(out), "--config_overrides", json.dumps(SMALL),
        "--device", "cpu"])
    a = results["rgbd_dataset_freiburg1_xyz"]
    assert len(a["ate_trials"]) == 1 and np.isfinite(a["ate_cm"])
    dump = np.loadtxt(out / "rgbd_dataset_freiburg1_xyz_rgb_trial0.txt")
    assert dump.shape == (N_IMGS, 8)
    np.testing.assert_allclose(dump[0, 0], 1305031102.175304, atol=1e-6)
    assert (out / "tum_rgb_results.json").exists()
    assert "_summary" in results
