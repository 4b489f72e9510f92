"""The frame-input families of the port's evaluation (eval/frames.py, the
counterpart of evals/common_frames.py, and `eval/cli.py --family`): the
frame configuration against the JAX drivers', the intrinsics file's
refusal, and one run end to end on the CPU over a fake tree of PNG frames
per family.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from devo_tpu.runtime.config import EVAL_CONFIGS as JEVAL_CONFIGS
from devo_tpu_torch.eval import cli, frames
from devo_tpu_torch.nets.evonet import EVONet
from devo_tpu_torch.runtime.config import VOConfig
from devo_tpu_torch.utils.params import random_state_dict

SMALL = dict(DIM_INET=32, DIM_FNET=16, DIM=8, PATCHES_PER_FRAME=8,
             MIXED_PRECISION=False, MOTION_PROBE_THRESH=-1.0, BUFFER_SIZE=64,
             MEM=16)
N_IMGS, HT, WD = 10, 64, 64


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Small tensors: more than two intra-op threads only contend with the
    other workers of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_frame_config_is_the_reference_drivers():
    """evals/common_frames.py:71-74 on devo_tpu's EVAL_CONFIGS["default"],
    knob by knob."""
    want = JEVAL_CONFIGS["default"].replace(
        EVS=False, BINS=3, PATCH_SELECTOR="random", NORM="none",
        SCORER_EVAL_MODE="random", SCORER_EVAL_USE_GRID=False,
        OPTIMIZATION_WINDOW=15, KEYFRAME_THRESH=15.0)
    got = frames.frame_config()
    for f in dataclasses.fields(VOConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert set(frames.FAMILIES) == {"rgb", "e2v", "evs_frame"}


def _write_scene(d, family, calib=True):
    import cv2

    img_dir = os.path.join(d, frames.FAMILIES[family])
    os.makedirs(img_dir)
    rng = np.random.default_rng(0)
    base = (rng.random((HT, 2 * WD, 3)) * 255).astype(np.uint8)
    for i in range(N_IMGS):
        img = base[:, 3 * i:3 * i + WD]
        if i == 1:       # one grey image: read back as 3 equal channels
            img = img[..., 0]
        cv2.imwrite(os.path.join(img_dir, f"{i:06d}.png"), img)
    tss_us = np.arange(N_IMGS, dtype=np.float64) * 33_000 + 4_000
    np.savetxt(os.path.join(d, "images_timestamps_us.txt"), tss_us)
    gt = np.zeros((N_IMGS, 8))
    gt[:, 0], gt[:, 1], gt[:, 7] = tss_us, 0.03 * np.arange(N_IMGS), 1.0
    np.savetxt(os.path.join(d, "stamped_groundtruth_us.txt"), gt)
    if calib:
        np.savetxt(os.path.join(d, "calib_undist.txt"), [60.0, 60.0, 32.0, 32.0])


def _weights(path):
    cfg = frames.frame_config().replace(**SMALL)
    torch.save(random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS,
               patch_selector=cfg.PATCH_SELECTOR), seed=0), path)


def test_frame_iterator_reads_the_scene(tmp_path):
    _write_scene(str(tmp_path), "rgb")
    intr = frames.load_undist_intrinsics(str(tmp_path))
    items = list(frames.frame_iterator(str(tmp_path / "images_undistorted_calib0"),
                                       intr, stride=2))
    assert len(items) == N_IMGS // 2
    img, k, ts = items[0]
    assert img.shape == (3, HT, WD) and img.dtype == np.float32
    assert img.max() <= 255 and img.max() > 1
    assert ts == pytest.approx(0.004) and items[1][2] == pytest.approx(0.070)
    np.testing.assert_array_equal(k, [60.0, 60.0, 32.0, 32.0])
    grey = next(frames.frame_iterator(
        str(tmp_path / "images_undistorted_calib0"), intr, stride=1))
    assert grey[0].shape == (3, HT, WD)


def test_missing_calibration_raises(tmp_path):
    _write_scene(str(tmp_path / "s"), "rgb", calib=False)
    with pytest.raises(FileNotFoundError, match="calib_undist.txt"):
        frames.load_undist_intrinsics(str(tmp_path / "s"))
    weights = tmp_path / "w.pth"
    _weights(weights)
    with pytest.raises(FileNotFoundError, match="calib_undist.txt"):
        cli.main(["eds", "--family", "rgb", "--datapath", str(tmp_path / "s"),
                  "--weights", str(weights), "--trials", "1", "--outdir",
                  str(tmp_path / "out"), "--device", "cpu"])
    (tmp_path / "s" / "calib_undist.txt").write_text("60 60 32\n")
    with pytest.raises(ValueError, match="4 values"):
        frames.load_undist_intrinsics(str(tmp_path / "s"))


def test_frame_family_refuses_an_event_config(tmp_path):
    args = cli.make_parser().parse_args(
        ["eds", "--family", "rgb", "--weights", str(tmp_path / "w.pth"),
         "--config", "config/eval_eds.yaml"])
    _weights(tmp_path / "w.pth")
    with pytest.raises(ValueError, match="--config"):
        cli.evaluate_benchmark("eds", args)
    assert cli.make_parser().parse_args(["eds"]).family == "evs"
    with pytest.raises(SystemExit):
        cli.make_parser().parse_args(["eds", "--family", "depth"])


@pytest.mark.parametrize("family", ["rgb", "e2v", "evs_frame"])
def test_frame_cli_end_to_end_on_the_cpu(tmp_path, family):
    """`python -m devo_tpu_torch.eval.cli eds --family <f> ... --device
    cpu` over one scene of 10 PNG frames: the engine initializes, and the
    run gives finite metrics, a TUM dump a trial and the results JSON."""
    data = tmp_path / "eds"
    _write_scene(str(data / "scene_a"), family)
    split = tmp_path / "val.txt"
    split.write_text("scene_a\n")
    weights = tmp_path / "weights.pth"
    _weights(weights)
    out = tmp_path / "out"
    trials = 2 if family == "rgb" else 1
    results = cli.main([
        "eds", "--family", family, "--datapath", str(data), "--weights",
        str(weights), "--val_split", str(split), "--trials", str(trials),
        "--outdir", str(out), "--config_overrides", json.dumps(SMALL),
        "--device", "cpu"])
    a = results["scene_a"]
    assert len(a["ate_trials"]) == trials and np.isfinite(a["ate_cm"])
    assert np.isfinite([a["mpe"], a["r_rmse"]]).all() and a["fps"] > 0
    on_disk = json.loads((out / f"eds_{family}_results.json").read_text())
    assert on_disk["scene_a"]["ate_trials"] == a["ate_trials"]
    for trial in range(trials):
        dump = np.loadtxt(out / f"scene_a_{family}_trial{trial}.txt")
        assert dump.shape == (N_IMGS, 8) and np.isfinite(dump).all()
    blob = json.loads((out / f"scene_a_{family}_results.json").read_text())
    assert {"median", "trials", "fps"} <= set(blob)
