"""The port's command-line evaluation (devo_tpu_torch/eval/cli.py, the
counterpart of evals/common.py): its argument surface, the configuration
files it loads, what it refuses, and one run end to end on the CPU over a
synthetic EDS-format tree of two scenes, one of them without ground truth.
No jax import: the CLI is the port's alone.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

from devo_tpu_torch.data.event_utils import compute_ms_to_idx
from devo_tpu_torch.data.loaders import BENCHMARK_RES
from devo_tpu_torch.eval import cli
from devo_tpu_torch.nets.evonet import EVONet
from devo_tpu_torch.runtime.config import EVAL_CONFIGS, VOConfig
from devo_tpu_torch.utils.params import random_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(DIM_INET=32, DIM_FNET=16, DIM=8, PATCHES_PER_FRAME=8,
             MIXED_PRECISION=False, MOTION_PROBE_THRESH=-1.0, BUFFER_SIZE=64,
             MEM=16)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The tensors here are small: more than two intra-op threads gain
    nothing and contend with the other workers of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_parser_surface(capsys):
    p = cli.make_parser()
    args = p.parse_args(["eds", "--datapath", "/data/eds", "--weights", "w.pth",
                         "--val_split", "splits/eds/eds_val.txt", "--trials",
                         "3", "--stride", "2", "--outdir", "out", "--config",
                         "config/eval_eds.yaml", "--config_overrides",
                         '{"CORR_KERNEL": "pair"}', "--device", "cpu"])
    assert (args.benchmark, args.trials, args.stride, args.device) == (
        "eds", 3, 2, "cpu")
    d = p.parse_args(["fpv"])
    assert (d.weights, d.trials, d.stride, d.outdir, d.device, d.viz) == (
        "DEVO.pth", 5, 1, "results", None, False)
    # the event benchmarks and TUM-RGBD, a frame benchmark alone
    assert set(cli.BENCHMARKS) == set(BENCHMARK_RES) | {"tum"}
    with pytest.raises(SystemExit):
        p.parse_args(["not-a-benchmark"])
    with pytest.raises(SystemExit) as e:
        p.parse_args(["--help"])
    assert e.value.code == 0
    helptext = capsys.readouterr().out
    for flag in ("--datapath", "--weights", "--val_split", "--trials",
                 "--stride", "--outdir", "--config", "--config_overrides",
                 "--device"):
        assert flag in helptext


def test_tartanair_waits_for_the_training_slice():
    """The training slice brought the tartanair benchmark
    (tests/test_torch_trainer.py runs it on a fake tree); its trees hold
    event voxels alone, so a frame family is refused, and a missing tree
    raises."""
    args = cli.make_parser().parse_args(["tartanair", "--weights", "none.pth",
                                         "--family", "rgb"])
    with pytest.raises(ValueError, match="event voxels alone"):
        cli.evaluate_benchmark("tartanair", args)
    args = cli.make_parser().parse_args(["tartanair", "--weights", "none.pth"])
    with pytest.raises(FileNotFoundError):
        cli.evaluate_benchmark("tartanair", args)


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(ROOT, "config", "eval_*.yaml"))), ids=os.path.basename)
def test_eval_yaml_loads_through_the_ports_config(path):
    name = os.path.basename(path)[len("eval_"):-len(".yaml")]
    base = EVAL_CONFIGS[name]
    cfg = VOConfig.from_yaml(path, base=base)
    assert isinstance(cfg, VOConfig)
    # the yaml files restate the built-in per-benchmark overrides
    assert cfg.KEYFRAME_THRESH == base.KEYFRAME_THRESH
    assert cfg.EDGE_CAP == base.EDGE_CAP and not cfg.CORR_RING_I8


def _write_scene(d, with_gt, n_imgs=4, dt_us=33_000):
    import h5py

    os.makedirs(d)
    rng = np.random.default_rng(3)
    n_ev = 250_000
    t = np.sort(rng.integers(0, n_imgs * dt_us + 20_000, n_ev)).astype(np.int64)
    with h5py.File(os.path.join(d, "events.h5"), "w") as f:
        f.create_dataset("events/t", data=t)
        f.create_dataset("events/x", data=rng.integers(0, 640, n_ev).astype(np.uint16))
        f.create_dataset("events/y", data=rng.integers(0, 480, n_ev).astype(np.uint16))
        f.create_dataset("events/p", data=(rng.integers(0, 2, n_ev) * 2 - 1).astype(np.int8))
        f.create_dataset("ms_to_idx", data=compute_ms_to_idx(t))
    gx, gy = np.meshgrid(np.arange(640, dtype=np.float32),
                         np.arange(480, dtype=np.float32))
    with h5py.File(os.path.join(d, "rectify_map_calib0.h5"), "w") as f:
        f.create_dataset("rectify_map", data=np.stack([gx, gy], -1))
    tss_us = np.arange(n_imgs, dtype=np.float64) * dt_us + 4_000
    np.savetxt(os.path.join(d, "images_timestamps_us.txt"), tss_us)
    if with_gt:
        gt = np.zeros((n_imgs, 8))
        gt[:, 0], gt[:, 1], gt[:, 7] = tss_us, 0.03 * np.arange(n_imgs), 1.0
        np.savetxt(os.path.join(d, "stamped_groundtruth_us.txt"), gt,
                   header="t x y z qx qy qz qw")


def test_cli_end_to_end_on_the_cpu(tmp_path, capsys):
    """`python -m devo_tpu_torch.eval.cli eds ... --device cpu` on two
    scenes: the one with ground truth gets metrics, TUM dumps and a results
    JSON; the one without is reported and skipped, and the run goes on."""
    data = tmp_path / "eds"
    _write_scene(str(data / "scene_a"), with_gt=True)
    _write_scene(str(data / "scene_b"), with_gt=False)
    split = tmp_path / "val.txt"
    split.write_text("scene_a\nscene_b\n")
    cfg = EVAL_CONFIGS["eds"].replace(**SMALL)
    weights = tmp_path / "weights.pth"
    torch.save(random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS), seed=0),
        weights)
    out = tmp_path / "out"
    results = cli.main([
        "eds", "--datapath", str(data), "--weights", str(weights),
        "--val_split", str(split), "--trials", "2", "--outdir", str(out),
        "--config", os.path.join(ROOT, "config", "eval_eds.yaml"),
        "--config_overrides", json.dumps({**SMALL, "CORR_KERNEL": "pair"}),
        "--device", "cpu"])
    assert "error" in results["scene_b"]
    a = results["scene_a"]
    assert len(a["ate_trials"]) == 2 and np.isfinite(a["ate_cm"])
    assert a["fps"] > 0 and "_summary" in results
    assert "no ground truth" in capsys.readouterr().err
    on_disk = json.loads((out / "eds_results.json").read_text())
    assert on_disk["scene_a"]["ate_trials"] == a["ate_trials"]
    for trial in range(2):
        dump = np.loadtxt(out / f"scene_a_trial{trial}.txt")
        assert dump.shape == (3, 8)          # 4 image stamps -> 3 windows
    blob = json.loads((out / "scene_a_results.json").read_text())
    assert {"median", "trials", "fps"} <= set(blob)
