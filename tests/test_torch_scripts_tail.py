"""The offline scripts of devo_tpu_torch/scripts/ (the eight pp_*.py,
convert_tartan, e2v_undist, evaluate_rpe, compute_median_from_restxt,
orb3_pp_eds, orb3_eval, plot_h5) against their originals in scripts/: each
pair runs as `__main__` with the same arguments on two copies of one fake
tree, and the trees they leave are compared file by file (h5 files dataset
by dataset, the rest byte for byte), and so is what they print, the tree's
path put aside.

Tolerance: none. The scripts and the modules under them are NumPy, OpenCV
and matplotlib code on the host, the same operations in the same order.
"""
import json
import runpy
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")
yaml = pytest.importorskip("yaml")

from test_torch_data_tail import assert_same_tree, make_sequence

ROOT = Path(__file__).resolve().parent.parent


def run_both(name, tree, argv, tmp_path, monkeypatch, capsys):
    """Run scripts/<name>.py on a copy of `tree` and the port's on another;
    `argv(root)` gives the arguments for a copy at `root`. Returns the
    files of the port's copy."""
    out = {}
    for side in ("port", "orig"):
        root = tmp_path / side
        shutil.copytree(tree, root)
        monkeypatch.setattr(sys, "argv", [name] + argv(root))
        if side == "port":
            runpy.run_module(f"devo_tpu_torch.scripts.{name}",
                             run_name="__main__", alter_sys=False)
        else:
            runpy.run_path(str(ROOT / "scripts" / f"{name}.py"),
                           run_name="__main__")
        out[side] = capsys.readouterr().out.replace(str(root), "<tree>")
    assert out["port"] == out["orig"]
    return assert_same_tree(tmp_path / "port", tmp_path / "orig")


def _calib_json(path, size):
    path.write_text(json.dumps({"K": [60.0, 61.0, size[1] / 2, size[0] / 2],
                                "dist": [0.05, -0.01, 0.001, 0.0],
                                "size": list(size)}))
    return str(path)


PP_CASES = {
    # name: (the script's arguments beyond --indir, extra files of the tree)
    "pp_eds": (["--calibstr", "calib1"], {}),
    "pp_ecd": ([], {"images.txt": "5.0 images/frame_0000.png\n"
                                  "5.02 images/frame_0001.png\n"}),
    "pp_fpv": ([], {}),
    "pp_hku": (["--side", "right"], {}),
    "pp_mvsec": ([], {}),
    "pp_rpg": ([], {}),
    "pp_tumvie": (["--side", "right"], {}),
    "pp_vector": ([], {}),
}


@pytest.mark.parametrize("name", list(PP_CASES))
def test_pp_scripts_write_the_originals_files(name, tmp_path, monkeypatch,
                                              capsys):
    """Each preprocessor on tests/test_preprocess.py's synthetic sequence
    with a user calibration (--calib; pp_eds with its built-in RGB
    calibration for the images): the rectify map, the undistorted
    calibration, the time sidecars and the undistorted images."""
    extra, files = PP_CASES[name]
    tree = tmp_path / "tree"
    make_sequence(tree)
    for fn, text in files.items():
        (tree / fn).write_text(text)
    calib = _calib_json(tmp_path / "c.json", (48, 64))
    if name == "pp_fpv":    # the camchain's extrinsics give the camera GT
        (tree / "camchain.yaml").write_text(yaml.safe_dump({"cam0": {
            "T_cam_imu": [[0.0, -1.0, 0.0, 0.1], [1.0, 0.0, 0.0, 0.0],
                          [0.0, 0.0, 1.0, -0.2], [0.0, 0.0, 0.0, 1.0]]}}))
    got = run_both(name, tree,
                   lambda r: ["--indir", str(r), "--calib", calib] + extra,
                   tmp_path, monkeypatch, capsys)
    assert any(f.startswith("rectify_map") for f in got)


def test_convert_tartan_writes_the_originals_voxels(tmp_path, monkeypatch,
                                                    capsys):
    """tests/test_convert_tartan.py's raw scene, simulated by ESIM at 2x
    upsampling: the same float16 voxels."""
    from test_convert_tartan import _write_raw_scene
    scene = tmp_path / "tree" / "P001"
    _write_raw_scene(str(scene))
    got = run_both("convert_tartan", tmp_path / "tree",
                   lambda r: ["--scenes", str(r / "P001"), "--upsample", "2",
                              "--seed", "3"], tmp_path, monkeypatch, capsys)
    assert sum(f.startswith("P001/evs_left/h5/") for f in got) == 7


def test_e2v_undist_writes_the_originals_images(tmp_path, monkeypatch,
                                                capsys):
    tree = tmp_path / "tree"
    (tree / "e2calib").mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i in range(3):
        cv2.imwrite(str(tree / "e2calib" / f"{i:05d}.png"),
                    (rng.random((40, 56)) * 255).astype(np.uint8))
    got = run_both("e2v_undist", tree,
                   lambda r: ["--indir", str(r / "e2calib"), "--calib",
                              "50 51 28 20 0.05 -0.01 0.001 0",
                              "--res", "40", "56"],
                   tmp_path, monkeypatch, capsys)
    assert sum(f.startswith("e2calib_undistorted/") for f in got) == 3


def _trajectory(n, seed, noise=0.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) * 0.05
    xyz = np.stack([np.cos(t), np.sin(t), 0.1 * t], -1)
    q = np.zeros((n, 4))
    q[:, 2], q[:, 3] = np.sin(t / 4), np.cos(t / 4)
    traj = np.concatenate([xyz + noise * rng.standard_normal((n, 3)), q], 1)
    return t, traj


def test_evaluate_rpe_and_median_print_the_originals_numbers(
        tmp_path, monkeypatch, capsys):
    tree = tmp_path / "tree"
    tree.mkdir()
    t, gt = _trajectory(60, 0)
    _, est = _trajectory(60, 1, noise=0.01)
    np.savetxt(tree / "gt.txt", np.concatenate([t[:, None], gt], 1))
    np.savetxt(tree / "est.txt", np.concatenate([t[:, None], est], 1))
    run_both("evaluate_rpe", tree,
             lambda r: ["--est", str(r / "est.txt"), "--gt", str(r / "gt.txt"),
                        "--delta", "3"], tmp_path / "rpe", monkeypatch, capsys)
    rows = ["Scene ATE[cm] R_rmse[deg] MPE[%/m]"] + [
        f"seq{k % 3} {1.5 + k:.3f} {0.1 * k:.3f} {0.7 - 0.05 * k:.3f}"
        for k in range(9)]
    (tree / "res.txt").write_text(" \\\n".join(rows))
    run_both("compute_median_from_restxt", tree,
             lambda r: [str(r / "res.txt")], tmp_path / "med", monkeypatch,
             capsys)


def test_orb3_scripts_write_the_originals_files(tmp_path, monkeypatch,
                                                capsys):
    """orb3_pp_eds on an EDS sequence with undistorted images, then
    orb3_eval on the result with two ORB-SLAM3 estimates: the copied
    images, the ns stamps and ground truth, the results JSON and the
    trajectory plots."""
    seq = tmp_path / "tree" / "seq"
    (seq / "images_undistorted_calib0").mkdir(parents=True)
    n = 40
    t, gt = _trajectory(n, 0)
    np.savetxt(seq / "images_timestamps.txt", 5e6 + t * 1e6, fmt="%d")
    np.savetxt(seq / "stamped_groundtruth.txt",
               np.concatenate([t[:, None] + 5.0, gt], 1),
               header="t x y z qx qy qz qw")
    rng = np.random.default_rng(4)
    for i in range(n):
        cv2.imwrite(str(seq / "images_undistorted_calib0" / f"{i:04d}.png"),
                    (rng.random((8, 10)) * 255).astype(np.uint8))
    template = tmp_path / "orb3.yaml"
    template.write_text("Camera.fx: 500.0\nCamera.fps: 30\n")
    run_both("orb3_pp_eds", tmp_path / "tree",
             lambda r: ["--indir", str(r), "--yaml_template", str(template)],
             tmp_path / "pp", monkeypatch, capsys)

    orb3 = tmp_path / "pp" / "port" / "seq" / "ORB3_calib0"
    for k in range(2):
        _, est = _trajectory(n, 5 + k, noise=0.02)
        np.savetxt(orb3 / f"f_seq_{k}.txt",
                   np.concatenate([(5.0 + t[:, None]) * 1e9, est], 1),
                   delimiter=" ")
    got = run_both("orb3_eval", tmp_path / "pp" / "port",
                   lambda r: ["--datadir", str(r), "--evaldir",
                              str(r / "eval")], tmp_path / "ev", monkeypatch,
                   capsys)
    assert {"eval/orb3_results.json", "eval/seq_trial1.png"} <= set(got)


def test_plot_h5_writes_the_originals_frames(tmp_path, monkeypatch, capsys):
    tree = tmp_path / "tree"
    tree.mkdir()
    rng = np.random.default_rng(6)
    n = 4000
    with h5py.File(tree / "events.h5", "w") as f:
        f["events/t"] = np.sort(rng.integers(0, 150_000, n)).astype(np.int64)
        f["events/x"] = rng.integers(0, 64, n).astype(np.uint16)
        f["events/y"] = rng.integers(0, 48, n).astype(np.uint16)
        f["events/p"] = rng.integers(0, 2, n).astype(np.uint8)
    got = run_both("plot_h5", tree,
                   lambda r: ["--infile", str(r / "events.h5"), "--H", "48",
                              "--W", "64", "--max_frames", "4"],
                   tmp_path, monkeypatch, capsys)
    assert sum(f.startswith("evs_frames/") for f in got) == 4
