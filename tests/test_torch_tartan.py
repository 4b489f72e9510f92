"""The port's TartanAir-EVS dataset (devo_tpu_torch/data/tartan.py, its own
copy of devo_tpu/data/tartan.py) against devo_tpu's on a fake tree: the
same frame graph, the same clips bit for bit for one seed, the same
augmentor draws; and the readers. `make_tree` builds the fake tree that
the trainer's and the CLI's tests also read, in the converted
TartanAir-EVS layout: <env>/<difficulty>/evs_left/<traj>/h5/*.h5 with a
(5, H, W) f16 'voxel' dataset, depth_left/<traj>/depth_left/*.npy and
image_left/<traj>/pose_left.txt, one more depth and pose than voxels.
"""
import os

import numpy as np
import pytest

from devo_tpu.data import tartan as jt
from devo_tpu_torch.data import tartan as tt

TREE_HW = (64, 80)
CROP = (48, 64)


def make_tree(root, n=16, hw=TREE_HW, seed=0, env="Env", traj="P001"):
    """A fake TartanAir-EVS scene of n voxel frames under root; returns its
    evs_left scene directory. The camera moves 0.25 along NED y (camera x)
    a frame, so that neighbouring frames lie 12-13 flow units apart."""
    import h5py

    rng = np.random.default_rng(seed)
    H, W = hw
    scene = os.path.join(root, env, "Easy", "evs_left", traj)
    os.makedirs(os.path.join(scene, "h5"))
    depth_dir = os.path.join(root, env, "Easy", "depth_left", traj, "depth_left")
    os.makedirs(depth_dir)
    img = os.path.join(root, env, "Easy", "image_left", traj)
    os.makedirs(img)
    for i in range(n):
        v = rng.standard_normal((5, H, W)) * (rng.random((5, H, W)) < 0.2)
        with h5py.File(os.path.join(scene, "h5", f"{i:06d}.h5"), "w") as f:
            f.create_dataset("voxel", data=v.astype(np.float16))
    for i in range(n + 1):
        np.save(os.path.join(depth_dir, f"{i:06d}_left_depth.npy"),
                rng.uniform(5.0, 10.0, (H, W)).astype(np.float32))
    poses = np.zeros((n + 1, 7))
    poses[:, 1] = 0.25 * np.arange(n + 1)
    poses[:, 6] = 1.0
    np.savetxt(os.path.join(img, "pose_left.txt"), poses, delimiter=" ")
    return scene


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tartan"))
    make_tree(root, n=16)
    make_tree(root, n=12, seed=1, traj="P002")
    return root


def test_readers_match(tree):
    scene = os.path.join(tree, "Env", "Easy", "evs_left", "P001")
    np.testing.assert_array_equal(tt.pose_read(scene), jt.pose_read(scene))
    d = os.path.join(tree, "Env", "Easy", "depth_left", "P001", "depth_left",
                     "000003_left_depth.npy")
    np.testing.assert_array_equal(tt.depth_read(d), jt.depth_read(d))
    v = os.path.join(scene, "h5", "000002.h5")
    a = tt.voxel_read(v)
    assert a.dtype == np.float32 and a.shape == (5,) + TREE_HW
    np.testing.assert_array_equal(a, jt.voxel_read(v))
    np.testing.assert_array_equal(tt.TARTAN_INTRINSICS, jt.TARTAN_INTRINSICS)
    assert tt.DEPTH_SCALE == jt.DEPTH_SCALE
    for entry in ("abandonedfactory/abandonedfactory/Easy/P001",
                  "Env/Easy/evs_left/P001"):
        assert tt.evs_scene_dir("/r", entry) == jt.evs_scene_dir("/r", entry)


def test_dataset_clips_match_devo_tpu_bit_for_bit(tree, tmp_path):
    """One seed, two scenes: the same frame graphs and index, and the
    same five clips (voxels, poses, disparities, intrinsics) in order: the
    graph walk and the augmentor draw from one np.random.Generator as
    devo_tpu's do. The graph cache round-trips."""
    kw = dict(n_frames=5, crop_size=CROP, seed=3)
    want = jt.TartanAirEVS(tree, **kw)
    cache = str(tmp_path / "graph.pkl")
    got = tt.TartanAirEVS(tree, cache_path=cache, **kw)
    assert got.dataset_index == want.dataset_index and len(got) > 10
    for scene, info in want.scene_info.items():
        for i, (frames, dist) in info["graph"].items():
            np.testing.assert_array_equal(got.scene_info[scene]["graph"][i][0], frames)
            np.testing.assert_array_equal(got.scene_info[scene]["graph"][i][1], dist)
    for index in (0, 7, 3, len(want) - 1, 7):
        for a, b in zip(got[index], want[index]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    voxels, poses, disps, intr = got[2]
    assert voxels.shape == (5, 5) + CROP and disps.shape == (5,) + CROP
    assert poses.shape == (5, 7) and intr.shape == (5, 4)
    cached = tt.TartanAirEVS(tree, cache_path=cache, **kw)
    assert cached.dataset_index == got.dataset_index


def test_augmentor_matches_with_one_seed():
    """EVSDAugmentor: the value jitter, the 80% rescale and the centre crop
    draw as devo_tpu's from one generator seed; the outputs are its bits."""
    rng = np.random.default_rng(5)
    vox = rng.standard_normal((4, 5, 60, 70)).astype(np.float32)
    poses = rng.standard_normal((4, 7)).astype(np.float32)
    depths = rng.uniform(0.5, 2.0, (4, 60, 70)).astype(np.float32)
    intr = np.tile(np.asarray([50.0, 50.0, 35.0, 30.0], np.float32), (4, 1))
    for seed in range(6):
        a = tt.EVSDAugmentor((48, 64), np.random.default_rng(seed))
        b = jt.EVSDAugmentor((48, 64), np.random.default_rng(seed))
        for x, y in zip(a(vox, poses, depths, intr), b(vox, poses, depths, intr)):
            np.testing.assert_array_equal(x, y)


def test_flow_geometry_matches():
    rng = np.random.default_rng(1)
    poses = np.zeros((5, 7), np.float32)
    poses[:, 0] = 0.1 * np.arange(5)
    poses[:, 3:] = rng.standard_normal((5, 4)) * 0.01
    poses[:, 6] = 1.0
    disps = rng.uniform(0.3, 1.0, (5, 6, 8)).astype(np.float32)
    intr = np.asarray([20.0, 20.0, 4.0, 3.0])
    np.testing.assert_array_equal(
        tt.compute_distance_matrix_flow(poses, disps, intr),
        jt.compute_distance_matrix_flow(poses, disps, intr))
    assert tt.induced_flow_mag(poses, disps, intr, 0, 3) == \
        jt.induced_flow_mag(poses, disps, intr, 0, 3)
