"""Port parity for the host-side data path: devo_tpu_torch/data's own copies
of event_utils.py, loaders.py and benchmarks.py against devo_tpu/data's on
the same seeded events and the same synthetic EDS-format sequence (raw
events.h5, a rectify map, image stamps and a stamped ground truth, as
tests/test_eval_harness.py builds it, smaller). They are the same numpy
code, so voxels, intrinsics and stamps must be identical, not close.
"""
import numpy as np
import pytest

from devo_tpu.data import benchmarks as jbench
from devo_tpu.data import event_utils as jev
from devo_tpu.data import loaders as jload
from devo_tpu_torch.data import benchmarks as tbench
from devo_tpu_torch.data import event_utils as tev
from devo_tpu_torch.data import loaders as tload

H, W = 480, 640


def _events(rng, n, t_end_us):
    t = np.sort(rng.integers(0, t_end_us, n)).astype(np.int64)
    x = rng.integers(0, W, n).astype(np.uint16)
    y = rng.integers(0, H, n).astype(np.uint16)
    p = (rng.integers(0, 2, n) * 2 - 1).astype(np.int8)
    return t, x, y, p


@pytest.fixture(scope="module")
def eds_scene(tmp_path_factory):
    """A 6-image EDS-format scene directory."""
    import h5py

    d = tmp_path_factory.mktemp("eds_scene")
    n_imgs, dt_us = 6, 33_000
    rng = np.random.default_rng(3)
    t, x, y, p = _events(rng, 400_000, n_imgs * dt_us + 20_000)
    with h5py.File(d / "events.h5", "w") as f:
        f.create_dataset("events/t", data=t)
        f.create_dataset("events/x", data=x)
        f.create_dataset("events/y", data=y)
        f.create_dataset("events/p", data=p)
        f.create_dataset("ms_to_idx", data=jev.compute_ms_to_idx(t))
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    with h5py.File(d / "rectify_map_calib0.h5", "w") as f:
        f.create_dataset("rectify_map", data=np.stack([gx, gy], -1))
    tss_us = np.arange(n_imgs, dtype=np.float64) * dt_us + 4_000
    np.savetxt(d / "images_timestamps_us.txt", tss_us)
    gt = np.zeros((n_imgs, 8))
    gt[:, 0] = tss_us
    gt[:, 1] = 0.03 * np.arange(n_imgs)
    gt[:, 7] = 1.0
    np.savetxt(d / "stamped_groundtruth_us.txt", gt, header="t x y z qx qy qz qw")
    return str(d), n_imgs


def _same_stream(a, b, n_min):
    a, b = list(a), list(b)
    assert len(a) == len(b) >= n_min
    for (va, ia, ta), (vb, ib, tb) in zip(a, b):
        assert va.dtype == vb.dtype and va.shape == vb.shape
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(ia, ib)
        assert ta == tb
    return a


@pytest.mark.parametrize("size", [(H, W), (64, 96)], ids=["native", "resized"])
def test_eds_iterator_matches_devo_tpu(eds_scene, size):
    d, n_imgs = eds_scene
    frames = _same_stream(tbench.eds_evs_iterator(d, H=size[0], W=size[1]),
                          jbench.eds_evs_iterator(d, H=size[0], W=size[1]),
                          n_imgs - 2)
    vox, intr, ts = frames[0]
    assert vox.shape == (5,) + size and vox.dtype == np.float32
    assert np.isfinite(vox).all() and np.abs(vox).sum() > 0
    assert intr.shape == (4,)


def test_benchmark_dispatch_and_gt_match_devo_tpu(eds_scene):
    d, n_imgs = eds_scene
    _same_stream(tbench.benchmark_evs_iterator("eds", d, stride=2),
                 jbench.benchmark_evs_iterator("eds", d, stride=2), 2)
    (tss_t, traj_t), (tss_j, traj_j) = (tbench.load_benchmark_gt("eds", d),
                                        jbench.load_benchmark_gt("eds", d))
    np.testing.assert_array_equal(tss_t, tss_j)
    np.testing.assert_array_equal(traj_t, traj_j)
    assert traj_t.shape == (n_imgs, 7)
    with pytest.raises(FileNotFoundError):
        tbench.load_benchmark_gt("eds", d + "/nowhere")
    assert set(tbench.ITERATORS) == set(jbench.ITERATORS)
    assert tbench.EDS_INTRINSICS.keys() == jbench.EDS_INTRINSICS.keys()


def test_benchmark_resolutions_match_devo_tpu():
    assert tload.BENCHMARK_RES == jload.BENCHMARK_RES


@pytest.mark.parametrize("seed", [0, 1])
def test_voxel_grid_and_hot_pixels_match_devo_tpu(seed):
    rng = np.random.default_rng(seed)
    t, x, y, p = _events(rng, 50_000, 40_000)
    xf = x.astype(np.float32) + rng.random(len(x)).astype(np.float32) * 0.5
    yf = y.astype(np.float32) * 0.99
    got = tev.to_voxel_grid(xf, yf, t, p, H, W, nb_of_time_bins=5)
    want = jev.to_voxel_grid(xf, yf, t, p, H, W, nb_of_time_bins=5)
    assert got.shape == (5, H, W)
    np.testing.assert_array_equal(got, want)
    hot = got.copy()
    hot[:, 7, 9] = 500.0
    np.testing.assert_array_equal(tev.remove_hot_pixels_voxel(hot.copy(), 10.0),
                                  jev.remove_hot_pixels_voxel(hot.copy(), 10.0))
    assert not tev.remove_hot_pixels_voxel(hot.copy(), 10.0)[:, 7, 9].any()
    np.testing.assert_array_equal(tev.compute_ms_to_idx(t),
                                  jev.compute_ms_to_idx(t))


def test_event_slicer_matches_devo_tpu(eds_scene):
    import h5py

    d, _ = eds_scene
    with h5py.File(d + "/events.h5", "r") as fa, \
            h5py.File(d + "/events.h5", "r") as fb:
        a, b = tev.EventSlicer(fa), jev.EventSlicer(fb)
        assert a.get_start_time_us() == b.get_start_time_us()
        assert a.get_final_time_us() == b.get_final_time_us()
        for t0, t1 in ((4_000, 20_500), (37_000, 53_500), (0, 1_000)):
            ea, eb = a.get_events(t0, t1), b.get_events(t0, t1)
            assert (ea is None) == (eb is None)
            if ea is not None:
                assert ea.keys() == eb.keys()
                for k in ea:
                    np.testing.assert_array_equal(ea[k], eb[k])
