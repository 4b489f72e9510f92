"""Port parity for the last host-side data modules: devo_tpu_torch's own
copies of devo_tpu/data/calibs.py, preprocess.py, esim.py, rgbd.py and
stream.py and of devo_tpu/native, each against devo_tpu's on the same
seeded inputs (the inputs of tests/test_preprocess.py, test_convert_tartan.py,
test_augment.py, test_stream.py and test_native.py).

Tolerance: none. These are NumPy / OpenCV / C++ code on the host, the same
operations in the same order, so every array, file and number is compared
bit for bit, but the native voxelizer against the NumPy splat, which is held
to test_native.py's 1e-3 (float32 accumulation in another order).
"""
import json
import os
import time

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")
yaml = pytest.importorskip("yaml")

from devo_tpu import native as jnative
from devo_tpu.data import calibs as jcalibs
from devo_tpu.data import esim as jesim
from devo_tpu.data import event_utils as jeu
from devo_tpu.data import preprocess as jpre
from devo_tpu.data import rgbd as jrgbd
from devo_tpu.data import stream as jstream
from devo_tpu_torch import native
from devo_tpu_torch.data import calibs, esim, preprocess, rgbd, stream
from devo_tpu_torch.data import event_utils as eu


def _same_calib(a, b):
    for f in ("fx", "fy", "cx", "cy", "dist", "model", "policy", "size"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.K, b.K)
    np.testing.assert_array_equal(a.dist_np, b.dist_np)


# ------------------------------------------------------------------ calibs

def test_calibration_registries_match():
    for name in ("EDS", "HKU", "RPG_180x240"):
        ours, theirs = getattr(calibs, name), getattr(jcalibs, name)
        assert set(ours) == set(theirs), name
        for key in ours:
            _same_calib(ours[key], theirs[key])
    for name in ("HKU_T_CAM0_CAM1", "HKU_T_MARKER_CAM0"):
        np.testing.assert_array_equal(getattr(calibs, name),
                                      getattr(jcalibs, name))


def _calib_files(d):
    """tests/test_preprocess.py's calibration files of every reader."""
    tumvie = d / "camera-calibrationA.json"
    tumvie.write_text(json.dumps({"value0": {
        "intrinsics": [
            {"intrinsics": dict(fx=900.0 + i, fy=901.0 + i, cx=512.0,
                                cy=384.0, k1=0.01, k2=-0.02, k3=0.003,
                                k4=-0.001)} for i in range(4)],
        "resolution": [[1024, 768]] * 2 + [[1280, 720]] * 2}}))
    chain = {"cam0": {"intrinsics": [223.9, 223.6, 170.7, 128.2],
                      "distortion_coeffs": [-0.048, 0.011, -0.022, 0.009],
                      "resolution": [346, 260],
                      "T_cam_imu": np.eye(4).tolist()},
             "cam1": {"intrinsics": [223.1, 222.9, 170.1, 129.5],
                      "distortion_coeffs": [-0.049, 0.012, -0.023, 0.010],
                      "resolution": [346, 260]}}
    camchain = d / "camchain-imucam-indoor_flying.yaml"
    camchain.write_text(yaml.safe_dump(chain))
    vec = d / "left_event_camera_intrinsic_results.yaml"
    vec.write_text(yaml.safe_dump({
        "camera_matrix": {"data": [886.2, 0, 610.5, 0, 886.6, 514.4, 0, 0, 1]},
        "distortion_coefficients": {"data": [-0.14, 0.09, 0.0004, 0.0002]},
        "image_height": 480, "image_width": 640}))
    ecd = d / "calib.txt"
    np.savetxt(ecd, [[199.0, 198.0, 132.0, 110.0, -0.368, 0.150, -0.0007,
                      -0.0005, 0.0]])
    user = d / "user.json"
    user.write_text(json.dumps({"K": [[500, 0, 320], [0, 501, 240], [0, 0, 1]],
                                "dist": [0.1, -0.05, 0.001, 0.0]}))
    return dict(tumvie=str(tumvie), camchain=str(camchain), vec=str(vec),
                ecd=str(ecd), user=str(user))


def test_calibration_readers_match(tmp_path):
    f = _calib_files(tmp_path)
    calls = [
        ("read_tumvie_calib", (f["tumvie"], 2), {}),
        ("read_tumvie_calib", (f["tumvie"], 0), {"for_images": True}),
        ("read_mvsec_camchain", (f["camchain"], "left"), {}),
        ("read_mvsec_camchain", (f["camchain"], "right"), {}),
        ("read_vector_calib", (f["vec"],), {}),
        ("read_vector_calib", (f["vec"],), {"size": (1024, 1224)}),
        ("read_ecd_calib", (f["ecd"],), {}),
        ("read_fpv_calib", (f["camchain"],), {}),
        ("from_user_json", (f["user"],), {"default_size": (260, 346)}),
    ]
    for name, args, kw in calls:
        _same_calib(getattr(calibs, name)(*args, **kw),
                    getattr(jcalibs, name)(*args, **kw))
    np.testing.assert_array_equal(calibs.read_fpv_T_cam_imu(f["camchain"]),
                                  jcalibs.read_fpv_T_cam_imu(f["camchain"]))


# -------------------------------------------------------------- preprocess

def test_undistortion_maps_match():
    for cam in (calibs.EDS[("calib0", "evs")], calibs.HKU["left"],
                calibs.RPG_180x240["right"],
                calibs.CamCalib(223.9, 223.6, 170.7, 128.2,
                                (-0.048, 0.011, -0.022, 0.009),
                                model="fisheye", policy="balance05",
                                size=(260, 346))):
        H, W = cam.size
        for policy in (cam.policy, "keep"):
            Kn = preprocess.new_camera_matrix(cam.K, cam.dist_np, H, W,
                                              cam.model, policy)
            np.testing.assert_array_equal(Kn, jpre.new_camera_matrix(
                cam.K, cam.dist_np, H, W, cam.model, policy))
            np.testing.assert_array_equal(
                preprocess.compute_rectify_map(
                    cam.K, cam.dist_np, H, W, K_new=Kn,
                    fisheye=cam.model == "fisheye"),
                jpre.compute_rectify_map(cam.K, cam.dist_np, H, W, K_new=Kn,
                                         fisheye=cam.model == "fisheye"))


def make_sequence(seq, t0=5_000_000, size=(48, 64)):
    """tests/test_preprocess.py's synthetic sequence at `size`."""
    (seq / "images").mkdir(parents=True)
    with h5py.File(seq / "events.h5", "w") as f:
        f["t"] = np.arange(t0, t0 + 100_000, 100, np.int64)
    gt = np.zeros((10, 8))
    gt[:, 0] = (t0 + np.arange(10) * 1e4) / 1e6
    gt[:, 1] = np.arange(10) * 0.1
    gt[:, 7] = 1.0
    np.savetxt(seq / "stamped_groundtruth.txt", gt)
    np.savetxt(seq / "images_timestamps.txt", t0 + np.arange(5) * 2e4,
               fmt="%d")
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(seq / "images" / f"frame_{i:04d}.png"),
                    (rng.random(size) * 255).astype(np.uint8))


def assert_same_tree(a, b):
    """Every file under `a` and `b` the same: h5 files dataset by dataset,
    the others byte for byte."""
    fa = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
    fb = sorted(str(p.relative_to(b)) for p in b.rglob("*") if p.is_file())
    assert fa == fb
    for rel in fa:
        pa, pb = a / rel, b / rel
        if rel.endswith(".h5"):
            with h5py.File(pa, "r") as x, h5py.File(pb, "r") as y:
                names = []
                x.visit(names.append)
                yn = []
                y.visit(yn.append)
                assert names == yn, rel
                for n in names:
                    if isinstance(x[n], h5py.Dataset):
                        np.testing.assert_array_equal(x[n][()], y[n][()],
                                                      err_msg=f"{rel}:{n}")
        else:
            assert pa.read_bytes() == pb.read_bytes(), rel
    return fa


def test_preprocess_with_calib_writes_devo_tpus_files(tmp_path):
    a, b = tmp_path / "port", tmp_path / "jax"
    make_sequence(a)
    make_sequence(b)
    user = tmp_path / "c.json"
    user.write_text(json.dumps({"K": [60.0, 61.0, 32.0, 24.0],
                                "dist": [0.05, -0.01, 0.001, 0.0],
                                "size": [48, 64]}))
    for root, mod, cal in ((a, preprocess, calibs), (b, jpre, jcalibs)):
        cam = cal.from_user_json(str(user))
        assert mod.preprocess_with_calib(str(root), cam, suffix="_c",
                                         images_dir="images",
                                         img_calib=cam) == 5_000_000
        mod.write_camera_frame_gt(str(root / "stamped_groundtruth_us.txt"),
                                  str(root / "gt_cam.txt"),
                                  np.diag([1.0, -1.0, -1.0, 1.0]))
    files = assert_same_tree(a, b)
    assert {"rectify_map_c.h5", "calib_undist_c.txt", "t_offset_us.txt",
            "gt_cam.txt"} <= set(files)


# -------------------------------------------------------------------- esim

def _bar_frames(n=3, h=24, w=96, step=24):
    """tests/test_convert_tartan.py's moving bar."""
    for i in range(n):
        img = np.full((h, w), 0.2, np.float32)
        img[:, i * step:i * step + 8] = 0.9
        yield img, i * 1e4


@pytest.mark.parametrize("upsample,mode", [(1, "flow"), (4, "flow"),
                                           (4, "linear")])
def test_esim_sequence_matches(upsample, mode):
    got = list(esim.simulate_sequence(_bar_frames(), seed=3,
                                      upsample=upsample, upsample_mode=mode))
    want = list(jesim.simulate_sequence(_bar_frames(), seed=3,
                                        upsample=upsample, upsample_mode=mode))
    assert len(got) == len(want) == 2
    for (v, t), (wv, wt) in zip(got, want):
        assert t == wt
        np.testing.assert_array_equal(v, wv)


# -------------------------------------------------------------------- rgbd

def test_rgbd_augmentor_matches():
    rng = np.random.default_rng(0)
    images = (rng.random((4, 60, 80, 3)) * 255).astype(np.float32)
    depths = rng.uniform(1, 5, (4, 60, 80)).astype(np.float32)
    intr = np.tile(np.asarray([50.0, 50.0, 40.0, 30.0], np.float32), (4, 1))
    poses = np.zeros((4, 7), np.float32)
    for seed in range(6):
        got = rgbd.RGBDAugmentor((48, 64), np.random.default_rng(seed))(
            images, poses, depths, intr)
        want = jrgbd.RGBDAugmentor((48, 64), np.random.default_rng(seed))(
            images, poses, depths, intr)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _rgb_tree(root, n=10, h=48, w=64):
    """A TartanAir RGB scene: image_left/P001/{imgs/*.png, pose_left.txt}
    and depth_left/P001/depth_left/*.npy."""
    img_dir = root / "Env" / "Easy" / "image_left" / "P001"
    dep_dir = root / "Env" / "Easy" / "depth_left" / "P001" / "depth_left"
    (img_dir / "imgs").mkdir(parents=True)
    dep_dir.mkdir(parents=True)
    rng = np.random.default_rng(1)
    poses = []
    for i in range(n):
        cv2.imwrite(str(img_dir / "imgs" / f"{i:06d}.png"),
                    (rng.random((h, w, 3)) * 255).astype(np.uint8))
        np.save(dep_dir / f"{i:06d}_left_depth.npy",
                rng.uniform(2, 6, (h, w)).astype(np.float32))
        poses.append([0.05 * i, 0.01 * i, 0.0, 0.0, 0.0, 0.0, 1.0])
    np.savetxt(img_dir / "pose_left.txt", np.asarray(poses))


def test_tartan_rgb_clips_match(tmp_path):
    _rgb_tree(tmp_path)
    kw = dict(n_frames=4, fmin=0.0, fmax=1e9, crop_size=(32, 48))
    ours = rgbd.TartanAirRGB(str(tmp_path), seed=5, **kw)
    theirs = jrgbd.TartanAirRGB(str(tmp_path), seed=5, **kw)
    assert len(ours) == len(theirs) > 0
    for i in range(3):
        for g, w in zip(ours[i], theirs[i]):
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ stream

def test_buffered_matches_and_propagates_errors():
    assert list(stream.buffered(iter(range(20)), maxsize=4)) == list(range(20))

    def bad():
        yield 1
        raise OSError("corrupt h5 mid-sequence")

    it = stream.buffered(bad(), maxsize=2)
    assert next(it) == 1
    with pytest.raises(OSError, match="corrupt h5"):
        next(it)


def test_buffered_consumer_early_exit_releases_producer():
    produced = []

    def src():
        for i in range(1000):
            produced.append(i)
            yield i

    it = stream.buffered(src(), maxsize=2)
    assert next(it) == 0
    it.close()
    time.sleep(0.6)                 # > the producer's put timeout
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n < 1000


def test_image_and_video_streams_match(tmp_path):
    rng = np.random.default_rng(2)
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(5):
        cv2.imwrite(str(d / f"{i:03d}.png"),
                    (rng.random((40, 60, 3)) * 255).astype(np.uint8))
    calib = np.asarray([50.0, 51.0, 30.0, 20.0, 0.01, -0.01, 0.0, 0.0])
    for kw in (dict(stride=2), dict(skip=1)):
        got = list(stream.image_stream(str(d), calib, **kw))
        want = list(jstream.image_stream(str(d), calib, **kw))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    video = tmp_path / "v.avi"
    wr = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                         (60, 40))
    for i in range(6):
        wr.write((rng.random((40, 60, 3)) * 255).astype(np.uint8))
    wr.release()
    got = list(stream.video_stream(str(video), calib, stride=2))
    want = list(jstream.video_stream(str(video), calib, stride=2))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------------ native

def _events(n=5000, H=60, W=80, seed=0):
    """tests/test_native.py's events."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, W + 1, n).astype(np.float32)
    y = rng.uniform(-1, H + 1, n).astype(np.float32)
    t = np.sort(rng.integers(0, 100_000, n)).astype(np.int64)
    p = rng.choice([-1, 1], n).astype(np.int8)
    return x, y, t, p


def test_native_is_built_into_the_build_directory():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    libs = list(native.BUILD_DIR.glob("libdevo_voxelizer_*.so"))
    assert libs and not (native._SRC.parent / "_voxelizer.so").exists()


def test_native_matches_devo_tpus_native_and_numpy():
    if not jnative.available():
        pytest.skip("devo_tpu's native library does not build here")
    H, W = 60, 80
    x, y, t, p = _events(H=H, W=W, seed=1)
    got = native.to_voxel_grid(x, y, t, p, H, W, 5)
    np.testing.assert_array_equal(got, jnative.to_voxel_grid(x, y, t, p, H,
                                                             W, 5))
    np.testing.assert_allclose(got, eu.to_voxel_grid(x, y, t, p, H, W, 5),
                               atol=1e-3, rtol=1e-3)
    rng = np.random.default_rng(2)
    rmap = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).astype(np.float32)
    rmap += rng.normal(0, 0.5, rmap.shape).astype(np.float32)
    xi = rng.integers(0, W, 3000).astype(np.float32)
    yi = rng.integers(0, H, 3000).astype(np.float32)
    ti = np.sort(rng.integers(0, 50_000, 3000)).astype(np.int64)
    pi = rng.choice([-1, 1], 3000).astype(np.int8)
    got = native.to_voxel_grid(xi, yi, ti, pi, H, W, 5, rectify_map=rmap)
    np.testing.assert_array_equal(got, jnative.to_voxel_grid(
        xi, yi, ti, pi, H, W, 5, rectify_map=rmap))
    np.testing.assert_allclose(got, eu.to_voxel_grid(
        xi, yi, ti, pi, H, W, 5, rectify_map=rmap), atol=1e-3, rtol=1e-3)

    np.testing.assert_array_equal(native.compute_ms_to_idx(t),
                                  jnative.compute_ms_to_idx(t))
    np.testing.assert_array_equal(native.compute_ms_to_idx(t),
                                  jeu.compute_ms_to_idx(t))
    v = (rng.standard_normal((32, 40, 5))
         * (rng.random((32, 40, 5)) < 0.2)).astype(np.float32)
    q, s = native.quantize_i8(v)
    jq, js = jnative.quantize_i8(v)
    np.testing.assert_array_equal(q, jq)
    assert s == js
    vox = np.zeros((5, 20, 20), np.float32)
    vox[:, 5, 5] = 100.0
    vox[:, 1, 1] = 0.1
    out = native.remove_hot_pixels(vox, 3.0)
    np.testing.assert_array_equal(out, jnative.remove_hot_pixels(vox, 3.0))
    assert out[:, 5, 5].sum() == 0.0 and vox[:, 5, 5].sum() == 500.0


def test_native_refuses_what_its_c_code_would_read_past():
    x, y, t, p = _events(n=10)
    with pytest.raises(ValueError, match="one length"):
        native.to_voxel_grid(x, y[:5], t, p, 60, 80)
    with pytest.raises(ValueError, match="rectify_map"):
        native.to_voxel_grid(x, y, t, p, 60, 80,
                             rectify_map=np.zeros((30, 80, 2), np.float32))
    with pytest.raises(ValueError, match="voxel"):
        native.remove_hot_pixels(np.zeros((20, 20), np.float32))


def test_native_falls_back_to_numpy_with_its_reason(monkeypatch):
    """A failed build leaves the NumPy path, says why, and is not
    retried."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "g++ exited 1: no compiler")
    assert not native.available()
    assert native.build_error() == "g++ exited 1: no compiler"
    x, y, t, p = _events(seed=4)
    np.testing.assert_array_equal(native.to_voxel_grid(x, y, t, p, 60, 80),
                                  eu.to_voxel_grid(x, y, t, p, 60, 80))
    q, s = native.quantize_i8(np.asarray([0.5, -1.0], np.float32))
    assert s == 1.0 / 127.0 and q.tolist() == [64, -127]
