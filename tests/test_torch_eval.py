"""Port parity for the evaluation entry point: devo_tpu_torch's eval harness,
trajectory metrics and pose utilities against devo_tpu's.

- eval/ate.py, eval/ate_check.py and utils/pose_utils.py are the port's own
  copies of numpy code: on the same seeded trajectories both packages give
  the same numbers to 1e-12.
- evaluate_sequence of the port on the CPU, at tests/test_eval_harness.py's
  size (64x96, 12 frames, its CFG with unquantised rings) and with weights
  carried across by jax_params_to_state_dict: the TUM dumps and the results
  JSON, one engine for two trials, a reset engine equal to a fresh one
  bitwise, a cache slot of its own for run_voxel_norm_seq, the 346-wide
  crop, `viz=True` attaching the live viewer to trial 0.
- The slice as a whole: the same voxels, weights and initial-depth draws
  (the JAX engine's key schedule, handed to the port as
  tests/test_torch_engine.py does) through devo_tpu.eval.harness.run_voxel
  and the port's, with deterministic top-k patch selection. Poses within
  atol 5e-2 (the bound of tests/test_torch_engine.py: float noise compounds
  over the 12-update initialization and the per-frame BA), the same stamps,
  and the ATE of both against the same ground truth within 10% plus 0.5 cm
  (the Sim(3) alignment rescales the pose differences).
"""
import json

import numpy as np
import pytest
import torch

from devo_tpu.eval import ate as jate
from devo_tpu.eval import ate_check as jcheck
from devo_tpu.eval import harness as jharness
from devo_tpu.utils import pose_utils as jpose
from devo_tpu_torch.eval import ate as tate
from devo_tpu_torch.eval import ate_check as tcheck
from devo_tpu_torch.eval import harness
from devo_tpu_torch.runtime.config import VOConfig
from devo_tpu_torch.runtime.engine import DEVO
from devo_tpu_torch.utils import pose_utils as tpose
from devo_tpu_torch.utils.params import jax_params_to_state_dict

from test_eval_harness import CFG as JCFG, HT, INTR, N_FRAMES, WD, _params, _voxels
from test_torch_engine import SHARED, _depth_draws

CFG = VOConfig(CORR_RING_I8=False, **{k: getattr(JCFG, k) for k in SHARED})
EXACT = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The tensors here are small: more than two intra-op threads gain
    nothing and contend with the other workers of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shared():
    params = _params()
    return {"params": params, "weights": jax_params_to_state_dict(params),
            "engine_cache": {}}


def _trajectory(rng, n, step=0.1):
    p = np.cumsum(step * rng.standard_normal((n, 3)), 0)
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([p, q], 1)


def _straight_gt(n, step):
    gt = np.zeros((n, 7), np.float32)
    gt[:, 0] = step * np.arange(n)
    gt[:, 6] = 1.0
    return gt


def _iterator(vox):
    return iter([(v, INTR, float(t)) for t, v in enumerate(vox)])


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ate_matches_devo_tpu(seed):
    rng = np.random.default_rng(seed)
    n = 60
    gt = _trajectory(rng, n)
    est = gt.copy()
    est[:, :3] = 1.7 * est[:, :3] + 0.02 * rng.standard_normal((n, 3)) + 3.0
    tss_gt = np.arange(n) * 0.1
    tss_est = tss_gt + 0.01 * rng.random(n)
    for kw in (dict(), dict(correct_scale=False), dict(max_diff=0.005)):
        a = tate.ate_real(est, tss_est, gt, tss_gt, **kw)
        b = jate.ate_real(est, tss_est, gt, tss_gt, **kw)
        for name in ("ate", "mpe", "r_rmse", "scale", "n_pairs"):
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       err_msg=name, **EXACT)
    np.testing.assert_allclose(tate.quat_to_rot(gt[:, 3:]),
                               jate.quat_to_rot(gt[:, 3:]), **EXACT)
    np.testing.assert_array_equal(tate.associate(tss_est, tss_gt, 0.005)[0],
                                  jate.associate(tss_est, tss_gt, 0.005)[0])
    for x, y in zip(tate.umeyama_alignment(est[:, :3], gt[:, :3]),
                    jate.umeyama_alignment(est[:, :3], gt[:, :3])):
        np.testing.assert_allclose(x, y, **EXACT)
    for x, y in zip(tate.rpe(est, tss_est, gt, tss_gt, delta=5),
                    jate.rpe(est, tss_est, gt, tss_gt, delta=5)):
        np.testing.assert_allclose(x, y, **EXACT)
    np.testing.assert_allclose(
        tcheck.ate_horn(est, tss_est, gt, tss_gt),
        jcheck.ate_horn(est, tss_est, gt, tss_gt), **EXACT)
    m = tate.ate_real(est, tss_est, gt, tss_gt)
    np.testing.assert_allclose(
        tcheck.cross_check_ate(m, est, tss_est, gt, tss_gt),
        jcheck.cross_check_ate(m, est, tss_est, gt, tss_gt), **EXACT)
    with pytest.raises(AssertionError, match="cross-check"):
        tcheck.cross_check_ate(tate.TrajectoryMetrics(
            ate=m.ate * 2 + 1, mpe=m.mpe, r_rmse=m.r_rmse, scale=m.scale,
            n_pairs=m.n_pairs), est, tss_est, gt, tss_gt)


def test_result_aggregation_matches_devo_tpu(tmp_path):
    rng = np.random.default_rng(5)
    trials = [tate.TrajectoryMetrics(*rng.random(4), 10) for _ in range(5)]
    med_t, ate_t = tate.compute_median_results(trials)
    med_j, ate_j = jate.compute_median_results(
        [jate.TrajectoryMetrics(t.ate, t.mpe, t.r_rmse, t.scale, t.n_pairs)
         for t in trials])
    assert (med_t.ate, med_t.mpe, med_t.r_rmse) == (med_j.ate, med_j.mpe,
                                                    med_j.r_rmse)
    assert ate_t == ate_j
    per_scene = {"a": [1.0, 2.0, 30.0], "b/c": [0.5, 0.7, 0.6]}
    out_t = tate.aggregate_results(per_scene, "eds", outfolder=str(tmp_path / "t"))
    out_j = jate.aggregate_results(per_scene, "eds", outfolder=str(tmp_path / "j"))
    assert out_t == out_j
    assert tate.compute_auc([1.0, 5.0, 50.0]) == jate.compute_auc([1.0, 5.0, 50.0])


def test_pose_utils_match_devo_tpu():
    rng = np.random.default_rng(7)
    traj = _trajectory(rng, 30)
    tss = np.sort(rng.random(30)) * 10
    query = np.sort(rng.random(50)) * 9 + 0.5
    np.testing.assert_allclose(tpose.interpolate_traj_at_tss(tss, traj, query),
                               jpose.interpolate_traj_at_tss(tss, traj, query),
                               **EXACT)
    hom = tpose.poses_quat_to_hom(traj)
    np.testing.assert_allclose(hom, jpose.poses_quat_to_hom(traj), **EXACT)
    np.testing.assert_allclose(tpose.poses_hom_to_quat(hom),
                               jpose.poses_hom_to_quat(hom), **EXACT)
    tau = rng.random(29)
    for k in range(29):
        np.testing.assert_allclose(
            tpose.quat_slerp(traj[k, 3:], traj[k + 1, 3:], tau[k]),
            jpose.quat_slerp(traj[k, 3:], traj[k + 1, 3:], tau[k]), **EXACT)
    vox = rng.standard_normal((4, 5, 16, 24)).astype(np.float32)
    disp = rng.random((4, 16, 24)).astype(np.float32)
    intr = np.asarray([[20.0, 20.0, 12.0, 8.0]] * 4, np.float32)
    for a, b in zip(tpose.transform_rescale(0.5, vox, disp, traj[:4], intr),
                    jpose.transform_rescale(0.5, vox, disp, traj[:4], intr)):
        np.testing.assert_allclose(a, b, **EXACT)


# ---------------------------------------------------------------- harness

def test_evaluate_sequence_artifacts(tmp_path, shared):
    vox = _voxels()
    gt = _straight_gt(N_FRAMES, 0.05)
    tss = np.arange(N_FRAMES, dtype=np.float64)
    med, results, fps = harness.evaluate_sequence(
        CFG, shared["weights"], lambda: _iterator(vox), traj_gt=gt,
        tss_gt=tss, trials=2, ht=HT, wd=WD, max_diff_s=0.5,
        outdir=str(tmp_path), name="synt",
        engine_cache=shared["engine_cache"], device="cpu")

    assert len(results) == 2 and len(fps) == 2
    assert np.isfinite([med.ate, med.mpe, med.r_rmse]).all()
    assert len(shared["engine_cache"]) == 1      # one engine for both trials
    for trial in range(2):
        dump = np.loadtxt(tmp_path / f"synt_trial{trial}.txt")
        assert dump.shape == (N_FRAMES, 8)
        assert (np.diff(dump[:, 0]) > 0).all()
    blob = json.loads((tmp_path / "synt_results.json").read_text())
    assert {"median", "trials", "fps"} <= set(blob)
    assert blob["median"]["ate"] == pytest.approx(med.ate)
    assert len(blob["trials"]) == 2


def test_reset_engine_equals_a_fresh_engine(shared):
    """Trial 1 on the cached (reset) engine, after trial 0 and whatever ran
    before it, against a fresh engine with the same seed: bitwise."""
    vox = _voxels()
    cache = shared["engine_cache"]
    harness.run_voxel(CFG, shared["weights"], _iterator(vox), HT, WD, seed=0,
                      engine_cache=cache, device="cpu")
    reused = harness.run_voxel(CFG, shared["weights"], _iterator(vox), HT, WD,
                               seed=1, engine_cache=cache, device="cpu")
    fresh = harness.run_voxel(CFG, shared["weights"], _iterator(vox), HT, WD,
                              seed=1, device="cpu")
    assert len(cache) == 1
    np.testing.assert_array_equal(reused[0], fresh[0])
    np.testing.assert_array_equal(reused[1], fresh[1])
    slam = next(iter(cache.values()))
    assert slam.counter == N_FRAMES and len(slam.aux_log) == N_FRAMES
    slam.reset(seed=3)
    assert (slam.n, slam.counter, slam.n_edges, slam.aux_log) == (0, 0, 0, [])
    assert not slam.initialized and not slam.fmap1.any()
    assert slam.generator.initial_seed() == 3


def test_reset_loads_new_weights(shared):
    slam = DEVO(CFG, shared["weights"], ht=HT, wd=WD, device="cpu")
    other = {k: v + 1.0 for k, v in shared["weights"].items()}
    slam.reset(seed=0, weights=other)
    for k, v in slam.net.state_dict().items():
        assert torch.equal(v, other[k].to(v.dtype)), k


def test_run_voxel_norm_seq_gets_its_own_cache_slot(shared):
    vox = _voxels()
    cache = shared["engine_cache"]
    before = len(cache)
    poses, tss, fps = harness.run_voxel_norm_seq(
        CFG, shared["weights"], _iterator(vox), HT, WD, N_norm=6,
        engine_cache=cache, device="cpu")
    assert poses.shape == (N_FRAMES, 7) and np.isfinite(poses).all()
    assert len(cache) == before + 1
    assert any(k[2].NORM == "none" for k in cache)


def test_run_voxel_crops_346_wide_input(shared):
    rng = np.random.default_rng(2)
    vox = [(rng.standard_normal((5, HT, 346)) *
            (rng.random((5, HT, 346)) < 0.2)).astype(np.float32)
           for _ in range(3)]
    cache = {}
    poses, tss, _ = harness.run_voxel(CFG, shared["weights"], _iterator(vox),
                                      HT, 346, engine_cache=cache,
                                      device="cpu", final_updates=0)
    (key, slam), = cache.items()
    assert key[:2] == (HT, 344) and key[3] == "cpu"
    assert slam.fmap1.shape[1:3] == (HT // 4, 86)
    assert poses.shape == (3, 7)


def test_harness_refuses_what_is_not_ported(shared, tmp_path):
    """`viz=True` (the viewer, once unported) attaches the live viewer to
    trial 0 alone: it renders into <outdir>/viz_<name>, and terminate()
    detaches it. An empty iterator and a missing card still raise."""
    cache = shared["engine_cache"]
    harness.evaluate_sequence(
        CFG, shared["weights"], lambda: _iterator(_voxels()),
        traj_gt=_straight_gt(N_FRAMES, 0.05),
        tss_gt=np.arange(N_FRAMES, dtype=np.float64), trials=2, ht=HT,
        wd=WD, max_diff_s=0.5, outdir=str(tmp_path), name="v", viz=True,
        engine_cache=cache, device="cpu")
    assert [p.name for p in tmp_path.glob("viz_*")] == ["viz_v"]
    assert list((tmp_path / "viz_v").glob("frame_*.png"))
    assert all(slam.viewer is None for slam in cache.values())
    with pytest.raises(RuntimeError, match="empty iterator"):
        harness.run_voxel(CFG, shared["weights"], iter([]), HT, WD,
                          device="cpu")
    if not torch.cuda.is_available():    # no silent fallback to the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            harness.run_voxel(CFG, shared["weights"], _iterator(_voxels(1)),
                              HT, WD)


# ------------------------------------------------- the slice against devo_tpu

def test_run_voxel_matches_devo_tpu(shared, monkeypatch):
    # the lossless wire: devo_tpu quantises voxels to int8 on their way to
    # the device by default, the port has no such transport
    jcfg = JCFG.replace(SCORER_EVAL_MODE="topk", VOXEL_WIRE="f32")
    cfg = CFG.replace(SCORER_EVAL_MODE="topk")
    vox = _voxels()
    draws = iter(_depth_draws(N_FRAMES, cfg.M, seed=0))
    monkeypatch.setattr(
        DEVO, "_draw_depth",
        lambda self: torch.from_numpy(np.array(next(draws))))

    poses_j, tss_j, _ = jharness.run_voxel(jcfg, shared["params"],
                                           _iterator(vox), HT, WD, seed=0)
    poses_t, tss_t, _ = harness.run_voxel(cfg, shared["weights"],
                                          _iterator(vox), HT, WD, seed=0,
                                          device="cpu")
    np.testing.assert_array_equal(tss_t, tss_j)
    assert poses_t.shape == poses_j.shape == (N_FRAMES, 7)
    np.testing.assert_allclose(poses_t, poses_j, atol=5e-2)

    gt = _straight_gt(N_FRAMES, 0.05)
    tss_gt = np.arange(N_FRAMES, dtype=np.float64)
    m_t = tate.ate_real(poses_t, tss_t, gt, tss_gt, max_diff=0.5)
    m_j = jate.ate_real(poses_j, tss_j, gt, tss_gt, max_diff=0.5)
    assert m_t.n_pairs == m_j.n_pairs == N_FRAMES
    np.testing.assert_allclose(m_t.ate, m_j.ate, rtol=0.1, atol=0.5)
