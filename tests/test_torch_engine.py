"""Port parity for the whole tracking slice: devo_tpu_torch's DEVO against
devo_tpu's DEVO over the same frames, with the same weights and the same
random draws.

The configuration and frames are those of tests/test_engine_golden.py, with
the deterministic top-k patch selection. The only random draws left are the
initial depths: the test reproduces the JAX engine's key schedule (one
split per call, engine.py:695; the depth draw from fold_in(key_sel, 1),
engine.py:634-635) and hands those draws to the port. Per frame, the
keyframe count and the (kk, jj) edge set must be equal and the poses within
atol 5e-2: the same bound as the golden test, since float noise compounds
over the 12-update initialization and the per-frame BA.
"""
import dataclasses

import numpy as np
import torch

import jax

from devo_tpu.runtime import config as jconfig
from devo_tpu.runtime.engine import DEVO as JDEVO
from devo_tpu_torch.ops import corr as corr_plain
from devo_tpu_torch.ops import corr_cuda
from devo_tpu_torch.runtime import config as tconfig
from devo_tpu_torch.runtime.config import VOConfig
from devo_tpu_torch.runtime.engine import DEVO
from devo_tpu_torch.utils.params import jax_params_to_state_dict

from test_engine_golden import CFG as GOLDEN_CFG, HT, WD, make_frames, make_params

N_FRAMES = 18
SEED = 0
JCFG = GOLDEN_CFG.replace(SCORER_EVAL_MODE="topk")
SHARED = ("BUFFER_SIZE", "HT", "WD", "PATCHES_PER_FRAME", "PATCH_LIFETIME",
          "REMOVAL_WINDOW", "OPTIMIZATION_WINDOW", "KEYFRAME_INDEX",
          "KEYFRAME_THRESH", "MOTION_PROBE_THRESH", "MEM", "DIM_INET",
          "DIM_FNET", "DIM", "MIXED_PRECISION", "SCORER_EVAL_MODE")
# the JAX engine's "gather" correlation reads unquantised rings whatever
# CORR_RING_I8 says; the port's counterpart of that is CORR_RING_I8=False
# (tests/test_torch_engine_i8.py holds the int8 configurations)
CFG = VOConfig(CORR_RING_I8=False, **{k: getattr(JCFG, k) for k in SHARED})


def _depth_draws(n_calls, M, seed=SEED):
    """The JAX engine's initial-depth draw of each call."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_calls):
        key, key_sel = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(
            jax.random.fold_in(key_sel, 1), (M, 1))))
    return out


def _live_edges_jax(st):
    ne = int(st.n_edges)
    live = ~np.asarray(st.pending_drop[:ne])
    return set(zip(np.asarray(st.kk[:ne])[live].tolist(),
                   np.asarray(st.jj[:ne])[live].tolist()))


def test_config_matches_jax():
    """The port keeps every knob the two engines share, with the same
    defaults, derived sizes and per-benchmark overrides."""
    names = {f.name for f in dataclasses.fields(tconfig.VOConfig)}
    for name in names:
        assert getattr(tconfig.VOConfig(), name) == getattr(jconfig.VOConfig(), name), name
    assert set(tconfig.EVAL_CONFIGS) == set(jconfig.EVAL_CONFIGS)
    for k, c in tconfig.EVAL_CONFIGS.items():
        for name in names:
            assert getattr(c, name) == getattr(jconfig.EVAL_CONFIGS[k], name), (k, name)
    y = tconfig.VOConfig.from_yaml("config/eval_eds.yaml")
    assert y.KEYFRAME_THRESH == 25.0 and y.EDGE_CAP == tconfig.VOConfig().EDGE_CAP
    for prop in ("M", "P", "ba_window", "frame_span", "patch_slots"):
        assert getattr(CFG, prop) == getattr(JCFG, prop)


def test_engine_matches_jax_engine():
    params = make_params(JCFG)
    frames = make_frames(N_FRAMES)
    intr = np.asarray([80.0, 80.0, WD / 2, HT / 2], np.float32)
    draws = _depth_draws(N_FRAMES, CFG.M)

    jslam = JDEVO(JCFG, params, ht=HT, wd=WD, seed=SEED)
    slam = DEVO(CFG, jax_params_to_state_dict(params), ht=HT, wd=WD, seed=SEED,
                device="cpu")
    corr_plain.calls = 0
    corr_cuda.reset_launches()
    culls = 0
    for i, v in enumerate(frames):
        jslam(i / 30.0, v, intr)
        slam._draw_depth = lambda d=draws[i]: torch.from_numpy(np.array(d))
        slam(i / 30.0, v, intr)
        st = jslam.state
        assert slam.n == int(st.n), f"frame {i}: n {slam.n} vs {int(st.n)}"
        assert slam.aux_log[-1][1].status == int(jslam.aux_log[-1][1].status)
        port_edges = set(zip(slam.kk.tolist(), slam.jj.tolist()))
        jax_edges = _live_edges_jax(st)
        assert port_edges == jax_edges, (
            f"frame {i}: edge tables differ (port-only "
            f"{sorted(port_edges - jax_edges)[:5]}, jax-only "
            f"{sorted(jax_edges - port_edges)[:5]})")
        # the port's table is packed and (kk, jj)-sorted
        key = slam.kk * CFG.BUFFER_SIZE + slam.jj
        assert bool((key[1:] > key[:-1]).all())
        kf = bool(jslam.aux_log[-1][1].kf_removed)
        assert slam.aux_log[-1][1].kf_removed == kf, f"frame {i}: cull decision"
        culls += kf
        nk = max(slam.n, 1)
        np.testing.assert_allclose(slam.poses[:nk].numpy(),
                                   np.asarray(st.poses[:nk]), atol=5e-2,
                                   err_msg=f"frame {i}: poses diverged")
    assert culls >= 1, "no keyframe cull happened: the cull path went untested"
    # CPU tensors took the plain correlation, never the kernel
    assert corr_plain.calls > 0 and not any(corr_cuda.launches.values())

    for _ in range(12):
        jslam.update()
        slam.update()
    poses_j, tss_j = jslam.terminate()
    poses_t, tss_t = slam.terminate()
    np.testing.assert_array_equal(tss_t, tss_j)
    assert poses_t.shape == (N_FRAMES, 7)
    np.testing.assert_allclose(poses_t, poses_j, atol=5e-2)
    pts = slam.point_cloud()
    assert pts.shape == (slam.n * CFG.M, 3) and np.isfinite(pts).all()


def test_engine_skips_empty_first_frame():
    params = make_params(JCFG)
    slam = DEVO(CFG, jax_params_to_state_dict(params), ht=HT, wd=WD,
                device="cpu")
    intr = np.asarray([80.0, 80.0, WD / 2, HT / 2], np.float32)
    slam(0.0, np.zeros((HT, WD, 5), np.float32), intr)
    assert slam.aux_log[-1][1].status == 0 and slam.n == 0
    slam(0.1, make_frames(1)[0], intr)
    assert slam.aux_log[-1][1].status == 2 and slam.n == 1
    poses, tss = slam.terminate()          # not initialized: near-identity
    assert poses.shape == (1, 7) and list(tss) == [0.1]


def test_engine_crops_346_wide_voxels():
    """MVSEC/FPV voxels are 346 wide; the engine crops one column each side
    (devo.py:466-467), so the rings are built 346 // 4 = 86 wide, and the
    level-4 ring 86 // 4 = 21 (avg_pool2d drops the trailing columns)."""
    params = make_params(JCFG)
    slam = DEVO(CFG, jax_params_to_state_dict(params), ht=HT, wd=346,
                device="cpu")
    intr = np.asarray([80.0, 80.0, 173.0, HT / 2], np.float32)
    slam(0.0, make_frames(1, wd=346)[0], intr)
    assert slam.aux_log[-1][1].status == 2 and slam.n == 1
    assert slam.fmap1.shape[1:3] == (HT // 4, 86)
    assert slam.fmap2.shape[1:3] == (HT // 16, 21)
