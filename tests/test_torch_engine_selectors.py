"""Port parity for the tracking engine with the frame input and the two
new selectors: devo_tpu_torch's DEVO against devo_tpu's over the same
frames, with the same weights and the same random draws.

- Frame input: the frame drivers' configuration (evals/common_frames.py:
  EVS=False, BINS=3, PATCH_SELECTOR="random", NORM="none", ...) on
  3-channel 0-255 frames, so that the engine's EVS=False branch and the
  random selector run.
- The gradient selector with SCORER_EVAL_MODE="topk" on event voxels.

Sizes and the rest of the configuration are tests/test_engine_golden.py's
(64x64, 4 patches a frame), over 9 frames: frame 8 initializes (12
updates), frame 9 runs one update and the keyframe test. The test
reproduces the JAX engine's key schedule (one split per call,
engine.py:695; the selector's draw from key_sel, the depth draw from
fold_in(key_sel, 1), engine.py:634-635) and hands the draws to the port
(`_draw_coords`, `_draw_depth`). Per frame the keyframe count, the status
and the (kk, jj) edge set must be equal and the poses within atol 5e-2,
the bound of tests/test_torch_engine.py; then terminate() within it.
"""
import numpy as np
import pytest
import torch

import jax

from devo_tpu.runtime.engine import DEVO as JDEVO
from devo_tpu_torch.ops import corr as corr_plain
from devo_tpu_torch.ops import corr_cuda
from devo_tpu_torch.runtime.config import VOConfig
from devo_tpu_torch.runtime.engine import DEVO
from devo_tpu_torch.utils.params import jax_params_to_state_dict

from test_engine_golden import CFG as GOLDEN_CFG, HT, WD, make_frames, make_params
from test_torch_engine import SHARED, _live_edges_jax


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the small CPU engines are thousands of tiny
    operators, and beside the other workers of a parallel run every core's
    thread only contends (tests/test_torch_frames.py does the same)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


N_FRAMES = 9
SEED = 0
FRAME_KNOBS = dict(EVS=False, BINS=3, PATCH_SELECTOR="random", NORM="none",
                   SCORER_EVAL_MODE="random", SCORER_EVAL_USE_GRID=False,
                   OPTIMIZATION_WINDOW=15, KEYFRAME_THRESH=15.0)
GRADIENT_KNOBS = dict(PATCH_SELECTOR="gradient", SCORER_EVAL_MODE="topk")
KEYS = SHARED + ("EVS", "BINS", "PATCH_SELECTOR", "NORM", "SCORER_EVAL_USE_GRID")


def _configs(knobs):
    jcfg = GOLDEN_CFG.replace(**knobs)
    return jcfg, VOConfig(CORR_RING_I8=False,
                          **{k: getattr(jcfg, k) for k in KEYS})


def _draws(n_calls, M, random_coords, seed=SEED):
    """Per call the JAX engine's (coords, depths): the random selector's x,
    y (select_random from key_sel) and the initial depths."""
    key = jax.random.PRNGKey(seed)
    out = []
    h, w = HT // 4, WD // 4
    for _ in range(n_calls):
        key, key_sel = jax.random.split(key)
        coords = None
        if random_coords:
            kx, ky = jax.random.split(key_sel)
            coords = tuple(torch.from_numpy(np.array(jax.random.randint(
                k, (1, M), 1, lim - 1))).long() for k, lim in ((kx, w), (ky, h)))
        depth = np.asarray(jax.random.uniform(jax.random.fold_in(key_sel, 1),
                                              (M, 1)))
        out.append((coords, torch.from_numpy(np.array(depth))))
    return out


def _rgb_frames(n, seed=0):
    """3-channel 0-255 frames of a texture sliding 3 px a frame."""
    rng = np.random.default_rng(seed)
    base = (rng.random((HT, 2 * WD, 3)) * 255).astype(np.float32)
    return [base[:, 3 * i:3 * i + WD] for i in range(n)]


def _run_both(knobs, frames):
    jcfg, cfg = _configs(knobs)
    params = make_params(jcfg)
    intr = np.asarray([80.0, 80.0, WD / 2, HT / 2], np.float32)
    draws = _draws(len(frames), cfg.M, cfg.PATCH_SELECTOR == "random")
    jslam = JDEVO(jcfg, params, ht=HT, wd=WD, seed=SEED)
    slam = DEVO(cfg, jax_params_to_state_dict(params), ht=HT, wd=WD,
                seed=SEED, device="cpu")
    corr_plain.calls = 0
    corr_cuda.reset_launches()
    for i, v in enumerate(frames):
        coords, depth = draws[i]
        jslam(i / 30.0, v, intr)
        slam._draw_depth = lambda d=depth: d
        if coords is not None:
            slam._draw_coords = lambda c=coords: c
        slam(i / 30.0, v, intr)
        st = jslam.state
        assert slam.n == int(st.n), f"frame {i}: n {slam.n} vs {int(st.n)}"
        assert slam.aux_log[-1][1].status == int(jslam.aux_log[-1][1].status)
        assert slam.aux_log[-1][1].kf_removed == bool(
            jslam.aux_log[-1][1].kf_removed), f"frame {i}: cull decision"
        port_edges = set(zip(slam.kk.tolist(), slam.jj.tolist()))
        assert port_edges == _live_edges_jax(st), f"frame {i}: edge tables differ"
        nk = max(slam.n, 1)
        np.testing.assert_allclose(slam.poses[:nk].numpy(),
                                   np.asarray(st.poses[:nk]), atol=5e-2,
                                   err_msg=f"frame {i}: poses diverged")
    assert slam.initialized and bool(jslam.state.initialized)
    # CPU tensors took the plain correlation, never the kernel
    assert corr_plain.calls > 0 and not any(corr_cuda.launches.values())
    poses_j, tss_j = jslam.terminate()
    poses_t, tss_t = slam.terminate()
    np.testing.assert_array_equal(tss_t, tss_j)
    assert poses_t.shape == (len(frames), 7)
    np.testing.assert_allclose(poses_t, poses_j, atol=5e-2)
    return slam


def test_frame_engine_matches_jax_engine():
    slam = _run_both(FRAME_KNOBS, _rgb_frames(N_FRAMES))
    assert slam.net.patchify.patch_selector == "random"
    assert not hasattr(slam.net.patchify, "scorer")
    assert slam.cfg.EVS is False and slam.cfg.BINS == 3
    # no empty-frame skip in frame mode, and the patches sit inside
    # [1, w-2] x [1, h-2] at feature resolution
    assert all(aux.status == 2 for _, aux in slam.aux_log)
    P = slam.cfg.P
    c = (P * P) // 2
    px = slam.patches[:slam.n * slam.cfg.M, c]
    assert float(px.min()) >= 1 and float(px.max()) <= WD // 4 - 2


def test_gradient_engine_matches_jax_engine():
    slam = _run_both(GRADIENT_KNOBS, make_frames(N_FRAMES))
    assert slam.net.patchify.patch_selector == "gradient"


def test_random_selector_draws_from_the_engine_generator():
    """Without injected draws, the random selector's coordinates come from
    the engine's generator: one seed, the same patches; another seed,
    others."""
    jcfg, cfg = _configs(FRAME_KNOBS)
    weights = jax_params_to_state_dict(make_params(jcfg))
    intr = np.asarray([80.0, 80.0, WD / 2, HT / 2], np.float32)
    frame = _rgb_frames(1)[0]
    runs = []
    for seed in (3, 3, 4):
        slam = DEVO(cfg, weights, ht=HT, wd=WD, seed=seed, device="cpu")
        slam(0.0, frame, intr)
        runs.append(slam.patches[:cfg.M].clone())
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
