"""The port's bench entry point (devo_tpu_torch/bench.py) on the CPU at a
small size, and one engine run under a CORR_KERNEL name the bench added.

- the synthetic stream equals the recipe of devo_tpu's bench.py
  (bench.py:140-149), recomputed here in numpy;
- `bench.run(device="cpu")` at 64x64 and narrow widths, a few windows of a
  few frames: the keys of its result, that the live edge count sheds at
  EDGE_CAP, and the two rules that end the warm-up;
- the environment knobs: every CORR_KERNEL name the JAX bench takes, a bad
  value, and a knob of something the port dropped, which must stop the
  program before it measures anything;
- CORR_KERNEL="split2" on int8 rings against the interpreted JAX engine with
  the same knobs (DEVO_CORR_INTERPRET=1), as tests/test_torch_engine_i8.py
  holds "split": both engines take five frames, short of the initialisation,
  then each computes the correlation features of its whole edge table
  through its own _edge_features, within the per-level kernels' bound (atol
  5e-2, rtol 1e-2).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from devo_tpu.runtime import engine as jengine
from devo_tpu.runtime.engine import DEVO as JDEVO
from devo_tpu_torch import bench
from devo_tpu_torch.ops import corr as corr_plain
from devo_tpu_torch.ops import corr_cuda
from devo_tpu_torch.runtime.engine import DEVO
from devo_tpu_torch.utils.params import jax_params_to_state_dict

from test_engine_golden import HT, WD, make_frames, make_params
from test_torch_engine import CFG as BASE, JCFG, SEED, _depth_draws, _live_edges_jax

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(BUFFER_SIZE=64, PATCHES_PER_FRAME=4, PATCH_LIFETIME=5,
             REMOVAL_WINDOW=9, OPTIMIZATION_WINDOW=4, MEM=16, DIM_INET=32,
             DIM_FNET=16, DIM=8, MIXED_PRECISION=False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The engine at this size is thousands of tiny operators: with several
    test workers on one machine, torch's intra-op threads wait on each other
    at every one of them and a run of seconds takes minutes. One thread
    computes the same numbers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


KEYS = {"metric", "value", "unit", "steady_window_fps", "window_fps",
        "window_spread", "config", "size", "device", "card", "reached",
        "frames_before_timing", "window_dispatch_s", "window_copy_s",
        "window_end_live_edges", "launches", "plain_corr_calls", "peak_gib",
        "poses", "engine"}


def test_stream_is_the_jax_bench_recipe():
    ht, wd = bench.HT, bench.WD
    assert (ht, wd) == (480, 640)
    rng = np.random.default_rng(0)
    base = rng.standard_normal((ht, wd * 2, 5)).astype(np.float32)
    base *= (rng.random((ht, wd * 2, 5)) < 0.1)
    got = bench.texture()
    assert got.dtype == np.float32 and np.array_equal(got, base)
    assert 0.09 < (got != 0).mean() < 0.11
    for i in (0, 1, 7, 213, 214, 500):
        sh = (3 * i) % wd
        assert np.array_equal(bench.frame(got, i), base[:, sh:sh + wd])
    first = list(bench.frames(3))
    assert len(first) == 3 and first[2].shape == (ht, wd, 5)
    assert np.array_equal(first[2], base[:, 6:6 + wd])
    np.testing.assert_array_equal(bench.intrinsics(),
                                  np.float32([320.0, 320.0, 320.0, 240.0]))
    small = bench.texture(64, 64)
    assert small.shape == (64, 128, 5)
    assert np.array_equal(bench.frame(small, 30), small[:, 26:90])


def test_bench_defaults_are_the_jax_bench_shape():
    assert (bench.N_WARM, bench.N_POST, bench.N_POST_MAX, bench.N_BENCH,
            bench.WINDOWS) == (48, 8, 336, 336, 12)
    assert bench.EDGE_POINT == 12288 and bench.NEAR_CAP == 128
    # every banded kernel but the two that bench.py refuses too
    assert set(bench.KERNELS) == set(corr_cuda.KERNELS) - {"g8", "full"}


@pytest.mark.parametrize("kernel", ["mono", "split2", "g8c"])
def test_run_on_the_cpu_sheds_at_the_edge_cap(kernel):
    before = dict(corr_cuda.launches)
    res = bench.run(dict(SMALL, EDGE_CAP=100, CORR_KERNEL=kernel),
                    device="cpu", n_warm=12, n_post=4, n_post_max=40,
                    n_bench=9, windows=3, ht=64, wd=64)
    assert set(res) == KEYS
    assert res["metric"] == "event_vo_fps_640x480" and res["unit"] == "frames/s"
    assert res["config"] == {"ring_i8": True, "corr_kernel": kernel,
                             "keyframe_thresh": 15.0, "edge_cap": 100,
                             "l4_resident": False}
    assert res["size"] == [64, 64] and res["device"] == "cpu"
    assert res["card"] is None and res["peak_gib"] is None
    # uncapped, this configuration's updates run on 125 edges and more: the
    # cap sheds the tail of the append
    live = res["window_end_live_edges"]
    assert res["reached"] and max(live) == 100 and min(live) > 90
    for key in ("window_fps", "window_dispatch_s", "window_copy_s"):
        assert len(res[key]) == 3 and all(v >= 0 for v in res[key])
    assert res["value"] > 0 and res["steady_window_fps"] > 0
    assert 0 <= res["window_spread"] < 1
    # nine timed frames, one update each; on the CPU no kernel is launched
    assert res["launches"] == {} and corr_cuda.launches == before
    calls = {"mono": 9, "split2": 18, "g8c": 18}[kernel]
    assert res["plain_corr_calls"] == calls
    assert res["poses"].shape == (res["frames_before_timing"] + 9, 7)
    assert np.isfinite(res["poses"]).all()
    assert res["engine"].cfg.CORR_KERNEL == kernel
    json.dumps({k: v for k, v in res.items() if k not in ("poses", "engine")})


def test_run_at_maximum_load_waits_for_two_calm_probes():
    res = bench.run(dict(SMALL, KEYFRAME_THRESH=-1.0), device="cpu", n_warm=12,
                    n_post=4, n_post_max=48, n_bench=4, windows=2, ht=64,
                    wd=64)
    # no cull: the derived EDGE_CAP, and more edges than the culled regime
    assert res["config"]["edge_cap"] == 1024
    assert res["config"]["keyframe_thresh"] == -1.0
    assert res["reached"] and res["frames_before_timing"] >= 12 + 4 + 16
    assert res["window_end_live_edges"][-1] > 125
    # a budget too short to reach the point is reported, not hidden
    short = bench.run(dict(SMALL, KEYFRAME_THRESH=-1.0), device="cpu",
                      n_warm=2, n_post=2, n_post_max=8, n_bench=2, windows=1,
                      ht=64, wd=64)
    assert not short["reached"]


def test_run_takes_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run(dict(SMALL), n_warm=1, n_post=0, n_bench=1, windows=1,
                  ht=64, wd=64)


def test_knobs_from_env():
    assert bench.knobs_from_env({}) == dict(
        CORR_RING_I8=True, CORR_KERNEL="mono", KEYFRAME_THRESH=15.0)
    for name in ("split", "split2", "pair", "pair2", "mono", "mono2", "mono3",
                 "mono4", "g8c"):
        assert bench.knobs_from_env(
            {"BENCH_CORR_KERNEL": name.upper()})["CORR_KERNEL"] == name
    got = bench.knobs_from_env({"BENCH_RING_I8": "no",
                                "BENCH_KEYFRAME_THRESH": "-1"})
    assert got == dict(CORR_RING_I8=False, CORR_KERNEL="mono",
                       KEYFRAME_THRESH=-1.0)
    for env in ({"BENCH_CORR_KERNEL": "g8"}, {"BENCH_CORR_KERNEL": "mono5"},
                {"BENCH_RING_I8": "2"}, {"BENCH_KEYFRAME_THRESH": "low"}):
        with pytest.raises(SystemExit) as exc:
            bench.knobs_from_env(env)
        assert exc.value.code not in (0, None)
    for name in bench.DROPPED_KNOBS:
        with pytest.raises(SystemExit) as exc:
            bench.knobs_from_env({name: "1"})
        assert name in str(exc.value.code)
    assert set(bench.DROPPED_KNOBS) == {
        "BENCH_WIRE", "BENCH_CORR_WR1", "BENCH_SCORER_S2D",
        "BENCH_ENCODER_S2D", "DEVO_FORCE_BUCKET", "DEVO_CORR_IF",
        "DEVO_CORR_K", "DEVO_CORR_BE"}


@pytest.mark.parametrize("env,args", [
    ({"BENCH_CORR_KERNEL": "mono5"}, ["--device", "cpu"]),
    ({"BENCH_WIRE": "f16"}, ["--device", "cpu"]),
    ({"DEVO_FORCE_BUCKET": "12288"}, ["--device", "cpu"]),
    ({"CUDA_VISIBLE_DEVICES": ""}, []),
], ids=["bad-kernel", "dropped-wire", "dropped-bucket", "no-card"])
def test_program_exits_before_any_result(env, args):
    """A bad knob, a knob of something the port dropped, and no CUDA device
    without --device cpu: a non-zero exit, a message, and no JSON line."""
    clean = {k: v for k, v in os.environ.items()
             if not k.startswith(("BENCH_", "DEVO_"))}
    res = subprocess.run([sys.executable, "-m", "devo_tpu_torch.bench", *args],
                         cwd=ROOT, env={**clean, **env}, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == "" and res.stderr.strip()


INTR = np.asarray([80.0, 80.0, WD / 2, HT / 2], np.float32)


def test_split2_features_match_jax_banded_engine(monkeypatch):
    n_frames = 5                  # before the initialisation (frame 7)
    knobs = dict(CORR_RING_I8=True, CORR_KERNEL="split2")
    monkeypatch.setenv("DEVO_CORR_INTERPRET", "1")
    jcfg = JCFG.replace(CORR_IMPL="banded", **knobs)
    params = make_params(jcfg)
    slam = DEVO(BASE.replace(**knobs), jax_params_to_state_dict(params),
                ht=HT, wd=WD, seed=SEED, device="cpu")
    draws = _depth_draws(n_frames, BASE.M)
    with pltpu.force_tpu_interpret_mode():
        jslam = JDEVO(jcfg, params, ht=HT, wd=WD, seed=SEED)
        assert jslam.cfg.CORR_KERNEL == "split2"
        assert jslam.state.fmap1b.dtype == np.int8
        for i, v in enumerate(make_frames(n_frames)):
            jslam(i / 30.0, v, INTR)
            slam._draw_depth = lambda d=draws[i]: torch.from_numpy(np.array(d))
            slam(i / 30.0, v, INTR)
        st = jslam.state
        assert slam.n == int(st.n) == n_frames and not slam.initialized
        edges = set(zip(slam.kk.tolist(), slam.jj.tolist()))
        assert edges == _live_edges_jax(st)
        _, jfeat, _ = jengine._edge_features(jslam.cfg, st, st.ii, st.jj,
                                             st.kk, st.emask)
        jfeat = np.asarray(jfeat)
    corr_plain.calls = 0
    _, feat, _ = slam._edge_features(slam.ii, slam.jj, slam.kk)
    assert corr_plain.calls == 2          # one plain corr_level per level
    ne = int(st.n_edges)
    assert ne == slam.n_edges == 100
    np.testing.assert_array_equal(np.asarray(st.kk[:ne]), slam.kk.numpy())
    np.testing.assert_array_equal(np.asarray(st.jj[:ne]), slam.jj.numpy())
    assert feat.shape == (ne, 882) and np.abs(jfeat[:ne]).max() > 0.1
    np.testing.assert_allclose(feat.numpy(), jfeat[:ne], atol=5e-2, rtol=1e-2)
