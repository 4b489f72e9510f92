"""Port parity for the quantised-ring configurations of the tracking engine:
(CORR_RING_I8, CORR_KERNEL, CORR_L4_RESIDENT) = (True, "mono", "off"),
(True, "split", "off") and (True, "split", "auto"), on the frames, weights
and injected depth draws of tests/test_torch_engine.py.

The JAX engine reads int8 rings only on its banded Pallas path
(CORR_IMPL="banded"), which on the CPU runs in interpret mode
(DEVO_CORR_INTERPRET=1 and pltpu.force_tpu_interpret_mode, the way
tests/test_engine_banded.py drives it). That engine is slow: the 12-update
initialisation alone takes about two minutes per configuration at the golden
test's size. So, to keep this file to about two and a half minutes:

- one configuration, the default (int8 rings, "mono"), runs against the
  interpreted JAX engine, over the fewest frames that include the
  initialisation and one keyframe cull (9): per frame the same keyframe
  count, cull decision and (kk, jj) edge set, poses within atol 0.1
  (tests/test_engine_banded.py's own int8 bound). This run departs from the
  shared configuration in one knob: PATCH_LIFETIME is cut from 5 to 3 in
  both engines, which halves the live edges the interpreter walks. The
  other runs of this file keep PATCH_LIFETIME=5;
- "split" and "split" + resident level 4 meet the interpreted JAX engine
  with the same knobs once, at the unchanged PATCH_LIFETIME: both engines
  take five frames, short of the initialisation (no update has moved a
  pose yet, so their states are equal up to the networks' float noise),
  then each computes its correlation features of the whole edge table
  through its own _edge_features: rings, per-slot scales and the per-level
  dispatch as the engine passes them, within the per-level kernels' own
  bound, atol 5e-2 and rtol 1e-2;
- all three configurations run the full 18 frames against the port's own
  unquantised engine (which tests/test_torch_engine.py holds against the
  JAX engine): the same decisions on every frame, poses and terminate()
  output within the same atol 0.1, and at least one cull, so that the
  shift of the per-slot scales is covered;
- the three configurations agree with each other: on the CPU they take the
  same plain arithmetic, so their poses are equal.

Also here: the per-slot scales move with their ring slots on a cull, and the
rules of CORR_KERNEL and CORR_L4_RESIDENT.
"""
import functools

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from devo_tpu.runtime import engine as jengine
from devo_tpu.runtime.engine import DEVO as JDEVO
from devo_tpu_torch.ops import corr as corr_plain
from devo_tpu_torch.ops import corr_cuda
from devo_tpu_torch.runtime.config import VOConfig
from devo_tpu_torch.runtime.engine import DEVO, l4_resident
from devo_tpu_torch.utils.params import jax_params_to_state_dict

from test_engine_golden import HT, WD, make_frames, make_params
from test_torch_engine import CFG as BASE, JCFG, SEED, _depth_draws, _live_edges_jax

N_FRAMES = 18
I8_ATOL = 0.1
INTR = np.asarray([80.0, 80.0, WD / 2, HT / 2], np.float32)
CONFIGS = {
    "bf16": dict(CORR_RING_I8=False),
    "i8-mono": dict(CORR_RING_I8=True, CORR_KERNEL="mono"),
    "i8-split": dict(CORR_RING_I8=True, CORR_KERNEL="split"),
    "i8-resident": dict(CORR_RING_I8=True, CORR_KERNEL="split",
                        CORR_L4_RESIDENT="auto"),
}
I8 = ["i8-mono", "i8-split", "i8-resident"]


def _port(cfg):
    return DEVO(cfg, jax_params_to_state_dict(make_params(JCFG)), ht=HT,
                wd=WD, seed=SEED, device="cpu")


def _step(slam, i, frame, draw):
    slam._draw_depth = lambda: torch.from_numpy(np.array(draw))
    slam(i / 30.0, frame, INTR)
    return dict(n=slam.n, cull=bool(slam.aux_log[-1][1].kf_removed),
                edges=set(zip(slam.kk.tolist(), slam.jj.tolist())),
                poses=slam.poses[:max(slam.n, 1)].numpy().copy())


@functools.lru_cache(maxsize=None)
def _port_run(name):
    """The port's engine over the 18 frames: per-frame records, and the
    terminate() output (without further updates, as
    tests/test_engine_banded.py compares it: under random weights twelve
    more updates amplify the rounding of the rings beyond any bound)."""
    slam = _port(BASE.replace(**CONFIGS[name]))
    draws = _depth_draws(N_FRAMES, BASE.M)
    records = [_step(slam, i, v, draws[i])
               for i, v in enumerate(make_frames(N_FRAMES))]
    return slam, records, slam.terminate()


def _same_decisions(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["n"] == w["n"], f"frame {i}: n differs from {what}"
        assert g["cull"] == w["cull"], f"frame {i}: cull differs from {what}"
        assert g["edges"] == w["edges"], f"frame {i}: edges differ from {what}"


@pytest.mark.parametrize("name", I8)
def test_i8_engine_matches_unquantised_engine(name):
    slam, records, (poses, tss) = _port_run(name)
    _, ref_records, (ref_poses, ref_tss) = _port_run("bf16")
    assert slam.fmap1.dtype == torch.int8 and slam.fmap2.dtype == torch.int8
    assert slam.fsc1.shape == (BASE.MEM,) and slam.fsc2.shape == (BASE.MEM,)
    assert slam.l4_resident == (name == "i8-resident")
    _same_decisions(records, ref_records, "the unquantised engine")
    for i, (g, w) in enumerate(zip(records, ref_records)):
        np.testing.assert_allclose(g["poses"], w["poses"], atol=I8_ATOL,
                                   err_msg=f"frame {i}: poses diverged")
    assert sum(r["cull"] for r in records) >= 1, "no cull: scale shift untested"
    np.testing.assert_array_equal(tss, ref_tss)
    np.testing.assert_allclose(poses, ref_poses, atol=I8_ATOL)
    # the quantisation does change the numbers
    assert np.abs(poses - ref_poses).max() > 0


def test_i8_configurations_agree_with_each_other():
    runs = {name: _port_run(name) for name in I8}
    _, ref_records, (ref_poses, _) = runs["i8-mono"]
    for name in I8[1:]:
        _, records, (poses, _) = runs[name]
        _same_decisions(records, ref_records, "i8-mono")
        for g, w in zip(records, ref_records):
            np.testing.assert_allclose(g["poses"], w["poses"], atol=1e-5)
        np.testing.assert_allclose(poses, ref_poses, atol=1e-5)
    # on CPU tensors no configuration launches a kernel
    assert not any(corr_cuda.launches.values())


def test_i8_engine_matches_jax_banded_engine(monkeypatch):
    n_frames = 9                  # initialisation at frame 7, a cull at 8
    knobs = dict(CORR_RING_I8=True, CORR_KERNEL="mono",
                 CORR_L4_RESIDENT="off", PATCH_LIFETIME=3, EDGE_CAP=0)
    monkeypatch.setenv("DEVO_CORR_INTERPRET", "1")
    jcfg = JCFG.replace(CORR_IMPL="banded", **knobs)
    params = make_params(jcfg)
    slam = DEVO(BASE.replace(**knobs), jax_params_to_state_dict(params),
                ht=HT, wd=WD, seed=SEED, device="cpu")
    draws = _depth_draws(n_frames, BASE.M)
    culls = 0
    with pltpu.force_tpu_interpret_mode():
        jslam = JDEVO(jcfg, params, ht=HT, wd=WD, seed=SEED)
        assert jslam.state.fmap1b.dtype == np.int8      # the banded i8 path
        for i, v in enumerate(make_frames(n_frames)):
            jslam(i / 30.0, v, INTR)
            got = _step(slam, i, v, draws[i])
            st = jslam.state
            assert got["n"] == int(st.n), f"frame {i}: keyframe count"
            kf = bool(jslam.aux_log[-1][1].kf_removed)
            assert got["cull"] == kf, f"frame {i}: cull decision"
            assert got["edges"] == _live_edges_jax(st), f"frame {i}: edge set"
            np.testing.assert_allclose(
                got["poses"], np.asarray(st.poses[:max(got["n"], 1)]),
                atol=I8_ATOL, err_msg=f"frame {i}: poses diverged")
            culls += kf
            if kf:
                # the scales moved with their slots, as the JAX engine's did
                n = got["n"]
                np.testing.assert_allclose(slam.fsc1[:n].numpy(),
                                           np.asarray(st.fsc1[:n]), rtol=1e-4)
                np.testing.assert_allclose(slam.fsc2[:n].numpy(),
                                           np.asarray(st.fsc2[:n]), rtol=1e-4)
    assert slam.initialized and culls >= 1


@pytest.mark.parametrize("name", ["i8-split", "i8-resident"])
def test_per_level_features_match_jax_banded_engine(name, monkeypatch):
    n_frames = 5                  # before the initialisation (frame 7)
    monkeypatch.setenv("DEVO_CORR_INTERPRET", "1")
    jcfg = JCFG.replace(CORR_IMPL="banded", **CONFIGS[name])
    params = make_params(jcfg)
    slam = _port(BASE.replace(**CONFIGS[name]))
    draws = _depth_draws(n_frames, BASE.M)
    with pltpu.force_tpu_interpret_mode():
        jslam = JDEVO(jcfg, params, ht=HT, wd=WD, seed=SEED)
        resident = name == "i8-resident"
        assert jengine._l4_resident(jslam.cfg, HT, WD) == resident
        assert slam.l4_resident == resident
        for i, v in enumerate(make_frames(n_frames)):
            jslam(i / 30.0, v, INTR)
            got = _step(slam, i, v, draws[i])
        st = jslam.state
        assert got["n"] == int(st.n) == n_frames and not slam.initialized
        assert got["edges"] == _live_edges_jax(st)
        np.testing.assert_allclose(slam.fsc1[:n_frames].numpy(),
                                   np.asarray(st.fsc1[:n_frames]), rtol=1e-4)
        np.testing.assert_allclose(slam.fsc2[:n_frames].numpy(),
                                   np.asarray(st.fsc2[:n_frames]), rtol=1e-4)
        _, jfeat, _ = jengine._edge_features(jslam.cfg, st, st.ii, st.jj,
                                             st.kk, st.emask)
        jfeat = np.asarray(jfeat)
    corr_plain.calls = 0
    _, feat, _ = slam._edge_features(slam.ii, slam.jj, slam.kk)
    assert corr_plain.calls == 2          # one plain corr_level per level
    ne = int(st.n_edges)
    assert ne == slam.n_edges == 100
    # both tables are packed and (kk, jj)-sorted: rows line up
    np.testing.assert_array_equal(np.asarray(st.kk[:ne]), slam.kk.numpy())
    np.testing.assert_array_equal(np.asarray(st.jj[:ne]), slam.jj.numpy())
    assert feat.shape == (ne, 882) and np.abs(jfeat[:ne]).max() > 0.1
    np.testing.assert_allclose(feat.numpy(), jfeat[:ne], atol=5e-2, rtol=1e-2)


def test_cull_moves_the_scales_with_their_ring_slots():
    slam = _port(BASE.replace(**CONFIGS["i8-split"]))
    draws = _depth_draws(6, BASE.M)
    for i, v in enumerate(make_frames(6)):
        _step(slam, i, v, draws[i])
    assert slam.n == 6
    before = [(slam.fmap1[j].clone(), slam.fsc1[j].item(),
               slam.fmap2[j].clone(), slam.fsc2[j].item()) for j in range(6)]
    assert len({b[1] for b in before}) == 6        # distinct scales
    slam._remove_keyframe(2)
    assert slam.n == 5
    for j, src in enumerate([0, 1, 3, 4, 5]):
        assert torch.equal(slam.fmap1[j], before[src][0])
        assert slam.fsc1[j].item() == before[src][1]
        assert torch.equal(slam.fmap2[j], before[src][2])
        assert slam.fsc2[j].item() == before[src][3]


def test_ring_writes_quantise_each_level_with_its_own_scale():
    slam = _port(BASE.replace(**CONFIGS["i8-mono"]))
    ref = _port(BASE.replace(**CONFIGS["bf16"]))
    draw = _depth_draws(1, BASE.M)[0]
    frame = make_frames(1)[0]
    _step(slam, 0, frame, draw)
    _step(ref, 0, frame, draw)
    for ring, scale, want in ((slam.fmap1, slam.fsc1, ref.fmap1),
                              (slam.fmap2, slam.fsc2, ref.fmap2)):
        s = want[0].abs().max() / 127.0
        assert scale[0].item() == s.item()
        assert ring[0].abs().max().item() == 127
        torch.testing.assert_close(ring[0].float() * scale[0], want[0],
                                   atol=0.5 * s.item() * 1.0001, rtol=0)
        assert torch.equal(scale[1:], torch.ones_like(scale[1:]))


def test_corr_knob_rules():
    full = VOConfig()
    assert (full.CORR_RING_I8, full.CORR_KERNEL, full.CORR_L4_RESIDENT) == (
        True, "mono", "off")
    split = full.replace(CORR_KERNEL="split")
    # off; and on / auto where it holds: 480x640, int8, per-level kernel
    assert not l4_resident(split, 480, 640)
    assert l4_resident(split.replace(CORR_L4_RESIDENT="on"), 480, 640)
    assert l4_resident(split.replace(CORR_L4_RESIDENT="auto"), 480, 640)
    # where it cannot hold, "auto" is off and "on" raises: the two-level
    # kernel, unquantised rings, a frame beyond a block's shared memory
    for cfg, hw in ((full, (480, 640)),
                    (split.replace(CORR_RING_I8=False), (480, 640)),
                    (split, (720, 1280))):
        assert not l4_resident(cfg.replace(CORR_L4_RESIDENT="auto"), *hw)
        with pytest.raises(ValueError):
            l4_resident(cfg.replace(CORR_L4_RESIDENT="on"), *hw)
    with pytest.raises(ValueError):
        l4_resident(split.replace(CORR_L4_RESIDENT="maybe"), 480, 640)
    weights = jax_params_to_state_dict(make_params(JCFG))
    for name in corr_cuda.KERNELS:           # every name builds an engine
        assert DEVO(BASE.replace(CORR_KERNEL=name), weights, ht=HT, wd=WD,
                    device="cpu").cfg.CORR_KERNEL == name
    with pytest.raises(ValueError, match="CORR_KERNEL='mono5'"):
        DEVO(BASE.replace(CORR_KERNEL="mono5"), weights, ht=HT, wd=WD,
             device="cpu")
    with pytest.raises(ValueError):
        DEVO(BASE.replace(CORR_L4_RESIDENT="on"), weights, ht=HT, wd=WD,
             device="cpu")


def test_engine_runs_on_the_card_unless_asked_for_the_cpu():
    """Without `device` the engine takes the current CUDA device and refuses
    to start where there is none: it never falls back to the CPU."""
    weights = jax_params_to_state_dict(make_params(JCFG))
    if torch.cuda.is_available():
        assert DEVO(BASE, weights, ht=HT, wd=WD).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DEVO(BASE, weights, ht=HT, wd=WD)
    assert DEVO(BASE, weights, ht=HT, wd=WD, device="cpu").device.type == "cpu"
