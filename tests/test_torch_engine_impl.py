"""Port parity for the engine's remaining correlation configurations:
CORR_IMPL = "pallas", "window" and "gather", and CORR_IMPL="banded" with
CORR_KERNEL = "g8" and "full", on the frames, weights and injected depth
draws of tests/test_torch_engine.py (f32, 64x64, the golden test's sizes).

devo_tpu's rules for these knobs, each pinned against devo_tpu's own
functions (DEVO_CORR_INTERPRET=1, without which devo_tpu's _impl_active runs
"gather" on a CPU whatever CORR_IMPL says):
- CORR_IMPL's values and default; any other value raises;
- int8 rings and per-slot scales under "banded" alone: every other family
  keeps plain rings in the net dtype whatever CORR_RING_I8 says (init_state);
- the resident level 4 off outside "banded", without an error
  (_l4_resident);
- "g8" and "full" refuse int8 rings (corr_level_banded asserts; the port
  raises at DEVO(...)), and the names of the "full" kernel's stages are no
  CORR_KERNEL.

The engines:
- the correlation features of the first 64 edges of the table (one block of
  devo_tpu's kernels) after 5 frames, before the initialisation, so that
  both engines' states are equal up to the networks' float noise: each
  engine through its own _edge_features, for all five configurations. The
  state of devo_tpu's "gather" run serves all five: its plain rings, and for
  "g8" and "full" the same frames banded as devo_tpu's banded engine writes
  them (_banded_writes); its Pallas kernels run in interpret mode.
  Tolerance atol 5e-2, rtol 1e-2: the TPU kernels round their inputs to
  bf16, and the rest is float noise of the states;
- the per-frame decisions over the fewest frames that include a cull (9:
  the initialisation at frame 7, a cull at frame 8): "window" and "gather"
  against devo_tpu's engine in the same mode (XLA on the CPU): the same
  keyframe count, cull decision and (kk, jj) edge set every frame, poses
  within atol 5e-2 (tests/test_torch_engine.py's bound). On the CPU the
  port's "pallas", "g8" and "full" take corr_level a level, which is the f32
  "gather" arithmetic: their runs equal the "gather" run bitwise.
"""
import contextlib
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from devo_tpu.ops import corr_pallas
from devo_tpu.runtime import config as jconfig
from devo_tpu.runtime import engine as jengine
from devo_tpu.runtime.engine import DEVO as JDEVO
from devo_tpu_torch.ops import corr as corr_plain
from devo_tpu_torch.ops import corr_cuda
from devo_tpu_torch.runtime.config import CORR_IMPLS, VOConfig
from devo_tpu_torch.runtime.engine import DEVO, STAGE_NAMES, l4_resident
from devo_tpu_torch.utils.params import jax_params_to_state_dict

from test_corr_pallas import make_case
from test_engine_golden import HT, WD, make_frames, make_params
from test_torch_engine import CFG as BASE, JCFG, SEED, _depth_draws, _live_edges_jax

INTR = np.asarray([80.0, 80.0, WD / 2, HT / 2], np.float32)
FEAT_FRAMES = 5
FEAT_EDGES = 64       # one block of devo_tpu's kernels (BE = 64)
RUN_FRAMES = 9
# float rings in both engines (devo_tpu's default is int8, which "g8" and
# "full" refuse, and which the other families do not read)
CONFIGS = {
    "pallas": dict(CORR_IMPL="pallas", CORR_RING_I8=False),
    "window": dict(CORR_IMPL="window", CORR_RING_I8=False),
    "gather": dict(CORR_IMPL="gather", CORR_RING_I8=False),
    "g8": dict(CORR_IMPL="banded", CORR_KERNEL="g8", CORR_RING_I8=False),
    "full": dict(CORR_IMPL="banded", CORR_KERNEL="full", CORR_RING_I8=False),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The engine at this size is thousands of tiny operators: one intra-op
    thread computes the same numbers and keeps workers from waiting on
    each other (as tests/test_torch_bench.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@contextlib.contextmanager
def _configured_impl():
    """devo_tpu runs the configured CORR_IMPL on a CPU under
    DEVO_CORR_INTERPRET, its Pallas kernels in interpret mode."""
    before = os.environ.get("DEVO_CORR_INTERPRET")
    os.environ["DEVO_CORR_INTERPRET"] = "1"
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        if before is None:
            del os.environ["DEVO_CORR_INTERPRET"]
        else:
            os.environ["DEVO_CORR_INTERPRET"] = before


@functools.lru_cache(maxsize=None)
def _params():
    """The JAX weights: the network's shape does not depend on the
    correlation knobs."""
    return make_params(JCFG)


@functools.lru_cache(maxsize=None)
def _weights():
    return jax_params_to_state_dict(_params())


def _step(slam, i, frame, draw):
    slam._draw_depth = lambda: torch.from_numpy(np.array(draw))
    slam(i / 30.0, frame, INTR)
    return dict(n=slam.n, cull=bool(slam.aux_log[-1][1].kf_removed),
                edges=set(zip(slam.kk.tolist(), slam.jj.tolist())),
                poses=slam.poses[:max(slam.n, 1)].numpy().copy())


def _path_counts():
    return (corr_plain.calls, corr_plain.window_calls, corr_plain.gather_calls)


@functools.lru_cache(maxsize=None)
def _port_run(name):
    """The port's engine in configuration `name` over RUN_FRAMES frames: its
    per-frame records, and after FEAT_FRAMES frames its tables, its
    correlation features of the first FEAT_EDGES edges and the counts of the
    plain paths that computing them took."""
    slam = DEVO(BASE.replace(**CONFIGS[name]), _weights(), ht=HT, wd=WD,
                seed=SEED, device="cpu")
    draws = _depth_draws(RUN_FRAMES, BASE.M)
    records = []
    for i, v in enumerate(make_frames(RUN_FRAMES)):
        records.append(_step(slam, i, v, draws[i]))
        if i + 1 == FEAT_FRAMES:
            before = _path_counts()
            _, feat, _ = slam._edge_features(
                *(t[:FEAT_EDGES] for t in (slam.ii, slam.jj, slam.kk)))
            at_feat = dict(kk=slam.kk.numpy().copy(), jj=slam.jj.numpy().copy(),
                           feat=feat.numpy(), initialized=slam.initialized,
                           counts=[b - a for a, b in zip(before, _path_counts())])
    return slam, records, at_feat


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """devo_tpu's engine in configuration `name` ("window" or "gather") over
    RUN_FRAMES frames, under the configured implementation: its per-frame
    records and its state after FEAT_FRAMES frames."""
    records = []
    with _configured_impl():
        jslam = JDEVO(JCFG.replace(**CONFIGS[name]), _params(), ht=HT, wd=WD,
                      seed=SEED)
        for i, v in enumerate(make_frames(RUN_FRAMES)):
            jslam(i / 30.0, v, INTR)
            st = jslam.state
            records.append(dict(
                n=int(st.n), cull=bool(jslam.aux_log[-1][1].kf_removed),
                edges=_live_edges_jax(st),
                poses=np.asarray(st.poses[:max(int(st.n), 1)])))
            if i + 1 == FEAT_FRAMES:     # the next step donates the state
                at_feat = jax.tree_util.tree_map(jnp.copy, st)
    return jslam, records, at_feat


@functools.lru_cache(maxsize=None)
def _jax_features(name):
    """devo_tpu's correlation features of the first FEAT_EDGES edges of its
    table after FEAT_FRAMES frames in configuration `name`, from the state of
    the "gather" run (plain rings, which "pallas" and "window" read too).
    For the banded configurations the rings are banded as devo_tpu's banded
    engine writes them (_banded_writes: band_frame of the same frames). The
    Pallas kernels run in interpret mode."""
    jslam, _, st = _jax_run("gather")
    cfg = jslam.cfg.replace(**CONFIGS[name])
    if cfg.CORR_IMPL == "banded":
        st = st._replace(**{
            f"fmap{n}b": jnp.stack([corr_pallas.band_frame(f) for f in ring])
            for n, ring in ((1, st.fmap1), (2, st.fmap2))})
    edges = [t[:FEAT_EDGES] for t in (st.ii, st.jj, st.kk, st.emask)]
    with _configured_impl():
        _, feat, _ = jengine._edge_features(cfg, st, *edges)
    return st, np.asarray(feat)


# --- the rules ---------------------------------------------------------------


def test_corr_impl_values_and_default():
    assert CORR_IMPLS == ("banded", "pallas", "window", "gather")
    assert VOConfig().CORR_IMPL == jconfig.VOConfig().CORR_IMPL == "banded"
    for impl in CORR_IMPLS:
        assert VOConfig(CORR_IMPL=impl).CORR_IMPL == impl
    for bad in ("xla", "Banded", ""):
        with pytest.raises(ValueError, match="CORR_IMPL"):
            VOConfig(CORR_IMPL=bad)
        with pytest.raises(ValueError, match="CORR_IMPL"):
            VOConfig().replace(CORR_IMPL=bad)


@pytest.mark.parametrize("impl", CORR_IMPLS)
@pytest.mark.parametrize("i8", [False, True], ids=["float", "i8"])
def test_rings_and_scales_follow_devo_tpu(impl, i8):
    """Under mixed precision, where devo_tpu's float rings are bf16 in every
    family: int8 rings with per-slot scales under "banded" and CORR_RING_I8
    alone, plain net-dtype rings without scales everywhere else."""
    knobs = dict(CORR_IMPL=impl, CORR_RING_I8=i8, MIXED_PRECISION=True)
    with _configured_impl():
        jcfg = JCFG.replace(**knobs)
        st = jengine.init_state(jcfg, HT, WD)
        banded = jengine._use_banded(jcfg)
    jring = st.fmap1b if banded else st.fmap1
    slam = DEVO(BASE.replace(**knobs), _weights(), ht=HT, wd=WD, device="cpu")
    want = {np.dtype(np.int8): torch.int8}.get(jring.dtype, torch.bfloat16)
    assert slam.fmap1.dtype == slam.fmap2.dtype == want
    assert str(jring.dtype) == {torch.int8: "int8"}.get(want, "bfloat16")
    assert slam.ring_i8 == (impl == "banded" and i8)
    assert (slam.fsc1 is None) == (st.fsc1.shape[0] == 0)
    if slam.fsc1 is not None:
        assert slam.fsc1.shape == slam.fsc2.shape == st.fsc1.shape
    # a float ring outside "banded" whatever CORR_RING_I8 says
    assert (jring.dtype == np.int8) == (impl == "banded" and i8)


@pytest.mark.parametrize("impl", CORR_IMPLS)
@pytest.mark.parametrize("mode", ["on", "auto"])
def test_resident_level_is_off_outside_banded(impl, mode):
    cfg = dict(CORR_IMPL=impl, CORR_RING_I8=True, CORR_KERNEL="split",
               CORR_L4_RESIDENT=mode)
    with _configured_impl():
        want = jengine._l4_resident(JCFG.replace(**cfg), HT, WD)
    got = l4_resident(BASE.replace(**cfg), HT, WD)
    assert got == want == (impl == "banded")


@pytest.mark.parametrize("kernel", ["split", "split2", "g8c"])
@pytest.mark.parametrize("mode", ["on", "auto"])
def test_resident_level_at_480x640(kernel, mode):
    """At the reference's width and 480x640 (30x40x128 level-4 frames)
    "auto" and "on" turn the resident level 4 on with int8 rings and a
    per-level kernel, as devo_tpu's _l4_resident does: its plan holds the
    frame beside 16 warps (bf16 patch features) or 9 (f32), and the rule
    does not depend on the patch features' type."""
    cfg = dict(CORR_IMPL="banded", CORR_RING_I8=True, CORR_KERNEL=kernel,
               CORR_L4_RESIDENT=mode)
    with _configured_impl():
        want = jengine._l4_resident(jconfig.VOConfig().replace(**cfg), 480, 640)
    for mixed in (True, False):
        got = l4_resident(VOConfig(MIXED_PRECISION=mixed, **cfg), 480, 640)
        assert got == want is True


@pytest.mark.parametrize("kernel", ["g8", "full"])
def test_g8_and_full_take_float_rings_only(kernel):
    gmap, fmap, coords, kk, jj, mask = make_case(0, E=8)
    ring = corr_pallas.band_frame_i8(fmap[0])[0][None]
    with pytest.raises(AssertionError, match="int8 rings"):
        corr_pallas.corr_level_banded(
            gmap, ring, coords, kk, jj * 0, mask, n_live=8,
            hp=corr_pallas.banded_shape(32, 40)[1], ablate=kernel,
            scale=np.ones((1,), np.float32))
    with pytest.raises(ValueError, match=f"CORR_KERNEL='{kernel}'"):
        DEVO(BASE.replace(CORR_KERNEL=kernel, CORR_RING_I8=True), _weights(),
             ht=HT, wd=WD, device="cpu")
    # float rings, or another family, whose rings are float anyway
    for knobs in (dict(CORR_RING_I8=False),
                  dict(CORR_RING_I8=True, CORR_IMPL="pallas")):
        slam = DEVO(BASE.replace(CORR_KERNEL=kernel, **knobs), _weights(),
                    ht=HT, wd=WD, device="cpu")
        assert slam.fmap1.dtype == torch.float32 and slam.fsc1 is None


@pytest.mark.parametrize("stage", STAGE_NAMES)
def test_stage_names_are_no_kernel(stage):
    assert STAGE_NAMES == ("noext", "nomm", "noDMA")
    with pytest.raises(ValueError, match="stage"):
        DEVO(BASE.replace(CORR_KERNEL=stage), _weights(), ht=HT, wd=WD,
             device="cpu")
    assert stage not in corr_cuda.KERNELS


# --- the engines -------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_features_match_devo_tpu_engine(name):
    st, jfeat = _jax_features(name)
    _, _, got = _port_run(name)
    ne = int(st.n_edges)
    assert not got["initialized"] and int(st.n) == FEAT_FRAMES
    # both tables are packed and (kk, jj)-sorted: rows line up
    np.testing.assert_array_equal(np.asarray(st.kk[:ne]), got["kk"])
    np.testing.assert_array_equal(np.asarray(st.jj[:ne]), got["jj"])
    # the configuration's path: a plain corr_level a level, or its tensor path
    assert got["counts"] == {"window": [0, 1, 0],
                             "gather": [0, 0, 1]}.get(name, [2, 0, 0])
    assert ne > FEAT_EDGES and got["feat"].shape == (FEAT_EDGES, 882)
    assert np.abs(jfeat).max() > 0.1
    np.testing.assert_allclose(got["feat"], jfeat, atol=5e-2, rtol=1e-2)


@pytest.mark.parametrize("name", ["window", "gather"])
def test_engine_decisions_match_devo_tpu_engine(name):
    _, records, _ = _port_run(name)
    _, jrecords, _ = _jax_run(name)
    for i, (g, w) in enumerate(zip(records, jrecords)):
        assert g["n"] == w["n"], f"frame {i}: keyframe count"
        assert g["cull"] == w["cull"], f"frame {i}: cull decision"
        assert g["edges"] == w["edges"], f"frame {i}: edge set"
        np.testing.assert_allclose(g["poses"], w["poses"], atol=5e-2,
                                   err_msg=f"frame {i}: poses diverged")
    assert sum(r["cull"] for r in records) >= 1, "no cull happened"
    assert not any(corr_cuda.launches.values())


@pytest.mark.parametrize("name", ["pallas", "g8", "full"])
def test_per_level_configurations_equal_gather_on_the_cpu(name):
    slam, records, _ = _port_run(name)
    _, ref, _ = _port_run("gather")
    assert slam.fmap1.dtype == torch.float32 and slam.fsc1 is None
    for i, (g, w) in enumerate(zip(records, ref)):
        assert g["n"] == w["n"] and g["cull"] == w["cull"], f"frame {i}"
        assert g["edges"] == w["edges"], f"frame {i}"
        np.testing.assert_array_equal(g["poses"], w["poses"])
    assert sum(r["cull"] for r in records) >= 1
