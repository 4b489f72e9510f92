"""The parts of chip_smoke.py that run on the CPU: the order of the kernel
work (rule2_loss), which charges each path's launches at the variant that
path runs (path_variants: the ring type of the path's configuration by the
engine's rule), on a made-up record of the kernel phase and the paths'
launches.
"""
import numpy as np
import pytest
import torch

import chip_smoke

E = chip_smoke.E_MAIN


def _kernel(name, reported, variants):
    """A made-up entry of the kernels' JSON record: the reported variant's
    (ms, bound_ms) and every variant's {label: (ms, bound_ms)} at E_MAIN,
    with a decoy at another E that must not be read."""
    return dict(name=name, ms=reported[0], bound_ms=reported[1], variants=[
        dict(label=label, E=E, ms=ms, bound_ms=b)
        for label, (ms, b) in variants.items()] + [
        dict(label=label, E=96, ms=100.0, bound_ms=0.0) for label in variants])


KERNELS = [
    _kernel("corr_pair", (0.568, 0.0361), {"both levels i8": (0.568, 0.0361),
                                           "both levels bf16": (0.70, 0.057)}),
    _kernel("corr_group8", (0.5316, 0.0476),
            {"level 1 bf16": (0.5316, 0.0476), "level 4 bf16": (0.4962, 0.0118)}),
    _kernel("corr_pyramid", (0.26, 0.0361), {"both levels i8": (0.26, 0.0361),
                                             "both levels bf16": (0.28, 0.057)}),
    _kernel("corr_level", (0.26, 0.0282),
            {"level 1 i8": (0.26, 0.0282), "level 4 i8": (0.25, 0.0103)}),
    _kernel("corr_level_resident", (0.39, 0.0103), {"level 4 i8": (0.39, 0.0103)}),
    _kernel("corr_mono2", (0.42, 0.0361),
            {"both levels i8 gathered": (0.42, 0.0361),
             "both levels i8 in place": (0.34, 0.0361)}),
    _kernel("corr_level_pipe", (0.2958, 0.0282),
            {"level 1 i8": (0.2958, 0.0282), "level 4 i8": (0.3129, 0.0103),
             "level 1 bf16": (0.3861, 0.0476),
             "level 4 bf16": (0.3969, 0.0118)}),
    _kernel("corr_level_full", (0.4948, 0.0476),
            {"level 1 bf16": (0.4948, 0.0476), "level 4 bf16": (0.4342, 0.0118),
             "level 1 f32": (0.7402, 0.0883), "level 4 f32": (0.6130, 0.0217)}),
]


def _losses(by_path):
    paths = {label: {k["name"]: 0 for k in KERNELS} | launched
             for label, launched in by_path.items()}
    return chip_smoke.rule2_loss(KERNELS, paths, list(paths))


def test_bf16_path_and_two_level_kernel_at_their_own_variants():
    """K5' on its bf16 eval path at its bf16 time and bound (not the int8
    one the JSON record reports), K9''s launches half at level 1 and half at
    level 4 (not all at level 1), K1 on an int8 and a bf16 path each at its
    own ring."""
    loss = _losses({"eval-eds-bf16-pair": {"corr_pair": 142},
                    "bf16-g8": {"corr_group8": 142},
                    "i8-mono": {"corr_pyramid": 71},
                    "bf16-mono": {"corr_pyramid": 71}})
    assert loss["corr_pair"] == pytest.approx(142 * (0.70 - 0.057))
    assert loss["corr_group8"] == pytest.approx(
        71 * (0.5316 - 0.0476) + 71 * (0.4962 - 0.0118))
    assert loss["corr_pyramid"] == pytest.approx(
        71 * (0.26 - 0.0361) + 71 * (0.28 - 0.057))
    assert loss["corr_level"] == loss["corr_mono2"] == 0


def test_resident_level_mono4_and_drivers():
    """corr_level beside the resident level-4 kernel runs level 1 alone; the
    in-place bench path runs corr_mono2 in place; a driver of DRIVERS, at
    its own shapes, is charged at the reported variant."""
    loss = _losses({"i8-split-resident": {"corr_level": 79,
                                          "corr_level_resident": 79},
                    "bench-12288-mono4": {"corr_mono2": 112},
                    "bench-12288-split2": {"corr_level": 0},
                    "probe_level_split": {"corr_level": 10}})
    assert loss["corr_level"] == pytest.approx(
        79 * (0.26 - 0.0282) + 10 * (0.26 - 0.0282))
    assert loss["corr_level_resident"] == pytest.approx(79 * (0.39 - 0.0103))
    assert loss["corr_mono2"] == pytest.approx(112 * (0.34 - 0.0361))
    assert chip_smoke.path_variants("corr_level", "probe_level_split", {}) is None
    assert chip_smoke.path_variants("corr_level", "bench-12288-split2", {}) == [
        ("level 1 i8", 0.5), ("level 4 i8", 0.5)]


def test_split2_and_full_paths_at_their_levels_and_rings():
    """K7'' on the int8 bench path and K10'' on the bf16 slice path: each
    path's launches half at level 1 and half at level 4, at its own ring
    type (int8 for the bench's default CORR_RING_I8, bf16 for "bf16-full"),
    never at the other ring's times."""
    assert chip_smoke.path_variants(
        "corr_level_pipe", "bench-12288-split2", {"corr_level_pipe": 224}) == [
        ("level 1 i8", 0.5), ("level 4 i8", 0.5)]
    assert chip_smoke.path_variants(
        "corr_level_full", "bf16-full", {"corr_level_full": 142}) == [
        ("level 1 bf16", 0.5), ("level 4 bf16", 0.5)]
    loss = _losses({"bench-12288-split2": {"corr_level_pipe": 224},
                    "bf16-full": {"corr_level_full": 142}})
    assert loss["corr_level_pipe"] == pytest.approx(
        112 * (0.2958 - 0.0282) + 112 * (0.3129 - 0.0103))
    assert loss["corr_level_full"] == pytest.approx(
        71 * (0.4948 - 0.0476) + 71 * (0.4342 - 0.0118))
    # bf16 rings on the split2 kernel are measured too, and charged as such
    # where a path runs them
    loss = _losses({"bf16-mono": {"corr_level_pipe": 2}})
    assert loss["corr_level_pipe"] == pytest.approx(
        (0.3861 - 0.0476) + (0.3969 - 0.0118))


def test_ring_type_comes_from_the_configuration(monkeypatch):
    """A path's ring type is the engine's (runtime/engine.ring_i8), not a
    word of its label: a renamed path with CORR_RING_I8=False runs bf16
    rings; CORR_RING_I8 under CORR_IMPL="pallas", which only "banded"
    reads, leaves them bf16; the bench and the g8c launch count keep the
    default int8 rings."""
    monkeypatch.setitem(chip_smoke.PATHS, "mono-renamed",
                        (dict(CORR_RING_I8=False), ("corr_pyramid",)))
    monkeypatch.setitem(chip_smoke.PATHS, "pallas-i8-knob",
                        (dict(CORR_IMPL="pallas", CORR_RING_I8=True),
                         ("corr_fixed",)))
    assert chip_smoke.path_variants("corr_pyramid", "mono-renamed", {}) == [
        ("both levels bf16", 1.0)]
    assert chip_smoke.path_variants("corr_fixed", "pallas-i8-knob", {}) == [
        ("level 1 bf16", 0.5), ("level 4 bf16", 0.5)]
    assert chip_smoke.path_variants("corr_pyramid", "bench-12288-mono", {}) == [
        ("both levels i8", 1.0)]
    assert chip_smoke.path_variants("corr_group", chip_smoke.G8C_LAUNCHES,
                                    {}) == [("level 1 i8", 0.5),
                                            ("level 4 i8", 0.5)]
    loss = _losses({"mono-renamed": {"corr_pyramid": 10}})
    assert loss["corr_pyramid"] == pytest.approx(10 * (0.28 - 0.057))


def test_a_variant_not_measured_raises():
    """A tracking path whose variant the kernel phase did not measure is not
    charged at another: corr_level on bf16 rings (measured on int8 alone in
    the made-up record) raises, and so does a label of no path."""
    with pytest.raises(KeyError, match="level 1 bf16"):
        _losses({"bf16-mono": {"corr_level": 3}})
    with pytest.raises(KeyError, match="no tracking path"):
        chip_smoke.path_variants("corr_pyramid", "no-such-path", {})


def _tracking_paths():
    """(label, kernels it launches) of every tracking path that launches
    one: the slice, eval and bench paths, the g8c launch count and the
    live event input."""
    out = [(label, names) for label, (_, names) in chip_smoke.PATHS.items()]
    out += [(label, (name,)) for label, (_, name, _) in chip_smoke.EVAL_PATHS.items()]
    out += [(label, (name,)) for label, (_, name, _) in chip_smoke.FRAME_PATHS.items()]
    out += [(label, (name,))
            for label, (_, _, name) in chip_smoke.BENCH_PATHS.items()]
    out.append((chip_smoke.G8C_LAUNCHES, ("corr_group",)))
    out.append((chip_smoke.LIVE_PATH, ("corr_pyramid",)))
    return [(label, names) for label, names in out if names]


@pytest.mark.parametrize("label,names", _tracking_paths(),
                         ids=[label for label, _ in _tracking_paths()])
def test_every_tracking_path_runs_a_measured_variant(label, names):
    """Each kernel a tracking path launches is charged at variants that the
    kernel phase measures (chip_smoke.variants, whose labels a tiny CPU case
    gives without launching anything), with shares that sum to one: the
    order lines at the end of a card run cannot raise for want of one."""
    g = torch.zeros(2, 3, 3, 8, dtype=torch.bfloat16)
    bf = (torch.zeros(2, 8, 8, 8, dtype=torch.bfloat16),
          torch.zeros(2, 2, 2, 8, dtype=torch.bfloat16))
    i8 = tuple(r.to(torch.int8) for r in bf)
    sc = (torch.ones(2), torch.ones(2))
    idx = torch.zeros(4, dtype=torch.int32)
    case = (g, bf, i8, sc, torch.zeros(4, 3, 3, 2), idx, idx)
    measured = {(name, what) for name, what, *_ in chip_smoke.variants(case)}
    launched = dict.fromkeys(names, 1)
    for name in names:
        parts = chip_smoke.path_variants(name, label, launched)
        assert sum(share for _, share in parts) == pytest.approx(1.0)
        for variant, _ in parts:
            assert (name, variant) in measured


def test_split_resident_path_charges_level_1_and_the_resident_level_4():
    """The i8-split-resident path runs K6'' at level 1 alone and K11'' at
    level 4, both on int8 rings: each launch at that variant's time and
    bound, never half at the other level."""
    launched = {"corr_level": 79, "corr_level_resident": 79}
    assert chip_smoke.path_variants("corr_level", "i8-split-resident",
                                    launched) == [("level 1 i8", 1.0)]
    assert chip_smoke.path_variants("corr_level_resident", "i8-split-resident",
                                    launched) == [("level 4 i8", 1.0)]
    loss = _losses({"i8-split-resident": launched})
    assert loss["corr_level"] == pytest.approx(79 * (0.26 - 0.0282))
    assert loss["corr_level_resident"] == pytest.approx(79 * (0.39 - 0.0103))


def test_parent_sources_and_what_the_ab_compares():
    """--parent builds the parent's K13'', K15'' and K14'' with their
    headers beside the kernels that include corr_mma.cuh; the A/B holds
    every kernel on the edge pipeline, K6'' and K11'' among them, and K13''
    in every mode on the random layout and K15'' with and without
    extraction (unchanged since the parent) to the parent's bits, and K14''
    in five modes on both copy routes (and `single` on one block) to the
    parent's exact output."""
    for name in ("corr_band_ablate.cu", "corr_frame_probe.cu", "copy_probe.cu",
                 "window_probe.cuh", "corr_level.cu", "corr_level_resident.cu",
                 "corr_pipe.cuh", "corr_mma.cuh", "corr_common.cuh",
                 "corr_level_pipe.cu", "corr_level_full.cu"):
        assert name in chip_smoke.PARENT_SOURCES
    ab = chip_smoke.parent_ab()
    assert len(set(ab)) == len(ab)
    assert {rule for _, _, rule in ab} == {"bits"}
    bits = {name for name, _, rule in ab if rule == "bits"}
    assert bits == {"corr_pyramid", "corr_pair", "corr_pair2", "corr_mono2",
                    "corr_mono3", "corr_group", "corr_group8",
                    "corr_level_pipe", "corr_level_full", "corr_level",
                    "corr_level_resident", "copy_probe", "corr_band_ablate",
                    "corr_frame_probe"}
    assert {label for name, label, _ in ab if name == "corr_band_ablate"} == {
        f"random {mode}" for mode in ("full", "noext", "nomm", "noDMA")}
    assert {label for name, label, _ in ab if name == "corr_frame_probe"} == {
        "extract=True", "extract=False"}
    assert {label for name, label, _ in ab if name == "copy_probe"} == {
        f"{mode} {route}" for mode in ("single", "pair", "tall4", "dual", "local")
        for route in ("cp.async", "bulk")} | {
        f"single {route}, one block" for route in ("cp.async", "bulk")}
    assert {name for name, _, _ in ab} >= set(chip_smoke.PROBE_REPORTED)


def test_level_structures_put_k6_beside_k7():
    """K6'' (P) is timed beside K7'' on both ring types, and every one-level
    instance timed there is a kernel of the record; the kernel record names
    every kernel of the port."""
    names = {ring: [name for _, name in chip_smoke.LEVEL_STRUCTURES[ring]]
             for ring in ("i8", "bf16")}
    for ring in ("i8", "bf16"):
        assert names[ring][:2] == ["corr_level_pipe", "corr_level"]
        assert set(names[ring]) <= set(chip_smoke.KERNELS)
    assert len(chip_smoke.KERNELS) == 15
    assert chip_smoke.COUNTERS["split"] == ("corr_level",)


def test_frame_staged_counts_groups_within_block_runs():
    """corr_frame_probe's grouping rule, worked out on the host (the card
    run holds the kernel's own count to it): groups of up to 3
    consecutive edges of one origin in the sorted order, never across a
    block's run. Origins (by edge) 5, 5, 5, 5, 2, 9, 9: sorted 2 | 5 5 5 5 |
    9 9, so one block stages 2, (5 5 5), (5), (9 9): 4 windows; two blocks
    (runs of 3 and 4: 2 5 5 | 5 5 9 9) stage 2, (5 5), (5 5), (9 9): 4; seven
    blocks stage 7."""
    y0 = torch.tensor([[5], [5], [5], [5], [2], [9], [9]], dtype=torch.int32)
    x08 = torch.zeros_like(y0)
    inputs = (torch.zeros(16, 24, 1), None, y0, x08)
    for grid, windows in ((1, 4), (2, 4), (7, 7)):
        assert chip_smoke.frame_staged(inputs, 3, grid) == windows


def test_frame_and_gradient_paths_charge_k1_at_bf16():
    """The frame-input path (the frame drivers' configuration on the eval
    base's bf16 rings) and the gradient-selector eval path run K1 at bf16
    on both levels; rule2_loss charges their launches there."""
    for label in ("frames-rgb-random", "tum-rgb-random",
                  "eval-eds-bf16-gradient"):
        assert chip_smoke.path_variants("corr_pyramid", label,
                                        {"corr_pyramid": 79}) == [
            ("both levels bf16", 1.0)]
    cfg = chip_smoke.path_config("frames-rgb-random")
    assert (cfg.EVS, cfg.BINS, cfg.PATCH_SELECTOR) == (False, 3, "random")
    assert chip_smoke.path_config("eval-eds-bf16-gradient").PATCH_SELECTOR == \
        "gradient"
    loss = _losses({"frames-rgb-random": {"corr_pyramid": 79},
                    "eval-eds-bf16-gradient": {"corr_pyramid": 79}})
    assert loss["corr_pyramid"] == pytest.approx(2 * 79 * (0.28 - 0.057))
    # each runs one trial
    assert chip_smoke.EVAL_PATHS["eval-eds-bf16-gradient"][2] == 1
    assert chip_smoke.FRAME_PATHS["frames-rgb-random"][2] == 1


def test_reference_phase_lists_the_new_configurations():
    """The frame input with the random selector and the gradient selector
    (top-k) are among the reference configurations, and each of them
    builds a VOConfig over the phase's small base."""
    from devo_tpu_torch.runtime.config import VOConfig
    frames = chip_smoke.REFERENCE["f32 rings frames random"]
    assert (frames["EVS"], frames["BINS"], frames["PATCH_SELECTOR"]) == (
        False, 3, "random")
    assert chip_smoke.REFERENCE["f32 rings gradient topk"][
        "PATCH_SELECTOR"] == "gradient"
    assert len(chip_smoke.REFERENCE) == 24
    # TUM-RGBD's aspect at the phase's scale
    tum = VOConfig(**{**chip_smoke.REF_BASE, **chip_smoke.REFERENCE[
        "f32 rings frames random 64x88"]})
    assert (tum.HT, tum.WD, tum.EVS) == (64, 88, False)
    # one bound for every configuration: the tolerance, or twice the CPU's
    # own spread under four one-ulp moves of its inputs where that is larger
    assert chip_smoke.REF_SPREAD == 2.0
    assert {what for what, _ in chip_smoke.REF_MOVES.values()} == {
        "frames", "weights", "depths"}
    for knobs in chip_smoke.REFERENCE.values():
        cfg = VOConfig(**{**chip_smoke.REF_BASE, **knobs})
        assert cfg.SCORER_EVAL_MODE == "topk" and not cfg.MIXED_PRECISION


def test_ulp_move_moves_each_nonzero_entry_one_step():
    a = np.asarray([0.0, 1.0, -2.5, 255.0, 1e-30], np.float32)
    for toward in (np.inf, -np.inf):
        b = chip_smoke.ulp_move(a, toward)
        assert b.dtype == np.float32 and b[0] == 0.0
        np.testing.assert_array_equal(b[1:], np.nextafter(a[1:], np.float32(toward)))
        assert (b[1:] != a[1:]).all()


def test_reference_knobs_take_overrides():
    """`chip_smoke.py --reference LABEL[:KEY=VALUE,...]`: the entry's knobs
    with the overrides read as literals; an unknown label raises."""
    knobs = chip_smoke.reference_knobs(
        "f32 rings gradient topk:PATCHES_PER_FRAME=16, KEYFRAME_THRESH=15.0")
    assert knobs == {**chip_smoke.REFERENCE["f32 rings gradient topk"],
                     "PATCHES_PER_FRAME": 16, "KEYFRAME_THRESH": 15.0}
    assert chip_smoke.reference_knobs("i8-mono") == chip_smoke.REFERENCE["i8-mono"]
    with pytest.raises(KeyError):
        chip_smoke.reference_knobs("f32 rings nothing")


def test_reference_phase_holds_the_cpu_to_itself(capsys, monkeypatch):
    """The reference phase's comparisons, run with the CPU in the card's
    place on the configuration that needs no kernel ("window"): the same
    decisions, edge sets and patch coordinates, no gap, and a spread of the
    moved CPU runs that is nonzero and far inside the tolerance. A second
    run gives the CPU's bits again and takes the spread measured."""
    import re
    monkeypatch.setattr(chip_smoke, "REF_SPREADS", {})
    # one thread: beside other test processes the small engines' many tiny
    # parallel regions oversubscribe the cores and take minutes, not seconds
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for _ in range(2):
            chip_smoke.reference_phase(torch.device("cpu"), "cpu",
                                       "f32 rings window",
                                       chip_smoke.REFERENCE["f32 rings window"])
    finally:
        torch.set_num_threads(threads)
    assert len(chip_smoke.REF_SPREADS) == 1
    line = capsys.readouterr().out.splitlines()[-1]
    assert "edge sets and patch coordinates" in line
    # (gap, spread) over the frames and at terminate() before and after
    pairs = re.findall(r"(\d\.\d+e[-+]\d+) \((\d\.\d+e[-+]\d+)\)", line)
    assert len(pairs) == 3
    for gap, spread in pairs:
        assert float(gap) == 0.0
        assert 0 < float(spread) < chip_smoke.REF_TOL[False] / 10


def test_train_pieces_run_before_the_profiled_slice():
    """main runs the train_pieces phase after the bench paths and before
    the profiled slice, after which nothing is timed."""
    import inspect
    src = inspect.getsource(chip_smoke.main)
    assert src.index("train_pieces_phase(dev, gpu)") < src.index(
        "run_slice(PROFILED)")
    assert src.index("BENCH_PATHS.items()") < src.index("train_pieces_phase")
    assert src.index("FRAME_PATHS.items()") < src.index("BENCH_PATHS.items()")


def test_rgb_stream_and_ba_scene():
    """The frame path's frames: 3-channel, 0-255, from memory; the
    train_pieces phase's BA scene: tests/test_ba.py's sizes."""
    stream = chip_smoke.rgb_stream(2)
    assert len(stream) == 2 and stream[0].shape == (3, chip_smoke.HT,
                                                    chip_smoke.WD)
    assert stream[0].min() >= 0 and stream[0].max() <= 255
    assert not np.array_equal(stream[0], stream[1])
    tum = chip_smoke.rgb_stream(1, *chip_smoke.FRAME_SIZES["tum-rgb-random"])
    assert tum[0].shape == (3, 256, 352)
    poses, patches, intr, ii, jj, kk, target, mask, weight = chip_smoke.ba_scene()
    assert poses.shape == (8, 7) and patches.shape == (192, 27)
    assert ii.shape == jj.shape == kk.shape == mask.shape == (864,)
    assert target.shape == weight.shape == (864, 2) and not mask.all()


# ------------------------------------------------------------ train phase

@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_train_clip_moves_as_its_texture():
    """The synthetic training clip: the bench's sliding texture, a camera
    moving along x at constant disparity, so that a point's reprojection
    from frame 0 into frame i moves it 3 * i pixels left, as the texture
    moves."""
    batch = chip_smoke.train_clip(5, 32, 48)
    vox, poses, disps, intr = (batch[k][0] for k in
                               ("voxels", "poses", "disps", "intrinsics"))
    assert vox.shape == (5, 32, 48, 5) and disps.shape == (5, 32, 48)
    assert torch.equal(vox[1][:, :45], vox[0][:, 3:])      # 3 px a frame
    fx, d = float(intr[0]), float(disps[0, 0, 0])
    assert torch.all(disps == d) and torch.all(poses[:, 3:6] == 0)
    # w2c translation -3 i / (fx d): a point at x in frame 0 lies at
    # x - fx * d * (3 i / (fx d)) = x - 3 i in frame i
    np.testing.assert_allclose(poses[:, 0].numpy() * fx * d,
                               -3.0 * np.arange(5), rtol=1e-6)


def test_train_against_cpu_with_the_cpu_in_both_places(two_threads):
    """The card-against-CPU step with the CPU in the card's place: the
    same draws and weights give the same bits."""
    out = chip_smoke.train_against_cpu(torch.device("cpu"))
    assert out["loss_rel"] == out["grad_rel"] == out["param_abs"] == 0.0
    assert out["nonfinite"] == (0, 0) and np.isfinite(out["loss"])
    assert out["param_bound"] == pytest.approx(2 * 8e-5 / 25)


def test_stability_verdict_rule():
    from devo_tpu_torch.scripts.train_stability import verdict
    falls = [5.0] * 10 + list(np.linspace(4.0, 2.0, 90))
    assert verdict(falls, [0] * 100, 10)["pass"]
    assert not verdict(falls, [0] * 99 + [1], 10)["pass"]
    assert not verdict(falls[:10] + falls[10:][::-1], [0] * 100, 10)["pass"]
    # the structure-only head is not compared
    v = verdict([0.1] * 10 + [3.0] * 80 + [2.0] * 10, [0] * 100, 10)
    assert v["pass"] and v["fullphase_head"] == 3.0


def test_train_drivers_run_at_a_tiny_size_on_the_cpu(capsys, two_threads):
    """scripts/train_step and scripts/train_stability through their main()
    with --device cpu at a tiny size: one JSON line each."""
    import json
    from devo_tpu_torch.scripts import train_stability, train_step
    rc = train_step.main(["--device", "cpu", "--height", "48", "--width", "64",
                          "--n_frames", "5", "--iters", "2", "--ppi", "4",
                          "--grow_after", "1", "--dims", "32", "16", "8",
                          "--steps", "2", "--remat", "both", "--profile"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert rc == 0 and [r["remat"] for r in lines] == [True, False]
    for r in lines:
        assert r["finite"] and r["params_changed"] and r["card"] == "cpu"
        assert r["grad_nonfinite"] == [0, 0] and len(r["steps_ms"]) == 2
        assert r["top_ops"][0][0] == "(all)" and len(r["top_ops"]) > 5
    rc = train_stability.main(["--device", "cpu", "--steps", "6", "--height",
                               "48", "--width", "64"])
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["grad_nonfinite_total"] == 0 and out["steps"] == 6
    assert rc == (0 if out["pass"] else 1)


def test_train_drivers_refuse_a_machine_without_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from devo_tpu_torch.scripts import train_stability, train_step
    for mod in (train_step, train_stability):
        with pytest.raises(SystemExit, match="no CUDA device"):
            mod.main([])


def test_more_moves_are_one_ulp_moves_of_the_inputs():
    """--more-moves adds moves of the same kind (one ulp toward +-inf) to
    REF_MOVES, of inputs both engines take."""
    assert not set(chip_smoke.REF_MOVES) & set(chip_smoke.REF_MORE_MOVES)
    for what, toward in chip_smoke.REF_MORE_MOVES.values():
        assert what in ("frames", "weights", "depths", "intrinsics")
        assert toward in (np.inf, -np.inf)
    assert len({**chip_smoke.REF_MOVES, **chip_smoke.REF_MORE_MOVES}) == 8


def test_tum_path_and_the_tail_phases_helpers():
    """The TUM frame path runs at eval/frames' size with its scaled
    freiburg1 intrinsics (the others at the bench's); the live path's
    configuration is the default's (int8 rings, K1); its event windows fall
    on the texture, in the frame's 1/30 s, sorted; main runs the viewer and
    live phases among the eval paths and the trace phase after the profiled
    slice."""
    import inspect
    from devo_tpu_torch.eval import frames
    from devo_tpu_torch.runtime.config import VOConfig
    assert chip_smoke.FRAME_SIZES["tum-rgb-random"] == (frames.TUM_H,
                                                        frames.TUM_W)
    np.testing.assert_array_equal(
        chip_smoke.stream_intrinsics("tum-rgb-random", 256, 352),
        frames.tum_intrinsics())
    np.testing.assert_array_equal(
        chip_smoke.stream_intrinsics("frames-rgb-random", 480, 640),
        [320.0, 320.0, 320.0, 240.0])
    with pytest.raises(RuntimeError, match="256x352"):
        chip_smoke.stream_intrinsics("tum-rgb-random", 480, 640)
    assert chip_smoke.path_config(chip_smoke.LIVE_PATH) == VOConfig(
        CORR_RING_I8=True, CORR_KERNEL="mono", CORR_L4_RESIDENT="off")
    assert chip_smoke.path_variants(
        "corr_pyramid", chip_smoke.LIVE_PATH, {"corr_pyramid": 1}) == [
        ("both levels i8", 1.0)]
    from devo_tpu_torch.bench import frame, texture
    base = texture(32, 48).sum(-1)
    for i, (x, y, t, p) in enumerate(chip_smoke.event_stream(2, 32, 48)):
        assert x.dtype == y.dtype == np.float32 and p.dtype == np.int8
        assert (np.diff(t) >= 0).all() and t[0] >= i * 33_333
        assert t[-1] < (i + 1) * 33_333
        f = frame(base[..., None], i)[..., 0]
        xi, yi = x.astype(int), y.astype(int)
        assert (f[yi, xi] != 0).all()
        assert (np.sign(f[yi, xi]) == p).all()
    src = inspect.getsource(chip_smoke.main)
    assert src.index("FRAME_PATHS.items()") < src.index("viewer_phase(")
    assert src.index("live_phase(") < src.index("BENCH_PATHS.items()")
    assert src.index("run_slice(PROFILED)") < src.index("trace_phase(")
