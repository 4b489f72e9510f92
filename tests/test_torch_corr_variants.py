"""Port parity for the functions of the kernels "mono2", "mono4", "mono3",
"split2" and "g8c".

csrc/corr_mono2.cu and csrc/corr_mono3.cu compute the plain
`ops/corr.corr_pyramid`, csrc/corr_level_pipe.cu the plain `corr_level`, and
csrc/corr_group.cu with `extract_blend_group` the plain `corr_level_group`;
on the card they are held against those by tests/test_torch_corr_cuda.py.
Here the plain versions are held against the JAX package's own Pallas
kernels (_kernel_banded_mono with step2 / adj2, _kernel_banded_mono3,
_kernel_banded_split2, _kernel_banded_g8c with extract_blend_g8), run in
interpret mode on the CPU as tests/test_corr_pallas.py runs them: E = 24
edges of that file's make_case (inside the TPU kernels' window budget, so
their tap clip does not bite), hw = (32, 40), levels (1, 2), wins (16, 12).
Tolerances are the JAX tests' own budgets: atol 0.12 for the mono variants
(bf16 strips add one rounding to the int8 quantisation and the bf16
products), 5e-2 for split2 and g8c, rtol 1e-2.

`corr_level_group` against `corr_level`: every tap is rounded once to bf16,
so a tap is off by at most half an ulp, 2^-8 of its size, and an output, a
convex combination of taps, by at most 2^-8 of the largest tap.

Also: on CPU tensors the entry point takes the plain version bitwise under
each new name and launches nothing, the CORR_L4_RESIDENT rule for the new
names, and the shared-memory plans of the new wrappers at C = 128.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from devo_tpu.ops import corr_pallas
from devo_tpu_torch.ops import corr as corr_plain
from devo_tpu_torch.ops import corr_cuda
from devo_tpu_torch.runtime.config import VOConfig
from devo_tpu_torch.runtime.engine import l4_resident

from test_corr_pallas import make_case
from test_torch_corr_level import (BF, HP, _banded_i8, _masked, _pool2,
                                   _quantize_ring, _t)

MONO = pytest.mark.parametrize("variant", ["mono2", "mono3", "mono4"])


def _jax_pyramid(gmap, pyr, coords, kk, jj, mask, scales, variant):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(corr_pallas.corr_pyramid_banded(
            gmap, pyr, coords, kk, jj, mask, n_live=coords.shape[0],
            hw=(32, 40), levels=(1, 2), scales=scales, wins=(16, 12),
            variant=variant), np.float32)


def _jax_level(gmap, fmap_b, coords, kk, jj, mask, ablate, scale=None):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(corr_pallas.corr_level_banded(
            gmap, fmap_b, coords, kk, jj, mask, n_live=coords.shape[0],
            hp=HP, ablate=ablate, scale=scale), np.float32)


@MONO
@pytest.mark.parametrize("seed", [0, 3])
def test_corr_pyramid_matches_jax_mono_variants_i8(seed, variant):
    gmap, fmap, coords, kk, jj, mask = make_case(seed, E=24)
    levels = (fmap, _pool2(fmap))
    banded = [_banded_i8(fm) for fm in levels]
    want = _jax_pyramid(gmap, tuple(b for b, _ in banded), coords, kk, jj,
                        mask, tuple(s for _, s in banded), variant)
    rings = [_quantize_ring(fm) for fm in levels]
    got = corr_plain.corr_pyramid(
        _t(gmap).to(BF), tuple(r for r, _ in rings), _t(coords), _t(kk),
        _t(jj), levels=(1, 2), scales=tuple(s for _, s in rings))
    assert got.shape == (24, 2 * 49 * 9) and got.dtype == torch.float32
    np.testing.assert_allclose(_masked(got, mask), want, atol=0.12, rtol=1e-2)


@MONO
def test_corr_pyramid_matches_jax_mono_variants_bf16(variant):
    gmap, fmap, coords, kk, jj, mask = make_case(5, E=24)
    levels = (fmap, _pool2(fmap))
    pyr = tuple(jnp.stack([corr_pallas.band_frame(f) for f in fm])
                for fm in levels)
    want = _jax_pyramid(gmap, pyr, coords, kk, jj, mask, None, variant)
    got = corr_plain.corr_pyramid(
        _t(gmap).to(BF), tuple(_t(fm).to(BF) for fm in levels), _t(coords),
        _t(kk), _t(jj), levels=(1, 2))
    np.testing.assert_allclose(_masked(got, mask), want, atol=0.12, rtol=1e-2)


@pytest.mark.parametrize("i8", [False, True], ids=["bf16", "i8"])
def test_corr_level_matches_jax_split2_kernel(i8):
    gmap, fmap, coords, kk, jj, mask = make_case(3, E=24)
    if i8:
        fmap_b, scale = _banded_i8(fmap)
        ring, sc = _quantize_ring(fmap)
    else:
        fmap_b = jnp.stack([corr_pallas.band_frame(f) for f in fmap])
        scale, ring, sc = None, _t(fmap).to(BF), None
    want = _jax_level(gmap, fmap_b, coords, kk, jj, mask, "split2", scale)
    got = corr_plain.corr_level(_t(gmap).to(BF), ring, _t(coords), _t(kk),
                                _t(jj), sc)
    np.testing.assert_allclose(_masked(got, mask), want, atol=5e-2, rtol=1e-2)


@pytest.mark.parametrize("i8,seed", [(False, 0), (False, 3), (True, 1)],
                         ids=["bf16-0", "bf16-3", "i8-1"])
def test_corr_level_group_matches_jax_g8c_kernel(i8, seed):
    gmap, fmap, coords, kk, jj, mask = make_case(seed, E=24)
    if i8:
        fmap_b, scale = _banded_i8(fmap)
        ring, sc = _quantize_ring(fmap)
    else:
        fmap_b = jnp.stack([corr_pallas.band_frame(f) for f in fmap])
        scale, ring, sc = None, _t(fmap).to(BF), None
    want = _jax_level(gmap, fmap_b, coords, kk, jj, mask, "g8c", scale)
    args = (_t(gmap).to(BF), ring, _t(coords), _t(kk), _t(jj), sc)
    got = corr_plain.corr_level_group(*args)
    assert got.shape == (24, 49 * 9) and got.dtype == torch.float32
    np.testing.assert_allclose(_masked(got, mask), want, atol=5e-2, rtol=1e-2)
    # both round their products to bf16 at the same place: most outputs
    # agree far inside the budget
    close = np.abs(_masked(got, mask) - want) <= 1e-3
    assert close.mean() > 0.9


def _wide_case(seed, E=40):
    """make_case with every second patch distorted beyond 144 window
    positions (its pixels moved 3 px each on their own)."""
    gmap, fmap, coords, kk, jj, _ = make_case(seed, E=E)
    rng = np.random.default_rng(seed)
    coords = np.array(coords)
    coords[::2] += 3.0 * rng.standard_normal(coords[::2].shape).astype(np.float32)
    coords[1::8] = np.round(coords[1::8])            # and some on the grid
    return gmap, fmap, jnp.asarray(coords), kk, jj


@pytest.mark.parametrize("i8", [False, True], ids=["bf16", "i8"])
@pytest.mark.parametrize("E", [40, 37, 3])
def test_corr_level_group_is_corr_level_within_the_bf16_budget(i8, E):
    """Also on windows beyond the surface's rows (such an edge keeps its
    taps in the rows), with a last group that is not full, and on
    coordinates on the integer grid."""
    gmap, fmap, coords, kk, jj = _wide_case(2, E)
    ring, sc = _quantize_ring(fmap) if i8 else (_t(fmap).to(BF), None)
    args = (_t(gmap).to(BF), ring, _t(coords), _t(kk), _t(jj), sc)
    wide = corr_plain._group_index(args[2], corr_plain.GROUP_ROWS)[-1]
    assert 0 < int(wide.sum()) < E
    surface = corr_plain.group_surface(*args[:5])
    assert surface.shape == (-(-E // 8), 144, 128)
    assert surface.dtype == torch.bfloat16
    got = corr_plain.corr_level_group(*args)
    want = corr_plain.corr_level(*args)
    top = surface.float().abs().max().item()
    top *= sc.max().item() if i8 else 1.0
    err = (got - want).abs().max().item()
    assert 0 < err <= 2.0 ** -8 * top
    # a smaller window capacity moves edges to the tap rows and changes
    # no number
    small = corr_plain.extract_blend_group(
        corr_plain.group_surface(*args[:5], cap=100), args[2], args[4],
        ring.shape[1:3], sc, cap=100)
    assert torch.equal(small, got)


def test_corr_level_group_edge_cases():
    gmap, fmap, coords, kk, jj, _ = make_case(2, E=8, coord_range=(-300, -200))
    args = (_t(gmap), _t(fmap), _t(coords), _t(kk), _t(jj))
    got = corr_plain.corr_level_group(*args)
    assert torch.equal(got, torch.zeros_like(got))         # all off the image
    empty = corr_plain.corr_level_group(args[0], args[1], args[2][:0],
                                        args[3][:0], args[4][:0])
    assert empty.shape == (0, 441)
    ring, sc = _quantize_ring(fmap)
    with pytest.raises(ValueError):
        corr_plain.corr_level_group(args[0], ring, *args[2:])      # no scale
    with pytest.raises(ValueError):
        corr_plain.corr_level_group(*args, sc)                     # float ring


@pytest.mark.parametrize("kernel", ["mono2", "mono3", "mono4", "split2", "g8c"])
@pytest.mark.parametrize("i8", [False, True], ids=["float", "i8"])
def test_new_kernels_on_cpu_tensors_take_the_plain_version(kernel, i8):
    gmap, fmap, coords, kk, jj, _ = make_case(4, E=16, C=16)
    levels = (fmap, _pool2(_pool2(fmap)))
    if i8:
        rings = [_quantize_ring(fm) for fm in levels]
        pyr, scales = tuple(r for r, _ in rings), tuple(s for _, s in rings)
    else:
        pyr, scales = tuple(_t(fm) for fm in levels), None
    args = (_t(gmap), pyr, _t(coords), _t(kk).int(), _t(jj).int())
    launches, calls = dict(corr_cuda.launches), corr_plain.calls
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel)
    assert corr_cuda.launches == launches
    ss = scales or (None, None)
    if kernel == "g8c":
        assert corr_plain.calls == calls + 2       # one surface a level
        want = corr_plain.stack_levels(
            corr_plain.corr_level_group(args[0], r, args[2] / lvl, args[3],
                                        args[4], s)
            for r, lvl, s in zip(pyr, (1, 4), ss))
    else:
        assert corr_plain.calls == calls + (2 if kernel == "split2" else 1)
        want = corr_plain.corr_pyramid(*args, scales=scales)
    assert torch.equal(got, want)
    if kernel in ("split2", "g8c") and i8:
        # the resident level is corr_level's function: the last level takes
        # that plain version
        res = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel,
                                     resident=True)
        assert corr_cuda.launches == launches
        plain = corr_plain.corr_pyramid(*args, scales=scales)
        assert torch.equal(res.view(16, -1, 2)[..., 1],
                           plain.view(16, -1, 2)[..., 1])
        assert torch.equal(res.view(16, -1, 2)[..., 0],
                           got.view(16, -1, 2)[..., 0])
    else:
        with pytest.raises(ValueError):      # two-level, or float rings
            corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel,
                                   resident=True)


@pytest.mark.parametrize("kernel", ["split2", "g8c"])
def test_l4_resident_serves_the_per_level_kernels(kernel):
    """devo_tpu's rule (runtime/engine.py _l4_resident, corr_pyramid_banded's
    dispatch): the resident level 4 serves every kernel that takes one
    level a call."""
    cfg = VOConfig(CORR_KERNEL=kernel)
    assert not l4_resident(cfg, 480, 640)
    assert l4_resident(cfg.replace(CORR_L4_RESIDENT="auto"), 480, 640)
    assert l4_resident(cfg.replace(CORR_L4_RESIDENT="on"), 480, 640)
    assert not l4_resident(cfg.replace(CORR_L4_RESIDENT="auto",
                                       CORR_RING_I8=False), 480, 640)
    with pytest.raises(ValueError, match="CORR_RING_I8"):
        l4_resident(cfg.replace(CORR_L4_RESIDENT="on", CORR_RING_I8=False),
                    480, 640)


@pytest.mark.parametrize("kernel", ["mono2", "mono3", "mono4"])
def test_l4_resident_never_serves_a_two_level_kernel(kernel):
    cfg = VOConfig(CORR_KERNEL=kernel)
    assert not l4_resident(cfg.replace(CORR_L4_RESIDENT="auto"), 480, 640)
    with pytest.raises(ValueError, match="per-level kernel"):
        l4_resident(cfg.replace(CORR_L4_RESIDENT="on"), 480, 640)


def test_new_kernels_shared_memory_plans():
    """At the bench's width (P = 3, C = 128) every new kernel fits a block's
    232,448 bytes of shared memory, with the full 144-vector windows on int8
    and bf16 rings except where said; f32 rings stage smaller windows; a
    feature vector that is no multiple of 16 bytes stages nothing."""
    i8, bf, f32 = torch.int8, torch.bfloat16, torch.float32
    cc = corr_cuda
    room = cc.SMEM_MAX
    # corr_level_pipe (the edge pipeline in corr_group8's shape, one level):
    # group_plan, two blocks an SM of two stages (one a pipeline) of full
    # windows, each stage the bf16 patch rows (9 x 160 channels) and one
    # window of 144 rows of 160 int8 / 320 bf16 bytes, then two f32 surface
    # slots (144 rows of 10 floats); f32 patch features stage their 9 x 128
    # floats and rows of C + 16 bytes: on int8 rings still two blocks an SM,
    # on f32 rings one
    assert cc.group_smem_bytes(3, 128, bf, i8, 144, 2) == (
        2 * (9 * 160 * 2 + 144 * 160) + 2 * 144 * 10 * 4) == 63_360
    assert cc.group_smem_bytes(3, 128, bf, bf, 144, 2) == (
        2 * (9 * 160 * 2 + 144 * 320) + 2 * 144 * 10 * 4) == 109_440
    assert cc.group_smem_bytes(3, 128, f32, i8, 144, 2) == (
        2 * (9 * 128 * 4 + 144 * 144) + 2 * 144 * 10 * 4) == 62_208
    assert cc.group_smem_bytes(3, 128, f32, f32, 144, 2) == (
        2 * (9 * 128 * 4 + 144 * 528) + 2 * 144 * 10 * 4) == 172_800
    assert cc.group_plan(3, 128, bf, i8) == cc.group_plan(3, 128, bf, bf) == (144, 2, 2)
    assert cc.group_plan(3, 128, f32, i8) == (144, 2, 2)
    # four int8 stages (115,200 bytes) miss half an SM beside the static
    # tables (111,616) by 3,584 bytes
    assert cc.group_smem_bytes(3, 128, bf, i8, 144, 4) - (
        233_472 // 2 - 1024 - 4096) == 3_584
    # an int8 ring of 8-byte vectors is staged for bf16 patch features (the
    # tensor cores' rows), not for f32 ones: every tap reads the ring
    assert cc.group_plan(3, 8, bf, i8)[0] == 144
    assert cc.group_plan(3, 8, f32, i8)[0] == 0
    # corr_mono2 (the edge pipeline, a pair a step): int8 rings two
    # pipelines of one stage, each stage two edges' bf16 patch rows (9 x 160
    # channels) and four windows of 128 rows of 160 bytes, and four f32
    # surface slots (128 rows of 10) a pipeline; bf16 rings one pipeline of
    # one stage of full windows; gathered and in place take the same
    assert cc.mono2_smem_bytes(3, 128, bf, i8, 128, 2, 2) == (
        2 * 2 * (2880 + 2 * 128 * 160) + 2 * 4 * 128 * 10 * 4)
    assert cc.mono2_plan(3, 128, bf, i8) == (128, 2, 2)
    assert cc.mono2_plan(3, 128, bf, bf) == (144, 1, 1)
    cap, depth, pipes = cc.mono2_plan(3, 128, f32, f32)
    assert pipes == 1 and 64 <= cap < 144
    for ring in (i8, bf):
        cap, depth, pipes = cc.mono2_plan(3, 128, bf, ring)
        assert cc.mono2_smem_bytes(3, 128, bf, ring, cap, depth, pipes) <= room - 5120
    assert cc.mono2_plan(3, 8, f32, i8)[0] == 0
    # corr_mono3 (the edge pipeline, one pipeline of one edge a step, two
    # rotating slots a level): the deepest ring that fits, each stage the
    # bf16 patch rows (9 x 160 channels) and two windows of 144 rows, then
    # four f32 surface slots (144 rows of 10): four int8 stages (K1's own
    # total), two bf16 ones
    assert cc.mono3_smem_bytes(3, 128, bf, i8, 144, 4) == (
        4 * (2880 + 2 * 144 * 160) + 4 * 144 * 10 * 4) == 218_880
    assert cc.mono3_smem_bytes(3, 128, bf, bf, 144, 2) == (
        2 * (2880 + 2 * 144 * 320) + 4 * 144 * 10 * 4) == 213_120
    assert cc.mono3_plan(3, 128, bf, i8) == (144, 4)
    assert cc.mono3_plan(3, 128, bf, bf) == (144, 2)
    cap, depth = cc.mono3_plan(3, 128, f32, f32)
    assert depth == 2 and 64 <= cap < 144
    for gdt, ring in ((bf, i8), (bf, bf), (f32, f32)):
        cap, depth = cc.mono3_plan(3, 128, gdt, ring)
        assert cc.mono3_smem_bytes(3, 128, gdt, ring, cap, depth) <= room - 6144
        assert cc.mono3_smem_bytes(3, 128, gdt, ring, cap, depth + 1) > room - 6144
    assert cc.mono3_plan(3, 8, f32, i8) == (0, cc.MONO3_MAX_DEPTH)
    # corr_group (the edge pipeline, one level): two blocks an SM with
    # rings of two stages of full windows on int8 and bf16 rings, each stage
    # the bf16 patch rows and one window, two f32 surface slots a block
    assert cc.group_smem_bytes(3, 128, bf, i8, 144, 2) == (
        2 * (2880 + 144 * 160) + 2 * 144 * 10 * 4)
    assert cc.group_plan(3, 128, bf, i8) == (144, 2, 2)
    assert cc.group_plan(3, 128, bf, bf) == (144, 2, 2)
    assert cc.group_plan(3, 128, f32, f32) == (144, 2, 1)
    assert cc.group_plan(3, 8, f32, i8)[0] == 0
