"""Port parity for the two-level pair kernels' function.

csrc/corr_pair.cu and csrc/corr_pair2.cu compute the plain
`ops/corr.corr_pyramid`; on the card they are held against it by
tests/test_torch_corr_cuda.py. Here the plain version is held against the
JAX package's own `pair` and `pair2` Pallas kernels (_kernel_banded_pair,
_kernel_banded_pair2), run in interpret mode on the CPU as
tests/test_corr_pallas.py runs them: E = 24 edges of that file's make_case
(inside the TPU kernels' window budget, so their tap clip does not bite),
hw = (32, 40), levels (1, 2), wins (16, 12), on bf16 rings and on int8 rings
with per-slot scales. Tolerances are the JAX tests' own budgets: atol 5e-2
for `pair` (f32 strips; the int8 quantisation and the TPU kernel's bf16
products dominate), 0.12 for `pair2` (bf16 strips add one rounding), rtol
1e-2.

Also: on CPU tensors the entry point takes the plain version bitwise for
both kernel names and launches nothing, an unknown kernel raises, and the
CORR_L4_RESIDENT rules for the two new CORR_KERNEL values.
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
from test_torch_corr_level import BF, _banded_i8, _masked, _pool2, _quantize_ring, _t

VARIANTS = pytest.mark.parametrize("variant,atol", [("pair", 5e-2),
                                                    ("pair2", 0.12)])


def _jax_pair(gmap, pyr, coords, kk, jj, mask, scales, variant):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(corr_pallas.corr_pyramid_banded(
            gmap, pyr, coords, kk, jj, mask, n_live=coords.shape[0],
            hw=(32, 40), levels=(1, 2), scales=scales, wins=(16, 12),
            variant=variant), np.float32)


@VARIANTS
@pytest.mark.parametrize("seed", [0, 3])
def test_corr_pyramid_matches_jax_pair_kernels_i8(seed, variant, atol):
    gmap, fmap, coords, kk, jj, mask = make_case(seed, E=24)
    levels = (fmap, _pool2(fmap))
    banded = [_banded_i8(fm) for fm in levels]
    want = _jax_pair(gmap, tuple(b for b, _ in banded), coords, kk, jj, mask,
                     tuple(s for _, s in banded), variant)
    rings = [_quantize_ring(fm) for fm in levels]
    got = corr_plain.corr_pyramid(
        _t(gmap).to(BF), tuple(r for r, _ in rings), _t(coords), _t(kk),
        _t(jj), levels=(1, 2), scales=tuple(s for _, s in rings))
    assert got.shape == (24, 2 * 49 * 9) and got.dtype == torch.float32
    np.testing.assert_allclose(_masked(got, mask), want, atol=atol, rtol=1e-2)


@VARIANTS
@pytest.mark.parametrize("seed", [0, 5])
def test_corr_pyramid_matches_jax_pair_kernels_bf16(seed, variant, atol):
    gmap, fmap, coords, kk, jj, mask = make_case(seed, E=24)
    levels = (fmap, _pool2(fmap))
    pyr = tuple(jnp.stack([corr_pallas.band_frame(f) for f in fm])
                for fm in levels)
    want = _jax_pair(gmap, pyr, coords, kk, jj, mask, None, variant)
    got = corr_plain.corr_pyramid(
        _t(gmap).to(BF), tuple(_t(fm).to(BF) for fm in levels), _t(coords),
        _t(kk), _t(jj), levels=(1, 2))
    np.testing.assert_allclose(_masked(got, mask), want, atol=atol, rtol=1e-2)


@pytest.mark.parametrize("kernel", ["pair", "pair2"])
@pytest.mark.parametrize("i8", [False, True], ids=["float", "i8"])
def test_pair_kernels_on_cpu_tensors_take_the_plain_version(kernel, i8):
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
    assert corr_cuda.launches == launches and corr_plain.calls == calls + 1
    want = corr_plain.corr_pyramid(*args, scales=scales)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):          # no resident level with them
        corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel,
                               resident=True)


def test_kernel_names_and_counters():
    assert corr_cuda.KERNELS == ("mono", "mono2", "mono3", "mono4", "pair",
                                 "pair2", "split", "split2", "g8c", "g8",
                                 "full")
    assert set(corr_cuda.launches) == {
        "corr_pyramid", "corr_level", "corr_level_resident", "corr_pair",
        "corr_pair2", "corr_level_pipe", "corr_group", "corr_mono2",
        "corr_mono3", "corr_fixed", "corr_group8", "corr_level_full",
        "corr_band_ablate", "copy_probe", "corr_frame_probe"}
    gmap, fmap, coords, kk, jj, _ = make_case(4, E=4, C=16)
    args = (_t(gmap), (_t(fmap), _t(_pool2(fmap))), _t(coords), _t(kk).int(),
            _t(jj).int())
    for unknown in ("pair3", "mono5", "", None):
        with pytest.raises(ValueError, match="kernel must be one of"):
            corr_cuda.corr_pyramid(*args, kernel=unknown)


@pytest.mark.parametrize("kernel", ["pair", "pair2"])
def test_l4_resident_rules_for_the_pair_kernels(kernel):
    """devo_tpu's rule (runtime/engine.py _l4_resident): with "pair" the
    resident level 4 is off under "auto" and "on" raises; the port holds
    "pair2" to the same, as it does every kernel that takes both levels in
    one launch."""
    cfg = VOConfig(CORR_KERNEL=kernel)
    assert not l4_resident(cfg, 480, 640)
    assert not l4_resident(cfg.replace(CORR_L4_RESIDENT="auto"), 480, 640)
    with pytest.raises(ValueError, match="CORR_KERNEL='split'"):
        l4_resident(cfg.replace(CORR_L4_RESIDENT="on"), 480, 640)


def test_pair_shared_memory_budget():
    """At the slice's width both kernels fit a block's 232,448 bytes with
    the full 144-vector windows on int8 and bf16 rings; corr_pair2 on f32
    rings stages smaller windows; a feature vector that is no multiple of
    16 bytes stages nothing."""
    i8, bf, f32 = torch.int8, torch.bfloat16, torch.float32
    assert corr_cuda.pair_smem_bytes(3, 128, i8, 144) == 9216 + 2 * 18_432
    assert corr_cuda.pair_smem_bytes(3, 128, bf, 144) == 9216 + 2 * 36_864
    assert corr_cuda.pair2_smem_bytes(3, 128, bf, i8, 144) == (
        9216 + 2 * (2304 + 2 * 18_432))
    assert corr_cuda.pair2_smem_bytes(3, 128, bf, bf, 144) == (
        9216 + 2 * (2304 + 2 * 36_864))

    def cap2(g, r, C=128):
        return corr_cuda.pair_cap("corr_pair2", 3, C, g, r)

    assert cap2(bf, i8) == cap2(bf, bf) == 144
    assert 100 <= cap2(f32, f32) < 144
    assert corr_cuda.pair2_smem_bytes(3, 128, f32, f32, cap2(f32, f32)) <= (
        corr_cuda.SMEM_MAX - 4096)
    assert cap2(bf, bf, C=12) == 0 and cap2(bf, i8, C=8) == 0
    assert cap2(bf, i8, C=16) == 144
    assert corr_cuda.pair_cap("corr_pair", 3, 128, f32, f32) == 144
