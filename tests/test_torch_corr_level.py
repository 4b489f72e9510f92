"""Port parity for the quantised feature rings and the per-level correlation.

The plain PyTorch versions (devo_tpu_torch/ops/corr.py) against the JAX
package's Pallas kernels themselves, run in interpret mode on the CPU as
tests/test_corr_pallas.py runs them, on that file's make_case inputs (whose
edges lie inside the TPU kernels' window budget, so their tap clip does not
bite):

- quantize_frame against band_frame_i8's and pad_frame_l4_i8's scale and
  integer values (exact) and against the formula the JAX tests use;
- corr_level against corr_level_banded(ablate="split") (_kernel_banded_split)
  on bf16 rings and on int8 rings with per-slot scales, and at the smaller
  windows of the upper pyramid levels: atol 5e-2, rtol 1e-2, the JAX tests'
  own bound (the TPU kernel rounds its products to bf16 in its R buffer);
- corr_level on int8 rings against corr_level_l4_resident
  (_kernel_l4_resident), same bound; all-off-image edges give exact zeros;
- corr_pyramid with int8 rings against corr_pyramid_banded, variant "mono"
  (atol 0.12: bf16 strip output) and "split" (atol 5e-2), at levels (1, 2);
- on CPU tensors every configuration of the engine's entry point takes the
  plain versions and launches no kernel.

The kernels are held against the plain versions on the card by
tests/test_torch_corr_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from devo_tpu.ops import corr_pallas
from devo_tpu_torch.ops import corr as corr_plain
from devo_tpu_torch.ops import corr_cuda

from test_corr_pallas import make_case

HP = corr_pallas.banded_shape(32, 40)[1]
BF = torch.bfloat16
TOL = dict(atol=5e-2, rtol=1e-2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pool2(fmap):
    return fmap.reshape(fmap.shape[0], fmap.shape[1] // 2, 2,
                        fmap.shape[2] // 2, 2, -1).mean((2, 4))


def _quantize_ring(fmap):
    """(mem, H, W, C) f32 frames -> the port's int8 ring and (mem,) scales."""
    return corr_plain.quantize_frame(_t(fmap))


def _banded_i8(fmap):
    qs = [corr_pallas.band_frame_i8(f) for f in fmap]
    return jnp.stack([q for q, _ in qs]), jnp.stack([s for _, s in qs])


def _masked(got, mask):
    return (got * _t(mask)[:, None]).numpy()


@pytest.mark.parametrize("seed", [0, 3])
def test_quantize_frame_matches_jax(seed):
    _, fmap, *_ = make_case(seed, E=4, mem=2)
    for f in fmap:
        q, s = corr_plain.quantize_frame(_t(f))
        assert q.dtype == torch.int8 and q.shape == f.shape
        assert s.dtype == torch.float32 and s.shape == ()
        # the scale of the banded and of the padded level-4 layout
        _, s_band = corr_pallas.band_frame_i8(f)
        q_pad, s_pad = corr_pallas.pad_frame_l4_i8(f)
        assert float(s) == float(s_band) == float(s_pad)
        # the integer values: the padded layout minus its zero border
        H, W = f.shape[:2]
        inner = q_pad[corr_pallas.L4PADY:corr_pallas.L4PADY + H,
                      corr_pallas.L4PADX:corr_pallas.L4PADX + W]
        np.testing.assert_array_equal(q.numpy(), np.asarray(inner))
        # the formula of tests/test_corr_pallas.py
        s_ref = jnp.max(jnp.abs(f)) / 127.0
        want = jnp.clip(jnp.round(f / s_ref), -127, 127)
        np.testing.assert_array_equal(q.numpy(), np.asarray(want, np.int8))


def test_quantize_frame_of_zeros_has_scale_one():
    q, s = corr_plain.quantize_frame(torch.zeros((4, 5, 8)))
    assert float(s) == 1.0 and not q.any()


@pytest.mark.parametrize("seed", [0, 3])
def test_corr_level_matches_jax_split_kernel_bf16(seed):
    gmap, fmap, coords, kk, jj, mask = make_case(seed, E=24)
    fmap_b = jnp.stack([corr_pallas.band_frame(f) for f in fmap])
    with pltpu.force_tpu_interpret_mode():
        want = corr_pallas.corr_level_banded(
            gmap, fmap_b, coords, kk, jj, mask, n_live=24, hp=HP,
            ablate="split")
    got = corr_plain.corr_level(_t(gmap).to(BF), _t(fmap).to(BF), _t(coords),
                                _t(kk), _t(jj))
    assert got.shape == (24, 49 * 9) and got.dtype == torch.float32
    np.testing.assert_allclose(_masked(got, mask), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_corr_level_matches_jax_split_kernel_i8(seed):
    gmap, fmap, coords, kk, jj, mask = make_case(seed, E=24)
    fmap_b, scale = _banded_i8(fmap)
    with pltpu.force_tpu_interpret_mode():
        want = corr_pallas.corr_level_banded(
            gmap, fmap_b, coords, kk, jj, mask, n_live=24, hp=HP,
            ablate="split", scale=scale)
    ring, sc = _quantize_ring(fmap)
    np.testing.assert_array_equal(sc.numpy(), np.asarray(scale))
    got = corr_plain.corr_level(_t(gmap).to(BF), ring, _t(coords), _t(kk),
                                _t(jj), sc)
    np.testing.assert_allclose(_masked(got, mask), np.asarray(want), **TOL)


@pytest.mark.parametrize("win_rows", [10, 12])
def test_corr_level_matches_jax_split_kernel_small_window(win_rows):
    gmap, fmap, coords, kk, jj, mask = make_case(6, E=24)
    fmap_b = jnp.stack([corr_pallas.band_frame(f) for f in fmap])
    with pltpu.force_tpu_interpret_mode():
        want = corr_pallas.corr_level_banded(
            gmap, fmap_b, coords, kk, jj, mask, n_live=24, hp=HP,
            ablate="split", win_rows=win_rows)
    got = corr_plain.corr_level(_t(gmap).to(BF), _t(fmap).to(BF), _t(coords),
                                _t(kk), _t(jj))
    np.testing.assert_allclose(_masked(got, mask), np.asarray(want), **TOL)


def _jax_resident(gmap, fmap, coords, kk, jj, mask):
    qs = [corr_pallas.pad_frame_l4_i8(f) for f in fmap]
    with pltpu.force_tpu_interpret_mode():
        return corr_pallas.corr_level_l4_resident(
            gmap, jnp.stack([q for q, _ in qs]), coords, kk, jj, mask,
            n_live=coords.shape[0], scale=jnp.stack([s for _, s in qs]))


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_corr_level_matches_jax_resident_kernel(seed):
    gmap, fmap, coords, kk, jj, mask = make_case(seed, E=24)
    want = _jax_resident(gmap, fmap, coords, kk, jj, mask)
    ring, sc = _quantize_ring(fmap)
    got = corr_plain.corr_level(_t(gmap).to(BF), ring, _t(coords), _t(kk),
                                _t(jj), sc)
    np.testing.assert_allclose(_masked(got, mask), np.asarray(want), **TOL)


def test_corr_level_off_image_is_exact_zero():
    gmap, fmap, coords, kk, jj, mask = make_case(2, E=8,
                                                 coord_range=(-300, -200))
    want = _jax_resident(gmap, fmap, coords, kk, jj, mask)
    ring, sc = _quantize_ring(fmap)
    got = corr_plain.corr_level(_t(gmap).to(BF), ring, _t(coords), _t(kk),
                                _t(jj), sc)
    assert torch.equal(got, torch.zeros_like(got))
    np.testing.assert_allclose(np.asarray(want), 0.0, atol=1e-6)


@pytest.mark.parametrize("variant,atol", [("mono", 0.12), ("split", 5e-2)])
@pytest.mark.parametrize("seed", [0, 3])
def test_corr_pyramid_i8_matches_jax_kernels(seed, variant, atol):
    gmap, fmap, coords, kk, jj, mask = make_case(seed, E=24)
    levels = (fmap, _pool2(fmap))
    banded = [_banded_i8(fm) for fm in levels]
    with pltpu.force_tpu_interpret_mode():
        want = corr_pallas.corr_pyramid_banded(
            gmap, tuple(b for b, _ in banded), coords, kk, jj, mask,
            n_live=24, hw=(32, 40), levels=(1, 2),
            scales=tuple(s for _, s in banded), wins=(16, 12),
            variant=variant)
    rings = [_quantize_ring(fm) for fm in levels]
    got = corr_plain.corr_pyramid(
        _t(gmap).to(BF), tuple(r for r, _ in rings), _t(coords), _t(kk),
        _t(jj), levels=(1, 2), scales=tuple(s for _, s in rings))
    assert got.shape == (24, 2 * 49 * 9)
    np.testing.assert_allclose(_masked(got, mask),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=1e-2)


def test_scale_goes_with_int8_rings_only():
    gmap, fmap, coords, kk, jj, _ = make_case(1, E=4, C=16)
    ring, sc = _quantize_ring(fmap)
    args = (_t(coords), _t(kk), _t(jj))
    with pytest.raises(ValueError):
        corr_plain.corr_level(_t(gmap), ring, *args)            # no scale
    with pytest.raises(ValueError):
        corr_plain.corr_level(_t(gmap), _t(fmap), *args, sc)    # float ring


@pytest.mark.parametrize("i8,kernel,resident", [
    (False, "mono", False), (True, "mono", False), (False, "split", False),
    (True, "split", False), (True, "split", True)],
    ids=["bf16-mono", "i8-mono", "bf16-split", "i8-split", "i8-resident"])
def test_cpu_tensors_take_the_plain_path(i8, kernel, resident):
    """Every configuration of the entry point, on CPU tensors: the plain
    versions, no launch, and the same numbers whichever kernel is named."""
    gmap, fmap, coords, kk, jj, _ = make_case(4, E=16, C=16)
    levels = (fmap, _pool2(_pool2(fmap)))
    if i8:
        rings = [_quantize_ring(fm) for fm in levels]
        pyr, scales = tuple(r for r, _ in rings), tuple(s for _, s in rings)
    else:
        pyr, scales = tuple(_t(fm) for fm in levels), None
    args = (_t(gmap), pyr, _t(coords), _t(kk).int(), _t(jj).int())
    launches, calls = dict(corr_cuda.launches), corr_plain.calls
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel,
                                 resident=resident)
    assert corr_cuda.launches == launches
    assert corr_plain.calls > calls
    want = corr_plain.corr_pyramid(*args, scales=scales)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_entry_point_rejects_what_no_kernel_computes():
    gmap, fmap, coords, kk, jj, _ = make_case(4, E=4, C=16)
    args = (_t(gmap), (_t(fmap), _t(_pool2(fmap))), _t(coords), _t(kk).int(),
            _t(jj).int())
    with pytest.raises(ValueError):
        corr_cuda.corr_pyramid(*args, kernel="mono3")
    with pytest.raises(ValueError):          # resident needs "split"
        corr_cuda.corr_pyramid(*args, kernel="mono", resident=True)
    with pytest.raises(ValueError):          # and int8 rings
        corr_cuda.corr_pyramid(*args, kernel="split", resident=True)


def test_resident_shared_memory_budget():
    """One level-4 frame of a 480x640 input (30x40x128 int8) and the
    kernel's scratch fit a block's 232,448 bytes; a 720x1280 input's does
    not, nor does a frame that does not copy in 16-byte pieces."""
    assert corr_cuda.resident_smem_bytes(30, 40, 128, 3) == 153_600 + 55_296
    assert corr_cuda.resident_fits(30, 40, 128, 3)
    assert not corr_cuda.resident_fits(45, 80, 128, 3)
    assert not corr_cuda.resident_fits(3, 3, 4, 3)
    assert corr_cuda.level_smem_bytes(3, 128, torch.int8, 144) == 6912 + 18_432
