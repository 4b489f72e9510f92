"""Port parity of the voxel augmentation (devo_tpu_torch/data/randaug.py
against devo_tpu/data/randaug.py): the strength table, each of the seven
uint8 image ops at each strength bin, and the whole augmentation with
devo_tpu's draws, on numpy-seeded sparse voxels. The ops floor and clamp
uint8 values held in f32: the port gives devo_tpu's values exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from devo_tpu.data import randaug as jra
from devo_tpu_torch.data import randaug as ra


def _voxels(seed=0, shape=(3, 24, 32, 5)):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape).astype(np.float32)
    return v * (rng.random(shape) < 0.3)


def _rgb(seed):
    """devo_tpu's and the port's uint8 images of one rescaled voxel:
    (..., bins, H, W, 3) and (..., bins, 3, H, W)."""
    v = np.asarray(jra.rescale_normalize(jnp.asarray(_voxels(seed))))
    x = np.moveaxis(v, -1, -3)
    return jra._to_rgb_u8(jnp.asarray(x)), ra._to_rgb_u8(torch.from_numpy(x.copy()))


def test_factor_table_is_devo_tpus_bit_for_bit():
    np.testing.assert_array_equal(ra._factor_table().numpy(),
                                  np.asarray(jra._factor_table()))


@pytest.mark.parametrize("op", range(7), ids=[f.__name__ for f in ra.OPS])
def test_each_op_at_each_bin_matches_jax(op):
    """Every strength bin of one op on two seeded images: the same uint8
    values, the quantization into them too."""
    table = np.asarray(jra._factor_table())
    for seed in (0, 1):
        rgb_j, rgb_t = _rgb(seed)
        np.testing.assert_array_equal(np.moveaxis(np.asarray(rgb_j), -1, -3),
                                      rgb_t.numpy())
        for fbin in range(ra.NUM_BINS):
            want = jra._OPS[op](rgb_j, jnp.float32(table[op, fbin]))
            got = ra.OPS[op](rgb_t, float(ra._factor_table()[op, fbin]))
            np.testing.assert_array_equal(
                got.numpy(), np.moveaxis(np.asarray(want), -1, -3),
                err_msg=f"bin {fbin}")
            assert float(got.min()) >= 0 and float(got.max()) <= 255


def _jax_draw(key):
    """devo_tpu's three draws of maybe_voxel_augment (randaug.py:132-134,
    150-151)."""
    k_roll, k_aug = jax.random.split(key)
    k_op, k_f = jax.random.split(k_aug)
    return (bool(jax.random.bernoulli(k_roll, ra.PROB)),
            int(jax.random.randint(k_op, (), 0, len(ra.OPS))),
            int(jax.random.randint(k_f, (), 0, ra.NUM_BINS)))


@pytest.mark.parametrize("norm", ["std2", "rescale"])
def test_maybe_voxel_augment_matches_jax_with_its_draws(norm):
    """The whole augmentation, the roll included, over keys until both an
    augmented and an untouched draw are seen: devo_tpu's voxels within
    atol 1e-6 (the trailing standardization sums in another order)."""
    vox = _voxels(2)
    seen = set()
    for i in range(40):
        key = jax.random.PRNGKey(i)
        draw = _jax_draw(key)
        want = np.asarray(jra.maybe_voxel_augment(jnp.asarray(vox), key, norm))
        got = ra.maybe_voxel_augment(torch.from_numpy(vox), norm, draw=draw)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
        if not draw[0]:
            assert np.array_equal(got.numpy(), vox)
        seen.add(draw[0])
        if seen == {True, False}:
            break
    assert seen == {True, False}


def test_draw_augment_is_seeded_and_in_range():
    draws = [ra.draw_augment(torch.Generator().manual_seed(s)) for s in range(200)]
    assert draws[:5] == [ra.draw_augment(torch.Generator().manual_seed(s))
                         for s in range(5)]
    rolls = np.mean([d[0] for d in draws])
    assert 0.2 < rolls < 0.46
    assert {d[1] for d in draws} == set(range(7))
    assert {d[2] for d in draws} == set(range(ra.NUM_BINS))
