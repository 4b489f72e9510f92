"""Port parity for the two-level patch correlation.

- The plain PyTorch corr_pyramid against devo_tpu.ops.corr.corr_pyramid, in
  f32 (atol 1e-4: reordered f32 sums of 128-channel dots).
- The plain version on bf16-rounded inputs against the JAX mono Pallas
  kernel itself (corr_pyramid_banded(variant="mono"), run in interpret mode
  on bf16 banded rings), at the small size tests/test_corr_pallas.py uses:
  levels (1, 2) and windows (16, 12). The make_case edges lie inside the
  kernel's window budget, so its tap clip does not bite. atol 0.12, rtol
  1e-2: the kernel's strip output is bf16 (the bound test_corr_pallas.py
  uses for the bf16-out variants).
- CPU tensors take the plain version; the kernel is not launched.

The kernel itself is held against the plain version on the card by
tests/test_torch_corr_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from devo_tpu.ops import corr as jcorr
from devo_tpu.ops import corr_pallas
from devo_tpu_torch.ops import corr as corr_plain
from devo_tpu_torch.ops import corr_cuda

from test_corr_pallas import make_case


def _t(a):
    return torch.from_numpy(np.array(a))


def _pool2(fmap):
    return fmap.reshape(fmap.shape[0], fmap.shape[1] // 2, 2,
                        fmap.shape[2] // 2, 2, -1).mean((2, 4))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_corr_pyramid_matches_jax(seed):
    gmap, fmap, coords, kk, jj, _ = make_case(seed, E=24, C=32)
    fmap2 = _pool2(fmap)
    want = jcorr.corr_pyramid(gmap, (fmap, fmap2), coords, kk, jj,
                              levels=(1, 2))
    got = corr_plain.corr_pyramid(_t(gmap), (_t(fmap), _t(fmap2)), _t(coords),
                                  _t(kk), _t(jj), levels=(1, 2))
    assert got.shape == (24, 2 * 49 * 9) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_plain_corr_out_of_bounds_taps_are_zero():
    gmap, fmap, coords, kk, jj, _ = make_case(2, E=8, C=16,
                                              coord_range=(-300, -200))
    got = corr_plain.corr_pyramid(_t(gmap), (_t(fmap), _t(_pool2(fmap))),
                                  _t(coords), _t(kk), _t(jj), levels=(1, 2))
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("seed", [0, 3])
def test_plain_corr_matches_jax_mono_kernel(seed):
    gmap, fmap, coords, kk, jj, mask = make_case(seed, E=24)
    fmap2 = _pool2(fmap)
    pyr = tuple(jnp.stack([corr_pallas.band_frame(f) for f in fm])
                for fm in (fmap, fmap2))
    with pltpu.force_tpu_interpret_mode():
        want = corr_pallas.corr_pyramid_banded(
            gmap, pyr, coords, kk, jj, mask, n_live=24, hw=(32, 40),
            levels=(1, 2), wins=(16, 12), variant="mono")
    bf = torch.bfloat16
    got = corr_plain.corr_pyramid(
        _t(gmap).to(bf), (_t(fmap).to(bf), _t(fmap2).to(bf)), _t(coords),
        _t(kk), _t(jj), levels=(1, 2))
    got = got * _t(mask)[:, None]
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=0.12, rtol=1e-2)


def test_cpu_tensors_take_the_plain_path():
    gmap, fmap, coords, kk, jj, _ = make_case(4, E=16, C=16)
    fmap4 = _pool2(_pool2(fmap))
    args = (_t(gmap), (_t(fmap), _t(fmap4)), _t(coords),
            _t(kk).int(), _t(jj).int())
    launches, calls = dict(corr_cuda.launches), corr_plain.calls
    got = corr_cuda.corr_pyramid(*args)
    assert corr_cuda.launches == launches
    assert corr_plain.calls == calls + 1
    torch.testing.assert_close(got, corr_plain.corr_pyramid(*args),
                               rtol=0, atol=0)
