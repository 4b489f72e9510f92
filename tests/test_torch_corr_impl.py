"""Port parity for the functions of CORR_IMPL = "pallas", "window" and
"gather" and of the banded kernels "g8" and "full".

csrc/corr_fixed.cu (K12', "pallas"), csrc/corr_group8.cu (K9', "g8") and
csrc/corr_level_full.cu (K10', "full") compute the plain `ops/corr.corr_level`;
on the card they are held against it by tests/test_torch_corr_cuda.py. Here
`corr_level` is held against the JAX package's own Pallas kernels
(`_kernel` via corr_level_pallas, `_kernel_banded_g8` and `_kernel_banded`
via corr_level_banded), run in interpret mode on the CPU as
tests/test_corr_pallas.py runs them, on that file's make_case inputs (E = 24,
inside the TPU kernels' window budget, so their tap clip does not bite). The
TPU kernels round their inputs to bf16 and sum f32 products; so the port is
given the same bf16 inputs, and the two differ only in the order of f32
sums: atol 2e-4, rtol 1e-4 (dots of magnitude ~10).

The two tensor paths against devo_tpu's XLA functions, which run on the CPU
as they are:
- "gather" against corr_ops.corr_pyramid fed coordinates cast to bf16, under
  mixed precision (bf16 features and rings), as devo_tpu's engine calls it:
  the same f32 sums of the same bf16 products, atol 2e-4, rtol 1e-4; and it
  is not the f32-coordinate corr_pyramid;
- "window" against corr_ops.corr_window on f32 features, also on patches
  distorted beyond the window, whose taps both clamp: atol 1e-4, rtol 1e-5.

Also: the plain versions of the "full" kernel's stage instances, and the
entry point's dispatch on CPU tensors.
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
from test_torch_corr_level import BF, HP, _masked, _t

SUMS = dict(atol=2e-4, rtol=1e-4)       # bf16 inputs, f32 sums in another order


def _port_level(gmap, fmap, coords, kk, jj):
    """corr_level on the bf16-rounded inputs the TPU kernels take."""
    return corr_plain.corr_level(_t(gmap).to(BF), _t(fmap).to(BF), _t(coords),
                                 _t(kk), _t(jj))


@pytest.mark.parametrize("seed", [0, 3])
def test_corr_level_matches_jax_pallas_kernel(seed):
    gmap, fmap, coords, kk, jj, mask = make_case(seed, E=24)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(corr_pallas.corr_level_pallas(gmap, fmap, coords, kk,
                                                        jj, mask))
    got = _port_level(gmap, fmap, coords, kk, jj)
    assert got.shape == (24, 49 * 9) and np.abs(want).max() > 1.0
    np.testing.assert_allclose(_masked(got, mask), want, **SUMS)


@pytest.mark.parametrize("ablate,seed", [("g8", 0), ("g8", 3), ("full", 1)])
def test_corr_level_matches_jax_banded_g8_and_full_kernels(ablate, seed):
    gmap, fmap, coords, kk, jj, mask = make_case(seed, E=24)
    fmap_b = jnp.stack([corr_pallas.band_frame(f) for f in fmap])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(corr_pallas.corr_level_banded(
            gmap, fmap_b, coords, kk, jj, mask, n_live=24, hp=HP,
            ablate=ablate))
    got = _port_level(gmap, fmap, coords, kk, jj)
    np.testing.assert_allclose(_masked(got, mask), want, **SUMS)


def test_pallas_dispatch_matches_jax_corr_pyramid_pallas():
    """The port's CORR_IMPL="pallas" entry on CPU tensors (corr_level a
    level) against corr_pyramid_pallas, both pyramid levels."""
    gmap, fmap, coords, kk, jj, mask = make_case(1, E=24)
    fmap4 = fmap.reshape(4, 8, 4, 10, 4, -1).mean((2, 4))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(corr_pallas.corr_pyramid_pallas(
            gmap, (fmap, fmap4), coords, kk, jj, mask))
    launches, calls = dict(corr_cuda.launches), corr_plain.calls
    got = corr_cuda.corr_pyramid(
        _t(gmap).to(BF), (_t(fmap).to(BF), _t(fmap4).to(BF)), _t(coords),
        _t(kk), _t(jj), impl="pallas")
    assert corr_cuda.launches == launches and corr_plain.calls == calls + 2
    assert got.shape == (24, 2 * 49 * 9)
    np.testing.assert_allclose(_masked(got, mask), want, **SUMS)


def test_off_image_edges_are_exact_zeros():
    """Centers far off the image: every tap out of bounds, in the TPU kernel
    and in the port's entry point under each new configuration."""
    gmap, fmap, coords, kk, jj, mask = make_case(2, E=8, coord_range=(-300, -200))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(corr_pallas.corr_level_pallas(gmap, fmap, coords, kk,
                                                        jj, mask))
    assert not want.any()
    args = (_t(gmap), (_t(fmap), _t(fmap)[:, :8, :10].contiguous()),
            _t(coords), _t(kk), _t(jj))
    for impl, kernel in (("pallas", "mono"), ("banded", "g8"),
                         ("banded", "full"), ("window", "mono"),
                         ("gather", "mono")):
        got = corr_cuda.corr_pyramid(*args, kernel=kernel, impl=impl)
        assert torch.equal(got, torch.zeros_like(got)), (impl, kernel)


# --- the tensor paths ------------------------------------------------------


def _large_case(seed=0, E=40, H=160, W=200, C=32):
    """make_case at the level-1 size of a 640x800 input: coordinates beyond
    128, where bf16 steps by a whole pixel."""
    return make_case(seed, E=E, H=H, W=W, C=C, mem=3)


def test_gather_matches_jax_with_bf16_coordinates():
    gmap, fmap, coords, kk, jj, _ = _large_case()
    fmap4 = fmap.reshape(3, 40, 4, 50, 4, -1).mean((2, 4))
    gb, f1, f4 = (jnp.asarray(a, jnp.bfloat16) for a in (gmap, fmap, fmap4))
    want = np.asarray(jcorr.corr_pyramid(gb, (f1, f4),
                                         coords.astype(jnp.bfloat16), kk, jj))
    args = (_t(gmap).to(BF), (_t(fmap).to(BF), _t(fmap4).to(BF)), _t(coords),
            _t(kk), _t(jj))
    calls, gathers = corr_plain.calls, corr_plain.gather_calls
    got = corr_cuda.corr_pyramid(*args, impl="gather")
    assert (corr_plain.calls, corr_plain.gather_calls) == (calls, gathers + 1)
    assert got.shape == (40, 2 * 49 * 9) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **SUMS)
    # the cast is part of the function: the f32-coordinate correlation is
    # another one, far beyond the tolerance
    f32_coords = corr_plain.corr_pyramid(*args)
    assert (f32_coords - got).abs().max().item() > 100 * SUMS["atol"]
    # with f32 features the cast and the weights' rounding change nothing
    args32 = (_t(gmap), (_t(fmap), _t(fmap4)), *args[2:])
    assert torch.equal(corr_plain.corr_pyramid_gather(*args32),
                       corr_plain.corr_pyramid(*args32))


def _distorted(coords, seed, every=3):
    """Every `every`-th patch spread beyond the 16x24 window (each pixel
    moved up to 12 px on its own)."""
    rng = np.random.default_rng(seed)
    c = np.array(coords)
    c[::every] += rng.uniform(-12, 12, c[::every].shape).astype(np.float32)
    return jnp.asarray(c)


@pytest.mark.parametrize("distort", [False, True])
def test_window_matches_jax_corr_window(distort):
    gmap, fmap, coords, kk, jj, mask = make_case(4, E=24)
    if distort:
        coords = _distorted(coords, 4)
    want = np.asarray(jcorr.corr_window(gmap, fmap, coords, kk, jj, mask))
    args = (_t(gmap), _t(fmap), _t(coords), _t(kk), _t(jj))
    got = corr_plain.corr_window(*args)
    np.testing.assert_allclose(_masked(got, mask), want, atol=1e-4, rtol=1e-5)
    exact = corr_plain.corr_level(*args)
    if distort:
        # the clamp is the function of this path: not corr_level
        assert (got - exact).abs().max().item() > 1.0
    else:
        torch.testing.assert_close(got, exact, atol=1e-4, rtol=1e-5)


def test_window_pyramid_and_chunks():
    """corr_pyramid_window is corr_window a level, and gathering the windows
    in chunks of edges changes no number."""
    gmap, fmap, coords, kk, jj, _ = make_case(5, E=24)
    fmap4 = fmap.reshape(4, 8, 4, 10, 4, -1).mean((2, 4))
    args = (_t(gmap), (_t(fmap), _t(fmap4)), _t(coords), _t(kk), _t(jj))
    calls, windows = corr_plain.calls, corr_plain.window_calls
    got = corr_cuda.corr_pyramid(*args, impl="window")
    assert (corr_plain.calls, corr_plain.window_calls) == (calls, windows + 1)
    want = corr_plain.stack_levels(
        corr_plain.corr_window(args[0], fm, args[2] / lvl, *args[3:])
        for fm, lvl in zip(args[1], (1, 4)))
    assert torch.equal(got, want)
    chunk = corr_plain.WINDOW_CHUNK
    try:
        corr_plain.WINDOW_CHUNK = 5
        assert torch.equal(corr_cuda.corr_pyramid(*args, impl="window"), got)
    finally:
        corr_plain.WINDOW_CHUNK = chunk


# --- the stage instances of the "full" kernel ------------------------------


def test_stage_plain_versions():
    """What ops/corr.corr_level_stage defines, checked from the ring itself:
    on integer coordinates (no blend) "nomm" is the ring's channel p; "noext"
    is the surface of the covering window, row-major; "noDMA" zeroes the
    staged edges and keeps the others' correlation; every stage (49*P*P)
    a row."""
    gmap, fmap, coords, kk, jj, _ = make_case(6, E=24, C=16)
    coords = np.floor(np.array(coords))
    coords[::4] += np.random.default_rng(6).uniform(
        -4, 4, coords[::4].shape).round()          # wide covering windows
    g, f, c, k, j = (_t(gmap), _t(fmap), _t(coords.astype(np.float32)),
                     _t(kk), _t(jj))
    cap = 100
    x0, y0, wx0, wy0, ww, wide = corr_plain._group_index(c, cap)
    assert 0 < int(wide.sum()) < 24
    out = {s: corr_plain.corr_level_stage(g, f, c, k, j, s, cap)
           for s in corr_plain.STAGES}
    for s, o in out.items():
        assert o.shape == (24, 441) and o.dtype == torch.float32, s
    torch.testing.assert_close(out["full"], corr_plain.corr_level(g, f, c, k, j))
    # "nomm": tap (oy, ox) of pixel p at output [(ox * 7 + oy) * 9 + p]
    e, p, ox, oy = 3, 4, 2, 5
    iy, ix = int(y0[e, p]) + oy - 3, int(x0[e, p]) + ox - 3
    ring = f[j[e], iy, ix, p] if 0 <= iy < 32 and 0 <= ix < 40 else 0.0
    assert out["nomm"][e, (ox * 7 + oy) * 9 + p] == ring
    # "noext": row i = window position i // 9, pixel i % 9
    staged = int(torch.nonzero(~wide[:, 0])[0])
    i, pix = 7 * 9 + 2, 2
    iy, ix = int(wy0[staged]) + 7 // int(ww[staged]), int(wx0[staged]) + 7 % int(ww[staged])
    dot = (g[k[staged]].reshape(9, -1)[pix] * f[j[staged], iy, ix]).sum() \
        if 0 <= iy < 32 and 0 <= ix < 40 else torch.tensor(0.0)
    torch.testing.assert_close(out["noext"][staged, i], dot)
    assert not out["noext"][wide[:, 0]].any()
    # "noDMA"
    assert not out["noDMA"][~wide[:, 0]].any()
    assert torch.equal(out["noDMA"][wide[:, 0]], out["full"][wide[:, 0]])
    with pytest.raises(ValueError):
        corr_plain.corr_level_stage(g, f, c, k, j, "noDma", cap)


# --- the entry point on CPU tensors ----------------------------------------


@pytest.mark.parametrize("impl,kernel", [("pallas", "mono"), ("pallas", "g8c"),
                                         ("banded", "g8"), ("banded", "full")])
def test_new_configurations_on_cpu_tensors_take_corr_level(impl, kernel):
    """On the CPU the per-level configurations take corr_level a level, which
    stacked is corr_pyramid bitwise, and launch nothing. Under "pallas" the
    kernel name is not read."""
    gmap, fmap, coords, kk, jj, _ = make_case(4, E=16, C=16)
    fmap4 = fmap.reshape(4, 8, 4, 10, 4, -1).mean((2, 4))
    args = (_t(gmap), (_t(fmap), _t(fmap4)), _t(coords), _t(kk).int(),
            _t(jj).int())
    launches, calls = dict(corr_cuda.launches), corr_plain.calls
    got = corr_cuda.corr_pyramid(*args, kernel=kernel, impl=impl)
    assert corr_cuda.launches == launches and corr_plain.calls == calls + 2
    assert torch.equal(got, corr_plain.corr_pyramid(*args))


def test_entry_point_rejects_what_the_configurations_do_not_take():
    gmap, fmap, coords, kk, jj, _ = make_case(4, E=8, C=16)
    q, s = corr_plain.quantize_frame(_t(fmap))
    args = (_t(gmap), (_t(fmap), _t(fmap)), _t(coords), _t(kk).int(),
            _t(jj).int())
    with pytest.raises(ValueError, match="impl must be one of"):
        corr_cuda.corr_pyramid(*args, impl="xla")
    for impl in ("pallas", "window", "gather"):
        with pytest.raises(ValueError):          # int8 rings with scales
            corr_cuda.corr_pyramid(args[0], (q, q), *args[2:], scales=(s, s),
                                   impl=impl)
        with pytest.raises(ValueError):          # a resident level
            corr_cuda.corr_pyramid(*args, impl=impl, resident=True)
    for kernel in corr_cuda.FLOAT_ONLY:
        with pytest.raises(ValueError, match="float rings"):
            corr_cuda.corr_pyramid(args[0], (q, q), *args[2:], scales=(s, s),
                                   kernel=kernel)
