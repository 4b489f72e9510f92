"""Port parity: the networks of devo_tpu_torch against the flax modules of
devo_tpu, with the JAX params carried across by utils/params.py.

Inputs are drawn with numpy from a seed and fed to both. Everything runs in
f32 (MIXED_PRECISION=False); tolerance atol 1e-4 covers the reordered f32
sums of two conv / matmul backends.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from devo_tpu.data.normalize import normalize as jax_normalize
from devo_tpu.nets import selector as jsel
from devo_tpu.nets.encoder import BasicEncoder4Evs as JEncoder, Scorer as JScorer
from devo_tpu.nets.evonet import EVONet as JEVONet
from devo_tpu.nets.update import Update as JUpdate
from devo_tpu.ops import graph as jgraph
from devo_tpu.ops.patchify import extract_patches as jax_extract

from devo_tpu_torch.data.normalize import normalize
from devo_tpu_torch.nets import selector as sel
from devo_tpu_torch.nets.evonet import EVONet
from devo_tpu_torch.ops.graph import sorted_neighbors
from devo_tpu_torch.ops.patchify import extract_patches
from devo_tpu_torch.utils.params import (build_mapping,
                                         jax_params_to_state_dict,
                                         random_state_dict)

ATOL = 1e-4
DIMS = dict(P=3, dim_inet=32, dim_fnet=16, dim=8)
H, W = 48, 64


@pytest.fixture(scope="module")
def nets():
    """A small JAX EVONet with every leaf (biases included) randomized, and
    the port's EVONet loaded from it."""
    jnet = JEVONet(**DIMS)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 5)),
                       jax.random.PRNGKey(1))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    tnet = EVONet(**DIMS).eval()
    tnet.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return jnet, params, tnet


def _t(a):
    return torch.from_numpy(np.array(a))


def test_params_set_every_port_parameter_once(nets):
    jnet, params, tnet = nets
    sd = jax_params_to_state_dict(params)
    assert set(sd) == set(tnet.state_dict())
    # a leaf the port has no slot for is an error, not silently dropped
    extra = jax.tree_util.tree_map(np.asarray, params)
    extra = {**extra, "update": {**extra["update"], "stray": {"kernel": np.zeros(2)}}}
    with pytest.raises(ValueError, match="unused"):
        jax_params_to_state_dict(extra)
    # every torch module path in the table exists in the port
    names = {n for n, _ in tnet.named_modules()}
    assert {k for k in build_mapping() if "downsample" not in k} <= names


def test_random_state_dict_loads_strict():
    net = EVONet(**DIMS)
    sd = random_state_dict(net, seed=3)
    net.load_state_dict(sd, strict=True)
    again = random_state_dict(net, seed=3)
    assert all(torch.equal(sd[k], again[k]) for k in sd)


@pytest.mark.parametrize("norm_fn", ["instance", "none"])
def test_encoder_matches_jax(nets, norm_fn):
    jnet, params, tnet = nets
    name = "fnet" if norm_fn == "instance" else "inet"
    out_dim = DIMS["dim_fnet"] if name == "fnet" else DIMS["dim_inet"]
    x = np.random.default_rng(1).standard_normal((2, H, W, 5)).astype(np.float32)
    jenc = JEncoder(output_dim=out_dim, dim=DIMS["dim"], norm_fn=norm_fn)
    want = np.asarray(jenc.apply({"params": params["patchify"][name]},
                                 jnp.asarray(x)))
    with torch.no_grad():
        got = getattr(tnet.patchify, name)(_t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL)


def test_scorer_matches_jax(nets):
    jnet, params, tnet = nets
    x = np.random.default_rng(2).standard_normal((2, H, W, 5)).astype(np.float32)
    want = np.asarray(JScorer().apply({"params": params["patchify"]["scorer"]},
                                      jnp.asarray(x)))
    with torch.no_grad():
        got = tnet.patchify.scorer(_t(x).permute(0, 3, 1, 2))
    assert got.shape == want.shape == (2, (H - 8) // 4, (W - 8) // 4)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def _update_case(E=40, n_patches=9, seed=3):
    rng = np.random.default_rng(seed)
    D = DIMS["dim_inet"]
    kk = np.sort(rng.integers(0, n_patches, E)).astype(np.int32)
    jj = rng.integers(0, 12, E).astype(np.int32)
    order = np.lexsort((jj, kk))
    kk, jj = kk[order], jj[order]
    mask = np.ones(E, bool)
    mask[-5:] = False                     # a padded tail, as the JAX table has
    net = rng.standard_normal((E, D)).astype(np.float32)
    ctx = rng.standard_normal((E, D)).astype(np.float32)
    corr = rng.standard_normal((E, 2 * 49 * 9)).astype(np.float32)
    ij = rng.integers(0, 6, E).astype(np.int32)
    kk_seg = np.where(mask, kk, n_patches).astype(np.int32)
    return kk, jj, mask, net, ctx, corr, kk_seg, ij, n_patches


@pytest.mark.parametrize("sorted_table", [True, False], ids=["sorted", "unsorted"])
def test_update_matches_jax(nets, sorted_table):
    jnet, params, tnet = nets
    kk, jj, mask, net, ctx, corr, kk_seg, ij, nseg = _update_case()
    if sorted_table:
        ix, jx = jgraph.sorted_neighbors(jnp.asarray(kk), jnp.asarray(mask))
        tix, tjx = sorted_neighbors(_t(kk).long(), _t(mask))
        np.testing.assert_array_equal(tix.numpy(), np.asarray(ix))
        np.testing.assert_array_equal(tjx.numpy(), np.asarray(jx))
    else:
        ix, jx = jgraph.neighbors(jnp.asarray(kk), jnp.asarray(jj),
                                  jnp.asarray(mask))
    jupd = JUpdate(dim=DIMS["dim_inet"], corr_dim=2 * 49 * 9)
    want = jupd.apply({"params": params["update"]}, jnp.asarray(net),
                      jnp.asarray(ctx), jnp.asarray(corr), ix, jx,
                      jnp.asarray(kk_seg), nseg, jnp.asarray(ij), 6,
                      jnp.asarray(mask), kk_sorted=sorted_table)
    with torch.no_grad():
        got = tnet.update(_t(net), _t(ctx), _t(corr), _t(np.asarray(ix)).long(),
                          _t(np.asarray(jx)).long(), _t(kk_seg).long(), nseg,
                          _t(ij).long(), 6, _t(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_patchifier_topk_matches_jax(nets):
    jnet, params, tnet = nets
    rng = np.random.default_rng(4)
    vox = rng.standard_normal((1, H, W, 5)).astype(np.float32)
    vox *= rng.random(vox.shape) < 0.2
    want = jnet.apply({"params": params}, jnp.asarray(vox),
                      jax.random.PRNGKey(0), patches_per_image=8,
                      scorer_eval_mode="topk", method=JEVONet.run_patchify)
    with torch.no_grad():
        got = tnet.run_patchify(_t(vox), 8, scorer_eval_mode="topk")
    np.testing.assert_array_equal(got["coords"].numpy(),
                                  np.asarray(want["coords"]))
    for k in ("fmap", "imap", "gmap", "patches", "scores", "clr"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("use_grid", [True, False], ids=["grid", "nogrid"])
def test_select_multi_injected_noise_matches_jax(use_grid):
    rng = np.random.default_rng(5)
    scores = rng.random((2, 30, 38)).astype(np.float32)
    ppi = 16
    key = jax.random.PRNGKey(11)
    want = jsel.select_multi(key, jnp.asarray(scores), ppi, use_grid=use_grid)

    # the JAX sampler's own draws: Gumbel top-k over the pooled cells, then
    # a Gumbel-max categorical over each 4x4 window
    k1, k2 = jax.random.split(key)
    s, top, left = sel._pad(_t(scores), use_grid)
    h1, w1 = s.shape[1] // 4, s.shape[2] // 4
    cells = (2, 4, (h1 // 2) * (w1 // 2)) if use_grid else (2, h1 * w1)
    noise = (_t(jax.random.gumbel(k1, cells)),
             _t(jax.random.gumbel(k2, (2, ppi, 16))))
    got = sel.select_multi(_t(scores), ppi, use_grid=use_grid, noise=noise)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_select_multi_draws_from_generator():
    scores = torch.rand((1, 30, 38), generator=torch.Generator().manual_seed(0))
    a = sel.select_multi(scores, 16, torch.Generator().manual_seed(7))
    b = sel.select_multi(scores, 16, torch.Generator().manual_seed(7))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (1, 16)


@pytest.mark.parametrize("use_grid", [True, False], ids=["grid", "nogrid"])
def test_select_topk_and_nms_match_jax(use_grid):
    scores = np.random.default_rng(6).random((2, 30, 38)).astype(np.float32)
    for jf, tf in ((jsel.select_topk, sel.select_topk),
                   (jsel.select_nms, sel.select_nms)):
        want = jf(jnp.asarray(scores), 16, use_grid=use_grid)
        got = tf(_t(scores), 16, use_grid=use_grid)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["std", "rescale"])
def test_normalize_matches_jax(mode):
    rng = np.random.default_rng(7)
    vox = rng.standard_normal((H, W, 5)).astype(np.float32)
    vox *= rng.random(vox.shape) < 0.1
    want = np.asarray(jax_normalize(jnp.asarray(vox), mode))
    np.testing.assert_allclose(normalize(_t(vox), mode).numpy(), want,
                               atol=1e-5, rtol=1e-5)


def test_extract_patches_matches_jax():
    rng = np.random.default_rng(8)
    fmap = rng.standard_normal((2, 12, 16, 4)).astype(np.float32)
    coords = rng.uniform(-3, 18, (2, 7, 2)).astype(np.float32)
    want = np.asarray(jax_extract(jnp.asarray(fmap), jnp.asarray(coords), 1))
    got = extract_patches(_t(fmap), _t(coords), 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
