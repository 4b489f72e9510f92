"""Port parity: the gradient and random patch selectors and the training
draws (nets/selector.py, nets/evonet.Patchifier) against devo_tpu's, and
the weights of a scorer-less network.

Inputs are drawn with numpy from a seed. Where devo_tpu draws from a key,
the test reproduces its draws with jax.random and injects them into the
port (`noise`, `candidates`, `coords`). Selected coordinates must be equal;
feature maps and patches match within atol 1e-4 in f32 (reordered f32 sums
of two conv backends, as tests/test_torch_nets.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from devo_tpu.nets import selector as jsel
from devo_tpu.nets.evonet import EVONet as JEVONet
from devo_tpu_torch.nets import selector as sel
from devo_tpu_torch.nets.evonet import EVONet
from devo_tpu_torch.utils.params import (build_mapping,
                                         jax_params_to_state_dict,
                                         random_state_dict)

ATOL = 1e-4
DIMS = dict(P=3, dim_inet=32, dim_fnet=16, dim=8)
H, W = 48, 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _voxels(seed, shape=(1, H, W, 5), density=0.2):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape).astype(np.float32)
    return v * (rng.random(shape) < density)


def _jax_net(selector, bins, seed=0):
    """A JAX EVONet of the selector with every leaf perturbed (biases too),
    and the port's loaded from it with strict=True."""
    jnet = JEVONet(**DIMS, patch_selector=selector, bins=bins)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, bins)),
                       jax.random.PRNGKey(1))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    tnet = EVONet(**DIMS, bins=bins, patch_selector=selector).eval()
    tnet.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return jnet, params, tnet


@pytest.fixture(scope="module")
def gradient_nets():
    return _jax_net("gradient", 5)


@pytest.mark.parametrize("shape", [(2, 33, 47, 5), (1, 64, 64, 3),
                                   (1, 120, 172, 5)],
                         ids=["odd", "frames", "wide"])
def test_event_gradient_matches_jax_exactly(shape):
    """The pooled gradient map, trailing rows and columns dropped as
    avg_pool2d drops them, bit for bit."""
    v = _voxels(0, shape, density=0.15)
    want = np.asarray(jsel.event_gradient(jnp.asarray(v)))
    got = sel.event_gradient(_t(v)).numpy()
    assert got.shape == want.shape == (shape[0], (shape[1] - 1) // 4,
                                       (shape[2] - 1) // 4)
    np.testing.assert_array_equal(got, want)


def _candidates(key, n, k, xmax, ymax):
    """devo_tpu's candidate draw: randint over [0, xmax) x [0, ymax)."""
    kx, ky = jax.random.split(key)
    return (_t(jax.random.randint(kx, (n, k), 0, xmax)).long(),
            _t(jax.random.randint(ky, (n, k), 0, ymax)).long())


@pytest.mark.parametrize("zeros", [False, True], ids=["dense", "ties"])
def test_select_3xrandom_matches_jax_given_its_draws(zeros):
    """The ppi largest of 3*ppi candidates, +1; with a map that is zero in
    places, equal weights keep the lower candidate first, as lax.top_k
    does."""
    rng = np.random.default_rng(1)
    w = rng.random((2, 12, 17)).astype(np.float32)
    if zeros:
        w *= rng.random(w.shape) < 0.3
    key = jax.random.PRNGKey(3)
    want = jsel.select_3xrandom(key, jnp.asarray(w), 6)
    got = sel.select_3xrandom(_t(w), 6, candidates=_candidates(key, 2, 18, 17, 12))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


@pytest.mark.parametrize("use_grid", [True, False], ids=["grid", "flat"])
def test_select_topk_takes_the_lower_index_among_ties(use_grid):
    """A score map whose 4x4 blocks are mostly all zero (an event-gradient
    map over a static scene): many pooled cells tie at zero, and the port
    picks the ones lax.top_k picks, the lower index first, on any
    device."""
    rng = np.random.default_rng(7)
    s = rng.random((2, 24, 40)).astype(np.float32)
    s *= np.kron(rng.random((2, 6, 10)) < 0.15, np.ones((4, 4))).astype(np.float32)
    want = jsel.select_topk(jnp.asarray(s), 8, use_grid=use_grid)
    got = sel.select_topk(_t(s), 8, use_grid=use_grid)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    idx = sel._top_indices(torch.tensor([[0.0, 2.0, 0.0, 2.0, 1.0, 0.0]]), 4)
    assert idx.tolist() == [[1, 3, 4, 0]]


def test_select_training_scorer_matches_jax_given_its_draws():
    rng = np.random.default_rng(2)
    s = rng.random((2, 10, 14)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jsel.select_training_scorer(key, jnp.asarray(s), 8)
    got = sel.select_training_scorer(_t(s), 8,
                                     candidates=_candidates(key, 2, 24, 12, 8))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def test_generator_draws_are_in_range_and_repeat():
    """Without injected draws the selectors draw from the generator: the
    same seed gives the same coordinates, inside devo_tpu's ranges."""
    s = torch.rand((2, 10, 14), generator=torch.Generator().manual_seed(0))
    for f in (lambda g: sel.select_random(2, 10, 14, 8, g),
              lambda g: sel.select_3xrandom(s, 8, g),
              lambda g: sel.select_training_scorer(s, 8, g)[:2]):
        a = f(torch.Generator().manual_seed(5))
        b = f(torch.Generator().manual_seed(5))
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        x, y = a
        assert x.shape == y.shape == (2, 8)
        assert int(x.min()) >= 1 and int(y.min()) >= 1
        assert int(x.max()) <= 14 and int(y.max()) <= 10
    x, y = sel.select_random(2, 10, 14, 64, torch.Generator().manual_seed(6))
    assert int(x.max()) <= 12 and int(y.max()) <= 8


def _check_patchify(got, want, keys=("fmap", "imap", "gmap", "patches", "clr")):
    np.testing.assert_array_equal(got["coords"].numpy(), np.asarray(want["coords"]))
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("mode", ["topk", "nms", "multi"])
def test_gradient_patchifier_matches_jax(gradient_nets, mode):
    """The gradient selector's Patchifier in each eval mode (the multi
    sampler with devo_tpu's Gumbel draws injected), as
    tests/test_selector_gradient.py drives devo_tpu's: the coords clamped
    into [1, w-2] x [1, h-2], no scores."""
    jnet, params, tnet = gradient_nets
    assert "scorer" not in params["patchify"]
    assert not hasattr(tnet.patchify, "scorer")
    vox = _voxels(3)
    key = jax.random.PRNGKey(5)
    want = jnet.apply({"params": params}, jnp.asarray(vox), key,
                      patches_per_image=8, scorer_eval_mode=mode,
                      method=JEVONet.run_patchify)
    noise = None
    if mode == "multi":
        k1, k2 = jax.random.split(key)
        g = sel.event_gradient(_t(vox))
        s, _, _ = sel._pad(g, True)
        h1, w1 = s.shape[1] // 4, s.shape[2] // 4
        noise = (_t(jax.random.gumbel(k1, (1, 4, (h1 // 2) * (w1 // 2)))),
                 _t(jax.random.gumbel(k2, (1, 8, 16))))
    with torch.no_grad():
        got = tnet.run_patchify(_t(vox), 8, scorer_eval_mode=mode, noise=noise)
    assert got["scores"] is None and want["scores"] is None
    _check_patchify(got, want)
    c = got["coords"]
    assert (c >= 1).all() and (c[..., 0] <= W // 4 - 2).all()
    assert (c[..., 1] <= H // 4 - 2).all()


def test_gradient_patchifier_training_draw_matches_jax(gradient_nets):
    """training=True: 3x-random candidates over the gradient map, with
    devo_tpu's draw injected, and the patches at the given inverse
    depths."""
    jnet, params, tnet = gradient_nets
    vox = _voxels(4)
    key = jax.random.PRNGKey(6)
    disps = np.random.default_rng(4).uniform(0.5, 2.0, (1, H // 4, W // 4)
                                             ).astype(np.float32)
    want = jnet.apply({"params": params}, jnp.asarray(vox), key,
                      patches_per_image=8, training=True,
                      disps=jnp.asarray(disps), method=JEVONet.run_patchify)
    gh, gw = (H - 1) // 4, (W - 1) // 4
    with torch.no_grad():
        got = tnet.run_patchify(_t(vox), 8, training=True, disps=_t(disps),
                                candidates=_candidates(key, 1, 24, gw, gh))
    assert got["scores"] is None
    _check_patchify(got, want)


def test_scorer_patchifier_training_draw_matches_jax():
    """The scorer's training draw through the Patchifier: coords and their
    scores, given devo_tpu's candidates."""
    jnet, params, tnet = _jax_net("scorer", 5, seed=2)
    vox = _voxels(5)
    key = jax.random.PRNGKey(7)
    want = jnet.apply({"params": params}, jnp.asarray(vox), key,
                      patches_per_image=8, training=True,
                      method=JEVONet.run_patchify)
    h2, w2 = (H - 8) // 4, (W - 8) // 4
    with torch.no_grad():
        got = tnet.run_patchify(_t(vox), 8, training=True,
                                candidates=_candidates(key, 1, 24, w2 - 2, h2 - 2))
    _check_patchify(got, want, keys=("fmap", "imap", "gmap", "patches", "scores"))


def test_scorerless_three_channel_weights_load_strict():
    """A JAX EVONet of the random selector on 3-channel frames has no
    patchify/scorer: its tree loads into the port's with strict=True, and
    the patchify outputs match devo_tpu's given its coordinate draw. The
    tree does not load into a scorer network, nor a scorer tree into it."""
    jnet, params, tnet = _jax_net("random", 3, seed=1)
    sd = jax_params_to_state_dict(params)
    assert not any("scorer" in k for k in sd)
    assert set(sd) == set(tnet.state_dict())
    assert tnet.patchify.fnet.state_dict()["conv1.weight"].shape[1] == 3
    with pytest.raises(RuntimeError, match="scorer"):
        EVONet(**DIMS, bins=3).load_state_dict(sd, strict=True)
    with pytest.raises(RuntimeError, match="scorer"):
        EVONet(**DIMS, bins=3, patch_selector="random").load_state_dict(
            random_state_dict(EVONet(**DIMS, bins=3), 0), strict=True)
    assert {k for k in build_mapping(scorer=False)} == {
        k for k in build_mapping() if "scorer" not in k}
    # random_state_dict serves the scorer-less network too
    EVONet(**DIMS, bins=3, patch_selector="random").load_state_dict(
        random_state_dict(tnet, 3), strict=True)

    # a frame as the engine hands it over: 0-255 scaled to [-0.5, 1.5]
    img = np.random.default_rng(6).uniform(-0.5, 1.5, (1, H, W, 3)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = jnet.apply({"params": params}, jnp.asarray(img), key,
                      patches_per_image=8, method=JEVONet.run_patchify)
    kx, ky = jax.random.split(key)
    coords = (_t(jax.random.randint(kx, (1, 8), 1, W // 4 - 1)).long(),
              _t(jax.random.randint(ky, (1, 8), 1, H // 4 - 1)).long())
    with torch.no_grad():
        got = tnet.run_patchify(_t(img), 8, coords=coords)
    assert got["scores"] is None
    _check_patchify(got, want)


def test_unknown_selector_raises():
    with pytest.raises(NotImplementedError, match="patch_selector"):
        EVONet(**DIMS, patch_selector="sift")
