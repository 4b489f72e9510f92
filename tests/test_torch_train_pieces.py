"""Port parity for the differentiable pieces training stands on: the
projective geometry with its Jacobians (geom/projective.py), the unsorted
temporal neighbors (ops/graph.neighbors), the gradient clip / zero
identities (nets/blocks.py), the differentiable Gauss-Newton step
(ops/ba.gauss_newton_step_diff) and the training correlation
(ops/corr.corr_pyramid_train), each against devo_tpu's on the same
numpy-seeded inputs, values and gradients (jax.grad against
torch.autograd). Tolerances are stated at each test.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from devo_tpu.geom import projective as jpops
from devo_tpu.nets import blocks as jblocks
from devo_tpu.ops import ba as jba
from devo_tpu.ops import corr as jcorr
from devo_tpu.ops import graph as jgraph
from devo_tpu_torch.geom import projective as pops
from devo_tpu_torch.nets.blocks import gradient_clip, gradient_zero
from devo_tpu_torch.ops import ba
from devo_tpu_torch.ops import corr as corr_plain
from devo_tpu_torch.ops.graph import neighbors

from test_projective import make_scene
from test_torch_ba import _scene


def _t(a):
    return torch.from_numpy(np.array(a))


def _idx(a):
    return _t(a).long()


# --------------------------------------------------------------- projective

@pytest.mark.parametrize("seed", [1, 2])
def test_transform_and_jacobians_match_jax(seed):
    """coords, the validity mask and Ji, Jj, Jz within atol 1e-4 + rtol
    1e-4 (the Jacobians carry fx = 120), with depth and tonly too."""
    poses, patches, intr, ii, jj, kk = make_scene(seed)
    args = (poses, patches, intr, ii, jj, kk)
    targs = (_t(poses), _t(patches), _t(intr), _idx(ii), _idx(jj), _idx(kk))
    want = jpops.transform(*args, jacobian=True)
    got = pops.transform(*targs, jacobian=True)
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **tol)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for name in ("Ji", "Jj", "Jz"):
        np.testing.assert_allclose(getattr(got[2], name).numpy(),
                                   np.asarray(getattr(want[2], name)),
                                   err_msg=name, **tol)
    for kw in (dict(depth=True), dict(tonly=True), dict(valid=True)):
        w = jpops.transform(*args, **kw)
        g = pops.transform(*targs, **kw)
        for a, b in zip(g if isinstance(g, tuple) else (g,),
                        w if isinstance(w, tuple) else (w,)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=str(kw),
                                       **tol)
    np.testing.assert_allclose(
        pops.relative_poses(_t(poses), _idx(ii), _idx(jj)).numpy(),
        np.asarray(jpops.relative_poses(poses, ii, jj)), atol=1e-5)


def test_identity_transform_is_a_noop():
    poses, patches, intr, ii, jj, kk = make_scene(0)
    coords = pops.transform(_t(poses), _t(patches), _t(intr), _idx(ii),
                            _idx(ii), _idx(kk))
    expect = torch.stack([_t(patches)[:, 0], _t(patches)[:, 1]], -1)
    np.testing.assert_allclose(coords.numpy(), expect.numpy(), atol=1e-3)


def test_point_cloud_and_flow_mag_match_jax():
    poses, patches, intr, ii, jj, kk = make_scene(4)
    np.testing.assert_allclose(
        pops.point_cloud(_t(poses), _t(patches), _t(intr), _idx(ii)).numpy(),
        np.asarray(jpops.point_cloud(poses, patches, intr, ii)),
        atol=1e-4, rtol=1e-4)
    for beta in (0.3, 0.5):
        np.testing.assert_allclose(
            pops.flow_mag(_t(poses), _t(patches), _t(intr), _idx(ii),
                          _idx(jj), _idx(kk), beta=beta).numpy(),
            np.asarray(jpops.flow_mag(poses, patches, intr, ii, jj, kk,
                                      beta=beta)), atol=1e-4, rtol=1e-4)
    fm = pops.flow_mag(_t(poses), _t(patches), _t(intr), _idx(ii), _idx(ii),
                       _idx(kk))
    np.testing.assert_allclose(fm.numpy(), 0.0, atol=1e-3)
    X = pops.iproj(_t(patches), _t(intr)[_idx(ii)])
    np.testing.assert_allclose(
        X.numpy(), np.asarray(jpops.iproj(patches, intr[ii])), atol=1e-6)
    np.testing.assert_allclose(
        pops.proj(X, _t(intr)[_idx(ii)], depth=True).numpy(),
        np.asarray(jpops.proj(jnp.asarray(X.numpy()), intr[ii], depth=True)),
        atol=1e-4, rtol=1e-5)


def test_transform_gradients_match_jax():
    """d sum(sin(coords)) / d(poses, patches) through transform, within
    atol 1e-3 + rtol 1e-4."""
    poses, patches, intr, ii, jj, kk = make_scene(5)

    def jloss(p, q):
        return jnp.sum(jnp.sin(jpops.transform(p, q, intr, ii, jj, kk)))

    want = jax.grad(jloss, argnums=(0, 1))(poses, patches)
    p, q = _t(poses).requires_grad_(True), _t(patches).requires_grad_(True)
    torch.sin(pops.transform(p, q, _t(intr), _idx(ii), _idx(jj),
                             _idx(kk))).sum().backward()
    for g, w in zip((p.grad, q.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=1e-4)


# ---------------------------------------------------------------- neighbors

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_neighbors_match_jax_on_unsorted_masked_edges(seed):
    """Unsorted (kk, jj) tables with masked rows and repeated pairs: the
    same predecessor and successor edge ids as devo_tpu, -1 where there is
    none."""
    rng = np.random.default_rng(seed)
    E = 60
    kk = rng.integers(0, 7, E).astype(np.int32)
    jj = rng.integers(0, 9, E).astype(np.int32)
    dup = rng.integers(0, E, 8)
    kk[dup[:4]], jj[dup[:4]] = kk[dup[4:]], jj[dup[4:]]     # repeated pairs
    mask = rng.random(E) > 0.2
    want = jgraph.neighbors(jnp.asarray(kk), jnp.asarray(jj), jnp.asarray(mask))
    got = neighbors(_idx(kk), _idx(jj), _t(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0][~_t(mask)] == -1).all() and (got[1][~_t(mask)] == -1).all()
    ix, jx = neighbors(_idx(kk), _idx(jj))          # no mask: every edge
    wix, wjx = jgraph.neighbors(jnp.asarray(kk), jnp.asarray(jj),
                                jnp.ones(E, bool))
    np.testing.assert_array_equal(ix.numpy(), np.asarray(wix))
    np.testing.assert_array_equal(jx.numpy(), np.asarray(wjx))


# ---------------------------------------------------------- gradient VJPs

@pytest.mark.parametrize("name", ["clip", "zero"])
def test_gradient_identities_match_jax(name):
    """The forward is the identity (bit for bit); the backward maps NaN to
    0 and clamps (clip) or zeroes (zero) large gradients, as devo_tpu's
    custom_vjp: exactly its gradients on NaN, large and small cotangents."""
    tf = {"clip": gradient_clip, "zero": gradient_zero}[name]
    jf = {"clip": jblocks.gradient_clip, "zero": jblocks.gradient_zero}[name]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(64).astype(np.float32)
    ct = np.concatenate([[np.nan, -np.nan, 1e3, -1e3, 0.05, -0.05, 0.2, -0.2,
                          0.1, -0.1, 0.01, -0.01, 0.0],
                         rng.standard_normal(51) * 0.1]).astype(np.float32)
    _, vjp = jax.vjp(jf, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    xt = _t(x).requires_grad_(True)
    y = tf(xt)
    assert torch.equal(y.detach(), _t(x))
    y.backward(_t(ct))
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    with torch.no_grad():
        assert torch.equal(tf(_t(x)), _t(x))


def test_update_heads_clip_the_gradient():
    """nets/update.Update's delta and weight heads pass their gradient
    through gradient_clip, as devo_tpu/nets/update.py:100-102: a large
    cotangent on delta reaches the head's bias clamped to 0.01 an edge."""
    from devo_tpu_torch.nets.update import Update
    torch.manual_seed(0)
    upd = Update(dim=16, corr_dim=2 * 49 * 9)
    E = 6
    kk = torch.arange(E)
    none = torch.full((E,), -1)
    _, delta, weight = upd(torch.randn(E, 16), torch.randn(E, 16),
                           torch.randn(E, 882), none, none, kk, E,
                           torch.zeros(E, dtype=torch.long), 1,
                           torch.ones(E, dtype=torch.bool))
    (1e3 * delta.sum()).backward(retain_graph=True)
    np.testing.assert_allclose(upd.d[1].bias.grad.numpy(), [0.01 * E] * 2,
                               rtol=1e-6)
    upd.zero_grad()
    (-1e3 * weight.sum()).backward()
    assert (upd.w[1].bias.grad.abs() <= 0.01 * E + 1e-6).all()


# ----------------------------------------------------- differentiable BA

def _ba_inputs(seed):
    poses, patches, intr, ii, jj, kk, target, mask, weight = _scene(seed)
    n, M = poses.shape[0], patches.shape[0]
    return dict(poses=poses, patches=patches.reshape(M, -1), intr=intr, ii=ii,
                jj=jj, kk=kk, target=target, mask=mask, weight=weight, n=n, M=M)


@pytest.mark.parametrize("seed", [0, 1])
def test_differentiable_ba_matches_jax_grad(seed):
    """One differentiable Gauss-Newton step with the training constants
    (max_residual 250, ep 10, the whole window's depths clamped to
    [1e-3, 10]) on tests/test_ba.py's scene: its poses and patches against
    devo_tpu's gauss_newton_step(depth_clamp="training") within 1e-3 of
    each tensor's largest entry, and the gradients of a scalar loss of them
    with respect to target, weight, poses and patches against their float64
    truth.

    The scene's Schur system is ill-conditioned (ROADMAP Queue 3): f32
    gradients lie up to 1.8e-3 of the largest entry from f64, JAX's as far
    as the port's, and which of the two lies farther changes with the order
    of the edges alone. So the yardstick is the truth, the port's step in
    float64 (devo_tpu's step cannot run under jax_enable_x64), checked
    against jax.grad; and the port's f32 gradients are held to it within
    max(1e-3, 2 x the largest gap of jax.grad's f32 gradients from it) of
    each tensor's largest entry, the rule of chip_smoke.py's reference
    phase (REF_SPREAD)."""
    s = _ba_inputs(seed)
    n, M = s["n"], s["M"]
    rng = np.random.default_rng(10 + seed)
    A = rng.standard_normal((n, 7)).astype(np.float32)
    B = rng.standard_normal(s["patches"].shape).astype(np.float32)
    bounds = np.asarray([-64.0, -64.0, 160 + 64.0, 120 + 64.0], np.float32)
    kw = dict(window=n - 1, patch_slots=M, max_residual=250.0, ep=10.0,
              lm=1e-4, structure_only=False)

    def jstep(target, weight, poses, patches):
        return jba.gauss_newton_step(
            poses, patches, jnp.asarray(s["intr"]), target, weight,
            jnp.float32(1e-4), jnp.asarray(s["ii"]), jnp.asarray(s["jj"]),
            jnp.asarray(s["kk"]), jnp.asarray(s["mask"]), t0=jnp.int32(1),
            t1=jnp.int32(n), kbase=jnp.int32(0), bounds=jnp.asarray(bounds),
            depth_clamp="training", **kw)[:2]

    def jloss(*a):
        p, q = jstep(*a)
        return jnp.sum(p * A) + jnp.sum(q * B)

    names = ("target", "weight", "poses", "patches")
    jargs = tuple(jnp.asarray(s[k]) for k in names)
    want_out = jstep(*jargs)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)

    def port(dtype):
        targs = [_t(s[k]).to(dtype).requires_grad_(True) for k in names]
        p_in, q_in = targs[2].clone(), targs[3].clone()
        p, q, ok = ba.gauss_newton_step_diff(
            targs[2], targs[3], _t(s["intr"]).to(dtype), targs[0], targs[1],
            1e-4, _idx(s["ii"]), _idx(s["jj"]), _idx(s["kk"]), _t(s["mask"]),
            t0=1, t1=n, kbase=0, bounds=_t(bounds).to(dtype), **kw)
        assert bool(ok)
        ((p * _t(A).to(dtype)).sum() + (q * _t(B).to(dtype)).sum()).backward()
        # the inputs are untouched: no in-place write
        assert torch.equal(targs[2].detach(), p_in.detach())
        assert torch.equal(targs[3].detach(), q_in.detach())
        return p.detach(), q.detach(), targs

    def close(got, w, what, tol=1e-3):
        w = np.asarray(w)
        np.testing.assert_allclose(got, w, rtol=1e-3,
                                   atol=tol * np.abs(w).max(), err_msg=what)

    p, q, targs = port(torch.float32)
    close(p.numpy(), want_out[0], "poses")
    close(q.numpy(), want_out[1], "patches")
    PP = q.shape[1] // 3
    d = q[:, 2 * PP:]
    assert float(d.min()) >= 1e-3 and float(d.max()) <= 10
    truth = [t.grad.numpy() for t in port(torch.float64)[2]]
    for name, t, w, g in zip(names, targs, want, truth):
        assert t.grad is not None and torch.isfinite(t.grad).all(), name
        spread = float(np.abs(np.asarray(w) - g).max() / np.abs(g).max())
        # the truth is jax.grad's own, to its f32 rounding: about twice the
        # largest gap measured (1.21e-3, weight, seed 0)
        assert spread < 2.5e-3, (name, spread)
        close(t.grad.numpy(), g, f"d loss / d {name}", max(1e-3, 2 * spread))


def test_differentiable_ba_solves_the_tracking_steps_system():
    """With the tracking step's constants the differentiable step solves
    the in-place step's system: the same poses bit for bit, and the same
    depths wherever neither clamp acts (the in-place depth strictly inside
    (1e-3, 10) and not its reset value 1)."""
    s = _ba_inputs(0)
    n, M = s["n"], s["M"]
    bounds = _t(np.asarray([-64.0, -64.0, 224.0, 184.0], np.float32))
    kw = dict(t0=1, t1=n, kbase=0, window=n - 1, patch_slots=M, bounds=bounds,
              max_residual=128.0, ep=1.0, lm=1e-4)

    def args(p, q):
        return (p, q, _t(s["intr"]), _t(s["target"]), _t(s["weight"]), 1e-4,
                _idx(s["ii"]), _idx(s["jj"]), _idx(s["kk"]), _t(s["mask"]))

    p0, q0 = _t(s["poses"]), _t(s["patches"])
    ba.gauss_newton_step(*args(p0, q0), **kw)
    p1, q1, _ = ba.gauss_newton_step_diff(*args(_t(s["poses"]),
                                                _t(s["patches"])), **kw)
    assert torch.equal(p0, p1)
    PP = q0.shape[1] // 3
    assert torch.equal(q0[:, :2 * PP], q1[:, :2 * PP])
    d0, d1 = q0[:, 2 * PP:], q1[:, 2 * PP:]
    free = (d0 > 1e-3) & (d0 < 10.0) & (d0 != 1.0)
    assert free.float().mean() > 0.9
    assert torch.equal(d0[free], d1[free])


# --------------------------------------------------- training correlation

def _corr_case(E=12, M=6, N=3, H=16, W=20, C=8, P=3, seed=0):
    """tests/test_corr_dropout.py's fixture."""
    rng = np.random.default_rng(seed)
    gmap = rng.standard_normal((M, P, P, C)).astype(np.float32)
    pyr = (rng.standard_normal((N, H, W, C)).astype(np.float32),
           rng.standard_normal((N, H // 4, W // 4, C)).astype(np.float32))
    coords = rng.uniform(2, min(H, W) - 3, (E, P, P, 2)).astype(np.float32)
    kk = rng.integers(0, M, E).astype(np.int32)
    jj = rng.integers(0, N, E).astype(np.int32)
    return gmap, pyr, coords, kk, jj


def _torch_grads(gmap, pyr, coords, kk, jj, **kw):
    g = _t(gmap).requires_grad_(True)
    p = [_t(a).requires_grad_(True) for a in pyr]
    c = _t(coords).requires_grad_(True)
    out = corr_plain.corr_pyramid_train(g, p, c, _idx(kk), _idx(jj), **kw)
    torch.sin(out).sum().backward()
    return out, g.grad, [a.grad for a in p], c.grad


@pytest.mark.parametrize("dropout", [0.5, 0.2])
def test_corr_pyramid_train_matches_jax(dropout):
    """The forward is corr_pyramid's; with devo_tpu's keep mask passed in
    (uniform(key, (E,)) < dropout), the gmap and pyramid gradients of
    sum(sin(out)) are devo_tpu's within atol 1e-5 + rtol 1e-5; the
    coordinates get a zero gradient."""
    gmap, pyr, coords, kk, jj = _corr_case()
    key = jax.random.PRNGKey(42)
    keep = np.asarray(jax.random.uniform(key, (kk.shape[0],)) < dropout)
    assert 0 < keep.sum() < keep.size
    jargs = (jnp.asarray(gmap), tuple(jnp.asarray(a) for a in pyr),
             jnp.asarray(coords), jnp.asarray(kk), jnp.asarray(jj))
    want_g, want_p = jax.grad(
        lambda g, p: jnp.sum(jnp.sin(jcorr.corr_pyramid_train(
            g, p, jargs[2], jargs[3], jargs[4], key, dropout=dropout))),
        argnums=(0, 1))(jargs[0], jargs[1])
    out, g, p, c = _torch_grads(gmap, pyr, coords, kk, jj, dropout=dropout,
                                keep=_t(keep))
    plain = corr_plain.corr_pyramid(_t(gmap), [_t(a) for a in pyr],
                                    _t(coords), _idx(kk), _idx(jj))
    assert torch.equal(out.detach(), plain)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jcorr.corr_pyramid(*jargs)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), atol=1e-5, rtol=1e-5)
    for a, b in zip(p, want_p):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    assert torch.equal(c, torch.zeros_like(c))


def test_corr_pyramid_train_dropout_one_is_the_full_gradient():
    """dropout=1 keeps every edge: the gradient of the plain correlation
    with the coordinates detached, bit for bit, and still none to the
    coordinates; a generator's draw keeps a subset, the same for one
    seed."""
    gmap, pyr, coords, kk, jj = _corr_case(seed=1)
    _, g, p, c = _torch_grads(gmap, pyr, coords, kk, jj, dropout=1.0)
    g0 = _t(gmap).requires_grad_(True)
    p0 = [_t(a).requires_grad_(True) for a in pyr]
    torch.sin(corr_plain.corr_pyramid(g0, p0, _t(coords), _idx(kk),
                                      _idx(jj))).sum().backward()
    assert torch.equal(g, g0.grad)
    assert all(torch.equal(a, b.grad) for a, b in zip(p, p0))
    assert torch.equal(c, torch.zeros_like(c))
    runs = [_torch_grads(gmap, pyr, coords, kk, jj, dropout=0.5,
                         generator=torch.Generator().manual_seed(s))[1]
            for s in (3, 3)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], g)
