"""Port parity: the Lie-group ops of devo_tpu_torch.lie against devo_tpu.lie
on the same numpy-seeded inputs, in f32 with atol 1e-5."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from devo_tpu.lie import se3 as jse3, so3 as jso3
from devo_tpu_torch.lie import se3, so3

ATOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def _rand_se3(rng, n, scale=1.0):
    xi = rng.standard_normal((n, 6)).astype(np.float32) * scale
    return np.asarray(jse3.exp(jnp.asarray(xi)))


def _check(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# tangent scales: ordinary angles and the small-angle Taylor branch
@pytest.mark.parametrize("scale", [1.0, 1e-4], ids=["normal", "small"])
def test_so3_ops_match_jax(scale):
    rng = np.random.default_rng(0)
    phi = rng.standard_normal((16, 3)).astype(np.float32) * scale
    q = np.asarray(jso3.exp(jnp.asarray(rng.standard_normal((16, 3)).astype(np.float32))))
    q2 = np.asarray(jso3.exp(jnp.asarray(rng.standard_normal((16, 3)).astype(np.float32))))
    p = rng.standard_normal((16, 3)).astype(np.float32)
    p4 = rng.standard_normal((16, 4)).astype(np.float32)
    J = jnp.asarray
    _check(so3.exp(t(phi)), jso3.exp(J(phi)))
    _check(so3.log(so3.exp(t(phi))), jso3.log(jso3.exp(J(phi))))
    _check(so3.log(t(q)), jso3.log(J(q)))
    _check(so3.inv(t(q)), jso3.inv(J(q)))
    _check(so3.mul(t(q), t(q2)), jso3.mul(J(q), J(q2)))
    _check(so3.act(t(q), t(p)), jso3.act(J(q), J(p)))
    _check(so3.act4(t(q), t(p4)), jso3.act4(J(q), J(p4)))
    _check(so3.adj(t(q), t(p)), jso3.adj(J(q), J(p)))
    _check(so3.adjT(t(q), t(p)), jso3.adjT(J(q), J(p)))
    _check(so3.retr(t(q), t(phi)), jso3.retr(J(q), J(phi)))
    _check(so3.left_jacobian(t(phi)), jso3.left_jacobian(J(phi)))
    _check(so3.left_jacobian_inverse(t(phi)), jso3.left_jacobian_inverse(J(phi)))
    _check(so3.identity((3,)), jso3.identity((3,)))


@pytest.mark.parametrize("scale", [1.0, 1e-4], ids=["normal", "small"])
def test_se3_ops_match_jax(scale):
    rng = np.random.default_rng(1)
    xi = rng.standard_normal((16, 6)).astype(np.float32) * scale
    g1, g2 = _rand_se3(rng, 16), _rand_se3(rng, 16)
    p = rng.standard_normal((16, 3)).astype(np.float32)
    p4 = rng.standard_normal((16, 4)).astype(np.float32)
    a = rng.standard_normal((16, 6)).astype(np.float32)
    J = jnp.asarray
    _check(se3.exp(t(xi)), jse3.exp(J(xi)))
    _check(se3.log(t(g1)), jse3.log(J(g1)))
    _check(se3.log(se3.exp(t(xi))), jse3.log(jse3.exp(J(xi))))
    _check(se3.inv(t(g1)), jse3.inv(J(g1)))
    _check(se3.mul(t(g1), t(g2)), jse3.mul(J(g1), J(g2)))
    _check(se3.act(t(g1), t(p)), jse3.act(J(g1), J(p)))
    _check(se3.act4(t(g1), t(p4)), jse3.act4(J(g1), J(p4)))
    _check(se3.adj(t(g1), t(a)), jse3.adj(J(g1), J(a)))
    _check(se3.adjT(t(g1), t(a)), jse3.adjT(J(g1), J(a)))
    _check(se3.retr(t(g1), t(xi)), jse3.retr(J(g1), J(xi)))
    _check(se3.identity((2, 3)), jse3.identity((2, 3)))


def test_se3_broadcasts_over_leading_dims():
    rng = np.random.default_rng(2)
    g = t(_rand_se3(rng, 4))
    pts = t(rng.standard_normal((4, 3, 3, 4)).astype(np.float32))
    out = se3.act4(g[:, None, None, :], pts)
    assert out.shape == (4, 3, 3, 4)
    want = jse3.act4(jnp.asarray(g.numpy())[:, None, None, :],
                     jnp.asarray(pts.numpy()))
    _check(out, want)


# ---------------------------------------------------------------------------
# The rest of the groups and helpers: quaternion <-> matrix, so3 / se3
# matrices, se3's accessors, Sim(3) and RxSO(3), against devo_tpu.lie in f32.

from devo_tpu.lie import quaternion as jquat, rxso3 as jrxso3, sim3 as jsim3
from devo_tpu_torch.lie import quaternion, rxso3, sim3

GROUPS = {"so3": (so3, jso3, 3), "rxso3": (rxso3, jrxso3, 4),
          "se3": (se3, jse3, 6), "sim3": (sim3, jsim3, 7)}


@pytest.mark.parametrize("scale", [1.0, 1e-4], ids=["normal", "small"])
def test_quaternion_and_matrix_helpers_match_jax(scale):
    rng = np.random.default_rng(3)
    J = jnp.asarray
    phi = rng.standard_normal((32, 3)).astype(np.float32) * scale
    # rotations near pi as well: every Shepperd pivot of matrix_to_quat
    phi[:8] *= np.float32(np.pi - 1e-3) / np.linalg.norm(phi[:8], axis=-1,
                                                         keepdims=True)
    q = np.asarray(jso3.exp(J(phi)))
    R = np.asarray(jquat.quat_to_matrix(J(q)))
    _check(quaternion.quat_to_matrix(t(q)), jquat.quat_to_matrix(J(q)))
    _check(quaternion.matrix_to_quat(t(R)), jquat.matrix_to_quat(J(R)))
    _check(so3.matrix(t(q)), jso3.matrix(J(q)))
    _check(so3.from_matrix(t(R)), jso3.from_matrix(J(R)))
    g = _rand_se3(rng, 16, scale)
    T = np.asarray(jse3.matrix(J(g)))
    _check(se3.matrix(t(g)), jse3.matrix(J(g)))
    _check(se3.from_matrix(t(T)), jse3.from_matrix(J(T)))
    _check(se3.translation(t(g)), jse3.translation(J(g)))
    _check(se3.rotation(t(g)), jse3.rotation(J(g)))
    _check(se3.make(t(g[:, :3]), t(g[:, 3:])), jse3.make(J(g[:, :3]), J(g[:, 3:])))
    _check(se3.scale(t(g), 2.5), jse3.scale(J(g), 2.5))
    # the round trip through the matrix is the same pose (up to the
    # quaternion's sign)
    rel = se3.log(se3.mul(se3.inv(t(g)), se3.from_matrix(se3.matrix(t(g)))))
    np.testing.assert_allclose(rel.numpy(), 0.0, atol=ATOL)


@pytest.mark.parametrize("scale", [1.0, 1e-4, 1e-7],
                         ids=["normal", "small", "tiny"])
@pytest.mark.parametrize("name", ["sim3", "rxso3"])
def test_scaled_groups_match_jax(name, scale):
    """Every function of Sim(3) and RxSO(3), on ordinary tangents and on the
    small-angle / small-scale branches of W and W^-1."""
    g, jg, dim = GROUPS[name]
    rng = np.random.default_rng(4)
    J = jnp.asarray
    x = rng.standard_normal((16, dim)).astype(np.float32) * scale
    # the four branch pairs of W: sigma and theta each small or not
    x[:4, -1] = 0.0
    if name == "sim3":
        x[4:8, 3:6] = 0.0
    a = rng.standard_normal((16, dim)).astype(np.float32)
    X1 = np.asarray(jg.exp(J(rng.standard_normal((16, dim)).astype(np.float32))))
    X2 = np.asarray(jg.exp(J(rng.standard_normal((16, dim)).astype(np.float32))))
    p = rng.standard_normal((16, 3)).astype(np.float32)
    p4 = rng.standard_normal((16, 4)).astype(np.float32)
    _check(g.exp(t(x)), jg.exp(J(x)))
    _check(g.log(t(X1)), jg.log(J(X1)))
    _check(g.log(g.exp(t(x))), jg.log(jg.exp(J(x))))
    _check(g.inv(t(X1)), jg.inv(J(X1)))
    _check(g.mul(t(X1), t(X2)), jg.mul(J(X1), J(X2)))
    _check(g.act(t(X1), t(p)), jg.act(J(X1), J(p)))
    _check(g.act4(t(X1), t(p4)), jg.act4(J(X1), J(p4)))
    _check(g.matrix(t(X1)), jg.matrix(J(X1)))
    _check(g.retr(t(X1), t(x)), jg.retr(J(X1), J(x)))
    _check(g.adj(t(X1), t(a)), jg.adj(J(X1), J(a)))
    _check(g.adjT(t(X1), t(a)), jg.adjT(J(X1), J(a)))
    _check(g.identity((2, 3)), jg.identity((2, 3)))
    if name == "sim3":
        phi, sigma = x[:, 3:6], x[:, 6:7]
        _check(sim3._calcW(t(phi), t(sigma)), jsim3._calcW(J(phi), J(sigma)))
        _check(sim3._calcWInv(t(phi), t(sigma)),
               jsim3._calcWInv(J(phi), J(sigma)))


def _tangent(dim, scale, seed, batch=4):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((batch, dim)) * scale)


def _gradcheck_cases():
    """(group, function) pairs of tests/test_lie.py's gradient checks over
    the four groups, and the quaternion helpers."""
    cases = []
    for name in GROUPS:
        cases += [(name, f) for f in ("exp", "log", "inv", "adj", "adjT",
                                      "act4", "mul", "act", "retr", "matrix")]
    cases += [("quaternion", f) for f in ("qmul", "qrot", "qnormalize",
                                          "quat_to_matrix", "matrix_to_quat")]
    return cases


@pytest.mark.parametrize("name,fn", _gradcheck_cases(),
                         ids=[f"{n}-{f}" for n, f in _gradcheck_cases()])
def test_gradcheck_f64(name, fn):
    """torch.autograd.gradcheck in f64 (the counterpart of test_lie.py's
    check_grads) of each function of each group with respect to all of its
    arguments, at tangents of scale 0.5."""
    if name == "quaternion":
        q = so3.exp(_tangent(3, 0.5, 20))
        q2 = so3.exp(_tangent(3, 0.5, 21))
        v = _tangent(3, 1.0, 22)
        args = {"qmul": (q, q2), "qrot": (q, v), "qnormalize": (q * 1.3,),
                "quat_to_matrix": (q,),
                "matrix_to_quat": (quaternion.quat_to_matrix(q),)}[fn]
        f = getattr(quaternion, fn)
    else:
        g, _, dim = GROUPS[name]
        X = g.exp(_tangent(dim, 0.5, 23))
        Y = g.exp(_tangent(dim, 0.5, 24))
        a = _tangent(dim, 0.5, 25)
        args = {"exp": (a,), "log": (X,), "inv": (X,), "adj": (X, a),
                "adjT": (X, a), "act4": (X, _tangent(4, 1.0, 26)),
                "mul": (X, Y), "act": (X, _tangent(3, 1.0, 27)),
                "retr": (X, a), "matrix": (X,)}[fn]
        f = getattr(g, fn)
    args = tuple(x.detach().clone().requires_grad_(True) for x in args)
    assert torch.autograd.gradcheck(f, args, eps=1e-6, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", list(GROUPS))
def test_exp_gradient_finite_near_zero(name):
    """The Taylor branches are differentiable too (test_lie.py's
    test_exp_gradcheck_near_zero), and so are the degenerate points of
    test_grad_finite_at_degenerate_points: identity, near-identity and
    near-pi rotations."""
    g, _, dim = GROUPS[name]
    x = _tangent(dim, 1e-5, 28).float().requires_grad_(True)
    g.exp(x).sum().backward()
    assert torch.isfinite(x.grad).all()
    for make in (lambda: g.identity((2,)),
                 lambda: g.exp(_tangent(dim, 1e-9, 29).float())):
        X = make().requires_grad_(True)
        g.log(X).sum().backward()
        assert torch.isfinite(X.grad).all()
    q = so3.exp(torch.tensor([[np.pi - 1e-4, 0.0, 0.0]])).requires_grad_(True)
    so3.log(q).sum().backward()
    assert torch.isfinite(q.grad).all()
    for f in (so3.left_jacobian, so3.left_jacobian_inverse):
        p = torch.tensor([[0.0, 0.0, 0.0], [1e-9, 0, 0], [0, 1e-4, 0]],
                         requires_grad=True)
        f(p).sum().backward()
        assert torch.isfinite(p.grad).all()
