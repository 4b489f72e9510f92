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
