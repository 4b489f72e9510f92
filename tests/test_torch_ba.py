"""Port parity: edge geometry and bundle adjustment of devo_tpu_torch against
devo_tpu on the synthetic scene of tests/test_ba.py (known poses and
depths, perturbed), in f32. Poses and depths are compared after 2
Gauss-Newton iterations.

Tolerances: the scene's Schur system is ill-conditioned enough that each
f32 solve lies up to 5e-5 (poses) and 3e-4 (depths) from the float64 one,
so the two f32 solves are held to 2e-4 and 1e-3."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from devo_tpu.geom import edgewise as jedge
from devo_tpu.lie import se3 as jse3
from devo_tpu.ops import ba as jba
from devo_tpu_torch.geom import edgewise
from devo_tpu_torch.ops import ba

from test_ba import build_scene


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(seed):
    poses_gt, patches_gt, intr, ii, jj, kk, target, mask, rng = build_scene(seed)
    n, M = poses_gt.shape[0], patches_gt.shape[0]
    noise = rng.standard_normal((n, 6)).astype(np.float32) * 0.01
    noise[0] = 0.0
    poses0 = np.asarray(jse3.retr(poses_gt, jnp.asarray(noise)))
    patches0 = np.array(patches_gt)
    patches0[:, 2] *= rng.uniform(0.8, 1.2, (M, 1, 1)).astype(np.float32)
    mask = np.array(mask)
    mask[::7] = False                       # some masked rows
    weight = rng.uniform(0.2, 1.0, (ii.shape[0], 2)).astype(np.float32)
    return (poses0, patches0, np.asarray(intr), np.asarray(ii),
            np.asarray(jj), np.asarray(kk), np.asarray(target), mask, weight)


def test_reproject_and_jacobians_match_jax():
    poses, patches, intr, ii, jj, kk, _, _, _ = _scene(0)
    flat = patches.reshape(patches.shape[0], -1)
    want = jedge.reproject(jnp.asarray(poses), jnp.asarray(flat),
                           jnp.asarray(intr), jnp.asarray(ii), jnp.asarray(jj),
                           jnp.asarray(kk), jacobian=True)
    got = edgewise.reproject(_t(poses), _t(flat), _t(intr), _t(ii).long(),
                             _t(jj).long(), _t(kk).long(), jacobian=True)
    E = ii.shape[0]
    for name in ("coords_x", "coords_y", "center_x", "center_y", "valid", "Jz"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-4, rtol=1e-5, err_msg=name)
    for name in ("Ji", "Jj"):
        np.testing.assert_allclose(getattr(got, name).reshape(E, 12).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-3, rtol=1e-5, err_msg=name)
    fm_w = jedge.flow_mag_edges(jnp.asarray(poses), jnp.asarray(flat),
                                jnp.asarray(intr), jnp.asarray(ii),
                                jnp.asarray(jj), jnp.asarray(kk))
    fm_g = edgewise.flow_mag_edges(_t(poses), _t(flat), _t(intr), _t(ii).long(),
                                   _t(jj).long(), _t(kk).long())
    np.testing.assert_allclose(fm_g.numpy(), np.asarray(fm_w), atol=1e-4)


@pytest.mark.parametrize("structure_only", [False, True], ids=["full", "structure"])
@pytest.mark.parametrize("seed", [0, 1])
def test_run_ba_matches_jax(seed, structure_only):
    poses, patches, intr, ii, jj, kk, target, mask, weight = _scene(seed)
    n, M, P = poses.shape[0], patches.shape[0], patches.shape[-1]
    kw = dict(t0=1, t1=n, kbase=0, window=n - 1, patch_slots=M,
              iterations=2, structure_only=structure_only)
    bounds = np.asarray([-64.0, -64.0, 160 + 64.0, 120 + 64.0], np.float32)
    wp, wpatch = jba.run_ba(
        jnp.asarray(poses), jnp.asarray(patches), jnp.asarray(intr),
        jnp.asarray(target), jnp.asarray(weight), jnp.float32(1e-4),
        jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(kk), jnp.asarray(mask),
        bounds=jnp.asarray(bounds), **{k: (jnp.int32(v) if k in ("t0", "t1", "kbase") else v)
                                       for k, v in kw.items()})
    gp, gpatch = ba.run_ba(
        _t(poses), _t(patches.reshape(M, 3 * P * P)), _t(intr), _t(target),
        _t(weight), 1e-4, _t(ii).long(), _t(jj).long(), _t(kk).long(),
        _t(mask), bounds=_t(bounds), **kw)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=2e-4)
    np.testing.assert_allclose(gpatch.reshape(M, 3, P, P).numpy(),
                               np.asarray(wpatch), atol=1e-3)
    if not structure_only:
        assert not np.allclose(gp.numpy(), poses)      # the solve moved poses
    else:
        np.testing.assert_array_equal(gp.numpy(), poses)


def test_schur_solve_flags_failed_cholesky():
    n, m = 2, 3
    sys = ba.BASystem(B=-torch.eye(6 * n) * 10, E=torch.zeros(6 * n, m),
                      C=torch.ones(m), v=torch.ones(6 * n), u=torch.ones(m))
    dX, dZ, ok = ba.schur_solve(sys, 1e-4, ep=1.0, lm=1e-4)
    assert not bool(ok)
    assert torch.equal(dX, torch.zeros(n, 6))
    torch.testing.assert_close(dZ, torch.full((m,), 1.0 / (1.0 + 1e-4)))
