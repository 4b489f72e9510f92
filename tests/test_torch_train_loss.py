"""Port parity of the training losses (devo_tpu_torch/train/loss.py against
devo_tpu/train/loss.py) on seeded made-up trajectory steps: each step loss
and its gradients against jax.grad, the Umeyama scale, the guarded norm's
gradient at 0, and total_loss's step rules (the pose loss from step 2 on
and never under structure_only, the scorer loss on the last step only and
only for the scorer selector). Values within rtol 1e-5 and gradients
within 1e-4 of each tensor's largest entry: sums of a few hundred f32
terms in another order, and an SVD.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from devo_tpu.lie import se3 as jse3
from devo_tpu.train import loss as jl
from devo_tpu_torch.train import loss as tl

P, N, PPI = 3, 6, 5


def _step(seed, with_scores=True):
    """A made-up trajectory step: N frames, N*PPI patches, every frame pair
    an edge for each patch, some invalid and masked."""
    rng = np.random.default_rng(seed)
    M = N * PPI
    kk = np.repeat(np.arange(M), N)
    jj = np.tile(np.arange(N), M)
    ii = kk // PPI
    E = kk.size
    coords_gt = rng.uniform(0, 40, (E, P, P, 2)).astype(np.float32)
    coords = (coords_gt + rng.normal(0, 2, coords_gt.shape)).astype(np.float32)
    coords[3] = coords_gt[3]                       # an exact zero residual
    xi = rng.standard_normal((N, 6)).astype(np.float32) * 0.2
    Ps = np.asarray(jse3.exp(jnp.asarray(xi)))
    Gs = np.asarray(jse3.exp(jnp.asarray(
        xi + rng.standard_normal((N, 6)).astype(np.float32) * 0.05)))
    step = dict(
        ii=ii, jj=jj, kk=kk, coords=coords, coords_gt=coords_gt,
        valid=(rng.random(E) > 0.2).astype(np.float32),
        emask=rng.random(E) > 0.1,
        weight=rng.uniform(0.01, 1.0, (E, 2)).astype(np.float32),
        Gs=Gs, Ps=Ps,
        scores=(rng.uniform(0.05, 1.0, (N, PPI)).astype(np.float32)
                if with_scores else None))
    return step


DIFF = ("coords", "weight", "Gs", "scores")


def _torch_step(step, grad=False):
    out = {}
    for k, v in step.items():
        if isinstance(v, np.ndarray) and k not in ("ii", "jj", "kk"):
            t = torch.from_numpy(v.copy())
            if grad and k in DIFF:
                t.requires_grad_(True)
            out[k] = t
        else:
            out[k] = v
    return out


def _jax_step(step, **leaves):
    out = {k: (jnp.asarray(v) if isinstance(v, np.ndarray)
               and k not in ("ii", "jj", "kk") else v)
           for k, v in step.items()}
    out.update(leaves)
    return out


def _close_grad(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("which", ["flow", "pose", "scorer"])
def test_step_losses_and_gradients_match_jax(which, seed):
    step = _step(seed)
    jfn = {"flow": lambda s: jl.flow_loss_step(s, P), "pose": jl.pose_loss_step,
           "scorer": lambda s: jl.scorer_loss_step(s, P)}[which]
    tfn = {"flow": lambda s: tl.flow_loss_step(s, P), "pose": tl.pose_loss_step,
           "scorer": lambda s: tl.scorer_loss_step(s, P)}[which]
    keys = [k for k in DIFF if step[k] is not None]
    jleaves = {k: jnp.asarray(step[k]) for k in keys}
    want, wgrads = jax.value_and_grad(
        lambda lv: jfn(_jax_step(step, **lv)))(jleaves)
    ts = _torch_step(step, grad=True)
    got = tfn(ts)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for k in keys:
        g = ts[k].grad
        if g is None:                   # the loss does not read it
            assert not np.abs(np.asarray(wgrads[k])).any(), k
            continue
        assert torch.isfinite(g).all(), k
        _close_grad(g, wgrads[k], f"{which} d/d {k}")


def test_umeyama_scale_matches_and_is_not_differentiated():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((7, 3)).astype(np.float32)
    B = (2.5 * A + rng.normal(0, 0.01, A.shape)).astype(np.float32)
    want = float(jl.kabsch_umeyama_scale(jnp.asarray(A), jnp.asarray(B)))
    got = float(tl.kabsch_umeyama_scale(torch.from_numpy(A), torch.from_numpy(B)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert abs(got - 0.4) < 1e-2
    # the pose loss holds the scale fixed: its gradient is the one with the
    # scale a constant (stop_gradient in devo_tpu, no_grad here)
    step = _step(4)
    ts = _torch_step(step, grad=True)
    tl.pose_loss_step(ts).backward()
    assert torch.isfinite(ts["Gs"].grad).all()


def test_safe_norm_gradient_is_zero_at_zero():
    x = torch.zeros(4, 2, requires_grad=True)
    tl._safe_norm(x).sum().backward()
    assert torch.equal(x.grad, torch.zeros_like(x))
    j = jax.grad(lambda a: jl._safe_norm(a).sum())(jnp.zeros((4, 2)))
    np.testing.assert_array_equal(np.asarray(j), 0.0)


@pytest.mark.parametrize("structure_only", [False, True])
@pytest.mark.parametrize("use_scorer", [True, False])
def test_total_loss_step_rules_match(structure_only, use_scorer):
    """Four steps: the flow loss at each, the pose loss from the third on
    (none under structure_only), the scorer loss at the last for the
    scorer selector; the returned terms are the last step's."""
    steps = [_step(10 + i, with_scores=use_scorer) for i in range(4)]
    want = jl.total_loss([_jax_step(s) for s in steps], P=P,
                         structure_only=structure_only, use_scorer=use_scorer)
    got = tl.total_loss([_torch_step(s) for s in steps], P=P,
                        structure_only=structure_only, use_scorer=use_scorer)
    for k in ("loss", "flow", "pose", "scores"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    flows = [float(tl.flow_loss_step(_torch_step(s), P)) for s in steps]
    poses = [float(tl.pose_loss_step(_torch_step(s))) for s in steps]
    expect = 0.1 * sum(flows)
    if not structure_only:
        expect += 10.0 * sum(poses[2:])
    if use_scorer:
        expect += 0.05 * float(tl.scorer_loss_step(_torch_step(steps[-1]), P))
    np.testing.assert_allclose(float(got["loss"]), expect, rtol=1e-5)
