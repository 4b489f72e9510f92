"""Port parity of the unrolled training forward (devo_tpu_torch/train/
forward.py against devo_tpu/train/forward.py) with devo_tpu's loss: the
edge schedule, the trajectory of every step (coords, valid, weight, Gs),
the loss, and the gradient of the loss with respect to every parameter
against jax.grad, with devo_tpu's draws injected (`JaxDraws`: its key
splits and fold_ins, forward.py:118, :170, :193, randaug.py:132-151), with
and without randaug, under structure_only and with the gradient and random
selectors; and the port's remat against no remat.

Small size (32/16/8, 48x64, 5 frames, 3 steps, grow_after=2, 4 patches an
image); the JAX side is computed once per module. Tolerance: each tensor
within 1e-3 relative plus 1e-3 of its largest entry, the rule of the
differentiable BA step that every step runs twice (its f32 gradients lie up
to 1.2e-3 of the largest entry from f64, tests/test_torch_train_pieces.py),
plus 1e-6 of the largest gradient entry of the whole network for the
gradients that are 0 analytically (a bias before an instance norm, a
softmax logit's bias).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from devo_tpu.lie import se3 as jse3
from devo_tpu.nets.evonet import EVONet as JNet
from devo_tpu.train import forward as jfwd
from devo_tpu.train.loss import total_loss as jtotal
from devo_tpu_torch.nets.evonet import EVONet
from devo_tpu_torch.train import forward as fwd
from devo_tpu_torch.train.forward import Draws
from devo_tpu_torch.train.loss import total_loss
from devo_tpu_torch.utils.params import jax_params_to_state_dict

N_FRAMES, HT, WD, PPI, STEPS, GROW = 5, 48, 64, 4, 3, 2
DIMS = dict(dim_inet=32, dim_fnet=16, dim=8)
DROPOUT = 0.5
RTOL = 1e-3


class JaxDraws(Draws):
    """devo_tpu's draws for one sample's key: the randaug split first
    where randaug is on, then (k_sel, k_depth, k_drop) = split(key, 3);
    the drop roll of step s from fold_in(k_drop, s), the keep mask from
    fold_in(k_drop, 1000 + s)."""

    def __init__(self, key, randaug_on=False, device="cpu"):
        super().__init__(None, device)
        if randaug_on:
            key, k_aug = jax.random.split(key)
            k_roll, k_aug = jax.random.split(k_aug)
            k_op, k_f = jax.random.split(k_aug)
            self.aug = (bool(jax.random.bernoulli(k_roll, 0.33)),
                        int(jax.random.randint(k_op, (), 0, 7)),
                        int(jax.random.randint(k_f, (), 0, 10)))
        self.k_sel, self.k_depth, self.k_drop = jax.random.split(key, 3)

    def _t(self, a):
        return torch.from_numpy(np.array(a)).to(self.device)

    def augment(self):
        return self.aug

    def candidates(self, n, k, x_high, y_high):
        kx, ky = jax.random.split(self.k_sel)
        return (self._t(jax.random.randint(kx, (n, k), 0, x_high)).long(),
                self._t(jax.random.randint(ky, (n, k), 0, y_high)).long())

    def coords(self, n, ppi, h, w):
        kx, ky = jax.random.split(self.k_sel)
        return (self._t(jax.random.randint(kx, (n, ppi), 1, w - 1)).long(),
                self._t(jax.random.randint(ky, (n, ppi), 1, h - 1)).long())

    def depths(self, m):
        return self._t(jax.random.uniform(self.k_depth, (m, 1, 1))).reshape(m)

    def drop(self, step):
        return bool(jax.random.bernoulli(jax.random.fold_in(self.k_drop, step),
                                         0.1))

    def keep(self, step, E, dropout):
        if dropout >= 1.0:
            return torch.ones(E, dtype=torch.bool, device=self.device)
        k = jax.random.fold_in(self.k_drop, 1000 + step)
        return self._t(jax.random.uniform(k, (E,)) < dropout)


def make_inputs(seed=0):
    """tests/test_train.py's inputs."""
    rng = np.random.default_rng(seed)
    voxels = rng.standard_normal((N_FRAMES, HT, WD, 5)).astype(np.float32)
    voxels *= rng.random((N_FRAMES, HT, WD, 5)) < 0.3
    xi = np.cumsum(rng.standard_normal((N_FRAMES, 6)) * 0.01, 0).astype(np.float32)
    poses = np.asarray(jse3.exp(jnp.asarray(xi)))
    disps = rng.uniform(0.5, 2.0, (N_FRAMES, HT, WD)).astype(np.float32)
    intr = np.asarray([60.0, 60.0, WD / 2, HT / 2], np.float32)
    return voxels, poses, disps, intr


def _randaug_key():
    """A key whose randaug roll augments (p = 0.33)."""
    for i in range(100):
        key = jax.random.PRNGKey(100 + i)
        if JaxDraws(key, randaug_on=True).aug[0]:
            return key
    raise AssertionError("no augmenting key")


CASES = {
    "plain": dict(key=2),
    "randaug": dict(randaug=True),
    "structure_only": dict(key=3, structure_only=True),
}


def _kw(case):
    c = CASES[case]
    return dict(structure_only=c.get("structure_only", False),
                randaug=c.get("randaug", False))


def _key(case):
    c = CASES[case]
    return _randaug_key() if c.get("randaug") else jax.random.PRNGKey(c["key"])


@pytest.fixture(scope="module")
def jax_side():
    """devo_tpu's trajectories and losses for the three cases, and jax.grad
    of the plain case's loss (remat off: jax.checkpoint changes what the
    backward stores, not its values).

    The initialization and the plain case's value and gradient are
    compiled, as devo_tpu's trainer compiles its step: dispatched op by op
    they take four minutes on the CPU, compiled half that. The two other
    cases run op by op, on the primitives that the first has compiled
    (compiled whole, each would compile its own unrolled graph anew)."""
    voxels, poses, disps, intr = make_inputs()
    net = JNet(**DIMS)
    params = jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(voxels[:1]),
                               jax.random.PRNGKey(1))["params"]
    args = tuple(jnp.asarray(a) for a in (voxels, poses, disps, intr))

    def run(p, key, case):
        kw = _kw(case)
        traj = jfwd.evonet_forward(net, p, *args, key, steps=STEPS,
                                   ppi=PPI, grow_after=GROW,
                                   corr_dropout=DROPOUT, remat=False, **kw)
        out = jtotal(traj, P=3, structure_only=kw["structure_only"])
        return out["loss"], (traj, out)

    out = {}
    (_, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, k: run(p, k, "plain"), has_aux=True))(params, _key("plain"))
    out["plain"] = aux
    for case in ("randaug", "structure_only"):
        out[case] = run(params, _key(case), case)[1]
    return dict(params=params, grads=grads, cases=out,
                inputs=(voxels, poses, disps, intr))


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(jax_side, case, remat=True, grad=False):
    net = EVONet(**DIMS)
    net.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, jax_side["params"])))
    kw = _kw(case)
    args = [torch.from_numpy(np.array(a)) for a in jax_side["inputs"]]
    with torch.set_grad_enabled(grad):
        traj = fwd.evonet_forward(
            net, *args, JaxDraws(_key(case), kw["randaug"]), steps=STEPS,
            ppi=PPI, grow_after=GROW, corr_dropout=DROPOUT, remat=remat,
            structure_only=kw["structure_only"], randaug_on=kw["randaug"])
        out = total_loss(traj, P=3, structure_only=kw["structure_only"])
    if grad:
        out["loss"].backward()
    return net, traj, out


def close(got, want, what, floor=0.0):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=RTOL,
        atol=RTOL * float(np.abs(want).max(initial=0.0)) + floor, err_msg=what)


# ------------------------------------------------------------ edge schedule

@pytest.mark.parametrize("args", [
    dict(n_frames=10, ppi=4, steps=12),                  # test_train.py:35
    dict(n_frames=5, ppi=4, steps=4, grow_after=2),      # test_train.py:51
    dict(n_frames=15, ppi=80, steps=18),                 # the training scale
    dict(n_frames=5, ppi=4, steps=1, grow_after=0),
])
def test_edge_schedule_matches_devo_tpu(args):
    want = jfwd.build_edge_schedule(**args)
    got = fwd.build_edge_schedule(**args)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("ii", "jj", "kk"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.n_active_frames, a.added_frame, a.new_edges) == \
            (b.n_active_frames, b.added_frame, b.new_edges)


# --------------------------------------------------------- forward + loss

@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_and_loss_match_devo_tpu(jax_side, case):
    """Every step's coords, validity, BA weights, poses and edge mask, and
    the loss terms, with devo_tpu's draws."""
    jtraj, jout = jax_side["cases"][case]
    _, traj, out = _port(jax_side, case)
    assert len(traj) == STEPS
    for s, (a, b) in enumerate(zip(traj, jtraj)):
        for k in ("ii", "jj", "kk"):
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["emask"].numpy(), np.asarray(b["emask"]))
        np.testing.assert_array_equal(a["valid"].numpy(), np.asarray(b["valid"]))
        for k in ("coords", "coords_gt", "weight", "Gs", "Ps", "scores"):
            close(a[k], b[k], f"step {s} {k}")
    for k in ("loss", "flow", "pose", "scores"):
        close(out[k], jout[k], k)
    assert bool(torch.isfinite(out["loss"]))


@pytest.fixture(scope="module")
def selector_side():
    """devo_tpu's trajectories and losses (no scorer loss) with the gradient
    and the random selector, whose networks hold no scorer (initialized by
    a compiled init, as jax_side's)."""
    voxels, poses, disps, intr = make_inputs(2)
    args = tuple(jnp.asarray(a) for a in (voxels, poses, disps, intr))
    out = {}
    for sel in ("gradient", "random"):
        net = JNet(patch_selector=sel, **DIMS)
        params = jax.jit(net.init)(jax.random.PRNGKey(0), args[0][:1],
                                   jax.random.PRNGKey(1))["params"]
        traj = jfwd.evonet_forward(net, params, *args, jax.random.PRNGKey(4),
                                   steps=STEPS, ppi=PPI, grow_after=GROW,
                                   corr_dropout=DROPOUT, remat=False)
        out[sel] = (params, traj, jtotal(traj, P=3, use_scorer=False))
    return dict(cases=out, inputs=(voxels, poses, disps, intr))


@pytest.mark.parametrize("selector", ["gradient", "random"])
def test_other_selectors_match_devo_tpu(selector_side, selector):
    """The gradient selector's 3x-random candidates by event gradient and
    the random selector's coordinates, drawn by devo_tpu's keys: the same
    trajectory and loss, with no scores and no scorer loss."""
    params, jtraj, jout = selector_side["cases"][selector]
    net = EVONet(patch_selector=selector, **DIMS)
    net.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params)))
    args = [torch.from_numpy(np.array(a)) for a in selector_side["inputs"]]
    with torch.no_grad():
        traj = fwd.evonet_forward(net, *args, JaxDraws(jax.random.PRNGKey(4)),
                                  steps=STEPS, ppi=PPI, grow_after=GROW,
                                  corr_dropout=DROPOUT)
        out = total_loss(traj, P=3, use_scorer=False)
    for s, (a, b) in enumerate(zip(traj, jtraj)):
        assert a["scores"] is None
        np.testing.assert_array_equal(a["valid"].numpy(), np.asarray(b["valid"]))
        for k in ("coords", "coords_gt", "weight", "Gs"):
            close(a[k], b[k], f"step {s} {k}")
    for k in ("loss", "flow", "pose"):
        close(out[k], jout[k], k)
    assert float(out["scores"]) == 0.0


def test_gradients_match_jax_grad(jax_side):
    """d loss / d every parameter against jax.grad of devo_tpu's loss, the
    plain case, remat on."""
    net, _, _ = _port(jax_side, "plain", remat=True, grad=True)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jax_side["grads"]))
    assert set(want) == {n for n, _ in net.named_parameters()}
    top = max(float(v.abs().max()) for v in want.values())
    for name, p in net.named_parameters():
        assert p.grad is not None, name
        close(p.grad, want[name].numpy(), name, floor=1e-6 * top)


def test_remat_gives_the_same_gradients(jax_side):
    """torch.utils.checkpoint around each step recomputes the step in the
    backward; the keep mask is drawn outside it, so the recompute is the
    forward's: the same loss and gradients (test_train.py:156's
    counterpart, its rtol 1e-5 + atol 1e-6)."""
    grads = {}
    for remat in (True, False):
        net, _, out = _port(jax_side, "randaug", remat=remat, grad=True)
        grads[remat] = (float(out["loss"].detach()),
                        {n: p.grad.clone() for n, p in net.named_parameters()})
    assert grads[True][0] == grads[False][0]
    for name, g in grads[True][1].items():
        np.testing.assert_allclose(g.numpy(), grads[False][1][name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_default_draws_are_seeded():
    """The default draws come from the generator alone: one seed, one
    trajectory; another seed, other candidates."""
    voxels, poses, disps, intr = make_inputs(1)
    torch.manual_seed(0)
    net = EVONet(**DIMS)
    args = [torch.from_numpy(np.array(a)) for a in (voxels, poses, disps, intr)]

    def run(seed):
        with torch.no_grad():
            return fwd.evonet_forward(
                net, *args, Draws(torch.Generator().manual_seed(seed)),
                steps=STEPS, ppi=PPI, grow_after=GROW, randaug_on=True)

    a, b, c = run(4), run(4), run(5)
    assert torch.equal(a[-1]["coords"], b[-1]["coords"])
    assert not torch.equal(a[0]["coords_gt"], c[0]["coords_gt"])
