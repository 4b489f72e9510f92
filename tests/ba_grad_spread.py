"""How far the differentiable BA step's f32 gradients lie from their float64
truth, the port's (ops/ba.gauss_newton_step_diff) beside devo_tpu's
(jax.grad of gauss_newton_step(depth_clamp="training")), on the scene of
tests/test_torch_train_pieces.py::test_differentiable_ba_matches_jax_grad
with its edges in their own order and in `--orders` random orders, and
with the port's accumulations changed one at a time (`--variants`).

    JAX_PLATFORMS=cpu python tests/ba_grad_spread.py [--seed 0] [--orders 12]
        [--variants]

The truth is the port's step in float64 (devo_tpu's step cannot run under
jax_enable_x64). Each line gives, for target, weight, poses and patches,
the largest gap from the truth relative to the tensor's largest entry;
the last lines the medians and maxima over the orders. Not a test: a
measurement that pytest does not collect.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from devo_tpu.ops import ba as jba  # noqa: E402
from devo_tpu_torch.ops import ba, segment  # noqa: E402
from test_torch_train_pieces import _ba_inputs, _idx, _t  # noqa: E402

NAMES = ("target", "weight", "poses", "patches")


def gaps(seed: int, order=None):
    """((port f32, jax f32) gap from the truth of each gradient)."""
    s = _ba_inputs(seed)
    n, M = s["n"], s["M"]
    rng = np.random.default_rng(10 + seed)
    A = rng.standard_normal((n, 7)).astype(np.float32)
    B = rng.standard_normal(s["patches"].shape).astype(np.float32)
    if order is not None:
        for k in ("ii", "jj", "kk", "target", "mask", "weight"):
            s[k] = np.asarray(s[k])[order]
    bounds = np.asarray([-64.0, -64.0, 224.0, 184.0], np.float32)
    kw = dict(window=n - 1, patch_slots=M, max_residual=250.0, ep=10.0,
              lm=1e-4, structure_only=False)

    def jloss(target, weight, poses, patches):
        p, q = jba.gauss_newton_step(
            poses, patches, jnp.asarray(s["intr"]), target, weight,
            jnp.float32(1e-4), jnp.asarray(s["ii"]), jnp.asarray(s["jj"]),
            jnp.asarray(s["kk"]), jnp.asarray(s["mask"]), t0=jnp.int32(1),
            t1=jnp.int32(n), kbase=jnp.int32(0), bounds=jnp.asarray(bounds),
            depth_clamp="training", **kw)[:2]
        return jnp.sum(p * A) + jnp.sum(q * B)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(s[k]) for k in NAMES))

    def port(dtype):
        args = [_t(s[k]).to(dtype).requires_grad_(True) for k in NAMES]
        p, q, _ = ba.gauss_newton_step_diff(
            args[2], args[3], _t(s["intr"]).to(dtype), args[0], args[1], 1e-4,
            _idx(s["ii"]), _idx(s["jj"]), _idx(s["kk"]), _t(s["mask"]), t0=1,
            t1=n, kbase=0, bounds=_t(bounds).to(dtype), **kw)
        ((p * _t(A).to(dtype)).sum() + (q * _t(B).to(dtype)).sum()).backward()
        return [a.grad.double().numpy() for a in args]

    truth, got = port(torch.float64), port(torch.float32)
    out = []
    for g, j, t in zip(got, jg, truth):
        top = np.abs(t).max()
        out.append((np.abs(g - t).max() / top,
                    np.abs(np.asarray(j, np.float64) - t).max() / top))
    return np.asarray(out)


def _f64_segment_sums():
    """The port with its patch sums (segment.segment_sum) in float64."""
    plain = segment.segment_sum
    segment.segment_sum = lambda v, seg: plain(v.double(), seg).to(v.dtype)
    return lambda: setattr(segment, "segment_sum", plain)


def _triangular_solves():
    """The port with the Schur system solved by two triangular solves, as
    devo_tpu solves it, in place of cholesky_solve."""
    plain = ba.schur_solve

    def solve(sys_, lmbda, ep, lm, structure_only=False):
        B, E, C, v, u = sys_
        Q = 1.0 / (C + lmbda)
        EQ = E * Q[None, :]
        S = B - EQ @ E.T
        y = v - EQ @ u
        S = S + torch.diag(ep + lm * torch.diagonal(S))
        L, info = torch.linalg.cholesky_ex(S)
        z = torch.linalg.solve_triangular(L, y[:, None], upper=False)
        dX = torch.linalg.solve_triangular(L.T, z, upper=True)[:, 0]
        dZ = ba._finite_or_zero(Q * (u - E.T @ dX))
        return dX.reshape(-1, 6), dZ, info == 0

    ba.schur_solve = solve
    return lambda: setattr(ba, "schur_solve", plain)


def _line(label, g):
    return label + "  " + "  ".join(
        f"{n} port {p:.2e} jax {j:.2e}" for n, (p, j) in zip(NAMES, g))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--orders", type=int, default=12)
    ap.add_argument("--variants", action="store_true")
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    rows = [gaps(a.seed)]
    print(_line(f"seed {a.seed}, the test's order", rows[0]), flush=True)
    E = len(_ba_inputs(a.seed)["ii"])
    for k in range(a.orders):
        order = np.random.default_rng(100 + k).permutation(E)
        rows.append(gaps(a.seed, order))
        print(_line(f"seed {a.seed}, order {k}", rows[-1]), flush=True)
    R = np.stack(rows)
    print(_line("median over the orders", np.median(R, 0)))
    print(_line("max over the orders", R.max(0)))
    if a.variants:
        for label, change in (("patch sums in f64", _f64_segment_sums),
                              ("triangular solves", _triangular_solves)):
            undo = change()
            try:
                print(_line(f"seed {a.seed}, {label}", gaps(a.seed)))
            finally:
                undo()


if __name__ == "__main__":
    main()
