"""The port's segment sums in a fixed order (devo_tpu_torch/ops/segment.py),
which replace `index_add_` in bundle adjustment and in the SoftAgg segment
softmax so that two runs on the card give the same bits.

On the CPU `index_add_` was already deterministic: these tests show that the
new sums compute what the old ones did (the sorted sums against
`index_add_` and against the JAX package's `jax.ops.segment_sum`, atol 1e-6
on f32 sums of ~50 terms of magnitude ~1; the one-hot product within an f32
rounding of float64 sums), that BA's system is the float64 sums' within 1e-6 of their largest
entry, and the old f32 assembly's within that one's own rounding (4e-6 of
the largest entry: its blocks sum ~1000 rows in f32), and that the
port's engine repeats itself bitwise over a run, as tests/test_determinism.py
holds devo_tpu. The proof on the card, where `index_add_` adds through
atomics, is chip_smoke.py's determinism phase: BA's system at E = 12288
assembled twice, and the full-width i8-mono and bf16-gather paths run twice,
compared as bytes.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from devo_tpu_torch.ops import ba, segment
from devo_tpu_torch.ops.graph import segment_softmax_sum


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("width", [(), (6,), (6, 6), (384,)])
@pytest.mark.parametrize("num_segments", [1, 17, 300])
def test_segment_sum_matches_index_add_and_jax(num_segments, width):
    rng = np.random.default_rng(num_segments + len(width))
    N = 800
    values = rng.standard_normal((N,) + width).astype(np.float32)
    ids = rng.integers(0, num_segments, N)
    ids[:5] = num_segments - 1                      # some segments stay empty
    got = segment.segment_sum(torch.from_numpy(values),
                              segment.segments(torch.from_numpy(ids), num_segments))
    want = torch.zeros((num_segments,) + width).index_add_(
        0, torch.from_numpy(ids), torch.from_numpy(values))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    jx = jax.ops.segment_sum(jnp.asarray(values), jnp.asarray(ids), num_segments)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx), atol=1e-6)
    # the one-hot product sums in f64 and rounds once: within an f32 ulp of
    # the float64 sums
    exact = np.zeros((num_segments,) + width)
    np.add.at(exact, ids, values.astype(np.float64))
    dense = segment.dense_segment_sum(torch.from_numpy(values),
                                      torch.from_numpy(ids), num_segments)
    np.testing.assert_allclose(dense.numpy(), exact, rtol=1.2e-7, atol=1e-30)


def test_segment_sum_keeps_row_order_and_takes_no_rows():
    """A segment's rows are added in their order in `values` (a stable
    sort): the sum of [1e8, 1, -1e8] in f32 is 0, of [1e8, -1e8, 1] 1."""
    v = torch.tensor([1e8, 1.0, 2.0, -1e8, 1e8, -1e8, 1.0])
    ids = torch.tensor([0, 0, 1, 0, 2, 2, 2])
    got = segment.segment_sum(v, segment.segments(ids, 3))
    assert got.tolist() == [0.0, 2.0, 1.0]
    empty = segment.segment_sum(torch.zeros((0, 4)),
                                segment.segments(torch.zeros(0, dtype=torch.long), 5))
    assert empty.shape == (5, 4) and not empty.any()


def _assemble_index_add(Ji, Jj, Jz, r, w, li, lj, pk, n, m):
    """BA's system as ops/ba.assemble summed it before, by index_add_, in
    the inputs' type."""
    mi = (li >= 0)[:, None].to(w.dtype)
    mj = (lj >= 0)[:, None].to(w.dtype)
    wi, wj, wij = w * mi, w * mj, w * mi * mj
    li, lj = li.clamp(0, n - 1), lj.clamp(0, n - 1)

    def outer(wt, A, B):
        return torch.einsum("er,eri,erj->eij", wt, A, B)

    z = dict(dtype=w.dtype)
    Hij = outer(wij, Ji, Jj)
    B = torch.zeros((n * n, 6, 6), **z)
    B.index_add_(0, li * n + li, outer(wi, Ji, Ji))
    B.index_add_(0, li * n + lj, Hij)
    B.index_add_(0, lj * n + li, Hij.transpose(1, 2))
    B.index_add_(0, lj * n + lj, outer(wj, Jj, Jj))
    B = B.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
    v = torch.zeros((n, 6), **z)
    v.index_add_(0, li, torch.einsum("er,eri->ei", wi * r, Ji))
    v.index_add_(0, lj, torch.einsum("er,eri->ei", wj * r, Jj))
    Eb = torch.zeros((n * m, 6), **z)
    Eb.index_add_(0, li * m + pk, torch.einsum("er,eri->ei", wi * Jz, Ji))
    Eb.index_add_(0, lj * m + pk, torch.einsum("er,eri->ei", wj * Jz, Jj))
    E = Eb.reshape(n, m, 6).permute(0, 2, 1).reshape(6 * n, m)
    C = torch.zeros(m, **z).index_add_(0, pk, (w * Jz * Jz).sum(-1))
    u = torch.zeros(m, **z).index_add_(0, pk, (w * Jz * r).sum(-1))
    return ba.BASystem(B, E, C, v.reshape(-1), u)


def test_ba_system_matches_the_index_add_assembly():
    rng = np.random.default_rng(3)
    E, n, m = 3000, 6, 150

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    args = (t(E, 2, 6), t(E, 2, 6), t(E, 2), t(E, 2),
            torch.from_numpy(rng.random((E, 2)).astype(np.float32)),
            torch.from_numpy(rng.integers(-1, n, E)),
            torch.from_numpy(rng.integers(-1, n, E)),
            torch.from_numpy(rng.integers(0, m, E)))
    got = ba.assemble(*args, n, m)
    exact = _assemble_index_add(*(a.double() if a.is_floating_point() else a
                                  for a in args), n, m)
    old = _assemble_index_add(*args, n, m)
    for name, a, x, o in zip(got._fields, got, exact, old):
        a, x, o = a.numpy(), x.numpy(), o.numpy()
        scale = np.abs(x).max()
        # the new sums: f64 products rounded once (B, v), or f32 sums of a
        # few rows each (E, C, u): within 1e-6 of the largest entry of the
        # float64 sums
        np.testing.assert_allclose(a, x, rtol=1e-6, atol=1e-6 * scale,
                                   err_msg=name)
        # the old ones: f32 sums over up to ~1000 rows, whose rounding
        # reaches ~2e-6 of the largest entry
        np.testing.assert_allclose(a, o, rtol=1e-6, atol=4e-6 * scale,
                                   err_msg=name)


def test_segment_softmax_sum_matches_index_add():
    rng = np.random.default_rng(4)
    E, C, S = 500, 8, 40
    values = torch.from_numpy(rng.standard_normal((E, C)).astype(np.float32))
    logits = torch.from_numpy(rng.standard_normal((E, C)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, S, E))
    mask = torch.from_numpy(rng.random(E) < 0.8)
    got = segment_softmax_sum(values, logits, seg, S, mask)
    # the same with index_add_ sums
    s = torch.where(mask, seg, torch.full_like(seg, S))
    mx = torch.full((S + 1, C), -1e30).scatter_reduce(
        0, s[:, None].expand(E, C), logits, "amax", include_self=True)
    ex = torch.exp(logits - mx[s]) * mask[:, None]
    den = torch.zeros((S + 1, C)).index_add_(0, s, ex)
    w = ex / den[s].clamp_min(1e-30)
    want = torch.zeros((S + 1, C)).index_add_(0, s, values * w)[s]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_engine_two_runs_bitwise_identical():
    """The port's DEVO at the CPU tests' small size, random weights and the
    random patch selection, twice from the same seed: the edge table, the
    patches, the keyframe poses and terminate()'s output bitwise equal."""
    from devo_tpu_torch.bench import frames
    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.runtime.config import VOConfig
    from devo_tpu_torch.runtime.engine import DEVO
    from devo_tpu_torch.utils.params import random_state_dict

    cfg = VOConfig(BUFFER_SIZE=64, PATCHES_PER_FRAME=4, PATCH_LIFETIME=5,
                   REMOVAL_WINDOW=9, OPTIMIZATION_WINDOW=4, MEM=16,
                   DIM_INET=32, DIM_FNET=16, DIM=8, MIXED_PRECISION=False,
                   MOTION_PROBE_THRESH=-1.0, HT=64, WD=64)
    weights = random_state_dict(
        EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET, cfg.DIM, cfg.BINS), seed=0)
    intr = np.asarray([80.0, 80.0, 32.0, 32.0], np.float32)

    def run():
        slam = DEVO(cfg, weights, ht=64, wd=64, seed=0, device="cpu")
        for i, vox in enumerate(frames(14, 64, 64)):
            slam(i / 30.0, vox, intr)
        state = [getattr(slam, k).numpy().copy()
                 for k in ("ii", "jj", "kk", "patches", "poses")]
        return state + list(slam.terminate())

    a, b = run(), run()
    assert a[0].size > 0
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.tobytes() == y.tobytes()
