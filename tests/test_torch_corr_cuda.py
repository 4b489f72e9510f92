"""The correlation kernel (devo_tpu_torch/csrc/corr.cu) against its plain
PyTorch version, on a CUDA device. Every test here skips without one.

This file imports neither jax nor devo_tpu, so it also runs where only the
port is installed:

    python -m pytest --noconftest -q tests/test_torch_corr_cuda.py

Both versions sum f32 products of the same inputs and differ only in the
order of the sums: atol 1e-3, rtol 1e-4 on dots of magnitude ~10.
"""
import numpy as np
import pytest
import torch

from devo_tpu_torch.ops import corr as corr_plain
from devo_tpu_torch.ops import corr_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(dev, dtype, E=300, mem=4, H=32, W=40, C=128, M=16, seed=5):
    """Patch-grid edges whose centers reach 6 px past the image."""
    rng = np.random.default_rng(seed)
    gmap = rng.standard_normal((M, 3, 3, C)).astype(np.float32)
    fmap = rng.standard_normal((mem, H, W, C)).astype(np.float32)
    fmap4 = fmap.reshape(mem, H // 4, 4, W // 4, 4, C).mean((2, 4))
    cx = rng.uniform(-6, W + 6, (E, 1, 1))
    cy = rng.uniform(-6, H + 6, (E, 1, 1))
    off = np.arange(3) - 1
    coords = np.stack([np.broadcast_to(cx + off[None, None, :], (E, 3, 3)),
                       np.broadcast_to(cy + off[None, :, None], (E, 3, 3))],
                      -1).astype(np.float32)
    kk = rng.integers(0, M, E).astype(np.int32)
    jj = rng.integers(0, mem, E).astype(np.int32)

    def on(a, dt=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t.to(dt) if dt is not None else t

    return (on(gmap, dtype), (on(fmap, dtype), on(fmap4, dtype)), on(coords),
            on(kk), on(jj))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("E", [300, 1, 96])
def test_kernel_matches_plain(dev, dtype, E):
    args = _case(dev, dtype, E=E)
    before = corr_cuda.launches
    got = corr_cuda.corr_pyramid(*args)
    torch.cuda.synchronize()
    assert corr_cuda.launches == before + 1
    want = corr_plain.corr_pyramid(*args)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


def test_kernel_off_image_taps_are_zero(dev):
    gmap, pyr, coords, kk, jj = _case(dev, torch.bfloat16, E=64)
    got = corr_cuda.corr_pyramid(gmap, pyr, coords - 400.0, kk, jj)
    assert torch.equal(got, torch.zeros_like(got))


def test_kernel_empty_edge_set_launches_nothing(dev):
    gmap, pyr, coords, kk, jj = _case(dev, torch.bfloat16, E=8)
    before = corr_cuda.launches
    got = corr_cuda.corr_pyramid(gmap, pyr, coords[:0], kk[:0], jj[:0])
    assert got.shape == (0, 2 * 49 * 9) and corr_cuda.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    gmap, pyr, coords, kk, jj = _case(dev, torch.bfloat16, E=8)
    bad = [
        (gmap, pyr, coords, kk.long(), jj),                    # index dtype
        (gmap.float(), pyr, coords, kk, jj),                   # mixed dtypes
        (gmap, pyr, coords.half(), kk, jj),                    # coords dtype
        (gmap, pyr, coords.transpose(1, 2), kk, jj),           # not contiguous
        (gmap, (pyr[0].cpu(), pyr[1]), coords, kk, jj),        # device
    ]
    for args in bad:
        with pytest.raises(ValueError):
            corr_cuda.corr_pyramid(*args)
    with pytest.raises(ValueError):
        corr_cuda.corr_pyramid(gmap, pyr, coords, kk, jj, radius=2)
