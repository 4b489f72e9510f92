"""The three probe kernels (csrc/corr_band_ablate.cu, csrc/copy_probe.cu,
csrc/corr_frame_probe.cu) against their plain versions (ops/probe.py) on
the card, at small sizes: the banded ablation in every mode on its live
block (atol 1e-3 + rtol 1e-4: f32 sums of the same products in another
order), the copy probe in every mode the card holds, on both copy routes
and on 1, 3 and 200 blocks, exactly (integer sums below 2^24), and the
one-frame window product with and without extraction (the same tolerance).

Marked `cuda`: they skip without a GPU. On the H100 (no jax there):
`python -m pytest --noconftest -q tests/test_torch_probe_cuda.py`.
"""
import numpy as np
import pytest
import torch

from devo_tpu_torch.ops import probe, probe_cuda

TOL = dict(atol=1e-3, rtol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probe kernels run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ablate_args(dev, E=128):
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)

    def ints(hi, shape):
        return torch.from_numpy(rng.integers(0, hi, shape).astype(np.int32)).to(dev)

    ring = (torch.randn((3, 2, 24, 24, 128), generator=g, device=dev) * 0.1).bfloat16()
    gm = (torch.randn((E, 16, 128), generator=g, device=dev) * 0.1).bfloat16()
    nlive = torch.tensor([64], dtype=torch.int32, device=dev)
    return (nlive, ints(3, E), ints(2, E), ints(8, E), gm, ints(8, (E, 16)),
            ints(3, (E, 16)), ring)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", probe.ABLATE_MODES)
def test_band_ablate_kernel(dev, mode):
    args = _ablate_args(dev)
    got = probe_cuda.band_ablate_cuda(*args, mode)[:64]
    torch.testing.assert_close(got, probe.band_ablate(*args, mode)[:64], **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("route", probe_cuda.ROUTES)
@pytest.mark.parametrize("mode", [m for m in probe.COPY_MODES if m != "tall8"])
def test_copy_probe_kernel(dev, mode, route):
    rng = np.random.default_rng(1)
    S, M, _ = probe.copy_plan(mode)
    n = probe.copy_count(mode, 96)
    ring = torch.from_numpy(rng.integers(-127, 127, (4, 4200, 128)).astype(np.int8)).to(dev)
    slot = torch.from_numpy(rng.integers(0, 4 - (S - 1), n).astype(np.int32)).to(dev)
    row0 = torch.from_numpy((rng.integers(0, (4200 - M * 384 - 8) // 8, n) * 8)
                            .astype(np.int32)).to(dev)
    want = probe.copy_probe(ring, slot, row0, mode)
    for blocks in (1, 3, 200):
        assert torch.equal(probe_cuda.copy_probe_cuda(ring, slot, row0, mode, route,
                                                      blocks), want)


@pytest.mark.cuda
@pytest.mark.parametrize("extract", [True, False])
def test_frame_probe_kernel(dev, extract):
    from devo_tpu_torch.scripts import bench_gather
    inputs = bench_gather.frame_inputs(np.random.default_rng(0), dev, 1000)
    torch.testing.assert_close(probe_cuda.frame_probe_cuda(*inputs, extract=extract),
                               probe.frame_windows(*inputs, extract=extract), **TOL)
