"""The three probe kernels (csrc/corr_band_ablate.cu, csrc/copy_probe.cu,
csrc/corr_frame_probe.cu) against their plain versions (ops/probe.py) on
the card, at small sizes: the banded ablation in every mode on its live
block (atol 1e-3 + rtol 1e-4: f32 sums of the same products in another
order), the copy probe in every mode the card holds, on both copy routes
and on 1, 7, 132 and 200 blocks, exactly (integer sums below 2^24), with
its order of the copies against the plain version's bit for bit, and the
one-frame window product with and without extraction (the same tolerance).
Then the window kernels' plan (ops/probe_cuda.window_plan) against their
own shared-memory and occupancy queries in every mode, their bits at two
grids of persistent blocks, the frame product's own count of the windows
it stages, and the ablation's ragged live gate (nlive no
multiple of 64, 0, all edges; E = 0), by their C interfaces
(chip_smoke.c_ablate, c_frame).

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


def _copy_case(dev, mode, slots, mem=4):
    """A ring of `mem` slots and the (slot, row0) of copy_count(mode, 101)
    copies, a number no grid of the tests divides: random slots, all in slot
    0, or all in the last slot that holds the mode's copy."""
    rng = np.random.default_rng(1)
    S, M, _ = probe.copy_plan(mode)
    n = probe.copy_count(mode, 101)
    ring = torch.from_numpy(rng.integers(-127, 127, (mem, 4200, 128)).astype(np.int8)).to(dev)
    slot = {"random": rng.integers(0, mem - (S - 1), n),
            "one slot": np.zeros(n, np.int64),
            "last slot": np.full(n, mem - S)}[slots].astype(np.int32)
    row0 = (rng.integers(0, (4200 - M * 384 - 8) // 8, n) * 8).astype(np.int32)
    return ring, torch.from_numpy(slot).to(dev), torch.from_numpy(row0).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("slots", ["random", "one slot", "last slot"])
@pytest.mark.parametrize("route", probe_cuda.ROUTES)
@pytest.mark.parametrize("mode", [m for m in probe.COPY_MODES if m != "tall8"])
def test_copy_probe_kernel(dev, mode, route, slots):
    """K14'' exactly the plain version's at 1, 7, 132 and 200 blocks (more
    blocks than copies at 132 and 200)."""
    ring, slot, row0 = _copy_case(dev, mode, slots)
    want = probe.copy_probe(ring, slot, row0, mode)
    for blocks in (1, 7, 132, 200):
        assert torch.equal(probe_cuda.copy_probe_cuda(ring, slot, row0, mode, route,
                                                      blocks), want)


@pytest.mark.cuda
@pytest.mark.parametrize("slots", ["random", "one slot", "last slot"])
@pytest.mark.parametrize("n,mem", [(101, 4), (9600, 32), (5000, 128), (0, 32),
                                   (200000, 32), (150000, 128)])
def test_copy_order_kernel(dev, n, mem, slots):
    """The order's scratch (devo_copy_order) is the plain copy_order's sorted
    order bit for bit, and the C interface refuses more ring slots than it
    counts. At 150,000 and 200,000 copies a warp of the order has more
    tiles than it holds in registers, and its second pass reloads them."""
    import chip_smoke
    from devo_tpu_torch.ops import corr_cuda
    rng = np.random.default_rng(n)
    slot = {"random": rng.integers(0, mem, n), "one slot": np.zeros(n, np.int64),
            "last slot": np.full(n, mem - 1)}[slots]
    slot = torch.from_numpy(slot.astype(np.int32)).to(dev)
    got = chip_smoke.c_copy_order(slot, mem)
    assert torch.equal(got, probe.copy_order(slot, "single")[0])
    code = corr_cuda._load().devo_copy_order(slot.data_ptr(), got.data_ptr(), n,
                                             probe_cuda.COPY_ORDER_MEM + 1, None)
    assert code != 0


@pytest.mark.cuda
@pytest.mark.parametrize("extract", [True, False])
def test_frame_probe_kernel(dev, extract):
    from devo_tpu_torch.scripts import bench_gather
    inputs = bench_gather.frame_inputs(np.random.default_rng(0), dev, 1000)
    torch.testing.assert_close(probe_cuda.frame_probe_cuda(*inputs, extract=extract),
                               probe.frame_windows(*inputs, extract=extract), **TOL)


@pytest.mark.cuda
def test_window_plan_matches_the_kernels(dev):
    """The plan's bytes are each kernel's own at the plan's stages, and the
    occupancy query holds WINDOW_BLOCKS blocks an SM in every mode of the
    ablation and for the frame product with and without extraction."""
    from devo_tpu_torch.ops import corr_cuda
    lib = corr_cuda._load()
    depth, smem = probe_cuda.window_plan()
    assert lib.devo_corr_band_ablate_smem(depth) == smem
    for m in range(len(probe.ABLATE_MODES)):
        assert lib.devo_corr_band_ablate_blocks_per_sm(m, depth) >= probe_cuda.WINDOW_BLOCKS
    depth, smem = probe_cuda.window_plan(group=probe_cuda.FRAME_GROUP)
    assert lib.devo_corr_frame_probe_smem(depth) == smem
    for extract in (0, 1):
        assert lib.devo_corr_frame_probe_blocks_per_sm(extract, depth) >= probe_cuda.WINDOW_BLOCKS


@pytest.mark.cuda
@pytest.mark.parametrize("mode", probe.ABLATE_MODES)
def test_band_ablate_same_bits_at_two_grids(dev, mode):
    """Each live row is written by one block with its sums in a fixed order:
    the wrapper's grid, 3 blocks and 1 block give the same bits."""
    import chip_smoke
    args = _ablate_args(dev, E=300)
    args = (torch.tensor([200], dtype=torch.int32, device=dev),) + args[1:]
    depth, _ = probe_cuda.window_plan()
    want = probe_cuda.band_ablate_cuda(*args, mode)[:256]
    for grid in (3, 1):
        assert torch.equal(chip_smoke.c_ablate(None, args, mode, (grid, depth))[:256],
                           want)
    torch.testing.assert_close(want, probe.band_ablate(*args, mode)[:256], **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("extract", [True, False])
def test_frame_probe_same_bits_at_two_grids(dev, extract):
    """Groups of edges that share a window change no bits: 5 blocks and 1,
    on the sorted order and on the edges' own and reversed orders, give the
    wrapper's bits, with windows drawn from 40 origins so that most groups
    hold FRAME_GROUP edges."""
    import chip_smoke
    from devo_tpu_torch.scripts import bench_gather
    inputs = list(bench_gather.frame_inputs(np.random.default_rng(2), dev, 333))
    inputs[2] = inputs[2] % 4                     # y0: 4 x 10 origins
    inputs[3] = inputs[3] % 10
    depth, _ = probe_cuda.window_plan(group=probe_cuda.FRAME_GROUP)
    want = probe_cuda.frame_probe_cuda(*inputs, extract=extract)
    torch.testing.assert_close(want, probe.frame_windows(*inputs, extract=extract),
                               **TOL)
    order = probe_cuda.frame_order(inputs[2], inputs[3], inputs[0].shape[1])
    mine = torch.arange(333, dtype=torch.int32, device=dev)
    for grid, o in ((5, order), (1, order), (7, mine), (7, mine.flip(0))):
        assert torch.equal(chip_smoke.c_frame(None, inputs, extract, (grid, depth), o),
                           want)


@pytest.mark.cuda
@pytest.mark.parametrize("extract", [True, False])
def test_frame_probe_counts_the_windows_it_stages(dev, extract):
    """The kernel's own count of the windows it stages is the grouping
    rule's (chip_smoke.frame_staged) at 5 blocks and 1, on windows drawn
    from 40 origins; without a counter the bits are the same."""
    import chip_smoke
    from devo_tpu_torch.scripts import bench_gather
    inputs = list(bench_gather.frame_inputs(np.random.default_rng(2), dev, 333))
    inputs[2] = inputs[2] % 4
    inputs[3] = inputs[3] % 10
    depth, _ = probe_cuda.window_plan(group=probe_cuda.FRAME_GROUP)
    order = probe_cuda.frame_order(inputs[2], inputs[3], inputs[0].shape[1])
    for grid in (5, 1):
        n = torch.zeros(1, dtype=torch.int64, device=dev)
        got = chip_smoke.c_frame(None, inputs, extract, (grid, depth), order, n)
        assert int(n.item()) == chip_smoke.frame_staged(inputs, probe_cuda.FRAME_GROUP,
                                                        grid)
        assert torch.equal(got, chip_smoke.c_frame(None, inputs, extract,
                                                   (grid, depth), order))


@pytest.mark.cuda
@pytest.mark.parametrize("nlive", [100, 0, 128, 1000])
def test_band_ablate_ragged_live_gate(dev, nlive):
    """nlive no multiple of 64 (rows up to the next multiple computed), none,
    and beyond E = 150: the live gate's rows within TOL of the plain
    version in every mode, the rows past it never written (still NaN)."""
    import chip_smoke
    args = _ablate_args(dev, E=150)
    args = (torch.tensor([nlive], dtype=torch.int32, device=dev),) + args[1:]
    live = min(150, -(-nlive // probe.BE) * probe.BE)
    depth, _ = probe_cuda.window_plan()
    for mode in probe.ABLATE_MODES:
        out = torch.full((150, 8, 16 * probe.PP), float("nan"), device=dev)
        chip_smoke.c_ablate(None, args, mode, (probe_cuda.window_grid(150, dev), depth),
                            out)
        torch.testing.assert_close(out[:live], probe.band_ablate(*args, mode)[:live],
                                   **TOL)
        assert out[live:].isnan().all()


@pytest.mark.cuda
def test_window_kernels_at_no_edges(dev):
    """E = 0: empty results and no launch."""
    from devo_tpu_torch.ops import corr_cuda
    from devo_tpu_torch.scripts import bench_gather
    args = tuple(t[:0] if t.ndim and t.shape[0] == 128 else t
                 for t in _ablate_args(dev))
    inputs = tuple(t[:0] if i else t for i, t in
                   enumerate(bench_gather.frame_inputs(np.random.default_rng(0), dev, 4)))
    before = dict(corr_cuda.launches)
    assert probe_cuda.band_ablate_cuda(*args).shape == (0, 8, 144)
    assert probe_cuda.frame_probe_cuda(*inputs, extract=False).shape == (0, 16, 144)
    assert corr_cuda.launches == before
