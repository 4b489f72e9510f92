"""The correlation kernels (devo_tpu_torch/csrc/*.cu) against their plain
PyTorch versions, on a CUDA device. Every test here skips without one.

This file imports neither jax nor devo_tpu, so it also runs where only the
port is installed:

    python -m pytest --noconftest -q tests/test_torch_corr_cuda.py

A kernel and its plain version sum f32 products of the same inputs and
differ only in the order of the sums: atol 1e-3, rtol 1e-4 on dots of
magnitude ~10.
"""
import numpy as np
import pytest
import torch

from devo_tpu_torch.ops import corr as corr_plain
from devo_tpu_torch.ops import corr_cuda

pytestmark = pytest.mark.cuda

TOL = dict(atol=1e-3, rtol=1e-4)
DTYPES = pytest.mark.parametrize("dtype", ["bf16", "f32", "i8", "f32-i8"])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(dev, dtype, E=300, mem=4, H=32, W=40, C=128, M=16, seed=5,
          jitter=0.0, empty_slot=None):
    """Patch-grid edges whose centers reach 6 px past the image. dtype:
    "bf16" / "f32" = features and rings of that type; "i8" = int8 rings
    with bf16 patch features, "f32-i8" with f32 ones. `jitter` moves every
    pixel of a patch on its own (a distorted patch with a wide window);
    `empty_slot` is a ring slot that no edge points at. Returns (gmap,
    pyramid, coords, kk, jj, scales)."""
    rng = np.random.default_rng(seed)
    gmap = rng.standard_normal((M, 3, 3, C)).astype(np.float32)
    fmap = rng.standard_normal((mem, H, W, C)).astype(np.float32)
    fmap4 = fmap.reshape(mem, H // 4, 4, W // 4, 4, C).mean((2, 4))
    cx = rng.uniform(-6, W + 6, (E, 1, 1))
    cy = rng.uniform(-6, H + 6, (E, 1, 1))
    off = np.arange(3) - 1
    coords = np.stack([np.broadcast_to(cx + off[None, None, :], (E, 3, 3)),
                       np.broadcast_to(cy + off[None, :, None], (E, 3, 3))],
                      -1) + jitter * rng.standard_normal((E, 3, 3, 2))
    # some coordinates exactly on the integer grid, also after / 4
    coords[::7] = np.round(coords[::7] / 4) * 4
    kk = rng.integers(0, M, E).astype(np.int32)
    jj = rng.integers(0, mem, E).astype(np.int32)
    if empty_slot is not None:
        jj[jj == empty_slot] = (empty_slot + 1) % mem

    def on(a, dt=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t.to(dt) if dt is not None else t

    gdt = {"bf16": torch.bfloat16, "i8": torch.bfloat16}.get(dtype, torch.float32)
    if dtype.endswith("i8"):
        pyr, scales = zip(*(corr_plain.quantize_frame(on(fm))
                            for fm in (fmap, fmap4)))
    else:
        pyr, scales = (on(fmap, gdt), on(fmap4, gdt)), None
    return (on(gmap, gdt), pyr, on(coords.astype(np.float32)), on(kk), on(jj),
            scales)


def _level(case, n):
    """The arguments of a per-level function for level n of a case."""
    gmap, pyr, coords, kk, jj, scales = case
    return (gmap, pyr[n], coords / (1, 4)[n], kk, jj,
            None if scales is None else scales[n])


@DTYPES
@pytest.mark.parametrize("E", [300, 1, 96])
def test_kernel_matches_plain(dev, dtype, E):
    *args, scales = _case(dev, dtype, E=E)
    before = corr_cuda.launches["corr_pyramid"]
    got = corr_cuda.corr_pyramid(*args, scales=scales)
    torch.cuda.synchronize()
    assert corr_cuda.launches["corr_pyramid"] == before + 1
    want = corr_plain.corr_pyramid(*args, scales=scales)
    torch.testing.assert_close(got, want, **TOL)


@DTYPES
@pytest.mark.parametrize("E", [300, 1, 96])
@pytest.mark.parametrize("level", [0, 1])
def test_level_kernel_matches_plain(dev, dtype, E, level):
    args = _level(_case(dev, dtype, E=E), level)
    before = corr_cuda.launches["corr_level"]
    got = corr_cuda.corr_level_cuda(*args)
    torch.cuda.synchronize()
    assert corr_cuda.launches["corr_level"] == before + 1
    assert got.shape == (E, 49 * 9)
    torch.testing.assert_close(got, corr_plain.corr_level(*args), **TOL)


@pytest.mark.parametrize("dtype", ["bf16", "i8"])
def test_level_kernel_wide_windows_read_the_ring_directly(dev, dtype):
    """Patches distorted beyond the staged window's capacity (jitter 3 px:
    windows up to ~20x20 vectors) take the direct reads."""
    args = _level(_case(dev, dtype, E=200, jitter=3.0), 0)
    got = corr_cuda.corr_level_cuda(*args)
    torch.testing.assert_close(got, corr_plain.corr_level(*args), **TOL)


def test_level_kernel_narrow_feature_vectors(dev):
    """C = 12 in bf16 is 24 bytes a vector, no multiple of the 16-byte
    copies: nothing is staged."""
    args = _level(_case(dev, "bf16", E=50, C=12), 0)
    got = corr_cuda.corr_level_cuda(*args)
    torch.testing.assert_close(got, corr_plain.corr_level(*args), **TOL)


@pytest.mark.parametrize("dtype", ["i8", "f32-i8"])
@pytest.mark.parametrize("E", [300, 1, 96])
def test_resident_kernel_matches_plain(dev, dtype, E):
    args = _level(_case(dev, dtype, E=E), 1)
    before = corr_cuda.launches["corr_level_resident"]
    got = corr_cuda.corr_level_resident_cuda(*args)
    torch.cuda.synchronize()
    assert corr_cuda.launches["corr_level_resident"] == before + 1
    torch.testing.assert_close(got, corr_plain.corr_level(*args), **TOL)


def test_resident_kernel_full_size_frame_and_an_empty_slot(dev):
    """A 30x40x128 frame (the level-4 ring of a 480x640 input: 150 KB of a
    block's shared memory), 32 slots of which slot 5 has no edge; edges of
    one slot are scattered over the table."""
    case = _case(dev, "i8", E=2000, mem=32, H=120, W=160, empty_slot=5)
    args = _level(case, 1)
    assert not (args[4] == 5).any()
    got = corr_cuda.corr_level_resident_cuda(*args)
    torch.testing.assert_close(got, corr_plain.corr_level(*args), **TOL)


def test_resident_kernel_takes_int8_rings_only(dev):
    with pytest.raises(ValueError):
        corr_cuda.corr_level_resident_cuda(*_level(_case(dev, "bf16", E=8), 1))
    gmap, pyr, coords, kk, jj, scales = _case(dev, "i8", E=8)
    big = torch.zeros((4, 45, 80, 128), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):          # beyond a block's shared memory
        corr_cuda.corr_level_resident_cuda(gmap, big, coords, kk, jj, scales[1])


@pytest.mark.parametrize("dtype,resident", [
    ("bf16", False), ("f32", False), ("i8", False), ("i8", True),
    ("f32-i8", True)])
def test_split_kernels_stacked_match_the_two_level_kernel(dev, dtype, resident):
    """The per-level kernels get coords / lvl from PyTorch, the two-level
    kernel divides in-kernel: both must floor the same values, also where a
    coordinate sits on an integer after the division."""
    *args, scales = _case(dev, dtype, E=300)
    corr_cuda.reset_launches()
    mono = corr_cuda.corr_pyramid(*args, scales=scales, kernel="mono")
    split = corr_cuda.corr_pyramid(*args, scales=scales, kernel="split",
                                   resident=resident)
    assert corr_cuda.launches == {
        "corr_pyramid": 1, "corr_level": 1 if resident else 2,
        "corr_level_resident": int(resident), "corr_pair": 0, "corr_pair2": 0}
    torch.testing.assert_close(split, mono, **TOL)


PAIR = pytest.mark.parametrize("kernel", ["pair", "pair2"])


@PAIR
@DTYPES
@pytest.mark.parametrize("E", [0, 1, 96, 5003])
def test_pair_kernels_match_plain_and_the_two_level_kernel(dev, kernel, dtype, E):
    """corr_pair and corr_pair2 against the plain version and against
    corr_pyramid's kernel, which divides the coordinates as they do: also
    where a coordinate sits on an integer after the division by 4, on edges
    that share ring slots and patches (16 patches, 4 slots), at an E that
    is no multiple of anything, and at E = 0 (an empty result, no launch)."""
    *args, scales = _case(dev, dtype, E=E)
    name = "corr_" + kernel
    before = corr_cuda.launches[name]
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel)
    torch.cuda.synchronize()
    assert corr_cuda.launches[name] == before + (E > 0)
    assert got.shape == (E, 2 * 49 * 9) and got.dtype == torch.float32
    want = corr_plain.corr_pyramid(*args, scales=scales)
    torch.testing.assert_close(got, want, **TOL)
    mono = corr_cuda.corr_pyramid(*args, scales=scales, kernel="mono")
    torch.testing.assert_close(got, mono, **TOL)


@PAIR
@pytest.mark.parametrize("dtype", ["bf16", "i8"])
def test_pair_kernels_wide_windows_read_the_ring_directly(dev, kernel, dtype):
    """Patches distorted beyond the staged window's capacity (jitter 3 px at
    level 1: windows up to ~20x20 vectors) read that level's taps from the
    ring while the other level's window is still staged."""
    *args, scales = _case(dev, dtype, E=200, jitter=3.0)
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel)
    want = corr_plain.corr_pyramid(*args, scales=scales)
    torch.testing.assert_close(got, want, **TOL)


@PAIR
@pytest.mark.parametrize("dtype,C", [("bf16", 12), ("i8", 8), ("i8", 32),
                                     ("f32", 4)])
def test_pair_kernels_narrow_feature_vectors(dev, kernel, dtype, C):
    """C = 12 in bf16 (24 bytes a vector) and C = 8 in int8 (8 bytes) are no
    multiple of the 16-byte copies: nothing is staged, every tap reads the
    ring. C = 32 in int8 and C = 4 in f32 are staged at the narrowest."""
    *args, scales = _case(dev, dtype, E=150, C=C)
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel)
    want = corr_plain.corr_pyramid(*args, scales=scales)
    torch.testing.assert_close(got, want, **TOL)


@PAIR
def test_pair_kernels_full_size_rings(dev, kernel):
    """The slice's rings (32 slots of 120x160 and 30x40, C = 128) at more
    edges than the persistent grid has blocks."""
    *args, scales = _case(dev, "i8", E=3000, mem=32, H=120, W=160)
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel)
    want = corr_plain.corr_pyramid(*args, scales=scales)
    torch.testing.assert_close(got, want, **TOL)


def test_pair2_occupancy_query(dev):
    assert corr_cuda.pair2_blocks_per_sm(3, 128, torch.bfloat16, torch.int8) >= 1
    assert corr_cuda.pair2_blocks_per_sm(3, 128, torch.bfloat16,
                                         torch.bfloat16) >= 1


@DTYPES
def test_kernel_off_image_taps_are_zero(dev, dtype):
    gmap, pyr, coords, kk, jj, scales = _case(dev, dtype, E=64)
    for kernel, resident in (("mono", False), ("split", False),
                             ("split", dtype.endswith("i8")),
                             ("pair", False), ("pair2", False)):
        got = corr_cuda.corr_pyramid(gmap, pyr, coords - 400.0, kk, jj,
                                     scales=scales, kernel=kernel,
                                     resident=resident)
        assert torch.equal(got, torch.zeros_like(got))


def test_kernel_empty_edge_set_launches_nothing(dev):
    gmap, pyr, coords, kk, jj, scales = _case(dev, "i8", E=8)
    corr_cuda.reset_launches()
    for kernel, resident in (("mono", False), ("split", False), ("split", True),
                             ("pair", False), ("pair2", False)):
        got = corr_cuda.corr_pyramid(gmap, pyr, coords[:0], kk[:0], jj[:0],
                                     scales=scales, kernel=kernel,
                                     resident=resident)
        assert got.shape == (0, 2 * 49 * 9)
    assert not any(corr_cuda.launches.values())


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    gmap, pyr, coords, kk, jj, _ = _case(dev, "bf16", E=8)
    *_, scales = _case(dev, "i8", E=8)
    bad = [
        (gmap, pyr, coords, kk.long(), jj),                    # index dtype
        (gmap.float(), pyr, coords, kk, jj),                   # mixed dtypes
        (gmap, pyr, coords.half(), kk, jj),                    # coords dtype
        (gmap, (pyr[0].cpu(), pyr[1]), coords, kk, jj),        # device
        (gmap, (pyr[0].transpose(1, 2), pyr[1]), coords, kk, jj),  # strides
    ]
    for args in bad:
        for kernel in corr_cuda.KERNELS:
            with pytest.raises(ValueError):
                corr_cuda.corr_pyramid(*args, kernel=kernel)
    with pytest.raises(ValueError):          # coords not contiguous
        corr_cuda.corr_pyramid(gmap, pyr, coords.transpose(1, 2), kk, jj)
    with pytest.raises(ValueError):
        corr_cuda.corr_pyramid(gmap, pyr, coords, kk, jj, radius=2)
    with pytest.raises(ValueError):          # scales with float rings
        corr_cuda.corr_pyramid(gmap, pyr, coords, kk, jj, scales=scales)
    for kernel in ("pair", "pair2"):         # copies need aligned coords
        with pytest.raises(ValueError):
            corr_cuda.corr_pyramid(gmap, pyr, coords.flatten()[2:-16].view(
                -1, 3, 3, 2), kk[:-1], jj[:-1], kernel=kernel)
