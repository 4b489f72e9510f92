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


# --- csrc/corr.cu: blocks that walk runs of edges ---------------------------


@DTYPES
@pytest.mark.parametrize("E", [1, 7, 131, 133, 265, 12289])
def test_mono_kernel_runs_of_edges(dev, dtype, E):
    """The blocks of csrc/corr.cu walk runs of mono_run's length: one edge,
    fewer edges than blocks, just more edges than one a block, and E no
    multiple of the run (the last block's run is short)."""
    *args, scales = _case(dev, dtype, E=E, mem=8)
    run = corr_cuda.mono_run(E, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert run * -(-E // run) >= E and -(-E // run) <= sms
    got = corr_cuda.corr_pyramid(*args, scales=scales)
    torch.testing.assert_close(
        got, corr_plain.corr_pyramid(*args, scales=scales), **TOL)


REPEATED = pytest.mark.parametrize("order", ["kk runs", "jj runs",
                                             "one patch", "one frame"])


def _repeated_case(dev, dtype, order):
    """Consecutive edges of one patch (the engine's edge table holds runs of
    one kk) or one ring slot, or a launch on a single patch or slot."""
    gmap, pyr, coords, kk, jj, scales = _case(dev, dtype, E=1500)
    n = torch.arange(1500, device=dev, dtype=torch.int32)
    if order == "kk runs":
        kk = (n // 9 % gmap.shape[0]).to(torch.int32)
    elif order == "jj runs":
        jj = (n // 50 % pyr[0].shape[0]).to(torch.int32)
    elif order == "one patch":
        kk = torch.full_like(kk, 3)
    else:
        jj = torch.full_like(jj, 1)
    return gmap, pyr, coords, kk, jj, scales


@DTYPES
@REPEATED
def test_mono_kernel_repeated_patches_and_frames(dev, dtype, order):
    """Edges that repeat their patch or ring slot (_repeated_case): the
    ring's stages then hold the same data several times."""
    *args, scales = _repeated_case(dev, dtype, order)
    got = corr_cuda.corr_pyramid(*args, scales=scales)
    torch.testing.assert_close(
        got, corr_plain.corr_pyramid(*args, scales=scales), **TOL)


@DTYPES
def test_mono_kernel_two_launches_are_bitwise_equal(dev, dtype):
    """No atomics and sums in a fixed order: the same inputs give the same
    bits, with staged windows and (jitter 1 px: some windows beyond the
    cap) direct reads in one launch."""
    *args, scales = _case(dev, dtype, E=5003, mem=8, jitter=1.0)
    first = corr_cuda.corr_pyramid(*args, scales=scales)
    second = corr_cuda.corr_pyramid(*args, scales=scales)
    assert torch.equal(first, second)


@DTYPES
def test_mono_kernel_wide_windows(dev, dtype):
    """Patches distorted beyond the staged window (jitter 3 px: level-1
    windows up to ~20x20 vectors) take that level's taps from the ring."""
    *args, scales = _case(dev, dtype, E=400, jitter=3.0)
    got = corr_cuda.corr_pyramid(*args, scales=scales)
    torch.testing.assert_close(
        got, corr_plain.corr_pyramid(*args, scales=scales), **TOL)


@DTYPES
@pytest.mark.parametrize("C", [4, 8, 12, 40])
def test_mono_kernel_narrow_feature_vectors(dev, dtype, C):
    """C below one chunk of 32 channels or not a multiple of it: the
    tensor-core instances stage the vectors by 4-, 8- or 16-byte copies and
    zeros to the chunk's end; the f32 instances stage vectors of 16 bytes
    and read the others from the ring."""
    *args, scales = _case(dev, dtype, E=300, C=C)
    got = corr_cuda.corr_pyramid(*args, scales=scales)
    torch.testing.assert_close(
        got, corr_plain.corr_pyramid(*args, scales=scales), **TOL)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_fixed_kernel_two_launches_are_bitwise_equal(dev, dtype):
    args = _level(_case(dev, dtype, E=3001, jitter=1.0), 0)
    assert torch.equal(corr_cuda.corr_fixed_cuda(*args),
                       corr_cuda.corr_fixed_cuda(*args))


def test_mono_and_fixed_plans_match_the_kernels(dev):
    """The wrappers' shared-memory sums are the kernels' own, and one SM
    holds as many blocks as the plans count on."""
    lib = corr_cuda._load()
    bf, i8, f32 = torch.bfloat16, torch.int8, torch.float32
    for gdt, rdt in ((bf, bf), (bf, i8), (f32, f32), (f32, i8)):
        for C in (8, 32, 128):
            cap, depth, blocks = corr_cuda.mono_plan(3, C, gdt, rdt)
            assert lib.devo_corr_pyramid_smem(
                9, C, cap, depth, int(gdt == bf), int(rdt == i8)) == (
                corr_cuda.mono_smem_bytes(3, C, gdt, rdt, cap, depth))
            assert corr_cuda.mono_blocks_per_sm(3, C, gdt, rdt) >= blocks
    for dt in (bf, f32):
        for C in (8, 32, 128):
            assert lib.devo_corr_fixed_smem(9, C, int(dt == bf)) == (
                corr_cuda.fixed_smem_bytes(3, C, dt))
            want = corr_cuda.fixed_plan(3, C, dt)[1] if dt == bf else 1
            assert corr_cuda.fixed_blocks_per_sm(3, C, dt) >= want


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
    assert {k: v for k, v in corr_cuda.launches.items() if v} == {
        "corr_pyramid": 1, "corr_level": 1 if resident else 2,
        **({"corr_level_resident": 1} if resident else {})}
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


@DTYPES
@pytest.mark.parametrize("E", [96, 5003, 12288])
def test_pair_kernel_at_the_step_sizes(dev, dtype, E):
    """corr_pair (corr_pyramid's pipeline and plan) at the motion
    probe's E, a ragged E and the step's E on the slice's rings (32 slots of
    120x160 and 30x40): the plain version within TOL, K1's bits, one
    launch."""
    *args, scales = _case(dev, dtype, E=E, mem=32, H=120, W=160)
    before = corr_cuda.launches["corr_pair"]
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel="pair")
    torch.cuda.synchronize()
    assert corr_cuda.launches["corr_pair"] == before + 1
    torch.testing.assert_close(got, corr_plain.corr_pyramid(*args, scales=scales),
                               **TOL)
    mono = corr_cuda.corr_pyramid(*args, scales=scales, kernel="mono")
    assert torch.equal(got, mono)


@DTYPES
def test_pair_kernel_one_level_staged_the_other_from_the_ring(dev, dtype):
    """Distorted patches (jitter 3 px) over runs of many edges: in one step
    a level-1 window beyond the cap reads its taps from the ring while the
    level-4 window is staged, and the other way round."""
    *args, scales = _case(dev, dtype, E=4000, mem=8, jitter=3.0)
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel="pair")
    torch.testing.assert_close(got, corr_plain.corr_pyramid(*args, scales=scales),
                               **TOL)


def test_pair2_occupancy_query(dev):
    """The SMs hold as many corr_pair2 blocks at once as pair2_plan sized the
    windows for: one at C = 128 (full windows), two at C = 32; the
    persistent grid is the SMs times the query's count, at most E."""
    bf, i8 = torch.bfloat16, torch.int8
    assert corr_cuda.pair2_plan(3, 32, bf, i8)[2] == 2
    assert corr_cuda.pair2_blocks_per_sm(3, 32, bf, i8) >= 2
    for ring in (i8, bf):
        blocks = corr_cuda.pair2_blocks_per_sm(3, 128, bf, ring)
        assert blocks >= corr_cuda.pair2_plan(3, 128, bf, ring)[2]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert corr_cuda.pair2_grid(12288, sms, blocks) == sms * blocks
        assert corr_cuda.pair2_grid(7, sms, blocks) == 7


@DTYPES
def test_kernel_off_image_taps_are_zero(dev, dtype):
    gmap, pyr, coords, kk, jj, scales = _case(dev, dtype, E=64)
    for kernel, resident in (("mono", False), ("split", False),
                             ("split", dtype.endswith("i8")),
                             ("pair", False), ("pair2", False),
                             ("split2", False), ("split2", dtype.endswith("i8")),
                             ("g8c", False), ("mono2", False), ("mono4", False),
                             ("mono3", False)):
        got = corr_cuda.corr_pyramid(gmap, pyr, coords - 400.0, kk, jj,
                                     scales=scales, kernel=kernel,
                                     resident=resident)
        assert torch.equal(got, torch.zeros_like(got))


def test_kernel_empty_edge_set_launches_nothing(dev):
    gmap, pyr, coords, kk, jj, scales = _case(dev, "i8", E=8)
    corr_cuda.reset_launches()
    for kernel, resident in (("mono", False), ("split", False), ("split", True),
                             ("pair", False), ("pair2", False),
                             ("split2", False), ("g8c", True), ("mono2", False),
                             ("mono4", False), ("mono3", False)):
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
    for kernel in ("pair", "pair2", "mono2", "mono4", "mono3"):
        with pytest.raises(ValueError):      # copies need aligned coords
            corr_cuda.corr_pyramid(gmap, pyr, coords.flatten()[2:-16].view(
                -1, 3, 3, 2), kk[:-1], jj[:-1], kernel=kernel)


# --- the kernels "split2", "g8c", "mono2" / "mono4" and "mono3" -------------

NEW_TWO_LEVEL = pytest.mark.parametrize("kernel", ["mono2", "mono4", "mono3"])
COUNTER = {"mono2": "corr_mono2", "mono4": "corr_mono2", "mono3": "corr_mono3",
           "split2": "corr_level_pipe", "g8c": "corr_group"}


@NEW_TWO_LEVEL
@DTYPES
@pytest.mark.parametrize("E", [0, 1, 96, 97, 5003])
def test_mono_variants_match_plain_and_the_two_level_kernel(dev, kernel, dtype, E):
    """corr_mono2 (both flags) and corr_mono3 against the plain version and
    against corr_pyramid's kernel, which divides the coordinates as they do:
    also where a coordinate sits on an integer after the division by 4, on
    edges that share ring slots and patches, at an odd E (corr_mono2's last
    block has one edge) and at E = 0 (an empty result, no launch)."""
    *args, scales = _case(dev, dtype, E=E)
    before = dict(corr_cuda.launches)
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel)
    torch.cuda.synchronize()
    assert corr_cuda.launches == {
        **before, COUNTER[kernel]: before[COUNTER[kernel]] + (E > 0)}
    assert got.shape == (E, 2 * 49 * 9) and got.dtype == torch.float32
    want = corr_plain.corr_pyramid(*args, scales=scales)
    torch.testing.assert_close(got, want, **TOL)
    mono = corr_cuda.corr_pyramid(*args, scales=scales, kernel="mono")
    torch.testing.assert_close(got, mono, **TOL)


@DTYPES
@pytest.mark.parametrize("E", [0, 1, 96, 5003, 12288])
@pytest.mark.parametrize("level", [0, 1])
def test_level_pipe_kernel_matches_plain_and_the_level_kernel(dev, dtype, E, level):
    """corr_level_pipe (K7'', the edge pipeline at group_plan) on the four
    (patch feature, ring) type pairs, int8 rings with their slots' scales:
    the plain corr_level and corr_level's kernel, one launch, none at E = 0."""
    args = _level(_case(dev, dtype, E=E), level)
    before = corr_cuda.launches["corr_level_pipe"]
    got = corr_cuda.corr_level_pipe_cuda(*args)
    torch.cuda.synchronize()
    assert corr_cuda.launches["corr_level_pipe"] == before + (E > 0)
    assert got.shape == (E, 49 * 9)
    torch.testing.assert_close(got, corr_plain.corr_level(*args), **TOL)
    torch.testing.assert_close(got, corr_cuda.corr_level_cuda(*args), **TOL)


@DTYPES
@pytest.mark.parametrize("C,jitter", [(8, 0.0), (128, 3.0)])
def test_level_pipe_kernel_narrow_and_distorted(dev, dtype, C, jitter):
    """corr_level_pipe at C = 8 (an int8 vector of 8 bytes: f32 patch
    features stage nothing and read every tap from the ring, bf16 ones
    stage it as the tensor cores' rows) and on patches distorted beyond the
    staged window's cap (jitter 3 px), at both levels."""
    case = _case(dev, dtype, E=1001, C=C, jitter=jitter)
    if jitter:
        wide = corr_plain._group_index(case[2], corr_plain.GROUP_ROWS)[-1]
        assert int(wide.sum()) > 20
    for level in (0, 1):
        args = _level(case, level)
        got = corr_cuda.corr_level_pipe_cuda(*args)
        torch.testing.assert_close(got, corr_plain.corr_level(*args), **TOL)


def _group_tolerances(args):
    """(atol against corr_level_group, atol against corr_level) for the
    grouped correlation of one level. The kernel and its plain version round
    the same f32 sums to bf16; where the order of a sum moves it across a
    rounding boundary the two land one bf16 ulp apart, at most 2^-7 of the
    largest product, and the blend is a convex combination of taps, so that
    is also the bound on an output. Against the unrounded corr_level every
    tap is off by at most half an ulp, 2^-8 of its size. Both in output
    units: times the largest ring scale."""
    gmap, fmap, coords, kk, jj, scale = args
    surface = corr_plain.group_surface(gmap, fmap, coords, kk, jj)
    top = surface.float().abs().max().item() if surface.numel() else 0.0
    top *= 1.0 if scale is None else scale.max().item()
    return 2.0 ** -7 * top + 1e-6, 2.0 ** -8 * top + 1e-3


@DTYPES
@pytest.mark.parametrize("E", [0, 1, 96, 99, 5003])
@pytest.mark.parametrize("level", [0, 1])
def test_group_kernel_matches_its_plain_version(dev, dtype, E, level):
    """corr_group (one launch: the products, their rounding to bf16 and the
    blend) against corr_level_group, which rounds at the same place,
    and against corr_level within the bf16 budget; E = 99 leaves the last
    group with three edges."""
    args = _level(_case(dev, dtype, E=E), level)
    before = corr_cuda.launches["corr_group"]
    got = corr_cuda.corr_group_cuda(*args)
    torch.cuda.synchronize()
    assert corr_cuda.launches["corr_group"] == before + (E > 0)
    assert got.shape == (E, 49 * 9) and got.dtype == torch.float32
    ulp, budget = _group_tolerances(args)
    torch.testing.assert_close(got, corr_plain.corr_level_group(*args),
                               atol=ulp, rtol=0)
    torch.testing.assert_close(got, corr_plain.corr_level(*args), atol=budget,
                               rtol=0)
    # the kernel's own rounding is rare: most outputs agree to f32 noise
    if E >= 96:
        close = (got - corr_plain.corr_level_group(*args)).abs() <= 1e-3
        assert close.float().mean().item() > 0.98


@pytest.mark.parametrize("kernel", ["split2", "g8c", "mono2", "mono4", "mono3"])
@pytest.mark.parametrize("dtype", ["bf16", "i8"])
def test_new_kernels_wide_windows(dev, kernel, dtype):
    """Patches distorted beyond the staged window's capacity (jitter 3 px at
    level 1: windows up to ~20x20 vectors): the tap kernels read that
    level's taps from the ring, and corr_group keeps the edge's taps in its
    surface rows instead of its window, so that nothing is clipped."""
    *args, scales = _case(dev, dtype, E=200, jitter=3.0)
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel)
    if kernel == "g8c":
        wide = corr_plain._group_index(args[2], corr_plain.GROUP_ROWS)[-1]
        assert 20 < int(wide.sum()) < 200
        for n in (0, 1):
            lvl = _level((*args, scales), n)
            ulp, budget = _group_tolerances(lvl)
            torch.testing.assert_close(
                got.view(200, -1, 2)[..., n], corr_plain.corr_level_group(*lvl),
                atol=ulp, rtol=0)
            torch.testing.assert_close(
                got.view(200, -1, 2)[..., n], corr_plain.corr_level(*lvl),
                atol=budget, rtol=0)
    else:
        want = corr_plain.corr_pyramid(*args, scales=scales)
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("kernel", ["split2", "g8c", "mono2", "mono4", "mono3"])
@pytest.mark.parametrize("dtype,C", [("bf16", 12), ("i8", 8), ("i8", 32),
                                     ("f32", 4), ("bf16", 8)])
def test_new_kernels_narrow_feature_vectors(dev, kernel, dtype, C):
    """C = 12 in bf16 (24 bytes a vector) and C = 8 in int8 (8 bytes) are no
    multiple of the 16-byte copies: nothing is staged, every tap reads the
    ring (corr_group keeps taps in its rows). C = 32 in int8, C = 8 in bf16
    and C = 4 in f32 are staged at the narrowest."""
    *args, scales = _case(dev, dtype, E=150, C=C)
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel)
    want = corr_plain.corr_pyramid(*args, scales=scales)
    if kernel == "g8c":
        top = want.abs().max().item()
        torch.testing.assert_close(got, want, atol=2.0 ** -7 * top, rtol=0)
    else:
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("kernel", ["split2", "g8c", "mono2", "mono4", "mono3"])
def test_new_kernels_full_size_rings(dev, kernel):
    """The bench's rings (32 slots of 120x160 and 30x40, C = 128) at more
    edges than a persistent grid has blocks and several runs of 64."""
    *args, scales = _case(dev, "i8", E=3001, mem=32, H=120, W=160)
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel)
    want = corr_plain.corr_pyramid(*args, scales=scales)
    if kernel == "g8c":
        top = want.abs().max().item()
        torch.testing.assert_close(got, want, atol=2.0 ** -7 * top, rtol=0)
    else:
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("kernel", ["split2", "g8c"])
def test_new_per_level_kernels_with_the_resident_level(dev, kernel):
    """A per-level kernel hands its last level to the resident-ring kernel
    under `resident`: one launch each."""
    *args, scales = _case(dev, "i8", E=300)
    corr_cuda.reset_launches()
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel,
                                 resident=True)
    assert {k: v for k, v in corr_cuda.launches.items() if v} == {
        COUNTER[kernel]: 1, "corr_level_resident": 1}
    want = corr_plain.corr_pyramid(*args, scales=scales)
    if kernel == "g8c":
        top = want.abs().max().item()
        torch.testing.assert_close(got, want, atol=2.0 ** -7 * top, rtol=0)
    else:
        torch.testing.assert_close(got, want, **TOL)


def _surface_rows(coords, cap):
    """(ceil(E / 8), GROUP_ROWS, 128) bool: the rows and lanes that
    corr_group's surface instance writes (an edge's window positions, or its
    64 taps where the window exceeds cap; lanes 16 j .. 16 j + 15)."""
    _, y0, _, _, ww, wide = corr_plain._group_index(coords, cap)
    wh = y0.amax(1, keepdim=True) - y0.amin(1, keepdim=True) + 8
    n_rows = torch.where(wide, torch.full_like(ww, 64), ww * wh)[:, 0]
    E = coords.shape[0]
    G = -(-E // 8)
    rows = torch.arange(corr_plain.GROUP_ROWS, device=coords.device)
    mask = torch.zeros((G * 8, corr_plain.GROUP_ROWS), dtype=torch.bool,
                       device=coords.device)
    mask[:E] = rows[None, :] < n_rows[:, None]
    return (mask.reshape(G, 8, -1, 1).expand(G, 8, corr_plain.GROUP_ROWS, 16)
            .transpose(1, 2).reshape(G, corr_plain.GROUP_ROWS, 128))


@pytest.mark.parametrize("dtype", ["bf16", "i8", "f32"])
@pytest.mark.parametrize("E", [0, 99, 5003])
@pytest.mark.parametrize("jitter", [0.0, 3.0])
def test_group_surface_instance_matches_group_surface(dev, dtype, E, jitter):
    """The surface instance writes the TPU kernel's own output: on the rows
    and lanes it writes, ops/corr.group_surface at the same cap within one
    bf16 ulp (a sum in another order may round the other way), zero
    elsewhere; one launch of its own counter and none of corr_group's."""
    args = _level(_case(dev, dtype, E=E, jitter=jitter), 0)
    before = dict(corr_cuda.launches)
    surface, cap = corr_cuda.group_surface_cuda(*args)
    torch.cuda.synchronize()
    assert corr_cuda.launches == {
        **before, "corr_group_surface": before["corr_group_surface"] + (E > 0)}
    want = corr_plain.group_surface(*args[:5], cap=cap)
    assert surface.shape == want.shape and surface.dtype == torch.bfloat16
    if E == 0:
        return
    mask = _surface_rows(args[2], cap)
    got, ref = surface.float(), want.float()
    assert torch.equal(got[~mask], torch.zeros_like(got[~mask]))
    top = ref[mask].abs().max().item()
    torch.testing.assert_close(got[mask], ref[mask], atol=2.0 ** -7 * top,
                               rtol=0)
    assert (got[mask] == ref[mask]).float().mean().item() > 0.98


def test_group_kernel_is_one_launch_without_stage_2(dev):
    """CORR_KERNEL="g8c" on the card: one launch a level, and the tensor-code
    stage 2 (ops/corr.extract_blend_group) is never called."""
    *args, scales = _case(dev, "i8", E=300)
    corr_cuda.reset_launches()
    calls = corr_plain.extract_calls
    corr_cuda.corr_pyramid(*args, scales=scales, kernel="g8c")
    assert {k: v for k, v in corr_cuda.launches.items() if v} == {
        "corr_group": 2}
    assert corr_plain.extract_calls == calls


@pytest.mark.parametrize("kernel", ["g8c", "mono2", "mono4", "mono3", "pair2",
                                    "pair", "split2"])
@pytest.mark.parametrize("dtype", ["bf16", "i8", "f32"])
def test_pipeline_kernels_two_launches_are_bitwise_equal(dev, kernel, dtype):
    """corr_group, corr_mono2, corr_mono3, corr_pair2, corr_pair and
    corr_level_pipe sum in a fixed order: the same inputs give the same bits, staged windows and ring
    reads (jitter 1 px) in one launch."""
    *args, scales = _case(dev, dtype, E=5003, mem=8, jitter=1.0)
    first = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel)
    second = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel)
    assert torch.equal(first, second)


@DTYPES
@pytest.mark.parametrize("E", [2, 131, 265, 12289])
def test_mono2_kernel_runs_of_pairs(dev, dtype, E):
    """corr_mono2's blocks walk runs of mono2_run's length (whole pairs)
    over its pipelines: fewer pairs than blocks, just more, and a run cut
    short by E; gathered and in place."""
    *args, scales = _case(dev, dtype, E=E, mem=8)
    run = corr_cuda.mono2_run(E, dev)
    assert run % 2 == 0 and run * -(-E // run) >= E
    want = corr_plain.corr_pyramid(*args, scales=scales)
    for kernel in ("mono2", "mono4"):
        got = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel)
        torch.testing.assert_close(got, want, **TOL)


def test_pipeline_plans_match_the_kernels(dev):
    """corr_pair's, corr_group's, corr_group8's, corr_level_pipe's,
    corr_level's, corr_level_full's, corr_mono2's, corr_mono3's and
    corr_pair2's shared-memory sums are the kernels' own, and one SM
    holds as many blocks as the plans count on."""
    lib = corr_cuda._load()
    bf, i8, f32 = torch.bfloat16, torch.int8, torch.float32
    for gdt, rdt in ((bf, bf), (bf, i8), (f32, f32), (f32, i8)):
        flags = (int(gdt == bf), int(rdt == i8))
        for C in (8, 32, 128):
            cap, depth, blocks = corr_cuda.mono_plan(3, C, gdt, rdt)
            assert lib.devo_corr_pair_smem(9, C, cap, depth, *flags) == (
                corr_cuda.mono_smem_bytes(3, C, gdt, rdt, cap, depth))
            assert corr_cuda.mono_blocks_per_sm(3, C, gdt, rdt,
                                                "corr_pair") >= blocks
            if gdt == rdt:
                cap, depth, blocks = corr_cuda.group_plan(3, C, gdt, rdt)
                assert lib.devo_corr_group8_smem(9, C, cap, depth, flags[0]) == (
                    corr_cuda.group_smem_bytes(3, C, gdt, rdt, cap, depth))
                assert corr_cuda.group_blocks_per_sm(3, C, gdt, rdt,
                                                     "corr_group8") >= blocks
            cap, depth, blocks = corr_cuda.group_plan(3, C, gdt, rdt)
            assert lib.devo_corr_group_smem(9, C, cap, depth, *flags) == (
                corr_cuda.group_smem_bytes(3, C, gdt, rdt, cap, depth))
            assert corr_cuda.group_blocks_per_sm(3, C, gdt, rdt) >= blocks
            assert lib.devo_corr_level_pipe_smem(9, C, cap, depth, *flags) == (
                corr_cuda.group_smem_bytes(3, C, gdt, rdt, cap, depth))
            assert corr_cuda.group_blocks_per_sm(3, C, gdt, rdt,
                                                 "corr_level_pipe") >= blocks
            assert lib.devo_corr_level_smem(9, C, cap, depth, *flags) == (
                corr_cuda.group_smem_bytes(3, C, gdt, rdt, cap, depth))
            assert corr_cuda.group_blocks_per_sm(3, C, gdt, rdt,
                                                 "corr_level") >= blocks
            if gdt == rdt:
                for d in (2, corr_cuda.FULL_MAX_DEPTH):
                    assert lib.devo_corr_level_full_smem(9, C, cap, d,
                                                         flags[0]) == (
                        corr_cuda.group_smem_bytes(3, C, gdt, rdt, cap, d))
                assert corr_cuda.group_blocks_per_sm(
                    3, C, gdt, rdt, "corr_level_full") >= blocks
            cap, depth, pipes = corr_cuda.mono2_plan(3, C, gdt, rdt)
            assert lib.devo_corr_mono2_smem(9, C, cap, depth, pipes, *flags) == (
                corr_cuda.mono2_smem_bytes(3, C, gdt, rdt, cap, depth, pipes))
            assert corr_cuda.mono2_blocks_per_sm(3, C, gdt, rdt) >= 1
            cap, depth = corr_cuda.mono3_plan(3, C, gdt, rdt)
            assert lib.devo_corr_mono3_smem(9, C, cap, depth, *flags) == (
                corr_cuda.mono3_smem_bytes(3, C, gdt, rdt, cap, depth))
            assert corr_cuda.mono3_blocks_per_sm(3, C, gdt, rdt) >= 1
            cap, depth, blocks = corr_cuda.pair2_plan(3, C, gdt, rdt)
            assert lib.devo_corr_pair2_smem(9, C, cap, depth, *flags) == (
                corr_cuda.pair2_smem_bytes(3, C, gdt, rdt, cap, depth))
            assert corr_cuda.pair2_blocks_per_sm(3, C, gdt, rdt) >= blocks


def test_new_kernels_occupancy_and_plans(dev):
    bf, i8 = torch.bfloat16, torch.int8
    for ring in (i8, bf):
        assert corr_cuda.group_blocks_per_sm(3, 128, bf, ring,
                                             "corr_level_pipe") >= 2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for E in (1, 96, 5003, 12288, 42432):
        run = corr_cuda.mono3_run(E, sms)
        blocks = -(-E // run)
        assert 1 <= run <= corr_cuda.MONO3_RUN
        # whole rounds over the SMs, the last one nearly full
        assert blocks <= sms * -(-blocks // sms) and run * blocks >= E
        assert E < sms or blocks % sms == 0 or blocks % sms > sms * 0.9


# --- the one-barrier instances of the edge pipeline: "mono3", "pair2" ------

ROTATING = pytest.mark.parametrize("kernel", ["mono3", "pair2"])


@ROTATING
@DTYPES
@pytest.mark.parametrize("E", [1, 7, 131, 133, 265, 12289])
def test_rotating_kernels_runs_and_strides(dev, kernel, dtype, E):
    """corr_mono3's blocks walk runs of mono3_run's length, corr_pair2's
    blocks every grid-th edge of pair2_grid's persistent grid: one edge,
    fewer edges than blocks, just more, and an E that neither the run nor
    the grid divides (the last run is short, the last blocks take one edge
    fewer)."""
    *args, scales = _case(dev, dtype, E=E, mem=8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if E == 12289:
        gdt, rdt = args[0].dtype, args[1][0].dtype
        step = (corr_cuda.mono3_run(E, sms) if kernel == "mono3" else
                corr_cuda.pair2_grid(E, sms, corr_cuda.pair2_blocks_per_sm(
                    3, 128, gdt, rdt)))
        assert E % step != 0
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel)
    torch.testing.assert_close(
        got, corr_plain.corr_pyramid(*args, scales=scales), **TOL)


@ROTATING
@DTYPES
@REPEATED
def test_rotating_kernels_repeated_patches_and_frames(dev, kernel, dtype, order):
    """Edges that repeat their patch or ring slot (_repeated_case): the ring's
    stages and both surface slots then hold the same data."""
    *args, scales = _repeated_case(dev, dtype, order)
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel)
    torch.testing.assert_close(
        got, corr_plain.corr_pyramid(*args, scales=scales), **TOL)


@ROTATING
@DTYPES
def test_rotating_kernels_wide_windows(dev, kernel, dtype):
    """Patches distorted beyond the staged window (jitter 3 px: level-1
    windows up to ~20x20 vectors) take that level's taps from the ring into
    the step's surface slot."""
    *args, scales = _case(dev, dtype, E=400, jitter=3.0)
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel)
    torch.testing.assert_close(
        got, corr_plain.corr_pyramid(*args, scales=scales), **TOL)


@ROTATING
@DTYPES
@pytest.mark.parametrize("C", [4, 8, 12, 40])
def test_rotating_kernels_narrow_feature_vectors(dev, kernel, dtype, C):
    """C below one chunk of 32 channels or not a multiple of it, as
    test_mono_kernel_narrow_feature_vectors."""
    *args, scales = _case(dev, dtype, E=300, C=C)
    got = corr_cuda.corr_pyramid(*args, scales=scales, kernel=kernel)
    torch.testing.assert_close(
        got, corr_plain.corr_pyramid(*args, scales=scales), **TOL)


# --- CORR_IMPL="pallas" and the kernels "g8" and "full" ---------------------

FLOAT_LEVEL = {"corr_fixed": corr_cuda.corr_fixed_cuda,
               "corr_group8": corr_cuda.corr_group8_cuda,
               "corr_level_full": corr_cuda.corr_level_full_cuda}
FLOAT_KERNELS = pytest.mark.parametrize("name", list(FLOAT_LEVEL))
FLOAT_DTYPES = pytest.mark.parametrize("dtype", ["bf16", "f32"])


@FLOAT_KERNELS
@FLOAT_DTYPES
@pytest.mark.parametrize("E", [0, 96, 5003, 12288])
@pytest.mark.parametrize("level", [0, 1])
def test_float_level_kernels_match_plain(dev, name, dtype, E, level):
    """corr_fixed, corr_group8 and corr_level_full compute corr_level: at the
    motion probe's E, a ragged E (corr_group8's last group has three edges)
    and the step's E, on edges that share ring slots and patches, with
    coordinates partly off the image and on the integer grid; E = 0 is an
    empty result and no launch."""
    args = _level(_case(dev, dtype, E=E), level)
    before = dict(corr_cuda.launches)
    got = FLOAT_LEVEL[name](*args)
    torch.cuda.synchronize()
    assert corr_cuda.launches == {**before, name: before[name] + (E > 0)}
    assert got.shape == (E, 49 * 9) and got.dtype == torch.float32
    torch.testing.assert_close(got, corr_plain.corr_level(*args), **TOL)


@FLOAT_KERNELS
@FLOAT_DTYPES
def test_float_level_kernels_distorted_patches(dev, name, dtype):
    """Patches distorted beyond the staged window (jitter 3 px: covering
    windows up to ~20x20 vectors) and beyond corr_fixed's 16x24 window:
    corr_group8 and corr_level_full read such an edge's taps from the ring,
    corr_fixed such a pixel's; nothing is clipped."""
    args = _level(_case(dev, dtype, E=400, jitter=3.0), 0)
    wide = corr_plain._group_index(args[2], corr_plain.GROUP_ROWS)[-1]
    assert 20 < int(wide.sum()) < 400
    got = FLOAT_LEVEL[name](*args)
    torch.testing.assert_close(got, corr_plain.corr_level(*args), **TOL)


@FLOAT_KERNELS
@pytest.mark.parametrize("dtype,C", [("bf16", 8), ("bf16", 12), ("f32", 8),
                                     ("f32", 4)])
def test_float_level_kernels_narrow_feature_vectors(dev, name, dtype, C):
    """C = 8 in bf16 and f32 and C = 4 in f32 are staged at the narrowest;
    C = 12 in bf16 (24 bytes a vector) is no multiple of the 16-byte copies,
    so nothing is staged and every tap reads the ring."""
    for level in (0, 1):
        args = _level(_case(dev, dtype, E=501, C=C), level)
        got = FLOAT_LEVEL[name](*args)
        torch.testing.assert_close(got, corr_plain.corr_level(*args), **TOL)


@FLOAT_KERNELS
def test_float_level_kernels_full_size_rings(dev, name):
    """The slice's rings (32 slots of 120x160 and 30x40, C = 128) at more
    edges than corr_level_full's grid has blocks."""
    case = _case(dev, "bf16", E=3001, mem=32, H=120, W=160)
    for level in (0, 1):
        args = _level(case, level)
        got = FLOAT_LEVEL[name](*args)
        torch.testing.assert_close(got, corr_plain.corr_level(*args), **TOL)


@FLOAT_DTYPES
def test_group8_kernel_two_launches_are_bitwise_equal(dev, dtype):
    """corr_group8 sums in a fixed order: the same bits twice, staged
    windows and ring reads (jitter 1 px) in one launch, both levels."""
    for level in (0, 1):
        args = _level(_case(dev, dtype, E=5003, mem=8, jitter=1.0), level)
        assert torch.equal(corr_cuda.corr_group8_cuda(*args),
                           corr_cuda.corr_group8_cuda(*args))


@pytest.mark.parametrize("level", [0, 1])
def test_group8_taps_are_exact_where_group_rounds_them(dev, level):
    """corr_group8 (K9'') and corr_group (K8'') are one pipeline shape apart
    by the rounding alone: on bf16 rings at the step's E corr_group8 holds
    to corr_level within TOL, and corr_group, whose taps are rounded to
    bf16, does not, but holds to corr_level_group."""
    args = _level(_case(dev, "bf16", E=12288, mem=32, H=120, W=160), level)
    want = corr_plain.corr_level(*args)
    exact = corr_cuda.corr_group8_cuda(*args)
    torch.testing.assert_close(exact, want, **TOL)
    rounded = corr_cuda.corr_group_cuda(*args)
    assert not torch.allclose(rounded, want, **TOL)
    rounded_want = corr_plain.corr_level_group(*args)
    torch.testing.assert_close(
        rounded, rounded_want,
        atol=2.0 ** -7 * rounded_want.abs().max().item() + TOL["atol"],
        rtol=TOL["rtol"])


@pytest.mark.parametrize("kernel,name,launches_an_update", [
    ("pair", "corr_pair", 1), ("g8", "corr_group8", 2),
    ("split2", "corr_level_pipe", 2), ("full", "corr_level_full", 2)])
def test_engine_configurations_launch_their_kernel(dev, kernel, name,
                                                   launches_an_update):
    """The engine's "pair", "g8", "split2" and "full" configurations on bf16
    rings, at 64x64 and narrow widths with random weights: every correlation
    of the run is a launch of the configuration's kernel (one an update for
    "pair", one a level for the others), no other kernel is launched and no
    plain correlation is called."""
    from devo_tpu_torch import bench
    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.runtime.config import VOConfig
    from devo_tpu_torch.runtime.engine import DEVO
    from devo_tpu_torch.utils.params import random_state_dict
    cfg = VOConfig(BUFFER_SIZE=64, PATCHES_PER_FRAME=4, PATCH_LIFETIME=5,
                   REMOVAL_WINDOW=9, OPTIMIZATION_WINDOW=4, MEM=16,
                   DIM_INET=32, DIM_FNET=16, DIM=8, MOTION_PROBE_THRESH=-1.0,
                   CORR_RING_I8=False, CORR_KERNEL=kernel)
    weights = random_state_dict(EVONet(cfg.P, cfg.DIM_INET, cfg.DIM_FNET,
                                       cfg.DIM, cfg.BINS), seed=0)
    slam = DEVO(cfg, weights, ht=64, wd=64, seed=0, device=dev)
    corr_cuda.reset_launches()
    calls = corr_plain.calls
    for i, vox in enumerate(bench.frames(16, 64, 64)):
        slam(i / 30.0, vox, bench.intrinsics(64, 64))
    torch.cuda.synchronize()
    launched = {k: v for k, v in corr_cuda.launches.items() if v}
    assert set(launched) == {name} and corr_plain.calls == calls
    assert launched[name] >= launches_an_update
    assert launched[name] % launches_an_update == 0


@FLOAT_KERNELS
def test_float_level_kernels_take_float_rings_only(dev, name):
    with pytest.raises(ValueError):
        FLOAT_LEVEL[name](*_level(_case(dev, "i8", E=8), 0))


@pytest.mark.parametrize("stage", ["noext", "nomm", "noDMA"])
@FLOAT_DTYPES
@pytest.mark.parametrize("E,jitter", [(96, 0.0), (5003, 0.0), (400, 3.0)])
def test_full_kernel_stages_match_their_plain_versions(dev, stage, dtype, E,
                                                       jitter):
    """The stage instances of csrc/corr_level_full.cu against
    ops/corr.corr_level_stage at the window capacity the wrapper launches
    with: on staged windows and, with jitter 3 px, on edges whose windows
    are not staged."""
    args = _level(_case(dev, dtype, E=E, jitter=jitter), 0)
    cap = corr_cuda.full_knobs(3, 128, args[1].dtype)[0]
    got = corr_cuda.corr_level_full_cuda(*args, stage=stage)
    want = corr_plain.corr_level_stage(*args[:5], stage, cap)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (E, 49 * 9)
    torch.testing.assert_close(got, want, **TOL)
    if stage != "nomm":
        # what the stage skips shows: it is not the correlation
        assert not torch.allclose(got, corr_plain.corr_level(*args), **TOL)
    with pytest.raises(ValueError):
        corr_cuda.corr_level_full_cuda(*args, stage="nodma")


@pytest.mark.parametrize("impl,kernel,name", [
    ("pallas", "mono", "corr_fixed"), ("banded", "g8", "corr_group8"),
    ("banded", "full", "corr_level_full")])
@FLOAT_DTYPES
def test_entry_point_takes_the_new_kernels(dev, impl, kernel, name, dtype):
    """The engine's entry point: one launch a level of the configuration's
    kernel and no other, the plain two-level function, off-image taps zero,
    and E = 0 an empty result without a launch."""
    *args, _ = _case(dev, dtype, E=300)
    corr_cuda.reset_launches()
    got = corr_cuda.corr_pyramid(*args, kernel=kernel, impl=impl)
    torch.cuda.synchronize()
    assert {k: v for k, v in corr_cuda.launches.items() if v} == {name: 2}
    torch.testing.assert_close(got, corr_plain.corr_pyramid(*args), **TOL)
    gmap, pyr, coords, kk, jj = args
    off = corr_cuda.corr_pyramid(gmap, pyr, coords - 400.0, kk, jj,
                                 kernel=kernel, impl=impl)
    assert torch.equal(off, torch.zeros_like(off))
    corr_cuda.reset_launches()
    empty = corr_cuda.corr_pyramid(gmap, pyr, coords[:0], kk[:0], jj[:0],
                                   kernel=kernel, impl=impl)
    assert empty.shape == (0, 2 * 49 * 9) and not any(corr_cuda.launches.values())


@pytest.mark.parametrize("impl", ["window", "gather"])
def test_tensor_paths_on_the_card_launch_no_kernel(dev, impl):
    """CORR_IMPL="window" and "gather" are tensor code on the card: no
    kernel launch, no plain-correlation call, their own counter; on bf16
    features their functions differ from corr_pyramid as on the CPU."""
    *args, _ = _case(dev, "bf16", E=300)
    corr_cuda.reset_launches()
    calls = (corr_plain.calls, corr_plain.window_calls, corr_plain.gather_calls)
    got = corr_cuda.corr_pyramid(*args, impl=impl)
    torch.cuda.synchronize()
    assert not any(corr_cuda.launches.values())
    assert (corr_plain.calls, corr_plain.window_calls,
            corr_plain.gather_calls) == (
        calls[0], calls[1] + (impl == "window"), calls[2] + (impl == "gather"))
    cpu = [a.cpu() for a in args[:1]] + [tuple(r.cpu() for r in args[1])] + [
        a.cpu() for a in args[2:]]
    want = corr_cuda.corr_pyramid(*cpu, impl=impl)
    torch.testing.assert_close(got.cpu(), want, **TOL)


def test_new_kernel_plans(dev):
    """corr_level_full (full_knobs) and corr_group8 at corr_group's plan:
    two blocks an SM of two stages (one a pipeline) of full windows on bf16
    rings, one block on f32 rings, and bf16 rows of 12 channels staged in
    chunks of 32; the occupancy query holds as many blocks as planned, and a
    ring of four stages takes an SM alone. The runs of group_run cover every
    edge in one round over the blocks the SMs hold."""
    bf, f32 = torch.bfloat16, torch.float32
    assert corr_cuda.full_knobs(3, 128, bf) == (144, 2, 2)
    assert corr_cuda.full_knobs(3, 128, f32) == (144, 2, 1)
    assert corr_cuda.full_knobs(3, 12, bf)[0] == 144
    assert corr_cuda.group_plan(3, 128, bf, bf) == (144, 2, 2)
    assert corr_cuda.group_plan(3, 128, f32, f32) == (144, 2, 1)
    assert corr_cuda.group_plan(3, 12, bf, bf)[0] == 144
    for ring, blocks in ((bf, 2), (f32, 1)):
        for name in ("corr_level_full", "corr_group8"):
            assert corr_cuda.group_blocks_per_sm(3, 128, ring, ring,
                                                 name) >= blocks
    lib = corr_cuda._load()
    smem = corr_cuda.group_smem_bytes(3, 128, bf, bf, 144, 4)
    assert lib.devo_corr_level_full_smem(9, 128, 144, 4, 1) == smem
    assert corr_cuda._occupancy("corr_level_full",
                                lib.devo_corr_level_full_blocks_per_sm(
                                    9, 128, 144, 4, 1, 0)) == 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for E in (1, 96, 5003, 12288):
        run = corr_cuda.group_run(E, dev, 2)
        assert run * sms * 2 >= E and (run - 1) * sms * 2 < E


@pytest.mark.parametrize("stage", ["full", "noext", "nomm", "noDMA"])
@FLOAT_DTYPES
def test_full_kernel_two_launches_are_bitwise_equal(dev, stage, dtype):
    """corr_level_full and its stage instances sum in a fixed order: the
    same bits twice, staged windows and ring reads (jitter 1 px) in one
    launch, both levels, and at a ring of four stages and short runs."""
    for level in (0, 1):
        args = _level(_case(dev, dtype, E=5003, mem=8, jitter=1.0), level)
        first = corr_cuda.corr_level_full_cuda(*args, stage=stage)
        assert torch.equal(first,
                           corr_cuda.corr_level_full_cuda(*args, stage=stage))
        if dtype == "bf16":
            tuned = corr_cuda.corr_level_full_cuda(*args, stage=stage,
                                                   depth=4, run=5)
            torch.testing.assert_close(tuned, first, **TOL)


# --- csrc/corr_level.cu (K6''): the edge pipeline's one-level instance ------


@DTYPES
@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("jitter", [0.0, 3.0])
def test_level_kernel_gives_the_level_pipe_bits(dev, dtype, level, jitter):
    """corr_level (K6'') is corr_level_pipe's (K7'') instance at the same
    plan: its output is K7'''s bits on the four type pairs, staged windows
    and windows beyond the cap alike, and the same bits twice."""
    args = _level(_case(dev, dtype, E=5003, jitter=jitter), level)
    got = corr_cuda.corr_level_cuda(*args)
    assert torch.equal(got, corr_cuda.corr_level_pipe_cuda(*args))
    assert torch.equal(got, corr_cuda.corr_level_cuda(*args))


def _case4(dev, dtype, E=700, mem=4, H=32, W=40, C=128, seed=9):
    """4x4 patches (16 pixels, the most the kernels take) on the rings of
    _case, with its indices and scales."""
    rng = np.random.default_rng(seed)
    gmap, pyr, _, kk, jj, scales = _case(dev, dtype, E=E, mem=mem, H=H, W=W,
                                         C=C, seed=seed)
    g4 = torch.from_numpy(rng.standard_normal((gmap.shape[0], 4, 4, C)).astype(
        np.float32)).to(dev).to(gmap.dtype)
    cx = rng.uniform(-6, W + 6, (E, 1, 1))
    cy = rng.uniform(-6, H + 6, (E, 1, 1))
    off = np.arange(4) - 1.5
    coords = np.stack([np.broadcast_to(cx + off[None, None, :], (E, 4, 4)),
                       np.broadcast_to(cy + off[None, :, None], (E, 4, 4))],
                      -1) + 0.3 * rng.standard_normal((E, 4, 4, 2))
    return (g4, pyr, torch.from_numpy(coords.astype(np.float32)).to(dev), kk,
            jj, scales)


@DTYPES
@pytest.mark.parametrize("level", [0, 1])
def test_level_kernel_4x4_patches(dev, dtype, level):
    """K6'' takes the 4x4 patches that devo_tpu_torch/scripts/
    probe_level_split.py runs: 16 pixels, two n-tiles of the products."""
    args = _level(_case4(dev, dtype), level)
    got = corr_cuda.corr_level_cuda(*args)
    assert got.shape == (700, 49 * 16)
    torch.testing.assert_close(got, corr_plain.corr_level(*args), **TOL)


# --- csrc/corr_level_resident.cu (K11''): the resident frame ----------------


RESIDENT_DTYPES = pytest.mark.parametrize("dtype", ["i8", "f32-i8"])


def _resident_case(dev, dtype, slots, E=3000, mem=32):
    """Level 4 of a full-size ring (30x40x128 frames, 32 slots) with jj set
    by `slots`: "uniform", "one slot" (every edge on slot 5) or "newest"
    (the 10 newest slots, as on the tracking path)."""
    args = list(_level(_case(dev, dtype, E=E, mem=mem, H=120, W=160), 1))
    rng = np.random.default_rng(11)
    if slots == "one slot":
        args[4] = torch.full_like(args[4], 5)
    elif slots == "newest":
        args[4] = torch.from_numpy(
            (mem - 1 - rng.integers(0, 10, E)).astype(np.int32)).to(dev)
    return tuple(args)


@RESIDENT_DTYPES
@pytest.mark.parametrize("slots", ["uniform", "one slot", "newest"])
def test_resident_kernel_skewed_slots(dev, dtype, slots):
    """K11'' on every edge of one slot and on the 10 newest slots as on a
    uniform spread: within TOL of corr_level, one launch."""
    args = _resident_case(dev, dtype, slots)
    before = corr_cuda.launches["corr_level_resident"]
    got = corr_cuda.corr_level_resident_cuda(*args)
    torch.cuda.synchronize()
    assert corr_cuda.launches["corr_level_resident"] == before + 1
    torch.testing.assert_close(got, corr_plain.corr_level(*args), **TOL)


def _resident_at(args, blocks):
    """One launch of devo_corr_level_resident by its C interface at `blocks`
    persistent blocks, on the wrapper's plan and slot-sorted edges."""
    gmap, fmap, coords, kk, jj, scale = args
    E, P, C = coords.shape[0], gmap.shape[1], gmap.shape[-1]
    mem, h, w, _ = fmap.shape
    warps, cap, _ = corr_cuda.resident_plan(h, w, C, P, gmap.dtype)
    order, slots, offsets = corr_cuda.resident_order(jj, mem)
    out = torch.empty((E, 49 * P * P), dtype=torch.float32, device=gmap.device)
    code = corr_cuda._load().devo_corr_level_resident(
        gmap.data_ptr(), fmap.data_ptr(), scale.data_ptr(), coords.data_ptr(),
        kk.data_ptr(), order.data_ptr(), slots.data_ptr(), offsets.data_ptr(),
        out.data_ptr(), E, P * P, C, h, w, cap,
        int(gmap.dtype == torch.bfloat16), warps, blocks,
        torch.cuda.current_stream().cuda_stream)
    assert code == 0
    return out


@RESIDENT_DTYPES
@pytest.mark.parametrize("slots", ["uniform", "one slot"])
def test_resident_kernel_same_bits_at_any_block_count(dev, dtype, slots):
    """Each row is written by one warp in a fixed order: the same bits at
    1 and 7 blocks by the C interface as at one block an SM (the wrapper's
    persistent grid), and in two launches; distorted patches (jitter 3 px
    at level 1) take both the surface and the taps beyond the cap."""
    args = list(_resident_case(dev, dtype, slots))
    g = torch.Generator(device=dev).manual_seed(3)
    args[2] = args[2] + 0.75 * torch.randn(args[2].shape, generator=g,
                                           device=dev)
    first = corr_cuda.corr_level_resident_cuda(*args)
    torch.testing.assert_close(first, corr_plain.corr_level(*args), **TOL)
    assert torch.equal(first, corr_cuda.corr_level_resident_cuda(*args))
    for blocks in (1, 7):
        assert torch.equal(first, _resident_at(args, blocks))


@RESIDENT_DTYPES
def test_resident_kernel_off_image_rows_are_zero(dev, dtype):
    """Edges whose patch lies wholly off the frame (every window position
    on the zero row) give rows of zeros; the others their values."""
    args = list(_resident_case(dev, dtype, "uniform", E=400))
    coords = args[2].clone()
    coords[::3] += torch.tensor([-60.0, 45.0], device=dev)
    args[2] = coords
    got = corr_cuda.corr_level_resident_cuda(*args)
    assert torch.equal(got[::3], torch.zeros_like(got[::3]))
    torch.testing.assert_close(got, corr_plain.corr_level(*args), **TOL)


@RESIDENT_DTYPES
def test_resident_kernel_4x4_patches(dev, dtype):
    """4x4 patches, which the TPU script probe_l4_resident runs: the plan
    holds fewer warps (5 for f32 patch features) and the kernel takes
    them."""
    args = _level(_case4(dev, dtype, mem=8, H=120, W=160), 1)
    warps = corr_cuda.resident_plan(30, 40, 128, 4, args[0].dtype)[0]
    assert warps == (12 if dtype == "i8" else 5)
    got = corr_cuda.corr_level_resident_cuda(*args)
    torch.testing.assert_close(got, corr_plain.corr_level(*args), **TOL)


def test_resident_plan_matches_the_kernel(dev):
    """resident_plan's bytes are the kernel's own (its C query), and a
    narrow ring (C = 16, rows padded to one chunk of 32 channels) and a
    346-wide input's 16x21 frame launch as planned."""
    lib = corr_cuda._load()
    for h, w, C, P in ((30, 40, 128, 3), (30, 40, 128, 4), (16, 21, 128, 3),
                       (4, 4, 16, 3)):
        for gdt in (torch.bfloat16, torch.float32):
            warps, cap, smem = corr_cuda.resident_plan(h, w, C, P, gdt)
            assert lib.devo_corr_level_resident_smem(
                P * P, C, h, w, cap, int(gdt == torch.bfloat16), warps) == smem
    for C, H, W in ((16, 16, 16), (128, 64, 84)):
        for dtype in ("i8", "f32-i8"):
            args = _level(_case(dev, dtype, E=500, C=C, H=H, W=W), 1)
            torch.testing.assert_close(corr_cuda.corr_level_resident_cuda(*args),
                                       corr_plain.corr_level(*args), **TOL)
