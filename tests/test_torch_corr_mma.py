"""The shared-memory plans of the tensor-core correlation kernels
(csrc/corr.cu, csrc/corr_fixed.cu, csrc/corr_mma.cuh) and the arithmetic of
their fragments, on the CPU.

The kernels themselves run only on the card (tests/test_torch_corr_cuda.py).
Here: ops/corr_cuda.mono_plan and fixed_plan / fixed_smem_bytes fit a
block's shared memory with the stages and blocks the designs need, and
refuse what the kernels do not take; the channel order that corr_mma.cuh
gives the mma fragments computes the plain product; its int8 -> bf16
conversion is exact for every int8 value.
"""
import numpy as np
import pytest
import torch

from devo_tpu_torch.ops import corr_cuda

BF, I8, F32 = torch.bfloat16, torch.int8, torch.float32
# the (patch feature, ring) dtype pairs the engine can ask corr_pyramid for:
# MIXED_PRECISION with bf16 or int8 rings, and f32 with f32 or int8 rings
PAIRS = [(BF, BF), (BF, I8), (F32, F32), (F32, I8)]
SMEM_MAX = 232_448


@pytest.mark.parametrize("gmap_dtype,ring_dtype", PAIRS)
@pytest.mark.parametrize("C", [8, 32, 128])
def test_mono_plan_fits_a_block(gmap_dtype, ring_dtype, C):
    """At P = 3 every pair fits a block's 232,448 bytes with its static
    tables, with a ring of two or four stages (one or two for each half of
    the block), four where they fit; one block of 512 threads an SM; bf16
    patch features stage whole m-tiles (a multiple of 16 positions) and the
    full 144-vector windows."""
    cap, depth, blocks = corr_cuda.mono_plan(3, C, gmap_dtype, ring_dtype)
    smem = corr_cuda.mono_smem_bytes(3, C, gmap_dtype, ring_dtype, cap, depth)
    assert smem + corr_cuda._MONO_STATIC <= SMEM_MAX
    assert depth in (2, corr_cuda.MONO_MAX_DEPTH) and blocks == 1
    if gmap_dtype == BF:
        assert cap == corr_cuda.LEVEL_WINDOW_CAP and cap % 16 == 0
    if depth < corr_cuda.MONO_MAX_DEPTH:
        assert (corr_cuda.mono_smem_bytes(3, C, gmap_dtype, ring_dtype, cap,
                                          corr_cuda.MONO_MAX_DEPTH)
                + corr_cuda._MONO_STATIC > SMEM_MAX)


def test_mono_plan_at_the_model_width():
    """C = 128: int8 rings take four stages of full windows, bf16 rings two
    (95 KB a stage); f32 rings stage smaller windows; f32 patch features on
    an int8 ring of 8-byte vectors stage nothing."""
    assert corr_cuda.mono_plan(3, 128, BF, I8) == (144, 4, 1)
    assert corr_cuda.mono_plan(3, 128, BF, BF) == (144, 2, 1)
    cap, depth, _ = corr_cuda.mono_plan(3, 128, F32, F32)
    assert depth == 2 and 64 <= cap < 144
    assert corr_cuda.mono_plan(3, 8, F32, I8)[0] == 0
    # the stage: the bf16 patch feature in rows of 160 channels (5 chunks),
    # two windows of 144 such rows
    assert corr_cuda.mono_smem_bytes(3, 128, BF, BF, 144, 1) == (
        9 * 160 * 2 + 2 * 144 * 160 * 2 + 4 * 144 * 10 * 4)
    assert corr_cuda.mono_smem_bytes(3, 128, BF, I8, 144, 1) == (
        9 * 160 * 2 + 2 * 144 * 160 + 4 * 144 * 10 * 4)


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("C", [8, 32, 128])
def test_fixed_plan_fits_a_block(dtype, C):
    """corr_fixed at P = 3: the bf16 kernel's two stages of 24 KB, the patch
    feature, the 384-row surface and the taps fit a block, three blocks an
    SM; the f32 kernel stages no window and fits ten."""
    stages, blocks = corr_cuda.fixed_plan(3, C, dtype)
    smem = corr_cuda.fixed_smem_bytes(3, C, dtype)
    assert smem + corr_cuda._FIXED_STATIC <= SMEM_MAX
    if dtype == BF:
        assert stages == 2 and blocks == 3
        assert smem >= 2 * 384 * 32 * 2 + 384 * 10 * 4
    else:
        assert stages == 0 and blocks >= 8
        assert smem == (9 * C + (384 + 64) * 9) * 4


@pytest.mark.parametrize("plan", ["mono", "fixed"])
@pytest.mark.parametrize("P,C", [(5, 128), (3, 126), (3, 10)])
def test_plans_refuse_what_the_kernels_do_not_take(plan, P, C):
    """P*P above 16 pixels (the kernels' index tables and two n-tiles), and
    a C that is no multiple of 4 (the kernels' 4-element loads)."""
    with pytest.raises(ValueError, match="corr kernel"):
        if plan == "mono":
            corr_cuda.mono_plan(P, C, BF, I8)
        else:
            corr_cuda.fixed_plan(P, C, BF)


def test_mma_stride_keeps_rows_an_odd_number_of_chunks_apart():
    for C in (4, 8, 12, 32, 48, 64, 96, 128, 160, 256):
        stride = corr_cuda._mma_stride(C)
        assert stride >= C and stride % 32 == 0 and stride // 32 % 2 == 1


def test_permuted_fragments_compute_the_plain_product():
    """corr_mma.cuh's fragments: of a 32-channel chunk, lane (g, t) holds
    channels 8t .. 8t+7 of A's rows g, g+8 and of B's column g, and k-step s
    takes words 2s, 2s+1 of them. Placed as mma.m16n8k16 places its
    registers (A: a0a1 row g k 2t..2t+1, a2a3 row g+8, a4a5 row g k
    2t+8..2t+9, a6a7 row g+8; B: b0b1 k 2t..2t+1 column g, b2b3 k
    2t+8..2t+9), the two k-steps give A @ B over the chunk."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((16, 32))
    B = rng.standard_normal((32, 8))
    D = np.zeros((16, 8))
    for s in range(2):
        # the logical 16x16 A tile and 16x8 B tile of k-step s, as each lane
        # hands them to the mma
        At = np.zeros((16, 16))
        Bt = np.zeros((16, 8))
        for lane in range(32):
            g, t = lane // 4, lane % 4
            row_a, row_b = A[g, 8 * t:8 * t + 8], A[g + 8, 8 * t:8 * t + 8]
            col = B[8 * t:8 * t + 8, g]
            words_a = [row_a[2 * w:2 * w + 2] for w in range(4)]
            words_b = [row_b[2 * w:2 * w + 2] for w in range(4)]
            words_c = [col[2 * w:2 * w + 2] for w in range(4)]
            At[g, 2 * t:2 * t + 2] = words_a[2 * s]
            At[g + 8, 2 * t:2 * t + 2] = words_b[2 * s]
            At[g, 2 * t + 8:2 * t + 10] = words_a[2 * s + 1]
            At[g + 8, 2 * t + 8:2 * t + 10] = words_b[2 * s + 1]
            Bt[2 * t:2 * t + 2, g] = words_c[2 * s]
            Bt[2 * t + 8:2 * t + 10, g] = words_c[2 * s + 1]
        D += At @ Bt
    np.testing.assert_allclose(D, A @ B, rtol=1e-12, atol=1e-12)


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4i) & 7 of the
    eight bytes of y:x."""
    src = (y << 32) | x
    return sum(((src >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def _f32(bits: int) -> float:
    return float(np.array([bits], np.uint32).view(np.float32)[0])


def _bits(v: float) -> int:
    return int(np.array([v], np.float32).view(np.uint32)[0])


def test_int8_to_bf16_conversion_is_exact():
    """corr_mma.cuh's i8x2_bf16x2 for every int8 value in either half of a
    word: flip the sign bits, put each byte into 2^23's mantissa, subtract
    2^23 + 128 in f32, and keep the upper halves of the two floats: the bf16
    of the value, bit for bit (torch's rounding of the same value)."""
    bias = np.float32(8388608.0 + 128.0)
    values = np.arange(-128, 128)
    want = torch.from_numpy(values.astype(np.float32)).to(torch.bfloat16)
    want = want.view(torch.int16).numpy().astype(np.uint16)
    for k in (0, 2):
        for n, v in enumerate(values):
            other = int(values[(n * 37) % 256]) & 0xFF
            word = ((v & 0xFF) << (8 * k)) | (other << (8 * (k + 1) % 32))
            u = word ^ 0x80808080
            lo = np.float32(_f32(_byte_perm(u, 0x4B000000, 0x7650 + k))) - bias
            hi = np.float32(_f32(_byte_perm(u, 0x4B000000, 0x7651 + k))) - bias
            packed = _byte_perm(_bits(lo), _bits(hi), 0x7632)
            assert lo == v and hi == values[(n * 37) % 256]
            assert packed & 0xFFFF == want[n]
            assert packed >> 16 == want[(n * 37) % 256]
