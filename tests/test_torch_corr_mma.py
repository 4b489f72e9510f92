"""The shared-memory plans of the tensor-core correlation kernels
(csrc/corr.cu, csrc/corr_pair.cu, csrc/corr_pair2.cu, csrc/corr_mono2.cu,
csrc/corr_mono3.cu, csrc/corr_group.cu, csrc/corr_group8.cu,
csrc/corr_level_pipe.cu, csrc/corr_level_full.cu on the edge pipeline of
csrc/corr_pipe.cuh, csrc/corr_fixed.cu, csrc/corr_mma.cuh), the edges their
blocks walk, and the arithmetic of their fragments, on the CPU.

The kernels themselves run only on the card (tests/test_torch_corr_cuda.py).
Here: ops/corr_cuda.mono_plan (corr_pyramid's and corr_pair's), group_plan
(corr_group's, corr_group8's, corr_level_pipe's and corr_level_full's, the
last with its tuning knobs, full_knobs), mono2_plan, mono3_plan, pair2_plan
and fixed_plan / fixed_smem_bytes fit a block's shared memory with the
stages, pipelines and blocks the designs need, and refuse what the kernels
do not take; corr_mono3's runs and
corr_pair2's persistent grid cover every edge once; the channel order that
corr_mma.cuh gives the mma fragments computes the plain product; its int8 -> bf16 conversion is exact for every int8 value; the
order of corr_group's taps (round to bf16, then scale, then blend) is
corr_level_group's.
"""
import numpy as np
import pytest
import torch

from devo_tpu_torch.ops import corr as corr_plain
from devo_tpu_torch.ops import corr_cuda

BF, I8, F32 = torch.bfloat16, torch.int8, torch.float32
# the (patch feature, ring) dtype pairs the engine can ask corr_pyramid for:
# MIXED_PRECISION with bf16 or int8 rings, and f32 with f32 or int8 rings
PAIRS = [(BF, BF), (BF, I8), (F32, F32), (F32, I8)]
SMEM_MAX = 232_448
SMEM_SM = 233_472             # an SM's shared memory, 1,024 bytes a block
                              #   reserved


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


@pytest.mark.parametrize("gmap_dtype,ring_dtype", PAIRS)
@pytest.mark.parametrize("C", [8, 32, 128])
def test_group_plan_fits_a_block(gmap_dtype, ring_dtype, C):
    """corr_group at P = 3 (one level, two pipelines a block): every pair
    fits its share of an SM with its static tables, two blocks an SM where a
    ring of two stages of full windows fits half an SM, four stages where
    they fit; bf16 patch features take full windows, two blocks an SM."""
    cap, depth, blocks = corr_cuda.group_plan(3, C, gmap_dtype, ring_dtype)
    share = SMEM_MAX if blocks == 1 else SMEM_SM // 2 - 1024

    def smem(depth):
        return (corr_cuda.group_smem_bytes(3, C, gmap_dtype, ring_dtype, cap,
                                           depth) + corr_cuda._MONO_STATIC)

    assert smem(depth) <= share and depth in (2, 4) and blocks in (1, 2)
    assert depth == 4 or smem(4) > share
    if gmap_dtype == BF:
        assert (cap, blocks) == (corr_cuda.LEVEL_WINDOW_CAP, 2)
    if blocks == 1:
        assert cap > 0


def test_pair_and_group8_plans_at_the_model_width():
    """C = 128: corr_pair at corr_pyramid's plan, four stages of full
    windows on int8 rings (218,880 bytes), two on bf16 rings (213,120: one
    stage a pipeline); corr_group8 at corr_group's plan, on bf16 rings two
    stages of 48,960 bytes and two surface slots of 5,760, 109,440 bytes,
    within the 111,616 that each of two blocks an SM has beside its static
    tables; on f32 rings one block."""
    assert corr_cuda.mono_plan(3, 128, BF, I8) == (144, 4, 1)
    assert corr_cuda.mono_plan(3, 128, BF, BF) == (144, 2, 1)
    assert corr_cuda.mono_smem_bytes(3, 128, BF, I8, 144, 4) == (
        4 * (9 * 160 * 2 + 2 * 144 * 160) + 4 * 144 * 10 * 4) == 218_880
    assert corr_cuda.mono_smem_bytes(3, 128, BF, BF, 144, 2) == (
        2 * (9 * 160 * 2 + 2 * 144 * 160 * 2) + 4 * 144 * 10 * 4) == 213_120
    assert corr_cuda.group_plan(3, 128, BF, BF) == (144, 2, 2)
    assert corr_cuda._stage_bytes(3, 128, BF, BF, 144, 1) == 48_960
    assert corr_cuda._slot_bytes(3, 144) == 5_760
    assert corr_cuda.group_smem_bytes(3, 128, BF, BF, 144, 2) == (
        2 * 48_960 + 2 * 5_760) == 109_440
    assert SMEM_SM // 2 - 1024 - corr_cuda._MONO_STATIC == 111_616
    assert corr_cuda.group_plan(3, 128, F32, F32)[2] == 1


def test_level_pipe_and_full_plans_at_the_model_width():
    """C = 128: corr_level_pipe (K7'') and corr_level_full (K10'') are
    instances of the edge pipeline in corr_group8's shape at group_plan.
    K7'' on int8 rings: two stages of the bf16 patch rows (9 x 160 x 2
    bytes) and a window of 144 rows of 160 bytes, 25,920 each, and two
    surface slots of 5,760: 63,360 bytes, two blocks an SM; four stages
    (115,200) would miss the 111,616 of half an SM. K10'' (full_knobs): the
    plan on bf16 rings, two blocks of 109,440 bytes an SM; a ring of four
    stages, 207,360 bytes, takes an SM alone; on f32 rings two stages of
    80,640 (9 x 128 floats and 144 rows of 528 bytes), 172,800 bytes, one
    block an SM."""
    assert corr_cuda.group_plan(3, 128, BF, I8) == (144, 2, 2)
    assert corr_cuda._stage_bytes(3, 128, BF, I8, 144, 1) == (
        9 * 160 * 2 + 144 * 160) == 25_920
    assert corr_cuda.group_smem_bytes(3, 128, BF, I8, 144, 2) == (
        2 * 25_920 + 2 * 5_760) == 63_360
    assert corr_cuda.group_smem_bytes(3, 128, BF, I8, 144, 4) == 115_200
    assert corr_cuda.full_knobs(3, 128, BF) == (144, 2, 2)
    assert corr_cuda.full_knobs(3, 128, BF, depth=2, run=7) == (144, 2, 2)
    assert corr_cuda.full_knobs(3, 128, BF, depth=4) == (144, 4, 1)
    assert corr_cuda.group_smem_bytes(3, 128, BF, BF, 144, 4) == (
        4 * 48_960 + 2 * 5_760) == 207_360
    assert corr_cuda._stage_bytes(3, 128, F32, F32, 144, 1) == (
        9 * 128 * 4 + 144 * 528) == 80_640
    assert corr_cuda.full_knobs(3, 128, F32) == (144, 2, 1)
    assert corr_cuda.group_smem_bytes(3, 128, F32, F32, 144, 2) == 172_800


@pytest.mark.parametrize("dtype,depth,run,match", [
    (BF, 3, None, "multiple of the block's 2 pipelines"),
    (BF, 6, None, "depth must be 2 to 4"),
    (BF, 0, None, "depth must be 2 to 4"),
    (F32, 4, None, "more shared memory than a block can have"),
    (BF, None, 0, "run must be at least 1"),
    (BF, 2, -3, "run must be at least 1")])
def test_full_knobs_refusals(dtype, depth, run, match):
    """corr_level_full's tuning knobs: a depth that is no multiple of the
    block's two pipelines or outside 2 .. FULL_MAX_DEPTH, a depth whose ring
    a block's shared memory does not hold (four f32 stages, 334,080 bytes),
    and a run below one edge."""
    with pytest.raises(ValueError, match=match):
        corr_cuda.full_knobs(3, 128, dtype, depth, run)


@pytest.mark.parametrize("gmap_dtype,ring_dtype", PAIRS)
@pytest.mark.parametrize("C", [8, 32, 128])
def test_mono2_plan_fits_a_block(gmap_dtype, ring_dtype, C):
    """corr_mono2 at P = 3 (a pair of edges a step, one block an SM): every
    pair fits a block with its static tables; two pipelines of one stage
    each for bf16 patch features on int8 rings alone, with windows of at
    least MONO2_PIPES_CAP vectors; otherwise one pipeline of one or two
    stages, two where they fit; bf16 patch features stage whole m-tiles."""
    cap, depth, pipes = corr_cuda.mono2_plan(3, C, gmap_dtype, ring_dtype)

    def smem(depth):
        return (corr_cuda.mono2_smem_bytes(3, C, gmap_dtype, ring_dtype, cap,
                                           depth, pipes)
                + corr_cuda._MONO2_STATIC)

    assert smem(depth) <= SMEM_MAX and depth % pipes == 0 and 1 <= depth <= 2
    assert (pipes == 2) == (gmap_dtype == BF and ring_dtype == I8)
    assert pipes == 2 or depth == 2 or smem(2) > SMEM_MAX
    if gmap_dtype == BF:
        assert cap % 16 == 0 and cap >= corr_cuda.MONO2_PIPES_CAP


def test_pipeline_plans_at_the_model_width():
    """C = 128: corr_group two blocks of two stages of full windows an SM on
    int8 and bf16 rings; corr_mono2 two pipelines of windows of 128 vectors
    on int8 rings, one pipeline of one stage of full windows on bf16; f32
    patch features on an int8 ring of 8-byte vectors stage nothing."""
    assert corr_cuda.group_plan(3, 128, BF, I8) == (144, 2, 2)
    assert corr_cuda.group_plan(3, 128, BF, BF) == (144, 2, 2)
    assert corr_cuda.mono2_plan(3, 128, BF, I8) == (128, 2, 2)
    assert corr_cuda.mono2_plan(3, 128, BF, BF) == (144, 1, 1)
    assert corr_cuda.group_plan(3, 8, F32, I8)[0] == 0
    assert corr_cuda.mono2_plan(3, 8, F32, I8)[0] == 0
    # the stage of a pair: two patch rows of 160 channels, four windows
    assert corr_cuda.mono2_smem_bytes(3, 128, BF, I8, 128, 1, 1) == (
        2 * (9 * 160 * 2 + 2 * 128 * 160) + 4 * 128 * 10 * 4)


@pytest.mark.parametrize("gmap_dtype,ring_dtype", PAIRS)
@pytest.mark.parametrize("C", [8, 32, 128])
def test_mono3_plan_fits_a_block(gmap_dtype, ring_dtype, C):
    """corr_mono3 at P = 3 (one pipeline of 512 threads, two rotating
    surface slots a level, one block an SM): every pair fits a block with
    its static tables and at least the two stages the one-barrier schedule
    needs, the deepest ring that fits; bf16 patch features stage whole
    m-tiles and the full 144-vector windows."""
    cap, depth = corr_cuda.mono3_plan(3, C, gmap_dtype, ring_dtype)

    def smem(depth):
        return (corr_cuda.mono3_smem_bytes(3, C, gmap_dtype, ring_dtype, cap,
                                           depth) + corr_cuda._MONO3_STATIC)

    assert smem(depth) <= SMEM_MAX and 2 <= depth <= corr_cuda.MONO3_MAX_DEPTH
    assert depth == corr_cuda.MONO3_MAX_DEPTH or smem(depth + 1) > SMEM_MAX
    if gmap_dtype == BF:
        assert cap == corr_cuda.LEVEL_WINDOW_CAP
    # the one pipeline's four slots are K1's two pipelines' four
    assert (corr_cuda.mono3_smem_bytes(3, C, gmap_dtype, ring_dtype, cap, 2)
            == corr_cuda.mono_smem_bytes(3, C, gmap_dtype, ring_dtype, cap, 2))


@pytest.mark.parametrize("gmap_dtype,ring_dtype", PAIRS)
@pytest.mark.parametrize("C", [8, 32, 128])
def test_pair2_plan_fits_a_block(gmap_dtype, ring_dtype, C):
    """corr_pair2 at P = 3 (blocks of one pipeline of 256 threads with two
    stages): two blocks an SM, each within half an SM with its static tables
    and reserved bytes, where full windows fit or nothing is staged; else
    one block with windows as large as a block allows; bf16 patch features
    stage whole m-tiles."""
    cap, depth, blocks = corr_cuda.pair2_plan(3, C, gmap_dtype, ring_dtype)
    smem = (corr_cuda.pair2_smem_bytes(3, C, gmap_dtype, ring_dtype, cap,
                                       depth) + corr_cuda._PAIR_STATIC)
    assert depth == corr_cuda.PAIR2_DEPTH == 2 and blocks in (1, 2)
    assert smem <= (SMEM_SM // 2 - 1024 if blocks == 2 else SMEM_MAX)
    if blocks == 1:
        half = (corr_cuda.pair2_smem_bytes(3, C, gmap_dtype, ring_dtype,
                                           corr_cuda.LEVEL_WINDOW_CAP, depth)
                + corr_cuda._PAIR_STATIC)
        more = (corr_cuda.pair2_smem_bytes(
            3, C, gmap_dtype, ring_dtype, cap + (16 if gmap_dtype == BF else 1),
            depth)
            + corr_cuda._PAIR_STATIC)
        assert cap > 0 and half > SMEM_SM // 2 - 1024
        assert cap == corr_cuda.LEVEL_WINDOW_CAP or more > SMEM_MAX
    elif cap:
        assert cap == corr_cuda.LEVEL_WINDOW_CAP
    if gmap_dtype == BF:
        assert cap == corr_cuda.LEVEL_WINDOW_CAP


def _run_edges(E, run):
    """The edges of each block of a kernel whose blocks walk runs of `run`
    consecutive edges (csrc/corr_pipe.cuh, Order::kRuns): block b takes
    b * run .. min(E, b * run + run) - 1."""
    return [list(range(b * run, min(E, b * run + run)))
            for b in range(-(-E // run))]


def _strided_edges(E, grid):
    """The edges of each block of a persistent grid of `grid` blocks
    (Order::kStrided): block b takes b, b + grid, b + 2 grid, ... below E."""
    return [list(range(b, E, grid)) for b in range(grid)]


@pytest.mark.parametrize("E", [0, 1, 131, 5003, 12288])
def test_rotating_kernels_cover_every_edge_once(E):
    """On an H100's 132 SMs, corr_mono3's runs (mono3_run) and corr_pair2's
    persistent grid at one and two blocks an SM (pair2_grid) give every
    edge to exactly one block, and no block none; corr_mono3's blocks come
    to whole rounds over the SMs but for a short last round, and its runs
    stay within MONO3_RUN."""
    sms = 132
    assignments = []
    if E:
        run = corr_cuda.mono3_run(E, sms)
        assert 1 <= run <= corr_cuda.MONO3_RUN
        blocks = -(-E // run)
        assert blocks <= sms or blocks % sms == 0 or blocks % sms > 0.9 * sms
        assignments.append(_run_edges(E, run))
        for per_sm in (1, 2):
            grid = corr_cuda.pair2_grid(E, sms, per_sm)
            assert grid == min(E, sms * per_sm)
            assignments.append(_strided_edges(E, grid))
    else:
        # the wrappers launch nothing at E = 0
        assert corr_cuda.pair2_grid(0, sms, 2) == 0
    for blocks in assignments:
        assert all(blocks)
        edges = sorted(e for block in blocks for e in block)
        assert edges == list(range(E))


PLANS = {"mono": lambda P, C: corr_cuda.mono_plan(P, C, BF, I8),
         "group": lambda P, C: corr_cuda.group_plan(P, C, BF, I8),
         "full": lambda P, C: corr_cuda.full_knobs(P, C, BF),
         "mono2": lambda P, C: corr_cuda.mono2_plan(P, C, BF, I8),
         "mono3": lambda P, C: corr_cuda.mono3_plan(P, C, BF, I8),
         "pair2": lambda P, C: corr_cuda.pair2_plan(P, C, BF, I8),
         "fixed": lambda P, C: corr_cuda.fixed_plan(P, C, BF)}


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("P,C", [(5, 128), (3, 126), (3, 10)])
def test_plans_refuse_what_the_kernels_do_not_take(plan, P, C):
    """P*P above 16 pixels (the kernels' index tables and two n-tiles), and
    a C that is no multiple of 4 (the kernels' 4-element loads)."""
    with pytest.raises(ValueError, match="corr kernel"):
        PLANS[plan](P, C)


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


def _bf16_rne(x):
    """f32 -> bf16 -> f32, round to nearest even (as __float2bfloat16_rn)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def _blend(taps, fx, fy):
    """extract_blend_group's blend of (E, PP, 8, 8) taps, in its order and in
    f32, as (E, 49*PP) in [dx, dy, pixel] order."""
    fx, fy = fx[:, :, None, None], fy[:, :, None, None]
    one = np.float32(1)
    out = ((one - fx) * (one - fy) * taps[:, :, :7, :7]
           + fx * (one - fy) * taps[:, :, :7, 1:]
           + (one - fx) * fy * taps[:, :, 1:, :7]
           + fx * fy * taps[:, :, 1:, 1:])
    return out.transpose(0, 3, 2, 1).reshape(len(taps), -1)


def test_group_tap_order_is_corr_level_group():
    """corr_group's order, restated in numpy: each integer tap's f32 sum
    rounded once to bf16, then off-image taps zeroed, then the ring slot's
    scale, then the blend. On an int8 ring with integer patch features every
    sum is exact in f32 in any order, so this reproduces corr_level_group
    bit for bit; scaling before the rounding gives other numbers, on random
    inputs and on a crafted tap (257 rounds to 256 before a scale of 1/3,
    and 257/3 to 85.5 after it), so the order is pinned."""
    rng = np.random.default_rng(3)
    E, C, mem, H, W = 24, 32, 3, 12, 14
    g = rng.integers(-8, 9, (6, 3, 3, C)).astype(np.float32)
    ring = rng.integers(-127, 128, (mem, H, W, C)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, mem).astype(np.float32)
    cx = rng.uniform(-2, W + 1, (E, 1, 1))
    cy = rng.uniform(-2, H + 1, (E, 1, 1))
    off = np.arange(3) - 1.0
    coords = np.stack([np.broadcast_to(cx + off[None, None, :], (E, 3, 3)),
                       np.broadcast_to(cy + off[None, :, None], (E, 3, 3))],
                      -1) + 0.2 * rng.standard_normal((E, 3, 3, 2))
    coords = coords.astype(np.float32)
    kk = rng.integers(0, 6, E).astype(np.int32)
    jj = rng.integers(0, mem, E).astype(np.int32)
    want = corr_plain.corr_level_group(
        torch.from_numpy(g).to(torch.bfloat16), torch.from_numpy(ring),
        torch.from_numpy(coords), torch.from_numpy(kk), torch.from_numpy(jj),
        torch.from_numpy(scale)).numpy()

    x = coords[..., 0].reshape(E, 9)
    y = coords[..., 1].reshape(E, 9)
    x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    d = np.arange(8) - 3
    iy = y0[:, :, None, None] + d[:, None]                  # (E, 9, 8, 1)
    ix = x0[:, :, None, None] + d[None, :]                  # (E, 9, 1, 8)
    iy, ix = np.broadcast_arrays(iy, ix)
    inb = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    vec = ring[jj[:, None, None, None], iy.clip(0, H - 1), ix.clip(0, W - 1)]
    patch = g[kk].reshape(E, 9, 1, 1, C)
    sums = (patch.astype(np.int64) * vec.astype(np.int64)).sum(-1)
    sums = sums.astype(np.float32)                          # exact: |sum| < 2^24
    q = scale[jj][:, None, None, None]
    fx = (x - np.floor(x)).astype(np.float32)
    fy = (y - np.floor(y)).astype(np.float32)
    zero = np.float32(0)
    got = _blend(np.where(inb, _bf16_rne(sums), zero) * q, fx, fy)
    np.testing.assert_array_equal(got, want)
    other = _blend(np.where(inb, _bf16_rne(sums * q), zero), fx, fy)
    assert not np.array_equal(other, want)
    third = np.float32(1) / np.float32(3)
    assert _bf16_rne(np.float32(257)) * third != _bf16_rne(np.float32(257) * third)
