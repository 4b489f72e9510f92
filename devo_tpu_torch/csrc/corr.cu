// Two-level sparse patch correlation for the DEVO tracking step, for Hopper
// (sm_90a): the engine's default kernel (CORR_KERNEL="mono"). Plain C
// interface, loaded with ctypes by devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded_mono`
// (devo_tpu/ops/corr_pallas.py:1553, reached through corr_pyramid_banded
// :1962 -> corr_pyramid_pair2 :1835, pallas_call at :1944) together with its
// XLA glue: lookup_g (:968), _pair_level_index (:1195), the banded ring
// writes band_frame / band_frame_i8 (:242, :266) and ops/corr.blend_strips
// (devo_tpu/ops/corr.py:180). It computes the function, not the TPU
// schedule: plain (mem, h, w, C) rings, no banding, stagger or window clip.
//
// What it computes, per edge e:
//   g      = gmap[kk[e]]                       (P*P pixels x C)
//   level  l in {0, 1}: fmap = l ? fmap2 : fmap1, coords / scale_l
//   taps   t[l][p][di][dj] = <g[p], fmap[jj[e], y0+di-3, x0+dj-3]>, 8x8 integer
//          grid around floor(coord of pixel p); out-of-bounds taps are 0
//   out    the 7x7 bilinear blend of the taps with the fractional offsets,
//          written as (E, 2*49*P*P) f32 in [dx, dy, pixel, level] order
//          (ops/corr.corr_pyramid).
// Accumulation is f32. The patch features may be f32 or bf16; the rings are
// of the same type or int8 (the quantised-ring half of the TPU kernel, its
// `wi8` branch): the dot is then taken over the integer values and the ring
// slot's dequantisation scale dq_l[jj[e]] multiplies each f32 tap.
//
// What bounds it on an H100: bytes. Per edge at P = 3, C = 128 the 3x3
// patch's 8x8 tap grids cover about 10x10 feature vectors a level (25.6 KB
// of bf16, 12.8 KB of int8 at level 1); the level-1 ring (32 x 120 x 160 x
// 128 bf16, 157 MB) does not fit the 50 MB L2. The products, 2 x 9 x 64 x C
// multiply-adds an edge, are far below the tensor cores' rate. The design is
// the edge pipeline of corr_pipe.cuh, with one edge a step and both levels:
//   - a block walks a run of consecutive edges (the wrapper spreads the edges
//     over one round of blocks, one an SM: ops/corr_cuda.mono_run) as two
//     independent pipelines: each half of the block (256 threads, its own
//     named barrier) takes every other edge of the run, so that one half's
//     waits and barriers overlap the other half's work. A half keeps
//     depth / 2 stages: the copies of its edge i + depth/2 -- the patch
//     feature and both levels' covering windows -- start as soon as the
//     products of its edge i are done, and fly during the extraction of
//     edge i and the products in between. Every feature vector leaves
//     device memory or L2 once per edge;
//   - bf16 patch features (bf16 or int8 rings): the window product runs on
//     the tensor cores (corr_mma.cuh): the window's positions, padded to a
//     multiple of 16, as A, the patch's pixels as B, both levels' m-tiles
//     spread over the half's warps, the int8 -> bf16 conversion in the
//     fragment loads;
//   - f32 patch features (MIXED_PRECISION=False) are never rounded: the
//     same staged window is dotted on the CUDA cores, one position a thread
//     against all pixels (position_products);
//   - the surface, (positions, pixels) f32 a level with the slot's scale
//     applied, goes to the half's slot of the level in shared memory; after
//     the half's barrier its threads read each output's four taps from it,
//     blend and write the edge's row;
//   - a level whose covering window exceeds `cap` (a strongly distorted
//     patch), or, for f32 patch features, a ring whose vector is no multiple
//     of 16 bytes (cap = 0), takes its taps from the ring, one dot a tap, into
//     the same slot: nothing is clipped.
// No atomics, and every sum in a fixed order: two launches give the same
// bits.

#include "corr_pipe.cuh"

namespace {

using namespace devo;

// both levels, one edge a step, two pipelines, at most four stages
using Mono = PipeShape<2, 1, 2, 4, false, false, false>;

// G: type of the patch features, F: type of the rings (G or int8_t)
template <typename G, typename F>
__global__ void __launch_bounds__(kPipeBlock, 1)
corr_pyramid_kernel(const PipeArgs<G, F> args) {
  edge_pipeline<G, F, Mono>(args);
}

template <typename G, typename F>
size_t smem_bytes(int PP, int C, int cap, int depth) {
  return PipeLayout<G, F, Mono>(PP, C, cap).bytes(depth);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. All pointers are device pointers to contiguous,
// 16-byte aligned tensors: gmap (Mring, P, P, C), bf16 if g_bf16 else f32;
// fmap1 (mem, h1, w1, C) and fmap2 (mem, h2, w2, C), of gmap's type, or
// int8 if ring_i8, and then dq1, dq2 (mem,) f32 are the slots' scales (null
// otherwise); coords (E, P, P, 2) f32 at level-1 resolution, divided by
// lvl1 and lvl2 in the kernel; kk / jj (E,) int32 ring indices; out
// (E, 2*49*P*P) f32. C is a multiple of 4, P*P at most 16. `cap`: feature
// vectors of a staged window (a multiple of 16 for bf16 patch features; 0 =
// every tap reads the ring), `depth`: stages of the window ring (2 or 4,
// half of them each half's), `run`: consecutive edges a block walks (at
// least 1). The dynamic shared memory taken is devo_corr_pyramid_smem's,
// that of ops/corr_cuda.mono_smem_bytes.
extern "C" int devo_corr_pyramid(const void* gmap, const void* fmap1,
                                 const void* fmap2, const void* dq1,
                                 const void* dq2, const void* coords,
                                 const void* kk, const void* jj, void* out,
                                 int E, int PP, int C, int h1, int w1, int h2,
                                 int w2, int cap, float lvl1, float lvl2,
                                 int g_bf16, int ring_i8, int depth, int run,
                                 void* stream) {
  if (E == 0) return 0;
  if (PP > kMaxPP || depth < Mono::kPipes || depth > Mono::kMaxDepth ||
      depth % Mono::kPipes != 0 || run < 1 || (g_bf16 && cap % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (E + run - 1) / run;
#define DEVO_LAUNCH(G, F)                                                     \
  launch_pipe<Mono>(corr_pyramid_kernel<G, F>,                                \
              PipeArgs<G, F>{pair_args<G, F>(gmap, fmap1, fmap2, dq1, dq2,    \
                                             coords, kk, jj, out, E, PP, C,   \
                                             h1, w1, h2, w2, cap, lvl1, lvl2), \
                             depth, run, nullptr, 0},                         \
              grid, smem_bytes<G, F>(PP, C, cap, depth), st)
  return DEVO_PIPE_TYPES(DEVO_LAUNCH);
#undef DEVO_LAUNCH
}

// The dynamic shared memory devo_corr_pyramid takes at these sizes.
extern "C" long long devo_corr_pyramid_smem(int PP, int C, int cap, int depth,
                                            int g_bf16, int ring_i8) {
#define DEVO_SMEM(G, F) static_cast<long long>(smem_bytes<G, F>(PP, C, cap, depth))
  return DEVO_PIPE_TYPES(DEVO_SMEM);
#undef DEVO_SMEM
}

// Blocks of devo_corr_pyramid's kernel that one SM of the current device
// holds at these sizes, or minus the cudaError_t of the query.
extern "C" int devo_corr_pyramid_blocks_per_sm(int PP, int C, int cap,
                                               int depth, int g_bf16,
                                               int ring_i8) {
#define DEVO_OCC(G, F)                                                   \
  pipe_blocks_per_sm<Mono>(corr_pyramid_kernel<G, F>,                    \
                     smem_bytes<G, F>(PP, C, cap, depth))
  return DEVO_PIPE_TYPES(DEVO_OCC);
#undef DEVO_OCC
}

extern "C" const char* devo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
