// Both pyramid levels of the sparse patch correlation in one launch, for
// Hopper (sm_90a): CORR_KERNEL="pair". Plain C interface, loaded with ctypes
// by devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded_pair`
// (devo_tpu/ops/corr_pallas.py:1225, reached through corr_pyramid_banded
// :1962 -> corr_pyramid_pair :1311, pallas_call at :1408) together with its
// XLA glue: lookup_g (:968), _pair_level_index (:1195), the one-hot scale
// lookup and ops/corr.blend_strips for both levels. What that kernel is: one
// pass over the edges for both levels, the edge's patch feature brought in
// once and used for both, and one copy pipeline per level (two semaphore
// arrays, each IF deep), so that the level-4 windows stream while the
// level-1 products issue and the other way round. None of the TPU's shapes
// is kept: plain (mem, h, w, C) rings, no bands, stagger, 24-wide windows,
// R scratch or strip output; out-of-image taps are zero, and the blended
// (E, 882) f32 feature is written here.
//
// What it computes: the function of csrc/corr.cu (ops/corr.corr_pyramid is
// the plain version), coords / lvl divided here so that both floor the same
// values, as (E, 2*49*P*P) f32 in [dx, dy, pixel, level] order; with int8
// rings the dot is over the integer values, times the slot's scale.
//
// What bounds it on an H100: bytes, as csrc/corr.cu: the two covering
// windows of an edge (about 10x10 feature vectors at level 1, 9x9 at level
// 4) against 2 x 9 x 64 x C multiply-adds, far below the tensor cores'
// rate. The design is csrc/corr.cu's instance of the edge pipeline
// (corr_pipe.cuh), shape, schedule and plan (ops/corr_cuda.mono_plan):
//   - a block of 512 threads walks a run of consecutive edges as two
//     independent pipelines of 256 threads, each with its own named
//     barrier, one edge a step (ops/corr_cuda.mono_run);
//   - a stage holds an edge's patch feature, which both levels read, and
//     both levels' covering windows; four stages at C = 128 on int8 rings,
//     218,880 bytes, two on bf16 rings, 213,120 bytes, one a pipeline;
//   - products on the tensor cores (corr_mma.cuh) for bf16 patch features,
//     the int8 -> bf16 conversion in the fragment loads; on the CUDA cores
//     (position_products) for f32 ones; a level whose window exceeds `cap`
//     takes its taps from the ring, one dot a tap; the f32 surface in
//     shared memory, extraction and blend from it. Nothing is clipped.
// The TPU kernel's per-level copy streams (each level's window its own
// cp.async group with its own wait and barrier, three barriers a step) were
// measured on an H100 at 8-13% over this schedule on every ring type: two
// pipelines an SM already hide the copies (PERF.md §7).
// No atomics, and every sum in a fixed order: two launches give the same
// bits.

#include "corr_pipe.cuh"

namespace {

using namespace devo;

// both levels, one edge a step, two pipelines, at most four stages
using Pair = PipeShape<2, 1, 2, 4, false, false, false>;

// G: type of the patch features, F: type of the rings (G or int8_t)
template <typename G, typename F>
__global__ void __launch_bounds__(kPipeBlock, 1)
corr_pair_kernel(const PipeArgs<G, F> args) {
  edge_pipeline<G, F, Pair>(args);
}

template <typename G, typename F>
size_t smem_bytes(int PP, int C, int cap, int depth) {
  return PipeLayout<G, F, Pair>(PP, C, cap).bytes(depth);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. The arguments are those of devo_corr_pyramid
// (csrc/corr.cu): `cap` a multiple of 16 for bf16 patch features, `depth`
// the stages of the block's ring (2 or 4, half of them each pipeline's),
// `run` the consecutive edges a block walks (at least 1). The dynamic shared
// memory taken is devo_corr_pair_smem's, that of
// ops/corr_cuda.mono_smem_bytes.
extern "C" int devo_corr_pair(const void* gmap, const void* fmap1,
                              const void* fmap2, const void* dq1,
                              const void* dq2, const void* coords,
                              const void* kk, const void* jj, void* out, int E,
                              int PP, int C, int h1, int w1, int h2, int w2,
                              int cap, float lvl1, float lvl2, int g_bf16,
                              int ring_i8, int depth, int run, void* stream) {
  if (E == 0) return 0;
  if (PP > kMaxPP || depth < Pair::kPipes || depth > Pair::kMaxDepth ||
      depth % Pair::kPipes != 0 || run < 1 || (g_bf16 && cap % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (E + run - 1) / run;
#define DEVO_LAUNCH(G, F)                                                     \
  launch_pipe<Pair>(corr_pair_kernel<G, F>,                                   \
              PipeArgs<G, F>{pair_args<G, F>(gmap, fmap1, fmap2, dq1, dq2,    \
                                             coords, kk, jj, out, E, PP, C,   \
                                             h1, w1, h2, w2, cap, lvl1, lvl2), \
                             depth, run, nullptr, 0},                         \
              grid, smem_bytes<G, F>(PP, C, cap, depth), st)
  return DEVO_PIPE_TYPES(DEVO_LAUNCH);
#undef DEVO_LAUNCH
}

// The dynamic shared memory devo_corr_pair takes at these sizes.
extern "C" long long devo_corr_pair_smem(int PP, int C, int cap, int depth,
                                         int g_bf16, int ring_i8) {
#define DEVO_SMEM(G, F) static_cast<long long>(smem_bytes<G, F>(PP, C, cap, depth))
  return DEVO_PIPE_TYPES(DEVO_SMEM);
#undef DEVO_SMEM
}

// Blocks of devo_corr_pair's kernel that one SM of the current device holds
// at these sizes, or minus the cudaError_t of the query.
extern "C" int devo_corr_pair_blocks_per_sm(int PP, int C, int cap, int depth,
                                            int g_bf16, int ring_i8) {
#define DEVO_OCC(G, F)                                                   \
  pipe_blocks_per_sm<Pair>(corr_pair_kernel<G, F>,                       \
                     smem_bytes<G, F>(PP, C, cap, depth))
  return DEVO_PIPE_TYPES(DEVO_OCC);
#undef DEVO_OCC
}
